"""The port's model and hardware profilers against the JAX package's, on
the CPU (tiny widths; the card's numbers come from ``chip_smoke.py``).

- ``profile_model`` runs the port's real train step at two layer counts and
  writes reference-schema JSONs whose analytic fields (parameter, boundary
  and "other" sizes) equal the JAX profile's; its measured fields (time,
  activation bytes) are positive. Each package's JSONs load in the other's
  ``load_profiled_model`` and give the same plan in both searches.
- The adaptive layer counts halve on a CUDA out-of-memory error and on
  nothing else; explicit counts never change.
- ``profile_hardware``: a world of one writes the JAX package's world-1
  JSON; a 2-rank gloo world writes the key set of the JAX 2-device CPU
  simulation.
- The memory-fidelity prediction is the JAX package's arithmetic.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
SHAPE = dict(vocab_size=128, hidden_size=64, num_layers=4, num_heads=4, ffn_dim=128,
             max_seq_len=32)
BSZ = 4


def _tcfg(**kw):
    from galvatron_tpu_torch.models.modeling import ModelConfig

    return ModelConfig(**dict(SHAPE, **kw))


def _jcfg(**kw):
    from galvatron_tpu.models.modeling import ModelConfig

    return ModelConfig(**dict(SHAPE, **kw))


@pytest.fixture(scope="module")
def profiles(tmp_path_factory):
    """Both packages' profile JSONs of the same tiny model: the port's with
    time and memory measured on the CPU, the JAX package's memory-only
    (its timings on the CPU simulation are placeholders either way)."""
    from galvatron_tpu.profiling.model import profile_model as j_profile
    from galvatron_tpu.utils.config_utils import save_profiled_model as j_save
    from galvatron_tpu_torch import cli

    d = tmp_path_factory.mktemp("profiles")
    assert cli.main(["profile", "--device", "cpu", "--model_size", "llama-0.3b",
                     "--hidden_size", "64", "--num_layers", "4", "--num_heads", "4",
                     "--ffn_dim", "128", "--vocab_size", "128", "--seq_length", "32",
                     "--profile_batch_size", str(BSZ), "--output_prefix",
                     str(d / "port")]) == 0
    jc = j_profile(_jcfg(), bsz=BSZ, layernums=(2, 4), measure_time=False)
    j_save(jc, str(d / "jax_computation.json"), str(d / "jax_memory.json"))
    return d


def _load(pkg, d, who):
    import importlib

    cu = importlib.import_module(f"{pkg}.utils.config_utils")
    return cu.load_profiled_model(str(d / f"{who}_computation.json"),
                                  str(d / f"{who}_memory.json"))


def _keys(tree):
    if isinstance(tree, dict):
        return {k: _keys(v) for k, v in tree.items()}
    return type(tree).__name__ if tree is not None else "None"


def test_profile_jsons_have_the_reference_schema(profiles):
    for kind in ("computation", "memory"):
        port = json.loads((profiles / f"port_{kind}.json").read_text())
        ref = json.loads((profiles / f"jax_{kind}.json").read_text())
        assert set(port) == set(ref)
        if kind == "memory":
            assert set(port["layertype_0"]) == set(ref["layertype_0"])
            assert set(port["other"]) == set(ref["other"])
            assert set(port["layertype_0"]["activation_mb_per_sample"]) == \
                set(ref["layertype_0"]["activation_mb_per_sample"])


def test_analytic_fields_equal_and_measured_fields_positive(profiles):
    t = _load("galvatron_tpu_torch", profiles, "port")
    j = _load("galvatron_tpu", profiles, "jax")
    tl, jl = t.layer_types[0], j.layer_types[0]
    assert tl.parameter_mb == jl.parameter_mb
    assert tl.boundary_activation_mb_per_sample == jl.boundary_activation_mb_per_sample
    assert t.other_param_mb == j.other_param_mb
    assert t.other_act_mb_per_sample == j.other_act_mb_per_sample
    assert t.hidden_size == j.hidden_size
    assert tl.fwd_ms_per_sample > 0 and t.other_fwd_ms_per_sample >= 0
    assert tl.activation_mb_per_sample[1] > 0
    for tp in (2, 4, 8):  # one process: the analytic 1/tp curve
        assert tl.activation_mb_per_sample[tp] == pytest.approx(
            tl.activation_mb_per_sample[1] / tp)
    assert t.measured_vocab_slope_ms == {}  # the vocab fit is measured on the card only


@pytest.mark.parametrize("who", ["port", "jax"])
def test_each_json_loads_in_both_packages_and_gives_one_plan(profiles, who):
    plans = []
    for pkg in ("galvatron_tpu", "galvatron_tpu_torch"):
        import importlib

        cm = importlib.import_module(f"{pkg}.search.cost_model")
        se = importlib.import_module(f"{pkg}.search.search_engine")
        costs = _load(pkg, profiles, who)
        hw = cm.ProfiledHardware(allreduce_bw={"2_1": 150.0, "4_1": 140.0, "8_1": 120.0},
                                 p2p_bw={2: 50.0, 4: 50.0})
        eng = se.SearchEngine(costs, hw, num_layers=4, space=se.SearchSpace(world_size=8),
                              memory_budget_mb=64.0, mixed_precision="fp32")
        r = eng.search([8, 16], max_chunks=4)
        assert r is not None
        plans.append((r.config.to_json_dict(), r.cost_ms, r.memory_mb))
    assert plans[0][0] == plans[1][0]
    assert plans[0][1] == pytest.approx(plans[1][1], rel=1e-9)
    assert plans[0][2] == pytest.approx(plans[1][2], rel=1e-9)


def test_cpu_activation_measure_counts_saved_tensors():
    """On the CPU the activation measure is the bytes autograd saves: it
    grows with the layer count and the batch."""
    from galvatron_tpu_torch.profiling import model as pm

    dev = torch.device("cpu")
    b = {(L, n): pm._act_bytes(_tcfg(num_layers=L), n, 32, dev) for L in (1, 2) for n in (2, 4)}
    assert b[(2, 2)] > b[(1, 2)] > 0
    assert b[(2, 4)] > b[(2, 2)]
    assert "saved_tensors_hooks" in pm.act_measure("cpu")
    assert "CUDA allocator" in pm.act_measure("cuda")


def test_adaptive_layer_counts_halve_on_out_of_memory(monkeypatch, capsys):
    from galvatron_tpu_torch.profiling import model as pm

    seen = []

    def fake_iter(cfg, bsz, seq, device, iters=4):
        seen.append(cfg.num_layers)
        if cfg.num_layers > 2:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (test)")
        return 10.0 * cfg.num_layers + 1.0

    monkeypatch.setattr(pm, "_iter_time_ms", fake_iter)
    costs = pm.profile_model(_tcfg(num_layers=8), bsz=BSZ, device="cpu")
    out = capsys.readouterr().out
    assert "out of memory at layer counts (4, 8); dropping to (2, 4)" in out
    assert "dropping to (1, 2)" in out and "layer counts (1, 2)" in out
    assert costs.layer_types[0].fwd_ms_per_sample == pytest.approx(10.0 / BSZ / 3.0)
    # explicit counts are never changed, and no other error is caught
    with pytest.raises(torch.cuda.OutOfMemoryError):
        pm.profile_model(_tcfg(num_layers=8), bsz=BSZ, layernums=(2, 4), device="cpu")
    monkeypatch.setattr(pm, "_iter_time_ms", lambda *a, **k: (_ for _ in ()).throw(
        RuntimeError("not a memory error")))
    with pytest.raises(RuntimeError, match="not a memory error"):
        pm.profile_model(_tcfg(num_layers=8), bsz=BSZ, device="cpu")


@pytest.mark.parametrize("kw,item", [(dict(moe_experts=4), "§1.9"),
                                     (dict(enc_layers=2, enc_seq=32), "§1.10"),
                                     (dict(image_size=32, patch_size=8), "§1.10")])
def test_unported_profiles_raise_naming_their_item(kw, item):
    """Swin profiles raise naming §1.10 (a ViT profile runs:
    ``tests/test_torch_vision.py``; its Swin variant, the case with
    ``image_size``, raises); an encoder-decoder profile (ported) runs and
    gives its two layer types, and its Swin variant raises; an MoE profile
    (§1.9, ported) runs and carries the expert fields the EP search reads
    (their values against the JAX package: tests/test_torch_moe.py)."""
    from galvatron_tpu_torch.profiling.model import profile_model

    if "image_size" in kw:
        kw = dict(kw, causal=False, objective="cls", swin_depths=(1, 1), num_layers=2)
    if "enc_layers" in kw:
        costs = profile_model(_tcfg(**kw), bsz=BSZ, measure_time=False, device="cpu")
        enc, dec = costs.layer_types[0], costs.layer_types[kw["enc_layers"]]
        assert enc is not dec and dec.parameter_mb > enc.parameter_mb
        kw = dict(kw, swin_depths=(1, 1))

    if item == "§1.9":
        lt = profile_model(_tcfg(**kw), bsz=BSZ, measure_time=False, device="cpu").layer_types[0]
        assert 0.0 < lt.moe_expert_param_fraction < 1.0 and lt.moe_a2a_mb_per_sample > 0
        return
    with pytest.raises(NotImplementedError, match=item):
        profile_model(_tcfg(**kw), bsz=BSZ, device="cpu")


def test_vocab_fit_on_a_zero_layer_model():
    from galvatron_tpu_torch.profiling.model import profile_vocab_costs

    slope, const, mp = profile_vocab_costs(_tcfg(dtype=torch.float32), BSZ, iters=2,
                                           device="cpu")
    assert set(slope) == set(const) == {1} and mp == "fp32"
    assert slope[1] >= 0 and const[1] >= 0


def test_runtime_profiler_windows_and_report():
    from galvatron_tpu_torch.profiling.runtime import RuntimeProfiler

    for windowed in (False, True):
        prof = RuntimeProfiler(warmup_iters=1, windowed=windowed, device=torch.device("cpu"))
        for _ in range(4):
            prof.begin_iter()
            x = torch.ones(64, 64) @ torch.ones(64, 64)
            prof.end_iter(x.sum())
        prof.finish(x.sum())
        assert len(prof.iter_times_ms) == 3 and prof.avg_iter_ms > 0
        rep = prof.report(8, 32, predicted_ms=prof.avg_iter_ms)
        assert "fidelity" in rep and "= 1.000" in rep
        assert prof.memory_stats() == {}  # no allocator to read on the CPU


def test_memory_fidelity_prediction_is_the_reference_arithmetic():
    from galvatron_tpu.core import strategy as js
    from galvatron_tpu.search import memory_fidelity as jmf
    from galvatron_tpu.search import theoretical as jth
    from galvatron_tpu_torch.core import strategy as ts
    from galvatron_tpu_torch.search import memory_fidelity as tmf
    from galvatron_tpu_torch.search import theoretical as tth

    for pp, ptype, tp in ((1, "gpipe", 1), (2, "pipedream_flush", 2), (2, "gpipe", 1)):
        want = jmf.predicted_train_mb(
            jth.analytic_model_costs(_jcfg()), _jcfg(),
            js.HybridParallelConfig.uniform(4, pp=pp, tp=tp, chunks=2, pipeline_type=ptype),
            8, 16)
        got = tmf.predicted_train_mb(
            tth.analytic_model_costs(_tcfg()), _tcfg(),
            ts.HybridParallelConfig.uniform(4, pp=pp, tp=tp, chunks=2, pipeline_type=ptype),
            8, 16)
        assert got == pytest.approx(want, rel=1e-12)
    row = tmf.fidelity_row("x", tth.analytic_model_costs(_tcfg()), _tcfg(),
                           ts.HybridParallelConfig.uniform(4), 8, world=1,
                           measured={"total_mb": 10.0, "state_mb": 4.0, "temp_mb": 6.0})
    assert row.ratio == pytest.approx(row.predicted_mb / 10.0)
    assert "x" in tmf.format_rows([row])
    with pytest.raises(ValueError, match="card"):
        tmf.measured_train_mb(_tcfg(), ts.HybridParallelConfig.uniform(4), 8, device="cpu")


def _jax_hardware(tmp_path, devices):
    """The JAX ``cli profile-hardware`` on a ``devices``-device CPU platform
    (a subprocess: the suite's own process holds 8)."""
    out = tmp_path / f"jax_hw_{devices}.json"
    code = (
        "import os, sys\n"
        f"os.environ['XLA_FLAGS'] = '--xla_force_host_platform_device_count={devices}'\n"
        "import jax\n"
        "jax.config.update('jax_platforms', 'cpu')\n"
        "from galvatron_tpu.cli import main\n"
        f"sys.exit(main(['profile-hardware', '--profile_size_mb', '0.25', "
        f"'--hardware_output_path', {str(out)!r}]))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(out.read_text())


def test_world_one_hardware_json_is_the_reference(tmp_path):
    from galvatron_tpu_torch import cli

    out = tmp_path / "port_hw.json"
    assert cli.main(["profile-hardware", "--device", "cpu", "--hardware_output_path",
                     str(out)]) == 0
    assert json.loads(out.read_text()) == _jax_hardware(tmp_path, 1)


def test_two_rank_gloo_world_has_the_reference_keys(tmp_path):
    from galvatron_tpu_torch.parallel.launch import launch_local

    out = tmp_path / "port_hw2.json"
    ranks = launch_local([sys.executable, "-m", "galvatron_tpu_torch.cli", "profile-hardware",
                          "--device", "cpu", "--profile_size_mb", "0.25",
                          "--hardware_output_path", str(out)], 2, timeout_s=300, cwd=str(ROOT),
                         env=dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1"))
    assert all(r.returncode == 0 for r in ranks), "\n".join(r.output[-2000:] for r in ranks)
    got = json.loads(out.read_text())
    want = _jax_hardware(tmp_path, 2)
    assert _keys(got) == _keys(want)
    assert set(got["allreduce"]) == {"2_1"} and set(got["p2p"]) == {"2"}
    assert all(v > 0 for v in got["allreduce"].values()) and got["overlap_coe"] >= 1.0
    from galvatron_tpu.utils.config_utils import load_profiled_hardware

    hw = load_profiled_hardware(str(out))  # the JAX loader reads the port's file
    assert hw.p2p_bw[2] == got["p2p"]["2"]
    assert np.isfinite(hw.overlap_coe)
