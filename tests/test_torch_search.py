"""The port's strategy search against the JAX package's, on the CPU.

Every scenario of ``tests/test_search.py`` and ``tests/test_theoretical.py``
runs twice: once built from the JAX package's modules, once from the port's
(``galvatron_tpu_torch.search``), on the same ``ProfiledModelCosts`` /
``ProfiledHardware`` numbers and the same budgets. The results — emitted
plan dicts, predicted costs, tables, chosen strategies — must be equal,
floats within 1e-9 relative. The DP routes (the port's C++ core, its NumPy
DP, the JAX package's ``dp_core_native``) must agree with each other and
with brute force.

The last test closes the loop: the port's ``cli search`` (the tiny flags of
``tests/test_cli.py``) emits a plan for 8 devices, an 8-rank gloo world
trains it from the JAX package's initial weights and batches, and its 3-step
losses must match the JAX ``cli train`` of the same plan within 2e-4.

Run as a script (``python tests/test_torch_search.py worker CASE OUT``) this
file is one rank of that world; that path imports no JAX.
"""

import dataclasses
import itertools
import json
import os
import pickle
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import _torch_threads  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
REL = 1e-9
LOSS_TOL = 2e-4  # tests/test_hybrid_runtime.py's rtol / atol


# ---------------------------------------------------------------------------
# the two packages, side by side
# ---------------------------------------------------------------------------


def _pkg(name):
    import importlib

    mod = lambda m: importlib.import_module(f"{name}.{m}")  # noqa: E731
    return types.SimpleNamespace(
        name=name,
        st=mod("core.strategy"),
        cm=mod("search.cost_model"),
        se=mod("search.search_engine"),
        dp=mod("search.dynamic_programming"),
        native=mod("search.native"),
        th=mod("search.theoretical"),
        mod=mod("models.modeling"),
    )


PKGS = ("galvatron_tpu", "galvatron_tpu_torch")


def _same(a, b, path="result"):
    """Equal structures; floats within REL relative (1e-12 absolute)."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (path, sorted(a), sorted(b))
        for k in a:
            _same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), (path, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, float) or isinstance(b, float):
        if np.isfinite(a) or np.isfinite(b):
            assert abs(a - b) <= REL * max(abs(a), abs(b)) + 1e-12, (path, a, b)
        else:
            assert a == b or (np.isnan(a) and np.isnan(b)), (path, a, b)
    else:
        assert a == b, (path, a, b)


def _plain(x):
    """JSON-able form (numpy scalars and arrays become Python values)."""
    return json.loads(json.dumps(x, default=lambda v: v.tolist() if hasattr(v, "tolist")
                                 else str(v)))


def _result(r):
    if r is None:
        return None
    return _plain({"config": r.config.to_json_dict(), "cost_ms": r.cost_ms,
                   "throughput": r.throughput_samples_per_s, "global_bsz": r.global_bsz,
                   "memory_mb": r.memory_mb, "details": r.details})


def _both(scenario):
    """Run ``scenario(m)`` with each package; assert the outputs equal."""
    ref, port = (scenario(_pkg(p)) for p in PKGS)
    _same(ref, port)
    return port


# ---------------------------------------------------------------------------
# the scenarios' inputs (tests/test_search.py's), built from package m
# ---------------------------------------------------------------------------


def toy_costs(m, param_mb=80.0, act_mb=40.0):
    lt = m.cm.ProfiledLayerType(
        fwd_ms_per_sample=2.0, parameter_mb=param_mb,
        activation_mb_per_sample={1: act_mb, 2: act_mb / 2, 4: act_mb / 4, 8: act_mb / 8},
        boundary_activation_mb_per_sample=4.0,
    )
    return m.cm.ProfiledModelCosts(layer_types={0: lt}, other_param_mb=100.0,
                                   other_act_mb_per_sample=8.0, other_fwd_ms_per_sample=0.3)


def toy_hw(m):
    return m.cm.ProfiledHardware(
        allreduce_bw={"2_1": 150.0, "2_0": 30.0, "4_1": 140.0, "4_0": 25.0, "8_1": 120.0},
        p2p_bw={2: 50.0, 4: 50.0}, overlap_coe=1.1,
    )


def ref_hw(m):
    """The 16-device reference-shaped hardware of the homogeneity tests."""
    return m.cm.ProfiledHardware(
        allreduce_bw={"16_1": 45.7, "8_1": 153.5, "8_0": 32.1, "4_1": 152.4, "4_0": 19.3,
                      "2_1": 151.2, "2_0": 9.3},
        p2p_bw={2: 7.97, 4: 8.82, 8: 8.90, 16: 8.81}, overlap_coe=1.146,
    )


def make_engine(m, budget_mb, **space_kw):
    return m.se.SearchEngine(toy_costs(m), toy_hw(m), num_layers=8,
                             space=m.se.SearchSpace(world_size=8, **space_kw),
                             memory_budget_mb=budget_mb)


def lt_of(m, fwd=2.0, p=80.0, act=None, b=4.0):
    return m.cm.ProfiledLayerType(
        fwd_ms_per_sample=fwd, parameter_mb=p,
        activation_mb_per_sample=act or {1: 40.0, 2: 20.0, 4: 10.0, 8: 5.0},
        boundary_activation_mb_per_sample=b)


def _strategy_tuple(s):
    return dataclasses.astuple(s)


# ---------------------------------------------------------------------------
# scenarios
# ---------------------------------------------------------------------------


def rand_dp_instance(seed, L=5, S=4, V=30):
    rng = np.random.RandomState(seed)
    mem = rng.randint(1, 12, (L, S)).astype(np.int32)
    intra = rng.uniform(1.0, 10.0, (L, S))
    inter = rng.uniform(0.0, 2.0, (S, S))
    np.fill_diagonal(inter, 0.0)
    return mem, intra, inter, V


def brute_force(mem, intra, inter, V):
    L, S = mem.shape
    best = np.inf
    for combo in itertools.product(range(S), repeat=L):
        if sum(mem[i, c] for i, c in enumerate(combo)) > V:
            continue
        c = sum(intra[i, ci] for i, ci in enumerate(combo))
        c += sum(inter[combo[i], combo[i + 1]] for i in range(L - 1))
        best = min(best, c)
    return best


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_dp_routes_agree_with_brute_force_and_the_reference(seed):
    from galvatron_tpu.search.native import dp_core_native as ref_native
    from galvatron_tpu_torch.search import dynamic_programming as tdp
    from galvatron_tpu_torch.search import native

    mem, intra, inter, V = rand_dp_instance(seed)
    bf = brute_force(mem, intra, inter, V)
    nat = native.dp_core_native(mem, intra, inter, V)
    assert nat is not None, native.BUILD_ERROR
    npy = tdp.dp_numpy(mem, intra, inter, V)
    ref = ref_native(mem, intra, inter, V)
    assert ref is not None
    for cost, res, used in (nat, npy, ref):
        assert np.isclose(cost, bf), (cost, bf)
        c = sum(intra[i, res[i]] for i in range(len(res)))
        c += sum(inter[res[i], res[i + 1]] for i in range(len(res) - 1))
        assert np.isclose(c, cost)
        assert used == sum(mem[i, res[i]] for i in range(len(res))) <= V
    np.testing.assert_array_equal(nat[1], ref[1])
    assert tdp.run_dp(mem, intra, inter, V)[0] == nat[0] and native.ROUTE == "native"


def test_dp_route_falls_back_to_numpy_and_says_so(monkeypatch):
    from galvatron_tpu_torch.search import dynamic_programming as tdp
    from galvatron_tpu_torch.search import native

    mem, intra, inter, V = rand_dp_instance(7)
    want = native.dp_core_native(mem, intra, inter, V)
    monkeypatch.setattr(native, "get_dp_core", lambda: None)
    cost, res, used = tdp.run_dp(mem, intra, inter, V)
    assert native.ROUTE == "numpy"
    assert np.isclose(cost, want[0]) and used == want[2]


def test_dp_core_builds_into_the_port_build_dir():
    from galvatron_tpu_torch.search import native

    lib = native.get_dp_core()
    assert lib is not None, native.BUILD_ERROR
    assert Path(lib._name).parent == ROOT / "build" / "torch_kernels"


def test_dp_infeasible():
    def sc(m):
        mem = np.full((3, 2), 50, np.int32)
        cost, res, _ = m.dp.run_dp(mem, np.ones((3, 2)), np.zeros((2, 2)), 10)
        return [float(cost), res.tolist()]

    out = _both(sc)
    assert not np.isfinite(out[0]) and out[1] == [-1, -1, -1]


def test_strategy_space_generation():
    def sc(m):
        space = m.se.SearchSpace(world_size=8)
        out = {pp: [_strategy_tuple(s) for s in m.se.generate_layer_strategies(space, pp=pp)]
               for pp in (1, 2, 4)}
        space.allow_tp_overlap = True
        out["overlap"] = [_strategy_tuple(s) for s in m.se.generate_layer_strategies(space, 1)]
        for name in ("dp+tp", "dp+pp", "3d", "dp", "tp", "pp", "sdp"):
            sp = m.se.apply_search_space(m.se.SearchSpace(world_size=8), name)
            out[name] = [_strategy_tuple(s) for s in m.se.generate_layer_strategies(sp, 1)]
        return out

    out = _both(sc)
    assert len(out[1]) > len(out[4]) > 0


def test_tp_overlap_pricing():
    def sc(m):
        space = m.se.SearchSpace(world_size=8, allow_tp_overlap=True)
        lt, hw = toy_costs(m).layer_types[0], toy_hw(m)
        return [m.cm.layer_time_cost(lt, s, hw, world=8, pp=1, global_bsz=8)
                for s in m.se.generate_layer_strategies(space, pp=1)]

    _both(sc)


@pytest.mark.parametrize("budget", [20000.0, 1500.0, 900.0, 40.0])
def test_budget_drives_the_plan(budget):
    """tests/test_search.py's roomy / runnable / tight / infeasible budgets."""
    out = _both(lambda m: _result(make_engine(m, budget).search([8])))
    assert (out is None) == (budget == 40.0)


def test_pipeline_search_respects_stacking():
    out = _both(lambda m: _result(make_engine(m, 1200.0, pp_choices=[2, 4]).search([16])))
    assert out["config"]["pp_deg"] in (2, 4)


def test_vpp_evaluations_and_sweep():
    def sc(m):
        eng = make_engine(m, 3000.0, max_vpp=2, pipeline_types=("gpipe",))
        out = [_result(eng.evaluate(2, 16, 4, "gpipe", vpp=v)) for v in (1, 2, 8)]
        out.append(_result(eng.evaluate(2, 18, 3, "gpipe", vpp=2)))
        out.append(_result(eng.evaluate(2, 16, 4, "pipedream_flush", vpp=2)))
        out.append(_result(eng.search([16])))
        return out

    out = _both(sc)
    assert out[1]["cost_ms"] < out[0]["cost_ms"] and out[2] is None and out[3] is None


def test_vocab_strategy_searched():
    def sc(m):
        lt = lt_of(m)
        hw = m.cm.ProfiledHardware(allreduce_bw={"2_1": 150.0, "2_0": 30.0, "4_1": 140.0,
                                                 "8_1": 120.0}, overlap_coe=1.1)
        space = m.se.SearchSpace(world_size=8, pp_choices=[1], max_tp=2)
        out = []
        for other_mb, budget in ((4000.0, 50000.0), (4000.0, 2600.0), (10.0, 50000.0)):
            costs = m.cm.ProfiledModelCosts(layer_types={0: lt}, other_param_mb=other_mb,
                                            other_act_mb_per_sample=8.0,
                                            other_fwd_ms_per_sample=0.3)
            out.append(_result(m.se.SearchEngine(costs, hw, 4, space,
                                                 memory_budget_mb=budget).search([8])))
        return out

    out = _both(sc)
    assert out[1]["config"]["vocab_tp"] > 1 or out[1]["config"]["embed_sdp"]


@pytest.mark.parametrize("k_ms", [7.0, 0.0])
def test_transition_costs_ride_pipeline_ticks(monkeypatch, k_ms):
    def sc(m):
        costs = m.cm.ProfiledModelCosts(layer_types={0: lt_of(m)}, other_param_mb=100.0,
                                        other_act_mb_per_sample=8.0,
                                        other_fwd_ms_per_sample=0.0)
        space = m.se.SearchSpace(world_size=8, pp_choices=[2], max_tp=1, allow_sp=False,
                                 allow_ckpt=False, allow_zero2=False, allow_zero3=False,
                                 allow_strided=False)
        eng = m.se.SearchEngine(costs, m.cm.ProfiledHardware(overlap_coe=1.0), 4, space,
                                memory_budget_mb=50000.0)
        monkeypatch.setattr(m.se, "transition_cost_ms", lambda a, b, *r, **kw: k_ms)
        return _result(eng.evaluate(2, 16, 4, "gpipe"))

    _both(sc)


def test_fallback_bandwidths_labeled(tmp_path):
    def sc(m):
        costs = m.cm.ProfiledModelCosts(
            layer_types={0: lt_of(m, act={1: 40.0, 2: 20.0})}, other_param_mb=100.0,
            other_act_mb_per_sample=8.0, other_fwd_ms_per_sample=0.3)
        space = lambda: m.se.SearchSpace(world_size=8, pp_choices=[2], max_tp=2)  # noqa: E731
        eng = m.se.SearchEngine(costs, m.cm.ProfiledHardware(), 4, space(),
                                memory_budget_mb=20000.0)
        r = eng.evaluate(2, 8, 2, "gpipe")
        path = tmp_path / f"{m.name}.json"
        eng.save_result(r, str(path))
        hw = m.cm.ProfiledHardware(allreduce_bw={"2_1": 100.0}, p2p_bw={2: 50.0})
        eng2 = m.se.SearchEngine(costs, hw, 4, space(), memory_budget_mb=20000.0)
        return [_result(r), json.loads(path.read_text()), _result(eng2.evaluate(2, 8, 2, "gpipe"))]

    out = _both(sc)
    assert set(out[0]["details"]["fallback_bandwidths"]) == {"allreduce_bw", "p2p_bw"}
    assert "fallback_bandwidths" in out[1] and out[2]["details"]["fallback_bandwidths"] == []


@pytest.mark.parametrize("budget_gb", [9, 11, 30])
def test_homogeneity_gap(budget_gb):
    def sc(m):
        lt = lt_of(m, fwd=4.64, p=808.0, act={1: 57.2, 2: 28.6, 4: 14.3, 8: 7.2}, b=16.8)
        costs = m.cm.ProfiledModelCosts(layer_types={0: lt}, other_param_mb=1049.0,
                                        other_act_mb_per_sample=262.0,
                                        other_fwd_ms_per_sample=0.4, hidden_size=4096)
        eng = m.se.SearchEngine(costs, ref_hw(m), num_layers=32,
                                space=m.se.SearchSpace(world_size=16, pp_choices=[2]),
                                memory_budget_mb=budget_gb * 1000.0)
        return _plain(eng.homogeneity_gap(2, 64, 16))

    out = _both(sc)
    assert out is not None and abs(out["delta_pct"]) < 1e-6


def test_recommend_min_bsz():
    def sc(m):
        lt = lt_of(m, fwd=1.0, p=40.0, act={1: 20.0, 2: 10.0, 4: 5.0, 8: 2.5}, b=2.0)
        costs = m.cm.ProfiledModelCosts(layer_types={0: lt}, other_param_mb=30.0,
                                        other_act_mb_per_sample=4.0,
                                        other_fwd_ms_per_sample=0.2)
        hw = m.cm.ProfiledHardware(allreduce_bw={"8_1": 120.0})
        eng = lambda b: m.se.SearchEngine(  # noqa: E731
            costs, hw, num_layers=4, space=m.se.SearchSpace(world_size=8, pp_choices=[1]),
            memory_budget_mb=b)
        recs = [eng(b).recommend_min_bsz(scale=8) for b in (4000.0, 900.0, 1.0)]
        return recs + [_result(eng(4000.0).search([recs[0]]))]

    out = _both(sc)
    assert out[0] > out[1] >= 8 and out[2] == 8


def test_search_restrictions_labeled(tmp_path):
    def sc(m):
        lt = lambda ms: lt_of(m, fwd=ms, p=10.0, act={1: 8.0}, b=1.0)  # noqa: E731
        costs3 = m.cm.ProfiledModelCosts(layer_types={0: lt(1.0), 1: lt(1.5), 2: lt(2.0)},
                                         other_param_mb=5.0, other_act_mb_per_sample=1.0,
                                         other_fwd_ms_per_sample=0.1)
        eng = m.se.SearchEngine(costs3, m.cm.ProfiledHardware(), num_layers=3,
                                space=m.se.SearchSpace(world_size=4, pp_choices=[1, 2],
                                                       max_tp=1),
                                memory_budget_mb=2000.0, mixed_precision="fp32")
        r = eng.search([8], max_chunks=4)
        out = tmp_path / f"{m.name}.json"
        eng.save_result(r, str(out))
        return [_result(r), json.loads(out.read_text())]

    out = _both(sc)
    assert "section_pipeline_odd_pair_count_pp1_only" in out[1]["search_restrictions"]


def test_encdec_analytic_costs_search_pp2():
    """The analytic encoder-decoder costs (two layer types) and the coupled
    enc-dec pipeline pricing: the same plan in both packages."""
    def sc(m):
        cfg = m.mod.ModelConfig(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
                                ffn_dim=128, max_seq_len=16, enc_layers=2, enc_seq=16,
                                pos_embed="learned", tie_word_embeddings=True)
        eng = m.se.SearchEngine(m.th.analytic_model_costs(cfg), m.cm.ProfiledHardware(),
                                num_layers=cfg.total_layers,
                                space=m.se.SearchSpace(world_size=4, pp_choices=[1, 2],
                                                       max_tp=1),
                                memory_budget_mb=2000.0, mixed_precision="fp32")
        return [_result(eng.evaluate(2, 8, 1, "gpipe")), _result(eng.search([8], max_chunks=8))]

    _both(sc)


def test_uneven_layer_counts_at_vpp1():
    def sc(m):
        costs = m.cm.ProfiledModelCosts(layer_types={0: lt_of(m, 1.0, 10.0, {1: 8.0}, 1.0)},
                                        other_param_mb=5.0, other_act_mb_per_sample=1.0,
                                        other_fwd_ms_per_sample=0.1)
        eng = m.se.SearchEngine(costs, m.cm.ProfiledHardware(), num_layers=3,
                                space=m.se.SearchSpace(world_size=4, pp_choices=[2], max_tp=1,
                                                       max_vpp=2),
                                memory_budget_mb=2000.0, mixed_precision="fp32")
        return _result(eng.search([8], max_chunks=4))

    out = _both(sc)
    assert sorted(int(x) for x in out["config"]["pp_division"].split(",")) == [1, 2]


@pytest.mark.parametrize("allow_sp,budget", [(True, 4000.0), (True, 900.0),
                                             (False, 4000.0), (False, 900.0)])
def test_spmd_crash_guard_kept(allow_sp, budget):
    """The JAX package's exclusion of its partitioner's crash cell is kept,
    so both packages emit the same candidates (ROADMAP.md §3)."""
    def sc(m):
        eng = make_engine(m, budget, allow_sp=allow_sp, pp_choices=[1, 2])
        return [_result(r) for r in eng.search_topk([8, 16], k=64, max_chunks=8)]

    for r in _both(sc):
        c = r["config"]
        tps = [int(x) for x in c["tp_sizes_enc"].split(",")]
        sps = [int(x) for x in c["sp_flags"].split(",")]
        assert not (c["pp_deg"] > 1 and c["pipeline_type"] == "pipedream_flush"
                    and c["vocab_tp"] > 1 and any(t > 1 and not s for t, s in zip(tps, sps)))


def test_spmd_crash_guard_keeps_safe_vocab_tp_choices():
    _both(lambda m: _result(make_engine(m, 4000.0, pp_choices=[2]).evaluate(
        2, 16, 4, "pipedream_flush")))


# ---------------------------------------------------------------------------
# tests/test_theoretical.py's scenarios
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["llama-0.3b", "gpt-0.3b", "opt-125m", "llama-7b"])
def test_param_counts_equal_the_port_init(name):
    """The analytic counts equal the reference's and the element count of
    the port's own ``init_model_params`` (on the meta device)."""
    from galvatron_tpu_torch.core.optim import tree_leaves

    def sc(m):
        cfg = m.mod.PRESETS[name].replace(num_layers=2)
        return [m.th.layer_param_count(cfg), m.th.other_param_count(cfg),
                m.th.total_param_count(cfg)]

    layer, other, total = _both(sc)
    t = _pkg("galvatron_tpu_torch")
    cfg = t.mod.PRESETS[name].replace(num_layers=2)
    params = t.mod.init_model_params(cfg, 0, "meta")
    assert sum(p.numel() for p in tree_leaves(params["layers"][0])) == layer
    assert sum(p.numel() for p in tree_leaves(params)) == total


def test_states_activations_and_report():
    def sc(m):
        L = m.st.LayerStrategy
        cfg = m.mod.PRESETS["llama-0.3b"]
        c7 = m.mod.PRESETS["llama-7b"]
        out = [m.th.layer_states_mb(cfg, L(dp_type=d), world=8)
               for d in ("ddp", "zero2", "zero3")]
        out.append(m.th.layer_states_mb(cfg, L(tp=2), world=8))
        for impl in ("flash", "xla"):
            for s in (L(), L(tp=4), L(tp=4, sp=True)):
                out.append(m.th.layer_activation_mb_per_sample(c7.replace(attn_impl=impl), s))
        out.append(m.th.report(cfg, L(tp=2, dp_type="zero3"), world=8).lines())
        return out

    out = _both(sc)
    assert out[0] > out[1] > out[2]


def test_check_cost_model_table():
    def sc(m):
        lt = lt_of(m, 1.0, 50.0, {1: 40.0, 2: 22.0, 4: 12.0})
        costs = m.cm.ProfiledModelCosts(layer_types={0: lt}, other_param_mb=100.0,
                                        other_act_mb_per_sample=8.0)
        eng = m.se.SearchEngine(costs, m.cm.ProfiledHardware(), num_layers=4,
                                space=m.se.SearchSpace(world_size=8), memory_budget_mb=16000)
        return [eng.check_cost_model(global_bsz=8),
                eng.check_cost_model(8, strategies=[m.st.LayerStrategy(tp=2, dp_type="zero3")])]

    out = _both(sc)
    assert "vtp2-zero3" in out[0] and "1-2-4f" in out[1]


@pytest.mark.parametrize("impl", ["flash", "xla"])
def test_analytic_costs_drive_search(impl):
    def sc(m):
        cfg = m.mod.PRESETS["llama-0.3b"].replace(num_layers=4, attn_impl=impl)
        costs = m.th.analytic_model_costs(cfg, seq_len=512)
        eng = m.se.SearchEngine(costs, m.cm.ProfiledHardware(), num_layers=4,
                                space=m.se.SearchSpace(world_size=8, max_tp=4),
                                memory_budget_mb=8000)
        return [_plain(dataclasses.asdict(costs)), _result(eng.search([8], max_chunks=4))]

    out = _both(sc)
    assert out[1]["throughput"] > 0


def test_vision_analytic_costs_raise_naming_the_item():
    """Swin's analytic costs price one layer type a layer (their values
    against the JAX package: ``tests/test_torch_swin.py``), as a ViT's
    (``tests/test_torch_vision.py``) price one."""
    from galvatron_tpu_torch.models.modeling import ModelConfig
    from galvatron_tpu_torch.search import theoretical

    swin = theoretical.analytic_model_costs(ModelConfig(image_size=224, num_layers=2,
                                                        swin_depths=(1, 1), patch_size=4))
    assert set(swin.layer_types) == {0, 1}
    assert swin.layer_types[1].parameter_mb > swin.layer_types[0].parameter_mb
    assert theoretical.analytic_model_costs(ModelConfig(image_size=224, num_layers=2))


# ---------------------------------------------------------------------------
# cli search → an 8-rank gloo world against the JAX cli train
# ---------------------------------------------------------------------------

TINY = ["--model_size", "llama-0.3b", "--hidden_size", "64", "--num_layers", "4",
        "--num_heads", "4", "--ffn_dim", "128", "--vocab_size", "128", "--seq_length", "32"]
TRAIN = ["--global_train_batch_size", "8", "--train_iters", "3", "--mixed_precision", "fp32"]
WORLD = 8


def _worker(case_path: str, out_dir: str) -> None:
    """One rank: the plan from the JAX weights and batches, under the
    optimizer ``cli train``'s flags give (no JAX here)."""
    import torch
    import torch.distributed as dist

    from galvatron_tpu_torch import bridge
    from galvatron_tpu_torch.core.arguments import (
        adam_config_from_args,
        hybrid_config_from_args,
        initialize_galvatron,
        model_config_from_args,
    )
    from galvatron_tpu_torch.core.trainer import init_distributed
    from galvatron_tpu_torch.parallel import hybrid

    torch.set_num_threads(1)
    init_distributed(torch.device("cpu"), "gloo", timeout_s=300)
    rank, world = dist.get_rank(), dist.get_world_size()
    with open(case_path, "rb") as f:
        case = pickle.load(f)
    try:
        ns = initialize_galvatron("train", case["argv"])
        cfg = model_config_from_args(ns).replace(dtype=torch.float32)
        hp = hybrid_config_from_args(ns, cfg.num_layers, world)
        rt = hybrid.build_runtime(cfg, hp, adam_config_from_args(ns),
                                  global_batch_size=ns.global_train_batch_size,
                                  seq_len=cfg.max_seq_len, device="cpu")
        local = bridge.shard_params(case["params"], cfg, hp, rank, world)
        state = rt.state_from(hybrid.zip_map(
            lambda a, n: torch.from_numpy(np.array(a, copy=True)), local))
        losses = []
        for b in case["batches"]:
            state, loss = rt.train_step(state, torch.from_numpy(b))
            losses.append(float(loss))
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(losses, f)
    finally:
        dist.destroy_process_group()


def _jax_initial_params(key, cfg, plan_path):
    """The flat parameter tree the JAX trainer starts from under the plan:
    a pipeline draws its layers from the key in its own stacked order."""
    from galvatron_tpu.core.strategy import HybridParallelConfig
    from galvatron_tpu.models import modeling as jm
    from galvatron_tpu.parallel import pipeline, pipeline_interleaved

    hp = HybridParallelConfig.load(plan_path)
    if hp.pp == 1:
        return jm.init_model_params(key, cfg)
    if hp.vpp == 1:
        return pipeline.flatten_stacked_layers(pipeline.init_pipeline_params(key, cfg, hp),
                                               cfg, hp)
    return pipeline_interleaved.flatten_vstages(
        pipeline_interleaved.init_interleaved_params(key, cfg, hp), cfg, hp)


def test_cli_search_plan_trains_like_the_jax_cli_train(tmp_path):
    import jax

    from galvatron_tpu.core.arguments import initialize_galvatron as j_init
    from galvatron_tpu.core.dataloader import build_dataloader
    from galvatron_tpu.core.trainer import train as j_train
    from galvatron_tpu.models import modeling as jm
    from galvatron_tpu_torch import cli
    from galvatron_tpu_torch.parallel.launch import launch_local

    plan = str(tmp_path / "plan.json")
    assert cli.main(["search", *TINY, "--num_devices", str(WORLD), "--analytic_costs", "1",
                     "--memory_constraint_gb", "1", "--settle_bsz", "8", "--mixed_precision",
                     "fp32", "--device", "cpu", "--output_config_path", plan]) == 0
    argv = [*TINY, *TRAIN, "--galvatron_config_path", plan]
    ns = j_init("train", argv + ["--check_loss", "1"])
    jcfg = jm.PRESETS["llama-0.3b"].replace(hidden_size=64, num_layers=4, num_heads=4,
                                            ffn_dim=128, vocab_size=128, max_seq_len=32)
    loader = build_dataloader(jcfg, 8, 32, seed=ns.seed)
    batches = [np.asarray(next(loader)) for _ in range(3)]
    params = jax.tree.map(np.asarray, _jax_initial_params(jax.random.key(ns.seed), jcfg, plan))
    case_path = tmp_path / "case.pkl"
    with open(case_path, "wb") as f:
        pickle.dump({"argv": argv, "params": params, "batches": batches}, f)
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    ranks = launch_local([sys.executable, str(Path(__file__).resolve()), "worker",
                          str(case_path), str(tmp_path)], WORLD, timeout_s=600, env=env,
                         cwd=str(ROOT))
    assert all(r.returncode == 0 for r in ranks), "\n".join(r.output[-2000:] for r in ranks)
    jlosses = j_train(ns)["losses"]
    assert len(jlosses) == 3
    for r in range(WORLD):
        got = json.loads((tmp_path / f"rank{r}.json").read_text())
        np.testing.assert_allclose(got, jlosses, rtol=LOSS_TOL, atol=LOSS_TOL)


if __name__ == "__main__" and len(sys.argv) == 4 and sys.argv[1] == "worker":
    sys.path.insert(0, str(ROOT))
    _worker(sys.argv[2], sys.argv[3])
