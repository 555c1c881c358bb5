"""ViT (patch embedding, bidirectional layers, pooled class head, the 'cls'
objective) in the port against the JAX package at fp32 on the CPU, case for
case with the ViT tests of ``tests/test_vision.py`` (Swin is not ported).

The loss and every gradient equal the JAX ``lm_loss``'s within 1e-5 at 196
patches (ragged against the kernels' 64 / 128-row tiles), on the einsum
path and on the flash path (on the CPU: the grid kernels' plain versions,
unmasked); the synthetic image rows are the JAX rows byte for byte; the
analytic costs and ``cli search`` / ``check-plan`` of a tiny ViT and a tiny
BERT are the JAX package's; the presets have the JAX shapes. One 8-rank
gloo world trains the ViT under every ``VIT_STRATEGIES`` plan of the JAX
test (tp 2 with SP over 16 classes at vocab tp 2, ZeRO-3 with recompute, two
micro-batches), pp 2 under GPipe and 1F1B, interleaved (vpp 2) and tp 2 on
the flash path at 196 patches, each held to the JAX single-device 3-step
losses within 2e-4 and the gathered parameters within 1e-4 (an element
whose first gradient is within fp32 rounding of zero is held to steps x
lr). ``cli profile`` of a ViT and the ``vit`` entry package run.

Run as a script (``python tests/test_torch_vision.py worker CASES OUT``)
this file is one rank of the world; that path imports no JAX.
"""

import contextlib
import dataclasses
import io
import json
import os
import pickle
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
ATOL = 1e-5  # fp32 on both sides, matmuls summed in other orders
WORLD = 8
STEPS = 3
BATCH = 16  # two micro-batches of 8 rows split over 8 ranks (the port does not pad)
LR = 1e-3
LOSS_TOL = 2e-4  # tests/test_vision.py's rtol / atol
PARAM_ATOL = 1e-4
ROUNDING_OF_ZERO = 1e-5  # tests/test_torch_pipeline.py's AdamW rule
NOISE_SHARE = 1e-3
WORLD_TIMEOUT_S = 600
# tests/test_vision.py's VIT_CFG (16 patches of 4 x 4 x 3 pixels)
SHAPE = dict(vocab_size=1, hidden_size=64, num_layers=4, num_heads=4, max_seq_len=0,
             pos_embed="learned", norm_type="layernorm", act_fn="gelu", causal=False,
             objective="cls", image_size=16, patch_size=4, num_classes=16)
# 196 patches (14 x 14 of 2 x 2 pixels): ViT-B/16's sequence at a small width
RAGGED = dict(SHAPE, hidden_size=32, num_layers=2, num_heads=2, image_size=28, patch_size=2,
              use_bias=True)


def _cfgs(**kw):
    import jax.numpy as jnp

    from galvatron_tpu.models import modeling as jm
    from galvatron_tpu_torch.models import modeling as tm

    shape = dict(SHAPE, **kw)
    return jm.ModelConfig(dtype=jnp.float32, **shape), tm.ModelConfig(dtype=torch.float32,
                                                                       **shape)


def _params(jcfg, seed=0):
    """The JAX init (numpy leaves), norm scales and biases redrawn from a
    seed so that no gradient is structurally zero."""
    import jax

    from galvatron_tpu.models import modeling as jm

    rng = np.random.RandomState(seed + 100)

    def redraw(path, a):
        key = jax.tree_util.keystr(path)
        if key.endswith("'scale']"):
            return (1 + rng.standard_normal(a.shape) * 0.1).astype(np.float32)
        if key.endswith("_b']") or key.endswith("'bias']"):
            return (rng.standard_normal(a.shape) * 0.02).astype(np.float32)
        return a

    params = jax.tree.map(np.asarray, jm.init_model_params(jax.random.key(seed), jcfg))
    return jax.tree_util.tree_map_with_path(redraw, params)


def _batch(shape, seed=0, rows=BATCH):
    """Pixels ‖ label rows (``tests/_vision_common.make_vision_batches``)."""
    rng = np.random.RandomState(seed)
    n = shape["image_size"] ** 2 * 3
    return np.concatenate([rng.randint(0, 256, (rows, n)),
                           rng.randint(0, shape["num_classes"], (rows, 1))], 1).astype(np.int64)


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_loss_and_gradients_match_jax_at_196_patches(attn_impl):
    """The class loss and every gradient equal the JAX ones within 1e-5 at
    196 patches; 'flash' runs the grid kernels' plain versions on the CPU
    (196 tiles: ``flash_tileable``)."""
    import jax
    import jax.numpy as jnp

    from galvatron_tpu.models import modeling as jm
    from galvatron_tpu_torch import bridge
    from galvatron_tpu_torch.core.optim import tree_leaves
    from galvatron_tpu_torch.models import modeling as tm
    from galvatron_tpu_torch.ops.flash_attention import flash_tileable

    jcfg, tcfg = _cfgs(**RAGGED)
    assert tcfg.n_patches == 196 and flash_tileable(196)
    tcfg = tcfg.replace(attn_impl=attn_impl)
    ref = _params(jcfg)
    b = _batch(RAGGED, seed=2)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jm.lm_loss(p, jnp.asarray(b, jnp.int32), jcfg)))(jax.tree.map(jnp.asarray, ref))
    params = bridge.params_from_jax(ref, tcfg, "cpu")
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = tm.lm_loss(params, torch.from_numpy(b), tcfg)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), atol=ATOL, rtol=0)
    for (path, g), p in zip(jax.tree_util.tree_flatten_with_path(jgrads)[0], leaves):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(g), atol=ATOL, rtol=0,
                                   err_msg=jax.tree_util.keystr(path))


def test_bf16_patch_embedding_matches_jax_bitwise():
    """The pixels are cast, then divided in the compute dtype: the bf16
    patch embedding is the JAX one bit for bit."""
    import jax.numpy as jnp

    from galvatron_tpu.models import modeling as jm
    from galvatron_tpu_torch import bridge
    from galvatron_tpu_torch.models import modeling as tm

    jcfg, tcfg = _cfgs(**RAGGED)
    jcfg, tcfg = jcfg.replace(dtype=jnp.bfloat16), tcfg.replace(dtype=torch.bfloat16)
    ref = _params(jcfg)
    pixels = _batch(RAGGED, seed=4)[:, :-1]
    got = tm.vision_embed(torch.from_numpy(pixels), bridge.params_from_jax(ref, tcfg, "cpu"), tcfg)
    want = jm.vision_embed(jnp.asarray(pixels, jnp.int32), ref, jcfg)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


def test_vision_dataloader_rows_are_the_jax_rows():
    from galvatron_tpu.core.dataloader import build_dataloader as jax_loader
    from galvatron_tpu_torch.core.dataloader import build_dataloader

    jcfg, tcfg = _cfgs()
    for start in (0, 3):
        a, b = build_dataloader(tcfg, 8, seed=3, start_batch=start), jax_loader(
            jcfg, 8, seed=3, start_batch=start)
        for _ in range(3):
            x, y = next(a), next(b)
            assert x.shape == (8, tcfg.sample_len + 1) and x.dtype == np.int32
            assert x.tobytes() == y.tobytes()
    with pytest.raises(ValueError, match="do not apply to vision models"):
        build_dataloader(tcfg, 8, data_path="/nonexistent")


def test_preset_shapes_match_jax():
    """Every encoder preset's parameter shapes are the JAX package's."""
    import jax

    from galvatron_tpu.models import modeling as jm
    from galvatron_tpu_torch.models import modeling as tm
    from galvatron_tpu_torch.parallel import hybrid

    for name in ("vit-base", "vit-large", "vit-huge", "bert-base", "bert-large"):
        tcfg, jcfg = tm.PRESETS[name], jm.PRESETS[name]
        for f in dataclasses.fields(tcfg):
            if hasattr(jcfg, f.name) and f.name not in ("dtype", "param_dtype"):
                assert getattr(tcfg, f.name) == getattr(jcfg, f.name), (name, f.name)
        jshapes = jax.eval_shape(lambda k, c=jcfg: jm.init_model_params(k, c), jax.random.key(0))
        want = jax.tree.map(lambda a: tuple(a.shape), jshapes)
        assert hybrid.param_shapes(tcfg) == want, name
    vit = tm.PRESETS["vit-base"]
    assert vit.n_patches == 196 and vit.sample_len == 224 * 224 * 3
    assert tm.PRESETS["vit-huge"].head_dim == 80 and tm.PRESETS["vit-huge"].n_patches == 256


TINY_BERT = ["--model_size", "bert-base", "--hidden_size", "64", "--num_layers", "4",
             "--num_heads", "4", "--vocab_size", "128", "--seq_length", "32"]
TINY_VIT = ["--model_size", "vit-base", "--hidden_size", "64", "--num_layers", "4",
            "--num_heads", "4", "--image_size", "32", "--patch_size", "8", "--num_classes", "16"]
SEARCH = ["--num_devices", "8", "--analytic_costs", "1", "--settle_bsz", "16",
          "--memory_constraint_gb", "40"]


@pytest.mark.parametrize("family", ["vit", "bert"])
def test_analytic_costs_search_and_check_plan_match_jax(family, tmp_path):
    """``analytic_model_costs`` of the tiny model and of its presets are the
    JAX package's; ``cli search`` emits the JAX plan JSON and ``cli
    check-plan`` reports what the JAX checker reports."""
    from galvatron_tpu.cli import main as j_main
    from galvatron_tpu.models import modeling as jm
    from galvatron_tpu.search import theoretical as jth
    from galvatron_tpu_torch import cli
    from galvatron_tpu_torch.models import modeling as tm
    from galvatron_tpu_torch.search import theoretical as tth

    presets = ("vit-base", "vit-huge") if family == "vit" else ("bert-base", "bert-large")
    for name in presets:
        for mp in ("bf16", "fp32"):
            got = tth.analytic_model_costs(tm.PRESETS[name], mixed_precision=mp)
            want = jth.analytic_model_costs(jm.PRESETS[name], mixed_precision=mp)
            assert json.loads(json.dumps(dataclasses.asdict(got))) == \
                json.loads(json.dumps(dataclasses.asdict(want))), (name, mp)
        assert tth.total_param_count(tm.PRESETS[name]) == jth.total_param_count(jm.PRESETS[name])
    flags = (TINY_VIT if family == "vit" else TINY_BERT) + SEARCH
    a, b = str(tmp_path / "jax.json"), str(tmp_path / "port.json")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert j_main(["search", *flags, "--output_config_path", a]) == 0
        assert cli.main(["search", *flags, "--device", "cpu", "--output_config_path", b]) == 0
    with open(a) as f, open(b) as g:
        assert json.load(g) == json.load(f)
    jout, tout = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(jout):
        assert j_main(["check-plan", a, "--strict", "1"]) == 0
    with contextlib.redirect_stdout(tout):
        assert cli.main(["check-plan", b, "--strict", "1"]) == 0
    assert tout.getvalue().replace(b, a) == jout.getvalue()


def test_cli_profile_and_the_vit_entry_package(tmp_path, capsys):
    """``cli profile`` of a ViT measures its layers on pixel rows and keeps
    the analytic 'other' terms (no vocabulary fit); the ``vit`` entry
    package trains."""
    from galvatron_tpu_torch import cli
    from galvatron_tpu_torch.models import vit

    prefix = str(tmp_path / "p")
    assert cli.main(["profile", "--device", "cpu", *TINY_VIT, "--profile_batch_size", "2",
                     "--mixed_precision", "fp32", "--output_prefix", prefix]) == 0
    out = capsys.readouterr().out
    assert "fwd_ms_per_sample" in out and "vocab fit slope {} const {}" in out
    with open(f"{prefix}_memory.json") as f:
        assert json.load(f)
    assert vit.main(["train", "--device", "cpu", *TINY_VIT, "--global_train_batch_size", "8",
                     "--train_iters", "2", "--mixed_precision", "fp32", "--check_loss", "1"]) == 0
    out = capsys.readouterr().out
    assert "vit-base layers=4" in out and "seq=16" in out and "iter 1: loss" in out


# ---------------------------------------------------------------------------
# the 8-rank world (no JAX in a rank)
# ---------------------------------------------------------------------------


def _strategies(m):
    """name → (model shape change, plan): ``tests/test_vision.py``'s
    ``VIT_STRATEGIES``, its pipelines, and the flash path at 196 patches."""
    U = m.HybridParallelConfig.uniform
    return {
        "tp2_sp": ({}, U(4, tp=2, sp=True, mixed_precision="fp32", vocab_tp=2)),
        "zero3_ckpt": ({}, U(4, tp=1, dp_type="zero3", ckpt=True, mixed_precision="fp32",
                             embed_dp_type="zero3")),
        "accum2": ({}, U(4, tp=1, mixed_precision="fp32", chunks=2)),
        "pp2_gpipe": ({}, U(4, pp=2, tp=2, chunks=2, mixed_precision="fp32", vocab_tp=2,
                            pipeline_type="gpipe")),
        "pp2_1f1b": ({}, U(4, pp=2, tp=2, chunks=2, mixed_precision="fp32", vocab_tp=2,
                           pipeline_type="pipedream_flush")),
        "pp2_vpp2": ({}, U(4, pp=2, vpp=2, chunks=2, mixed_precision="fp32",
                           pipeline_type="gpipe")),
        "flash196_tp2_sp": (dict(RAGGED, attn_impl="flash"),
                            U(2, tp=2, sp=True, mixed_precision="fp32", vocab_tp=2)),
    }


CASE_NAMES = ("tp2_sp", "zero3_ckpt", "accum2", "pp2_gpipe", "pp2_1f1b", "pp2_vpp2",
              "flash196_tp2_sp")


def _worker(case_path: str, out_dir: str) -> None:
    import torch.distributed as dist

    from galvatron_tpu_torch import bridge
    from galvatron_tpu_torch.core.optim import AdamConfig
    from galvatron_tpu_torch.core.strategy import HybridParallelConfig
    from galvatron_tpu_torch.core.trainer import init_distributed
    from galvatron_tpu_torch.models.modeling import ModelConfig
    from galvatron_tpu_torch.parallel import hybrid

    torch.set_num_threads(1)
    init_distributed(torch.device("cpu"), "gloo", timeout_s=300)
    rank, world = dist.get_rank(), dist.get_world_size()
    with open(case_path, "rb") as f:
        cases = pickle.load(f)
    try:
        for case in cases:
            cfg = ModelConfig(dtype=torch.float32, **case["shape"])
            hp = HybridParallelConfig.from_json_dict(case["plan"])
            rt = hybrid.build_runtime(cfg, hp, AdamConfig(lr=LR, grad_clip=1.0),
                                      global_batch_size=BATCH, device="cpu")
            local = bridge.shard_params(case["params"], cfg, hp, rank, world)
            state = rt.state_from(hybrid.zip_map(
                lambda a, n: torch.from_numpy(np.array(a, copy=True)), local))
            losses = []
            for b in case["batches"]:
                state, loss = rt.train_step(state, torch.from_numpy(b))
                losses.append(float(loss))
            with open(os.path.join(out_dir, f"{case['name']}.{rank}.pkl"), "wb") as f:
                pickle.dump({"losses": losses,
                             "params": bridge.params_to_numpy(state["params"])}, f)
    finally:
        dist.destroy_process_group()


def _jax_reference(shape, params, batches):
    """(the 3 step losses, final params, first-step gradients) of the JAX
    single-device AdamW trajectory (``tests/test_vision.py``'s
    ``reference_losses``) on the einsum path."""
    import jax
    import jax.numpy as jnp

    from galvatron_tpu.core.optim import AdamConfig, adamw_update, init_opt_state
    from galvatron_tpu.models import modeling as jm

    cfg = jm.ModelConfig(dtype=jnp.float32, **dict(shape, attn_impl="xla"))
    adam = AdamConfig(lr=LR, grad_clip=1.0)
    p = jax.tree.map(jnp.asarray, params)
    step = jax.jit(jax.value_and_grad(lambda q, b: jm.lm_loss(q, b, cfg)))
    g0 = jax.tree.map(np.asarray, step(p, jnp.asarray(batches[0]))[1])
    losses, opt = [], init_opt_state(p)
    for b in batches:
        loss, grads = step(p, jnp.asarray(b))
        p, opt = adamw_update(p, grads, opt, adam)
        losses.append(float(loss))
    return losses, jax.tree.map(np.asarray, p), g0


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from galvatron_tpu_torch.core import strategy as ts
    from galvatron_tpu_torch.parallel.launch import launch_local

    d = tmp_path_factory.mktemp("torch_vision_world")
    tst = _strategies(ts)
    assert tuple(tst) == CASE_NAMES
    cases, table = [], {}
    for i, (name, (change, thp)) in enumerate(tst.items()):
        shape = dict(SHAPE, **change)
        params = _params(_cfgs(**change)[0], seed=i)
        batches = [_batch(shape, seed=10 * i + k) for k in range(STEPS)]
        table[name] = (shape, thp, params, batches)
        cases.append(dict(name=name, shape=shape, plan=thp.to_json_dict(), params=params,
                          batches=batches))
    case_path = d / "cases.pkl"
    with open(case_path, "wb") as f:
        pickle.dump(cases, f)
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    out = {}
    run = threading.Thread(target=lambda: out.setdefault("ranks", launch_local(
        [sys.executable, str(Path(__file__).resolve()), "worker", str(case_path), str(d)],
        WORLD, timeout_s=WORLD_TIMEOUT_S, env=env, cwd=str(ROOT))))
    run.start()  # the JAX references are computed while the world trains
    refs = {name: _jax_reference(shape, params, batches)
            for name, (shape, _, params, batches) in table.items()}
    run.join()
    results = {}
    for c in cases:
        files = [d / f"{c['name']}.{r}.pkl" for r in range(WORLD)]
        if all(f.exists() for f in files):
            results[c["name"]] = [pickle.load(open(f, "rb")) for f in files]
    return table, refs, results, out["ranks"]


def _world_failure(ranks):
    bad = [r for r in ranks if r.returncode != 0]
    return "\n".join(f"rank {r.rank} rc={r.returncode} killed={r.killed}:\n{r.output[-3000:]}"
                     for r in bad)


@pytest.mark.parametrize("name", CASE_NAMES)
def test_vit_trains_like_the_jax_package(world, name):
    import jax

    from galvatron_tpu_torch import bridge
    from galvatron_tpu_torch.core.optim import tree_leaves
    from galvatron_tpu_torch.models.modeling import ModelConfig

    table, refs, results, ranks = world
    assert name in results, _world_failure(ranks)
    shape, thp, _, _ = table[name]
    jlosses, jparams, jgrads = refs[name]
    got = results[name]
    losses = got[0]["losses"]
    assert all(g["losses"] == losses for g in got), "ranks report different losses"
    np.testing.assert_allclose(losses, jlosses, rtol=LOSS_TOL, atol=LOSS_TOL)
    full = bridge.gather_params([g["params"] for g in got],
                                ModelConfig(dtype=torch.float32, **shape), thp, WORLD)
    flat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    assert len(flat) == len(tree_leaves(full))
    for t, (path, j), g in zip(tree_leaves(full), flat, jax.tree.leaves(jgrads)):
        key = jax.tree_util.keystr(path)
        noise = np.abs(g) <= ROUNDING_OF_ZERO * np.abs(g).max()
        np.testing.assert_allclose(t[~noise], j[~noise], atol=PARAM_ATOL, rtol=0, err_msg=key)
        np.testing.assert_allclose(t[noise], j[noise], atol=STEPS * LR, rtol=0, err_msg=key)
        assert np.mean(np.abs(t - j) > PARAM_ATOL) < NOISE_SHARE, key


def test_every_rank_of_the_world_exited_cleanly(world):
    _, _, _, ranks = world
    assert all(r.returncode == 0 and not r.killed for r in ranks), _world_failure(ranks)


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "worker":
        _worker(sys.argv[2], sys.argv[3])
    else:
        raise SystemExit(f"usage: {sys.argv[0]} worker CASES OUT")
