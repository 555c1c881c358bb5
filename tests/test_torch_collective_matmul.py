"""The TP / gradient overlap plan fields in the port (``ops/
collective_matmul.py``, the projection seams of ``models/modeling.py``, the
``tp_overlap`` and ``grad_overlap`` paths of ``parallel/hybrid.py``) against
the JAX package, in one 8-rank gloo world (``parallel/launch.py``).

The functions (``tests/test_collective_matmul.py``'s cases): each rank runs
``allgather_matmul`` / ``matmul_reducescatter`` on its pieces of the same
seeded numpy inputs, at tp 2 and 4 on consecutive and strided ranks; the
outputs and the gradients of ``sum(sin(out))`` (the weight gradients summed
over the DP ranks) are held within 1e-5 to the JAX ``allgather_einsum`` /
``einsum_reducescatter`` on the 8-device CPU mesh (``JAX_RING_CASES``) or to
the plain einsum those reproduce (the rest); the blocked
qkv projection's shape; a sequence the ring does not divide takes the plain
seam (no hop) and gives the JAX fallback's output.

The runtime: plans with ``tp_overlap`` (tp 4 with and without SP, tp 2 on
strided ranks, GPT's biases, an MoE model, GQA, the flash path, full
recompute, pp 2) train 3
fp32 steps from the JAX package's ``key(0)`` weights within 2e-4 of the JAX
trajectory and within 1e-6 of their overlap-off twins, with ring hops only
when on; ``grad_overlap`` (zero2 at chunks 1 and, with tp 2, 2; zero3; pp 2) gives the
losses and parameters of its overlap-off twin to the last bit, every zero2
bucket issued by the backward. A ``cli search --enable_tp_overlap 1`` plan
trains through the port's ``cli train`` (8 ranks) within 2e-4 of the JAX
``cli train``.

Run as a script (``python tests/test_torch_collective_matmul.py worker CASES
OUT``) this file is one rank of the world; that path imports no JAX.
"""

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
WORLD = 8
STEPS = 3
BATCH, SEQ = 8, 32
LR = 1e-3
LOSS_TOL = 2e-4  # tests/test_hybrid_runtime.py's rtol / atol
TWIN_RTOL = 1e-6  # overlap on against off: another summation order
PARAM_ATOL = 1e-4
NOISE_SHARE = 1e-3  # tests/test_torch_moe.py's rule for elements near zero
FN_ATOL = 1e-5  # tests/test_collective_matmul.py's tolerance
WORLD_TIMEOUT_S = 900
B, S, H, F = 4, 16, 8, 12  # tests/test_collective_matmul.py's shapes
SHAPE = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4, ffn_dim=128,
             max_seq_len=SEQ)
GPT = dict(SHAPE, pos_embed="learned", norm_type="layernorm", act_fn="gelu",
           tie_word_embeddings=True, use_bias=True)
MOE = dict(SHAPE, moe_experts=4)
SHAPES = {"llama": SHAPE, "gpt": GPT, "moe": MOE}
#: the same model on another path of the port: GQA's interleaved qkv, and the
#: flash path's head-major seams (the kernels' plain versions on the CPU),
#: held to the model's JAX trajectory
PORT_SHAPES = {"gqa": ("gqa", dict(SHAPE, num_kv_heads=2)),
               "llama_flash": ("llama", dict(SHAPE, attn_impl="flash"))}


def _rand(seed, shape):
    return np.random.RandomState(seed).standard_normal(shape).astype(np.float32)


#: the function cases: (name, kind, tp, consecutive, scatter)
FN_CASES = [(f"{kind}_tp{tp}_{'consec' if c else 'strided'}" + (
    "" if kind == "ag" else ("_scatter" if sc else "_gather")), kind, tp, c, sc)
    for kind, scs in (("ag", (True,)), ("rs", (True, False)))
    for tp in (2, 4) for c in (True, False) for sc in scs]


def _ts():
    from galvatron_tpu_torch.core import strategy as ts

    return ts


def _runtime_cases(m):
    """name → (model kind, plan, its overlap-off twin or None)."""
    L = m.LayerStrategy

    def plan(layers, **kw):
        return m.HybridParallelConfig(pp=kw.pop("pp", 1), layer_strategies=layers,
                                      vocab_tp=kw.pop("vocab_tp", 1), mixed_precision="fp32",
                                      **kw)

    def pair(kind, layer, **kw):
        on = plan([L(tp_overlap=True, **layer)] * 2, **kw)
        return (kind, on, plan([L(**layer)] * 2, **kw))

    def grad(kind, layer, **kw):
        return (kind, plan([L(**layer)] * 2, grad_overlap=True, **kw),
                plan([L(**layer)] * 2, **kw))

    return {
        "tp4_sp_overlap": pair("llama", dict(tp=4, sp=True)),
        "tp4_overlap": pair("llama", dict(tp=4), vocab_tp=4),
        "tp2_strided_sp_overlap": pair("llama", dict(tp=2, tp_consec=False, sp=True)),
        "tp2_sp_overlap_full_zero3": pair("llama", dict(tp=2, sp=True, ckpt="full",
                                                         dp_type="zero3")),
        "gpt_tp2_sp_overlap": pair("gpt", dict(tp=2, sp=True), vocab_tp=2, vocab_sp=True),
        "moe_tp2_sp_overlap": pair("moe", dict(tp=2, sp=True, ep=2)),
        "gqa_tp2_sp_overlap": pair("gqa", dict(tp=2, sp=True)),
        "flash_tp2_sp_overlap": pair("llama_flash", dict(tp=2, sp=True)),
        "pp2_tp2_sp_overlap": pair("llama", dict(tp=2, sp=True), pp=2, chunks=2,
                                   pipeline_type="pipedream_flush"),
        "zero2_grad_overlap": grad("llama", dict(dp_type="zero2")),
        "tp2_zero2_grad_overlap_chunks2": grad("llama", dict(tp=2, dp_type="zero2"), chunks=2,
                                               vocab_tp=2),
        "tp2_zero3_grad_overlap": grad("llama", dict(tp=2, dp_type="zero3")),
        "pp2_zero2_grad_overlap": grad("llama", dict(dp_type="zero2"), pp=2, chunks=2),
    }


# ---------------------------------------------------------------------------
# a rank of the world (no JAX here)
# ---------------------------------------------------------------------------


def _fn_case(case, rank):
    """One function case on this rank: its pieces of the inputs, the
    output and the gradients of ``sum(sin(out))``."""
    from galvatron_tpu_torch.core.strategy import LayerStrategy
    from galvatron_tpu_torch.models import modeling
    from galvatron_tpu_torch.ops import collective_matmul as cm
    from galvatron_tpu_torch.parallel import comm
    from galvatron_tpu_torch.parallel.mesh import ProcessGroups, RankMesh

    _, kind, tp, consec, scatter = case["fn"]
    mesh = RankMesh(WORLD, 1)
    s = LayerStrategy(tp=tp, tp_consec=consec)
    groups = ProcessGroups(mesh, rank, [mesh.tp_axes(s)])
    group = groups.get(mesh.tp_axes(s))
    idx = group.index
    x, w = (torch.from_numpy(a) for a in case["inputs"])
    rows = mesh.batch_rows(rank, s, x.shape[0])
    cm.hops = 0
    if kind == "ag":
        sl = x.shape[1] // tp
        x_l = x[rows, idx * sl:(idx + 1) * sl]
        if w.dim() == 4:  # the blocked qkv projection (h, 3, n, hd): n split
            n = w.shape[2] // tp
            w_l = w[:, :, idx * n:(idx + 1) * n].reshape(w.shape[0], -1)
        else:
            n = w.shape[1] // tp
            w_l = w[:, idx * n:(idx + 1) * n]
    elif kind == "rs":
        f = x.shape[2] // tp
        x_l, w_l = x[rows, :, idx * f:(idx + 1) * f], w[idx * f:(idx + 1) * f]
    else:  # the fallback: the row-parallel seam without SP, a sequence T does not divide
        f = x.shape[2] // tp
        x_l, w_l = x[rows, :, idx * f:(idx + 1) * f], w[idx * f:(idx + 1) * f]
    x_l = x_l.contiguous().requires_grad_(True)
    w_l = w_l.contiguous().requires_grad_(True)
    if kind == "ag":
        out = cm.allgather_matmul(x_l, w_l, group)
        if w.dim() == 4:
            out = out.view(out.shape[0], out.shape[1], 3, n, w.shape[3]).permute(0, 2, 3, 1, 4)
    elif kind == "rs":
        out = cm.matmul_reducescatter(x_l, w_l, group, scatter=scatter)
    else:
        out = modeling._down(x_l, w_l, comm.TPRegion(group, sp=False, overlap=True))
    hops = cm.hops
    torch.sin(out).sum().backward()
    return {"rows": (rows.start, rows.stop), "index": idx, "out": out.detach().numpy(),
            "dx": x_l.grad.numpy(), "dw": w_l.grad.numpy(), "hops": hops}


def _runtime_case(case, rank, world):
    from galvatron_tpu_torch import bridge
    from galvatron_tpu_torch.core.optim import AdamConfig
    from galvatron_tpu_torch.core.strategy import HybridParallelConfig
    from galvatron_tpu_torch.models.modeling import ModelConfig
    from galvatron_tpu_torch.ops import collective_matmul as cm
    from galvatron_tpu_torch.parallel import hybrid

    cfg = ModelConfig(dtype=torch.float32, **case["shape"])
    hp = HybridParallelConfig.from_json_dict(case["plan"])
    rt = hybrid.build_runtime(cfg, hp, AdamConfig(lr=LR, grad_clip=1.0),
                              global_batch_size=BATCH, seq_len=SEQ, device="cpu")
    local = bridge.shard_params(case["params"], cfg, hp, rank, world)
    state = rt.state_from(hybrid.zip_map(
        lambda a, n: torch.from_numpy(np.array(a, copy=True)), local))
    losses, buckets = [], []
    cm.hops = 0
    for b in case["batches"]:
        state, loss = rt.train_step(state, torch.from_numpy(b))
        losses.append(float(loss))
        buckets.append(rt.stats.get("buckets"))
    return {"losses": losses, "params": bridge.params_to_numpy(state["params"]),
            "hops": cm.hops, "buckets": buckets}


def _worker(case_path: str, out_dir: str) -> None:
    import torch.distributed as dist

    from galvatron_tpu_torch.core.trainer import init_distributed

    torch.set_num_threads(1)
    init_distributed(torch.device("cpu"), "gloo", timeout_s=300)
    rank, world = dist.get_rank(), dist.get_world_size()
    with open(case_path, "rb") as f:
        cases = pickle.load(f)
    try:
        for case in cases:
            res = _fn_case(case, rank) if "fn" in case else _runtime_case(case, rank, world)
            with open(os.path.join(out_dir, f"{case['name']}.{rank}.pkl"), "wb") as f:
                pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the JAX side and the world (pytest)
# ---------------------------------------------------------------------------


def _jcfg(shape):
    import jax.numpy as jnp

    from galvatron_tpu.models import modeling as jm

    return jm.ModelConfig(dtype=jnp.float32, **shape)


def _jax_params(shape, seed=0):
    import jax

    from galvatron_tpu.models import modeling as jm

    return jax.tree.map(np.asarray, jm.init_model_params(jax.random.key(seed), _jcfg(shape)))


def _jax_trajectory(shape, batches):
    """The JAX runtime on one device: losses and final parameters (every
    plan computes this model)."""
    import jax
    import jax.numpy as jnp

    from galvatron_tpu.core.optim import AdamConfig
    from galvatron_tpu.core.strategy import HybridParallelConfig
    from galvatron_tpu.parallel import hybrid as jh
    from galvatron_tpu.parallel.mesh import build_mesh

    cfg = _jcfg(shape)
    mesh, axes = build_mesh(pp=1, devices=jax.devices()[:1])
    hp = HybridParallelConfig.uniform(cfg.num_layers, mixed_precision="fp32")
    rt = jh.build_runtime(cfg, hp, mesh=mesh, axes=axes, adam=AdamConfig(lr=LR, grad_clip=1.0),
                          global_batch_size=BATCH, seq_len=SEQ)
    state = rt.init_state_from(jax.tree.map(jnp.asarray, _jax_params(shape)))
    losses = []
    for b in batches:
        state, loss = rt.train_step(state, jnp.asarray(b))
        losses.append(float(loss))
    return {"losses": losses, "params": jax.tree.map(np.asarray, state["params"])}


def _fn_inputs(kind, j):
    if kind == "ag":
        return _rand(j, (B, S, H)), _rand(100 + j, (H, F))
    if kind == "qkv":
        return _rand(j, (B, S, H)), _rand(100 + j, (H, 3, 4, 2))
    if kind == "fallback":
        return _rand(j, (B, 6, F)), _rand(100 + j, (F, H))  # seq 6 % 4 != 0
    return _rand(j, (B, S, F)), _rand(100 + j, (F, H))


#: the function cases also run through the JAX ring itself (one compile of
#: the 8-device shard_map program each); the others are held to the plain
#: einsum the JAX ring reproduces (tests/test_collective_matmul.py)
JAX_RING_CASES = ("ag_tp4_strided", "rs_tp4_strided_scatter", "rs_tp2_consec_gather",
                  "qkv_tp4_strided")
_SUBSCRIPTS = {"ag": "bsh,hf->bsf", "qkv": "bsh,hcnd->bcnsd", "rs": "bsf,fh->bsh"}


def _jax_fn(case, kind):
    """The JAX function (the ring on the 8-device mesh for
    ``JAX_RING_CASES``, else the plain einsum): out and the gradients of
    ``sum(sin(out))``."""
    import jax
    import jax.numpy as jnp

    from galvatron_tpu.ops import collective_matmul as jcm
    from galvatron_tpu.parallel.mesh import build_mesh

    _, _, tp, consec, scatter = case["fn"]
    sub = _SUBSCRIPTS[kind]
    if case["name"] in JAX_RING_CASES:
        mesh, axes = build_mesh(pp=1)
        kw = dict(mesh=mesh, dp_axes=axes.dp_axes(tp, consec), tp_axes=axes.tp_axes(tp, consec))
        if kind == "rs":
            fn = lambda x_, w_: jcm.einsum_reducescatter(  # noqa: E731
                sub, x_, w_, w_shard_dim=0, scatter_output=scatter, **kw)
        else:
            fn = lambda x_, w_: jcm.allgather_einsum(  # noqa: E731
                sub, x_, w_, w_shard_dim=2 if kind == "qkv" else 1, **kw)
    else:
        fn = lambda x_, w_: jnp.einsum(sub, x_, w_)  # noqa: E731

    @jax.jit
    def run(x_, w_):
        out, vjp = jax.vjp(fn, x_, w_)
        return (out,) + vjp(jnp.cos(out))  # the gradients of sum(sin(out))

    return tuple(np.asarray(a) for a in run(*(jnp.asarray(a) for a in case["inputs"])))


def _batches(seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, SHAPE["vocab_size"], (BATCH, SEQ + 1)).astype(np.int32)
            for _ in range(STEPS)]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every case in one 8-rank gloo world, the JAX references computed
    meanwhile; returns (cases, references, per-rank results, launcher
    results)."""
    from galvatron_tpu_torch.parallel.launch import launch_local

    d = tmp_path_factory.mktemp("torch_collective_matmul_world")
    cases = []
    for j, fn in enumerate(FN_CASES + [("qkv_tp4_consec", "qkv", 4, True, True),
                                       ("qkv_tp4_strided", "qkv", 4, False, True),
                                       ("fallback_tp4", "fallback", 4, True, False)]):
        kind = "ag" if fn[1] == "qkv" else fn[1]
        cases.append(dict(name=fn[0], fn=(fn[0], kind, *fn[2:]), inputs=_fn_inputs(fn[1], j)))
    ref_shapes = dict(SHAPES, gqa=PORT_SHAPES["gqa"][1])
    params = {kind: _jax_params(shape) for kind, shape in ref_shapes.items()}
    batches = {kind: _batches(j) for j, kind in enumerate(ref_shapes)}
    for name, (kind, on, off) in _runtime_cases(_ts()).items():
        ref, shape = PORT_SHAPES.get(kind, (kind, SHAPES.get(kind)))
        for tag, hp in (("", on), ("_off", off)):
            cases.append(dict(name=name + tag, shape=shape, kind=ref, plan=hp.to_json_dict(),
                              params=params[ref], batches=batches[ref]))
    case_path = d / "cases.pkl"
    with open(case_path, "wb") as f:
        pickle.dump(cases, f)
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    out = {}
    run = threading.Thread(target=lambda: out.setdefault("ranks", launch_local(
        [sys.executable, str(Path(__file__).resolve()), "worker", str(case_path), str(d)],
        WORLD, timeout_s=WORLD_TIMEOUT_S, env=env, cwd=str(ROOT))))
    run.start()
    refs = {c["name"]: _jax_fn(c, "qkv" if c["name"].startswith("qkv") else c["fn"][1])
            for c in cases if "fn" in c and c["fn"][1] != "fallback"}
    refs.update({kind: _jax_trajectory(shape, batches[kind])
                 for kind, shape in ref_shapes.items()})
    run.join()
    results = {}
    for c in cases:
        files = [d / f"{c['name']}.{r}.pkl" for r in range(WORLD)]
        if all(f.exists() for f in files):
            results[c["name"]] = [pickle.load(open(f, "rb")) for f in files]
    return {c["name"]: c for c in cases}, refs, results, out["ranks"]


def _world_failure(ranks):
    bad = [r for r in ranks if r.returncode != 0]
    return "\n".join(f"rank {r.rank} rc={r.returncode} killed={r.killed}:\n{r.output[-3000:]}"
                     for r in bad)


def _check_fn(name, refs, results, scatter, qkv=False):
    out, dx, dw = refs[name]
    got = results[name]
    tp = len({g["index"] for g in got})
    dw_sum = {}
    for g in got:
        lo, hi = g["rows"]
        i = g["index"]
        assert g["hops"] > 0
        if qkv:  # (b, 3, n, s, d): this rank's heads
            n = out.shape[2] // tp
            np.testing.assert_allclose(g["out"], out[lo:hi, :, i * n:(i + 1) * n], atol=FN_ATOL)
            sl = dx.shape[1] // tp
            np.testing.assert_allclose(g["dx"], dx[lo:hi, i * sl:(i + 1) * sl], atol=FN_ATOL)
            dw_sum[i] = dw_sum.get(i, 0) + g["dw"]
            continue
        if name.startswith("ag"):
            n = out.shape[2] // tp
            sl = dx.shape[1] // tp
            np.testing.assert_allclose(g["out"], out[lo:hi, :, i * n:(i + 1) * n], atol=FN_ATOL)
            np.testing.assert_allclose(g["dx"], dx[lo:hi, i * sl:(i + 1) * sl], atol=FN_ATOL)
        else:
            f = dx.shape[2] // tp
            sl = out.shape[1] // tp
            want = out[lo:hi, i * sl:(i + 1) * sl] if scatter else out[lo:hi]
            np.testing.assert_allclose(g["out"], want, atol=FN_ATOL)
            np.testing.assert_allclose(g["dx"], dx[lo:hi, :, i * f:(i + 1) * f], atol=FN_ATOL)
        dw_sum[i] = dw_sum.get(i, 0) + g["dw"]
    for i, d in dw_sum.items():  # each weight piece's gradient summed over the DP ranks
        if qkv:
            n = dw.shape[2] // tp
            want = dw[:, :, i * n:(i + 1) * n].reshape(dw.shape[0], -1)
        elif name.startswith("ag"):
            n = dw.shape[1] // tp
            want = dw[:, i * n:(i + 1) * n]
        else:
            f = dw.shape[0] // tp
            want = dw[i * f:(i + 1) * f]
        np.testing.assert_allclose(d, want, atol=FN_ATOL * tp)


@pytest.mark.parametrize("name,kind,tp,consec,scatter", FN_CASES)
def test_collective_matmul_matches_the_jax_ring(world, name, kind, tp, consec, scatter):
    cases, refs, results, ranks = world
    assert name in results, _world_failure(ranks)
    _check_fn(name, refs, results, scatter)


@pytest.mark.parametrize("consec", [True, False])
def test_blocked_qkv_projection_matches_jax(world, consec):
    """The qkv seam's head-sharded blocked weight (h, 3, n, hd): the output
    (b, 3, n/tp, s, hd) and gradients of the JAX 'bsh,hcnd->bcnsd' ring."""
    cases, refs, results, ranks = world
    name = f"qkv_tp4_{'consec' if consec else 'strided'}"
    assert name in results, _world_failure(ranks)
    _check_fn(name, refs, results, True, qkv=True)


def test_an_indivisible_sequence_takes_the_plain_seam():
    """A sequence of 6 over a TP ring of 4: the row-parallel seam (no SP)
    takes the plain all-reduce (no hop), which is the JAX fallback's plain
    einsum; the ring itself refuses the shape."""
    import jax.numpy as jnp

    from galvatron_tpu.ops import collective_matmul as jcm
    from galvatron_tpu.parallel.mesh import build_mesh
    from galvatron_tpu_torch.ops import collective_matmul as cm

    x, w = _fn_inputs("fallback", 0)
    mesh, axes = build_mesh(pp=1)
    ref = jcm.einsum_reducescatter("bsf,fh->bsh", jnp.asarray(x), jnp.asarray(w), mesh=mesh,
                                   dp_axes=axes.dp_axes(4, True), tp_axes=axes.tp_axes(4, True),
                                   w_shard_dim=0, scatter_output=False)
    np.testing.assert_allclose(np.asarray(ref), np.einsum("bsf,fh->bsh", x, w), atol=1e-5)

    class _Ring4:  # a group of 4 (the ring is refused before any message)
        size, index = 4, 0

    with pytest.raises(ValueError, match="sequence 6 does not split over the TP ring of 4"):
        cm.matmul_reducescatter(torch.from_numpy(x[:, :, :3]), torch.from_numpy(w[:3]), _Ring4)


def test_an_indivisible_sequence_in_the_world_equals_jax(world):
    cases, refs, results, ranks = world
    assert "fallback_tp4" in results, _world_failure(ranks)
    x, w = cases["fallback_tp4"]["inputs"]
    out = np.einsum("bsf,fh->bsh", x, w)
    for g in results["fallback_tp4"]:
        lo, hi = g["rows"]
        assert g["hops"] == 0
        np.testing.assert_allclose(g["out"], out[lo:hi], atol=FN_ATOL)


def _gathered(case, got):
    from galvatron_tpu_torch import bridge
    from galvatron_tpu_torch.core.optim import tree_leaves
    from galvatron_tpu_torch.core.strategy import HybridParallelConfig
    from galvatron_tpu_torch.models.modeling import ModelConfig

    cfg = ModelConfig(dtype=torch.float32, **case["shape"])
    hp = HybridParallelConfig.from_json_dict(case["plan"])
    pieces = [g["params"] for g in got]
    full = bridge.gather_params(pieces, cfg, hp, WORLD)
    for r in range(WORLD):  # no replica drifted
        held = bridge.shard_params(full, cfg, hp, r, WORLD)
        for a, b in zip(tree_leaves(held), tree_leaves(pieces[r])):
            np.testing.assert_array_equal(a, b)
    return tree_leaves(full)


def _check_jax(name, cases, refs, results):
    import jax

    case, got = cases[name], results[name]
    ref = refs[case["kind"]]
    assert all(g["losses"] == got[0]["losses"] for g in got), "ranks report different losses"
    np.testing.assert_allclose(got[0]["losses"], ref["losses"], rtol=LOSS_TOL, atol=LOSS_TOL)
    flat = jax.tree_util.tree_flatten_with_path(ref["params"])[0]
    full = _gathered(case, got)
    assert len(flat) == len(full)
    for t, (path, j) in zip(full, flat):
        key = jax.tree_util.keystr(path)
        assert np.mean(np.abs(t - j) > PARAM_ATOL) < NOISE_SHARE, key
        np.testing.assert_allclose(t, j, atol=STEPS * LR, rtol=0, err_msg=key)


TP_CASES = [n for n, (_, on, _) in _runtime_cases(_ts()).items() if not on.grad_overlap]
GRAD_CASES = [n for n, (_, on, _) in _runtime_cases(_ts()).items() if on.grad_overlap]


@pytest.mark.parametrize("name", TP_CASES)
def test_tp_overlap_trains_like_the_jax_package_and_its_twin(world, name):
    cases, refs, results, ranks = world
    assert name in results and name + "_off" in results, _world_failure(ranks)
    _check_jax(name, cases, refs, results)
    on, off = results[name], results[name + "_off"]
    np.testing.assert_allclose(on[0]["losses"], off[0]["losses"], rtol=TWIN_RTOL, atol=0)
    assert all(g["hops"] > 0 for g in on) and all(g["hops"] == 0 for g in off)


@pytest.mark.parametrize("name", GRAD_CASES)
def test_grad_overlap_gives_its_twin_to_the_last_bit(world, name):
    from galvatron_tpu_torch.core.optim import tree_leaves

    cases, refs, results, ranks = world
    assert name in results and name + "_off" in results, _world_failure(ranks)
    _check_jax(name, cases, refs, results)
    for a, b in zip(results[name], results[name + "_off"]):
        assert a["losses"] == b["losses"]
        for x, y in zip(tree_leaves(a["params"]), tree_leaves(b["params"])):
            np.testing.assert_array_equal(x, y)
    hp = _ts().HybridParallelConfig.from_json_dict(cases[name]["plan"])
    if hp.pp > 1:  # accepted and inert, as in the reference
        assert all(bk is None for g in results[name] for bk in g["buckets"])
    elif hp.layer_strategies[0].dp_type == "zero2":  # one bucket a layer, from the backward
        assert all(bk == {"backward": 2, "after": 0} for g in results[name]
                   for bk in g["buckets"])


def test_every_rank_of_the_world_exited_cleanly(world):
    ranks = world[3]
    assert all(r.returncode == 0 and not r.killed for r in ranks), _world_failure(ranks)


# ---------------------------------------------------------------------------
# cli search --enable_tp_overlap 1 → cli train, against the JAX cli train
# ---------------------------------------------------------------------------

TINY = ["--model_size", "llama-0.3b", "--num_layers", "2", "--hidden_size", "64",
        "--num_heads", "4", "--ffn_dim", "128", "--vocab_size", "128", "--seq_length", "32",
        "--mixed_precision", "fp32"]


def test_cli_search_overlap_plan_trains_like_the_jax_cli_train(tmp_path):
    import jax

    from galvatron_tpu.core.arguments import initialize_galvatron as j_init
    from galvatron_tpu.core.trainer import train as j_train
    from galvatron_tpu.models import modeling as jm
    from galvatron_tpu_torch import cli
    from galvatron_tpu_torch.core.strategy import HybridParallelConfig
    from galvatron_tpu_torch.models import modeling as tm
    from galvatron_tpu_torch.parallel import hybrid
    from galvatron_tpu_torch.parallel.launch import launch_local
    from galvatron_tpu_torch.utils.metrics import read_metrics
    from tests.test_torch_data import jax_start_checkpoint

    plan = str(tmp_path / "plan.json")
    assert cli.main(["search", *TINY, "--num_devices", str(WORLD), "--analytic_costs", "1",
                     "--memory_constraint_gb", "1", "--settle_bsz", "8", "--search_space",
                     "tp", "--enable_tp_overlap", "1", "--device", "cpu",
                     "--output_config_path", plan]) == 0
    hp = HybridParallelConfig.load(plan)
    assert hp.pp == 1 and any(s.tp_overlap and s.tp > 1 for s in hp.layer_strategies)
    argv = [*TINY, "--global_train_batch_size", "8", "--train_iters", "3",
            "--galvatron_config_path", plan]
    jlosses = j_train(j_init("train", argv + ["--check_loss", "1"]))["losses"]  # synced losses
    jcfg = jm.PRESETS["llama-0.3b"].replace(num_layers=2, hidden_size=64, num_heads=4,
                                            ffn_dim=128, vocab_size=128, max_seq_len=32,
                                            dtype=jax.numpy.float32)
    tcfg = tm.PRESETS["llama-0.3b"].replace(num_layers=2, hidden_size=64, num_heads=4,
                                            ffn_dim=128, vocab_size=128, max_seq_len=32)
    rt = hybrid.build_runtime(tcfg, global_batch_size=8, seq_len=32, mixed_precision="fp32",
                              device="cpu")
    jax_start_checkpoint(str(tmp_path / "start"), jcfg, 1234, rt)
    metrics = str(tmp_path / "m.jsonl")
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    ranks = launch_local([sys.executable, "-m", "galvatron_tpu_torch.cli", "train", *argv,
                          "--device", "cpu", "--load", str(tmp_path / "start"),
                          "--metrics_path", metrics], WORLD, timeout_s=600, env=env,
                         cwd=str(ROOT))
    assert all(r.returncode == 0 for r in ranks), "\n".join(r.output[-2000:] for r in ranks)
    got = [r["loss"] for r in read_metrics(metrics) if r["event"] == "train_iter"]
    assert len(got) == len(jlosses) == 3
    np.testing.assert_allclose(got, jlosses, rtol=LOSS_TOL, atol=LOSS_TOL)
    assert json.loads(Path(plan).read_text())["tp_overlap_flags"].count("1") >= 1


if __name__ == "__main__" and len(sys.argv) == 4 and sys.argv[1] == "worker":
    sys.path.insert(0, str(ROOT))
    _worker(sys.argv[2], sys.argv[3])
