"""Switch-MoE and expert parallelism in the port (``models/moe.py``, the MoE
layers of ``parallel/hybrid.py``) against the JAX package.

In process (fp32, numpy-seeded inputs):

- ``sinkhorn``, ``moe_capacity`` and ``route_top1`` in both modes, against
  the JAX functions; the routing assignments EQUAL (expert, slot, kept);
- the index dispatch and combine against the JAX one-hot einsums, equal to
  the last bit in fp32, and in bf16 the one rounding of ``bf16(gate)·ye``;
- ``moe_block``'s output and gradients (1e-5), one MoE model's loss and
  gradients through ``bridge.params_from_jax`` for SwiGLU and for GPT with
  gelu and relu (both run tanh-GELU experts), and greedy ``generate`` token
  for token;
- the MoE profile's fields, the expert-time fit and the EP search scenarios
  of ``tests/test_moe.py``, equal to the JAX package's.

One 8-rank gloo world (``parallel/launch.py``) trains hybrid plans with MoE
layers 3 steps from the JAX package's ``key(0)`` weights while the parent
computes the JAX references on one device: ep = 1 at dp = 8 (the routing is
global over the micro-batch, the main trap), ep 2 and 4, tp 2 x ep 2 x
zero3 with and without SP, GPT with full recompute, a CP layer, and pp 2 x
tp 2 x ep 2 under GPipe at chunks 1 (the eval loss within 3e-5 of the flat
loss) and 2, 1F1B and interleaved 1F1B. Losses within 2e-4 of the JAX
trajectory, parameters within 1e-4 (``tests/test_torch_context_parallel.py``'s
rules), the first step's routing equal on every layer. A control that routes
each rank's own tokens must miss the JAX losses; an ep = 2 checkpoint resumes
at ep = 1 in the world and at world size 1 in the parent.

Run as a script (``python tests/test_torch_moe.py worker CASES OUT``) this
file is one rank of the world; that path imports no JAX.
"""

import json
import os
import pickle
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
WORLD = 8
STEPS = 3
BATCH, SEQ = 8, 32
LR = 1e-3
LOSS_TOL = 2e-4  # tests/test_ops.py's runtime tolerance (rtol / atol)
PARAM_ATOL = 1e-4
ROUNDING_OF_ZERO, NOISE_SHARE = 1e-5, 1e-3
EVAL_TOL = 3e-5  # tests/test_moe.py::test_moe_pipeline_parallel_parity
GRAD_TOL = 1e-5
WORLD_TIMEOUT_S = 900
EXPERTS = 4
SHAPE = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4, ffn_dim=128,
             max_seq_len=SEQ, moe_experts=EXPERTS)
GPT = dict(SHAPE, pos_embed="learned", norm_type="layernorm", act_fn="gelu",
           tie_word_embeddings=True, use_bias=True, moe_capacity_factor=1.0)
SHAPES = {"llama": SHAPE, "llama4": dict(SHAPE, num_layers=4), "gpt": GPT}


def _runtime_cases(m):
    """name → (model shape, plan, chunks of the JAX reference)."""
    U, L = m.HybridParallelConfig.uniform, m.LayerStrategy

    def plan(layers, **kw):
        return m.HybridParallelConfig(pp=kw.pop("pp", 1), layer_strategies=layers,
                                      vocab_tp=kw.pop("vocab_tp", 1), mixed_precision="fp32",
                                      **kw)

    return {
        "ep1_dp8": ("llama", U(2, mixed_precision="fp32", vocab_tp=1), 1),
        "ep2": ("llama", plan([L(ep=2)] * 2), 1),
        "ep4_zero2": ("llama", plan([L(ep=4, dp_type="zero2")] * 2), 1),
        "tp2_ep2_zero3": ("llama", plan([L(tp=2, dp_type="zero3", ep=2)] * 2, vocab_tp=2), 1),
        "tp2_sp_ep2_zero3": ("llama", plan([L(tp=2, sp=True, dp_type="zero3", ep=2)] * 2,
                                           vocab_tp=2), 1),
        "gpt_ep2_full": ("gpt", plan([L(ep=2, ckpt="full"), L(tp=2, ep=2)], vocab_tp=2), 1),
        "cp2": ("llama", plan([L(cp=2), L(cp=2, cp_impl="a2a")]), 1),
        "pp2_tp2_ep2_c1": ("llama4", plan([L(tp=2, ep=2)] * 4, pp=2, vocab_tp=2), 1),
        "pp2_tp2_ep2_c2": ("llama4", plan([L(tp=2, ep=2)] * 4, pp=2, chunks=2, vocab_tp=2), 2),
        "pp2_1f1b_ep2": ("llama4", plan([L(ep=2)] * 4, pp=2, chunks=2,
                                        pipeline_type="pipedream_flush"), 2),
        "pp2_vpp2_ep2": ("llama4", plan([L(ep=2)] * 4, pp=2, vpp=2, chunks=2,
                                        pipeline_type="pipedream_flush"), 2),
    }


#: the cases whose first step's routing is recorded and held equal to JAX's
ROUTED = ("ep1_dp8", "ep2", "tp2_sp_ep2_zero3")


def _ts():
    from galvatron_tpu_torch.core import strategy as ts

    return ts


# ---------------------------------------------------------------------------
# a rank of the world (no JAX here)
# ---------------------------------------------------------------------------


def _build(case, plan, world):
    from galvatron_tpu_torch.core.optim import AdamConfig
    from galvatron_tpu_torch.core.strategy import HybridParallelConfig
    from galvatron_tpu_torch.models.modeling import ModelConfig
    from galvatron_tpu_torch.parallel import hybrid

    cfg = ModelConfig(dtype=torch.float32, **case["shape"])
    hp = HybridParallelConfig.from_json_dict(plan)
    return cfg, hp, hybrid.build_runtime(cfg, hp, AdamConfig(lr=LR, grad_clip=1.0),
                                         global_batch_size=BATCH, seq_len=SEQ, device="cpu")


def _runtime_case(case, rank, world, out_dir):
    from galvatron_tpu_torch import bridge
    from galvatron_tpu_torch.core import checkpoint
    from galvatron_tpu_torch.models import moe
    from galvatron_tpu_torch.parallel import comm, hybrid

    comm.reset_counts()
    t0 = time.perf_counter()
    cfg, hp, rt = _build(case, case["plan"], world)
    local = bridge.shard_params(case["params"], cfg, hp, rank, world)
    state = rt.state_from(hybrid.zip_map(
        lambda a, n: torch.from_numpy(np.array(a, copy=True)), local))
    res = {}
    if case.get("eval_first"):
        res["eval"] = float(rt.eval_loss(state, torch.from_numpy(case["batches"][0])))
    routes, real_route = [], moe.route_top1

    def recording(logits, capacity, **kw):
        r = real_route(logits, capacity, **kw)
        routes.append(_kept_route(r.expert.numpy(), r.slot.numpy(), r.kept.numpy()))
        return r

    losses = []
    for step, b in enumerate(case["batches"]):
        if step == case.get("resume_at"):
            ckpt = os.path.join(out_dir, "ckpt_" + case["name"])
            checkpoint.save_checkpoint_portable(ckpt, state, step, rt)
            cfg, hp, rt = _build(case, case["resume_plan"], world)
            state = checkpoint.restore_checkpoint_portable(ckpt, rt)
        moe.route_top1 = recording if step == 0 and case.get("record") else real_route
        try:
            state, loss = rt.train_step(state, torch.from_numpy(b))
        finally:
            moe.route_top1 = real_route
        losses.append(float(loss))
    res.update(losses=losses, params=bridge.params_to_numpy(state["params"]), routes=routes,
               moves=dict(comm.moe_moves), seconds=time.perf_counter() - t0)
    return res


def _kept_route(expert, slot, kept):
    """(expert, slot, kept) with -1 for the expert and slot of a dropped
    token (the one-hot form carries neither)."""
    return np.where(kept, expert, -1), np.where(kept, slot, -1), kept


def _worker(case_path: str, out_dir: str) -> None:
    import torch.distributed as dist

    from galvatron_tpu_torch.core.trainer import init_distributed
    from galvatron_tpu_torch.parallel import hybrid

    torch.set_num_threads(1)
    init_distributed(torch.device("cpu"), "gloo", timeout_s=300)
    rank, world = dist.get_rank(), dist.get_world_size()
    with open(case_path, "rb") as f:
        cases = pickle.load(f)
    real_ctx = hybrid.MoEContext
    try:
        for case in cases:
            # the control: no routing context, so each rank routes its own tokens
            hybrid.MoEContext = (lambda *a, **k: None) if case.get("local_routing") else real_ctx
            res = _runtime_case(case, rank, world, out_dir)
            with open(os.path.join(out_dir, f"{case['name']}.{rank}.pkl"), "wb") as f:
                pickle.dump(res, f)
    finally:
        hybrid.MoEContext = real_ctx
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the JAX side
# ---------------------------------------------------------------------------


def _jcfg(shape):
    import jax.numpy as jnp

    from galvatron_tpu.models import modeling as jm

    return jm.ModelConfig(dtype=jnp.float32, **shape)


def _jax_params(shape, seed=0):
    import jax

    from galvatron_tpu.models import modeling as jm

    return jax.tree.map(np.asarray, jm.init_model_params(jax.random.key(seed), _jcfg(shape)))


def _jax_reference(shape, chunks, batches):
    """The JAX runtime on one device (routing over each whole micro-batch):
    losses, final parameters, the first full-batch gradients, the flat eval
    loss of batch 0 and the first batch's routing, layer by layer (eager)."""
    import jax
    import jax.numpy as jnp

    from galvatron_tpu.core.optim import AdamConfig
    from galvatron_tpu.core.strategy import HybridParallelConfig
    from galvatron_tpu.models import modeling as jm
    from galvatron_tpu.models import moe as jmoe
    from galvatron_tpu.parallel import hybrid as jh
    from galvatron_tpu.parallel.mesh import build_mesh

    cfg = _jcfg(shape)
    params = _jax_params(shape)
    mesh, axes = build_mesh(pp=1, devices=jax.devices()[:1])
    hp = HybridParallelConfig.uniform(cfg.num_layers, mixed_precision="fp32", chunks=chunks)
    rt = jh.build_runtime(cfg, hp, mesh=mesh, axes=axes, adam=AdamConfig(lr=LR, grad_clip=1.0),
                          global_batch_size=BATCH, seq_len=SEQ)
    state = rt.init_state_from(jax.tree.map(jnp.asarray, params))
    losses = []
    for b in batches:
        state, loss = rt.train_step(state, jnp.asarray(b))
        losses.append(float(loss))
    jp = jax.tree.map(jnp.asarray, params)
    b0 = jnp.asarray(batches[0])
    grads = jax.jit(jax.grad(lambda p: jm.lm_loss(p, b0, cfg)))(jp)
    routes, real = [], jmoe.route_top1

    def record(d):
        a = np.asarray(d)
        routes.append(_kept_route(a.sum(2).argmax(-1), a.sum(1).argmax(-1),
                                  a.sum(axis=(1, 2)) > 0))

    def recording(logits, capacity, **kw):
        d, c = real(logits, capacity, **kw)
        jax.debug.callback(record, d, ordered=True)
        return d, c

    jmoe.route_top1 = recording
    try:
        eval_loss = float(jax.jit(lambda p: jm.lm_loss(p, b0, cfg))(jp))
        jax.effects_barrier()
    finally:
        jmoe.route_top1 = real
    return dict(losses=losses, params=jax.tree.map(np.asarray, state["params"]),
                grads=jax.tree.map(np.asarray, grads), eval=eval_loss, routes=routes)


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

    d = tmp_path_factory.mktemp("torch_moe_world")
    batches = {kind: _batches(j) for j, kind in enumerate(SHAPES)}
    params = {kind: _jax_params(shape) for kind, shape in SHAPES.items()}
    runtime = _runtime_cases(_ts())
    cases = []
    for name, (kind, hp, _) in runtime.items():
        cases.append(dict(name=name, shape=SHAPES[kind], plan=hp.to_json_dict(),
                          batches=batches[kind], params=params[kind], record=name in ROUTED,
                          eval_first=name == "pp2_tp2_ep2_c1"))
    by_name = {c["name"]: c for c in cases}
    cases.append(dict(by_name["ep1_dp8"], name="control_local_routing", local_routing=True,
                      record=False))
    cases.append(dict(by_name["ep2"], name="ckpt_ep2_to_ep1", resume_at=2, record=False,
                      resume_plan=runtime["ep1_dp8"][1].to_json_dict()))
    case_path = d / "cases.pkl"
    with open(case_path, "wb") as f:
        pickle.dump(cases, f)
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    out = {}
    run = threading.Thread(target=lambda: out.setdefault("ranks", launch_local(
        [sys.executable, str(Path(__file__).resolve()), "worker", str(case_path), str(d)],
        WORLD, timeout_s=WORLD_TIMEOUT_S, env=env, cwd=str(ROOT))))
    run.start()
    jref = {(kind, ch): _jax_reference(SHAPES[kind], ch, batches[kind])
            for kind, _, ch in {(k, None, c) for k, _, c in runtime.values()}}
    refs = {name: jref[(kind, ch)] for name, (kind, _, ch) in runtime.items()}
    refs["control_local_routing"] = refs["ep1_dp8"]
    refs["ckpt_ep2_to_ep1"] = refs["ep2"]
    run.join()
    results = {}
    for c in cases:
        files = [d / f"{c['name']}.{r}.pkl" for r in range(WORLD)]
        if all(f.exists() for f in files):
            results[c["name"]] = [pickle.load(open(f, "rb")) for f in files]
    return {c["name"]: c for c in cases}, refs, results, out["ranks"], d


def _world_failure(ranks):
    bad = [r for r in ranks if r.returncode != 0]
    return "\n".join(f"rank {r.rank} rc={r.returncode} killed={r.killed}:\n{r.output[-3000:]}"
                     for r in bad)


def _check_runtime(name, cases, refs, results):
    import jax

    from galvatron_tpu_torch import bridge
    from galvatron_tpu_torch.core.optim import tree_leaves
    from galvatron_tpu_torch.core.strategy import HybridParallelConfig
    from galvatron_tpu_torch.models.modeling import ModelConfig

    ref = refs[name]
    got = results[name]
    losses = got[0]["losses"]
    assert all(g["losses"] == losses for g in got), "ranks report different losses"
    np.testing.assert_allclose(losses, ref["losses"], rtol=LOSS_TOL, atol=LOSS_TOL)
    case = cases[name]
    cfg = ModelConfig(dtype=torch.float32, **case["shape"])
    hp = HybridParallelConfig.from_json_dict(case.get("resume_plan", case["plan"]))
    pieces = [g["params"] for g in got]
    full = bridge.gather_params(pieces, cfg, hp, WORLD)
    for r in range(WORLD):  # no replica (over the replica, TP or CP group) drifted
        held = bridge.shard_params(full, cfg, hp, r, WORLD)
        for a, b in zip(tree_leaves(held), tree_leaves(pieces[r])):
            np.testing.assert_array_equal(a, b)
    flat = jax.tree_util.tree_flatten_with_path(ref["params"])[0]
    assert len(flat) == len(tree_leaves(full))
    for t, (path, j), g in zip(tree_leaves(full), flat, jax.tree.leaves(ref["grads"])):
        key = jax.tree_util.keystr(path)
        if key.endswith("'wqkv_b']"):  # the key slot: see test_torch_context_parallel.py
            np.testing.assert_allclose(t[1], j[1], atol=STEPS * LR, rtol=0, err_msg=key)
            t, j, g = t[[0, 2]], j[[0, 2]], g[[0, 2]]
        noise = np.abs(g) <= ROUNDING_OF_ZERO * np.abs(g).max()
        np.testing.assert_allclose(t[~noise], j[~noise], atol=PARAM_ATOL, rtol=0, err_msg=key)
        np.testing.assert_allclose(t[noise], j[noise], atol=STEPS * LR, rtol=0, err_msg=key)
        assert np.mean(np.abs(t - j) > PARAM_ATOL) < NOISE_SHARE, key


@pytest.mark.parametrize("name", list(_runtime_cases(_ts())))
def test_moe_runtime_trains_like_the_jax_package(world, name):
    cases, refs, results, ranks, _ = world
    assert name in results, _world_failure(ranks)
    _check_runtime(name, cases, refs, results)
    # every layer gathered its logits; the EP layers moved their tokens
    moves = results[name][0]["moves"]
    hp = _ts().HybridParallelConfig.from_json_dict(cases[name]["plan"])
    assert moves["logits"] > 0
    ep = any(s.ep > 1 for s in hp.layer_strategies)
    assert (moves["dispatch"] > 0 and moves["combine"] > 0) == ep, moves


@pytest.mark.parametrize("name", ROUTED)
def test_first_step_routing_equals_the_jax_package(world, name):
    """Every layer's (expert, slot, kept) of the first forward, on every
    rank, equal to the JAX flat model's (global routing, not close)."""
    cases, refs, results, ranks, _ = world
    assert name in results, _world_failure(ranks)
    want = refs[name]["routes"]
    for r, got in enumerate(results[name]):
        assert len(got["routes"]) == len(want), r
        for layer, (g, w) in enumerate(zip(got["routes"], want)):
            for what, a, b in zip(("expert", "slot", "kept"), g, w):
                np.testing.assert_array_equal(a, b, err_msg=f"rank {r} layer {layer} {what}")


def test_pipeline_eval_loss_equals_the_flat_loss(world):
    """pp 2 x tp 2 x ep 2 at chunks 1: the eval loss of the untrained model
    within 3e-5 of the JAX flat ``lm_loss``."""
    cases, refs, results, ranks, _ = world
    name = "pp2_tp2_ep2_c1"
    assert name in results, _world_failure(ranks)
    for got in results[name]:
        assert abs(got["eval"] - refs[name]["eval"]) <= EVAL_TOL


def test_per_rank_routing_control_misses(world):
    """Routing each rank's own 32 tokens (capacity from 32) is a different
    model: the same check must fail."""
    cases, refs, results, ranks, _ = world
    assert "control_local_routing" in results, _world_failure(ranks)
    with pytest.raises(AssertionError):
        _check_runtime("control_local_routing", cases, refs, results)


def test_ep2_checkpoint_resumes_at_ep1_and_at_world_size_1(world):
    """Saved after 2 steps at ep 2 (world 8), restored under the ep 1 plan
    in the world and under world size 1 here: the third step's loss is the
    uninterrupted run's in both."""
    from galvatron_tpu_torch.core import checkpoint
    from galvatron_tpu_torch.core.strategy import HybridParallelConfig

    cases, refs, results, ranks, d = world
    name = "ckpt_ep2_to_ep1"
    assert name in results, _world_failure(ranks)
    _check_runtime(name, cases, refs, results)
    case = cases[name]
    _, _, rt = _build(case, HybridParallelConfig.uniform(2, mixed_precision="fp32",
                                                         vocab_tp=1).to_json_dict(), 1)
    state = checkpoint.restore_checkpoint_portable(str(d / f"ckpt_{name}"), rt)
    assert state["step"] == 2
    _, loss = rt.train_step(state, torch.from_numpy(case["batches"][2]))
    np.testing.assert_allclose(float(loss), results[name][0]["losses"][2], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(loss), refs[name]["losses"][2], rtol=LOSS_TOL, atol=LOSS_TOL)


def test_every_rank_of_the_world_exited_cleanly(world):
    ranks = world[3]
    assert all(r.returncode == 0 and not r.killed for r in ranks), _world_failure(ranks)


# ---------------------------------------------------------------------------
# in process: the unit functions
# ---------------------------------------------------------------------------


def _jmods():
    import jax
    import jax.numpy as jnp

    from galvatron_tpu.models import moe as jmoe

    return jax, jnp, jmoe


def _logits(seed, T, E, skew=0.0):
    x = np.random.RandomState(seed).standard_normal((T, E)).astype(np.float32)
    x[:, 0] += skew
    return x


@pytest.mark.parametrize("T,E,skew,iters", [(64, 4, 0.0, 8), (256, 8, 2.0, 8), (48, 4, 5.0, 20)])
def test_sinkhorn_matches_jax(T, E, skew, iters):
    from galvatron_tpu_torch.models import moe

    jax, jnp, jmoe = _jmods()
    x = _logits(T, T, E, skew)
    ref = np.asarray(jmoe.sinkhorn(jnp.asarray(x), iters))
    got = moe.sinkhorn(torch.from_numpy(x), iters).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)
    np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))


@pytest.mark.parametrize("T,E,cf", [(256, 4, 1.25), (7, 4, 1.0), (100, 8, 2.0), (16384, 8, 1.25)])
def test_moe_capacity_matches_jax(T, E, cf):
    from galvatron_tpu_torch.models import moe

    _, _, jmoe = _jmods()
    assert moe.moe_capacity(T, E, cf) == jmoe.moe_capacity(T, E, cf)


def _onehot(r, E, C):
    """The (T, E, C) dispatch and combine tensors of a port ``Routing``."""
    T = r.expert.shape[0]
    d = np.zeros((T, E, C), np.float32)
    t = np.nonzero(r.kept.numpy())[0]
    d[t, r.expert.numpy()[t], r.slot.numpy()[t]] = 1.0
    return d, d * r.gate.detach().numpy()[:, None, None]


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("T,E,C,skew", [(64, 4, 24, 0.0), (64, 4, 8, 3.0), (96, 8, 8, 0.0)])
def test_route_top1_matches_jax(train, T, E, C, skew):
    """Sinkhorn (train) or raw argmax (eval) and capacity drops: the
    one-hot built from the port's assignments equals the JAX dispatch
    exactly; the gate (``torch.sigmoid`` against XLA's ``1 / (1 + exp(-x))``,
    two exponentials) within one fp32 ulp."""
    from galvatron_tpu_torch.models import moe

    jax, jnp, jmoe = _jmods()
    x = _logits(T + C, T, E, skew)
    jd, jc = jmoe.route_top1(jnp.asarray(x), C, train=train)
    r = moe.route_top1(torch.from_numpy(x), C, train=train)
    d, c = _onehot(r, E, C)
    np.testing.assert_array_equal(d, np.asarray(jd))
    np.testing.assert_allclose(c, np.asarray(jc), rtol=2 ** -23, atol=0)
    if C == 8:
        assert not r.kept.all()  # the case drops tokens


def test_route_top1_ties_take_the_first_expert():
    from galvatron_tpu_torch.models import moe

    _, jnp, jmoe = _jmods()
    x = np.zeros((16, 4), np.float32)
    r = moe.route_top1(torch.from_numpy(x), 8, train=False)
    assert (r.expert == 0).all() and int(r.kept.sum()) == 8
    jd, _ = jmoe.route_top1(jnp.asarray(x), 8, train=False)
    np.testing.assert_array_equal(_onehot(r, 4, 8)[0], np.asarray(jd))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dispatch_and_combine_equal_the_jax_einsums_to_the_last_bit(dtype):
    """``dispatch`` against ``einsum('tec,th->ech')`` and the gated
    ``collect`` against ``einsum('tec,ech->th')`` on the one-hot of the same
    routing and the same gate: equal bit for bit (a single nonzero term
    each)."""
    from galvatron_tpu_torch.models import moe

    jax, jnp, jmoe = _jmods()
    T, E, C, h = 96, 4, 16, 24
    rng = np.random.RandomState(3)
    x = _logits(5, T, E, 1.0)
    xt = rng.standard_normal((T, h)).astype(np.float32)
    ye = rng.standard_normal((E, C, h)).astype(np.float32)
    jd, jc = jmoe.route_top1(jnp.asarray(x), C)
    jdt = getattr(jnp, dtype)
    ref_xe = jnp.einsum("tec,th->ech", jd.astype(jdt), jnp.asarray(xt).astype(jdt))
    ref_y = jnp.einsum("tec,ech->th", jc.astype(jdt), jnp.asarray(ye).astype(jdt))
    tdt = getattr(torch, dtype)
    r = moe.route_top1(torch.from_numpy(x), C)
    dest = torch.where(r.kept, r.expert * C + r.slot, torch.full_like(r.slot, E * C))
    xe = moe.dispatch(torch.from_numpy(xt).to(tdt), dest, E * C).view(E, C, h)
    gate = torch.from_numpy(np.asarray(jc).sum(axis=(1, 2)))  # JAX's gate, 0 when dropped
    y = moe.collect(torch.from_numpy(ye).to(tdt).reshape(E * C, h), dest) \
        * gate.to(tdt)[:, None]
    np.testing.assert_array_equal(xe.float().numpy(), np.asarray(ref_xe.astype(jnp.float32)))
    np.testing.assert_array_equal(y.float().numpy(), np.asarray(ref_y.astype(jnp.float32)))


def _small_cfgs(**kw):
    import jax.numpy as jnp

    from galvatron_tpu.models import modeling as jm
    from galvatron_tpu_torch.models import modeling as tm

    shape = dict(SHAPE, **{"max_seq_len": 16, **kw})
    return jm.ModelConfig(dtype=jnp.float32, **shape), tm.ModelConfig(dtype=torch.float32,
                                                                        **shape)


def test_router_stays_fp32_when_serving_weights_are_cast():
    from galvatron_tpu_torch.models import modeling as tm

    cfg = tm.ModelConfig(**dict(SHAPE, max_seq_len=16))
    p = tm.cast_params(tm.init_model_params(cfg, 0, "cpu"), cfg)
    mlp = p["layers"][0]["mlp"]
    assert mlp["router"]["w"].dtype == torch.float32 and mlp["w1"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# mesh axes and parameter layouts, against the JAX package's mesh
# ---------------------------------------------------------------------------


def _layout_plans(m):
    """MoE plans over the 8-device world: ep on its own, with ZeRO, under TP
    (consecutive or strided, with SP) and at ep 8 over 8 experts."""
    L = m.LayerStrategy

    def plan(*layers, vocab_tp=1):
        return m.HybridParallelConfig(pp=1, layer_strategies=list(layers), vocab_tp=vocab_tp,
                                      mixed_precision="fp32")

    return {"ep2_ddp": plan(L(ep=2), L(ep=4)),
            "ep2_zero2_zero3": plan(L(ep=2, dp_type="zero2"), L(ep=4, dp_type="zero3")),
            "tp2_ep2": plan(L(tp=2, ep=2, dp_type="zero3"), L(tp=2, tp_consec=False, ep=2),
                            vocab_tp=2),
            "tp2_sp_ep4": plan(L(tp=2, sp=True, ep=4, dp_type="zero2"), L(ep=8),
                               vocab_tp=2)}


@pytest.mark.parametrize("name", list(_layout_plans(_ts())))
def test_moe_param_layout_and_axes_equal_the_jax_mesh(name):
    """``param_layout``'s ep rule equals ``param_spec`` leaf by leaf (experts
    over the EP axes, ZeRO over the DP axes outside them), ``ep_axes`` and
    ``moe_token_axes`` equal the JAX mesh's, and ``shard_params`` /
    ``gather_params`` of an MoE tree is the identity."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from galvatron_tpu.core import strategy as js
    from galvatron_tpu.models import modeling as jm
    from galvatron_tpu.parallel import hybrid as jh
    from galvatron_tpu.parallel import mesh as jmesh
    from galvatron_tpu_torch import bridge
    from galvatron_tpu_torch.core.optim import tree_leaves
    from galvatron_tpu_torch.models import modeling as tm
    from galvatron_tpu_torch.parallel import hybrid as th
    from galvatron_tpu_torch.parallel import mesh as tmesh

    shape = dict(SHAPE, moe_experts=8)
    jcfg = jm.ModelConfig(dtype=jnp.float32, **shape)
    tcfg = tm.ModelConfig(dtype=torch.float32, **shape)
    jhp, thp = _layout_plans(js)[name], _layout_plans(_ts())[name]
    _, jaxes = jmesh.build_mesh(pp=1)
    rm = tmesh.RankMesh(WORLD)
    for js_, ts_ in zip(jhp.layer_strategies, thp.layer_strategies):
        assert rm.axes.ep_axes(ts_.tp, ts_.tp_consec, ts_.ep) == jaxes.ep_axes(
            js_.tp, js_.tp_consec, js_.ep)
        assert tmesh.moe_token_axes(rm.axes, ts_) == jmesh.moe_token_axes(jaxes, js_)
    jshape = jax.eval_shape(lambda: jm.init_model_params(jax.random.key(0), jcfg))
    plans = th.model_leaf_plans(tcfg, thp, rm, th.param_shapes(tcfg))

    def entries(spec):
        return tuple((e,) if isinstance(e, str) else (tuple(e) if e is not None else None)
                     for e in spec)

    for opt in (False, True):
        specs = jh.model_param_specs(jshape, jcfg, jhp, jaxes, for_opt_state=opt)
        jl = jax.tree_util.tree_leaves(specs, is_leaf=lambda x: isinstance(x, P))
        tl = tree_leaves(plans)
        assert len(jl) == len(tl)
        for spec, lp in zip(jl, tl):
            assert entries(spec) == (lp.opt_layout if opt else lp.layout), (name, lp.annot)
    full = bridge.params_to_numpy(tm.init_model_params(tcfg, 3, "cpu"))
    pieces = [bridge.shard_params(full, tcfg, thp, r, WORLD) for r in range(WORLD)]
    for a, b in zip(tree_leaves(bridge.gather_params(pieces, tcfg, thp, WORLD)),
                    tree_leaves(full)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# profile and search (tests/test_moe.py's scenarios, against the JAX package)
# ---------------------------------------------------------------------------


def _lt_fields(lt):
    return dict(param=lt.parameter_mb, frac=lt.moe_expert_param_fraction,
                a2a=lt.moe_a2a_mb_per_sample, tfrac=lt.moe_expert_time_fraction,
                boundary=lt.boundary_activation_mb_per_sample)


def _no_jax_temp_bytes(monkeypatch, jpm):
    """The JAX profile's compiled activation bytes are no part of these
    comparisons (the two packages measure activations differently): its
    analytic fallback stands in, and the compiles are saved."""
    monkeypatch.setattr(jpm, "_temp_bytes", lambda *a, **k: None)
    monkeypatch.setattr(jpm, "_temp_bytes_tp", lambda *a, **k: None)


def test_moe_profile_fields_match_jax(monkeypatch):
    """The MoE profile (no timing): expert-parameter fraction, all-to-all MB
    per sample and the parameter sizes equal the JAX package's."""
    from galvatron_tpu.profiling import model as jpm
    from galvatron_tpu_torch.profiling import model as tpm

    _no_jax_temp_bytes(monkeypatch, jpm)
    jcfg, tcfg = _small_cfgs()
    jc = jpm.profile_model(jcfg, bsz=8, measure_time=False)
    tc = tpm.profile_model(tcfg, bsz=8, measure_time=False, device="cpu")
    assert _lt_fields(tc.layer_types[0]) == pytest.approx(_lt_fields(jc.layer_types[0]))
    assert 0.0 < tc.layer_types[0].moe_expert_param_fraction < 1.0
    assert tc.other_param_mb == pytest.approx(jc.other_param_mb)


def _search_scenarios(m):
    """tests/test_moe.py's three EP search scenarios on package m's modules
    (``_pkg`` of tests/test_torch_search.py)."""
    from tests.test_torch_search import _result

    L = m.st.LayerStrategy
    cfg = m.mod.ModelConfig(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
                            ffn_dim=64, max_seq_len=16, moe_experts=4)
    space = m.se.SearchSpace(world_size=8, max_tp=2, allow_ep=True, moe_experts=4,
                             pp_choices=[1])
    eps = sorted({s.ep for s in m.se.generate_layer_strategies(space, pp=1)})
    costs = m.th.analytic_model_costs(cfg, mixed_precision="bf16")
    lt = costs.layer_types[0]
    mem = [m.cm.layer_memory_cost(lt, L(tp=1, ep=e), 8, 1, 8).states_mb for e in (1, 4)]
    hw = m.cm.ProfiledHardware(allreduce_bw={"4_1": 1000.0, "8_1": 1000.0}, overlap_coe=1.0)
    times = [m.cm.layer_time_cost(lt, L(tp=1, ep=e), hw, 8, 1, 8) for e in (1, 4)]
    res = m.se.SearchEngine(costs, hw, num_layers=2, space=space,
                            memory_budget_mb=4096.0).search([8], max_chunks=1)
    mk = lambda tf: m.cm.ProfiledLayerType(  # noqa: E731
        fwd_ms_per_sample=4.26, parameter_mb=100.0, activation_mb_per_sample={1: 10.0},
        boundary_activation_mb_per_sample=0.0, moe_expert_param_fraction=0.943,
        moe_expert_time_fraction=tf)
    hw2 = m.cm.ProfiledHardware(allreduce_bw={"2_1": 1e9, "4_1": 1e9, "8_1": 1e9})
    priced = [m.cm.layer_time_cost(mk(tf), L(tp=1, ep=e), hw2, 8, 1, 8)
              for tf in (0.46, None) for e in (1, 8)]
    return dict(eps=eps, frac=lt.moe_expert_param_fraction, a2a=lt.moe_a2a_mb_per_sample,
                mem=mem, times=times, result=_result(res), priced=priced)


def test_moe_profile_json_and_its_search_match_jax(monkeypatch, tmp_path):
    """``tests/test_moe.py``'s profile round trip and profiled search: the
    JAX package's MoE profile JSONs load in both packages with the expert
    fields kept, the port writes the same JSON from the same costs, and an
    EP search on them emits equal results."""
    from galvatron_tpu.profiling import model as jpm
    from galvatron_tpu_torch.utils import config_utils as tcu
    from tests.test_torch_search import _both, _result

    _no_jax_temp_bytes(monkeypatch, jpm)
    jcfg, _ = _small_cfgs()
    costs = jpm.profile_model(jcfg, bsz=8, measure_time=False,
                              out_prefix=str(tmp_path / "jax"))
    paths = (str(tmp_path / "jax_computation.json"), str(tmp_path / "jax_memory.json"))
    loaded = tcu.load_profiled_model(*paths)
    tcu.save_profiled_model(loaded, str(tmp_path / "port_c.json"), str(tmp_path / "port_m.json"))
    for j, t in zip(paths, ("port_c.json", "port_m.json")):
        assert json.load(open(j)) == json.load(open(tmp_path / t))
    lt = loaded.layer_types[0]
    assert lt.moe_expert_param_fraction == pytest.approx(
        costs.layer_types[0].moe_expert_param_fraction) and 0 < lt.moe_a2a_mb_per_sample

    def search(m):
        cu = __import__(m.name + ".utils.config_utils", fromlist=["x"])
        eng = m.se.SearchEngine(
            cu.load_profiled_model(*paths), m.cm.ProfiledHardware(), num_layers=2,
            space=m.se.SearchSpace(world_size=8, allow_ep=True, moe_experts=4, max_tp=2),
            memory_budget_mb=20000.0)
        return _result(eng.search([8]))

    out = _both(search)
    assert out is not None and out["memory_mb"] > 0


def test_ep_search_scenarios_match_jax():
    from tests.test_torch_search import _both

    out = _both(_search_scenarios)
    assert {1, 2, 4} <= set(out["eps"]) and 8 not in out["eps"]
    assert out["mem"][1] < out["mem"][0] and out["times"][1] < out["times"][0]


# the model-level and entry-point tests: tests/test_torch_moe_cli.py


if __name__ == "__main__" and len(sys.argv) == 4 and sys.argv[1] == "worker":
    sys.path.insert(0, str(ROOT))
    _worker(sys.argv[2], sys.argv[3])
