"""Context parallelism in the port (``parallel/ring.py``, ``parallel/ulysses.py``
and the CP layers of ``parallel/hybrid.py``) against the JAX package, in one
8-rank gloo world on the CPU.

The world (``parallel/launch.py``, a hard deadline that fails instead of
hanging) runs every case while the parent computes the JAX references:

- **functions**: ``ring_attention`` (cp 2 over ``x2``, cp 4 over ``x1, x2``,
  cp 8 over all three axes, the einsum ring at s 24) and
  ``ulysses_attention`` (cp 2, cp 4) on seeded fp32 q/k/v, each rank its
  block of the sequence in its CP group's order. Outputs and the gradients
  of ``(out ** 2).sum()`` are held to the JAX package's functions on the
  simulated 8-device mesh within 1e-5 and to the plain attention within
  2e-5 (forward) and 5e-4 (gradients), the tolerances of
  ``tests/test_ops.py``'s ring and Ulysses tests;
- **runtime**: hybrid plans with CP layers trained 3 steps in fp32 from the
  JAX package's ``key(0)`` weights (``bridge.shard_params``): losses within
  2e-4 of ``tests/test_hybrid_runtime.reference_losses`` (the single-device
  trajectory) and the gathered parameters within 1e-4 of the same run's,
  every rank's piece equal to its cut of the gathered tree (an element whose
  first gradient is within fp32 rounding of zero moves up to ~lr under AdamW
  in either package: ``tests/test_torch_pipeline.py``'s rule holds it to
  steps x lr, in fewer than 0.1 % of a tensor);
- **controls**: a ring that drops one past hop, and a runtime that leaves
  out the CP gradient reduction, must each fail their check.

Then ``cli train --context_parallel_deg 2 --context_parallel_impl a2a`` in a
4-rank world against the same flags at world size 1, and the cp = 4 plan
that ``cli search --enable_cp 1`` emits for a tiny model at s 1024 trained
through ``--galvatron_config_path``.

Run as a script (``python tests/test_torch_context_parallel.py worker CASES
OUT``) this file is one rank of the world; that path imports no JAX.
"""

import os
import pickle
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
WORLD = 8
STEPS = 3
BATCH, SEQ = 8, 32
LR = 1e-3
LOSS_TOL = 2e-4  # tests/test_ops.py's CP runtime tests (rtol / atol)
PARAM_ATOL = 1e-4  # test_torch_training.py's TRAJ_PARAM_ATOL
# test_torch_pipeline.py's rule for an element whose first gradient is within
# fp32 rounding of zero (held to steps x lr, fewer than 0.1 % of a tensor)
ROUNDING_OF_ZERO, NOISE_SHARE = 1e-5, 1e-3
JAX_TOL = 1e-5  # the port's functions against the JAX package's
FWD_TOL, GRAD_TOL = 2e-5, 5e-4  # against the plain attention (tests/test_ops.py)
WORLD_TIMEOUT_S = 900
SHAPE = dict(vocab_size=128, hidden_size=64, num_layers=4, num_heads=4, ffn_dim=128,
             max_seq_len=SEQ)
GPT = dict(pos_embed="learned", norm_type="layernorm", act_fn="gelu", tie_word_embeddings=True,
           use_bias=True)
SHAPES = {"llama": SHAPE, "gqa": dict(SHAPE, num_kv_heads=2), "gpt": dict(SHAPE, **GPT)}

# (name, kind, cp axes, b, s, n, d, grads); a ring of 2 over the minor axis,
# of 4 over two axes, of 8 over all three, as tests/test_ops.py's
FUNCTIONS = [
    ("ring_cp2", "ring", ("x2",), 2, 64, 2, 32, False),
    ("ring_cp4_two_axes", "ring", ("x1", "x2"), 1, 64, 2, 32, True),
    ("ring_cp8", "ring", ("x0", "x1", "x2"), 1, 128, 2, 32, True),
    ("ring_einsum_s24", "ring", ("x2",), 2, 24, 2, 32, True),
    ("ulysses_cp2", "a2a", ("x2",), 2, 64, 2, 32, False),
    ("ulysses_cp4", "a2a", ("x1", "x2"), 1, 64, 4, 32, True),
]
# the control: the cp-4 ring with one past hop (position 0's block) left out
DROPPED_HOP = ("ring_dropped_hop", "ring", ("x1", "x2"), 1, 64, 2, 32, True)


def _runtime_cases(m):
    """name → (model shape, plan), built from strategy module ``m``."""
    U, L = m.HybridParallelConfig.uniform, m.LayerStrategy

    def plan(layers, **kw):
        return m.HybridParallelConfig(pp=kw.pop("pp", 1), layer_strategies=layers,
                                      vocab_tp=kw.pop("vocab_tp", 1), mixed_precision="fp32",
                                      **kw)

    return {
        "cp2_ring": ("llama", U(4, cp=2, mixed_precision="fp32", vocab_tp=1)),
        "cp2_a2a": ("llama", U(4, cp=2, cp_impl="a2a", mixed_precision="fp32", vocab_tp=1)),
        # world 8: tp 2 x cp 2 x dp 2
        "tp2_cp2_ring": ("llama", U(4, tp=2, cp=2, mixed_precision="fp32", vocab_tp=2)),
        # SP as well: the CP block is gathered over the TP group
        "tp2_sp_cp2_a2a": ("llama", U(4, tp=2, sp=True, cp=2, cp_impl="a2a",
                                      mixed_precision="fp32", vocab_tp=2)),
        "cp2_ring_zero2": ("llama", U(4, cp=2, dp_type="zero2", mixed_precision="fp32",
                                  vocab_tp=1)),
        "cp2_ring_zero3_full": ("llama", U(4, cp=2, dp_type="zero3", ckpt="full",
                                       mixed_precision="fp32", vocab_tp=1,
                                       embed_dp_type="zero3")),
        "cp4_ring": ("llama", U(4, cp=4, mixed_precision="fp32", vocab_tp=1)),
        # grouped K/V: repeated before the ring, kept at kv heads across the a2a
        "gqa": ("gqa", plan([L(cp=2), L(cp=2, cp_impl="a2a"), L(cp=4), L(cp=4, cp_impl="a2a")])),
        "gpt": ("gpt", plan([L(cp=2), L(cp=2, cp_impl="a2a", tp=2), L(cp=4, dp_type="zero2"),
                             L(cp=2, ckpt="full")], vocab_tp=2)),
        "mixed": ("llama", plan([L(cp=2), L(tp=2, sp=True), L(cp=4, cp_impl="a2a",
                                                             dp_type="zero2"), L()])),
        "pp2_ring": ("llama", plan([L(cp=2)] * 4, pp=2, chunks=2)),
        "pp2_a2a": ("llama", plan([L(cp=2, cp_impl="a2a")] * 4, pp=2, chunks=2)),
        # the interleaved 1F1B schedule (vpp 2)
        "pp2_vpp2_ring": ("llama", plan([L(cp=2)] * 4, pp=2, vpp=2, chunks=2,
                                        pipeline_type="pipedream_flush")),
    }


def _ts():
    from galvatron_tpu_torch.core import strategy as ts

    return ts


# ---------------------------------------------------------------------------
# a rank of the world (no JAX here)
# ---------------------------------------------------------------------------


def _function_case(case, rank):
    """This rank's block of q/k/v, through the port's function; returns
    its output block, its gradient blocks and its place in the group."""
    from galvatron_tpu_torch.models.modeling import ModelConfig
    from galvatron_tpu_torch.parallel import ring, ulysses
    from galvatron_tpu_torch.parallel.mesh import ProcessGroups, RankMesh

    axes = tuple(case["axes"])
    mesh = RankMesh(WORLD)
    group = ProcessGroups(mesh, rank, [axes]).get(axes)
    s = case["q"].shape[1]
    n = s // group.size
    blk = slice(group.index * n, (group.index + 1) * n)
    # the ring order is the order of the layer's sequence blocks (the axes
    # are the minor ones, a cp layer's at tp 1)
    assert mesh.seq_slice(rank, _ts().LayerStrategy(cp=group.size), s) == blk
    q, k, v = (torch.from_numpy(case[x][:, blk].copy()).requires_grad_(case["grads"])
               for x in "qkv")
    if case["kind"] == "ring":
        out = ring.ring_attention(q, k, v, group)
    else:
        cfg = ModelConfig(num_heads=q.shape[2], hidden_size=q.shape[2] * q.shape[3],
                          dtype=torch.float32)
        out = ulysses.ulysses_attention(q, k, v, cfg, group)
    res = {"index": group.index, "ranks": group.ranks, "out": out.detach().numpy()}
    if case["grads"]:
        (out ** 2).sum().backward()
        res["grads"] = [t.grad.numpy() for t in (q, k, v)]
    return res


def _runtime_case(case, rank, world):
    from galvatron_tpu_torch import bridge
    from galvatron_tpu_torch.core.optim import AdamConfig
    from galvatron_tpu_torch.core.strategy import HybridParallelConfig
    from galvatron_tpu_torch.models.modeling import ModelConfig
    from galvatron_tpu_torch.parallel import hybrid

    cfg = ModelConfig(dtype=torch.float32, **case["shape"])
    hp = HybridParallelConfig.from_json_dict(case["plan"])
    rt = hybrid.build_runtime(cfg, hp, AdamConfig(lr=LR, grad_clip=1.0),
                              global_batch_size=BATCH, seq_len=SEQ, device="cpu")
    local = bridge.shard_params(case["params"], cfg, hp, rank, world)
    state = rt.state_from(hybrid.zip_map(
        lambda a, n: torch.from_numpy(np.array(a, copy=True)), local))
    losses = []
    for b in case["batches"]:
        state, loss = rt.train_step(state, torch.from_numpy(b))
        losses.append(float(loss))
    return {"losses": losses, "params": bridge.params_to_numpy(state["params"])}


def _worker(case_path: str, out_dir: str) -> None:
    import torch.distributed as dist

    from galvatron_tpu_torch.core.trainer import init_distributed
    from galvatron_tpu_torch.parallel import hybrid, ring

    torch.set_num_threads(1)
    init_distributed(torch.device("cpu"), "gloo", timeout_s=300)
    rank, world = dist.get_rank(), dist.get_world_size()
    with open(case_path, "rb") as f:
        cases = pickle.load(f)
    real_reduce, real_past = hybrid._reduce_cp, ring._past
    try:
        for case in cases:
            # the controls: no CP gradient reduction; a ring without the
            # hop that brings position 0's block
            hybrid._reduce_cp = (lambda g, lp: g) if case.get("no_cp_reduce") else real_reduce
            ring._past = ((lambda owner, idx: 0 < owner < idx) if case.get("drop_hop")
                          else real_past)
            res = (_function_case(case, rank) if case["kind"] in ("ring", "a2a")
                   else _runtime_case(case, rank, world))
            with open(os.path.join(out_dir, f"{case['name']}.{rank}.pkl"), "wb") as f:
                pickle.dump(res, f)
    finally:
        hybrid._reduce_cp, ring._past = real_reduce, real_past
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the JAX side and the world (pytest)
# ---------------------------------------------------------------------------


def _qkv(b, s, n, d, seed):
    rng = np.random.RandomState(seed)
    return [rng.standard_normal((b, s, n, d)).astype(np.float32) for _ in range(3)]


def _jax_function(kind, axes, q, k, v, grads):
    """(out, grads or None) of the JAX package's function on the simulated
    mesh, and (out, grads) of the plain attention (``attention_xla``)."""
    import jax
    import jax.numpy as jnp

    from galvatron_tpu.models import modeling as jm
    from galvatron_tpu.parallel.mesh import build_mesh
    from galvatron_tpu.parallel.ring import ring_attention
    from galvatron_tpu.parallel.ulysses import ulysses_attention

    mesh, _ = build_mesh(pp=1)
    cfg = jm.ModelConfig(num_heads=q.shape[2], hidden_size=q.shape[2] * q.shape[3])

    def fn(q, k, v):
        if kind == "ring":
            return ring_attention(q, k, v, mesh, axes)
        return ulysses_attention(q, k, v, cfg, mesh, axes)

    def plain(q, k, v):
        return jm.attention_xla(q, k, v, cfg)

    args = tuple(jnp.asarray(x) for x in (q, k, v))
    out = (np.asarray(jax.jit(fn)(*args)), np.asarray(plain(*args)))
    if not grads:
        return out, (None, None)
    g = [jax.jit(jax.grad(lambda *a, f=f: (f(*a) ** 2).sum(), (0, 1, 2)))(*args)
         for f in (fn, plain)]
    return out, tuple([np.asarray(x) for x in gi] for gi in g)


def _jax_params(shape):
    import jax
    import jax.numpy as jnp

    from galvatron_tpu.models import modeling as jm

    cfg = jm.ModelConfig(dtype=jnp.float32, **shape)
    return jax.tree.map(np.asarray, jm.init_model_params(jax.random.key(0), cfg))


def _jax_trajectory(shape, batches):
    """``reference_losses``' single-device fp32 trajectory (its optimizer,
    its weights), with the final parameters and the first gradients."""
    import jax
    import jax.numpy as jnp

    from galvatron_tpu.core.optim import adamw_update, init_opt_state
    from galvatron_tpu.models import modeling as jm
    from tests.test_hybrid_runtime import ADAM, reference_losses

    cfg = jm.ModelConfig(dtype=jnp.float32, **shape)
    params = jax.tree.map(jnp.asarray, _jax_params(shape))
    opt = init_opt_state(params)
    step = jax.jit(jax.value_and_grad(lambda p, b: jm.lm_loss(p, b, cfg)))
    first = None
    for b in batches:
        _, grads = step(params, jnp.asarray(b))
        first = first or jax.tree.map(np.asarray, grads)
        params, opt = adamw_update(params, grads, opt, ADAM)
    losses = reference_losses(cfg, [jnp.asarray(b) for b in batches])
    return losses, jax.tree.map(np.asarray, params), first


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every case in one 8-rank gloo world, the JAX references computed
    meanwhile; returns (the cases by name, the JAX references by name, each
    case's per-rank results (missing when a rank failed), the launcher's
    per-rank results)."""
    from galvatron_tpu_torch.parallel.launch import launch_local
    from tests.test_hybrid_runtime import make_batches

    d = tmp_path_factory.mktemp("torch_cp_world")
    cases = []
    for i, (name, kind, axes, b, s, n, hd, grads) in enumerate(FUNCTIONS + [DROPPED_HOP]):
        q, k, v = _qkv(b, s, n, hd, seed=i)
        cases.append(dict(name=name, kind=kind, axes=axes, q=q, k=k, v=v, grads=grads,
                          drop_hop=name == DROPPED_HOP[0]))
    batches = {kind: [np.asarray(x) for x in make_batches(seed=j)]
               for j, kind in enumerate(SHAPES)}
    params = {kind: _jax_params(shape) for kind, shape in SHAPES.items()}
    runtime = _runtime_cases(_ts())
    for name, (kind, hp) in runtime.items():
        cases.append(dict(name=name, kind="runtime", shape=SHAPES[kind], plan=hp.to_json_dict(),
                          batches=batches[kind], params=params[kind]))
    control_of = "cp2_ring"
    cases.append(dict(next(c for c in cases if c["name"] == control_of),
                      name="control_no_cp_reduce", no_cp_reduce=True))
    case_path = d / "cases.pkl"
    with open(case_path, "wb") as f:
        pickle.dump(cases, f)
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    out = {}
    run = threading.Thread(target=lambda: out.setdefault("ranks", launch_local(
        [sys.executable, str(Path(__file__).resolve()), "worker", str(case_path), str(d)],
        WORLD, timeout_s=WORLD_TIMEOUT_S, env=env, cwd=str(ROOT))))
    run.start()
    refs = {}
    for c in cases:
        if c["kind"] != "runtime":
            refs[c["name"]] = _jax_function(c["kind"], c["axes"], c["q"], c["k"], c["v"],
                                            c["grads"])
    traj = {kind: _jax_trajectory(SHAPES[kind], batches[kind]) for kind in SHAPES}
    for name, (kind, _) in runtime.items():
        refs[name] = traj[kind]
    refs["control_no_cp_reduce"] = refs[control_of]
    run.join()
    ranks = out["ranks"]
    by_name = {c["name"]: c for c in cases}
    results = {}
    for c in cases:
        files = [d / f"{c['name']}.{r}.pkl" for r in range(WORLD)]
        if all(f.exists() for f in files):
            results[c["name"]] = [pickle.load(open(f, "rb")) for f in files]
    return by_name, refs, results, ranks


def _world_failure(ranks):
    bad = [r for r in ranks if r.returncode != 0]
    return "\n".join(f"rank {r.rank} rc={r.returncode} killed={r.killed}:\n{r.output[-3000:]}"
                     for r in bad)


def _assembled(got, key, i=None):
    """The whole-sequence array from the blocks of rank 0's group."""
    mine = [g for g in got if g["ranks"] == got[0]["ranks"]]
    mine.sort(key=lambda g: g["index"])
    return np.concatenate([g[key] if i is None else g[key][i] for g in mine], axis=1)


def _check_function(name, refs, results):
    (jout, pout), (jgrads, pgrads) = refs[name]
    got = results[name]
    out = _assembled(got, "out")
    np.testing.assert_allclose(out, jout, rtol=JAX_TOL, atol=JAX_TOL)
    np.testing.assert_allclose(out, pout, rtol=FWD_TOL, atol=FWD_TOL)
    if jgrads is not None:
        for i, (jg, pg) in enumerate(zip(jgrads, pgrads)):
            g = _assembled(got, "grads", i)
            np.testing.assert_allclose(g, jg, rtol=JAX_TOL, atol=JAX_TOL, err_msg=f"d{'qkv'[i]}")
            np.testing.assert_allclose(g, pg, rtol=GRAD_TOL, atol=GRAD_TOL, err_msg=f"d{'qkv'[i]}")


def _check_runtime(name, cases, refs, results):
    from galvatron_tpu_torch import bridge
    from galvatron_tpu_torch.core.optim import tree_leaves
    from galvatron_tpu_torch.core.strategy import HybridParallelConfig
    from galvatron_tpu_torch.models.modeling import ModelConfig

    jlosses, jparams, jgrads = refs[name]
    got = results[name]
    losses = got[0]["losses"]
    assert all(g["losses"] == losses for g in got), "ranks report different losses"
    np.testing.assert_allclose(losses, jlosses, rtol=LOSS_TOL, atol=LOSS_TOL)
    case = cases[name]
    cfg = ModelConfig(dtype=torch.float32, **case["shape"])
    hp = HybridParallelConfig.from_json_dict(case["plan"])
    pieces = [g["params"] for g in got]
    full = bridge.gather_params(pieces, cfg, hp, WORLD)
    for r in range(WORLD):  # no replica (over DP, TP or CP) drifted from the gathered value
        held = bridge.shard_params(full, cfg, hp, r, WORLD)
        for a, b in zip(tree_leaves(held), tree_leaves(pieces[r])):
            np.testing.assert_array_equal(a, b)
    import jax

    flat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    assert len(flat) == len(tree_leaves(full))
    for t, (path, j), g in zip(tree_leaves(full), flat, jax.tree.leaves(jgrads)):
        key = jax.tree_util.keystr(path)
        if key.endswith("'wqkv_b']"):
            # the key slot's gradient is exactly zero (softmax ignores a
            # per-row constant): AdamW turns its rounding noise into steps
            # of up to ~lr, so that slot is held to steps x lr
            np.testing.assert_allclose(t[1], j[1], atol=STEPS * LR, rtol=0, err_msg=key)
            t, j, g = t[[0, 2]], j[[0, 2]], g[[0, 2]]
        noise = np.abs(g) <= ROUNDING_OF_ZERO * np.abs(g).max()
        np.testing.assert_allclose(t[~noise], j[~noise], atol=PARAM_ATOL, rtol=0, err_msg=key)
        np.testing.assert_allclose(t[noise], j[noise], atol=STEPS * LR, rtol=0, err_msg=key)
        assert np.mean(np.abs(t - j) > PARAM_ATOL) < NOISE_SHARE, key


@pytest.mark.parametrize("name", [f[0] for f in FUNCTIONS])
def test_function_matches_the_jax_package(world, name):
    cases, refs, results, ranks = world
    assert name in results, _world_failure(ranks)
    _check_function(name, refs, results)


def test_ring_without_a_past_hop_fails(world):
    """The cp-4 ring with position 0's block left out of the later
    positions' rows: the same check must fail."""
    cases, refs, results, ranks = world
    name = DROPPED_HOP[0]
    assert name in results, _world_failure(ranks)
    refs = dict(refs, **{name: refs["ring_cp4_two_axes"]})
    with pytest.raises(AssertionError):
        _check_function(name, refs, results)


@pytest.mark.parametrize("name", list(_runtime_cases(_ts())))
def test_runtime_trains_like_the_jax_package(world, name):
    cases, refs, results, ranks = world
    assert name in results, _world_failure(ranks)
    _check_runtime(name, cases, refs, results)


def test_cp_gradient_reduction_control_fails(world):
    """Without the sum over the CP group each rank steps on its own block's
    gradient: the same check must fail."""
    cases, refs, results, ranks = world
    assert "control_no_cp_reduce" in results, _world_failure(ranks)
    with pytest.raises(AssertionError):
        _check_runtime("control_no_cp_reduce", cases, refs, results)


def test_every_rank_of_the_world_exited_cleanly(world):
    *_, ranks = world
    assert all(r.returncode == 0 and not r.killed for r in ranks), _world_failure(ranks)


# ---------------------------------------------------------------------------
# in process
# ---------------------------------------------------------------------------


def test_ring_flash_block_size_selection():
    """The flash ring whenever the local sequence tiles to a power of two,
    else the einsum ring: the reference's selection."""
    from galvatron_tpu_torch.parallel.ring import _flash_block_size

    assert _flash_block_size(2048) == 1024
    assert _flash_block_size(96) == 32
    assert _flash_block_size(16) == 16
    assert _flash_block_size(12) == 0
    assert _flash_block_size(7) == 0


def test_ulysses_head_divisibility_error():
    from galvatron_tpu_torch.models.modeling import ModelConfig
    from galvatron_tpu_torch.parallel.mesh import Group
    from galvatron_tpu_torch.parallel.ulysses import ulysses_attention

    q, k, v = (torch.from_numpy(x) for x in _qkv(2, 4, 2, 32, seed=0))
    cfg = ModelConfig(num_heads=2, hidden_size=64, dtype=torch.float32)
    with pytest.raises(ValueError, match="divisible"):
        ulysses_attention(q, k, v, cfg, Group(tuple(range(8)), 0))  # cp=8 > 2 heads


def test_the_reference_refusals_keep_their_messages():
    from galvatron_tpu_torch.models.modeling import ModelConfig
    from galvatron_tpu_torch.parallel import hybrid

    ts = _ts()
    hp = ts.HybridParallelConfig.uniform(4, cp=2)
    with pytest.raises(ValueError, match="causal-only"):
        hybrid.check_cp(ModelConfig(causal=False, **SHAPE), hp, SEQ)
    with pytest.raises(ValueError, match="enc-dec"):
        hybrid.check_cp(ModelConfig(enc_layers=2, **SHAPE), hp, SEQ)


# ---------------------------------------------------------------------------
# cli train in 4-rank worlds
# ---------------------------------------------------------------------------

TINY = ["--model_size", "llama-0.3b", "--num_layers", "4", "--hidden_size", "64",
        "--num_heads", "4", "--ffn_dim", "128", "--vocab_size", "128",
        "--global_train_batch_size", "8", "--train_iters", "3", "--mixed_precision", "fp32"]


def _cli_losses(argv, world, tmp_path, tag):
    from galvatron_tpu_torch.parallel.launch import launch_local
    from galvatron_tpu_torch.utils.metrics import read_metrics

    metrics = tmp_path / f"{tag}.jsonl"
    cmd = [sys.executable, "-m", "galvatron_tpu_torch.cli", "train", "--device", "cpu", *argv,
           "--metrics_path", str(metrics)]
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    if world == 1:
        r = subprocess.run(cmd, env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
        assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    else:
        ranks = launch_local(cmd, world, timeout_s=600, cwd=str(ROOT), env=env)
        assert all(r.returncode == 0 for r in ranks), _world_failure(ranks)
    return [r["loss"] for r in read_metrics(str(metrics)) if r["event"] == "train_iter"]


if __name__ == "__main__" and len(sys.argv) == 4 and sys.argv[1] == "worker":
    sys.path.insert(0, str(ROOT))
    _worker(sys.argv[2], sys.argv[3])
