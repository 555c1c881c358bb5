"""Per-layer hybrid parallelism in the port against the JAX package, in gloo
process worlds on the CPU.

One world of 8 ranks per module (``parallel/launch.py``, with a hard
deadline that fails instead of hanging) trains, in fp32 from the JAX
package's ``key(0)`` weights cut into each rank's pieces by
``bridge.shard_params``: every strategy of ``tests/test_hybrid_runtime.py``'s
STRATEGIES, the GPT family (with and without projection biases), a GQA
model, and (in ``tests/test_torch_hybrid_plans.py``'s world, which runs
beside it) the checked-in ``llama-7b_8dev_32gb.json`` /
``llama-0.3b_8dev_16gb.json`` plans at a narrow width with their layer
counts. Each case's 3-step losses
are held to the JAX losses at the reference's own 2e-4 (its single-device
trajectory; ``build_runtime`` on the 8-device simulation itself for hetero,
tp4_sp and zero3) and the gathered final parameters to 1e-4, the tolerance
of ``test_torch_training.py``'s trajectories; every rank's piece must equal
its cut of the gathered tree bit for bit, so no replica drifts. A control
with the DP gradient reduction taken out must fail the same check.

The port refuses uneven shards (GSPMD pads them), so the batch is 16 rows:
8 per micro-batch under ``chunks=2`` at DP 8.

Run as a script (``python tests/test_torch_hybrid.py worker CASES OUT``)
this file is one rank of the world; that path imports no JAX.
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
BATCH, SEQ = 16, 32
LR = 1e-3
LOSS_TOL = 2e-4  # tests/test_hybrid_runtime.py's rtol / atol
PARAM_ATOL = 1e-4  # test_torch_training.py's TRAJ_PARAM_ATOL
WORLD_TIMEOUT_S = 900
SHAPE = dict(vocab_size=128, hidden_size=64, num_layers=4, num_heads=4, ffn_dim=128,
             max_seq_len=SEQ)
GPT = dict(pos_embed="learned", norm_type="layernorm", act_fn="gelu", tie_word_embeddings=True)
# the checked-in plans at a narrow width: (plan file, model shape, global batch);
# llama-7b's plan runs tp=8 (8 heads) under vocab_tp=4, chunks 4; llama-0.3b's
# zero3 at DP 8 under chunks 8 needs 8 rows a micro-batch
PLANS = {
    "llama-7b_8dev_32gb": (dict(SHAPE, num_layers=32, num_heads=8), 8),
    "llama-0.3b_8dev_16gb": (dict(SHAPE, num_layers=24), 64),
}


def _strategies(m):
    """``tests/test_hybrid_runtime.py``'s STRATEGIES, built from module ``m``
    (the JAX package's strategy module or the port's copy)."""
    U, L = m.HybridParallelConfig.uniform, m.LayerStrategy
    return {
        "pure_dp": U(4, tp=1, mixed_precision="fp32", vocab_tp=1),
        "tp2": U(4, tp=2, mixed_precision="fp32", vocab_tp=2),
        "tp4_sp": U(4, tp=4, sp=True, mixed_precision="fp32", vocab_tp=4),
        "tp2_strided": U(4, tp=2, tp_consec=False, mixed_precision="fp32", vocab_tp=1),
        "zero3": U(4, tp=1, dp_type="zero3", mixed_precision="fp32", vocab_tp=1,
                   embed_dp_type="zero3"),
        "zero2": U(4, tp=1, dp_type="zero2", mixed_precision="fp32", vocab_tp=1),
        "ckpt": U(4, tp=2, ckpt=True, mixed_precision="fp32", vocab_tp=2),
        "ckpt_selective": U(4, tp=2, ckpt="selective", mixed_precision="fp32", vocab_tp=2),
        "accum2": U(4, tp=1, mixed_precision="fp32", vocab_tp=1, chunks=2),
        "hetero": m.HybridParallelConfig(
            pp=1, layer_strategies=[L(tp=1, dp_type="zero3"), L(tp=2, dp_type="ddp", ckpt=True),
                                    L(tp=4, sp=True, dp_type="ddp"),
                                    L(tp=2, tp_consec=False, dp_type="zero2")],
            vocab_tp=2, mixed_precision="fp32"),
    }


def _extra_cases(m):
    """(model shape, plan) of the cases beyond STRATEGIES."""
    U, L = m.HybridParallelConfig.uniform, m.LayerStrategy
    return {
        # test_gpt_family_parity's plan
        "gpt": (dict(SHAPE, **GPT), U(4, tp=2, mixed_precision="fp32", vocab_tp=2)),
        # biases under every layout, a tied vocab-parallel head under SP
        "gpt_bias_hetero": (dict(SHAPE, **GPT, use_bias=True), m.HybridParallelConfig(
            pp=1, layer_strategies=[L(tp=2, sp=True, dp_type="zero3"), L(tp=4, ckpt="selective"),
                                    L(tp=1, dp_type="zero2", ckpt=True),
                                    L(tp=2, tp_consec=False, sp=True, dp_type="zero2")],
            vocab_tp=4, vocab_sp=True, embed_dp_type="zero3", chunks=2,
            mixed_precision="fp32")),
        # the interleaved (kv-group) qkv layout: whole groups per TP rank
        "gqa_tp2_sp": (dict(SHAPE, num_kv_heads=2), U(4, tp=2, sp=True, dp_type="zero2",
                                                       mixed_precision="fp32", vocab_tp=2)),
    }


def _plan(m, name):
    hp = m.HybridParallelConfig.load(str(ROOT / "configs" / "strategies" / f"{name}.json"))
    hp.mixed_precision = "fp32"  # narrow fp32 parity; the plan's bf16 runs on the card
    return hp


def _case_names():
    """This file's world's cases (the checked-in plans train in
    ``tests/test_torch_hybrid_plans.py``'s world)."""
    return list(_strategies(_ts())) + list(_extra_cases(_ts()))


def _ts():
    from galvatron_tpu_torch.core import strategy as ts

    return ts


# ---------------------------------------------------------------------------
# a rank of the world (no JAX here)
# ---------------------------------------------------------------------------


def _worker(case_path: str, out_dir: str) -> None:
    import torch.distributed as dist

    from galvatron_tpu_torch import bridge
    from galvatron_tpu_torch.core.optim import AdamConfig
    from galvatron_tpu_torch.core.strategy import HybridParallelConfig
    from galvatron_tpu_torch.core.trainer import init_distributed
    from galvatron_tpu_torch.models.modeling import ModelConfig
    from galvatron_tpu_torch.parallel import comm, hybrid

    torch.set_num_threads(1)
    init_distributed(torch.device("cpu"), "gloo", timeout_s=300)
    rank, world = dist.get_rank(), dist.get_world_size()
    with open(case_path, "rb") as f:
        cases = pickle.load(f)
    real_reduce = hybrid._reduce_dp
    try:
        for case in cases:
            cfg = ModelConfig(dtype=torch.float32, **case["shape"])
            hp = HybridParallelConfig.from_json_dict(case["plan"])
            # the control: DP gradients left unreduced
            hybrid._reduce_dp = (lambda g, lp: g) if case["control"] else real_reduce
            rt = hybrid.build_runtime(cfg, hp, AdamConfig(lr=LR, grad_clip=1.0),
                                      global_batch_size=case["batch"], seq_len=SEQ, device="cpu")
            local = bridge.shard_params(case["params"], cfg, hp, rank, world)
            state = rt.state_from(hybrid.zip_map(
                lambda a, n: torch.from_numpy(np.array(a, copy=True)), local))
            losses = []
            comm.reset_counts()
            for b in case["batches"]:
                state, loss = rt.train_step(state, torch.from_numpy(b))
                losses.append(float(loss))
            with open(os.path.join(out_dir, f"{case['name']}.{rank}.pkl"), "wb") as f:
                pickle.dump({"losses": losses, "regathered": comm.regathered,
                             "params": bridge.params_to_numpy(state["params"])}, f)
    finally:
        hybrid._reduce_dp = real_reduce
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the JAX side and the world (pytest)
# ---------------------------------------------------------------------------


def _jax_cfg(shape):
    import jax.numpy as jnp

    from galvatron_tpu.models import modeling as jm

    return jm.ModelConfig(dtype=jnp.float32, **shape)


def _all_cases():
    """name → (model shape, JAX plan, port plan, global batch)."""
    from galvatron_tpu.core import strategy as js

    ts = _ts()
    out = {}
    jst, tst = _strategies(js), _strategies(ts)
    for name in jst:
        out[name] = (SHAPE, jst[name], tst[name], BATCH)
    jx, tx = _extra_cases(js), _extra_cases(ts)
    for name in jx:
        out[name] = (jx[name][0], jx[name][1], tx[name][1], BATCH)
    for name, (shape, batch) in PLANS.items():
        out[name] = (shape, _plan(js, name), _plan(ts, name), batch)
    return out


def _batches(batch, seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, SHAPE["vocab_size"], (batch, SEQ + 1)).astype(np.int32)
            for _ in range(STEPS)]


def _jax_params(shape):
    import jax

    from galvatron_tpu.models import modeling as jm

    return jax.tree.map(np.asarray, jm.init_model_params(jax.random.key(0), _jax_cfg(shape)))


def _jax_reference(name, shape, jhp, batches):
    """(losses, final params) of the JAX package: its single-device
    trajectory, or ``build_runtime`` on the 8-device simulation for
    hetero, tp4_sp and zero3."""
    import jax
    import jax.numpy as jnp

    from galvatron_tpu.core.optim import AdamConfig, adamw_update, init_opt_state
    from galvatron_tpu.models import modeling as jm
    from galvatron_tpu.parallel.hybrid import build_runtime

    cfg = _jax_cfg(shape)
    adam = AdamConfig(lr=LR, grad_clip=1.0)
    params = jax.tree.map(jnp.asarray, _jax_params(shape))
    losses = []
    if name in ("hetero", "tp4_sp", "zero3"):
        rt = build_runtime(cfg, jhp, adam=adam, global_batch_size=batches[0].shape[0],
                           seq_len=SEQ)
        state = rt.init_state_from(params)
        for b in batches:
            state, loss = rt.train_step(state, jnp.asarray(b))
            losses.append(float(loss))
        return losses, jax.tree.map(np.asarray, state["params"])
    step = jax.jit(jax.value_and_grad(lambda p, b: jm.lm_loss(p, b, cfg)))
    opt = init_opt_state(params)
    for b in batches:
        loss, grads = step(params, jnp.asarray(b))
        params, opt = adamw_update(params, grads, opt, adam)
        losses.append(float(loss))
    return losses, jax.tree.map(np.asarray, params)


def run_world(d, names, control):
    """Run the cases ``names`` (and with ``control`` the control of
    pure_dp) in one 8-rank gloo world under ``d``; returns the case table
    (with each case's JAX losses and parameters), each case's per-rank
    results (missing when its rank failed) and the launcher's per-rank
    results."""
    from galvatron_tpu_torch.parallel.launch import launch_local

    cases, table = [], {}
    for i, (name, (shape, jhp, thp, batch)) in enumerate(_all_cases().items()):
        if name not in names:
            continue
        batches = _batches(batch, seed=i)
        table[name] = (shape, jhp, thp, batches)
        cases.append(dict(name=name, shape=shape, plan=thp.to_json_dict(), batch=batch,
                          batches=batches, params=_jax_params(shape), control=False))
    if control:
        shape, jhp, thp, batches = table["pure_dp"]
        cases.append(dict(name="control_pure_dp", shape=shape, plan=thp.to_json_dict(),
                          batch=BATCH, batches=batches, params=_jax_params(shape), control=True))
        table["control_pure_dp"] = table["pure_dp"]
    case_path = d / "cases.pkl"
    with open(case_path, "wb") as f:
        pickle.dump(cases, f)
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    out = {}
    run = threading.Thread(target=lambda: out.setdefault("ranks", launch_local(
        [sys.executable, str(Path(__file__).resolve()), "worker", str(case_path), str(d)],
        WORLD, timeout_s=WORLD_TIMEOUT_S, env=env, cwd=str(ROOT))))
    run.start()  # the JAX references are computed while the world trains
    refs = {name: _jax_reference(name, shape, jhp, batches)
            for name, (shape, jhp, thp, batches) in table.items() if name != "control_pure_dp"}
    run.join()
    ranks = out["ranks"]
    if control:
        refs["control_pure_dp"] = refs["pure_dp"]
    table = {name: row + (refs[name],) for name, row in table.items()}
    results = {}
    for c in cases:
        files = [d / f"{c['name']}.{r}.pkl" for r in range(WORLD)]
        if all(f.exists() for f in files):
            results[c["name"]] = [pickle.load(open(f, "rb")) for f in files]
    return table, results, ranks


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_world(tmp_path_factory.mktemp("torch_hybrid_world"), _case_names(), True)


def _world_failure(ranks):
    bad = [r for r in ranks if r.returncode != 0]
    return "\n".join(f"rank {r.rank} rc={r.returncode} killed={r.killed}:\n{r.output[-3000:]}"
                     for r in bad)


def _check(name, table, results):
    """Raise AssertionError unless the case's losses, gathered parameters
    and every rank's pieces hold against the JAX run."""
    from galvatron_tpu_torch import bridge
    from galvatron_tpu_torch.core.optim import tree_leaves
    from galvatron_tpu_torch.models.modeling import ModelConfig
    from galvatron_tpu_torch.parallel import hybrid
    from galvatron_tpu_torch.parallel.mesh import RankMesh
    from galvatron_tpu_torch.parallel.sharding import shard

    shape, jhp, thp, batches, (jlosses, jparams) = table[name]
    got = results[name]
    losses = got[0]["losses"]
    assert all(g["losses"] == losses for g in got), "ranks report different losses"
    np.testing.assert_allclose(losses, jlosses, rtol=LOSS_TOL, atol=LOSS_TOL)
    cfg = ModelConfig(dtype=torch.float32, **shape)
    pieces = [g["params"] for g in got]
    full = bridge.gather_params(pieces, cfg, thp, WORLD)
    mesh = RankMesh(WORLD)
    plans = hybrid.model_leaf_plans(cfg, thp, mesh, hybrid.param_shapes(cfg))
    for r in range(WORLD):  # no replica drifted from the gathered value
        for lp, f, p in zip(tree_leaves(plans), tree_leaves(full), tree_leaves(pieces[r])):
            np.testing.assert_array_equal(shard(f, lp.layout, mesh, r, lp.pairs), p)
    import jax

    flat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    assert len(flat) == len(tree_leaves(full))
    for t, (path, j) in zip(tree_leaves(full), flat):
        key = jax.tree_util.keystr(path)
        if key.endswith("'wqkv_b']"):
            # the key slot's gradient is exactly zero (softmax ignores a
            # per-row constant): AdamW turns its rounding noise into steps
            # of up to ~lr, so that slot is held to steps x lr
            np.testing.assert_allclose(t[1], j[1], atol=STEPS * LR, rtol=0, err_msg=key)
            t, j = t[[0, 2]], j[[0, 2]]
        np.testing.assert_allclose(t, j, atol=PARAM_ATOL, rtol=0, err_msg=key)


@pytest.mark.parametrize("name", _case_names())
def test_trains_like_the_jax_package(world, name):
    table, results, ranks = world
    assert name in results, _world_failure(ranks)
    _check(name, table, results)


def test_zero3_layers_are_gathered_again_in_the_backward(world):
    """A zero3 layer without full recompute keeps no gathered parameter
    past its forward: the backward gathers again; under full recompute the
    recompute gathers and nothing is saved to gather again (the checked-in
    zero3 plan: ``tests/test_torch_hybrid_plans.py``)."""
    table, results, ranks = world
    for name in ("zero3", "hetero"):
        assert name in results, _world_failure(ranks)
        assert all(g["regathered"] > 0 for g in results[name]), name
    for name in ("pure_dp", "tp2", "ckpt"):
        assert all(g["regathered"] == 0 for g in results[name]), name


def test_dp_reduction_control_fails(world):
    """Without the DP gradient reduction each data-parallel rank steps on
    its own rows' gradient: the same check must fail."""
    table, results, ranks = world
    assert "control_pure_dp" in results, _world_failure(ranks)
    with pytest.raises(AssertionError):
        _check("control_pure_dp", table, results)


def test_every_rank_of_the_world_exited_cleanly(world):
    _, _, ranks = world
    assert all(r.returncode == 0 and not r.killed for r in ranks), _world_failure(ranks)


# ---------------------------------------------------------------------------
# refusals and the world-size-1 runtime (in process)
# ---------------------------------------------------------------------------


def _tcfg(**kw):
    from galvatron_tpu_torch.models.modeling import ModelConfig

    return ModelConfig(dtype=torch.float32, **dict(SHAPE, **kw))


#: fp16 itself runs (tests/test_torch_fp16.py); with fused_norm it is
#: ROADMAP §1.1's remainder. Expert parallelism (§1.9) runs on MoE models
#: (tests/test_torch_moe.py); its case holds the reference's refusal of ep on
#: a dense model. tp_overlap and grad_overlap (§1.6) run
#: (tests/test_torch_collective_matmul.py): their cases build and equal their
#: overlap-off runs.
UNPORTED = [("ep", dict(ep=2), "§1.9"),
            ("tp_overlap", dict(tp_overlap=True), "§1.6"),
            ("grad_overlap", dict(grad_overlap=True), "§1.6"),
            ("fp16", dict(mixed_precision="fp16"), "§1.1")]


@pytest.mark.parametrize("pp", [1, 2])
@pytest.mark.parametrize("what,change,item", UNPORTED)
def test_unported_plan_features_raise_naming_their_item(what, change, item, pp):
    """Refused at pp = 1 and under a pipeline alike (pipelines themselves
    run: ``tests/test_torch_pipeline.py``)."""
    from galvatron_tpu_torch.parallel import hybrid

    ts = _ts()
    layer = {k: v for k, v in change.items() if k in ("ep", "tp_overlap")}
    hp = ts.HybridParallelConfig(
        pp=pp, chunks=2, layer_strategies=[ts.LayerStrategy(**layer)] * 4,
        **{k: v for k, v in change.items() if k not in layer})
    cfg = _tcfg(fused_norm=True) if what == "fp16" else _tcfg()
    if what == "ep":
        with pytest.raises(ValueError, match=r"ep=2 but the model has 0 experts \(dense MLP\)"):
            hybrid.build_runtime(cfg, hp, global_batch_size=BATCH, seq_len=SEQ, device="cpu")
        return
    if what in ("tp_overlap", "grad_overlap"):
        from galvatron_tpu_torch.core.optim import tree_leaves

        # at world size 1 both fields are inert: the plan trains as its
        # overlap-off twin does, and a pipeline is refused alike (one rank)
        off = ts.HybridParallelConfig(pp=pp, chunks=2, layer_strategies=[ts.LayerStrategy()] * 4)
        runs = []
        for plan in (hp, off):
            plan.mixed_precision = "fp32"
            if pp > 1:
                with pytest.raises(ValueError) as e:
                    hybrid.build_runtime(cfg, plan, global_batch_size=BATCH, seq_len=SEQ,
                                         device="cpu")
                runs.append(str(e.value))
                continue
            rt = hybrid.build_runtime(cfg, plan, global_batch_size=BATCH, seq_len=SEQ,
                                      device="cpu")
            state = rt.init_state(0)
            batch = torch.from_numpy(_batches(BATCH, seed=5)[0])
            losses = [float(rt.train_step(state, batch)[1]) for _ in range(2)]
            runs.append((losses, [p.clone() for p in tree_leaves(state["params"])]))
        if pp > 1:
            assert runs[0] == runs[1] and "pp=2" in runs[0]
            return
        assert runs[0][0] == runs[1][0]
        for a, b in zip(runs[0][1], runs[1][1]):
            assert torch.equal(a, b)
        return
    with pytest.raises(NotImplementedError, match=item):
        hybrid.build_runtime(cfg, hp, global_batch_size=BATCH, seq_len=SEQ, device="cpu")


@pytest.mark.parametrize("pp", [1, 2])
@pytest.mark.parametrize("what", ["heads", "sequence"])
def test_cp_refusals(what, pp):
    """The plans the reference refuses, refused at build time from the
    shapes alone (before the world size is known): a tp-local head count
    that an a2a layer's cp does not divide, and a sequence that cp does not
    divide."""
    from galvatron_tpu_torch.parallel import hybrid

    ts = _ts()
    if what == "heads":  # 4 heads over tp 2: 2 per rank, split over cp 4
        layer, seq, match = ts.LayerStrategy(tp=2, cp=4, cp_impl="a2a"), SEQ, \
            r"tp-local head count 4/tp=2 divisible by cp=4"
    else:
        layer, seq, match = ts.LayerStrategy(cp=4), 30, "sequence 30 does not split over cp=4"
    hp = ts.HybridParallelConfig(pp=pp, chunks=2, layer_strategies=[layer] * 4)
    with pytest.raises(ValueError, match=match):
        hybrid.build_runtime(_tcfg(max_seq_len=seq), hp, global_batch_size=BATCH, seq_len=seq,
                             device="cpu")


def test_shapes_a_tp_degree_cannot_split_are_refused():
    from galvatron_tpu_torch.parallel import hybrid

    ts = _ts()
    with pytest.raises(ValueError, match="num_heads 4 does not split over tp=8"):
        hybrid.build_runtime(_tcfg(), ts.HybridParallelConfig.uniform(4, tp=8),
                             device="cpu", global_batch_size=BATCH, seq_len=SEQ)


def test_world_size_without_a_process_group_raises(monkeypatch):
    from galvatron_tpu_torch.parallel import hybrid

    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="no process group"):
        hybrid.build_runtime(_tcfg(), global_batch_size=BATCH, seq_len=SEQ, device="cpu")


def test_world_size_one_creates_no_group_and_issues_no_collective():
    import torch.distributed as dist

    from galvatron_tpu_torch.parallel import comm, hybrid

    comm.reset_counts()
    rt = hybrid.build_runtime(_tcfg(), global_batch_size=BATCH, seq_len=SEQ, device="cpu",
                              mixed_precision="fp32", chunks=2, ckpt="full")
    state = rt.init_state(0)
    state, loss = rt.train_step(state, torch.from_numpy(_batches(BATCH, 0)[0]))
    assert torch.isfinite(loss) and rt.world == 1
    assert comm.issued == 0 and comm.host_staged == 0
    assert not (dist.is_available() and dist.is_initialized())


def test_unreachable_master_raises_instead_of_running_alone(tmp_path):
    """A rank of a two-rank world whose master never answers fails within
    --dist_timeout_s; it never trains as a world of one."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]  # closed again: nothing listens there
    env = dict(os.environ, PYTHONPATH=str(ROOT), WORLD_SIZE="2", RANK="1", LOCAL_RANK="0",
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    r = subprocess.run([sys.executable, "-m", "galvatron_tpu_torch.cli", "train", "--device",
                        "cpu", "--num_layers", "1", "--hidden_size", "32", "--num_heads", "2",
                        "--vocab_size", "64", "--seq_length", "16", "--train_iters", "1",
                        "--dist_timeout_s", "3"], env=env, cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode != 0
    assert "iter 0" not in r.stdout


def test_launcher_ends_the_world_when_a_rank_fails():
    from galvatron_tpu_torch.parallel.launch import launch_local

    code = ("import os, sys, time\n"
            "sys.exit(3) if os.environ['RANK'] == '1' else time.sleep(120)\n")
    ranks = launch_local([sys.executable, "-c", code], 2, timeout_s=60)
    assert ranks[1].returncode == 3 and not ranks[1].killed
    assert ranks[0].killed


# ---------------------------------------------------------------------------
# cli train in a 4-rank world
# ---------------------------------------------------------------------------


def test_cli_train_four_ranks_writes_rank0_records_only(tmp_path):
    from galvatron_tpu_torch.parallel.launch import launch_local
    from galvatron_tpu_torch.utils.metrics import read_metrics

    ts = _ts()
    L = ts.LayerStrategy
    plan = ts.HybridParallelConfig(
        layer_strategies=[L(tp=2, sp=True), L(tp=1, dp_type="zero3", ckpt="full"),
                          L(tp=4, ckpt="selective"), L(tp=2, tp_consec=False, dp_type="zero2")],
        vocab_tp=2, mixed_precision="fp32")
    path = tmp_path / "plan.json"
    plan.save(str(path))
    metrics = tmp_path / "m.jsonl"
    cmd = [sys.executable, "-m", "galvatron_tpu_torch.cli", "train", "--device", "cpu",
           "--num_layers", "4", "--hidden_size", "64", "--num_heads", "4", "--ffn_dim", "128",
           "--vocab_size", "128", "--seq_length", "32", "--global_train_batch_size", "8",
           "--train_iters", "3", "--galvatron_config_path", str(path), "--check_loss", "1",
           "--metrics_path", str(metrics)]
    ranks = launch_local(cmd, 4, timeout_s=600, cwd=str(ROOT),
                         env=dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1"))
    assert all(r.returncode == 0 for r in ranks), _world_failure(ranks)
    recs = [r for r in read_metrics(str(metrics)) if r["event"] == "train_iter"]
    assert [r["step"] for r in recs] == [0, 1, 2]
    assert all(np.isfinite(r["loss"]) for r in recs)
    assert "iter 2: loss" in ranks[0].output and "world=4" in ranks[0].output
    assert all("iter 0" not in r.output for r in ranks[1:])


if __name__ == "__main__" and len(sys.argv) == 4 and sys.argv[1] == "worker":
    sys.path.insert(0, str(ROOT))
    _worker(sys.argv[2], sys.argv[3])
