"""Pipeline parallelism in the port against the JAX package: schedules,
refusals and stage division in process, and the pipelines themselves in a
gloo process world on the CPU.

One world of 8 ranks per module (``parallel/launch.py``, with a hard
deadline that fails instead of hanging) trains, in fp32 from the JAX
package's ``key(0)`` weights cut into each rank's pieces by
``bridge.shard_params``, every non-slow parity case of the JAX package's
pipeline tests: the GPipe cases of ``tests/test_pipeline.py``, the 1F1B
cases and the tied-embedding GPT case of ``tests/test_pipeline_1f1b.py``,
interleaved GPipe and interleaved 1F1B of
``tests/test_pipeline_interleaved.py`` and the uneven divisions of
``tests/test_pipeline_uneven.py``. The truth is what those tests hold the
JAX pipelines to: the flat single-device trajectory (``modeling.lm_loss`` +
``adamw_update``), compiled once per model shape. Each case's eval loss on
the first batch is held to the first reference loss at 2e-5, its 3-step
training losses at 5e-5, the gathered final parameters at 1e-4, and every
rank's piece must equal its cut of the gathered tree bit for bit (both
copies of a tied table included). One exception to 1e-4, with a cap: an
element whose first reference gradient is within fp32 rounding of zero
(below 1e-5 of its tensor's largest) takes a first AdamW step of up to ~lr
in either direction, whatever order the gradient sums ran in; such an
element is held to steps x lr, and the elements past 1e-4 must all be
such and fewer than 0.1 % of each tensor (one element of the embedding
table in the [3, 2] GPipe case: its first gradient reads 5e-8 or 1.2e-7 of
the table's largest, as the JAX step is jitted or not). A control with the tied-table gradient
sum taken out must fail the same check.

The port refuses the uneven shards that GSPMD pads, so every batch is 16
rows, which split over each case's data-parallel ranks (the JAX tests use 8).

Run as a script (``python tests/test_torch_pipeline.py worker CASES OUT``)
this file is one rank of the world; that path imports no JAX.
"""

import functools
import os
import pickle
import re
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
EVAL_TOL = 2e-5  # the JAX eval-loss parity tests' rtol / atol
LOSS_TOL = 5e-5  # their trajectory tests'
PARAM_ATOL = 1e-4  # test_torch_training.py's TRAJ_PARAM_ATOL
# an element whose first reference gradient is below this share of its
# tensor's largest is within fp32 rounding of zero (see _check); the
# elements past PARAM_ATOL must be such, and fewer than NOISE_SHARE of each
# tensor
ROUNDING_OF_ZERO = 1e-5
NOISE_SHARE = 1e-3
WORLD_TIMEOUT_S = 600
SHAPE = dict(vocab_size=128, hidden_size=64, num_layers=4, num_heads=4, ffn_dim=128,
             max_seq_len=SEQ)
GPT = dict(pos_embed="learned", norm_type="layernorm", act_fn="gelu", tie_word_embeddings=True)


def _ts():
    from galvatron_tpu_torch.core import strategy as ts

    return ts


def _cases(m):
    """name → (model shape, plan) built from module ``m`` (the JAX package's
    strategy module or the port's copy): the JAX tests' cases, in order."""
    U = m.HybridParallelConfig.uniform
    out = {}
    # tests/test_pipeline.py:55-76 (the trajectory test's plan is the first)
    for pp, chunks, tp, dp, ckpt in [(2, 2, 1, "ddp", False), (2, 4, 2, "ddp", False),
                                     (4, 4, 1, "zero3", True), (2, 2, 2, "zero2", False)]:
        out[f"gpipe_pp{pp}_c{chunks}_tp{tp}_{dp}{'_ckpt' if ckpt else ''}"] = (SHAPE, U(
            4, pp=pp, tp=tp, dp_type=dp, ckpt=ckpt, chunks=chunks, mixed_precision="fp32",
            vocab_tp=tp, pipeline_type="gpipe"))
    # tests/test_pipeline_1f1b.py:22-30 and the tied-embedding case at :69
    for pp, chunks, tp, dp, ckpt in [(2, 4, 1, "ddp", False), (2, 2, 2, "zero3", False),
                                     (4, 8, 1, "ddp", True), (4, 4, 2, "zero2", False)]:
        out[f"1f1b_pp{pp}_c{chunks}_tp{tp}_{dp}{'_ckpt' if ckpt else ''}"] = (SHAPE, U(
            4, pp=pp, tp=tp, dp_type=dp, ckpt=ckpt, chunks=chunks, mixed_precision="fp32",
            vocab_tp=tp, pipeline_type="pipedream_flush"))
    out["1f1b_tied_gpt"] = (dict(SHAPE, **GPT), U(
        4, pp=2, tp=1, chunks=4, mixed_precision="fp32", vocab_tp=1,
        pipeline_type="pipedream_flush"))
    # tests/test_pipeline_interleaved.py:46-53 (vpp=1 there is plain GPipe)
    for pp, vpp, chunks, tp, dp in [(2, 2, 2, 1, "ddp"), (2, 2, 4, 2, "zero3"),
                                    (4, 1, 4, 1, "ddp")]:
        out[f"igpipe_pp{pp}_vpp{vpp}_c{chunks}_tp{tp}_{dp}"] = (SHAPE, U(
            4, pp=pp, vpp=vpp, tp=tp, dp_type=dp, chunks=chunks, mixed_precision="fp32",
            vocab_tp=1))
    # :150-157, interleaved 1F1B at pp·vpp·2 layers
    for pp, vpp, chunks, tp, dp, ckpt in [(2, 2, 4, 1, "ddp", False),
                                          (2, 2, 2, 2, "zero3", True),
                                          (4, 2, 4, 1, "zero2", False)]:
        L = pp * vpp * 2
        hp = U(L, pp=pp, tp=tp, dp_type=dp, ckpt=ckpt, chunks=chunks, vocab_tp=tp,
               mixed_precision="fp32", pipeline_type="pipedream_flush")
        hp.vpp = vpp
        out[f"i1f1b_pp{pp}_vpp{vpp}_c{chunks}_tp{tp}_{dp}{'_ckpt' if ckpt else ''}"] = (
            dict(SHAPE, num_layers=L), hp)
    # tests/test_pipeline_uneven.py:44-52, and the 1F1B trajectory at :67
    for ptype, division in [("gpipe", [2, 3]), ("gpipe", [3, 2]),
                            ("pipedream_flush", [2, 3]), ("pipedream_flush", [3, 2])]:
        hp = U(5, pp=2, tp=2, chunks=2, vocab_tp=2, mixed_precision="fp32",
               pipeline_type=ptype)
        hp.pp_division = division
        out[f"uneven_{ptype}_{division[0]}{division[1]}"] = (dict(SHAPE, num_layers=5), hp)
    hp = U(5, pp=2, tp=1, chunks=2, vocab_tp=1, mixed_precision="fp32",
           pipeline_type="pipedream_flush")
    hp.pp_division = [3, 2]
    out["uneven_pipedream_flush_32_tp1"] = (dict(SHAPE, num_layers=5), hp)
    return out


CONTROL = "control_1f1b_tied_gpt"  # the tied case with the tied gradient sum taken out


def _case_names():
    return list(_cases(_ts()))


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
    real_sum = hybrid._sum_tied
    try:
        for case in cases:
            cfg = ModelConfig(dtype=torch.float32, **case["shape"])
            hp = HybridParallelConfig.from_json_dict(case["plan"])
            hybrid._sum_tied = (lambda g, group: g) if case["control"] else real_sum
            rt = hybrid.build_runtime(cfg, hp, AdamConfig(lr=LR, grad_clip=1.0),
                                      global_batch_size=BATCH, seq_len=SEQ, device="cpu")
            local = bridge.shard_params(case["params"], cfg, hp, rank, world)
            state = rt.state_from(hybrid.zip_map(
                lambda a, n: torch.from_numpy(np.array(a, copy=True)), local))
            comm.reset_counts()
            eval_loss = float(rt.eval_loss(state, torch.from_numpy(case["batches"][0])))
            losses, in_flight = [], []
            for b in case["batches"]:
                state, loss = rt.train_step(state, torch.from_numpy(b))
                losses.append(float(loss))
                in_flight.append(rt.stats["in_flight"])
            with open(os.path.join(out_dir, f"{case['name']}.{rank}.pkl"), "wb") as f:
                pickle.dump({"eval": eval_loss, "losses": losses, "stage": rt.stage,
                             "in_flight": in_flight, "p2p": comm.p2p,
                             "params": bridge.params_to_numpy(state["params"])}, f)
    finally:
        hybrid._sum_tied = real_sum
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the JAX side and the world (pytest)
# ---------------------------------------------------------------------------


def _jax_cfg(shape):
    import jax.numpy as jnp

    from galvatron_tpu.models import modeling as jm

    return jm.ModelConfig(dtype=jnp.float32, **shape)


def _jax_params(shape):
    return _jax_params_of(tuple(sorted(shape.items())))


@functools.lru_cache(maxsize=None)
def _jax_params_of(shape_key):
    import jax

    from galvatron_tpu.models import modeling as jm

    cfg = _jax_cfg(dict(shape_key))
    return jax.tree.map(np.asarray, jm.init_model_params(jax.random.key(0), cfg))


@functools.lru_cache(maxsize=None)
def _jax_step(shape_key):
    """The flat single-device step of one model shape, compiled once."""
    import jax

    from galvatron_tpu.core.optim import AdamConfig, adamw_update
    from galvatron_tpu.models import modeling as jm

    cfg = _jax_cfg(dict(shape_key))
    adam = AdamConfig(lr=LR, grad_clip=1.0)

    def step(params, opt, batch):
        loss, grads = jax.value_and_grad(lambda p: jm.lm_loss(p, batch, cfg))(params)
        params, opt = adamw_update(params, grads, opt, adam)
        return params, opt, loss, grads

    return jax.jit(step)


def _jax_reference(shape, batches):
    """(losses, final params, first gradients) of the flat single-device
    trajectory."""
    import jax
    import jax.numpy as jnp

    from galvatron_tpu.core.optim import init_opt_state

    step = _jax_step(tuple(sorted(shape.items())))
    params = jax.tree.map(jnp.asarray, _jax_params(shape))
    opt = init_opt_state(params)
    losses, first = [], None
    for b in batches:
        params, opt, loss, grads = step(params, opt, jnp.asarray(b))
        losses.append(float(loss))
        first = jax.tree.map(np.asarray, grads) if first is None else first
    return losses, jax.tree.map(np.asarray, params), first


def _batches(seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, SHAPE["vocab_size"], (BATCH, SEQ + 1)).astype(np.int32)
            for _ in range(STEPS)]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Run every case (and the control) in one 8-rank gloo world while the
    JAX references are computed here; returns the case table (with each
    case's reference), each case's per-rank results (missing when a rank
    failed) and the launcher's per-rank results."""
    from galvatron_tpu_torch.parallel.launch import launch_local

    d = tmp_path_factory.mktemp("torch_pipeline_world")
    cases, table = [], {}
    for i, (name, (shape, thp)) in enumerate(_cases(_ts()).items()):
        batches = _batches(seed=i)
        table[name] = (shape, thp, batches)
        cases.append(dict(name=name, shape=shape, plan=thp.to_json_dict(), batches=batches,
                          params=_jax_params(shape), control=False))
    tied = dict(cases[[c["name"] for c in cases].index("1f1b_tied_gpt")], name=CONTROL,
                control=True)
    cases.append(tied)
    table[CONTROL] = table["1f1b_tied_gpt"]
    case_path = d / "cases.pkl"
    with open(case_path, "wb") as f:
        pickle.dump(cases, f)
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    out = {}
    run = threading.Thread(target=lambda: out.setdefault("ranks", launch_local(
        [sys.executable, str(Path(__file__).resolve()), "worker", str(case_path), str(d)],
        WORLD, timeout_s=WORLD_TIMEOUT_S, env=env, cwd=str(ROOT))))
    run.start()  # the JAX references are computed while the world trains
    refs = {name: _jax_reference(shape, batches)
            for name, (shape, thp, batches) in table.items() if name != CONTROL}
    run.join()
    refs[CONTROL] = refs["1f1b_tied_gpt"]
    table = {name: row + (refs[name],) for name, row in table.items()}
    results = {}
    for c in cases:
        files = [d / f"{c['name']}.{r}.pkl" for r in range(WORLD)]
        if all(f.exists() for f in files):
            results[c["name"]] = [pickle.load(open(f, "rb")) for f in files]
    return table, results, out["ranks"]


def _world_failure(ranks):
    bad = [r for r in ranks if r.returncode != 0]
    return "\n".join(f"rank {r.rank} rc={r.returncode} killed={r.killed}:\n{r.output[-3000:]}"
                     for r in bad)


def _check(name, table, results):
    """Raise AssertionError unless the case's eval and training losses, its
    gathered parameters and every rank's pieces hold against the JAX
    trajectory."""
    from galvatron_tpu_torch import bridge
    from galvatron_tpu_torch.core.optim import tree_leaves
    from galvatron_tpu_torch.models.modeling import ModelConfig

    shape, thp, batches, (jlosses, jparams, jgrads) = table[name]
    got = results[name]
    losses = got[0]["losses"]
    assert all(g["losses"] == losses and g["eval"] == got[0]["eval"] for g in got), \
        "ranks report different losses"
    np.testing.assert_allclose(got[0]["eval"], jlosses[0], rtol=EVAL_TOL, atol=EVAL_TOL)
    np.testing.assert_allclose(losses, jlosses, rtol=LOSS_TOL, atol=LOSS_TOL)
    cfg = ModelConfig(dtype=torch.float32, **shape)
    pieces = [g["params"] for g in got]
    full = bridge.gather_params(pieces, cfg, thp, WORLD)
    for r in range(WORLD):  # no replica, and no copy of a tied table, drifted
        want = bridge.shard_params(full, cfg, thp, r, WORLD)
        for w, p in zip(tree_leaves(want), tree_leaves(pieces[r])):
            np.testing.assert_array_equal(w, p, err_msg=f"rank {r}")
    import jax

    flat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    assert len(flat) == len(tree_leaves(full))
    for t, (path, j), g in zip(tree_leaves(full), flat, jax.tree.leaves(jgrads)):
        key = jax.tree_util.keystr(path)
        # AdamW's first step is lr·g/(|g| + eps): an element whose first
        # gradient is within fp32 rounding of zero moves by up to ~lr in
        # either package, whatever order the sums ran in
        noise = np.abs(g) <= ROUNDING_OF_ZERO * np.abs(g).max()
        np.testing.assert_allclose(t[~noise], j[~noise], atol=PARAM_ATOL, rtol=0, err_msg=key)
        np.testing.assert_allclose(t[noise], j[noise], atol=STEPS * LR, rtol=0, err_msg=key)
        assert np.mean(np.abs(t - j) > PARAM_ATOL) < NOISE_SHARE, key


@pytest.mark.parametrize("name", _case_names())
def test_pipeline_trains_like_the_jax_package(world, name):
    table, results, ranks = world
    assert name in results, _world_failure(ranks)
    _check(name, table, results)


def test_tied_gradient_sum_control_fails(world):
    """Without the sum of the tied table's two gradients, stage 0's copy
    learns only from the embedding and the last stage's only from the
    head: the same check must fail."""
    table, results, ranks = world
    assert CONTROL in results, _world_failure(ranks)
    with pytest.raises(AssertionError):
        _check(CONTROL, table, results)


def test_stages_hold_the_schedules_in_flight_bound(world):
    """Each rank held at most what its schedule allows in flight: 1F1B
    ``min(chunks, 2(pp-1-s)+1)`` on stage s, GPipe every micro-batch."""
    table, results, ranks = world
    for name in ("1f1b_pp2_c4_tp1_ddp", "1f1b_pp4_c8_tp1_ddp_ckpt", "gpipe_pp2_c4_tp2_ddp"):
        assert name in results, _world_failure(ranks)
        thp = table[name][1]
        for g in results[name]:
            s = g["stage"]
            want = (min(thp.chunks, 2 * (thp.pp - 1 - s) + 1)
                    if thp.pipeline_type == "pipedream_flush" else thp.chunks)
            assert g["in_flight"] == [want] * STEPS, (name, s, g["in_flight"])
            assert g["p2p"] > 0


def test_every_rank_of_the_world_exited_cleanly(world):
    _, _, ranks = world
    assert all(r.returncode == 0 and not r.killed for r in ranks), _world_failure(ranks)


# ---------------------------------------------------------------------------
# schedules, held to the JAX clock formulas (in process)
# ---------------------------------------------------------------------------


def _cells(sched):
    return sorted((d, a.tick, a.kind, a.vstage, a.mb)
                  for d, acts in enumerate(sched.actions) for a in acts)


@pytest.mark.parametrize("pp,chunks", [(1, 4), (2, 2), (2, 8), (3, 5), (4, 4), (4, 16)])
def test_gpipe_and_1f1b_action_lists_are_the_jax_clocks(pp, chunks):
    from galvatron_tpu.parallel.pipeline import gpipe_schedule_ticks as j_gpipe
    from galvatron_tpu.parallel.pipeline_1f1b import pipedream_schedule_ticks as j_1f1b
    from galvatron_tpu_torch.parallel import pipeline, pipeline_1f1b

    assert pipeline_1f1b.pipedream_schedule_ticks(pp, chunks) == j_1f1b(pp, chunks)
    for j_ticks, sched in [(j_gpipe, pipeline.gpipe_schedule(pp, chunks)),
                           (j_1f1b, pipeline_1f1b.pipedream_schedule(pp, chunks))]:
        jt, jT = j_ticks(pp, chunks)
        assert sched.ticks == jT
        assert _cells(sched) == sorted((c["stage"], c["tick"], c["kind"], c["stage"], c["mb"])
                                       for c in jt)


def _jax_interleaved_clock(pp, vpp, chunks, one_f_one_b):
    """``pipeline_interleaved.py``'s clock arithmetic, evaluated tick by
    tick as its scans do (forward ``:13-20``, the 1F1B backward wave
    ``:245-256``)."""
    def decompose(n):
        nc = max(n, 0)
        return nc % pp, (nc // pp) % vpp, (nc // pp) // vpp

    cells = []
    T = vpp * chunks + vpp * pp + pp - 1 if one_f_one_b else vpp * chunks + pp
    for s in range(pp):
        for t in range(T):
            n = t - s
            r, j, g = decompose(n)
            if 0 <= n < vpp * chunks:
                cells.append((s, t, "fwd", s + j * pp, g * pp + r))
            if one_f_one_b:
                nb = t - vpp * pp - (pp - 1 - s)
                r, jj, g = decompose(nb)
                if 0 <= nb < vpp * chunks:
                    cells.append((s, t, "bwd", s + (vpp - 1 - jj) * pp, g * pp + r))
    return sorted(cells)


@pytest.mark.parametrize("pp,vpp,chunks", [(2, 2, 2), (2, 2, 8), (2, 3, 4), (4, 2, 4),
                                           (4, 2, 16), (3, 2, 6)])
def test_interleaved_action_lists_are_the_jax_clock(pp, vpp, chunks):
    from galvatron_tpu_torch.parallel.pipeline_interleaved import (
        interleaved_1f1b_schedule,
        interleaved_schedule,
    )

    sched = interleaved_1f1b_schedule(pp, vpp, chunks)
    assert _cells(sched) == _jax_interleaved_clock(pp, vpp, chunks, True)
    fwd = [c for c in _cells(interleaved_schedule(pp, vpp, chunks)) if c[2] == "fwd"]
    assert fwd == _jax_interleaved_clock(pp, vpp, chunks, False)
    # the GPipe-ordered backward is the mirror of the forward clock
    gp = interleaved_schedule(pp, vpp, chunks)
    when = {(c[2], c[3], c[4]): c[1] for c in _cells(gp)}
    t_fwd = 1 + max(c[1] for c in fwd)
    assert all(when[("bwd", v, m)] == 2 * t_fwd - 1 - when[("fwd", v, m)]
               for _, _, k, v, m in _cells(gp) if k == "fwd")


def test_every_message_is_consumed_one_tick_after_it_is_sent():
    """``Schedule.check`` holds every generator to it (a rank only waits for
    a sender that acts a tick earlier), and refuses a schedule that breaks
    it."""
    from dataclasses import replace

    from galvatron_tpu_torch.parallel import pipeline
    from galvatron_tpu_torch.parallel.pipeline_1f1b import pipedream_schedule

    sched = pipedream_schedule(3, 4)
    for d, acts in enumerate(sched.actions):
        for a in acts:
            if a.kind == "fwd" and a.vstage > 0:
                src = [b for b in sched.actions[d - 1] if (b.kind, b.mb) == ("fwd", a.mb)]
                assert [b.tick for b in src] == [a.tick - 1]
            if a.kind == "bwd" and a.vstage < 2:
                src = [b for b in sched.actions[d + 1] if (b.kind, b.mb) == ("bwd", a.mb)]
                assert [b.tick for b in src] == [a.tick - 1]
    late = [[replace(a, tick=a.tick + 1) if (d, a.kind, a.mb) == (1, "fwd", 2) else a
             for a in acts] for d, acts in enumerate(sched.actions)]
    with pytest.raises(ValueError, match="produced at tick"):
        pipeline.Schedule(3, 1, 4, sched.ticks + 1, late).check()


@pytest.mark.parametrize("chunks", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("pp", [2, 3, 4])
def test_1f1b_in_flight_bound_does_not_grow_with_chunks(pp, chunks):
    from galvatron_tpu_torch.parallel import pipeline
    from galvatron_tpu_torch.parallel.pipeline_1f1b import pipedream_schedule

    sched = pipedream_schedule(pp, chunks)
    assert [sched.in_flight(s) for s in range(pp)] == [
        min(chunks, 2 * (pp - 1 - s) + 1) for s in range(pp)]
    assert [pipeline.gpipe_schedule(pp, chunks).in_flight(s) for s in range(pp)] == [chunks] * pp


# ---------------------------------------------------------------------------
# refusals mirrored from the JAX package, stage division (in process)
# ---------------------------------------------------------------------------


def _message(fn, *args):
    try:
        fn(*args)
    except ValueError as e:
        return str(e)
    raise AssertionError(f"{fn} accepted {args}")


def _refused(m):
    """Plans both packages must refuse (module ``m``'s strategy classes)."""
    U, L = m.HybridParallelConfig.uniform, m.LayerStrategy
    bad_div = U(5, pp=2, chunks=2, mixed_precision="fp32")
    bad_div.pp_division = [1, 3]
    hetero = m.HybridParallelConfig(pp=2, layer_strategies=[L(tp=1), L(tp=2), L(tp=2), L(tp=2)],
                                    chunks=2, mixed_precision="fp32")
    uneven_hetero = m.HybridParallelConfig(
        pp=2, layer_strategies=[L(tp=1), L(tp=2), L(tp=2), L(tp=1), L(tp=2)], chunks=2,
        mixed_precision="fp32", pp_division=[2, 3])
    inter = m.HybridParallelConfig(pp=2, vpp=2, chunks=2, layer_strategies=[
        L(tp=1), L(tp=2), L(tp=1), L(tp=1)])
    return {"division": (5, bad_div), "cross_stage": (4, hetero),
            "uneven_cross_stage": (5, uneven_hetero), "interleaved": (4, inter)}


@pytest.mark.parametrize("what", ["division", "cross_stage", "uneven_cross_stage",
                                  "interleaved"])
def test_refusals_carry_the_jax_messages(what):
    import jax.numpy as jnp

    from galvatron_tpu.core import strategy as js
    from galvatron_tpu.models.modeling import ModelConfig as JCfg
    from galvatron_tpu.parallel import pipeline as jp
    from galvatron_tpu.parallel import pipeline_interleaved as jpi
    from galvatron_tpu_torch.parallel import pipeline as tp_
    from galvatron_tpu_torch.parallel import pipeline_interleaved as tpi

    L, jhp = _refused(js)[what]
    _, thp = _refused(_ts())[what]
    jcfg = JCfg(dtype=jnp.float32, **dict(SHAPE, num_layers=L))
    if what == "interleaved":
        want = _message(jpi.validate_interleaved_strategies, jcfg, jhp)
        got = _message(tpi.validate_interleaved_strategies, L, thp)
    else:
        want = _message(jp.validate_pipeline_strategies, jcfg, jhp)
        got = _message(tp_.validate_pipeline_strategies, L, thp)
    assert got == want


@pytest.mark.parametrize("what", ["division", "cross_stage", "uneven_cross_stage",
                                  "interleaved"])
def test_build_runtime_refuses_what_the_jax_runtime_refuses(what, monkeypatch):
    """The runtime of a rank in a world of 8 refuses these plans with the
    JAX ``build_runtime``'s message, before it makes any process group."""
    import jax.numpy as jnp

    from galvatron_tpu.core import strategy as js
    from galvatron_tpu.models.modeling import ModelConfig as JCfg
    from galvatron_tpu.parallel.hybrid import build_runtime as jbuild
    from galvatron_tpu_torch.models.modeling import ModelConfig
    from galvatron_tpu_torch.parallel import hybrid

    L, jhp = _refused(js)[what]
    _, thp = _refused(_ts())[what]
    jcfg = JCfg(dtype=jnp.float32, **dict(SHAPE, num_layers=L))
    want = _message(lambda: jbuild(jcfg, jhp, global_batch_size=8, seq_len=SEQ))
    monkeypatch.setattr(hybrid, "_world", lambda: (WORLD, 0))
    cfg = ModelConfig(dtype=torch.float32, **dict(SHAPE, num_layers=L))
    got = _message(lambda: hybrid.build_runtime(cfg, thp, global_batch_size=8, seq_len=SEQ,
                                                device="cpu"))
    assert got == want


def test_pp_above_one_in_a_world_of_one_raises():
    """A pipeline plan never runs as pp = 1: without the ranks it names,
    the world-size error."""
    from galvatron_tpu_torch.models.modeling import ModelConfig
    from galvatron_tpu_torch.parallel import hybrid

    cfg = ModelConfig(dtype=torch.float32, **SHAPE)
    hp = _ts().HybridParallelConfig.uniform(4, pp=2, chunks=2, mixed_precision="fp32")
    with pytest.raises(ValueError, match=r"pp=2 must divide world size 1"):
        hybrid.build_runtime(cfg, hp, global_batch_size=8, seq_len=SEQ, device="cpu")


@pytest.mark.parametrize("profile,pp,other", [
    ([10] * 4 + [40] * 4, 2, None), ([1.0] * 26, 4, None), ([1.0] * 8, 2, [4.0, 0.0]),
    ([1.0] * 7, 1, None), ([5, 1, 1, 1, 1, 9, 2, 3, 3, 8], 3, [2.0, 0.0, 6.0]),
    (list(np.linspace(1, 3, 48)), 2, [12.0, 20.0]), ([3.0, 1.0, 1.0, 1.0, 1.0], 2, None)])
def test_pp_division_memory_balanced_is_the_jax_function(profile, pp, other):
    from galvatron_tpu.search.pp_division import pp_division_memory_balanced as jdiv
    from galvatron_tpu_torch.search.pp_division import pp_division_memory_balanced as tdiv

    assert tdiv(profile, pp, other) == jdiv(profile, pp, other)


def test_pp_division_refuses_what_the_jax_function_refuses():
    from galvatron_tpu.search.pp_division import pp_division_memory_balanced as jdiv
    from galvatron_tpu_torch.search.pp_division import pp_division_memory_balanced as tdiv

    for args in [([1.0] * 3, 4), ([1.0] * 4, 2, [1.0])]:
        with pytest.raises(ValueError) as want:
            jdiv(*args)
        with pytest.raises(ValueError, match=re.escape(str(want.value))):
            tdiv(*args)


@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("plan", ["gpipe_pp4_c4_tp1_zero3_ckpt", "uneven_gpipe_32",
                                  "i1f1b_pp2_vpp2_c2_tp2_zero3_ckpt"])
def test_stage_pieces_cut_and_gather_back_to_the_tree(plan, tied):
    """``bridge.shard_params`` gives each rank its stage's part (the
    embedding on stage 0, the head on the last, a tied table on both) and
    ``gather_params`` puts the world's pieces back together exactly."""
    from galvatron_tpu_torch import bridge
    from galvatron_tpu_torch.core.optim import tree_leaves
    from galvatron_tpu_torch.models import modeling as tm

    shape, hp = _cases(_ts())[plan]
    cfg = tm.ModelConfig(dtype=torch.float32, **dict(shape, **(GPT if tied else {})))
    full = bridge.params_to_numpy(tm.init_model_params(cfg, 0, "cpu"))
    pieces = [bridge.shard_params(full, cfg, hp, r, WORLD) for r in range(WORLD)]
    back = bridge.gather_params(pieces, cfg, hp, WORLD)
    for a, b in zip(tree_leaves(full), tree_leaves(back)):
        np.testing.assert_array_equal(a, b)
    per = WORLD // hp.pp
    assert "embed" in pieces[0] and "head" not in pieces[0] and "final_norm" not in pieces[0]
    assert "final_norm" in pieces[-1] and ("embed" in pieces[-1]) == tied
    if tied:
        assert sorted(pieces[-1]["embed"]) == ["tok"]
    if hp.pp > 2:
        assert sorted(pieces[per]) == ["layers"]


def test_step_stats_take_every_layer_of_the_model():
    """Under a pipeline a rank runs only its stage's layers, but the
    per-device rate divides the whole model's FLOPs by the world: a list of
    one stage's recompute modes is refused."""
    from galvatron_tpu_torch.models.modeling import ModelConfig
    from galvatron_tpu_torch.obs.stepstats import StepStats

    cfg = ModelConfig(dtype=torch.float32, **SHAPE)
    whole = StepStats(cfg, BATCH, SEQ, "cpu", ckpt=["full", "none", "none", "none"], world=8)
    assert whole.hardware_flops_per_step > whole.model_flops_per_step
    with pytest.raises(ValueError, match="2 recompute modes for 4 layers"):
        StepStats(cfg, BATCH, SEQ, "cpu", ckpt=["full", "none"], world=8)


# ---------------------------------------------------------------------------
# cli train under the launcher, and a lost message
# ---------------------------------------------------------------------------

CLI = ["--device", "cpu", "--num_layers", "4", "--hidden_size", "64", "--num_heads", "4",
       "--ffn_dim", "128", "--vocab_size", "128", "--seq_length", "32",
       "--global_train_batch_size", "8", "--train_iters", "3", "--mixed_precision", "fp32",
       "--chunks", "4", "--check_loss", "1"]


def _cli_world(tmp_path, extra, name):
    from galvatron_tpu_torch.parallel.launch import launch_local
    from galvatron_tpu_torch.utils.metrics import read_metrics

    metrics = tmp_path / f"{name}.jsonl"
    cmd = [sys.executable, "-m", "galvatron_tpu_torch.cli", "train", *CLI, *extra,
           "--metrics_path", str(metrics)]
    ranks = launch_local(cmd, 2, timeout_s=300, cwd=str(ROOT),
                         env=dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1"))
    assert all(r.returncode == 0 for r in ranks), _world_failure(ranks)
    assert all("iter 0" not in r.output for r in ranks[1:])
    return [r["loss"] for r in read_metrics(str(metrics)) if r["event"] == "train_iter"], ranks


LOST = """
import sys
from galvatron_tpu_torch.core import trainer
from galvatron_tpu_torch.core.arguments import initialize_galvatron
from galvatron_tpu_torch.parallel import comm
import os
real = comm.exchange
if os.environ["RANK"] == "0":  # stage 0 loses every message it sends
    comm.exchange = lambda sends, recvs: real([], recvs)
trainer.train(initialize_galvatron("train", sys.argv[1:]))
"""


if __name__ == "__main__" and len(sys.argv) == 4 and sys.argv[1] == "worker":
    sys.path.insert(0, str(ROOT))
    _worker(sys.argv[2], sys.argv[3])
