"""fp16 with dynamic loss scaling, the port against the JAX package on the
CPU: 5-step trajectories (loss, scale, clean-step count, skipped steps) at
pp = 1 (with and without micro-batch accumulation), under 2-stage GPipe
and 1F1B and with ZeRO-2 in gloo worlds, all against the JAX ``build_runtime``'s flat fp16
trajectory from the same weights; a forced overflow leaves every parameter
and optimizer leaf bitwise as it was and halves the scale; and the blocked
flash plain versions at fp16 against the Pallas kernels in interpret mode."""

import json
import os
import pickle
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from galvatron_tpu.core import checkpoint as jck
from galvatron_tpu.core import optim as jopt
from galvatron_tpu.core.strategy import HybridParallelConfig as JHP
from galvatron_tpu.models import modeling as jm
from galvatron_tpu.ops import flash_attention as jfa
from galvatron_tpu.parallel import hybrid as jhybrid
from galvatron_tpu.parallel.mesh import build_mesh
from galvatron_tpu_torch import bridge
from galvatron_tpu_torch.core import optim as topt
from galvatron_tpu_torch.core.optim import tree_leaves
from galvatron_tpu_torch.models import modeling as tm
from galvatron_tpu_torch.ops import flash_attention as tfa
from galvatron_tpu_torch.parallel import hybrid as thybrid
import _torch_threads  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
SHAPE = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4, ffn_dim=128,
             max_seq_len=32)
ADAM = dict(lr=1e-3, grad_clip=1.0)
STEPS = 5
#: fp16 compute rounds every activation to 11 bits in both packages, in
#: different orders: losses are held to 5e-3 relative, the scaler bitwise
LOSS_RTOL = 5e-3


def _cfgs():
    return (jm.ModelConfig(dtype=jnp.float32, attn_impl="xla", **SHAPE),
            tm.ModelConfig(dtype=torch.float32, attn_impl="xla", **SHAPE))


def _batches(n=STEPS, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 128, (8, 33)).astype(np.int32) for _ in range(n)]


def _jax_flat(state):
    return {jax.tree_util.keystr(kp): np.asarray(v)
            for kp, v in jax.tree_util.tree_flatten_with_path(state)[0]}


def _jax_trajectory(chunks=1, scale=None):
    """(initial flat state, per-step records) of the JAX pp = 1 fp16 runtime."""
    jcfg, _ = _cfgs()
    hp = JHP.uniform(2, mixed_precision="fp16", chunks=chunks)
    mesh, axes = build_mesh(pp=1, devices=jax.devices()[:1])
    rt = jhybrid.build_runtime(jcfg, hp, mesh=mesh, axes=axes, adam=jopt.AdamConfig(**ADAM),
                               global_batch_size=8, seq_len=32)
    state = rt.init_state(jax.random.key(0))
    if scale is not None:
        state["scaler"]["scale"] = jax.device_put(jnp.asarray(scale, jnp.float32),
                                                  rt.state_shardings["scaler"]["scale"])
    start = _jax_flat(jck.portable_flat_state(state, rt))
    recs = []
    for b in _batches():
        count = int(state["opt"]["count"])
        state, loss = rt.train_step(state, jnp.asarray(b))
        recs.append(_rec(float(loss), state["scaler"], count == int(state["opt"]["count"])))
    return start, recs


def _rec(loss, scaler, skipped):
    return {"loss": loss, "scale": float(scaler["scale"]),
            "good_steps": int(scaler["good_steps"]), "skipped": bool(skipped)}


def _torch_trajectory(rt, start):
    state = bridge.state_from_jax(start, rt)
    recs = []
    for b in _batches():
        state, loss = rt.train_step(state, torch.from_numpy(b))
        recs.append(_rec(float(loss), state["scaler"], not rt.stats["updated"]))
    return recs


def _assert_same_trajectory(got, want):
    np.testing.assert_allclose([r["loss"] for r in got], [r["loss"] for r in want],
                               rtol=LOSS_RTOL)
    for key in ("scale", "good_steps", "skipped"):
        assert [r[key] for r in got] == [r[key] for r in want], key


@pytest.mark.parametrize("chunks", [1, 2])
def test_fp16_trajectory_matches_jax_at_pp1(chunks):
    start, want = _jax_trajectory(chunks)
    _, tcfg = _cfgs()
    rt = thybrid.build_runtime(tcfg, adam=topt.AdamConfig(**ADAM), global_batch_size=8,
                               seq_len=32, mixed_precision="fp16", chunks=chunks, device="cpu")
    assert rt.cfg.dtype == torch.float16
    got = _torch_trajectory(rt, start)
    _assert_same_trajectory(got, want)
    assert [r["good_steps"] for r in got] == list(range(1, STEPS + 1))


def test_fp16_overflow_skips_the_update_atomically_and_backs_off():
    """An absurd scale overflows fp16: every parameter and moment stays
    bitwise as it was, ``count`` too, ``step`` advances, the scale halves
    and the clean-step count restarts; the JAX package does the same."""
    _, tcfg = _cfgs()
    rt = thybrid.build_runtime(tcfg, adam=topt.AdamConfig(**ADAM), global_batch_size=8,
                               seq_len=32, mixed_precision="fp16", device="cpu")
    state = rt.init_state(0)
    b = torch.from_numpy(_batches(2)[0])
    state, _ = rt.train_step(state, b)  # nonzero moments, count 1
    before = [t.clone() for t in tree_leaves({"p": state["params"], "m": state["opt"]["mu"],
                                              "v": state["opt"]["nu"]})]
    state["scaler"]["scale"] = torch.tensor(2.0 ** 120)
    state, loss = rt.train_step(state, b)
    after = tree_leaves({"p": state["params"], "m": state["opt"]["mu"], "v": state["opt"]["nu"]})
    assert all(torch.equal(x, y) for x, y in zip(before, after))
    assert state["opt"]["count"] == 1 and state["step"] == 2 and not rt.stats["updated"]
    assert float(state["scaler"]["scale"]) == 2.0 ** 119
    assert int(state["scaler"]["good_steps"]) == 0
    assert torch.isfinite(loss)  # the loss itself is exact, only the gradients overflowed
    start, want = _jax_trajectory(scale=2.0 ** 120)
    got = _torch_trajectory(rt, start)
    _assert_same_trajectory(got, want)
    assert all(r["skipped"] for r in got)


def test_scaler_matches_the_jax_scaler_update():
    from galvatron_tpu.core import schedules as js
    from galvatron_tpu_torch.core import schedules as ts

    jc = js.LossScalerConfig(initial_scale=16.0, growth_interval=2, min_scale=2.0)
    tc = ts.LossScalerConfig(initial_scale=16.0, growth_interval=2, min_scale=2.0)
    jst, tst = js.init_scaler_state(jc), ts.init_scaler_state(tc)
    for finite in (True, True, False, True, False, False, False, False, True, True, True):
        jst = js.scaler_update(jst, jnp.asarray(finite), jc)
        tst = ts.scaler_update(tst, finite, tc)
        assert float(tst["scale"]) == float(jst["scale"])
        assert int(tst["good_steps"]) == int(jst["good_steps"])
        assert tst["scale"].dtype == torch.float32 and tst["good_steps"].dtype == torch.int32


# ---------------------------------------------------------------------------
# Pipelines in gloo worlds
# ---------------------------------------------------------------------------


#: the two-rank plans: both 2-stage schedules, and ZeRO-2 over two data ranks
PLANS = {"gpipe": dict(pp=2, chunks=2, pipeline_type="gpipe"),
         "pipedream_flush": dict(pp=2, chunks=2, pipeline_type="pipedream_flush"),
         "zero2_dp2": dict(dp_type="zero2", chunks=2)}


def _worker(case_path: str, out_dir: str) -> None:
    import torch.distributed as dist

    from galvatron_tpu_torch.core.strategy import HybridParallelConfig
    from galvatron_tpu_torch.core.trainer import init_distributed

    torch.set_num_threads(1)
    init_distributed(torch.device("cpu"), "gloo", timeout_s=300)
    rank = dist.get_rank()
    with open(case_path, "rb") as f:
        case = pickle.load(f)
    _, tcfg = _cfgs()
    out = {}
    try:
        for name, kw in PLANS.items():
            hp = HybridParallelConfig.uniform(2, mixed_precision="fp16", **kw)
            rt = thybrid.build_runtime(tcfg, hp, topt.AdamConfig(**ADAM), global_batch_size=8,
                                       seq_len=32, device="cpu")
            out[name] = _torch_trajectory(rt, case["start"])
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def test_fp16_pipelines_follow_the_jax_flat_trajectory(tmp_path):
    """Two stages under GPipe and 1F1B, and ZeRO-2 over two data ranks:
    every rank's losses and scaler as the JAX package's flat fp16 runtime
    gives them (one finiteness verdict over the world: the scaler is the
    same on every rank)."""
    from galvatron_tpu_torch.parallel.launch import launch_local

    start, want = _jax_trajectory()
    case_path = tmp_path / "case.pkl"
    with open(case_path, "wb") as f:
        pickle.dump({"start": start}, f)
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    ranks = launch_local([sys.executable, str(Path(__file__).resolve()), "worker",
                          str(case_path), str(tmp_path)], 2, timeout_s=600, env=env,
                         cwd=str(ROOT))
    assert all(r.returncode == 0 for r in ranks), "\n".join(r.output[-3000:] for r in ranks)
    for r in range(2):
        got = json.loads((tmp_path / f"rank{r}.json").read_text())
        for name in PLANS:
            _assert_same_trajectory(got[name], want)


# ---------------------------------------------------------------------------
# The blocked flash plain versions at fp16
# ---------------------------------------------------------------------------


def _tables(s, d):
    inv = 1.0 / (10000.0 ** (np.arange(0, d, 2) / d))
    f = np.outer(np.arange(s), inv)
    return np.cos(f).astype(np.float32), np.sin(f).astype(np.float32)


def _row_excess(got, ref):
    """The largest |got - ref| over the rms of ref's row (the last dim). A
    row whose true value cancels (query 0's dq: its one key is itself, so
    ds = 0) keeps only fp32 noise, exactly 0 in one package and ~1e-6 in the
    other: a row's scale is floored at 1/16 of the whole tensor's rms."""
    g, r = got.astype(np.float32), ref.astype(np.float32)
    rms = np.sqrt((r ** 2).mean(-1, keepdims=True))
    rms = np.maximum(rms, np.sqrt((r ** 2).mean()) / 16)
    return float((np.abs(g - r) / rms).max())


@pytest.mark.parametrize("s,d", [(128, 32), (384, 64), (256, 128)])
def test_blocked_plain_versions_at_fp16_match_the_pallas_kernels(s, d):
    """``flash_fwd_blocked_plain`` / ``flash_bwd_blocked_plain`` at fp16
    against ``_flash_fwd_blocked`` / ``_flash_bwd_blocked`` at fp16 in
    interpret mode: out, dq, dk, dv within 2^-8 of each row's rms, lse
    within 1e-3."""
    b, h = 1, 2
    sm = 1 / np.sqrt(d)
    rng = np.random.RandomState(s + d)
    q, k, v, do = (rng.standard_normal((b, h, s, d)).astype(np.float32) for _ in range(4))
    cos, sin = _tables(s, d)
    jq, jk, jv, jdo = (jnp.asarray(a, jnp.float16) for a in (q, k, v, do))
    jout, jlse = jfa._flash_fwd_blocked(jq, jk, jv, (cos, sin), sm, 128, True)
    jgrads = jfa._flash_bwd_blocked(jq, jk, jv, jdo, jout, jlse, (cos, sin), sm, 128, 64, True)
    tq, tk, tv, tdo = (torch.from_numpy(a).half() for a in (q, k, v, do))
    tcos, tsin = torch.from_numpy(cos), torch.from_numpy(sin)
    out, lse = tfa.flash_fwd(tq, tk, tv, tcos, tsin, sm)  # CPU tensors: the plain version
    assert out.dtype == torch.float16 and lse.dtype == torch.float32
    assert _row_excess(out.numpy(), np.asarray(jout)) <= 2 ** -8
    np.testing.assert_allclose(lse.numpy().reshape(b, h, s), np.asarray(jlse).reshape(b, h, s),
                               atol=1e-3, rtol=0)
    tout = torch.from_numpy(np.array(jout.astype(jnp.float32))).half()
    tlse = torch.from_numpy(np.asarray(jlse, np.float32)).reshape(b, h, s, 1).contiguous()
    grads = tfa.flash_bwd(tq, tk, tv, tdo, tout, tlse, tcos, tsin, sm)
    for name, g, r in zip(("dq", "dk", "dv"), grads, jgrads):
        assert g.dtype == torch.float16
        assert _row_excess(g.numpy(), np.asarray(r)) <= 2 ** -8, name


if __name__ == "__main__" and len(sys.argv) == 4 and sys.argv[1] == "worker":
    sys.path.insert(0, str(ROOT))
    _worker(sys.argv[2], sys.argv[3])
