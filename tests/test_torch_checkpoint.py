"""The port's checkpoints on the CPU: the commit protocol (staging, manifest
last, rename, retention, corruption and fallback), the portable flat leaves
against the JAX package's ``portable_flat_state`` (through ``bridge``), a
resumed run against the JAX package's uninterrupted trajectory, restores
into other (pp, vpp, division, tp, ZeRO) layouts and world sizes in gloo
worlds, GTA017 against the JAX function, and ``serve --load``'s params."""

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
from galvatron_tpu.parallel import hybrid as jhybrid
from galvatron_tpu.parallel.mesh import build_mesh
from galvatron_tpu_torch import bridge
from galvatron_tpu_torch.core import checkpoint as ck
from galvatron_tpu_torch.core import optim as topt
from galvatron_tpu_torch.models import modeling as tm
from galvatron_tpu_torch.parallel import hybrid as thybrid
from galvatron_tpu_torch.utils.metrics import MetricsLogger, read_metrics
import _torch_threads  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
SHAPE = dict(vocab_size=128, hidden_size=64, num_layers=4, num_heads=4, ffn_dim=128,
             max_seq_len=16)
ADAM = dict(lr=1e-3, weight_decay=0.01, grad_clip=1.0)
#: fp32 on both sides: AdamW turns gradient rounding differences into
#: O(lr) parameter moves, so trajectories hold 1e-4, restores across
#: layouts and worlds 2e-4
TRAJ_TOL = 1e-4
LAYOUT_TOL = 2e-4


def _cfgs(layers=4):
    shape = dict(SHAPE, num_layers=layers)
    return (jm.ModelConfig(dtype=jnp.float32, attn_impl="xla", **shape),
            tm.ModelConfig(dtype=torch.float32, attn_impl="xla", **shape))


def _batches(n, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 128, (8, 17)).astype(np.int32) for _ in range(n)]


def _jax_runtime(jcfg, precision="fp32"):
    hp = JHP.uniform(jcfg.num_layers, mixed_precision=precision)
    mesh, axes = build_mesh(pp=1, devices=jax.devices()[:1])
    return jhybrid.build_runtime(jcfg, hp, mesh=mesh, axes=axes, adam=jopt.AdamConfig(**ADAM),
                                 global_batch_size=8, seq_len=16)


def _jax_flat(state):
    """The JAX state's leaves by ``keystr`` (numpy): what its checkpoints name."""
    return {jax.tree_util.keystr(kp): np.asarray(v)
            for kp, v in jax.tree_util.tree_flatten_with_path(state)[0]}


def _torch_runtime(tcfg, precision="fp32"):
    return thybrid.build_runtime(tcfg, adam=topt.AdamConfig(**ADAM), global_batch_size=8,
                                 seq_len=16, mixed_precision=precision, device="cpu")


def _tiny_state(tmp_path=None):
    _, tcfg = _cfgs(2)
    rt = _torch_runtime(tcfg)
    state = rt.init_state(0)
    state, _ = rt.train_step(state, torch.from_numpy(_batches(1)[0]))
    return rt, state


# ---------------------------------------------------------------------------
# The commit protocol
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["step_0", "step_12", "step_12.tmp", "step_x", "step_3.old",
                                  "step_4.corrupt", "step_05", "steps_1", "step_"])
def test_step_names_parse_as_the_reference_parses_them(name):
    assert ck.parse_step_name(name) == jck.parse_step_name(name)


def test_a_save_that_dies_mid_write_commits_nothing(tmp_path, monkeypatch):
    rt, state = _tiny_state()
    d = str(tmp_path / "ck")
    ck.save_checkpoint_portable(d, state, 1, rt)
    calls = {"n": 0}
    real = ck._write_leaf

    def dying(*a):
        calls["n"] += 1
        if calls["n"] == 5:
            raise RuntimeError("killed mid-save")
        return real(*a)

    monkeypatch.setattr(ck, "_IO_THREADS", 1)
    monkeypatch.setattr(ck, "_write_leaf", dying)
    with pytest.raises(RuntimeError, match="killed mid-save"):
        ck.save_checkpoint_portable(d, state, 2, rt)
    assert os.path.isdir(os.path.join(d, "step_2.tmp"))
    assert ck.committed_steps(d) == [1] == jck.committed_steps(d)
    assert ck.uncommitted_steps(d) == []  # a .tmp is neither
    assert ck.gc_stale_tmp(d) == [os.path.join(d, "step_2.tmp")]
    assert sorted(os.listdir(d)) == ["step_1"]
    assert ck.latest_step(d) == 1


def test_the_manifest_is_written_last(tmp_path, monkeypatch):
    rt, state = _tiny_state()
    synced = []
    real_fsync = os.fsync

    def fsync(fd):
        synced.append(os.readlink(f"/proc/self/fd/{fd}"))
        return real_fsync(fd)

    monkeypatch.setattr(os, "fsync", fsync)
    path = ck.save_checkpoint_portable(str(tmp_path / "ck"), state, 3, rt)
    # the staging directory is renamed by now: tell files from directories by name
    files = [p for p in synced if p.endswith((".npy", ck.MANIFEST_NAME))]
    assert synced[-2:] == [files[-1].rsplit("/", 1)[0], str(tmp_path / "ck")]
    assert files[-1].endswith("step_3.tmp/" + ck.MANIFEST_NAME)
    assert len(files) == len(os.listdir(path))  # every file fsynced, the manifest last
    m = ck.read_manifest(path)
    assert set(m) == {"version", "step", "leaves", "files"} and m["step"] == 3
    assert set(m["files"]) == set(os.listdir(path)) - {ck.MANIFEST_NAME}
    for rec in m["leaves"].values():
        assert set(rec) == {"shape", "dtype", "digest"} and rec["digest"].startswith("sha256:")


def test_retention_keeps_the_newest_n(tmp_path):
    rt, state = _tiny_state()
    d = str(tmp_path / "ck")
    for s in (1, 2, 3, 4):
        ck.save_checkpoint_portable(d, state, s, rt, keep_last_n=2)
        assert ck.committed_steps(d) == [max(1, s - 1), s][-min(s, 2):]
    ck.save_checkpoint_portable(d, state, 5, rt)  # 0 keeps all
    assert ck.committed_steps(d) == [3, 4, 5]


def test_a_flipped_byte_falls_back_to_the_older_step(tmp_path):
    rt, state = _tiny_state()
    d = str(tmp_path / "ck")
    ck.save_checkpoint_portable(d, state, 1, rt)
    state, _ = rt.train_step(state, torch.from_numpy(_batches(2)[1]))
    ck.save_checkpoint_portable(d, state, 2, rt)
    leaf = os.path.join(d, "step_2", "params.layers.0.attn.wqkv.npy")
    data = bytearray(open(leaf, "rb").read())
    data[len(data) // 2] ^= 0x40
    open(leaf, "wb").write(bytes(data))
    with pytest.raises(ck.CheckpointCorruptError, match="content digest mismatch"):
        ck.restore_checkpoint_portable(d, rt, step=2)
    # the whole-directory check finds the same file, as the JAX package's does
    m = ck.read_manifest(os.path.join(d, "step_2"))
    assert ck.verify_files(os.path.join(d, "step_2"), m) == \
        jck.verify_files(os.path.join(d, "step_2"), m) == [
            "file params.layers.0.attn.wqkv.npy content digest mismatch (size "
            f"{os.path.getsize(leaf)} matches — bytes corrupted in place)"]
    assert ck.verify_files(os.path.join(d, "step_1"), ck.read_manifest(os.path.join(d, "step_1"))) == []
    mpath = str(tmp_path / "m.jsonl")
    with MetricsLogger(mpath) as metrics:
        restored = ck.restore_checkpoint_portable(d, rt, metrics=metrics)
    assert restored["step"] == 1
    events = [r for r in read_metrics(mpath) if r["event"] == "ckpt_fallback"]
    assert [e["step"] for e in events] == [2]
    # the corrupt step is renamed aside and counts no more
    assert ck.committed_steps(d) == [1] and os.path.isdir(os.path.join(d, "step_2.corrupt"))
    # every step corrupt: an error, never fresh weights
    leaf1 = os.path.join(d, "step_1", "step.npy")
    open(leaf1, "ab").write(b"\x00")
    with pytest.raises(ck.CheckpointCorruptError, match="failed verification"):
        ck.restore_checkpoint_portable(d, rt)


def test_bf16_leaves_round_trip_as_uint16_views(tmp_path):
    t = torch.randn(3, 5).to(torch.bfloat16)
    flat = {"['w']": t, "['n']": np.arange(4, dtype=np.int32), "['s']": torch.tensor(2.5)}
    path = ck.save_checkpoint(str(tmp_path / "ck"), flat, 7)
    m = ck.read_manifest(path)
    assert m["leaves"]["['w']"]["dtype"] == "bfloat16"
    assert np.load(os.path.join(path, "w.npy")).dtype == np.uint16
    tree, step = ck.restore_raw_checkpoint(str(tmp_path / "ck"))
    assert step == 7 and tree["w"].dtype == torch.bfloat16 and torch.equal(tree["w"], t)
    assert tree["s"].shape == () and float(tree["s"]) == 2.5
    assert tree["n"].tolist() == [0, 1, 2, 3]


def test_a_checkpoint_of_another_model_is_refused_not_corrupt(tmp_path):
    rt, state = _tiny_state()
    d = str(tmp_path / "ck")
    ck.save_checkpoint_portable(d, state, 1, rt)
    _, tcfg = _cfgs(3)
    with pytest.raises(ValueError, match="does not fit this model"):
        ck.restore_checkpoint_portable(d, _torch_runtime(tcfg), step=1)


def test_an_interrupted_resave_swap_is_put_back(tmp_path):
    """A re-save of a step swaps through ``step_N.old``: killed between the
    two renames, ``gc_stale_tmp`` renames the old committed copy back; once
    the swap completed, the ``.old`` is removed."""
    rt, state = _tiny_state()
    d = str(tmp_path / "ck")
    ck.save_checkpoint_portable(d, state, 1, rt)
    os.rename(os.path.join(d, "step_1"), os.path.join(d, "step_1.old"))
    assert ck.committed_steps(d) == []
    ck.gc_stale_tmp(d)
    assert ck.committed_steps(d) == [1] and not os.path.exists(os.path.join(d, "step_1.old"))
    ck.save_checkpoint_portable(d, state, 1, rt)  # a re-save of the same step
    assert ck.committed_steps(d) == [1] and sorted(os.listdir(d)) == ["step_1"]


TINY_TRAIN = ["--device", "cpu", "--model_size", "llama-0.3b", "--num_layers", "2",
              "--hidden_size", "64", "--num_heads", "4", "--ffn_dim", "128", "--vocab_size",
              "128", "--seq_length", "16", "--global_train_batch_size", "8",
              "--mixed_precision", "fp32", "--attn_impl", "xla"]


def _train(*extra):
    from galvatron_tpu_torch.core.arguments import initialize_galvatron
    from galvatron_tpu_torch.core.trainer import train

    return train(initialize_galvatron("train", TINY_TRAIN + list(extra)))


def test_trainer_saves_at_intervals_and_at_the_end_without_duplicates(tmp_path):
    d = str(tmp_path / "ck")
    out = _train("--train_iters", "5", "--save", d, "--save_interval", "3")
    assert ck.committed_steps(d) == [3, 5] and len(out["save_s"]) == 2
    meta = ck.read_manifest(ck.step_path(d, 5))["meta"]
    assert meta["batches_consumed"] == 5 and meta["samples_consumed"] == 40
    assert meta["fingerprint"]["world_size"] == 1 and meta["global_bsz"] == 8
    # the interval save already committed the last step: no second write
    out = _train("--train_iters", "6", "--load", d, "--save", d, "--save_interval", "3")
    assert out["start_step"] == 5 and ck.committed_steps(d) == [3, 5, 6]
    assert len(out["save_s"]) == 1
    # nothing left to train: no batch, no save
    out = _train("--train_iters", "6", "--load", d, "--save", d)
    assert out["losses"] == [] and out["save_s"] == []


def test_trainer_refuses_a_directory_of_partial_saves(tmp_path):
    d = tmp_path / "ck"
    (d / "step_4").mkdir(parents=True)
    (d / "step_4" / "params.embed.tok.npy").write_bytes(b"partial")
    with pytest.raises(FileNotFoundError, match="none carries a manifest"):
        _train("--train_iters", "5", "--load", str(d))


def test_trainer_resumes_at_another_batch_size_through_the_sample_cursor(tmp_path):
    """The checkpoint records samples consumed: resumed at batch 4, 24
    samples are 6 batches of 4; a batch size that does not divide them is
    refused instead of skipping or replaying a partial batch."""
    d = str(tmp_path / "ck")
    _train("--train_iters", "3", "--save", d)
    out = _train("--train_iters", "8", "--load", d, "--global_train_batch_size", "4")
    assert out["start_step"] == 3 and out["consumed_samples"] == 8 * 4
    assert len(out["losses"]) == 2  # batches 6 and 7 of 4
    with pytest.raises(ValueError, match="not divisible"):
        _train("--train_iters", "8", "--load", d, "--global_train_batch_size", "16")


# ---------------------------------------------------------------------------
# Parity with the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("precision", ["fp32", "fp16"])
def test_portable_leaves_equal_the_jax_portable_flat_state(precision):
    """JAX and the port train k steps from the same weights; the JAX
    package's ``portable_flat_state`` leaves, through ``bridge``, have the
    port's names, shapes and dtypes and its values within 1e-4."""
    jcfg, tcfg = _cfgs()
    jrt, trt = _jax_runtime(jcfg, precision), _torch_runtime(tcfg, precision)
    jstate = jrt.init_state(jax.random.key(0))
    tstate = bridge.state_from_jax(_jax_flat(jck.portable_flat_state(jstate, jrt)), trt)
    for b in _batches(3):
        jstate, _ = jrt.train_step(jstate, jnp.asarray(b))
        tstate, _ = trt.train_step(tstate, torch.from_numpy(b))
    want = _jax_flat(jck.portable_flat_state(jstate, jrt))
    got = bridge.state_to_jax(tstate, trt)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
        if precision == "fp32" or got[k].dtype != np.float32:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=TRAJ_TOL, err_msg=k)
            continue
        # fp16 rounds each gradient to 11 bits: an element whose gradient is
        # within that rounding of zero gets another sign in the two packages
        # and AdamW normalises it to ~lr a step. Such elements stay a small
        # share, within 2 x steps x lr; the rest hold fp32's band x 10
        diff = np.abs(got[k] - want[k])
        assert diff.max() <= 2 * 3 * ADAM["lr"], k
        assert (diff > 10 * TRAJ_TOL).mean() <= 0.01, k
    if precision == "fp16":
        assert got["['scaler']['scale']"] == want["['scaler']['scale']"]
        assert got["['scaler']['good_steps']"] == want["['scaler']['good_steps']"] == 3


def test_a_resumed_run_continues_the_jax_trajectory(tmp_path):
    """JAX trains 6 steps uninterrupted; the port trains 3 from the same
    weights, saves, and a fresh runtime restores and trains 3 more: the
    losses and the final state within 1e-4 of JAX's."""
    jcfg, tcfg = _cfgs()
    jrt = _jax_runtime(jcfg)
    jstate = jrt.init_state(jax.random.key(1))
    start = _jax_flat(jck.portable_flat_state(jstate, jrt))
    batches = _batches(6, seed=3)
    jlosses = []
    for b in batches:
        jstate, loss = jrt.train_step(jstate, jnp.asarray(b))
        jlosses.append(float(loss))
    trt = _torch_runtime(tcfg)
    tstate = bridge.state_from_jax(start, trt)
    losses = []
    for b in batches[:3]:
        tstate, loss = trt.train_step(tstate, torch.from_numpy(b))
        losses.append(float(loss))
    d = str(tmp_path / "ck")
    ck.save_checkpoint_portable(d, tstate, 3, trt, meta={"batches_consumed": 3})
    del tstate
    trt2 = _torch_runtime(tcfg)
    tstate = ck.restore_checkpoint_portable(d, trt2)
    assert tstate["step"] == 3 and tstate["opt"]["count"] == 3
    for b in batches[3:]:
        tstate, loss = trt2.train_step(tstate, torch.from_numpy(b))
        losses.append(float(loss))
    np.testing.assert_allclose(losses, jlosses, rtol=TRAJ_TOL, atol=TRAJ_TOL)
    want = _jax_flat(jstate)
    got = bridge.state_to_jax(tstate, trt2)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=TRAJ_TOL, err_msg=k)


@pytest.mark.parametrize("rec,live", [({"world_size": 8}, 8), ({"world_size": 8}, 4),
                                      ({"world_size": 0}, 4), ({}, 2), ("x", 2),
                                      ({"world_size": "bad"}, 2),
                                      ({"world_size": 2, "plan_hash": "a"}, 2)])
def test_gta017_gives_the_jax_verdict(rec, live):
    from galvatron_tpu.analysis.plan_check import check_topology_fingerprint as jcheck
    from galvatron_tpu_torch.analysis.plan_check import check_topology_fingerprint as tcheck

    want = [(d.code, d.field, d.severity, d.message) for d in jcheck(rec, live, source="s")]
    got = [(d.code, d.field, d.severity, d.message) for d in tcheck(rec, live, source="s")]
    assert got == want


def test_serve_load_restores_the_saved_params(tmp_path):
    from galvatron_tpu_torch import cli
    from galvatron_tpu_torch.core.arguments import initialize_galvatron, model_config_from_args

    rt, state = _tiny_state()
    d = str(tmp_path / "ck")
    ck.save_checkpoint_portable(d, state, 1, rt)
    argv = ["--device", "cpu", "--vocab_size", "128", "--hidden_size", "64", "--num_layers",
            "2", "--num_heads", "4", "--ffn_dim", "128", "--seq_length", "16", "--load", d]
    ns = initialize_galvatron("serve", argv)
    params = cli._load_or_init_params(ns, model_config_from_args(ns), "cpu")
    saved = ck.flatten(bridge.params_to_numpy(state["params"]))
    loaded = ck.flatten(bridge.params_to_numpy(params))
    assert sorted(saved) == sorted(loaded)
    for k in saved:
        np.testing.assert_array_equal(loaded[k], saved[k])
    ns = initialize_galvatron("serve", argv[:-4] + ["--num_layers", "3", "--load", d])
    with pytest.raises(ValueError, match="does not match the model config"):
        cli._load_or_init_params(ns, model_config_from_args(ns), "cpu")


# ---------------------------------------------------------------------------
# Cross-layout restores in gloo worlds
# ---------------------------------------------------------------------------

#: (name, uniform-plan keywords) of the layouts a world trains or restores into
LAYOUTS = {
    "pp2_1f1b": dict(pp=2, chunks=2, pipeline_type="pipedream_flush"),
    "pp2_gpipe_3_1": dict(pp=2, chunks=2, pipeline_type="gpipe"),
    "pp2_vpp2_1f1b": dict(pp=2, vpp=2, chunks=2, pipeline_type="pipedream_flush"),
    "pp1_tp2_zero3_vocab2": dict(tp=2, dp_type="zero3", vocab_tp=2),
    "pp2_tp2_zero2": dict(pp=2, tp=2, chunks=2, dp_type="zero2",
                          pipeline_type="pipedream_flush"),
}


def _layout_hp(name):
    from galvatron_tpu_torch.core.strategy import HybridParallelConfig

    hp = HybridParallelConfig.uniform(4, mixed_precision="fp32", **LAYOUTS[name])
    if name == "pp2_gpipe_3_1":
        hp.pp_division = [3, 1]
    return hp


def _worker(case_path: str, out_dir: str) -> None:
    import torch.distributed as dist

    from galvatron_tpu_torch.core.trainer import init_distributed

    torch.set_num_threads(1)
    init_distributed(torch.device("cpu"), "gloo", timeout_s=300)
    rank = dist.get_rank()
    with open(case_path, "rb") as f:
        case = pickle.load(f)
    _, tcfg = _cfgs()
    out = {}
    try:
        for step in case["steps"]:
            rt = thybrid.build_runtime(tcfg, _layout_hp(step["layout"]),
                                       topt.AdamConfig(**ADAM), global_batch_size=8,
                                       seq_len=16, device="cpu")
            if step["op"] == "train_and_save":
                state = bridge.state_from_jax(case["start"], rt)
                for b in case["batches"][:2]:
                    state, _ = rt.train_step(state, torch.from_numpy(b))
                ck.save_checkpoint_portable(case["ckpt"], state, 2, rt)
            else:
                state = ck.restore_checkpoint_portable(case["ckpt"], rt, step=2)
                res = {"eval": float(rt.eval_loss(state, torch.from_numpy(case["batches"][2]))),
                       "losses": []}
                for b in case["batches"][2:]:
                    state, loss = rt.train_step(state, torch.from_numpy(b))
                    res["losses"].append(float(loss))
                out[step["layout"]] = res
            dist.barrier()
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def _run_world(tmp_path, world, steps, case):
    from galvatron_tpu_torch.parallel.launch import launch_local

    case_path = tmp_path / f"case{world}.pkl"
    with open(case_path, "wb") as f:
        pickle.dump(dict(case, steps=steps), f)
    out = tmp_path / f"out{world}"
    out.mkdir()
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    ranks = launch_local([sys.executable, str(Path(__file__).resolve()), "worker",
                          str(case_path), str(out)], world, timeout_s=600, env=env,
                         cwd=str(ROOT))
    assert all(r.returncode == 0 for r in ranks), "\n".join(r.output[-3000:] for r in ranks)
    return [json.loads((out / f"rank{r}.json").read_text()) for r in range(world)]


def test_restores_across_layouts_and_worlds_continue_the_jax_trajectory(tmp_path):
    """A 2-rank world trains 2 steps under pp = 2 1F1B from the JAX weights
    and saves; the same world restores the step into GPipe over a 3 / 1
    division, interleaved 1F1B (vpp = 2) and pp = 1 x tp = 2 ZeRO-3 with
    vocab TP, and a 4-rank world into pp = 2 x tp = 2 ZeRO-2: every eval
    loss and every continued loss within 2e-4 of the JAX package's flat
    trajectory (a world-1 runtime from the same weights)."""
    jcfg, _ = _cfgs()
    jrt = _jax_runtime(jcfg)
    jstate = jrt.init_state(jax.random.key(2))
    start = _jax_flat(jck.portable_flat_state(jstate, jrt))
    batches = _batches(4, seed=5)
    jlosses = []
    for i, b in enumerate(batches):
        if i == 2:
            jeval = float(jrt.eval_loss(jstate, jnp.asarray(b)))
        jstate, loss = jrt.train_step(jstate, jnp.asarray(b))
        jlosses.append(float(loss))
    case = {"start": start, "batches": batches, "ckpt": str(tmp_path / "ck")}
    restores2 = ["pp2_gpipe_3_1", "pp2_vpp2_1f1b", "pp1_tp2_zero3_vocab2"]
    got2 = _run_world(tmp_path, 2, [{"op": "train_and_save", "layout": "pp2_1f1b"}] +
                      [{"op": "restore", "layout": n} for n in restores2], case)
    got4 = _run_world(tmp_path, 4, [{"op": "restore", "layout": "pp2_tp2_zero2"}], case)
    assert ck.committed_steps(case["ckpt"]) == [2]
    for world, got, names in ((2, got2, restores2), (4, got4, ["pp2_tp2_zero2"])):
        for rank_out in got:
            for n in names:
                r = rank_out[n]
                np.testing.assert_allclose(r["eval"], jeval, rtol=LAYOUT_TOL, atol=LAYOUT_TOL,
                                           err_msg=f"{n} world {world}")
                np.testing.assert_allclose(r["losses"], jlosses[2:], rtol=LAYOUT_TOL,
                                           atol=LAYOUT_TOL, err_msg=f"{n} world {world}")


if __name__ == "__main__" and len(sys.argv) == 4 and sys.argv[1] == "worker":
    sys.path.insert(0, str(ROOT))
    _worker(sys.argv[2], sys.argv[3])
