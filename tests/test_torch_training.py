"""The port's training path against the JAX package on the CPU: the loss
and its gradients (einsum and flash attention, the recompute modes), AdamW
with an LR schedule, the synthetic data stream, the FLOP accounting, a
5-step fp32 trajectory of the whole train step, and ``cli train``. The
JAX side's Pallas kernels run in interpret mode. Inputs and weights come
from numpy seeds (or the JAX init, bridged as numpy) and go to both sides
as the same arrays."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from galvatron_tpu.core import dataloader as jdl
from galvatron_tpu.core import optim as jopt
from galvatron_tpu.core import schedules as jsched
from galvatron_tpu.core.strategy import HybridParallelConfig
from galvatron_tpu.models import modeling as jm
from galvatron_tpu.obs import stepstats as jstats
from galvatron_tpu_torch import bridge, cli
from galvatron_tpu_torch.core import arguments as cli_args
from galvatron_tpu_torch.core import dataloader as tdl
from galvatron_tpu_torch.core import optim as topt
from galvatron_tpu_torch.core import schedules as tsched
from galvatron_tpu_torch.core.optim import tree_leaves
from galvatron_tpu_torch.models import modeling as tm
from galvatron_tpu_torch.obs import stepstats as tstats
from galvatron_tpu_torch.parallel import hybrid as thybrid
from galvatron_tpu_torch.utils.metrics import read_metrics

# fp32 on both sides; matmuls and softmax sums add in other orders, and the
# Pallas kernels walk the softmax in blocks: differences stay near fp32
# rounding, accumulated over two layers. The gradients of a token SUM reach
# O(10) and are sums of many such terms, so each leaf is held to 5e-6 of its
# largest magnitude (tens of fp32 ulps: the depth of those sums)
LOSS_ATOL = 1e-5
GRAD_ATOL = 1e-6
GRAD_SCALE_TOL = 5e-6
# five AdamW steps at lr 1e-3 amplify gradient rounding differences
# (Adam's m/sqrt(v) normalises tiny gradients to O(lr) updates)
TRAJ_LOSS_ATOL = 1e-4
TRAJ_PARAM_ATOL = 1e-4

SHAPE = dict(vocab_size=97, hidden_size=64, num_layers=2, num_heads=4, ffn_dim=128,
             max_seq_len=64)


def _cfgs(kv_heads=None, attn="xla", recompute="policy", seq=64):
    shape = dict(SHAPE, max_seq_len=seq)
    return (jm.ModelConfig(num_kv_heads=kv_heads, attn_impl=attn, mlp_recompute=recompute,
                           dtype=jnp.float32, **shape),
            tm.ModelConfig(num_kv_heads=kv_heads, attn_impl=attn, mlp_recompute=recompute,
                           dtype=torch.float32, **shape))


def _jax_params(jcfg, seed=0):
    return jax.tree.map(np.asarray, jm.init_model_params(jax.random.key(seed), jcfg))


def _batch(b, s, vocab, seed=1):
    return np.random.RandomState(seed).randint(0, vocab, (b, s + 1)).astype(np.int32)


def _torch_params(np_params, tcfg):
    params = bridge.params_from_jax(np_params, tcfg, "cpu")  # fp32 config: no cast
    for t in tree_leaves(params):
        t.requires_grad_(True)
    return params


def _assert_tree_close(torch_leaves, jax_tree, atol, what, scale_tol=0.0):
    """Each leaf within ``atol + scale_tol · max|reference leaf|``."""
    jl = jax.tree_util.tree_leaves(jax_tree)
    assert len(torch_leaves) == len(jl)
    for i, (t, j) in enumerate(zip(torch_leaves, jl)):
        ref = np.asarray(j, np.float32)
        tol = atol + scale_tol * float(np.abs(ref).max())
        np.testing.assert_allclose(t.detach().float().numpy(), ref, atol=tol, rtol=0,
                                   err_msg=f"{what} leaf {i}")


@pytest.mark.parametrize("attn,kv_heads,seq", [
    ("xla", None, 64), ("xla", 2, 64), ("flash", None, 64), ("flash", 2, 64),
    ("flash", None, 100),
])
def test_lm_loss_sum_and_grads_match_jax(attn, kv_heads, seq):
    jcfg, tcfg = _cfgs(kv_heads, attn, seq=seq)
    ref = _jax_params(jcfg)
    batch = _batch(2, seq, SHAPE["vocab_size"])

    def jloss(p):
        s, n = jm.lm_loss_sum(p, jnp.asarray(batch), jcfg)
        return s, n

    (js, jn), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jax.tree.map(jnp.asarray, ref))
    params = _torch_params(ref, tcfg)
    ts, tn = tm.lm_loss_sum(params, torch.from_numpy(batch).long(), tcfg)
    ts.backward()
    assert int(tn) == int(jn)
    np.testing.assert_allclose(float(ts.detach()), float(js), atol=LOSS_ATOL * batch.size, rtol=1e-6)
    _assert_tree_close([p.grad for p in tree_leaves(params)], jg, GRAD_ATOL, "grad",
                       scale_tol=GRAD_SCALE_TOL)


@pytest.mark.parametrize("attn", ["xla", "flash"])
def test_recompute_modes_give_the_same_values(attn):
    """'off', 'gate' and 'policy' (and per-layer full / selective
    checkpointing) change what is saved, not what is computed."""
    batch = torch.from_numpy(_batch(2, 64, SHAPE["vocab_size"], seed=4)).long()
    ref = _jax_params(_cfgs(None, attn)[0], seed=3)
    results = []
    for recompute, ckpt in [("off", "none"), ("gate", "none"), ("policy", "none"),
                            ("policy", "full"), ("policy", "selective")]:
        _, tcfg = _cfgs(None, attn, recompute)
        params = _torch_params(ref, tcfg)
        hook = thybrid._make_layer_hook(tcfg, ckpt)
        loss = tm.lm_loss(params, batch, tcfg, layer_hook=hook)
        loss.backward()
        results.append((float(loss.detach()), [p.grad.clone() for p in tree_leaves(params)]))
    base_loss, base_grads = results[0]
    for loss, grads in results[1:]:
        assert abs(loss - base_loss) <= 1e-6
        for a, b in zip(grads, base_grads):
            torch.testing.assert_close(a, b, atol=1e-6, rtol=0)


def test_adamw_with_clip_decay_and_cosine_warmup_matches_jax():
    sched_args = dict(lr=1e-3, min_lr=1e-5, warmup_iters=2, decay_iters=6, decay_style="cosine")
    jadam = jopt.AdamConfig(lr=1e-3, weight_decay=0.1, grad_clip=0.5,
                            lr_schedule=jsched.LRSchedule(**sched_args))
    tadam = topt.AdamConfig(lr=1e-3, weight_decay=0.1, grad_clip=0.5,
                            lr_schedule=tsched.LRSchedule(**sched_args))
    rng = np.random.RandomState(0)
    shapes = {"a": (5, 3), "b": {"c": (7,), "d": (2, 2)}}
    leaves = lambda tree, fn: {k: (leaves(v, fn) if isinstance(v, dict) else fn(v))  # noqa: E731
                               for k, v in tree.items()}
    p0 = leaves(shapes, lambda s: rng.standard_normal(s).astype(np.float32))
    jp, jstate = jax.tree.map(jnp.asarray, p0), None
    tp = leaves(p0, lambda a: torch.from_numpy(a.copy()))
    jstate = jopt.init_opt_state(jp)
    tstate = topt.init_opt_state(tp)
    for step in range(7):
        g = leaves(shapes, lambda s: (rng.standard_normal(s) * (step + 1)).astype(np.float32))
        jp, jstate = jopt.adamw_update(jp, jax.tree.map(jnp.asarray, g), jstate, jadam)
        topt.adamw_update(tp, leaves(g, torch.from_numpy), tstate, tadam)
        _assert_tree_close(tree_leaves(tp), jp, 1e-6, f"params after step {step}")
        _assert_tree_close(tree_leaves(tstate["mu"]), jstate["mu"], 1e-6, "mu")
        _assert_tree_close(tree_leaves(tstate["nu"]), jstate["nu"], 1e-6, "nu")
    assert tstate["count"] == int(jstate["count"]) == 7


@pytest.mark.parametrize("style", ["constant", "linear", "cosine"])
def test_lr_schedule_matches_jax(style):
    kw = dict(lr=3e-4, min_lr=1e-5, warmup_iters=3, decay_iters=10, decay_style=style,
              warmup_init_lr=1e-6)
    js, ts = jsched.LRSchedule(**kw), tsched.LRSchedule(**kw)
    for step in range(14):
        assert ts(step) == js(step)
        assert float(ts(torch.tensor(float(step)))) == float(js(jnp.float32(step)))


@pytest.mark.parametrize("seed,bsz,start", [(1234, 8, 0), (7, 4, 300), (0, 16, 63)])
def test_dataloader_batches_are_bit_identical(seed, bsz, start):
    jcfg, tcfg = _cfgs(seq=32)
    jit = jdl.build_dataloader(jcfg, bsz, 32, size=256, seed=seed, start_batch=start)
    tit = tdl.build_dataloader(tcfg, bsz, 32, size=256, seed=seed, start_batch=start)
    for _ in range(40):  # crosses an epoch boundary
        a, b = next(jit), next(tit)
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)


def test_dataloader_corpus_path_is_not_ported(tmp_path):
    """The corpus path is ported now (tests/test_torch_data.py holds its
    batches to the JAX package's): a missing corpus is the reference's
    FileNotFoundError, a corpus whose vocab exceeds the model's its
    ValueError."""
    from galvatron_tpu_torch.core.data import write_indexed_dataset

    with pytest.raises(FileNotFoundError, match="idx.json"):
        tdl.build_dataloader(_cfgs()[1], 4, data_path=str(tmp_path / "corpus"))
    write_indexed_dataset(str(tmp_path / "big"), [[1, 2, 3] * 40], vocab_size=1000)
    with pytest.raises(ValueError, match="exceeds the model vocab"):
        tdl.build_dataloader(_cfgs()[1], 4, 16, data_path=str(tmp_path / "big"))


@pytest.mark.parametrize("ckpt", ["none", "full", "selective"])
def test_step_flops_match_jax(ckpt):
    jcfg, tcfg = _cfgs(2)
    strategy = HybridParallelConfig.uniform(
        2, ckpt={"none": False, "full": "full", "selective": "selective"}[ckpt])
    js = jstats.StepStats(jcfg, 8, 64, hp=strategy, num_devices=1)
    ts = tstats.StepStats(tcfg, 8, 64, device="cpu", ckpt=ckpt)
    assert ts.model_flops_per_step == js.model_flops_per_step
    assert ts.hardware_flops_per_step == js.hardware_flops_per_step
    assert ts.per_iter(12.5) == {"tokens_per_s": None, "tflops_per_device": None,
                                 "mfu": None, "hfu": None}


@pytest.mark.parametrize("name,peak", [
    ("NVIDIA H100 80GB HBM3", 989e12),
    ("NVIDIA H200", 989e12),
    ("NVIDIA H100 PCIe", None),
    ("NVIDIA H100 NVL", None),
    ("NVIDIA H200 NVL", None),
    ("NVIDIA A100-SXM4-80GB", None),
])
def test_peak_is_known_only_for_the_sxm_parts(monkeypatch, name, peak):
    """The peak is looked up by the card's whole name: the PCIe and NVL
    parts of a chip peak lower than its SXM part and get no MFU."""
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: name)
    assert tstats.peak_flops_per_device("cuda") == peak
    assert tstats.peak_flops_per_device("cpu") is None


def test_runtime_refuses_fp16_bad_chunks_and_misshapen_batches():
    _, tcfg = _cfgs()
    # fp16 runs the blocked flash kernels only: the GPT family (grid kernels)
    # and fused_norm are ROADMAP §1.1's remainder
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        thybrid.build_runtime(tcfg.replace(pos_embed="learned", norm_type="layernorm"),
                              mixed_precision="fp16", device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        thybrid.build_runtime(tcfg.replace(fused_norm=True), mixed_precision="fp16",
                              device="cpu")
    with pytest.raises(ValueError, match="chunks"):
        thybrid.build_runtime(tcfg, global_batch_size=6, chunks=4, device="cpu")
    rt = thybrid.build_runtime(tcfg, global_batch_size=2, seq_len=16, device="cpu")
    state = rt.init_state(0)
    with pytest.raises(ValueError, match=r"\(2, 17\)"):
        rt.train_step(state, torch.zeros((2, 16), dtype=torch.int32))
    assert state["step"] == 0
    state, loss = rt.train_step(state, torch.zeros((2, 17), dtype=torch.int32))
    assert state["step"] == 1 and torch.isfinite(loss)


def test_cli_train_on_the_cpu_writes_train_iter_records(tmp_path, capsys):
    path = tmp_path / "m.jsonl"
    rc = cli.main(["train", "--device", "cpu", "--num_layers", "2", "--hidden_size", "64",
                   "--num_heads", "4", "--ffn_dim", "128", "--vocab_size", "128",
                   "--seq_length", "32", "--global_train_batch_size", "4",
                   "--train_iters", "3", "--mixed_precision", "fp32", "--check_loss", "1",
                   "--metrics_path", str(path)])
    assert rc == 0
    recs = [r for r in read_metrics(str(path)) if r["event"] == "train_iter"]
    assert [r["step"] for r in recs] == [0, 1, 2]
    for r in recs:
        assert r["schema"] == 1 and r["batch_size"] == 4 and r["iter_ms"] > 0
        assert np.isfinite(r["loss"])
        # device rates are None off the card
        assert r["tokens_per_s"] is None and r["mfu"] is None
    assert "iter 2: loss" in capsys.readouterr().out
    json.dumps(recs)


def test_cli_train_refuses_unported_flags():
    # flags of features not ported yet are argparse errors; the pipeline
    # flags parse, and --pp_deg 2 in a world of one rank raises the
    # world-size error instead of running pp=1
    # (--save / --data_path are ported: tests/test_torch_checkpoint.py and
    # tests/test_torch_data.py); the context-parallel flags are ported
    # (tests/test_torch_context_parallel.py), and so are the overlap flags
    # (tests/test_torch_collective_matmul.py) and --pack_sequences
    # (tests/test_torch_packing.py), which needs a corpus as the reference's does;
    # --load_hf is ported (tests/test_torch_convert.py) and parses
    from galvatron_tpu.core.arguments import initialize_galvatron as j_init
    from galvatron_tpu.core.trainer import train as j_train

    for flag in (["--num_slices", "2"],
                 ["--pipeline_type", "zero_bubble"], ["--pp_division", "2,x"]):
        with pytest.raises(SystemExit):
            cli.main(["train", "--device", "cpu", *flag])
    ns = cli_args.initialize_galvatron("train", ["--global_tp_overlap", "1", "--grad_overlap",
                                                 "1", "--global_tp_deg", "2"])
    hp = cli_args.hybrid_config_from_args(ns, 2, 2)
    assert hp.grad_overlap and all(s.tp_overlap and s.tp == 2 for s in hp.layer_strategies)
    with pytest.raises(ValueError) as je:
        j_train(j_init("train", ["--pack_sequences", "1"]))
    with pytest.raises(ValueError) as te:
        cli.main(["train", "--device", "cpu", "--pack_sequences", "1"])
    assert str(te.value) == str(je.value) and "need a real corpus" in str(te.value)
    assert cli_args.initialize_galvatron("train", ["--load_hf", "d"]).load_hf == "d"
    ns = cli_args.initialize_galvatron("train", ["--pp_deg", "2", "--vpp_deg", "2", "--pp_division",
                                        "2,2", "--pipeline_type", "pipedream_flush"])
    assert (ns.pp_deg, ns.vpp_deg, ns.pp_division, ns.pipeline_type) == (
        2, 2, [2, 2], "pipedream_flush")
    ns = cli_args.initialize_galvatron("train", ["--context_parallel_deg", "2",
                                                 "--context_parallel_impl", "a2a"])
    assert (ns.context_parallel_deg, ns.context_parallel_impl) == (2, "a2a")
    with pytest.raises(ValueError, match="pp=2 must divide the device count 1"):
        cli.main(["train", "--device", "cpu", "--pp_deg", "2"])


def test_state_from_trains_parameters_that_are_not_autograd_leaves():
    """A ``.to(device)`` or arithmetic copy of tensors that require grad is
    not an autograd leaf and would never receive ``.grad``; ``state_from``
    makes the state's tensors leaves that share the caller's storage."""
    _, tcfg = _cfgs(seq=16)
    rt = thybrid.build_runtime(tcfg, global_batch_size=2, seq_len=16, device="cpu")

    def nonleaf(tree):
        if isinstance(tree, dict):
            return {k: nonleaf(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [nonleaf(v) for v in tree]
        return tree.requires_grad_(True) * 1.0

    params = nonleaf(tm.init_model_params(tcfg, 0, "cpu"))
    before = [t.detach().clone() for t in tree_leaves(params)]
    state = rt.state_from(params)
    state, loss = rt.train_step(state, torch.from_numpy(_batch(2, 16, SHAPE["vocab_size"])))
    assert torch.isfinite(loss)
    moved = [not torch.equal(b, t.detach()) for b, t in zip(before, tree_leaves(params))]
    assert all(moved)  # updated in place, in the caller's storage
