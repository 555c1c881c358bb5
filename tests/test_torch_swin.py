"""The Swin pyramid in one process: the port against the JAX package at fp32
on the CPU, case for case with the single-device Swin cases of
``tests/test_vision.py`` and ``tests/test_profiling.py``.

- The shift mask is ``_swin_attn_mask``'s; the stage geometry, the window
  shrink and the presets' shapes are the JAX package's.
- Logits, loss and every gradient are the JAX ``lm_loss``'s within 1e-5 at
  ``SWIN_TINY`` (``tests/_vision_common.py``, with biases: ``wo_b``, which
  the reference's window attention never adds, gets an exactly-zero
  gradient in both) and at a three-section (2, 2, 2) pyramid whose later
  stages shrink their window (4 → 3); the runtime at world size 1 trains the JAX
  trajectory within 2e-4 under every recompute mode; one fp16 step is held
  as the JAX test holds it (within 0.05, the scale at 2^16).
- ``SwinLayout`` refuses what the JAX package refuses, with its messages;
  the coupled clocks pass ``Schedule.check`` for pp 2-4 x chunks 1/2/4 x K =
  2/3 sections, and section k on device s holds at most ``min(chunks, 2(K -
  k)·pp - 1 - 2s)`` micro-batches, within the JAX stash rings'
  ``min(chunks, 2(K - k)·pp - 1)``.
- The per-stage profile's structure and the analytic costs of swin-base and
  swin-large are the JAX package's; ``cli search`` and ``check-plan`` of a
  tiny Swin emit and report what the JAX package does at pp 1 and pp 2.
- A stage whose tokens (under SP) or heads do not split over tp is refused
  naming the layer; ``cli train`` runs through ``models.swin``; serving and
  generation refuse Swin with the reference's messages; ``StepStats``
  counts a swin-base step by hand.
"""

import contextlib
import dataclasses
import io
import json

import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401

ATOL = 1e-5  # fp32 on both sides, matmuls summed in other orders
LR = 1e-3
LOSS_TOL = 2e-4  # tests/test_vision.py's
# tests/_vision_common.py's SWIN_TINY (biased, so that wo_b is in the tree)
SHAPE = dict(vocab_size=1, hidden_size=16, num_layers=4, num_heads=2, max_seq_len=0,
             pos_embed="learned", norm_type="layernorm", act_fn="gelu", causal=False,
             objective="cls", image_size=16, patch_size=2, num_classes=16,
             swin_depths=(2, 2), swin_window=4, use_bias=True)
# three sections over 12 x 12 patches: windows 4, then 3 (shrunk to divide
# the 6 x 6 map), then 3 over the 3 x 3 map, which never shifts
THREE = dict(SHAPE, num_layers=6, swin_depths=(2, 2, 2), image_size=24)
TINY = ["--model_size", "swin-base", "--hidden_size", "16", "--num_layers", "4",
        "--num_heads", "2", "--image_size", "32", "--patch_size", "2", "--num_classes", "16",
        "--swin_depths", "2,2", "--swin_window", "4"]


def _cfgs(shape=SHAPE, **kw):
    import jax.numpy as jnp

    from galvatron_tpu.models import modeling as jm
    from galvatron_tpu_torch.models import modeling as tm

    shape = dict(shape, **kw)
    return jm.ModelConfig(dtype=jnp.float32, **shape), tm.ModelConfig(dtype=torch.float32,
                                                                       **shape)


def _params(jcfg, seed=0):
    """The JAX init (numpy leaves), norm scales and biases redrawn from a
    seed so that no gradient is structurally zero but ``wo_b``'s."""
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


def _batch(shape, seed=0, rows=8):
    """Pixels ‖ label rows (``tests/_vision_common.make_vision_batches``)."""
    rng = np.random.RandomState(seed)
    n = shape["image_size"] ** 2 * 3
    return np.concatenate([rng.randint(0, 256, (rows, n)),
                           rng.randint(0, shape["num_classes"], (rows, 1))], 1).astype(np.int64)


def test_shift_mask_geometry_and_window_shrink_match_jax():
    from galvatron_tpu.models import modeling as jm
    from galvatron_tpu_torch.models import modeling as tm

    for h, window, shift in ((8, 4, 2), (56, 7, 3), (28, 7, 3), (14, 7, 3), (12, 6, 3)):
        np.testing.assert_array_equal(tm.swin_attn_mask(h, h, window, shift),
                                      jm._swin_attn_mask(h, h, window, shift))
    for shape in (SHAPE, THREE):
        jcfg, tcfg = _cfgs(shape)
        for k in range(len(shape["swin_depths"])):
            assert tm.swin_geometry(tcfg, k) == jm.swin_geometry(jcfg, k)
            assert tm.swin_window_for(tcfg, k) == jm.swin_window_for(jcfg, k)
        for i in range(shape["num_layers"]):
            assert tm.swin_stage_of(tcfg, i) == jm.swin_stage_of(jcfg, i)
            lt, lj = tm.vision_layer_cfg(tcfg, i), jm.vision_layer_cfg(jcfg, i)
            assert (lt.hidden_size, lt.num_heads, lt.ffn) == (lj.hidden_size, lj.num_heads,
                                                              lj.ffn)
    # the window shrinks to a divisor of the side: 10 → 5 at window 7
    _, odd = _cfgs(SHAPE, image_size=20, swin_window=7)
    assert [tm.swin_window_for(odd, k) for k in range(2)] == [5, 5]
    base = tm.PRESETS["swin-base"]
    assert [tm.layer_seq(base, None, i) for i in (0, 2, 4, 22)] == [3136, 784, 196, 49]
    assert [tm.swin_window_for(base, k) for k in range(4)] == [7, 7, 7, 7]


def test_preset_shapes_match_jax():
    import jax

    from galvatron_tpu.models import modeling as jm
    from galvatron_tpu_torch.models import modeling as tm
    from galvatron_tpu_torch.parallel import hybrid

    for name in ("swin-base", "swin-large"):
        tcfg, jcfg = tm.PRESETS[name], jm.PRESETS[name]
        for f in dataclasses.fields(tcfg):
            if hasattr(jcfg, f.name) and f.name not in ("dtype", "param_dtype"):
                assert getattr(tcfg, f.name) == getattr(jcfg, f.name), (name, f.name)
        jshapes = jax.eval_shape(lambda k, c=jcfg: jm.init_model_params(k, c), jax.random.key(0))
        assert hybrid.param_shapes(tcfg) == jax.tree.map(lambda a: tuple(a.shape), jshapes), name


@pytest.mark.parametrize("shape", [SHAPE, THREE], ids=["tiny", "three_sections"])
def test_logits_loss_and_gradients_match_jax(shape):
    import jax
    import jax.numpy as jnp

    from galvatron_tpu.models import modeling as jm
    from galvatron_tpu_torch import bridge
    from galvatron_tpu_torch.core.optim import tree_leaves
    from galvatron_tpu_torch.models import modeling as tm

    jcfg, tcfg = _cfgs(shape)
    ref = _params(jcfg)
    b = _batch(shape, seed=2, rows=4)
    jb = jnp.asarray(b, jnp.int32)

    def loss_and_logits(p):  # the reference's lm_loss, its logits beside it
        logits = jm.forward_vision(p, jb[:, :-1], jcfg)
        s, n = jm.cross_entropy_sum(logits, jb[:, -1], remat=jm.ce_remat(jcfg))
        return s / jnp.maximum(n, 1), logits

    (jloss, jlogits), jgrads = jax.jit(jax.value_and_grad(loss_and_logits, has_aux=True))(
        jax.tree.map(jnp.asarray, ref))
    params = bridge.params_from_jax(ref, tcfg, "cpu")
    with torch.no_grad():
        logits = tm.forward_vision(params, torch.from_numpy(b[:, :-1]), tcfg)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=ATOL, rtol=0)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = tm.lm_loss(params, torch.from_numpy(b), tcfg)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), atol=ATOL, rtol=0)
    zero = 0
    for (path, g), p in zip(jax.tree_util.tree_flatten_with_path(jgrads)[0], leaves):
        key = jax.tree_util.keystr(path)
        got = p.grad.numpy() if p.grad is not None else np.zeros(p.shape, np.float32)
        np.testing.assert_allclose(got, np.asarray(g), atol=ATOL, rtol=0, err_msg=key)
        if key.endswith("['wo_b']"):
            assert p.grad is None and not np.asarray(g).any(), key
            zero += 1
    assert zero == shape["num_layers"]


def _jax_trajectory(jcfg, ref, batches):
    import jax
    import jax.numpy as jnp

    from galvatron_tpu.core.optim import AdamConfig, adamw_update, init_opt_state
    from galvatron_tpu.models import modeling as jm

    p = jax.tree.map(jnp.asarray, ref)
    opt, losses = init_opt_state(p), []
    step = jax.jit(jax.value_and_grad(lambda q, b: jm.lm_loss(q, b, jcfg)))
    for b in batches:
        loss, g = step(p, jnp.asarray(b, jnp.int32))
        p, opt = adamw_update(p, g, opt, AdamConfig(lr=LR, grad_clip=1.0))
        losses.append(float(loss))
    return losses


def _port_run(tcfg, ref, batches, **plan):
    from galvatron_tpu_torch.core.optim import AdamConfig
    from galvatron_tpu_torch.core.strategy import HybridParallelConfig
    from galvatron_tpu_torch.parallel import hybrid

    hp = HybridParallelConfig.uniform(tcfg.num_layers, **plan)
    rt = hybrid.build_runtime(tcfg, hp, AdamConfig(lr=LR, grad_clip=1.0), global_batch_size=8,
                              device="cpu")
    state = rt.state_from(hybrid.zip_map(lambda a, n: torch.from_numpy(np.array(a, copy=True)),
                                         ref))
    losses = []
    for b in batches:
        state, loss = rt.train_step(state, torch.from_numpy(b))
        losses.append(float(loss))
    return state, losses


def test_runtime_trains_the_jax_trajectory_and_an_fp16_step():
    """World size 1: three steps under every recompute mode and two
    micro-batches within 2e-4 of the JAX trajectory; one fp16 step within
    0.05 of the fp32 loss with the scale still 2^16, with and without
    ``fused_norm``."""
    jcfg, tcfg = _cfgs()
    ref = _params(jcfg)
    batches = [_batch(SHAPE, seed=7 + i) for i in range(3)]
    want = _jax_trajectory(jcfg, ref, batches)
    for ckpt, chunks in ((False, 1), ("full", 2), ("selective", 1)):
        _, got = _port_run(tcfg, ref, batches, ckpt=ckpt, chunks=chunks, mixed_precision="fp32")
        np.testing.assert_allclose(got, want, atol=LOSS_TOL, rtol=LOSS_TOL, err_msg=str(ckpt))
    for fused in (False, True):  # the fused norms take their fp16 instances
        state, got = _port_run(tcfg.replace(fused_norm=fused), ref, batches[:1],
                               mixed_precision="fp16")
        assert np.isfinite(got[0]) and abs(got[0] - want[0]) < 0.05, fused
        assert float(state["scaler"]["scale"]) == 65536.0


def test_tokens_or_heads_that_do_not_split_are_refused_naming_the_layer():
    """The port does not pad where GSPMD would: 49 tokens (swin-base's last
    stage: 14 x 14 patches, windows of 7) under SP at tp 2, and swin-large's
    6 heads at tp 4, raise naming the layer."""
    from galvatron_tpu_torch.core.strategy import HybridParallelConfig
    from galvatron_tpu_torch.models import modeling as tm
    from galvatron_tpu_torch.parallel import hybrid

    _, tcfg = _cfgs(SHAPE, image_size=28, swin_window=7)
    assert tm.layer_seq(tcfg, None, 2) == 49
    hp = HybridParallelConfig.uniform(4, tp=2, sp=True, vocab_tp=1, mixed_precision="fp32")
    with pytest.raises(ValueError, match=r"layer 2: .*49 tokens .* tp=2"):
        hybrid.build_runtime(tcfg, hp, global_batch_size=8, device="cpu")
    large = tm.PRESETS["swin-large"]
    hp = HybridParallelConfig.uniform(24, tp=4, vocab_tp=1)
    with pytest.raises(ValueError, match="layer 0: num_heads 6 does not split over tp=4"):
        hybrid.build_runtime(large, hp, global_batch_size=8, device="cpu")


def test_swin_layout_refuses_what_the_jax_package_refuses():
    from galvatron_tpu.core import strategy as js
    from galvatron_tpu.parallel.pipeline_swin import validate_swin_pipeline as jvalidate
    from galvatron_tpu_torch.core import strategy as ts
    from galvatron_tpu_torch.parallel.pipeline_swin import SwinLayout

    def plans(m):
        U, L = m.HybridParallelConfig.uniform, m.LayerStrategy
        bad_div = U(4, pp=2, chunks=2)
        bad_div.pp_division = [1, 3]
        bad_type = U(4, pp=2, chunks=2)
        bad_type.pipeline_type = "interleaved"  # no constructor takes it
        return [
            (dict(swin_depths=(1, 3)), U(4, pp=2, chunks=2)),
            ({}, U(4, pp=2, vpp=2, chunks=2)),
            ({}, bad_type),
            ({}, bad_div),
            ({}, m.HybridParallelConfig(pp=2, chunks=2, layer_strategies=[
                L(tp=1), L(tp=2), L(tp=1), L(tp=2)])),
        ]

    messages = []
    for (change, jhp), (_, thp) in zip(plans(js), plans(ts)):
        jcfg, tcfg = _cfgs(SHAPE, **change)
        with pytest.raises(ValueError) as want:
            jvalidate(jcfg, jhp)
        with pytest.raises(ValueError) as got:
            SwinLayout(tcfg, thp)
        assert str(got.value) == str(want.value)
        messages.append(str(got.value))
    assert ["even" in messages[0], "vpp" in messages[1], "orderings" in messages[2],
            "pp_division" in messages[3], "pair" in messages[4]] == [True] * 5


@pytest.mark.parametrize("sections", [2, 3])
def test_clocks_check_and_hold_the_stash_bound(sections):
    from galvatron_tpu_torch.parallel import pipeline

    K = sections
    for pp in (2, 3, 4):
        for chunks in (1, 2, 4):
            g = pipeline.sections_gpipe_schedule(pp, K, chunks)
            assert g.ticks == 2 * (chunks + K * pp - 1)
            pipeline.sections_gpipe_schedule(pp, K, chunks, train=False).check(False)
            f = pipeline.sections_1f1b_schedule(pp, K, chunks)
            assert f.ticks == chunks + 2 * K * pp - 2
            for s in range(pp):
                for k in range(K):
                    held = f.in_flight(s, [k * pp + s])
                    assert held == min(chunks, 2 * (K - k) * pp - 1 - 2 * s), (pp, chunks, s, k)
                    assert held <= min(chunks, 2 * (K - k) * pp - 1)
                    assert g.in_flight(s, [k * pp + s]) == chunks


def test_profile_matches_jax_structure():
    """The per-stage profile (no timing): one layer type a stage from the
    (K + 1)-point pair sweep, the JAX package's parameter, boundary and
    'other' terms; the activations are measured (saved tensors here, XLA's
    temporaries there) and shrink with tp."""
    import jax.numpy as jnp

    from galvatron_tpu.profiling.model import profile_model as jprofile
    from galvatron_tpu_torch.profiling.model import profile_model

    jcfg, tcfg = _cfgs(SHAPE)
    got = profile_model(tcfg, bsz=2, measure_time=False, device="cpu")
    want = jprofile(jcfg.replace(dtype=jnp.float32), bsz=2, measure_time=False)
    assert set(got.layer_types) == set(want.layer_types) == set(range(4))
    for i in range(4):
        a, b = got.layer_types[i], want.layer_types[i]
        for f in ("fwd_ms_per_sample", "parameter_mb", "boundary_activation_mb_per_sample"):
            assert getattr(a, f) == pytest.approx(getattr(b, f), rel=1e-12), (i, f)
        assert set(a.activation_mb_per_sample) == set(b.activation_mb_per_sample)
        curve = [a.activation_mb_per_sample[t] for t in sorted(a.activation_mb_per_sample)]
        assert curve[0] > 0 and curve == sorted(curve, reverse=True)
    assert got.layer_types[0] is got.layer_types[1] is not got.layer_types[2]
    assert got.layer_types[2] is got.layer_types[3]
    for f in ("other_param_mb", "other_act_mb_per_sample", "other_fwd_ms_per_sample",
              "hidden_size"):
        assert getattr(got, f) == pytest.approx(getattr(want, f), rel=1e-12), f
    with pytest.raises(ValueError, match="do not apply to swin profiles"):
        profile_model(tcfg, bsz=2, seq=64, measure_time=False, device="cpu")


def test_analytic_costs_match_jax():
    from galvatron_tpu.models import modeling as jm
    from galvatron_tpu.search import theoretical as jth
    from galvatron_tpu_torch.models import modeling as tm
    from galvatron_tpu_torch.search import theoretical as tth

    for name in ("swin-base", "swin-large"):
        for mp in ("bf16", "fp32"):
            got = tth.analytic_model_costs(tm.PRESETS[name], mixed_precision=mp)
            want = jth.analytic_model_costs(jm.PRESETS[name], mixed_precision=mp)
            assert json.loads(json.dumps(dataclasses.asdict(got))) == \
                json.loads(json.dumps(dataclasses.asdict(want))), (name, mp)
        assert tth.total_param_count(tm.PRESETS[name]) == jth.total_param_count(jm.PRESETS[name])


@pytest.mark.parametrize("memory_gb,pp", [("40", 1), ("0.02", 2)])
def test_cli_search_and_check_plan_match_jax(memory_gb, pp, tmp_path):
    """``cli search`` of a tiny Swin on 8 devices emits the JAX plan JSON (a
    pp 1 plan under a loose budget, a pp 2 one of the coupled sections
    under a tight one) and ``cli check-plan`` reports what the JAX checker
    reports."""
    from galvatron_tpu.cli import main as j_main
    from galvatron_tpu_torch import cli

    flags = TINY + ["--num_devices", "8", "--analytic_costs", "1", "--settle_bsz", "16",
                    "--memory_constraint_gb", memory_gb]
    a, b = str(tmp_path / "jax.json"), str(tmp_path / "port.json")
    with contextlib.redirect_stdout(io.StringIO()):
        assert j_main(["search", *flags, "--output_config_path", a]) == 0
        assert cli.main(["search", *flags, "--device", "cpu", "--output_config_path", b]) == 0
    with open(a) as f, open(b) as g:
        plan = json.load(g)
        assert plan == json.load(f)
    assert plan["pp_deg"] == pp
    jout, tout = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(jout):
        assert j_main(["check-plan", a, "--strict", "1"]) == 0
    with contextlib.redirect_stdout(tout):
        assert cli.main(["check-plan", b, "--strict", "1"]) == 0
    assert tout.getvalue().replace(b, a) == jout.getvalue()


def test_search_check_plan_and_train_through_the_swin_entry(tmp_path, capsys):
    """profile → search → check-plan → train on one device through
    ``python -m galvatron_tpu_torch.models.swin``: the ``train:`` line names
    every stage's layers, width, heads and tokens."""
    from galvatron_tpu_torch.models import swin

    prefix, plan = str(tmp_path / "p"), str(tmp_path / "plan.json")
    assert swin.main(["profile", "--device", "cpu", *TINY, "--profile_batch_size", "2",
                      "--mixed_precision", "fp32", "--output_prefix", prefix]) == 0
    assert swin.main(["search", "--device", "cpu", *TINY, "--num_devices", "1",
                      "--time_profile_path", f"{prefix}_computation.json",
                      "--memory_profile_path", f"{prefix}_memory.json", "--settle_bsz", "8",
                      "--mixed_precision", "fp32", "--output_config_path", plan]) == 0
    assert swin.main(["check-plan", plan, *TINY, "--strict", "1"]) == 0
    capsys.readouterr()
    assert swin.main(["train", "--device", "cpu", *TINY, "--galvatron_config_path", plan,
                      "--global_train_batch_size", "8", "--train_iters", "2"]) == 0
    out = capsys.readouterr().out
    assert "train: swin-base layers=2+2 hidden=16/32 heads=2/4 seq=256/64" in out, out
    assert "iter 1: loss" in out


def test_serve_and_generate_refuse_swin():
    from galvatron_tpu_torch import cli
    from galvatron_tpu_torch.models import generation as tgen
    from galvatron_tpu_torch.models import modeling as tm

    for mode, what in (("serve", "serving engine"), ("generate", "generation")):
        with pytest.raises(ValueError, match=f"{what} requires a decoder-only causal LM"):
            cli.main([mode, *TINY, "--device", "cpu"])
    _, tcfg = _cfgs()
    with pytest.raises(ValueError, match="generation requires a decoder-only causal LM"):
        tgen.generate(tm.init_model_params(tcfg, 0, "cpu"), torch.zeros((1, 4), dtype=torch.long),
                      [4], tcfg)


def test_stepstats_count_a_swin_base_step_by_hand():
    """swin-base at batch 2: stage s runs (56 / 2^s)² tokens at width C_s =
    128·2^s; a layer's token costs 2C·3C + 2C·C (qkv, wo), 4·49·C (its
    window's scores and context) and 2·2·C·4C (the MLP); a merge 2·4C·2C a
    merged token; the head 2·1024·1000 a sample. Model FLOPs are 3x that,
    and full recompute adds one forward of the layers."""
    from galvatron_tpu_torch.models import modeling as tm
    from galvatron_tpu_torch.obs.stepstats import StepStats

    cfg = tm.PRESETS["swin-base"]
    tokens, widths, depths = [3136, 784, 196, 49], [128, 256, 512, 1024], [2, 2, 18, 2]
    layers = sum(d * t * (24 * c * c + 196 * c) for d, t, c in zip(depths, tokens, widths))
    merges = sum(t // 4 * 16 * c * c for t, c in zip(tokens[:3], widths[:3]))
    fwd = 2 * (layers + merges + 2 * 1024 * 1000)
    st = StepStats(cfg, 2, tm.layer_seq(cfg), device="cpu", ckpt="full")
    assert st.model_flops_per_step == pytest.approx(3 * fwd, rel=1e-12)
    assert st.hardware_flops_per_step == pytest.approx(3 * fwd + 2 * layers, rel=1e-12)
    assert st.tokens_per_step == 2 * 3136
