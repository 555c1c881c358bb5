"""The T5-class encoder-decoder in the port against the JAX package at fp32
on the CPU, in one process: the single-process cases of
``tests/test_encdec.py`` and the port's own (its multi-rank cases:
``tests/test_torch_encdec_world.py`` and ``tests/test_torch_encdec_search.py``).

- The model: cross-attention reads the encoder (the JAX test's case) and
  the logits, the loss and every gradient hold the JAX ones within 1e-5 on
  the einsum path and on the flash path (on the CPU: the grid kernels'
  plain versions; the encoder unmasked, the decoder causal), with an
  encoder of another length than the decoder; the runtime trains and
  memorizes; the presets' parameter shapes are the JAX package's.
- The refusals, with the reference's messages: context parallelism, a
  strategy list that does not cover encoder + decoder, a single-stack
  ``pp_division`` other than the balanced one, vpp > 1, an unknown
  pipeline type, an empty stack; serving and generation of a T5.
- The coupled clocks (``parallel/pipeline_encdec.py``) pass
  ``Schedule.check`` and hold at most the JAX package's stashes in flight:
  ``min(chunks, 4pp - 1)`` encoder and ``min(chunks, 2pp - 1)`` decoder
  micro-batches, for pp 2 to 4 and 1 to 5 chunks.
- The weight bridge cuts cross-attention's fused ``[k | v]`` per head (a
  TP rank holds its heads' k columns and their v columns) and
  ``gather_params`` undoes the cut exactly, at tp 2 and 4, consecutive and
  strided.
- The measured profile has two layer types (the decoder's heavier by its
  cross-attention) with the JAX package's analytic parts; ``cli search``
  and ``cli check-plan`` emit and report what the JAX package's do at pp 1,
  2 and 4; step accounting counts what the JAX package counts; the loader's
  rows are the JAX rows byte for byte; ``cli train`` and the ``t5`` entry
  package train.
"""

import contextlib
import io
import json

import numpy as np
import pytest
import torch

ATOL = 1e-5  # fp32 on both sides, matmuls summed in other orders
# tests/test_encdec.py's T5
SHAPE = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4, ffn_dim=128,
             max_seq_len=16, enc_layers=2, enc_seq=16, pos_embed="learned", norm_type="rms",
             act_fn="gelu", tie_word_embeddings=True)
TINY_T5 = ["--hidden_size", "64", "--num_layers", "2", "--enc_layers", "2", "--num_heads", "4",
           "--ffn_dim", "128", "--vocab_size", "128", "--seq_length", "16", "--enc_seq", "16"]


def _cfgs(**kw):
    import jax.numpy as jnp

    from galvatron_tpu.models import modeling as jm
    from galvatron_tpu_torch.models import modeling as tm

    shape = dict(SHAPE, **kw)
    return (jm.ModelConfig(dtype=jnp.float32, **shape),
            tm.ModelConfig(dtype=torch.float32, **shape))


def _params(jcfg, seed=0):
    """The JAX init (numpy leaves), norm scales redrawn from a seed so that
    no gradient is structurally zero."""
    import jax

    from galvatron_tpu.models import modeling as jm

    rng = np.random.RandomState(seed + 100)

    def redraw(path, a):
        if jax.tree_util.keystr(path).endswith("'scale']"):
            return (1 + rng.standard_normal(a.shape) * 0.1).astype(np.float32)
        return a

    params = jax.tree.map(np.asarray, jm.init_model_params(jax.random.key(seed), jcfg))
    return jax.tree_util.tree_map_with_path(redraw, params)


def _batch(cfg, seed=0, rows=8):
    return np.random.RandomState(seed).randint(0, 128, (rows, cfg.sample_len + 1))


def test_cross_attention_uses_encoder():
    """Changing the encoder input changes the decoder logits (the JAX
    test's case); the logits are the JAX ones; the tree carries the encoder
    and each decoder layer's cross-attention."""
    import jax
    import jax.numpy as jnp

    from galvatron_tpu.models import modeling as jm
    from galvatron_tpu_torch import bridge
    from galvatron_tpu_torch.models import modeling as tm

    jcfg, tcfg = _cfgs()
    ref = _params(jcfg)
    params = bridge.params_from_jax(ref, tcfg, "cpu")
    b = torch.from_numpy(_batch(tcfg))
    enc, dec = b[:, :tcfg.enc_seq], b[:, tcfg.enc_seq:-1]
    with torch.no_grad():
        out1 = tm.forward_encdec(params, enc, dec, tcfg)
        out2 = tm.forward_encdec(params, (enc + 1) % 128, dec, tcfg)
    assert not torch.allclose(out1, out2)
    assert "cross" in params["layers"][0] and "enc_layers" in params
    want = jax.jit(lambda p, e, d: jm.forward_encdec(p, e, d, jcfg))(
        ref, jnp.asarray(enc.numpy()), jnp.asarray(dec.numpy()))
    np.testing.assert_allclose(out1.numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_loss_and_gradients_match_jax(attn_impl):
    """An encoder of 32 tokens and a decoder of 16: the loss and every
    gradient within 1e-5 of the JAX package's (the flash path: the grid
    kernels' plain versions on the CPU, unmasked in the encoder and causal
    in the decoder's self-attention; cross-attention is einsum in both
    packages)."""
    import jax
    import jax.numpy as jnp

    from galvatron_tpu.models import modeling as jm
    from galvatron_tpu_torch import bridge
    from galvatron_tpu_torch.core.optim import tree_leaves
    from galvatron_tpu_torch.models import modeling as tm

    jcfg, tcfg = _cfgs(enc_seq=32, attn_impl=attn_impl)
    ref = _params(jcfg, seed=1)
    b = _batch(tcfg, seed=2)
    jloss, jgrads = jax.jit(jax.value_and_grad(lambda p: jm.lm_loss(p, jnp.asarray(b), jcfg)))(
        jax.tree.map(jnp.asarray, ref))
    params = bridge.params_from_jax(ref, tcfg, "cpu")
    for t in tree_leaves(params):
        t.requires_grad_(True)
    loss = tm.lm_loss(params, torch.from_numpy(b), tcfg)
    loss.backward()
    np.testing.assert_allclose(float(loss), float(jloss), atol=ATOL, rtol=0)
    flat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert len(flat) == len(tree_leaves(params))
    for t, (path, g) in zip(tree_leaves(params), flat):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=ATOL, rtol=0,
                                   err_msg=jax.tree_util.keystr(path))


def test_encdec_trains_and_memorizes():
    from galvatron_tpu_torch.core.optim import AdamConfig
    from galvatron_tpu_torch.core.strategy import HybridParallelConfig
    from galvatron_tpu_torch.parallel.hybrid import build_runtime

    _, tcfg = _cfgs()
    rt = build_runtime(tcfg, HybridParallelConfig.uniform(4, mixed_precision="fp32"),
                       AdamConfig(lr=3e-3), global_batch_size=8, seq_len=16, device="cpu")
    state, b = rt.init_state(0), torch.from_numpy(_batch(tcfg))
    losses = []
    for _ in range(5):
        state, loss = rt.train_step(state, b)
        losses.append(float(loss))
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


def test_encdec_rejects_cp_and_bad_pipeline_shapes():
    """The reference's refusals and messages; a chunk count of 1 and
    sub-stacks smaller than pp are legal (zero-layer stages), an empty
    stack is not; a 2·pp division [enc ‖ dec] is read as such and a
    user-written single-stack one is refused."""
    from galvatron_tpu_torch.core.optim import AdamConfig
    from galvatron_tpu_torch.core.strategy import HybridParallelConfig
    from galvatron_tpu_torch.parallel import pipeline_encdec as pe
    from galvatron_tpu_torch.parallel.hybrid import build_runtime

    _, tcfg = _cfgs()
    U = HybridParallelConfig.uniform
    with pytest.raises(ValueError, match="context parallelism is not supported for enc-dec"):
        build_runtime(tcfg, U(4, cp=2, mixed_precision="fp32"), AdamConfig(),
                      global_batch_size=8, seq_len=16, device="cpu")
    with pytest.raises(ValueError, match=r"2 layer entries but the model has 4 \(encoder"):
        build_runtime(tcfg, U(2, mixed_precision="fp32"), AdamConfig(), global_batch_size=8,
                      seq_len=16, device="cpu")
    with pytest.raises(ValueError, match="pack_sequences requires a decoder-only CLM"):
        build_runtime(tcfg.replace(pack_sequences=True), U(4, mixed_precision="fp32"),
                      AdamConfig(), global_batch_size=8, seq_len=16, device="cpu")
    assert pe.pipedream_schedule(2, 1).ticks == 7  # chunks = 1 at pp = 2
    lay = pe.validate_encdec_pipeline(tcfg.replace(enc_layers=2, num_layers=2),
                                      U(4, pp=4, chunks=4))
    assert sorted(lay.div_e) == [0, 0, 1, 1]
    with pytest.raises(ValueError, match="at least one"):
        pe.validate_encdec_pipeline(tcfg.replace(enc_layers=0, num_layers=4),
                                    U(4, pp=4, chunks=4))
    ragged = tcfg.replace(enc_layers=3, num_layers=5)
    hp = U(8, pp=2, chunks=2)
    hp.pp_division = [2, 1, 2, 3]
    lay = pe.validate_encdec_pipeline(ragged, hp)
    assert (lay.div_e, lay.div_d) == ([2, 1], [2, 3])
    assert pe.virtual_stages(ragged, hp) == [[0, 1], [2], [3, 4], [5, 6, 7]]
    hp.pp_division = [5, 3]
    with pytest.raises(ValueError, match=r"2\*pp"):
        pe.validate_encdec_pipeline(ragged, hp)
    with pytest.raises(ValueError, match="does not compose with vpp>1"):
        pe.validate_encdec_pipeline(ragged, U(8, pp=2, vpp=2, chunks=2))
    bad = U(8, pp=2, chunks=2)
    bad.pipeline_type = "zb"
    with pytest.raises(ValueError, match="unknown pipeline_type 'zb'"):
        pe.validate_encdec_pipeline(ragged, bad)


@pytest.mark.parametrize("pp", [2, 3, 4])
@pytest.mark.parametrize("chunks", [1, 2, 3, 5])
def test_coupled_clocks_pass_check_and_bound_in_flight(pp, chunks):
    """Both clocks pass ``Schedule.check`` unchanged (every message consumed
    one tick after it is produced, the encoder output wrapping from device
    pp - 1 to device 0); 1F1B holds at most the JAX stashes in flight,
    GPipe every micro-batch; the tick counts are the JAX package's."""
    from galvatron_tpu_torch.parallel import pipeline_encdec as pe

    gpipe, f1b = pe.gpipe_schedule(pp, chunks), pe.pipedream_schedule(pp, chunks)
    for sched in (gpipe, f1b):
        sched.check(train=True)
        assert sched.stages == 2 * pp and all(sched.device(v) == v % pp for v in range(2 * pp))
    pe.gpipe_schedule(pp, chunks, train=False).check(train=False)
    assert gpipe.ticks == 2 * (chunks + 2 * pp - 1) and f1b.ticks == chunks + 4 * pp - 2
    enc, dec = range(pp), range(pp, 2 * pp)
    for d in range(pp):
        assert f1b.in_flight(d, enc) <= min(chunks, 4 * pp - 1)
        assert f1b.in_flight(d, dec) <= min(chunks, 2 * pp - 1)
        assert gpipe.in_flight(d, enc) == gpipe.in_flight(d, dec) == chunks
    assert f1b.in_flight(0, enc) == min(chunks, 4 * pp - 1)
    assert f1b.in_flight(0, dec) == min(chunks, 2 * pp - 1)


@pytest.mark.parametrize("tp,consec", [(2, True), (2, False), (4, True), (4, False)])
def test_wkv_cut_is_per_head_and_round_trips(tp, consec):
    """Under tp the fused cross-attention ``wkv`` = [k | v] is cut per head:
    a rank's piece is its heads' k columns, then the same heads' v columns
    (GSPMD's contiguous column cut would give one rank all of K); ``wq`` and
    ``wo`` are cut by head too; ``gather_params`` puts every rank's pieces
    back into the full tree exactly."""
    from galvatron_tpu_torch import bridge
    from galvatron_tpu_torch.core.optim import tree_leaves
    from galvatron_tpu_torch.core.strategy import HybridParallelConfig
    from galvatron_tpu_torch.parallel.mesh import RankMesh

    jcfg, tcfg = _cfgs()
    full = _params(jcfg)
    hp = HybridParallelConfig.uniform(4, tp=tp, tp_consec=consec, mixed_precision="fp32")
    world = 8
    pieces = [bridge.shard_params(full, tcfg, hp, r, world) for r in range(world)]
    mesh = RankMesh(world)
    hd, n = tcfg.head_dim, tcfg.num_heads
    wkv, wq = full["layers"][1]["cross"]["wkv"], full["layers"][1]["cross"]["wq"]
    for r in range(world):
        t = mesh.index(r, mesh.tp_axes(hp.layer_strategies[3]))
        heads = slice(t * n // tp * hd, (t + 1) * n // tp * hd)
        want = np.concatenate([wkv[:, :n * hd][:, heads], wkv[:, n * hd:][:, heads]], axis=1)
        np.testing.assert_array_equal(pieces[r]["layers"][1]["cross"]["wkv"], want)
        np.testing.assert_array_equal(pieces[r]["layers"][1]["cross"]["wq"], wq[:, heads])
    back = bridge.gather_params(pieces, tcfg, hp, world)
    for a, b in zip(tree_leaves(back), tree_leaves(full)):
        np.testing.assert_array_equal(a, b)


def test_encdec_measured_profile_two_types():
    """``profile_model`` of a T5 yields distinct encoder and decoder layer
    types from its three-point sweep, the decoder's parameters heavier by
    its cross-attention and equal to the JAX package's, and they feed the
    multi-type search at pp 2."""
    import jax.numpy as jnp

    from galvatron_tpu.models.modeling import ModelConfig as JCfg
    from galvatron_tpu.profiling.model import profile_model as jax_profile
    from galvatron_tpu_torch.profiling.model import profile_model
    from galvatron_tpu_torch.search.cost_model import ProfiledHardware
    from galvatron_tpu_torch.search.search_engine import SearchEngine, SearchSpace

    _, tcfg = _cfgs()
    costs = profile_model(tcfg, bsz=8, measure_time=False, device="cpu")
    want = jax_profile(JCfg(dtype=jnp.float32, **SHAPE), bsz=8, measure_time=False)
    assert len(set(id(v) for v in costs.layer_types.values())) == 2
    enc, dec = costs.layer_types[0], costs.layer_types[tcfg.enc_layers]
    assert dec.parameter_mb > enc.parameter_mb
    for got, ref in ((enc, want.layer_types[0]), (dec, want.layer_types[2])):
        assert (got.parameter_mb, got.boundary_activation_mb_per_sample, got.fwd_ms_per_sample) \
            == (ref.parameter_mb, ref.boundary_activation_mb_per_sample, ref.fwd_ms_per_sample)
        assert sorted(got.activation_mb_per_sample) == sorted(ref.activation_mb_per_sample)
        assert got.activation_mb_per_sample[1] > 0
    assert (costs.other_param_mb, costs.other_act_mb_per_sample) == \
        (want.other_param_mb, want.other_act_mb_per_sample)
    eng = SearchEngine(costs, ProfiledHardware(), num_layers=tcfg.total_layers,
                       space=SearchSpace(world_size=8, pp_choices=[2], max_tp=2),
                       memory_budget_mb=2000.0)
    r = eng.evaluate(2, 8, 2, "gpipe")
    assert r is not None and r.config.pp == 2
    with pytest.raises(ValueError, match="seq does not apply to enc-dec profiles"):
        profile_model(tcfg, bsz=8, seq=16, measure_time=False, device="cpu")


SEARCH = ["--analytic_costs", "1", "--settle_bsz", "64", "--mixed_precision", "fp32"]


@pytest.mark.parametrize("flags,pp", [
    (["--num_devices", "8", "--memory_constraint_gb", "40", "--search_space", "dp+tp"], 1),
    (["--num_devices", "4", "--memory_constraint_gb", "0.016", "--search_space", "dp+pp",
      "--disable_ckpt", "1"], 2),
    (["--num_devices", "8", "--memory_constraint_gb", "40", "--search_space", "dp+pp"], 4),
], ids=["pp1", "pp2", "pp4_zero_layer_stages"])
def test_cli_search_and_check_plan_match_jax(flags, pp, tmp_path):
    """``cli search`` of a tiny T5 on analytic costs emits the JAX plan
    JSON (pp 1; pp 2; pp 4, whose encoder and decoder divide [0, 1, 1, 0]),
    and ``cli check-plan`` reports what the JAX checker reports (the
    meta-device twin builds the T5's encoder and decoder trees)."""
    from galvatron_tpu.cli import main as j_main
    from galvatron_tpu_torch import cli

    args = ["--model_size", "t5-base", *TINY_T5, *SEARCH, *flags]
    a, b = str(tmp_path / "jax.json"), str(tmp_path / "port.json")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert j_main(["search", *args, "--output_config_path", a]) == 0
        assert cli.main(["search", *args, "--device", "cpu", "--output_config_path", b]) == 0
    with open(a) as f, open(b) as g:
        plan = json.load(f)
        assert json.load(g) == plan
    assert plan["pp_deg"] == pp
    jout, tout = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(jout):
        assert j_main(["check-plan", a, "--strict", "1"]) == 0
    with contextlib.redirect_stdout(tout):
        assert cli.main(["check-plan", b, "--strict", "1"]) == 0
    assert tout.getvalue().replace(b, a) == jout.getvalue()


@pytest.mark.parametrize("entry", ["t5", "cli"])
def test_t5_trains_through_its_entry_points(entry, capsys):
    """``python -m galvatron_tpu_torch.models.t5 train`` (the JAX test's
    flags) and ``cli train --model_size t5-base`` train on the CPU when
    asked; the ``train:`` line names encoder + decoder layers and
    sequences."""
    from galvatron_tpu_torch import cli
    from galvatron_tpu_torch.models import t5

    argv = ["train", "--model_size", "t5-base", *TINY_T5, "--global_train_batch_size", "8",
            "--train_iters", "2", "--mixed_precision", "fp32", "--check_loss", "1",
            "--device", "cpu"]
    assert (t5.main(argv) if entry == "t5" else cli.main(argv)) == 0
    out = capsys.readouterr().out
    assert "t5-base layers=2+2" in out and "seq=16+16" in out and "iter 1: loss" in out


def test_serve_and_generate_refuse_t5():
    """Serving and generation refuse an encoder-decoder with the reference's
    messages (``generation.check_generative``), from the CLI and the
    library."""
    from galvatron_tpu_torch import cli
    from galvatron_tpu_torch.models import generation as tgen
    from galvatron_tpu_torch.models import modeling as tm

    for mode, what in (("serve", "serving engine"), ("generate", "generation")):
        with pytest.raises(ValueError, match=f"{what} requires a decoder-only causal LM"):
            cli.main([mode, "--model_size", "t5-base", *TINY_T5, "--device", "cpu"])
    _, tcfg = _cfgs()
    with pytest.raises(ValueError, match="generation requires a decoder-only causal LM"):
        tgen.generate(tm.init_model_params(tcfg, 0, "cpu"), torch.zeros((1, 4), dtype=torch.long),
                      [4], tcfg)


def test_stepstats_count_what_the_jax_package_counts():
    """Model and hardware FLOPs of a T5 step are the JAX package's: every
    layer over the whole row, the decoder's positions at the head."""
    import jax.numpy as jnp

    from galvatron_tpu.models import modeling as jm
    from galvatron_tpu.obs.stepstats import StepStats as JStats
    from galvatron_tpu_torch.models import modeling as tm
    from galvatron_tpu_torch.obs.stepstats import StepStats

    for name in ("t5-base", "t5-large", "t5-3b"):
        jcfg, tcfg = jm.PRESETS[name].replace(dtype=jnp.float32), tm.PRESETS[name]
        got = StepStats(tcfg, 16, tcfg.max_seq_len, device="cpu", ckpt="none")
        want = JStats(jcfg, 16, jcfg.sample_len, num_devices=1)
        assert got.model_flops_per_step == want.model_flops_per_step, name
        assert got.hardware_flops_per_step == want.hardware_flops_per_step, name
        assert got.tokens_per_step == want.tokens_per_step == 16 * 1024


def test_dataloader_rows_are_the_jax_rows(tmp_path):
    """Random-token and corpus rows of encoder tokens ‖ decoder stream, byte
    for byte the JAX package's (its ``sample_len`` + 1)."""
    from galvatron_tpu.core.dataloader import build_dataloader as jax_loader
    from galvatron_tpu_torch.core.data import write_indexed_dataset
    from galvatron_tpu_torch.core.dataloader import build_dataloader

    jcfg, tcfg = _cfgs(enc_seq=8)
    rng = np.random.RandomState(4)
    corpus = str(tmp_path / "c")
    write_indexed_dataset(corpus, [list(rng.randint(0, 128, n)) for n in (40, 97, 230)], 128)
    for data_path in (None, corpus):
        for start in (0, 3):
            a = build_dataloader(tcfg, 8, tcfg.max_seq_len, seed=3, start_batch=start,
                                 data_path=data_path)
            b = jax_loader(jcfg, 8, jcfg.sample_len, seed=3, start_batch=start,
                           data_path=data_path)
            for _ in range(2):
                x, y = next(a), next(b)
                assert x.shape == (8, 8 + 16 + 1) and x.tobytes() == y.tobytes()


def test_preset_shapes_match_jax():
    """Every T5 preset's parameter shapes are the JAX package's."""
    import jax

    from galvatron_tpu.models import modeling as jm
    from galvatron_tpu_torch.models import modeling as tm
    from galvatron_tpu_torch.parallel.hybrid import param_shapes

    for name in ("t5-base", "t5-large", "t5-3b"):
        cfg = tm.PRESETS[name].replace(num_layers=2, enc_layers=2)
        want = jax.eval_shape(lambda: jm.init_model_params(
            jax.random.key(0), jm.PRESETS[name].replace(num_layers=2, enc_layers=2)))
        assert param_shapes(cfg) == jax.tree.map(lambda a: tuple(a.shape), want), name
