"""The port's GPT/OPT decoder (learned positions, LayerNorm, tanh-GELU or
ReLU, projection biases, tied embeddings) against the JAX package on the
CPU in fp32: init, the weight bridge, the loss and every gradient on the
einsum and flash paths (the JAX grid kernels in interpret mode), the three
recompute modes, a 5-step trajectory of the whole train step, the FLOP
accounting at gpt-1.5b, ``cli train`` of a GPT preset, and serving: the
paged cache forward, the engine on both KV backends and ``cli serve``.
Weights come from the JAX init, with biases and norm parameters drawn from
a numpy seed (the init's zeros and ones would leave their paths untested),
and go to both sides as the same arrays."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from galvatron_tpu.core.strategy import HybridParallelConfig
from galvatron_tpu.models import modeling as jm
from galvatron_tpu.obs import stepstats as jstats
from galvatron_tpu_torch import bridge, cli
from galvatron_tpu_torch.core.optim import tree_leaves
from galvatron_tpu_torch.models import modeling as tm
from galvatron_tpu_torch.obs import stepstats as tstats
from galvatron_tpu_torch.parallel import hybrid as thybrid
from galvatron_tpu_torch.utils.metrics import read_metrics
from tests.test_torch_serving import _http, _start_cli_serve
import _torch_threads  # noqa: F401

# the tolerances of test_torch_training.py (fp32 on both sides, sums in
# other orders): loss per token 1e-5, each gradient leaf within 1e-6 + 5e-6
# of its largest magnitude; 5 AdamW steps within 1e-4
LOSS_ATOL = 1e-5
GRAD_ATOL = 1e-6
GRAD_SCALE_TOL = 5e-6
TRAJ_ATOL = 1e-4

GPT = dict(vocab_size=97, hidden_size=64, num_layers=2, num_heads=4, max_seq_len=64,
           use_bias=True, pos_embed="learned", norm_type="layernorm",
           tie_word_embeddings=True)


def _cfgs(act="gelu", attn="xla", recompute="policy"):
    kw = dict(GPT, act_fn=act, attn_impl=attn, mlp_recompute=recompute)
    return (jm.ModelConfig(dtype=jnp.float32, **kw), tm.ModelConfig(dtype=torch.float32, **kw))


def _jax_params(jcfg, seed=0):
    """The JAX init with every bias and norm parameter redrawn."""
    rng = np.random.RandomState(seed + 100)

    def redraw(path, a):
        key = jax.tree_util.keystr(path)
        if key.endswith("_b']") or key.endswith("'bias']"):
            return (rng.standard_normal(a.shape) * 0.1).astype(np.float32)
        if key.endswith("'scale']"):
            return (1 + rng.standard_normal(a.shape) * 0.1).astype(np.float32)
        return a

    params = jax.tree.map(np.asarray, jm.init_model_params(jax.random.key(seed), jcfg))
    return jax.tree_util.tree_map_with_path(redraw, params)


def _batch(b, s, seed=1):
    return np.random.RandomState(seed).randint(0, GPT["vocab_size"], (b, s + 1)).astype(np.int32)


def _torch_params(np_params, tcfg):
    params = bridge.params_from_jax(np_params, tcfg, "cpu")
    for t in tree_leaves(params):
        t.requires_grad_(True)
    return params


def _assert_leaves_close(torch_leaves, jax_tree, atol, what, scale_tol=0.0):
    jl = jax.tree_util.tree_leaves(jax_tree)
    assert len(torch_leaves) == len(jl)
    for i, (t, j) in enumerate(zip(torch_leaves, jl)):
        ref = np.asarray(j, np.float32)
        np.testing.assert_allclose(t.detach().float().numpy(), ref,
                                   atol=atol + scale_tol * float(np.abs(ref).max()), rtol=0,
                                   err_msg=f"{what} leaf {i}")


@pytest.mark.parametrize("act", ["gelu", "relu"])
def test_init_matches_jax_tree_shapes_and_distributions(act):
    """Names, shapes and dtypes of the GPT tree (``embed.pos``, the qkv and
    output biases, ``w1``/``w1_b``, norm biases, no ``head`` when tied)
    and the init's distributions."""
    jcfg, tcfg = _cfgs(act)
    ref = jax.tree.map(np.asarray, jm.init_model_params(jax.random.key(0), jcfg))
    got = bridge.params_to_numpy(tm.init_model_params(tcfg, 0, "cpu"))
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(ref)
    assert "head" not in got and got["embed"]["pos"].shape == (64, 64)
    for path, r in jax.tree_util.tree_flatten_with_path(ref)[0]:
        t = got
        for k in path:
            t = t[getattr(k, "key", getattr(k, "idx", None))]
        assert t.shape == r.shape and t.dtype == r.dtype
        name = jax.tree_util.keystr(path)
        if name.endswith("'scale']"):
            np.testing.assert_array_equal(t, 1.0)
        elif name.endswith("_b']") or name.endswith("'bias']"):
            np.testing.assert_array_equal(t, 0.0)
        elif "'tok'" in name or "'pos'" in name:  # normal * 0.02
            assert abs(t.std() - 0.02) < 4e-3 and abs(t.mean()) < 4e-3
        else:  # uniform(-1/sqrt(fan_in), 1/sqrt(fan_in))
            bound = 1.0 / np.sqrt(r.shape[0])
            assert np.abs(t).max() <= bound


def test_bridge_round_trip_and_casts_keep_norm_parameters_fp32():
    """The GPT tree bridges as a plain copy; a bf16 cast rounds the
    weights, the projection biases and the embeddings like JAX's per-use
    ``astype`` and keeps norm scales and biases fp32 (``_norm_impl`` reads
    them so)."""
    jcfg, tcfg = _cfgs()
    ref = _jax_params(jcfg)
    back = bridge.params_to_numpy(bridge.params_from_jax(ref, tcfg, "cpu"))
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(ref)):
        np.testing.assert_array_equal(a, b)
    got = bridge.params_from_jax(ref, tcfg.replace(dtype=torch.bfloat16), "cpu")
    for (path, r), t in zip(jax.tree_util.tree_flatten_with_path(ref)[0], tree_leaves(got)):
        name = jax.tree_util.keystr(path)
        if name.endswith("'scale']") or name.endswith("'bias']"):
            assert t.dtype == torch.float32
            np.testing.assert_array_equal(t.numpy(), r)
        else:
            want = np.asarray(jnp.asarray(r).astype(jnp.bfloat16).astype(jnp.float32))
            np.testing.assert_array_equal(t.float().numpy(), want)


@pytest.mark.parametrize("attn", ["xla", "flash"])
@pytest.mark.parametrize("act", ["gelu", "relu"])
def test_lm_loss_sum_and_grads_match_jax(attn, act):
    """The summed token loss and every gradient (the tied table's included:
    the embedding gather's scatter-add plus the head GEMM's) against JAX;
    flash runs the grid kernels on both sides (no RoPE)."""
    jcfg, tcfg = _cfgs(act, attn)
    ref = _jax_params(jcfg)
    batch = _batch(2, 64)
    (js, jn), jg = jax.jit(jax.value_and_grad(
        lambda p: jm.lm_loss_sum(p, jnp.asarray(batch), jcfg), has_aux=True))(
        jax.tree.map(jnp.asarray, ref))
    params = _torch_params(ref, tcfg)
    ts, tn = tm.lm_loss_sum(params, torch.from_numpy(batch).long(), tcfg)
    ts.backward()
    assert int(tn) == int(jn)
    np.testing.assert_allclose(float(ts.detach()), float(js), atol=LOSS_ATOL * batch.size,
                               rtol=1e-6)
    _assert_leaves_close([p.grad for p in tree_leaves(params)], jg, GRAD_ATOL, "grad",
                         scale_tol=GRAD_SCALE_TOL)


@pytest.mark.parametrize("attn,act", [("xla", "gelu"), ("flash", "gelu"), ("flash", "relu")])
def test_recompute_modes_give_the_same_values(attn, act):
    """'off', 'gate' and 'policy' (whose region saves only x and the biased
    gate output), and per-layer full / selective checkpointing, change what
    is saved, not what is computed."""
    batch = torch.from_numpy(_batch(2, 64, seed=4)).long()
    ref = _jax_params(_cfgs(act, attn)[0], seed=3)
    results = []
    for recompute, ckpt in [("off", "none"), ("gate", "none"), ("policy", "none"),
                            ("policy", "full"), ("policy", "selective")]:
        _, tcfg = _cfgs(act, attn, recompute)
        params = _torch_params(ref, tcfg)
        loss = tm.lm_loss(params, batch, tcfg, layer_hook=thybrid._make_layer_hook(tcfg, ckpt))
        loss.backward()
        results.append((float(loss.detach()), [p.grad.clone() for p in tree_leaves(params)]))
    base_loss, base_grads = results[0]
    for loss, grads in results[1:]:
        assert abs(loss - base_loss) <= 1e-6
        for a, b in zip(grads, base_grads):
            torch.testing.assert_close(a, b, atol=1e-6, rtol=0)


@pytest.mark.parametrize("size,ckpt", [("gpt-1.5b", "none"), ("gpt-1.5b", "full"),
                                       ("opt-1.3b", "selective")])
def test_step_flops_match_jax(size, ckpt):
    """Model and hardware FLOPs per step at the presets' full size: two MLP
    GEMMs for gelu/relu, ffn 4h."""
    jcfg, tcfg = jm.PRESETS[size], tm.PRESETS[size]
    assert tcfg.ffn == jcfg.ffn == 4 * tcfg.hidden_size
    strategy = HybridParallelConfig.uniform(
        tcfg.num_layers, ckpt={"none": False, "full": "full", "selective": "selective"}[ckpt])
    js = jstats.StepStats(jcfg, 8, tcfg.max_seq_len, hp=strategy, num_devices=1)
    ts = tstats.StepStats(tcfg, 8, tcfg.max_seq_len, device="cpu", ckpt=ckpt)
    assert ts.model_flops_per_step == js.model_flops_per_step
    assert ts.hardware_flops_per_step == js.hardware_flops_per_step


@pytest.mark.parametrize("size", ["gpt-0.3b", "gpt-1.5b", "gpt-2.7b", "gpt-6.7b", "opt-125m",
                                  "opt-1.3b", "opt-6.7b", "opt-13b", "opt-30b"])
def test_presets_are_the_references(size):
    j, t = jm.PRESETS[size], tm.PRESETS[size]
    for field in ("vocab_size", "hidden_size", "num_layers", "num_heads", "max_seq_len",
                  "pos_embed", "norm_type", "act_fn", "use_bias", "tie_word_embeddings",
                  "ffn", "head_dim", "kv_heads"):
        assert getattr(t, field) == getattr(j, field), field


def test_cli_train_runs_a_gpt_preset_on_the_cpu(tmp_path, capsys):
    path = tmp_path / "m.jsonl"
    rc = cli.main(["train", "--device", "cpu", "--model_size", "gpt-0.3b", "--num_layers", "2",
                   "--hidden_size", "64", "--num_heads", "4", "--vocab_size", "128",
                   "--seq_length", "32", "--global_train_batch_size", "4", "--train_iters", "2",
                   "--attn_impl", "flash", "--check_loss", "1", "--metrics_path", str(path)])
    assert rc == 0
    recs = [r for r in read_metrics(str(path)) if r["event"] == "train_iter"]
    assert [r["step"] for r in recs] == [0, 1] and all(np.isfinite(r["loss"]) for r in recs)
    assert "gpt-0.3b layers=2" in capsys.readouterr().out


def test_serving_refuses_a_gpt_preset_naming_the_roadmap():
    """Serving takes the GPT family as training does: ``cli serve`` of a
    GPT preset (learned positions, LayerNorm, gelu, biases, tied head) on
    the default slot backend answers /api with ``generate_np``'s greedy
    tokens on the same weights; an ALiBi variant of the preset is accepted
    (ALiBi positions are ported: ``tests/test_torch_alibi.py``), and so is a
    bidirectional one in training (BERT: ``tests/test_torch_encoder.py``),
    which serving refuses with the reference's message, as it refuses an
    encoder-decoder (T5) variant, which trains, and a Swin variant, which
    trains too."""
    from galvatron_tpu_torch.models import generation as tgen
    from galvatron_tpu_torch.models.tokenizer import ByteTokenizer

    tm.check_supported(tm.PRESETS["gpt-1.5b"].replace(pos_embed="alibi"))
    tm.check_supported(tm.PRESETS["gpt-1.5b"].replace(causal=False))
    with pytest.raises(ValueError, match="serving engine requires a decoder-only causal LM"):
        tgen.check_generative(tm.PRESETS["gpt-1.5b"].replace(causal=False), "serving")
    t5 = tm.PRESETS["gpt-1.5b"].replace(enc_layers=2, enc_seq=64)
    tm.check_supported(t5)
    with pytest.raises(ValueError, match="serving engine requires a decoder-only causal LM"):
        tgen.check_generative(t5, "serving")
    swin = tm.PRESETS["swin-base"]
    tm.check_supported(swin)
    with pytest.raises(ValueError, match="serving engine requires a decoder-only causal LM"):
        tgen.check_generative(swin, "serving")
    flags = ["--device", "cpu", "--model_size", "gpt-0.3b", "--num_layers", "1",
             "--hidden_size", "64", "--num_heads", "4", "--seq_length", "64",
             "--prefill_chunk", "8", "--num_slots", "2"]
    base, th, rc = _start_cli_serve(flags)
    tok = ByteTokenizer()
    cfg = tm.PRESETS["gpt-0.3b"].replace(num_layers=1, hidden_size=64, num_heads=4,
                                         max_seq_len=64)
    params = tm.cast_params(tm.init_model_params(cfg, 0, "cpu"), cfg)
    prompts = ["gpt serves", "and so does its tied head"]
    code, resp = _http(base + "/api", {"prompts": prompts, "tokens_to_generate": 5})
    assert code == 200, resp
    assert resp["tokens"] == tgen.generate_np(params, cfg, [tok.encode(p) for p in prompts],
                                              max_new_tokens=5, eos_id=tok.eos_id,
                                              pad_id=tok.pad_id)
    code, drained = _http(base + "/drain", {})
    assert code == 200 and drained["leaked"] is False
    th.join(15)
    assert rc == [0]


@pytest.mark.parametrize("act", ["gelu", "relu"])
def test_forward_with_cache_paged_matches_jax(act):
    """GPT / OPT over the paged pool: a 12-token prefill chunk on two rows at
    ragged offsets, then a decode step, through scrambled block tables;
    logits and the written pool within 1e-5 of JAX's."""
    from galvatron_tpu.models import generation as jgen
    from galvatron_tpu_torch.models import generation as tgen

    jcfg, tcfg = _cfgs(act)
    ref = _jax_params(jcfg)
    tparams = bridge.params_from_jax(ref, tcfg, "cpu")
    bs, mb = 8, 8
    nblocks = 1 + 2 * mb
    rng = np.random.RandomState(1)
    tables = (rng.permutation(nblocks - 1)[: 2 * mb] + 1).reshape(2, mb).astype(np.int32)
    tables[1, 4:] = 0  # null-block tail
    jpool = jgen.init_kv_cache(jcfg, nblocks, bs)
    tpool = tgen.init_kv_cache(tcfg, nblocks, bs, "cpu")
    for tokens, offsets in ((rng.randint(1, 97, (2, 12)), [0, 5]),
                            (rng.randint(1, 97, (2, 1)), [12, 17])):
        offs = np.asarray(offsets, np.int32)
        jlog, jpool = jgen.forward_with_cache_paged(
            ref, jnp.asarray(tokens, jnp.int32), jcfg, jpool, jnp.asarray(tables),
            jnp.asarray(offs))
        tlog, tpool = tgen.forward_with_cache_paged(
            tparams, torch.from_numpy(tokens), tcfg, tpool, torch.from_numpy(tables),
            torch.from_numpy(offs))
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-5, rtol=0)
        np.testing.assert_allclose(tpool.k.numpy(), np.asarray(jpool.k), atol=1e-5, rtol=0)
        np.testing.assert_allclose(tpool.v.numpy(), np.asarray(jpool.v), atol=1e-5, rtol=0)


@pytest.mark.parametrize("act", ["gelu", "relu"])
def test_engine_serves_gpt_on_both_backends(act):
    """GPT / OPT through the engine, slot and paged (two requests sharing a
    16-token prefix, so the paged engine attaches cached blocks): greedy
    tokens equal JAX ``generate_np`` on both backends."""
    from galvatron_tpu.models import generation as jgen
    from galvatron_tpu_torch.serving.engine import Engine

    jcfg, tcfg = _cfgs(act)
    ref_params = _jax_params(jcfg)
    tparams = bridge.params_from_jax(ref_params, tcfg, "cpu")
    rng = np.random.RandomState(4)
    base = rng.randint(1, 97, (16,)).tolist()
    prompts = [rng.randint(1, 97, (5,)).tolist(), base + [3], base + [8, 9], [7] * 30]
    ref = jgen.generate_np(ref_params, jcfg, prompts, max_new_tokens=6)
    for kw in (dict(), dict(kv_num_blocks=-1, kv_block_size=8)):
        with Engine(tparams, tcfg, device="cpu", num_slots=2, prefill_chunk=8, **kw) as eng:
            assert eng.generate(prompts, max_new_tokens=6) == ref, kw
            assert not eng.audit()["leaked"]
