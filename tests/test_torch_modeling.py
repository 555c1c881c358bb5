"""The PyTorch port's model against the JAX package at fp32 on the CPU:
the weight bridge, the init distributions, and the paged KV-cache forward
(prefill chunk + decode step, logits and the updated pool)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from galvatron_tpu.models import generation as jgen
from galvatron_tpu.models import modeling as jm
from galvatron_tpu_torch import bridge
from galvatron_tpu_torch.models import generation as tgen
from galvatron_tpu_torch.models import modeling as tm
import _torch_threads  # noqa: F401

# fp32 end to end; the two frameworks sum matmuls in different orders
ATOL = 1e-4

SHAPE = dict(vocab_size=97, hidden_size=64, num_layers=2, num_heads=4, ffn_dim=128,
             max_seq_len=64)
LAYOUTS = {"mha": None, "gqa": 2}


def _cfgs(kv_heads, dtype="fp32"):
    jdt, tdt = {"fp32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    return (jm.ModelConfig(num_kv_heads=kv_heads, dtype=jdt, **SHAPE),
            tm.ModelConfig(num_kv_heads=kv_heads, dtype=tdt, **SHAPE))


def _jax_params(jcfg, seed=0):
    return jax.tree.map(np.asarray, jm.init_model_params(jax.random.key(seed), jcfg))


def _leaves(tree):
    return jax.tree_util.tree_leaves(tree)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_bridge_round_trip_is_bit_exact(layout):
    jcfg, tcfg = _cfgs(LAYOUTS[layout])
    ref = _jax_params(jcfg)
    back = bridge.params_to_numpy(bridge.params_from_jax(ref, tcfg, "cpu"))
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(ref)
    for a, b in zip(_leaves(back), _leaves(ref)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_bridge_casts_like_jax_per_use_astype(layout):
    """bf16 compute: matmul weights and the embedding are cast once at load
    to exactly JAX's ``astype(bfloat16)`` values; norm scales stay fp32."""
    jcfg, tcfg = _cfgs(LAYOUTS[layout], "bf16")
    ref = _jax_params(jcfg)
    got = bridge.params_from_jax(ref, tcfg, "cpu")
    flat_ref = jax.tree_util.tree_flatten_with_path(ref)[0]
    for (path, r), t in zip(flat_ref, _leaves(got)):
        if "scale" in jax.tree_util.keystr(path):
            assert t.dtype == torch.float32
            np.testing.assert_array_equal(t.numpy(), r)
        else:
            assert t.dtype == torch.bfloat16
            want = np.asarray(jnp.asarray(r).astype(jnp.bfloat16).astype(jnp.float32))
            np.testing.assert_array_equal(t.float().numpy(), want)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_init_matches_jax_shapes_and_distributions(layout):
    jcfg, tcfg = _cfgs(LAYOUTS[layout])
    ref = _jax_params(jcfg)
    got = bridge.params_to_numpy(tm.init_model_params(tcfg, 0, "cpu"))
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(ref)
    for path, r in jax.tree_util.tree_flatten_with_path(ref)[0]:
        t = got
        for k in path:
            t = t[getattr(k, "key", getattr(k, "idx", None))]
        assert t.shape == r.shape and t.dtype == r.dtype
        name = jax.tree_util.keystr(path)
        if "scale" in name:
            np.testing.assert_array_equal(t, 1.0)
        elif "tok" in name:  # normal * 0.02
            assert abs(t.std() - 0.02) < 2e-3 and abs(t.mean()) < 2e-3
        else:  # uniform(-1/sqrt(fan_in), 1/sqrt(fan_in))
            bound = 1.0 / np.sqrt(r.shape[0])
            assert np.abs(t).max() <= bound
            assert abs(t.std() - bound / np.sqrt(3)) < 0.1 * bound


@pytest.mark.parametrize("field,value", [
    ("pos_embed", "learned"), ("norm_type", "layernorm"), ("act_fn", "gelu"),
    ("use_bias", True), ("tie_word_embeddings", True), ("moe_experts", 4),
    ("pos_embed", "alibi"), ("causal", False), ("objective", "mlm"), ("objective", "cls"),
])
def test_unported_families_raise_naming_the_roadmap(field, value):
    """What the port runs and where it refuses: the GPT/OPT
    pieces training runs (learned positions, layernorm, gelu, biases, tied
    head), switch-MoE MLPs and ALiBi positions (Baichuan-13B) the serving
    engine takes too. An ALiBi model also trains: one step's loss is finite
    and its gradients reach every layer (its parity with the JAX package is
    ``tests/test_torch_alibi.py``). The encoders (bidirectional, 'mlm',
    'cls': ``tests/test_torch_encoder.py``, ``tests/test_torch_vision.py``)
    train, and the engine refuses them with the reference's message, as it
    refuses the encoder-decoder (T5: ``enc_layers``), which trains too
    (``tests/test_torch_encdec.py``), and their Swin (``swin_depths``)
    variant, which trains too (``tests/test_torch_swin.py``)."""
    from galvatron_tpu_torch.serving import Engine

    _, tcfg = _cfgs(None)
    cfg = tcfg.replace(**{field: value})
    if field in ("causal", "objective"):
        if value == "cls":
            cfg = cfg.replace(causal=False, image_size=16, patch_size=4, num_classes=8)
        params = tm.init_model_params(cfg, 0, "cpu")
        batch = torch.from_numpy(np.random.RandomState(0).randint(
            0, 97, (2, tm.batch_row_width(cfg, 16)))).long()
        if value == "cls":
            batch[:, -1] %= 8
        assert torch.isfinite(tm.lm_loss(params, batch, cfg))
        with pytest.raises(ValueError, match="requires a decoder-only causal LM"):
            Engine(params, cfg, device="cpu", start_loop=False)
        t5 = tcfg.replace(enc_layers=2, enc_seq=16)
        t5_batch = torch.from_numpy(np.random.RandomState(0).randint(
            0, 97, (2, tm.batch_row_width(t5, 16)))).long()
        assert torch.isfinite(tm.lm_loss(tm.init_model_params(t5, 0, "cpu"), t5_batch, t5))
        with pytest.raises(ValueError, match="requires a decoder-only causal LM"):
            Engine(params, t5, device="cpu", start_loop=False)
        swin = cfg.replace(causal=False, objective="cls", image_size=16, patch_size=2,
                           num_classes=8, num_layers=4, swin_depths=(2, 2), swin_window=4)
        swin_params = tm.init_model_params(swin, 0, "cpu")
        swin_batch = torch.from_numpy(np.random.RandomState(0).randint(
            0, 8, (2, tm.batch_row_width(swin, 16)))).long()
        assert torch.isfinite(tm.lm_loss(swin_params, swin_batch, swin))
        with pytest.raises(ValueError, match="requires a decoder-only causal LM"):
            Engine(swin_params, swin, device="cpu", start_loop=False)
    else:
        if value == "alibi":
            params = tm.init_model_params(cfg, 0, "cpu")
            for leaf in (params["layers"][0]["attn"]["wqkv"], params["embed"]["tok"]):
                leaf.requires_grad_(True)
            batch = torch.from_numpy(np.random.RandomState(0).randint(
                0, cfg.vocab_size, (2, 17))).long()
            loss = tm.lm_loss(params, batch, cfg)
            loss.backward()
            assert torch.isfinite(loss)
            assert params["layers"][0]["attn"]["wqkv"].grad.abs().sum() > 0
        params = tm.cast_params(tm.init_model_params(cfg, 0, "cpu"), cfg)
        Engine(params, cfg, device="cpu", start_loop=False).close()


@pytest.mark.parametrize("layout", LAYOUTS)
def test_forward_with_cache_paged_matches_jax(layout):
    """A 12-token prefill chunk on two rows at ragged offsets, then one
    decode step, through scrambled block tables: logits and the updated
    pool agree with JAX's ``forward_with_cache_paged``."""
    jcfg, tcfg = _cfgs(LAYOUTS[layout])
    ref = _jax_params(jcfg)
    tparams = bridge.params_from_jax(ref, tcfg, "cpu")
    bs, mb = 8, 8
    nblocks = 1 + 2 * mb
    rng = np.random.RandomState(1)
    tables = (rng.permutation(nblocks - 1)[: 2 * mb] + 1).reshape(2, mb).astype(np.int32)
    tables[1, 4:] = 0  # null-block tail
    jpool = jgen.init_kv_cache(jcfg, nblocks, bs)
    tpool = tgen.init_kv_cache(tcfg, nblocks, bs, "cpu")
    steps = [
        (rng.randint(1, 97, (2, 12)), np.asarray([0, 5], np.int32)),   # prefill chunk
        (rng.randint(1, 97, (2, 1)), np.asarray([12, 17], np.int32)),  # decode step
    ]
    for tokens, offsets in steps:
        jlog, jpool = jgen.forward_with_cache_paged(
            ref, jnp.asarray(tokens, jnp.int32), jcfg, jpool, jnp.asarray(tables),
            jnp.asarray(offsets))
        tlog, tpool = tgen.forward_with_cache_paged(
            tparams, torch.from_numpy(tokens), tcfg, tpool, torch.from_numpy(tables),
            torch.from_numpy(offsets))
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=ATOL, rtol=0)
        np.testing.assert_allclose(tpool.k.numpy(), np.asarray(jpool.k), atol=ATOL, rtol=0)
        np.testing.assert_allclose(tpool.v.numpy(), np.asarray(jpool.v), atol=ATOL, rtol=0)


def test_rope_tables_are_bit_identical():
    jcfg, tcfg = _cfgs(None)
    jc, js = jm.rope_tables(jcfg, 64)
    tc, ts = tm.rope_tables(tcfg, 64, "cpu")
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
