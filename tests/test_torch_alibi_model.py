"""ALiBi positions in the port against the JAX package, the single-process
half (split from ``tests/test_torch_alibi.py``, which holds the 8-rank
world, the slopes and the helpers these use, so that the suite's workers
share the two): the loss and gradients (packed rows too), the three cache
forwards and greedy generation, and ``cli profile`` of a baichuan-13b
layer."""

import json

import numpy as np
import pytest
import torch

from test_torch_alibi import ATOL, _cfgs, _loss_and_grads_case, _params
import _torch_threads  # noqa: F401


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_loss_and_gradients_match_jax(attn_impl):
    """fp32 loss and every gradient within 1e-5 of the JAX ``lm_loss``;
    under ``attn_impl='flash'`` too, since ALiBi never takes the flash
    kernels (the reference's rule, ``modeling.py:1056``)."""
    _loss_and_grads_case(packed=False, attn_impl=attn_impl)


def test_packed_loss_and_gradients_match_jax():
    """Packed rows (segment mask with the ALiBi bias): loss and gradients
    within 1e-5 of the JAX package's."""
    _loss_and_grads_case(packed=True, attn_impl="xla")


def test_cache_forwards_match_jax():
    """The contiguous, slot-wise and paged cache forwards: logits within
    1e-5 of the JAX forwards on the same caches, prefill chunks and
    one-token steps; a paged one-token step goes the einsum route and never
    reaches ``paged_decode_attention``."""
    import jax.numpy as jnp

    from galvatron_tpu.models import generation as jgen
    from galvatron_tpu_torch import bridge
    from galvatron_tpu_torch.models import generation as tgen

    jcfg, tcfg = _cfgs(num_layers=2)
    jp = _params(jcfg)
    tp = bridge.params_from_jax(jp, tcfg, "cpu")
    rng = np.random.RandomState(3)
    shape = (2, 3, 32, jcfg.kv_heads, jcfg.head_dim)
    k, v = rng.randn(*shape).astype(np.float32), rng.randn(*shape).astype(np.float32)
    jc, tc = jgen.KVCache(jnp.asarray(k), jnp.asarray(v)), tgen.KVCache(
        torch.from_numpy(k.copy()), torch.from_numpy(v.copy()))
    for s, offset in ((9, 0), (1, 9), (4, 10)):
        toks = rng.randint(1, 128, (3, s))
        jl, jc = jgen.forward_with_cache(jp, jnp.asarray(toks, jnp.int32), jcfg, jc, offset)
        tl, tc = tgen.forward_with_cache(tp, torch.from_numpy(toks), tcfg, tc, offset)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    for s, offs in ((1, [0, 7, 20]), (3, [2, 9, 28])):
        toks = rng.randint(1, 128, (3, s))
        o = np.asarray(offs, np.int32)
        jl, jc = jgen.forward_with_cache_slots(jp, jnp.asarray(toks, jnp.int32), jcfg, jc,
                                               jnp.asarray(o))
        tl, tc = tgen.forward_with_cache_slots(tp, torch.from_numpy(toks), tcfg, tc,
                                               torch.from_numpy(o))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    # paged: 9 blocks of 4 positions, 3 rows of up to 3 blocks each
    pshape = (2, 9, 4, jcfg.kv_heads, jcfg.head_dim)
    pk, pv = rng.randn(*pshape).astype(np.float32), rng.randn(*pshape).astype(np.float32)
    jpool = jgen.KVCache(jnp.asarray(pk), jnp.asarray(pv))
    tpool = tgen.KVCache(torch.from_numpy(pk.copy()), torch.from_numpy(pv.copy()))
    tables = np.asarray([[1, 2, 3], [4, 5, 6], [7, 8, 0]], np.int32)
    real = tgen.paged_decode_attention

    def refuse(*a, **kw):
        raise AssertionError("an ALiBi decode step reached paged_decode_attention")

    tgen.reset_decode_routes()
    tgen.paged_decode_attention = refuse
    try:
        for s, offs in ((5, [0, 0, 0]), (1, [5, 5, 5]), (1, [6, 6, 6]), (2, [7, 3, 7])):
            toks = rng.randint(1, 128, (3, s))
            o = np.asarray(offs, np.int32)
            jl, jpool = jgen.forward_with_cache_paged(
                jp, jnp.asarray(toks, jnp.int32), jcfg, jpool, jnp.asarray(tables),
                jnp.asarray(o))
            tl, tpool = tgen.forward_with_cache_paged(
                tp, torch.from_numpy(toks), tcfg, tpool, torch.from_numpy(tables),
                torch.from_numpy(o))
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    finally:
        tgen.paged_decode_attention = real
    assert tgen.decode_routes == {"paged_decode": 0, "einsum": 2}


def test_greedy_generation_matches_jax_on_every_cache_forward():
    """Greedy tokens token for token: the port's ``generate`` (contiguous
    cache) against the JAX ``generate``, and the serving engine's slot and
    paged backends (the slot-wise and paged forwards) against the JAX
    ``generate_np``."""
    import jax
    import jax.numpy as jnp

    from galvatron_tpu.models import generation as jgen
    from galvatron_tpu_torch import bridge
    from galvatron_tpu_torch.models import generation as tgen
    from galvatron_tpu_torch.serving import Engine

    jcfg, tcfg = _cfgs(num_layers=2, max_seq_len=64)
    jp = _params(jcfg)
    tp = bridge.params_from_jax(jp, tcfg, "cpu")
    prompt = np.random.RandomState(0).randint(1, 128, (2, 7)).astype(np.int32)
    lengths = np.full((2,), 7, np.int32)
    ref = jgen.generate(jp, jnp.asarray(prompt), jnp.asarray(lengths), jcfg, jax.random.key(1),
                        max_new_tokens=6, min_prompt_len=7, temperature=0.0)
    got = tgen.generate(tp, torch.from_numpy(prompt), torch.from_numpy(lengths), tcfg,
                        max_new_tokens=6, min_prompt_len=7, temperature=0.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    rng = np.random.RandomState(2)
    prompts = [rng.randint(1, 128, (n,)).tolist() for n in (5, 11, 3)]
    want = jgen.generate_np(jp, jcfg, prompts, max_new_tokens=8)
    for kv_blocks in (0, -1):
        tgen.reset_decode_routes()
        with Engine(tp, tcfg, device="cpu", num_slots=2, prefill_chunk=4,
                    kv_num_blocks=kv_blocks, kv_block_size=8) as eng:
            outs = eng.generate(prompts, max_new_tokens=8)
        assert [list(o) for o in outs] == want, kv_blocks
        if kv_blocks:
            assert tgen.decode_routes["einsum"] > 0 == tgen.decode_routes["paged_decode"]


def test_cli_profile_runs_a_baichuan13b_layer(tmp_path, capsys):
    """``cli profile`` of the ALiBi family (at a tiny width) measures its
    layers and writes the reference-schema JSONs."""
    from galvatron_tpu_torch import cli

    prefix = str(tmp_path / "p")
    assert cli.main(["profile", "--device", "cpu", "--model_size", "baichuan-13b",
                     "--hidden_size", "64", "--num_heads", "4", "--ffn_dim", "128",
                     "--vocab_size", "128", "--seq_length", "32", "--profile_batch_size", "2",
                     "--mixed_precision", "fp32", "--output_prefix", prefix]) == 0
    out = capsys.readouterr().out
    assert "fwd_ms_per_sample" in out
    for kind in ("computation", "memory"):
        with open(f"{prefix}_{kind}.json") as f:
            assert json.load(f)
