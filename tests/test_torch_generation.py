"""The port's KV-cache generation against the JAX package at fp32 on the CPU:
the contiguous and slot-wise cache forwards (logits and the written cache)
for the LLaMA, GPT (gelu) and OPT (relu) families, greedy ``generate`` and
``generate_np`` token for token (and against the port's own uncached greedy),
ragged prompts, eos, the length bucketing, the sampling filters, and ``cli
generate``. The shapes of the reference's ``tests/test_generation.py``:
vocab 97, h 64, 2 layers, 4 heads, max_seq_len 64."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from galvatron_tpu.models import generation as jgen
from galvatron_tpu.models import modeling as jm
from galvatron_tpu_torch import bridge, cli
from galvatron_tpu_torch.models import generation as tgen
from galvatron_tpu_torch.models import modeling as tm

# fp32 on both sides, matmuls summed in other orders: logits and cache
# entries within 1e-5
ATOL = 1e-5

SHAPE = dict(vocab_size=97, hidden_size=64, num_layers=2, num_heads=4, ffn_dim=128,
             max_seq_len=64)
GPT_FAMILY = dict(pos_embed="learned", norm_type="layernorm", use_bias=True,
                  tie_word_embeddings=True)
FAMILIES = {
    "llama": dict(num_kv_heads=2),  # rope, rms, swiglu, GQA
    "gpt": dict(GPT_FAMILY, act_fn="gelu"),
    "opt": dict(GPT_FAMILY, act_fn="relu"),
}


def _cfgs(family):
    kw = dict(SHAPE, **FAMILIES[family])
    return jm.ModelConfig(dtype=jnp.float32, **kw), tm.ModelConfig(dtype=torch.float32, **kw)


def _params(jcfg, seed=0):
    """The JAX init (numpy leaves) with biases and norm parameters redrawn
    from a seed, so their paths are exercised; the port gets the same
    arrays through the bridge."""
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


@pytest.fixture(scope="module", params=list(FAMILIES))
def family(request):
    jcfg, tcfg = _cfgs(request.param)
    jp = _params(jcfg)
    return request.param, jcfg, tcfg, jp, bridge.params_from_jax(jp, tcfg, "cpu")


def _random_cache(jcfg, tcfg, b, max_len, seed):
    """The same random cache on both sides: stale entries a forward must
    not attend (past each query's position) are nonzero."""
    shape = (jcfg.num_layers, b, max_len, jcfg.kv_heads, jcfg.head_dim)
    rng = np.random.RandomState(seed)
    k, v = rng.randn(*shape).astype(np.float32), rng.randn(*shape).astype(np.float32)
    return (jgen.KVCache(jnp.asarray(k), jnp.asarray(v)),
            tgen.KVCache(torch.from_numpy(k.copy()), torch.from_numpy(v.copy())))


def _assert_cache(tcache, jcache):
    np.testing.assert_allclose(tcache.k.numpy(), np.asarray(jcache.k), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tcache.v.numpy(), np.asarray(jcache.v), atol=ATOL, rtol=0)


def test_forward_with_cache_matches_jax(family):
    """A 12-token prefill at offset 0, a one-token step at 12 and a 5-token
    chunk at 13 over one cache: logits and every cache entry within 1e-5."""
    _, jcfg, tcfg, jp, tp = family
    jcache, tcache = _random_cache(jcfg, tcfg, 2, 32, seed=1)
    rng = np.random.RandomState(2)
    for s, offset in ((12, 0), (1, 12), (5, 13)):
        tokens = rng.randint(1, 97, (2, s))
        jlog, jcache = jgen.forward_with_cache(jp, jnp.asarray(tokens, jnp.int32), jcfg,
                                               jcache, offset)
        tlog, tcache = tgen.forward_with_cache(tp, torch.from_numpy(tokens), tcfg, tcache,
                                               offset)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=ATOL, rtol=0)
        _assert_cache(tcache, jcache)


def test_forward_with_cache_slots_matches_jax(family):
    """Every row at its own offset (one at 0, the engine's inactive row),
    one-token steps and a 3-token window: logits and cache within 1e-5."""
    _, jcfg, tcfg, jp, tp = family
    jcache, tcache = _random_cache(jcfg, tcfg, 3, 32, seed=3)
    rng = np.random.RandomState(4)
    for s, offsets in ((1, [0, 7, 20]), (1, [1, 8, 31]), (3, [2, 9, 28])):
        tokens = rng.randint(1, 97, (3, s))
        offs = np.asarray(offsets, np.int32)
        jlog, jcache = jgen.forward_with_cache_slots(
            jp, jnp.asarray(tokens, jnp.int32), jcfg, jcache, jnp.asarray(offs))
        tlog, tcache = tgen.forward_with_cache_slots(
            tp, torch.from_numpy(tokens), tcfg, tcache, torch.from_numpy(offs))
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=ATOL, rtol=0)
        _assert_cache(tcache, jcache)


def test_slotwise_forward_matches_scalar_offset(family):
    """At uniform offsets the slot-wise forward is the scalar one."""
    _, jcfg, tcfg, _, tp = family
    toks = torch.from_numpy(np.random.RandomState(8).randint(1, 97, (2, 5)))
    a = tgen.init_kv_cache(tcfg, 2, 32, "cpu")
    b = tgen.init_kv_cache(tcfg, 2, 32, "cpu")
    la, _ = tgen.forward_with_cache(tp, toks, tcfg, a, 0)
    lb, _ = tgen.forward_with_cache_slots(tp, toks, tcfg, b, torch.zeros(2, dtype=torch.int32))
    np.testing.assert_allclose(la.numpy(), lb.numpy(), atol=ATOL, rtol=0)
    np.testing.assert_allclose(a.k.numpy(), b.k.numpy(), atol=ATOL, rtol=0)


def _greedy_uncached(params, cfg, prompt, n_new):
    toks = torch.as_tensor(prompt).long()
    with torch.no_grad():
        for _ in range(n_new):
            nxt = tm.forward(params, toks, cfg)[:, -1].argmax(dim=-1)
            toks = torch.cat([toks, nxt[:, None]], dim=1)
    return toks.numpy()


def test_generate_greedy_matches_jax_and_uncached(family):
    """``generate`` at temperature 0 equals JAX's token for token, and the
    port's own uncached greedy of ``modeling.forward``."""
    _, jcfg, tcfg, jp, tp = family
    prompt = np.random.RandomState(0).randint(1, 97, (2, 7)).astype(np.int32)
    lengths = np.full((2,), 7, np.int32)
    ref = jgen.generate(jp, jnp.asarray(prompt), jnp.asarray(lengths), jcfg,
                        jax.random.key(1), max_new_tokens=6, min_prompt_len=7,
                        temperature=0.0)
    got = tgen.generate(tp, torch.from_numpy(prompt), torch.from_numpy(lengths), tcfg,
                        max_new_tokens=6, min_prompt_len=7, temperature=0.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(got.numpy(), _greedy_uncached(tp, tcfg, prompt, 6))


def test_generate_np_length_buckets_match_jax():
    """A bucket of 4 over prompts of 3, 6 and 10 tokens: the padded length
    rounds up, the prefill length rounds down, and the tokens equal JAX's;
    eos ends a row and pad follows it."""
    jcfg, tcfg = _cfgs("llama")
    jp = _params(jcfg)
    tp = bridge.params_from_jax(jp, tcfg, "cpu")
    rng = np.random.RandomState(5)
    prompts = [rng.randint(1, 97, (n,)).tolist() for n in (3, 6, 10)]
    ref = jgen.generate_np(jp, jcfg, prompts, length_bucket=4, max_new_tokens=7)
    assert tgen.generate_np(tp, tcfg, prompts, length_bucket=4, max_new_tokens=7) == ref
    eos = ref[1][6 + 2]  # the second row's third generated token
    ref_eos = jgen.generate_np(jp, jcfg, prompts, length_bucket=4, max_new_tokens=7,
                               eos_id=eos)
    assert tgen.generate_np(tp, tcfg, prompts, length_bucket=4, max_new_tokens=7,
                            eos_id=eos) == ref_eos
    assert len(ref_eos[1]) <= 6 + 2
    for mod, p, c in ((jgen, jp, jcfg), (tgen, tp, tcfg)):
        with pytest.raises(ValueError, match="exceeds max_seq_len 64"):
            mod.generate_np(p, c, [[1] * 60], max_new_tokens=5)
        with pytest.raises(ValueError, match="empty prompt"):
            mod.generate_np(p, c, [[1], []], max_new_tokens=5)


def test_eos_stops_row():
    jcfg, tcfg = _cfgs("llama")
    tp = bridge.params_from_jax(_params(jcfg), tcfg, "cpu")
    prompt = torch.from_numpy(np.random.RandomState(2).randint(1, 97, (1, 5)))
    eos = int(_greedy_uncached(tp, tcfg, prompt, 1)[0, -1])
    out = tgen.generate(tp, prompt, torch.tensor([5]), tcfg, max_new_tokens=4,
                        min_prompt_len=5, temperature=0.0, eos_id=eos, pad_id=0)
    row = out.numpy()[0, 5:]
    assert row[0] == eos and (row[1:] == 0).all()


def test_generation_refuses_what_is_not_a_causal_lm():
    for kw in (dict(causal=False), dict(objective="mlm"), dict(enc_layers=2)):
        with pytest.raises(ValueError, match="decoder-only causal LM"):
            tgen.generate({"embed": {"tok": torch.zeros(1)}}, torch.ones(1, 2), [2],
                          tm.ModelConfig(**SHAPE).replace(**kw))


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

SAMPLING = [(1.0, 0, 0.0), (0.7, 5, 0.0), (1.3, 0, 0.9), (0.5, 10, 0.8), (2.0, 0, 1.0),
            (1.0, 3, 0.05)]


@pytest.mark.parametrize("temperature,top_k,top_p", SAMPLING)
def test_filter_logits_matches_jax(monkeypatch, temperature, top_k, top_p):
    """The scaled, masked logits the draw is made from: the same -inf set
    as those JAX's ``sample_logits`` hands to ``jax.random.categorical``,
    finite values within 1e-6; ``host_probs`` equals its twin to 1e-12."""
    logits = np.random.RandomState(7).randn(4, 97).astype(np.float32) * 3
    seen = []
    real = jax.random.categorical
    monkeypatch.setattr(jax.random, "categorical",
                        lambda key, x, axis=-1: (seen.append(np.asarray(x)), real(key, x, axis))[1])
    jgen.sample_logits(jax.random.key(0), jnp.asarray(logits), temperature, top_k, top_p)
    ref = seen[0]
    got = tgen.filter_logits(torch.from_numpy(logits), temperature, top_k, top_p).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(ref))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(got[fin], ref[fin], atol=1e-6, rtol=0)
    for row in logits:
        np.testing.assert_allclose(tgen.host_probs(row, temperature, top_k, top_p),
                                   jgen.host_probs(row, temperature, top_k, top_p),
                                   atol=1e-12, rtol=0)


def test_top_k_one_is_greedy_at_any_temperature():
    logits = torch.tensor([[1.0, 4.0, 2.0, 3.0]])
    assert int(tgen.sample_logits(logits, temperature=0.0)[0]) == 1
    for seed in range(8):
        gen = torch.Generator().manual_seed(seed)
        for temp in (0.5, 1.0, 10.0):
            assert int(tgen.sample_logits(logits, temp, top_k=1, generator=gen)[0]) == 1


def test_top_p_tiny_keeps_the_argmax_and_sampling_covers_the_support():
    logits = torch.tensor([[1.0, 2.0, 3.0, 4.0]])
    gen = torch.Generator().manual_seed(0)
    for _ in range(4):
        assert int(tgen.sample_logits(logits, 1.0, top_p=0.05, generator=gen)[0]) == 3
    logits = torch.tensor([[2.0, -1.0, 0.5, 0.0, -3.0]])
    seen = {int(tgen.sample_logits(logits, 5.0, top_p=1.0, generator=gen)[0])
            for _ in range(256)}
    assert seen == set(range(5))


def test_sampled_generate_is_reproducible_from_its_seed():
    jcfg, tcfg = _cfgs("llama")
    tp = bridge.params_from_jax(_params(jcfg), tcfg, "cpu")
    prompts = [[5, 6, 7], [9, 10, 11, 12, 13]]
    runs = [tgen.generate_np(tp, tcfg, prompts, max_new_tokens=8, temperature=1.0,
                             top_k=20, seed=s) for s in (3, 3, 4)]
    assert runs[0] == runs[1] and runs[0] != runs[2]


# ---------------------------------------------------------------------------
# cli generate
# ---------------------------------------------------------------------------


def test_cli_generate_prints_generate_np_json_lines(capsys, tmp_path):
    """``cli generate --device cpu`` (seed-0 weights, byte tokenizer, the
    preset's bf16) prints one JSON line per prompt: the completion that
    ``generate_np`` gives on the same weights; with ``--load_hf`` (a
    directory ``cli export-hf`` wrote from the same flags) the completions
    of the imported weights, which ``--load`` beside it refuses."""
    from galvatron_tpu_torch.models.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    flags = ["--device", "cpu", "--num_layers", "2", "--hidden_size", "64", "--num_heads", "4",
             "--vocab_size", str(tok.vocab_size), "--seq_length", "64", "--max_new_tokens", "6"]
    prompts = ["hello", "a longer prompt"]
    assert cli.main(["generate", *flags, "--prompt", prompts[0], "--prompt", prompts[1]]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.strip().splitlines()]
    cfg = tm.PRESETS["llama-0.3b"].replace(num_layers=2, hidden_size=64, num_heads=4,
                                           vocab_size=tok.vocab_size, max_seq_len=64)
    params = tm.cast_params(tm.init_model_params(cfg, 0, "cpu"), cfg)
    enc = [tok.encode(p) for p in prompts]
    outs = tgen.generate_np(params, cfg, enc, max_new_tokens=6, eos_id=tok.eos_id,
                            pad_id=tok.pad_id, seed=1234)
    assert lines == [{"prompt": p, "completion": tok.decode(o[len(e):])}
                     for p, e, o in zip(prompts, enc, outs)]
    from galvatron_tpu_torch.models.convert import load_hf_checkpoint

    hf = str(tmp_path / "hf")
    assert cli.main(["export-hf", *flags, "--output_dir", hf]) == 0
    capsys.readouterr()
    assert cli.main(["generate", "--device", "cpu", "--max_new_tokens", "6", "--load_hf", hf,
                     "--prompt", prompts[0], "--prompt", prompts[1]]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0] == f"serving HF checkpoint {hf}"
    hf_params, hf_cfg = load_hf_checkpoint(hf)
    for a, b in zip(tm.init_model_params(cfg, 0, "cpu")["layers"][0]["attn"].values(),
                    hf_params["layers"][0]["attn"].values()):
        assert torch.equal(a, b)  # the export of the seed-0 weights, read back bitwise
    outs = tgen.generate_np(tm.cast_params(hf_params, hf_cfg), hf_cfg, enc, max_new_tokens=6,
                            eos_id=tok.eos_id, pad_id=tok.pad_id, seed=1234)
    assert [json.loads(ln) for ln in out[1:]] == [
        {"prompt": p, "completion": tok.decode(o[len(e):])}
        for p, e, o in zip(prompts, enc, outs)]
    with pytest.raises(ValueError, match="mutually exclusive"):
        cli.main(["generate", "--device", "cpu", "--load_hf", hf, "--load", hf])
