"""Autoregressive generation over a KV cache: the contiguous, slot-wise and
paged cache forwards, sampling, and the lockstep generation loop.

Counterpart of ``galvatron_tpu/models/generation.py``:

- ``forward_with_cache`` (one scalar offset for the whole batch: the
  generation loop and the slot engine's prefill of one row),
  ``forward_with_cache_slots`` (per-row offsets: the slot engine's decode
  step) and ``forward_with_cache_paged`` (K/V addressed through block tables
  in a shared pool; one-query steps through
  ``ops.flash_attention.paged_decode_attention``, the hand-written kernel on
  the card);
- ``filter_logits`` / ``sample_logits`` (temperature, top-k, nucleus) and
  ``host_probs``, their float64 host mirror for the serving engine;
- ``generate`` (prefill, then one token a step; prompt tokens override
  sampled ones until each row's own length) and ``generate_np`` (lists of
  token ids in and out, with the reference's length bucketing).

Every family training runs is served: rope, learned or ALiBi positions
(per-row absolute positions ``offsets[:, None] + arange(s)``), rms or
layernorm, swiglu / gelu / relu, biases and a tied head. ALiBi adds
``slope · (k − q)`` at those positions to every cache forward's einsum
attention; its paged decode steps take the gathered einsum attention, not
the ``paged_decode`` kernel (the reference's routing: the kernel only
without a bias). :data:`decode_routes` counts which route each paged decode
step took.

JAX threads caches through its jitted steps functionally; here they are
updated IN PLACE (indexed assignment into the layer's slice of the
``(L, B, max_len, kv, hd)`` cache or ``(L, num_blocks, block_size, kv, hd)``
pool), which saves a cache-sized copy per step; the cache is still returned
so the call sites read alike. The reference runs the generation loop as one
``lax.scan`` inside ``jit``; here it is a Python loop over the same
forwards, and sampling draws from a ``torch.Generator`` (the same
distribution, other tokens than ``jax.random``'s).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from galvatron_tpu_torch.models import modeling
from galvatron_tpu_torch.models.modeling import ModelConfig, Params
from galvatron_tpu_torch.ops.flash_attention import paged_decode_attention

#: the full-length rope tables of one (config, length, device), computed on
#: the host once instead of on every decode step
_rope_tables = functools.lru_cache(maxsize=8)(modeling.rope_tables)

#: paged decode steps (one-token forwards of ``forward_with_cache_paged``) by
#: the attention route they took: the ``paged_decode`` kernel, or the
#: gathered einsum attention (ALiBi)
decode_routes = {"paged_decode": 0, "einsum": 0}


def reset_decode_routes() -> None:
    for k in decode_routes:
        decode_routes[k] = 0


class KVCache(NamedTuple):
    """Per-layer key/value tensors, (L, B, max_len, kv_heads, head_dim)."""

    k: torch.Tensor
    v: torch.Tensor


def init_kv_cache(cfg: ModelConfig, batch_size: int, max_len: int, device) -> KVCache:
    shape = (cfg.num_layers, batch_size, max_len, cfg.kv_heads, cfg.head_dim)
    return KVCache(torch.zeros(shape, dtype=cfg.dtype, device=device),
                   torch.zeros(shape, dtype=cfg.dtype, device=device))


# ---------------------------------------------------------------------------
# pieces the three cache forwards share
# ---------------------------------------------------------------------------


def _positions(offsets, s: int, device):
    """(B or 1, s) absolute positions ``offsets[:, None] + arange(s)``;
    ``offsets`` is a (B,) tensor or a scalar (one row, broadcast)."""
    off = torch.as_tensor(offsets, device=device).long().reshape(-1)
    return off[:, None] + torch.arange(s, device=device)[None]


def _embed_and_rope(params, tokens, cfg: ModelConfig, pos, table_len: int):
    """Token embedding plus learned positions at ``pos``, and the per-row
    rope tables at ``pos`` (None without RoPE)."""
    x = modeling.embed(tokens, params, cfg, positions=pos)
    if cfg.pos_embed != "rope":
        return x, None
    cos_all, sin_all = _rope_tables(cfg, table_len, tokens.device)
    return x, (cos_all[pos], sin_all[pos])


def _qkv(x, p, cfg: ModelConfig, cos_sin):
    """Pre-norm, the fused projection (+ its bias) split per head, RoPE."""
    q, k, v = modeling.project_qkv_heads(modeling.norm(x, p["attn_norm"], cfg), p["attn"], cfg)
    if cos_sin is not None:
        q = modeling.apply_rope(q, *cos_sin)
        k = modeling.apply_rope(k, *cos_sin)
    return q, k, v


def _alibi_bias(cfg: ModelConfig, pos, k_len: int, device):
    """The ALiBi bias (B or 1, n, s, k_len) at the absolute query positions
    ``pos`` (None without ALiBi)."""
    slopes = modeling.alibi_tensor(cfg, device)
    return None if slopes is None else modeling.alibi_bias(slopes, pos, k_len)


def _finish_layer(x, o, p, cfg: ModelConfig):
    """Output projection (+ bias) and the MLP block, both residual. An MoE
    block routes by the raw argmax (``train=False``), with its capacity over
    the rows of this forward, as in the reference."""
    x = x + modeling.attn_output(o, p["attn"], cfg)
    return x + modeling.mlp_block(modeling.norm(x, p["mlp_norm"], cfg), p["mlp"], cfg,
                                  train=False)


def _logits(x, params, cfg: ModelConfig):
    return modeling.lm_head(modeling.norm(x, params["final_norm"], cfg), params, cfg)


# ---------------------------------------------------------------------------
# contiguous cache, one offset for every row (generation loop, slot prefill)
# ---------------------------------------------------------------------------


def forward_with_cache(params: Params, tokens, cfg: ModelConfig, cache: KVCache, offset: int):
    """Run ``tokens`` (B, s) at absolute positions ``[offset, offset + s)``,
    writing k/v into ``cache`` (L, B, max_len, kv, hd) there, then attending
    every cached position <= each query's own. Returns ``(logits (B, s, V),
    cache)``; the cache is updated in place (a view of a larger cache, e.g.
    one slot's rows, writes through)."""
    s = tokens.shape[1]
    offset = int(offset)
    pos = _positions(offset, s, tokens.device)
    x, cos_sin = _embed_and_rope(params, tokens, cfg, pos, cache.k.shape[2])
    bias = _alibi_bias(cfg, pos, cache.k.shape[2], tokens.device)
    for i, lp in enumerate(params["layers"]):
        q, k, v = _qkv(x, lp, cfg, cos_sin)
        kc, vc = cache.k[i], cache.v[i]
        kc[:, offset:offset + s] = k.to(kc.dtype)
        vc[:, offset:offset + s] = v.to(vc.dtype)
        o = modeling.attention_xla(q, kc, vc, cfg, q_offset=offset, bias=bias)
        x = _finish_layer(x, o, lp, cfg)
    return _logits(x, params, cfg), cache


# ---------------------------------------------------------------------------
# contiguous cache, every row at its own offset (the slot engine's decode)
# ---------------------------------------------------------------------------


def forward_with_cache_slots(params: Params, tokens, cfg: ModelConfig, cache: KVCache,
                             offsets):
    """Run ``tokens`` (B, s) with PER-ROW absolute positions ``offsets``
    (B,) int32, writing row b's k/v at ``offsets[b]`` of its own cache row.
    Returns ``(logits (B, s, V), cache)``; the cache is updated in place.

    Rows holding no request run at offset 0: their write lands at position
    0 of their own free slot, and the next prefill of that slot overwrites
    it before any query can attend it; causal masking keeps positions past
    a row's own offset invisible."""
    b, s = tokens.shape
    pos = _positions(offsets, s, tokens.device)
    x, cos_sin = _embed_and_rope(params, tokens, cfg, pos, cache.k.shape[2])
    bias = _alibi_bias(cfg, pos, cache.k.shape[2], tokens.device)
    rows = torch.arange(b, device=tokens.device)[:, None]
    for i, lp in enumerate(params["layers"]):
        q, k, v = _qkv(x, lp, cfg, cos_sin)
        kc, vc = cache.k[i], cache.v[i]
        kc[rows, pos] = k.to(kc.dtype)
        vc[rows, pos] = v.to(vc.dtype)
        o = modeling.attention_xla(q, kc, vc, cfg, q_offset=offsets, bias=bias)
        x = _finish_layer(x, o, lp, cfg)
    return _logits(x, params, cfg), cache


# ---------------------------------------------------------------------------
# paged pool (serving/paged_kv.py owns the pool and the host allocator)
# ---------------------------------------------------------------------------


def _layer_with_cache_paged(x, p, cfg: ModelConfig, pool_k, pool_v, tables, offsets, pos,
                            cos_sin, bias=None):
    """One decoder layer over the paged pool: ``pool_k``/``pool_v`` are this
    layer's (num_blocks, block_size, kvh, hd) views, ``tables`` is (B,
    max_blocks) int32 and row b's position p lives at
    ``(tables[b, p // bs], p % bs)``. Writes the new k/v into the pool. With
    an ALiBi ``bias`` every step, decode included, attends through the
    gathered context (the reference's routing)."""
    b, s, _ = x.shape
    bs = pool_k.shape[1]
    smax = tables.shape[1] * bs
    q, k, v = _qkv(x, p, cfg, cos_sin)
    # scatter the new k/v through the table (duplicate targets only arise on
    # the null block, whose contents are never attended)
    blk = torch.gather(tables.long(), 1, pos // bs)
    sub = pos % bs
    pool_k[blk, sub] = k.to(pool_k.dtype)
    pool_v[blk, sub] = v.to(pool_v.dtype)
    if s == 1 and bias is None:
        # decode step: the kernel reads pages through the table (q is a
        # strided view of the blocked GPT projection; the kernel takes it
        # contiguous)
        o = paged_decode_attention(q.contiguous(), pool_k, pool_v, tables, offsets)
    else:
        # prefill chunk (or ALiBi): materialise the row's context, einsum
        # attention
        idx = tables.long()
        k_ctx = pool_k[idx].reshape(b, smax, *pool_k.shape[2:])
        v_ctx = pool_v[idx].reshape(b, smax, *pool_v.shape[2:])
        o = modeling.attention_xla(q, k_ctx, v_ctx, cfg, q_offset=offsets, bias=bias)
    return _finish_layer(x, o, p, cfg)


def forward_with_cache_paged(params: Params, tokens, cfg: ModelConfig,
                             pool: KVCache, tables, offsets):
    """Run ``tokens`` (B, s) with per-row positions ``offsets`` (B,) int32,
    reading and writing K/V through ``tables`` (B, max_blocks) int32 in the
    block ``pool`` (L, num_blocks, block_size, kvh, hd). Returns
    ``(logits (B, s, V), pool)``; the pool is updated in place."""
    s = tokens.shape[1]
    smax = tables.shape[1] * pool.k.shape[2]
    pos = _positions(offsets, s, tokens.device)
    x, cos_sin = _embed_and_rope(params, tokens, cfg, pos, smax)
    bias = _alibi_bias(cfg, pos, smax, tokens.device)
    if s == 1:
        decode_routes["paged_decode" if bias is None else "einsum"] += 1
    for i, lp in enumerate(params["layers"]):
        x = _layer_with_cache_paged(x, lp, cfg, pool.k[i], pool.v[i], tables, offsets, pos,
                                    cos_sin, bias)
    return _logits(x, params, cfg), pool


# ---------------------------------------------------------------------------
# Sampling (reference: megatron/text_generation/sampling.py)
# ---------------------------------------------------------------------------


def filter_logits(logits, temperature: float = 1.0, top_k: int = 0, top_p: float = 0.0):
    """The fp32 logits ``sample_logits`` draws from: scaled by the
    temperature (when > 0), then ``-inf`` below the k-th largest (top-k) and
    outside the nucleus (the smallest prefix of the sorted distribution
    whose cumulative probability reaches ``top_p``, always >= 1 token)."""
    t = float(temperature)
    scaled = logits.float() / (t if t > 0 else 1.0)
    if top_k > 0:
        kth = torch.topk(scaled, top_k, dim=-1).values[..., -1:]
        scaled = scaled.masked_fill(scaled < kth, -torch.inf)
    if top_p > 0:
        sorted_logits = torch.sort(scaled, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep = cum - probs < top_p
        threshold = torch.where(keep, sorted_logits, torch.inf).amin(dim=-1, keepdim=True)
        scaled = scaled.masked_fill(scaled < threshold, -torch.inf)
    return scaled


def sample_logits(logits, temperature: float = 1.0, top_k: int = 0, top_p: float = 0.0,
                  generator: Optional[torch.Generator] = None):
    """logits: (B, V) → token ids (B,). temperature <= 0 is greedy (the
    argmax, no draw); otherwise one draw per row from
    :func:`filter_logits`'s distribution with ``generator``."""
    if temperature <= 0:
        return logits.float().argmax(dim=-1)
    probs = torch.softmax(filter_logits(logits, temperature, top_k, top_p), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def host_probs(logits, temperature: float, top_k: int, top_p: float):
    """Host-side (numpy, float64) processed sampling distribution over ONE
    position: temperature scaling, top-k filter, nucleus cutoff (smallest
    prefix with cumulative prob >= top_p, always >= 1 token) → normalized
    probabilities (V,). Greedy (temperature <= 0) is a one-hot argmax."""
    logits = np.asarray(logits, np.float64)
    p = np.zeros_like(logits)
    if temperature <= 0:
        p[np.argmax(logits)] = 1.0
        return p
    scaled = logits / temperature
    if top_k > 0:
        kth = np.sort(scaled)[-min(top_k, len(scaled))]
        scaled = np.where(scaled < kth, -np.inf, scaled)
    if top_p > 0:
        sorted_logits = np.sort(scaled)[::-1]
        shifted = sorted_logits - sorted_logits[0]
        probs = np.exp(shifted) / np.exp(shifted).sum()
        cum = np.cumsum(probs)
        keep = cum - probs < top_p
        threshold = sorted_logits[keep].min()
        scaled = np.where(scaled < threshold, -np.inf, scaled)
    shifted = scaled - scaled.max()
    p = np.exp(shifted)
    return p / p.sum()


# ---------------------------------------------------------------------------
# Generation loop
# ---------------------------------------------------------------------------


#: the reference's refusals of an encoder (or encoder-decoder) model, by
#: what refuses it: its ``generation.generate`` and its serving ``Engine``
NOT_GENERATIVE = {
    "generation": "generation requires a decoder-only causal LM (encoder families "
                  "train with objective='mlm'; enc-dec decode is not implemented)",
    "serving": "serving engine requires a decoder-only causal LM (same "
               "constraint as generation.generate)",
}


def check_generative(cfg: ModelConfig, what: str = "generation") -> None:
    """Raise the reference's ``ValueError`` unless ``cfg`` is a decoder-only
    causal LM: BERT and ViT train, they neither generate nor serve."""
    if not cfg.causal or cfg.objective != "clm" or cfg.enc_layers > 0:
        raise ValueError(NOT_GENERATIVE[what])


@torch.inference_mode()
def generate(params: Params, prompt, prompt_lengths, cfg: ModelConfig,
             generator: Optional[torch.Generator] = None, max_new_tokens: int = 32,
             min_prompt_len: Optional[int] = None, temperature: float = 0.0,
             top_k: int = 0, top_p: float = 0.0, eos_id: int = -1, pad_id: int = 0):
    """Prefill + lockstep decode (the reference's scheme: right-padded
    prompts (B, P), generation starts at ``min_prompt_len``, prompt tokens
    override sampled ones until each row's own prompt is exhausted). Returns
    (B, P + max_new_tokens) int64 on the params' device; positions past a
    row's eos are ``pad_id``."""
    check_generative(cfg)
    device = params["embed"]["tok"].device
    prompt = torch.as_tensor(prompt, device=device).long()
    lengths = torch.as_tensor(prompt_lengths, device=device).long()
    b, p_len = prompt.shape
    if min_prompt_len is None:
        min_prompt_len = p_len
    max_len = p_len + max_new_tokens
    cache = init_kv_cache(cfg, b, max_len, device)
    # prefill positions [0, min_prompt_len); all rows have real tokens there
    logits, _ = forward_with_cache(params, prompt[:, :min_prompt_len], cfg, cache, 0)
    last = logits[:, -1]  # (B, V): the logits at position min_prompt_len - 1
    out = torch.cat([prompt, torch.full((b, max_new_tokens), pad_id, dtype=torch.long,
                                        device=device)], dim=1)
    done = torch.zeros(b, dtype=torch.bool, device=device)
    pad = torch.full_like(out[:, 0], pad_id)
    for i in range(min_prompt_len, max_len):
        sampled = sample_logits(last, temperature, top_k, top_p, generator)
        in_prompt = i < lengths  # teacher-force rows still inside their prompt
        tok = torch.where(in_prompt, out[:, i], torch.where(done, pad, sampled))
        done = done | (~in_prompt & (tok == eos_id))
        out[:, i] = tok
        if i < max_len - 1:  # the last step has nothing left to predict
            logits, _ = forward_with_cache(params, tok[:, None], cfg, cache, i)
            last = logits[:, 0]
    return out


def generate_np(params, cfg: ModelConfig, prompts, length_bucket: int = 64,
                generator: Optional[torch.Generator] = None, seed: int = 0, **kw):
    """Lists of token ids → padded batch → :func:`generate` → lists of token
    ids (each row's prompt, then its completion up to eos).

    The prompt length is padded UP and ``min_prompt_len`` rounded DOWN to
    multiples of ``length_bucket`` (the reference's jit-cache buckets); that
    decides which positions are prefilled together, so it is kept exactly.
    Without ``generator`` one is seeded with ``seed`` on the params'
    device."""
    lengths = np.asarray([len(p) for p in prompts], np.int32)
    if int(lengths.min()) < 1:
        raise ValueError("empty prompt")
    max_new = kw.get("max_new_tokens", 32)
    p_raw = int(lengths.max())
    if p_raw + max_new > cfg.max_seq_len:
        raise ValueError(
            f"prompt ({p_raw}) + max_new_tokens ({max_new}) exceeds "
            f"max_seq_len {cfg.max_seq_len}"
        )
    # pad up to the bucket when the seq-len window allows it
    p_len = min(-(-p_raw // length_bucket) * length_bucket,
                max(p_raw, cfg.max_seq_len - max_new))
    pad_id = kw.get("pad_id", 0)
    batch = np.full((len(prompts), p_len), pad_id, np.int64)
    for i, p in enumerate(prompts):
        batch[i, : len(p)] = p
    if generator is None:
        generator = torch.Generator(device=params["embed"]["tok"].device).manual_seed(seed)
    min_len = max(1, int(lengths.min()) // length_bucket * length_bucket)
    out = generate(params, torch.from_numpy(batch), torch.from_numpy(lengths), cfg,
                   generator, min_prompt_len=min_len, **kw).cpu().numpy()
    eos_id = kw.get("eos_id", -1)
    res = []
    for i, row in enumerate(out):
        toks = row[: lengths[i]].tolist()
        for t in row[lengths[i]: lengths[i] + max_new]:
            if t == eos_id:
                break
            toks.append(int(t))
        res.append(toks)
    return res
