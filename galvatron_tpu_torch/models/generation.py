"""KV-cache forward over the paged block pool, and the host sampling
distribution.

Counterpart of ``galvatron_tpu/models/generation.py`` for the serving
slice: ``KVCache``/``init_kv_cache``, the paged forward
(``_layer_with_cache_paged`` + ``forward_with_cache_paged``: scatter the new
k/v into the pool through the block table, attend the materialised context
for a prefill chunk, and run one-query steps through
``ops.flash_attention.paged_decode_attention``), and ``host_probs``.

JAX threads the pool through its jitted steps functionally; here the pool
is updated IN PLACE (indexed assignment into the layer's slice of the
``(L, num_blocks, block_size, kv, hd)`` tensor), which saves a pool-sized
copy per step. The pool is still returned so the call sites read alike.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from galvatron_tpu_torch.models import modeling
from galvatron_tpu_torch.models.modeling import ModelConfig, Params
from galvatron_tpu_torch.ops.flash_attention import paged_decode_attention


#: the full-length rope tables of one (config, length, device), computed on
#: the host once instead of on every decode step
_rope_tables = functools.lru_cache(maxsize=8)(modeling.rope_tables)


class KVCache(NamedTuple):
    """Per-layer key/value tensors, (L, B, max_len, kv_heads, head_dim)."""

    k: torch.Tensor
    v: torch.Tensor


def init_kv_cache(cfg: ModelConfig, batch_size: int, max_len: int, device) -> KVCache:
    shape = (cfg.num_layers, batch_size, max_len, cfg.kv_heads, cfg.head_dim)
    return KVCache(torch.zeros(shape, dtype=cfg.dtype, device=device),
                   torch.zeros(shape, dtype=cfg.dtype, device=device))


def _layer_with_cache_paged(x, p, cfg: ModelConfig, pool_k, pool_v, tables,
                            offsets, cos_sin):
    """One decoder layer over the paged pool: ``pool_k``/``pool_v`` are this
    layer's (num_blocks, block_size, kvh, hd) views, ``tables`` is (B,
    max_blocks) int32 and row b's position p lives at
    ``(tables[b, p // bs], p % bs)``. Writes the new k/v into the pool."""
    b, s, _ = x.shape
    bs = pool_k.shape[1]
    smax = tables.shape[1] * bs
    q, k, v = modeling.project_qkv_heads(modeling.norm(x, p["attn_norm"], cfg), p["attn"], cfg)
    cos, sin = cos_sin  # (B, s, hd/2) per-row tables
    q = modeling.apply_rope(q, cos, sin)
    k = modeling.apply_rope(k, cos, sin)
    # scatter the new k/v through the table (duplicate targets only arise on
    # the null block, whose contents are never attended)
    pos = offsets.long()[:, None] + torch.arange(s, device=x.device)[None]
    blk = torch.gather(tables.long(), 1, pos // bs)
    sub = pos % bs
    pool_k[blk, sub] = k.to(pool_k.dtype)
    pool_v[blk, sub] = v.to(pool_v.dtype)
    if s == 1:
        # decode step: the kernel reads pages through the table
        o = paged_decode_attention(q, pool_k, pool_v, tables, offsets)
    else:
        # prefill chunk: materialise the row's context, einsum attention
        idx = tables.long()
        k_ctx = pool_k[idx].reshape(b, smax, *pool_k.shape[2:])
        v_ctx = pool_v[idx].reshape(b, smax, *pool_v.shape[2:])
        o = modeling.attention_xla(q, k_ctx, v_ctx, cfg, q_offset=offsets)
    x = x + modeling.attn_output(o, p["attn"], cfg)
    return x + modeling.mlp_block(modeling.norm(x, p["mlp_norm"], cfg), p["mlp"], cfg)


def forward_with_cache_paged(params: Params, tokens, cfg: ModelConfig,
                             pool: KVCache, tables, offsets):
    """Run ``tokens`` (B, s) with per-row positions ``offsets`` (B,) int32,
    reading and writing K/V through ``tables`` (B, max_blocks) int32 in the
    block ``pool`` (L, num_blocks, block_size, kvh, hd). Returns
    ``(logits (B, s, V), pool)``; the pool is updated in place."""
    s = tokens.shape[1]
    smax = tables.shape[1] * pool.k.shape[2]
    cos_all, sin_all = _rope_tables(cfg, smax, tokens.device)
    pos = offsets.long()[:, None] + torch.arange(s, device=tokens.device)[None]
    cos_sin = (cos_all[pos], sin_all[pos])
    x = modeling.embed(tokens, params)
    for i, lp in enumerate(params["layers"]):
        x = _layer_with_cache_paged(x, lp, cfg, pool.k[i], pool.v[i], tables, offsets, cos_sin)
    x = modeling.norm(x, params["final_norm"], cfg)
    return modeling.lm_head(x, params), pool


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
