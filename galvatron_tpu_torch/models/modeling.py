"""Decoder-only LLaMA-family Transformer in plain PyTorch tensor functions.

Counterpart of ``galvatron_tpu/models/modeling.py``, limited to what the
serving slice runs: RoPE (rotate-half), RMSNorm, SwiGLU, the fused QKV
projection in both stored layouts (blocked ``(h, 3, n·hd)`` for MHA,
kv-group-interleaved ``(h, kv·(npg+2)·hd)`` for GQA), the masked-softmax
einsum attention, embedding and LM head.

Parameters are a nested dict of tensors with the JAX package's names and
layouts (``x @ W`` everywhere), so the weight bridge (``bridge.py``) is a
plain copy. Matmul weights and the embedding are stored in the compute
dtype (cast once at load by :func:`cast_params`, which gives the values
JAX's per-use ``astype`` gives); norm scales stay fp32, as ``_norm_impl``
reads them.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Params = Dict[str, Any]


@dataclass(frozen=True)
class ModelConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: Optional[int] = None  # None → MHA; < num_heads → GQA
    ffn_dim: Optional[int] = None  # None → llama 8h/3 rounding
    max_seq_len: int = 2048
    pos_embed: str = "rope"
    norm_type: str = "rms"
    act_fn: str = "swiglu"
    tie_word_embeddings: bool = False
    use_bias: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    causal: bool = True
    moe_experts: int = 0
    dtype: torch.dtype = torch.bfloat16  # compute dtype
    param_dtype: torch.dtype = torch.float32

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def qkv_blocked(self) -> bool:
        """Fused-QKV weight layout: blocked (h, 3, n·hd) without GQA, else
        kv-group interleaved (see :func:`qkv_dims`)."""
        return self.kv_heads == self.num_heads

    @property
    def ffn(self) -> int:
        if self.ffn_dim is not None:
            return self.ffn_dim
        f = int(2 * 4 * self.hidden_size / 3)
        return (f + 255) // 256 * 256

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


#: the families the port does not run yet, each with the config field that
#: selects it and the value the port supports
_UNPORTED = (
    ("pos_embed", "rope", "learned/alibi positions"),
    ("norm_type", "rms", "layernorm"),
    ("act_fn", "swiglu", "gelu/relu MLPs"),
    ("use_bias", False, "projection biases"),
    ("tie_word_embeddings", False, "tied embeddings"),
    ("moe_experts", 0, "mixture-of-experts MLPs"),
    ("causal", True, "bidirectional encoders"),
)


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a family the port does not run yet
    (ROADMAP.md §1, "Other model families")."""
    for field, ported, what in _UNPORTED:
        if getattr(cfg, field) != ported:
            raise NotImplementedError(
                f"{field}={getattr(cfg, field)!r} ({what}) is not ported yet: "
                "ROADMAP.md §1 'Other model families'; the port runs the "
                "LLaMA family (rope, rms, swiglu, no biases, untied head)"
            )


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def qkv_dims(cfg: ModelConfig) -> Tuple[int, int]:
    """(kv groups, per-group width) of the fused QKV projection in the GQA
    (interleaved) layout: group g holds its n/kv query heads, then its k
    head, then its v head."""
    group = (cfg.num_heads // cfg.kv_heads + 2) * cfg.head_dim
    return cfg.kv_heads, group


def init_model_params(cfg: ModelConfig, seed: int, device) -> Params:
    """Random weights with the reference's distributions (normal·0.02
    embedding, uniform ±1/sqrt(fan_in) projections, unit norm scales) in
    ``cfg.param_dtype``, drawn on ``device`` from one ``torch.Generator``.
    The numbers differ from ``jax.random``'s; tests that compare the two
    packages share weights through ``bridge.params_from_jax`` instead."""
    check_supported(cfg)
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    h, hd, pd = cfg.hidden_size, cfg.head_dim, cfg.param_dtype

    def dense(fan_in, fan_out):
        scale = 1.0 / math.sqrt(fan_in)
        w = torch.empty((fan_in, fan_out), dtype=pd, device=device)
        return w.uniform_(-scale, scale, generator=gen)

    def ones():
        return torch.ones((h,), dtype=pd, device=device)

    tok = torch.randn((cfg.vocab_size, h), dtype=pd, device=device, generator=gen)
    params: Params = {"embed": {"tok": tok.mul_(0.02)}, "layers": []}
    kv, group = qkv_dims(cfg)
    for _ in range(cfg.num_layers):
        wqkv = dense(h, kv * group)
        if cfg.qkv_blocked:
            wqkv = wqkv.reshape(h, 3, cfg.num_heads * hd)
        params["layers"].append({
            "attn_norm": {"scale": ones()},
            "attn": {"wqkv": wqkv, "wo": dense(cfg.num_heads * hd, h)},
            "mlp_norm": {"scale": ones()},
            "mlp": {"w13": dense(h, 2 * cfg.ffn), "w2": dense(cfg.ffn, h)},
        })
    params["final_norm"] = {"scale": ones()}
    params["head"] = {"w": dense(h, cfg.vocab_size)}
    return params


def cast_params(params: Params, cfg: ModelConfig) -> Params:
    """Matmul weights and the embedding to ``cfg.dtype``, once, IN PLACE in
    the dict tree; norm scales stay as they are (fp32). Casting
    ``param_dtype`` weights once gives the same values as the reference's
    per-use ``astype(x.dtype)``. Each cast replaces its source entry as it
    goes, so a full-size model never holds two full copies. Returns
    ``params``."""
    for key, val in params.items():
        if isinstance(val, dict):
            cast_params(val, cfg)
        elif isinstance(val, list):
            for v in val:
                cast_params(v, cfg)
        elif key != "scale":
            params[key] = val.to(cfg.dtype)
    return params


# ---------------------------------------------------------------------------
# Forward pieces
# ---------------------------------------------------------------------------


def qkv_project(x, w, cfg: ModelConfig):
    """Fused QKV GEMM: blocked weights (h, 3, n·hd) give (…, 3, n·hd),
    interleaved weights (h, kv·group) give (…, kv·group)."""
    if cfg.qkv_blocked:
        y = x @ w.reshape(w.shape[0], -1)
        return y.reshape(*x.shape[:-1], 3, w.shape[-1])
    return x @ w


def split_qkv(qkv, cfg: ModelConfig):
    """Fused projection → q (…, n, hd), k/v (…, kv, hd)."""
    if cfg.qkv_blocked:
        r = qkv.reshape(*qkv.shape[:-2], 3, cfg.num_heads, cfg.head_dim)
        return r[..., 0, :, :], r[..., 1, :, :], r[..., 2, :, :]
    kv, _ = qkv_dims(cfg)
    npg = cfg.num_heads // cfg.kv_heads
    r = qkv.reshape(*qkv.shape[:-1], kv, npg + 2, cfg.head_dim)
    q = r[..., :npg, :].reshape(*qkv.shape[:-1], cfg.num_heads, cfg.head_dim)
    return q, r[..., npg, :], r[..., npg + 1, :]


def project_qkv_heads(x, p_attn, cfg: ModelConfig):
    return split_qkv(qkv_project(x, p_attn["wqkv"], cfg), cfg)


def attn_output(o, p_attn, cfg: ModelConfig):
    """(B, S, n, hd) attention context → (B, S, h)."""
    b, s = o.shape[:2]
    return o.reshape(b, s, cfg.num_heads * cfg.head_dim) @ p_attn["wo"]


def norm(x, p, cfg: ModelConfig):
    """RMSNorm in fp32, cast back to the input dtype (the reference's
    ``_norm_impl``; its Pallas ``fused_norm`` path is opt-in and not on
    this slice)."""
    x32 = x.float()
    x32 = x32 * torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + cfg.norm_eps)
    return (x32 * p["scale"].float()).to(x.dtype)


def rope_tables(cfg: ModelConfig, seq_len: int, device, offset: int = 0):
    """(cos, sin) of shape (seq_len, hd/2), fp32, computed in float64 on the
    host like the reference so the tables are bit-identical."""
    pos = np.arange(offset, offset + seq_len)
    inv = 1.0 / (cfg.rope_theta ** (np.arange(0, cfg.head_dim, 2) / cfg.head_dim))
    freqs = np.outer(pos, inv)
    cos = torch.from_numpy(np.cos(freqs).astype(np.float32)).to(device)
    sin = torch.from_numpy(np.sin(freqs).astype(np.float32)).to(device)
    return cos, sin


def apply_rope(x, cos, sin):
    """x: (B, S, n, hd), rotate-half. ``cos``/``sin`` are (S, hd/2) shared
    tables or (B, S, hd/2) per-row tables."""
    dt = x.dtype
    x = x.float()
    x1, x2 = x.chunk(2, dim=-1)
    if cos.dim() == 3:
        c, s = cos[:, :, None, :], sin[:, :, None, :]
    else:
        c, s = cos[None, :, None, :], sin[None, :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(dt)


def _repeat_kv(x, n_rep: int):
    """(b, s, kv, hd) → (b, s, kv·n_rep, hd), kv-major like the reference."""
    if n_rep == 1:
        return x
    b, s, kvh, hd = x.shape
    return x[:, :, :, None, :].expand(b, s, kvh, n_rep, hd).reshape(b, s, kvh * n_rep, hd)


def attention_xla(q, k, v, cfg: ModelConfig, q_offset):
    """Causal einsum attention (the reference's ``attention_xla``): k/v may
    be longer than q; query i of row b sits at absolute position
    ``q_offset[b] + i`` and sees keys at positions <= its own. Scores and
    softmax in fp32 with the -1e30 mask, probabilities cast to the compute
    dtype before the PV product. One-query calls go to the GQA-native
    ``decode_attention`` as in the reference."""
    b, s, nh, hd = q.shape
    offsets = torch.as_tensor(q_offset, device=q.device).reshape(-1)
    if s == 1:
        from galvatron_tpu_torch.ops.flash_attention import decode_attention

        return decode_attention(q, k, v, q_offset=offsets)
    k = _repeat_kv(k, nh // k.shape[2])
    v = _repeat_kv(v, nh // v.shape[2])
    scores = torch.einsum("bqnh,bknh->bnqk", q, k).float() / math.sqrt(hd)
    q_pos = offsets[:, None] + torch.arange(s, device=q.device)[None]
    k_pos = torch.arange(k.shape[1], device=q.device)
    allowed = k_pos[None, None, :] <= q_pos[:, :, None]
    scores = scores.masked_fill(~allowed[:, None], -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bnqk,bknh->bqnh", probs, v)


def mlp_block(x, p, cfg: ModelConfig):
    """SwiGLU over the fused [w1 | w3] gate projection."""
    f = p["w13"].shape[-1] // 2
    g = x @ p["w13"]
    return (F.silu(g[..., :f]) * g[..., f:]) @ p["w2"]


def embed(tokens, params):
    return params["embed"]["tok"][tokens]


def lm_head(x, params):
    return x @ params["head"]["w"]


# Preset configs of the LLaMA family (the reference's PRESETS, same sizes)
PRESETS: Dict[str, ModelConfig] = {
    "llama-0.3b": ModelConfig(
        vocab_size=32000, hidden_size=1024, num_layers=24, num_heads=16, max_seq_len=2048
    ),
    "llama-7b": ModelConfig(
        vocab_size=32000, hidden_size=4096, num_layers=32, num_heads=32,
        ffn_dim=11008, max_seq_len=2048,
    ),
    "llama-13b": ModelConfig(
        vocab_size=32000, hidden_size=5120, num_layers=40, num_heads=40,
        ffn_dim=13824, max_seq_len=2048,
    ),
    "llama-30b": ModelConfig(
        vocab_size=32000, hidden_size=6656, num_layers=60, num_heads=52,
        ffn_dim=17920, max_seq_len=2048,
    ),
}
