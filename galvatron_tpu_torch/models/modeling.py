"""Transformers in plain PyTorch tensor functions.

Counterpart of ``galvatron_tpu/models/modeling.py``, limited to the
families the port runs: the decoders LLaMA (RoPE, RMSNorm, SwiGLU),
Baichuan (LLaMA's layer with RoPE or ALiBi positions) and GPT/OPT (learned
positions, LayerNorm, tanh-GELU or ReLU, projection biases, tied
embeddings), each with dense or switch-MoE MLPs (``models/moe.py``), and the
bidirectional encoders BERT (the GPT layer with ``causal=False`` and the
masked-LM objective 'mlm': deterministic hash masking, :func:`mlm_positions`)
and ViT (the same layer over patch embeddings, a mean-pooled class head and
the 'cls' objective on pixel ‖ label rows), and the T5-class
encoder-decoder (``enc_layers`` > 0: a bidirectional encoder stack, its
final norm, then decoder layers with cross-attention over that output;
rows of encoder tokens ‖ decoder stream, :func:`forward_encdec`). ALiBi
adds ``slope · (k − q)`` per head to the scores and always takes the einsum
attention, as in the reference (its flash kernels carry no bias). The
fused QKV projection in both stored layouts (blocked ``(h, 3, n·hd)`` for
MHA, kv-group-interleaved ``(h, kv·(npg+2)·hd)`` for GQA), attention on the
einsum path (``attn_impl='xla'``) or the flash kernels (``'flash'``: the
head-major dataflow of ``_attn_block_headmajor``; blocked-causal with RoPE,
grid otherwise, which an encoder's unmasked attention takes), the
``mlp_recompute`` policies, embedding, LM head and the
sum-form token loss. Packed sequences (``pack_sequences``): rows of tokens ‖
segment ids, attention masked within each segment on the einsum path,
positions restarting per segment and labels masked at segment boundaries.
A tensor-parallel layer's projection seams (:func:`_up`, :func:`_down`) run
the plain GEMMs and the region's collectives, or the decomposed collective
matmul of ``ops/collective_matmul.py`` under the plan's ``tp_overlap``.

Parameters are a nested dict of tensors with the JAX package's names and
layouts (``x @ W`` everywhere), so the weight bridge (``bridge.py``) is a
plain copy. Every weight is cast to the compute dtype where it is used
(``w.to(x.dtype)``, the reference's per-use ``astype``): training keeps
fp32 master weights and autograd carries the casts; serving casts them once
at load (:func:`cast_params`), after which the per-use cast is a no-op.
Norm scales and biases stay fp32, as ``_norm_impl`` reads them.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from galvatron_tpu_torch.models import moe

Params = Dict[str, Any]


@dataclass(frozen=True)
class ModelConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: Optional[int] = None  # None → MHA; < num_heads → GQA
    ffn_dim: Optional[int] = None  # None → 4h (gelu/relu) or llama 8h/3 rounding
    max_seq_len: int = 2048
    pos_embed: str = "rope"  # 'rope' | 'learned' | 'alibi'
    norm_type: str = "rms"  # 'rms' | 'layernorm'
    act_fn: str = "swiglu"  # 'swiglu' | 'gelu' (tanh approximation) | 'relu'
    tie_word_embeddings: bool = False
    # GPT-2-style biases on the qkv/out/MLP GEMMs (norm biases come with
    # layernorm); needs the blocked qkv layout (no GQA)
    use_bias: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    causal: bool = True
    moe_experts: int = 0  # switch-MoE MLPs with this many experts (models/moe.py)
    moe_capacity_factor: float = 1.25
    moe_sinkhorn_iters: int = 8
    # the multi-rank MoE layer's groups (``moe.MoEContext``), set per layer
    # by the hybrid runtime; not part of the configuration's identity
    moe_ctx: Optional[Any] = field(default=None, compare=False, hash=False, repr=False)
    # 'clm' next-token LM; 'mlm' masked-LM (BERT: the positions of
    # mlm_positions' hash take the [MASK] id, vocab_size - 1, and carry the
    # loss); 'cls' image classification (ViT: rows of pixels ‖ label)
    objective: str = "clm"
    mlm_mask_rate: float = 0.15
    # the shape fields of the reference's other families, with its
    # decoder-only defaults: the search, the cost model and the plan checker
    # read them (``analysis/plan_check.MODEL_SHAPE_FIELDS``). Swin's stages
    # do not run: a non-default value raises in :func:`check_supported`
    # (ROADMAP.md §1.10).
    # encoder-decoder (T5): enc_layers > 0 encoder layers over enc_seq
    # tokens; a sample row is [encoder tokens (enc_seq) ‖ decoder stream
    # (max_seq_len + 1)], the loss next-token over the decoder stream
    enc_layers: int = 0
    enc_seq: int = 0
    # vision (ViT): image_size > 0 makes a sample a row of image_size² ·
    # num_channels pixel values (0..255, int) ‖ one class label, embedded by
    # patch_size² · num_channels patches through one projection
    image_size: int = 0
    patch_size: int = 16
    num_channels: int = 3
    num_classes: int = 1000
    swin_depths: Tuple[int, ...] = ()
    swin_window: int = 7
    attn_impl: str = "xla"  # 'xla' | 'flash'
    # activation recompute over the MLP/norm/loss regions (the reference's
    # --mlp_recompute): 'policy' saves the (biased) gate projection output
    # once per layer and recomputes the fp32 norm statistics, the activation
    # product and the cross-entropy fp32 cast; 'gate' recomputes only the
    # product; 'off' saves everything autograd saves. All three give the
    # same values.
    mlp_recompute: str = "policy"
    # every norm through the fused kernels of ops/fused_norm.py (the
    # reference's opt-in flag; a config field there too, no CLI flag). The
    # kernels save their own residuals, so under 'policy' the MLP branch
    # leaves the one-region recompute and only the activation product is
    # recomputed.
    fused_norm: bool = False
    # packed-sequence input rows (--pack_sequences; data/packing.py): a
    # sample row is [tokens (S+1) ‖ segment ids (S+1)], documents bin-packed
    # into one row. The model then (a) masks attention across segment
    # boundaries (intra-segment causal), (b) restarts rope / learned
    # positions per segment (positions_from_segments), and (c) masks the
    # loss at segment boundaries and on padding (split_batch). Decoder-only
    # 'clm'; the einsum attention only (the flash kernels carry no segment mask).
    pack_sequences: bool = False
    dtype: torch.dtype = torch.bfloat16  # compute dtype
    param_dtype: torch.dtype = torch.float32

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads

    @property
    def total_layers(self) -> int:
        """Layers carrying a per-layer strategy: encoder + decoder."""
        return self.enc_layers + self.num_layers

    @property
    def grid(self) -> int:
        """Vision: patches per image side at stage 0."""
        return self.image_size // self.patch_size

    @property
    def n_patches(self) -> int:
        return self.grid * self.grid

    @property
    def sample_len(self) -> int:
        """Token length of one training sample (before the +1 label shift)."""
        if self.image_size:
            return self.image_size * self.image_size * self.num_channels
        return self.enc_seq + self.max_seq_len if self.enc_layers else self.max_seq_len

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
        if self.act_fn == "swiglu":
            f = int(2 * 4 * self.hidden_size / 3)
            return (f + 255) // 256 * 256
        return 4 * self.hidden_size

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


#: what the port runs, in training, serving and generation: (config field,
#: the values the port runs, what the other values select); anything else
#: raises naming ROADMAP §1.10
_PORTED = (
    ("pos_embed", ("rope", "learned", "alibi"), "other position schemes"),
    ("norm_type", ("rms", "layernorm"), "other norms"),
    ("act_fn", ("swiglu", "gelu", "relu"), "other MLP activations"),
    ("objective", ("clm", "mlm", "cls"), "other objectives"),
    ("swin_depths", ((),), "Swin models"),
    ("swin_window", (7,), "Swin models"),
)


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a family the port does not run yet
    (ROADMAP.md §1.10): training runs the LLaMA, Baichuan and GPT/OPT
    decoders (rope, learned or ALiBi positions, rms or layernorm, swiglu /
    gelu / relu, biases, tied heads, switch-MoE MLPs), the BERT and ViT
    encoders ('mlm', 'cls') and the T5 encoder-decoder; serving and
    generation refuse the encoders and T5 themselves
    (``generation.check_generative``)."""
    for field, ported, what in _PORTED:
        if getattr(cfg, field) not in ported:
            raise NotImplementedError(
                f"{field}={getattr(cfg, field)!r} ({what}) is not ported yet: "
                "ROADMAP.md §1.10 'Other model families'; the port runs LLaMA, "
                "Baichuan and GPT/OPT decoders, BERT and ViT encoders and the T5 "
                "encoder-decoder"
            )
    if cfg.use_bias and not cfg.qkv_blocked:
        raise ValueError("use_bias needs the blocked qkv layout (no GQA)")
    if cfg.image_size and cfg.image_size % cfg.patch_size:
        raise ValueError(
            f"patch_size {cfg.patch_size} must divide image_size {cfg.image_size}"
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
    """Random weights with the reference's names, shapes and distributions
    (normal·0.02 token and position tables, uniform ±1/sqrt(fan_in)
    projections, unit norm scales, zero biases, no ``head`` when tied) in
    ``cfg.param_dtype``, drawn on ``device`` from one ``torch.Generator``.
    The numbers differ from ``jax.random``'s; tests that compare the two
    packages share weights through ``bridge.params_from_jax`` instead."""
    check_supported(cfg)
    device = torch.device(device)
    # the meta device (shapes only, ``parallel/hybrid.param_shapes``) has no generator
    gen = None if device.type == "meta" else torch.Generator(device=device).manual_seed(int(seed))
    h, hd, pd = cfg.hidden_size, cfg.head_dim, cfg.param_dtype

    def uniform(shape, fan_in):
        scale = 1.0 / math.sqrt(fan_in)
        w = torch.empty(shape, dtype=pd, device=device)
        return w.uniform_(-scale, scale, generator=gen)

    def dense(fan_in, fan_out):
        return uniform((fan_in, fan_out), fan_in)

    def normal(*shape):
        return torch.randn(shape, dtype=pd, device=device, generator=gen).mul_(0.02)

    def zeros(*shape):
        return torch.zeros(shape, dtype=pd, device=device)

    def norm_params():
        p = {"scale": torch.ones((h,), dtype=pd, device=device)}
        if cfg.norm_type == "layernorm":
            p["bias"] = zeros(h)
        return p

    if cfg.image_size:
        # ViT: the patch projection and its learned positions for the
        # embedding, the pooled class head (the reference's
        # ``init_vision_base_params``)
        patch_dim = cfg.patch_size * cfg.patch_size * cfg.num_channels
        params: Params = {"embed": {"proj": dense(patch_dim, h),
                                    "pos": normal(cfg.n_patches, h)}, "layers": []}
    else:
        params = {"embed": {"tok": normal(cfg.vocab_size, h)}, "layers": []}
        if cfg.pos_embed == "learned":
            # one table for both streams of an encoder-decoder
            params["embed"]["pos"] = normal(max(cfg.max_seq_len, cfg.enc_seq), h)
    kv, group = qkv_dims(cfg)
    up = _up_name(cfg)

    def layer(cross: bool):
        wqkv = dense(h, kv * group)
        if cfg.qkv_blocked:
            wqkv = wqkv.reshape(h, 3, cfg.num_heads * hd)
        attn = {"wqkv": wqkv, "wo": dense(cfg.num_heads * hd, h)}
        if cfg.use_bias:
            attn["wqkv_b"] = zeros(3, cfg.num_heads * hd)
            attn["wo_b"] = zeros(h)
        if cfg.moe_experts > 0:
            mlp = moe.init_moe_params(cfg, uniform, normal)
        else:
            width = 2 * cfg.ffn if cfg.act_fn == "swiglu" else cfg.ffn
            mlp = {up: dense(h, width), "w2": dense(cfg.ffn, h)}
            if cfg.use_bias:
                mlp[up + "_b"] = zeros(width)
                mlp["w2_b"] = zeros(h)
        p = {"attn_norm": norm_params(), "attn": attn, "mlp_norm": norm_params(), "mlp": mlp}
        if cross:  # a decoder layer of an encoder-decoder: [k | v] fused
            p["cross_norm"] = norm_params()
            p["cross"] = {"wq": dense(h, cfg.num_heads * hd),
                          "wkv": dense(h, 2 * cfg.kv_heads * hd),
                          "wo": dense(cfg.num_heads * hd, h)}
        return p

    if cfg.enc_layers > 0:
        params["enc_layers"] = [layer(False) for _ in range(cfg.enc_layers)]
        params["enc_final_norm"] = norm_params()
    params["layers"] = [layer(cfg.enc_layers > 0) for _ in range(cfg.num_layers)]
    params["final_norm"] = norm_params()
    if cfg.image_size:
        params["head"] = {"w": dense(h, cfg.num_classes)}
    elif not cfg.tie_word_embeddings:
        params["head"] = {"w": dense(h, cfg.vocab_size)}
    return params


def cast_params(params: Params, cfg: ModelConfig) -> Params:
    """Matmul weights, their biases and the embeddings to ``cfg.dtype``,
    once, IN PLACE in the dict tree; norm scales and biases, and the MoE
    router (whose logits are fp32), stay as they are (fp32). Casting
    ``param_dtype`` weights once gives the same values as the reference's
    per-use ``astype(x.dtype)``. Each cast replaces its source entry as it
    goes, so a full-size model never holds two full copies. Returns
    ``params``."""
    for key, val in params.items():
        if key == "router":
            continue  # the MoE router computes its logits in fp32
        if isinstance(val, dict):
            cast_params(val, cfg)
        elif isinstance(val, list):
            for v in val:
                cast_params(v, cfg)
        elif key not in ("scale", "bias"):
            params[key] = val.to(cfg.dtype)
    return params


def layer_annotations(cfg: ModelConfig, cross: bool = False) -> Params:
    """Logical axes per layer parameter (the reference's): 'tp' = the
    Megatron-sharded dim (column-parallel output / row-parallel input),
    'fsdp' = the dim ZeRO shards, 'ep' = an MoE layer's expert dim
    (``parallel/sharding.py``). ``cross``: an encoder-decoder's decoder
    layer, whose cross-attention ``wq`` / ``wkv`` are column-parallel and
    ``wo`` row-parallel (``wkv``'s TP shard holds its heads' k AND v
    columns: :func:`tp_pairs`)."""
    a: Params = {
        "attn_norm": {"scale": ("fsdp",)},
        "attn": {
            # blocked layout: TP shards the head dim of each q/k/v slot
            "wqkv": ("fsdp", None, "tp") if cfg.qkv_blocked else ("fsdp", "tp"),
            "wo": ("tp", "fsdp"),
        },
        "mlp_norm": {"scale": ("fsdp",)},
    }
    if cfg.use_bias:
        # column-parallel biases shard with their output dim; the
        # row-parallel output bias is added once after the reduction
        a["attn"]["wqkv_b"] = (None, "tp")
        a["attn"]["wo_b"] = ("fsdp",)
    up = _up_name(cfg)
    if cfg.moe_experts > 0:
        a["mlp"] = moe.moe_annotations(cfg)
    else:
        a["mlp"] = {up: ("fsdp", "tp"), "w2": ("tp", "fsdp")}
        if cfg.use_bias:
            a["mlp"][up + "_b"] = ("tp",)
            a["mlp"]["w2_b"] = ("fsdp",)
    if cross:
        a["cross_norm"] = {"scale": ("fsdp",)}
        a["cross"] = {"wq": ("fsdp", "tp"), "wkv": ("fsdp", "tp"), "wo": ("tp", "fsdp")}
    if cfg.norm_type == "layernorm":
        for name in ("attn_norm", "mlp_norm") + (("cross_norm",) if cross else ()):
            a[name]["bias"] = ("fsdp",)
    return a


def model_annotations(cfg: ModelConfig) -> Params:
    """The whole tree's annotations: the embedding (and an untied head) is
    vocab-parallel over its TP axes; a ViT's patch projection and class
    head are column-parallel over them (the reference's
    ``vision_base_annotations``)."""
    if cfg.image_size:
        embed = {"proj": ("fsdp", "tp"), "pos": ("fsdp", None)}
    else:
        embed = {"tok": ("tp", "fsdp")}
        if cfg.pos_embed == "learned":
            embed["pos"] = ("fsdp", None)
    cross = cfg.enc_layers > 0
    a: Params = {
        "embed": embed,
        "layers": [layer_annotations(cfg, cross) for _ in range(cfg.num_layers)],
        "final_norm": {"scale": ("fsdp",)},
    }
    if cross:
        a["enc_layers"] = [layer_annotations(cfg) for _ in range(cfg.enc_layers)]
        a["enc_final_norm"] = {"scale": ("fsdp",)}
    for name in ("final_norm", "enc_final_norm"):
        if cfg.norm_type == "layernorm" and name in a:
            a[name]["bias"] = ("fsdp",)
    if cfg.image_size or not cfg.tie_word_embeddings:
        a["head"] = {"w": ("fsdp", "tp")}
    return a


def tp_pairs(name: str, cfg: ModelConfig) -> int:
    """Stacked projections on a parameter's 'tp' dim: 2 for SwiGLU's fused
    ``[w1 | w3]`` (and its bias) and for cross-attention's fused ``[k | v]``
    (``wkv``), whose TP shards hold matching columns of both (a rank's own
    heads' k and v), else 1."""
    if name == "wkv":
        return 2
    return 2 if cfg.act_fn == "swiglu" and name in ("w13", "w13_b") else 1


def tp_local_config(cfg: ModelConfig, tp: int) -> ModelConfig:
    """The attention / MLP shapes one of ``tp`` ranks computes: n/tp query
    heads and kv/tp kv heads of the same head_dim (so ``hidden_size`` is
    n/tp · head_dim inside the attention block) and ffn/tp."""
    if tp == 1:
        return cfg
    kv = None if cfg.num_kv_heads is None else cfg.num_kv_heads // tp
    return cfg.replace(num_heads=cfg.num_heads // tp, num_kv_heads=kv,
                       hidden_size=cfg.num_heads // tp * cfg.head_dim, ffn_dim=cfg.ffn // tp)


def check_tp_shapes(cfg: ModelConfig, tp: int, what: str) -> None:
    """A TP degree must split the heads, kv heads and ffn evenly."""
    for name, n in (("num_heads", cfg.num_heads), ("kv heads", cfg.kv_heads),
                    ("ffn", cfg.ffn)):
        if n % tp:
            raise ValueError(f"{what}: {name} {n} does not split over tp={tp}")


# ---------------------------------------------------------------------------
# Forward pieces
# ---------------------------------------------------------------------------


def qkv_project(x, w, cfg: ModelConfig, tp=None):
    """Fused QKV GEMM: blocked weights (h, 3, n·hd) give (…, 3, n·hd),
    interleaved weights (h, kv·group) give (…, kv·group). With ``tp`` the
    column-parallel seam (:func:`_up`)."""
    w = w.to(x.dtype)
    if cfg.qkv_blocked:
        y = _up(x, w.reshape(w.shape[0], -1), tp)
        return y.reshape(*y.shape[:-1], 3, w.shape[-1])
    return _up(x, w, tp)


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


def project_qkv_heads(x, p_attn, cfg: ModelConfig, tp=None):
    """Fused projection (+ the optional bias on the blocked (3, n·hd)
    slots, added after the GEMM) straight to per-head q/k/v."""
    y = qkv_project(x, p_attn["wqkv"], cfg, tp)
    if "wqkv_b" in p_attn:
        y = y + p_attn["wqkv_b"].to(y.dtype)
    return split_qkv(y, cfg)


def attn_output(o, p_attn, cfg: ModelConfig, tp=None):
    """(B, S, n, hd) attention context → (B, S, h), + the optional bias
    (with ``tp``: through the row-parallel seam, the bias after it)."""
    b, s = o.shape[:2]
    y = _down(o.reshape(b, s, cfg.num_heads * cfg.head_dim), p_attn["wo"].to(o.dtype), tp)
    return _add_bias(y, p_attn, "wo_b")


def _up(x, w, tp=None):
    """The column-parallel GEMM seam (the reference's ``_proj_up``): ``x @
    w``, or under the collective matmul with SP (``tp.ring``) the sequence
    all-gather pipelined behind the GEMM chunks, on the sequence shard that
    ``tp.enter`` then left as it was."""
    if tp is not None and tp.ring:
        from galvatron_tpu_torch.ops import collective_matmul

        return collective_matmul.allgather_matmul(x, w, tp.group)
    return x @ w


def _down(x, w, tp=None, act: Optional[str] = None):
    """The row-parallel GEMM seam (the reference's ``_proj_down``):
    ``act(x) @ w`` (``act`` is recomputed in the backward: :class:`_ActDown`)
    then ``tp.exit``; under the plan's ``tp_overlap`` the reduction as the
    collective matmul's accumulator ring (the sequence-sharded output under
    SP, gathered back without it). A sequence the ring does not split keeps
    the plain seam (the reference's fallback)."""
    if tp is not None and tp.overlap and tp.size > 1 and x.shape[1] % tp.size == 0:
        from galvatron_tpu_torch.ops import collective_matmul

        return collective_matmul.matmul_reducescatter(
            x, w, tp.group, scatter=tp.sp, act=None if act is None else _ACTS[act])
    y = x @ w if act is None else _ActDown.apply(x, w, act)
    return y if tp is None else tp.exit(y)


def _add_bias(y, p, name):
    """``y + p[name]`` in y's dtype when the bias exists (added after its
    GEMM, the reference's order), else y."""
    return y + p[name].to(y.dtype) if name in p else y


def _rms(x, scale, eps: float):
    x32 = x.float()
    x32 = x32 * torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return (x32 * scale.float()).to(x.dtype)


def _layernorm(x, scale, bias, eps: float):
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mu).square().mean(dim=-1, keepdim=True)
    out = (x32 - mu) * torch.rsqrt(var + eps)
    return (out * scale.float() + bias.float()).to(x.dtype)


def _norm_with(x, scale, bias, cfg: ModelConfig):
    if cfg.norm_type == "rms":
        return _rms(x, scale, cfg.norm_eps)
    return _layernorm(x, scale, bias, cfg.norm_eps)


def _norm_impl(x, p, cfg: ModelConfig):
    """RMSNorm or LayerNorm in fp32, cast back to the input dtype (the
    reference's ``_norm_impl``)."""
    return _norm_with(x, p["scale"], p.get("bias"), cfg)


def norm(x, p, cfg: ModelConfig):
    """RMSNorm / LayerNorm. With ``cfg.fused_norm`` through the fused
    kernels' autograd entries (``ops/fused_norm.py``; a width that does not
    tile takes their plain reference), which save the input and the fp32 row
    statistics themselves, so no checkpoint wraps them. Otherwise, under
    ``mlp_recompute='policy'`` and with autograd on, the fp32 statistics are
    recomputed in the backward from the compute-dtype input instead of
    being saved widened (the reference wraps ``_norm_impl`` in
    ``jax.checkpoint``)."""
    if cfg.fused_norm:
        from galvatron_tpu_torch.ops import fused_norm

        if cfg.norm_type == "rms":
            return fused_norm.fused_rmsnorm(x, p["scale"], cfg.norm_eps)
        return fused_norm.fused_layernorm(x, p["scale"], p["bias"], cfg.norm_eps)
    if cfg.mlp_recompute == "policy" and torch.is_grad_enabled():
        return checkpoint(_norm_impl, x, p, cfg, use_reentrant=False)
    return _norm_impl(x, p, cfg)


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


def positions_from_segments(seg):
    """Per-segment position ids from a ``(B, S)`` packed segment-id array:
    position i's index within its own segment. Relies on the packer's layout
    contract — segment ids never decrease along the row (documents are laid
    out contiguously), so a segment's start is the last index where the id
    changed."""
    idx = torch.arange(seg.shape[1], device=seg.device)
    is_start = torch.cat([torch.ones_like(seg[:, :1], dtype=torch.bool),
                          seg[:, 1:] != seg[:, :-1]], dim=1)
    seg_start = torch.cummax(torch.where(is_start, idx[None], 0), dim=1).values
    return idx[None] - seg_start


def split_packed_inputs(inputs):
    """Packed model-input rows ``(B, 2·S)`` = tokens ‖ segment ids →
    (tokens (B, S), segment ids (B, S), per-segment position ids (B, S))."""
    s = inputs.shape[1] // 2
    seg = inputs[:, s:]
    return inputs[:, :s], seg, positions_from_segments(seg)


def packed_rope_tables(cfg: ModelConfig, pos_ids, tables=None):
    """Per-row rope tables for packed sequences: the shared ``(S, hd/2)``
    tables (``tables``, or :func:`rope_tables`) gathered by per-segment
    positions → ``(B, S, hd/2)``. For a row that is one whole segment this
    gathers ``arange(S)``: bit-identical values to the shared tables."""
    cos, sin = tables if tables is not None else rope_tables(cfg, pos_ids.shape[1],
                                                             pos_ids.device)
    return cos[pos_ids], sin[pos_ids]


def _repeat_kv(x, n_rep: int):
    """(b, s, kv, hd) → (b, s, kv·n_rep, hd), kv-major like the reference."""
    if n_rep == 1:
        return x
    b, s, kvh, hd = x.shape
    return x[:, :, :, None, :].expand(b, s, kvh, n_rep, hd).reshape(b, s, kvh * n_rep, hd)


def alibi_slopes(n_heads: int) -> np.ndarray:
    """The standard ALiBi slope schedule (Press et al.), the reference's:
    a geometric sequence for a power-of-two head count; otherwise the
    sequence of the next lower power of two, then every other slope of the
    one above it (baichuan-13b's 40 heads take that branch)."""
    def pow2slopes(n):
        start = 2 ** (-(2 ** -(np.log2(n) - 3)))
        return start * (start ** np.arange(n))

    if np.log2(n_heads).is_integer():
        return pow2slopes(n_heads)
    k = 2 ** int(np.floor(np.log2(n_heads)))
    return np.concatenate([pow2slopes(k), pow2slopes(2 * k)[0::2][: n_heads - k]])


@functools.lru_cache(maxsize=8)
def alibi_tensor(cfg: ModelConfig, device) -> Optional[torch.Tensor]:
    """(n,) fp32 slopes on ``device`` for an ALiBi model (the reference's
    ``jnp.asarray(alibi_slopes(n))``: float64 rounded to fp32), else None.
    Made once per (config, device); outside inference mode, since a cached
    tensor may meet autograd later."""
    if cfg.pos_embed != "alibi":
        return None
    with torch.inference_mode(False):
        return torch.from_numpy(alibi_slopes(cfg.num_heads).astype(np.float32)).to(device)


def alibi_local(slopes: torch.Tensor, tp) -> torch.Tensor:
    """The slopes of the heads one TP rank computes: ``bridge.shard_params``
    gives TP index t the wqkv columns of heads [t·n/tp, (t+1)·n/tp) in
    both qkv layouts (whole kv groups in head order under GQA), so its
    slopes are that slice (GSPMD shards the reference's (1, n, q, k) bias
    with the heads the same way)."""
    n = slopes.shape[0] // tp.size
    return slopes[tp.index * n:(tp.index + 1) * n]


def alibi_bias(slopes: torch.Tensor, q_pos, k_len: int) -> torch.Tensor:
    """The ALiBi bias ``slope · (k − q)`` as fp32 (B or 1, n, s, k_len):
    ``q_pos`` (B or 1, s) absolute query positions, keys at 0..k_len-1.
    One fp32 product of the slope and the exact integer distance, as the
    reference computes it."""
    k_pos = torch.arange(k_len, device=slopes.device)
    rel = (k_pos[None, None, :] - q_pos[:, :, None]).float()  # (B, s, k)
    return slopes[None, :, None, None] * rel[:, None]


def attention_xla(q, k, v, cfg: ModelConfig, q_offset, seg_ids=None, bias=None):
    """Einsum attention (the reference's ``attention_xla``): k/v may be
    longer than q; with ``cfg.causal`` query i of row b sits at absolute
    position ``q_offset[b] + i`` and sees keys at positions <= its own, and
    an encoder (``causal=False``) sees every key, unmasked. Scores and
    softmax in fp32 with the -1e30 mask, probabilities cast to the compute
    dtype before the PV product. Causal one-query calls go to the
    GQA-native ``decode_attention`` as in the reference.

    ``seg_ids`` ((B, S), packed sequences): the causal predicate tightens to
    intra-segment — query i attends to key j only when ``seg[i] == seg[j]``.
    The combine is a logical AND on the same -1e30 fill the causal mask
    uses, so a row holding one segment gets a bit-identical mask (the
    packed-vs-padded parity).

    ``bias`` (fp32, broadcastable to (B, n, s, k): ALiBi) is added to the
    scaled scores before the mask; a one-query call with a bias stays on
    this path, as in the reference."""
    b, s, nh, hd = q.shape
    offsets = torch.as_tensor(q_offset, device=q.device).reshape(-1)
    if s == 1 and seg_ids is None and bias is None and cfg.causal:
        from galvatron_tpu_torch.ops.flash_attention import decode_attention

        return decode_attention(q, k, v, q_offset=offsets)
    k = _repeat_kv(k, nh // k.shape[2])
    v = _repeat_kv(v, nh // v.shape[2])
    scores = torch.einsum("bqnh,bknh->bnqk", q, k).float() / math.sqrt(hd)
    if bias is not None:
        scores = scores + bias
    if cfg.causal:
        q_pos = offsets[:, None] + torch.arange(s, device=q.device)[None]
        k_pos = torch.arange(k.shape[1], device=q.device)
        allowed = k_pos[None, None, :] <= q_pos[:, :, None]
        if seg_ids is not None:
            allowed = allowed & (seg_ids[:, :, None] == seg_ids[:, None, :])
        scores = scores.masked_fill(~allowed[:, None], -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bnqk,bknh->bqnh", probs, v)


def _swiglu(g):
    f = g.shape[-1] // 2
    return F.silu(g[..., :f]) * g[..., f:]


def _gelu(g):
    return F.gelu(g, approximate="tanh")  # jax.nn.gelu(approximate=True)


#: the MLP activations, applied to the (biased) gate projection output
_ACTS = {"swiglu": _swiglu, "gelu": _gelu, "relu": F.relu}


def _up_name(cfg: ModelConfig) -> str:
    """The gate/up projection: fused [w1 | w3] for SwiGLU, w1 otherwise."""
    return "w13" if cfg.act_fn == "swiglu" else "w1"


def _flat(t):
    return t.reshape(-1, t.shape[-1])


def _bias_grad(dy, has_bias: bool):
    """The gradient of a bias broadcast-added to ``dy``'s rows (None when
    there is no bias)."""
    return _flat(dy).sum(dim=0) if has_bias else None


class _ActDown(torch.autograd.Function):
    """``act(g) @ w2`` saving the gate projection output ``g`` (and the
    compute-dtype w2) instead of the product: the backward recomputes the
    product, so the w2 GEMM is not recomputed and no second full-width
    activation is kept ('gate' recompute)."""

    @staticmethod
    def forward(ctx, g, w2, act_fn):
        ctx.save_for_backward(g, w2)
        ctx.act_fn = act_fn
        return _ACTS[act_fn](g) @ w2

    @staticmethod
    def backward(ctx, dy):
        g, w2 = ctx.saved_tensors
        with torch.enable_grad():
            g_ = g.detach().requires_grad_(True)
            prod = _ACTS[ctx.act_fn](g_)
        dw2 = _flat(prod.detach()).t() @ _flat(dy)
        (dg,) = torch.autograd.grad(prod, g_, dy @ w2.t())
        return dg, dw2, None


class _MLPBranch(torch.autograd.Function):
    """The 'policy' MLP branch ``act(norm(x) @ w_up + b_up) @ w2 + b2``
    saving only its input x and the biased gate projection output g (the
    reference's ``save_only_these_names('mlp_gate')`` region): the backward
    recomputes the norm (fp32 statistics included) and the activation
    product, never a GEMM of the forward. Biases may be None."""

    @staticmethod
    def forward(ctx, x, scale, nbias, w_up, b_up, w2, b2, cfg):
        g = _norm_with(x, scale, nbias, cfg) @ w_up
        if b_up is not None:
            g = g + b_up
        ctx.save_for_backward(x, scale, nbias, w_up, w2, g)
        ctx.cfg, ctx.biased = cfg, (b_up is not None, b2 is not None)
        y = _ACTS[cfg.act_fn](g) @ w2
        return y if b2 is None else y + b2

    @staticmethod
    def backward(ctx, dy):
        x, scale, nbias, w_up, w2, g = ctx.saved_tensors
        with torch.enable_grad():
            norm_in = [t.detach().requires_grad_(True) for t in (x, scale, nbias)
                       if t is not None]  # nbias is None for RMSNorm
            hn = _norm_with(*norm_in, *([None] * (3 - len(norm_in))), ctx.cfg)
            g_ = g.detach().requires_grad_(True)
            prod = _ACTS[ctx.cfg.act_fn](g_)
        dw2 = _flat(prod.detach()).t() @ _flat(dy)
        (dg,) = torch.autograd.grad(prod, g_, dy @ w2.t())
        dw_up = _flat(hn.detach()).t() @ _flat(dg)
        dx, dscale, *dnbias = torch.autograd.grad(hn, norm_in, dg @ w_up.t())
        return (dx, dscale, dnbias[0] if dnbias else None, dw_up, _bias_grad(dg, ctx.biased[0]),
                dw2, _bias_grad(dy, ctx.biased[1]), None)


def mlp_block(x, p, cfg: ModelConfig, product_remat: Optional[bool] = None,
              train: bool = True, tp=None):
    """``act(x @ w_up + b_up) @ w2 + b2`` (SwiGLU over the fused [w1 | w3],
    tanh-GELU or ReLU over w1; biases when present), or the switch-MoE block
    when ``cfg.moe_experts`` > 0 (``train`` picks its routing: sinkhorn-
    balanced, or the raw argmax at inference; no recompute policy applies
    to it, as in the reference); under 'gate' with
    autograd on (or with ``product_remat``), the product is recomputed in
    the backward. 'policy' is :func:`mlp_residual`'s region, except with
    ``fused_norm``: the branch
    then leaves that region (the fused kernels carry their own residuals)
    and the one-gate-save guarantee falls back to the product-only
    recompute here, as in the reference. With ``tp`` the GEMMs are the
    layer's TP seams (:func:`_up`, :func:`_down`; ``w2_b`` after the
    reduction)."""
    if cfg.moe_experts > 0:
        return moe.moe_block(x, p, cfg, train=train, ctx=cfg.moe_ctx)
    up = _up_name(cfg)
    g = _add_bias(_up(x, p[up].to(x.dtype), tp), p, up + "_b")
    w2 = p["w2"].to(x.dtype)
    if product_remat is None:
        product_remat = cfg.mlp_recompute == "gate" or (
            cfg.mlp_recompute == "policy" and cfg.fused_norm)
    if product_remat and torch.is_grad_enabled():
        y = _down(g, w2, tp, act=cfg.act_fn)
    else:
        y = _down(_ACTS[cfg.act_fn](g), w2, tp)
    return _add_bias(y, p, "w2_b")


def mlp_residual(x, p, cfg: ModelConfig):
    """x + MLP(norm(x)); under 'policy' with autograd on, the whole branch
    is one region that saves only x and the gate output
    (:class:`_MLPBranch`). ``fused_norm`` layers keep the plain branch: the
    region recomputes the plain norm, and the fused kernels save residuals
    it cannot reach; nor do MoE layers (the reference's)."""
    if (cfg.mlp_recompute == "policy" and not cfg.fused_norm and cfg.moe_experts == 0
            and torch.is_grad_enabled()):
        pm, pn, up = p["mlp"], p["mlp_norm"], _up_name(cfg)

        def cast(name):
            return pm[name].to(x.dtype) if name in pm else None

        return x + _MLPBranch.apply(x, pn["scale"], pn.get("bias"), cast(up), cast(up + "_b"),
                                    cast("w2"), cast("w2_b"), cfg)
    return x + mlp_block(norm(x, p["mlp_norm"], cfg), p["mlp"], cfg)


def embed(tokens, params, cfg: Optional[ModelConfig] = None, vocab=None, positions=None,
          pos_ids=None):
    """Token embedding: the table cast to the compute dtype, then gathered
    (the reference's order, so the backward scatter-adds in that dtype);
    learned positions add the cast table's first s rows, broadcast over
    the batch, or with ``positions`` ((B or 1, s) absolute positions, the
    KV-cache forwards') those rows of the table, or with ``pos_ids`` ((B, s)
    per-segment positions of packed rows) the first s rows broadcast over
    the batch and then gathered per row (the reference's order: the
    backward is a per-row placement, then the same sum over the batch as
    the unpacked broadcast, so a row of one whole segment gets bit-identical
    position-table gradients). With ``vocab`` (a
    ``TPRegion``) the table is this rank's vocabulary shard: tokens outside
    it embed to zero and ``vocab.exit`` sums the shards (into this rank's
    sequence shard under SP), then the positions of those rows are added."""
    tok = params["embed"]["tok"]
    if cfg is None:
        return tok[tokens]
    seq = slice(0, tokens.shape[1])
    if vocab is not None and vocab.size > 1:
        n = tok.shape[0]
        local = tokens - vocab.index * n
        inside = (local >= 0) & (local < n)
        x = tok.to(cfg.dtype)[torch.where(inside, local, torch.zeros_like(local))]
        x = vocab.exit(torch.where(inside[..., None], x, torch.zeros_like(x)))
        seq = vocab.seq_slice(tokens.shape[1])
    else:
        x = tok.to(cfg.dtype)[tokens]
    if cfg.pos_embed == "learned":
        table = params["embed"]["pos"].to(cfg.dtype)
        if pos_ids is not None:
            s, b = tokens.shape[1], pos_ids.shape[0]
            tbl = table[:s][None].expand(b, s, table.shape[1])
            idx = pos_ids[:, seq]
            x = x + torch.gather(tbl, 1, idx[:, :, None].expand(*idx.shape, table.shape[1]))
        else:
            x = x + (table[seq][None] if positions is None else table[positions])
    return x


def lm_head(x, params, cfg: Optional[ModelConfig] = None):
    """Logits; a tied head multiplies by the (compute-dtype) token table."""
    if cfg is not None and cfg.tie_word_embeddings:
        return x @ params["embed"]["tok"].to(x.dtype).t()
    return x @ params["head"]["w"].to(x.dtype)


# ---------------------------------------------------------------------------
# Attention for training: einsum path and the flash kernels
# ---------------------------------------------------------------------------


def _maybe_checkpoint(fn, remat: bool, *args):
    """``fn(*args)``, recomputed in the backward when ``remat`` (the
    reference's ``jax.checkpoint`` over the attention core)."""
    if remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def attention(q, k, v, cfg: ModelConfig, rope=None, seg_ids=None, alibi=None):
    """(B, S, n, hd) attention on the einsum path, RoPE applied first (the
    reference's xla branch), masked per segment with ``seg_ids``, with the
    ALiBi bias of the (n,) ``alibi`` slopes over the whole sequence. The
    flash path never comes here: ``attn_block`` sends a tileable sequence
    to ``_attn_block_headmajor``, and an untileable one takes this
    fallback, as in the reference."""
    if rope is not None:
        q = apply_rope(q, *rope)
        k = apply_rope(k, *rope)
    bias = None
    if alibi is not None:
        s = q.shape[1]
        bias = alibi_bias(alibi, torch.arange(s, device=q.device)[None], s)
    return attention_xla(q, k, v, cfg, 0, seg_ids=seg_ids, bias=bias)


def _attn_block_headmajor(x, p, cfg: ModelConfig, rope, remat_attn: bool, tp=None):
    """Flash-path attention with head-major dataflow: the fused projection
    (+ its bias, added after the GEMM) is viewed as (b, 3, n, s, hd) (MHA)
    and fed to ``flash_attention_qkv`` with no copy when the blocked RoPE
    kernels apply, else as q/k/v views to ``flash_attention_hm`` (the grid
    kernels without RoPE); the GQA layout is split into q at n heads and
    k/v at kv heads. The context then goes through the output projection
    ('bnsd,nde->bse') and its bias. With ``tp`` both GEMMs are the layer's
    TP seams: under the collective matmul with SP the projection gathers
    the sequence itself, so the kernels see the same full-sequence qkv."""
    from galvatron_tpu_torch.ops.flash_attention import (
        flash_attention_hm,
        flash_attention_qkv,
        flash_qkv_supported,
    )

    b, h = x.shape[0], x.shape[2]
    hd, n = cfg.head_dim, cfg.num_heads
    w = p["wqkv"].to(x.dtype)
    if cfg.qkv_blocked:
        qkv = _up(x, w.reshape(h, 3 * n * hd), tp)
        s = qkv.shape[1]
        qkv = qkv.view(b, s, 3, n, hd)
        if "wqkv_b" in p:
            qkv = qkv + p["wqkv_b"].to(x.dtype).view(3, n, hd)
        qkv = qkv.permute(0, 2, 3, 1, 4)
        if flash_qkv_supported(s, hd, cfg.causal, rope):
            o = _maybe_checkpoint(lambda t: flash_attention_qkv(t, rope=rope), remat_attn, qkv)
            return _headmajor_out(o, p, x.dtype, tp)
        q, k, v = qkv[:, 0], qkv[:, 1], qkv[:, 2]
    else:
        kv, group = qkv_dims(cfg)
        npg = group // hd - 2  # query heads per kv group, per the stored layout
        r = _up(x, w, tp)
        s = r.shape[1]
        r = r.view(b, s, kv, npg + 2, hd).permute(0, 2, 3, 1, 4)
        q = r[:, :, :npg].reshape(b, n, s, hd)
        k, v = r[:, :, npg], r[:, :, npg + 1]
    o = _maybe_checkpoint(
        lambda q_, k_, v_: flash_attention_hm(q_, k_, v_, causal=cfg.causal, rope=rope),
        remat_attn, q, k, v)
    return _headmajor_out(o, p, x.dtype, tp)


def _headmajor_out(o, p, dtype, tp=None):
    b, n, s, hd = o.shape
    y = _down(o.transpose(1, 2).reshape(b, s, n * hd), p["wo"].to(dtype), tp)
    return _add_bias(y, p, "wo_b")


def attn_block(x, p, cfg: ModelConfig, cos_sin=None, remat_attn: bool = False, seg_ids=None,
               tp=None, alibi=None):
    """``remat_attn`` recomputes only the attention core in the backward
    (the reference's "selective" checkpointing). RoPE tables apply only to
    ``pos_embed='rope'`` models, the ``alibi`` slopes (of this block's heads)
    only to ``pos_embed='alibi'`` ones. ``seg_ids`` (packed sequences) and
    ALiBi take the einsum path (the segment mask and the bias there), never
    the flash kernels, whatever ``attn_impl`` says (the reference's rule:
    its kernels carry neither). With ``tp`` the projections are the layer's
    TP seams and the output is reduced (:func:`_up`, :func:`_down`)."""
    from galvatron_tpu_torch.ops.flash_attention import flash_tileable

    rope = cos_sin if cfg.pos_embed == "rope" else None
    alibi = alibi if cfg.pos_embed == "alibi" else None
    seq = x.shape[1] * (tp.size if tp is not None and tp.ring else 1)
    if (cfg.attn_impl == "flash" and cfg.pos_embed != "alibi" and seg_ids is None
            and flash_tileable(seq)):
        return _attn_block_headmajor(x, p, cfg, rope, remat_attn, tp)
    q, k, v = project_qkv_heads(x, p, cfg, tp)
    o = _maybe_checkpoint(lambda q_, k_, v_: attention(q_, k_, v_, cfg, rope=rope,
                                                       seg_ids=seg_ids, alibi=alibi),
                          remat_attn, q, k, v)
    return attn_output(o, p, cfg, tp)


def decoder_layer(x, p, cfg: ModelConfig, cos_sin=None, remat_attn: bool = False, tp=None,
                  seg_ids=None, alibi=None, enc_out=None):
    """One layer. ``tp`` (a ``parallel.comm.TPRegion`` of more than one
    rank) runs it tensor-parallel on this rank's shards: see
    :func:`_decoder_layer_tp`. ``seg_ids`` ((B, S) over the whole sequence:
    packed rows) masks the attention per segment. ``alibi``: the (n,) fp32
    slopes of every head (:func:`alibi_tensor`) of an ALiBi model.
    ``enc_out`` (an encoder-decoder's decoder layer, which holds ``cross``):
    the normed encoder output its cross-attention reads, after the
    self-attention and before the MLP (the reference's order)."""
    if tp is not None and tp.size > 1:
        return _decoder_layer_tp(x, p, cfg, cos_sin, remat_attn, tp, seg_ids, alibi, enc_out)
    x = x + attn_block(norm(x, p["attn_norm"], cfg), p["attn"], cfg, cos_sin,
                       remat_attn=remat_attn, seg_ids=seg_ids, alibi=alibi)
    if enc_out is not None and "cross" in p:
        x = x + cross_attn_block(norm(x, p["cross_norm"], cfg), enc_out, p["cross"], cfg)
    return mlp_residual(x, p, cfg)


def encoder_cfg(cfg: ModelConfig) -> ModelConfig:
    """An encoder-decoder's encoder layers: the same layer, bidirectional
    (the reference's ``encoder_layer``)."""
    return cfg.replace(causal=False) if cfg.causal else cfg


def cross_attn_block(x, enc_out, p, cfg: ModelConfig, tp=None):
    """Cross-attention (the reference's ``cross_attn_block``): queries from
    the decoder stream x (B, s, h), keys and values from the encoder output
    (B, se, h) through the fused ``[k | v]`` GEMM, unmasked over every
    encoder position, no rotary; always the einsum attention, as in the
    reference. With ``tp`` (more than one rank) this rank's heads: x and
    enc_out enter the region (the whole sequences: under SP both arrive as
    sequence shards and are gathered), ``wq`` / ``wkv`` are this rank's
    column shards (``wkv`` its heads' k columns, then their v columns) and
    ``wo``'s row shard is reduced on the way out. enc_out's gradient from
    every TP rank is then summed by the region's backward."""
    if tp is not None and tp.size > 1:
        cfg = tp_local_config(cfg, tp.size)
        x, enc_out = tp.enter(x), tp.enter(enc_out)
    b, s = x.shape[:2]
    hd = cfg.head_dim
    kv_out = cfg.kv_heads * hd
    q = (x @ p["wq"].to(x.dtype)).reshape(b, s, cfg.num_heads, hd)
    kvp = enc_out.to(x.dtype) @ p["wkv"].to(x.dtype)
    se = kvp.shape[1]
    k = kvp[..., :kv_out].reshape(b, se, cfg.kv_heads, hd)
    v = kvp[..., kv_out:].reshape(b, se, cfg.kv_heads, hd)
    o = attention_xla(q, k, v, encoder_cfg(cfg), 0)
    y = o.reshape(b, s, cfg.num_heads * hd) @ p["wo"].to(x.dtype)
    return y if tp is None or tp.size == 1 else tp.exit(y)


def _without(p, name):
    return {k: v for k, v in p.items() if k != name}


def _decoder_layer_tp(x, p, cfg: ModelConfig, cos_sin, remat_attn: bool, tp, seg_ids=None,
                      alibi=None, enc_out=None):
    """Megatron's layer on one of ``tp.size`` ranks: the norm on this rank's
    activation (its sequence shard under SP), ``tp.enter`` (copy, or the
    sequence all-gather) before the column-parallel qkv / MLP-up GEMMs over
    the local n/tp heads and ffn/tp columns, ``tp.exit`` (all-reduce, or the
    reduce-scatter) after the row-parallel wo / w2, then their biases, added
    once. Under the plan's ``tp_overlap`` those seams are the collective
    matmul's rings (:func:`_up`, :func:`_down`; with SP ``tp.enter`` then
    leaves the shard to the qkv / MLP-up GEMM); an MoE layer's MLP keeps
    the plain seams, as in the reference. Under 'gate' and 'policy' the MLP
    saves the gate output and recomputes the activation product: the
    one-region 'policy' branch of the single-device layer recomputes the
    norm from the layer input, and here a collective stands between the
    two. An ALiBi layer's bias takes the slopes of this rank's heads
    (:func:`alibi_local`), over the whole sequence the TP region sees (under
    SP ``tp.enter`` has gathered it). A decoder layer of an
    encoder-decoder then runs its cross-attention on the plain seams
    (:func:`cross_attn_block`; the reference's block has no collective
    matmul either)."""
    local = tp_local_config(cfg, tp.size)
    h = _enter(norm(x, p["attn_norm"], cfg), tp)
    x = x + attn_block(h, p["attn"], local, cos_sin, remat_attn=remat_attn, seg_ids=seg_ids,
                       tp=tp, alibi=None if alibi is None else alibi_local(alibi, tp))
    if enc_out is not None and "cross" in p:
        x = x + cross_attn_block(norm(x, p["cross_norm"], cfg), enc_out, p["cross"], cfg, tp)
    return _mlp_residual_tp(x, p, cfg, tp)


def _enter(x, tp):
    """``tp.enter`` before a column-parallel seam; the collective matmul's
    ring gathers the sequence itself."""
    return x if tp.ring else tp.enter(x)


def _mlp_residual_tp(x, p, cfg: ModelConfig, tp):
    """The MLP half of :func:`_decoder_layer_tp`. An MoE layer's experts
    hold their ffn/tp columns and rows; it has no ``w2_b``."""
    pm = p["mlp"]
    if cfg.moe_experts > 0:
        h = tp.enter(norm(x, p["mlp_norm"], cfg))
        return x + tp.exit(moe.moe_block(h, pm, cfg, ctx=cfg.moe_ctx))
    h = _enter(norm(x, p["mlp_norm"], cfg), tp)
    return x + mlp_block(h, pm, tp_local_config(cfg, tp.size),
                         product_remat=cfg.mlp_recompute != "off", tp=tp)


def core_decoder_layer(x, p, cfg: ModelConfig, core, cos_sin=None, tp=None):
    """One layer whose attention core is ``core(q, k, v)``: q (B, s, n, hd)
    and k/v (B, s, kv, hd), RoPE applied, in; the (B, s, n, hd) context out.
    The context-parallel layers run this (``parallel/ring.py``,
    ``parallel/ulysses.py``; the reference's ``ring_decoder_layer`` and
    ``ulysses_decoder_layer``): the projections, RoPE through the caller's
    tables (the rows of this rank's positions), the core, the output
    projection and the MLP as in :func:`decoder_layer`. With ``tp`` (a
    ``TPRegion`` without SP) the projections are this rank's heads and
    columns, as in :func:`_decoder_layer_tp`."""
    tp = tp if tp is not None and tp.size > 1 else None
    local = tp_local_config(cfg, tp.size) if tp is not None else cfg
    pa = p["attn"]
    h = norm(x, p["attn_norm"], cfg)
    if tp is not None:
        h = tp.enter(h)
    q, k, v = project_qkv_heads(h, pa, local)
    if cfg.pos_embed == "rope":
        q, k = apply_rope(q, *cos_sin), apply_rope(k, *cos_sin)
    y = attn_output(core(q, k, v), _without(pa, "wo_b"), local)
    if tp is None:
        return mlp_residual(x + _add_bias(y, pa, "wo_b"), p, cfg)
    return _mlp_residual_tp(x + _add_bias(tp.exit(y), pa, "wo_b"), p, cfg, tp)


def forward(params, tokens, cfg: ModelConfig, layer_hook=None):
    """Full forward → logits. ``layer_hook(i, x, layer_params)`` lets a
    caller insert per-layer recompute (the hybrid runtime composes
    :func:`embed`, its layers and :func:`head` itself).

    Packed sequences (``cfg.pack_sequences``): ``tokens`` is the (B, 2·S)
    packed input row (tokens ‖ segment ids, from :func:`split_batch`); the
    segment ids drive the intra-segment mask and the per-segment positions,
    and reach the hook as the keyword ``seg_ids`` (only in packed mode).
    ALiBi models add the bias of :func:`alibi_tensor`'s slopes in every
    layer; a packed row needs no per-segment positions for it, since the
    bias depends only on k − q and the segment mask cuts across segments."""
    seg = pos_ids = None
    if cfg.pack_sequences:
        tokens, seg, pos_ids = split_packed_inputs(tokens)
    cos_sin = None
    if cfg.pos_embed == "rope":
        cos_sin = (packed_rope_tables(cfg, pos_ids) if pos_ids is not None
                   else rope_tables(cfg, tokens.shape[1], tokens.device))
    hook_kw = {"seg_ids": seg} if seg is not None else {}
    alibi = alibi_tensor(cfg, tokens.device)
    x = embed(tokens, params, cfg, pos_ids=pos_ids)
    for i, lp in enumerate(params["layers"]):
        if layer_hook is not None:
            x = layer_hook(i, x, lp, **hook_kw)
        else:
            x = decoder_layer(x, lp, cfg, cos_sin, seg_ids=seg, alibi=alibi)
    return head(x, params, cfg)


def forward_encdec(params, enc_tokens, dec_tokens, cfg: ModelConfig, layer_hook=None):
    """Encoder-decoder forward → decoder logits (the reference's
    ``forward_encdec``): the encoder tokens through the embedding and the
    bidirectional encoder layers, ``enc_final_norm``, then the decoder
    tokens through the embedding and the decoder layers, each
    cross-attending to that normed output, the final norm and the head.
    ``layer_hook(i, x, lp, enc_out=None)`` takes the encoder layers as
    0..enc_layers-1 and the decoder layers as enc_layers.. (decoder hooks
    get ``enc_out``)."""
    e = enc_tokens.shape[1]
    ecfg = encoder_cfg(cfg)
    rope_e = rope_tables(cfg, e, enc_tokens.device) if cfg.pos_embed == "rope" else None
    rope_d = (rope_tables(cfg, dec_tokens.shape[1], dec_tokens.device)
              if cfg.pos_embed == "rope" else None)
    x = embed(enc_tokens, params, cfg)
    for i, lp in enumerate(params["enc_layers"]):
        x = layer_hook(i, x, lp) if layer_hook is not None else decoder_layer(x, lp, ecfg,
                                                                              rope_e)
    enc_out = norm(x, params["enc_final_norm"], cfg)
    y = embed(dec_tokens, params, cfg)
    for j, lp in enumerate(params["layers"]):
        if layer_hook is not None:
            y = layer_hook(cfg.enc_layers + j, y, lp, enc_out=enc_out)
        else:
            y = decoder_layer(y, lp, cfg, rope_d, enc_out=enc_out)
    return head(y, params, cfg)


def head(x, params, cfg: ModelConfig, vocab=None):
    """The final norm and the head → logits (this rank's vocabulary or
    class shard with ``vocab``): the LM head, or for 'cls' the mean-pooled
    class head (under SP ``vocab.enter`` gathers the whole sequence first)."""
    x = norm(x, params["final_norm"], cfg)
    if vocab is not None:
        x = vocab.enter(x)
    if cfg.objective == "cls":
        return cls_head(x, params, cfg)
    return lm_head(x, params, cfg)


# ---------------------------------------------------------------------------
# Vision (ViT)
# ---------------------------------------------------------------------------


def vision_embed(pixels, params, cfg: ModelConfig, vocab=None):
    """(B, H·W·C) integer pixel rows → (B, n_patches, hidden): cast to the
    compute dtype, normalised to [-1, 1] in it (``/ 127.5 - 1``, the
    reference's order, so bf16 rounds where it rounds), cut into patches
    by reshape and transpose, one projection, plus the learned positions.

    With ``vocab`` (a ``TPRegion`` of more than one rank: the embedding's
    TP group) the projection is this rank's column shard: its output columns
    sit in a zero row of the full width and ``vocab.exit`` sums the shards
    (into this rank's sequence shard under SP), as the token embedding sums
    its vocabulary shards; then the positions of those rows are added."""
    b = pixels.shape[0]
    p_, g, c = cfg.patch_size, cfg.grid, cfg.num_channels
    x = pixels.to(cfg.dtype).reshape(b, g, p_, g, p_, c) / 127.5 - 1.0
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, g * g, p_ * p_ * c)
    y = x @ params["embed"]["proj"].to(cfg.dtype)
    seq = slice(0, g * g)
    if vocab is not None and vocab.size > 1:
        n = y.shape[-1]
        full = y.new_zeros(*y.shape[:-1], n * vocab.size)
        y = vocab.exit(full.index_copy(-1, torch.arange(vocab.index * n, (vocab.index + 1) * n,
                                                         device=y.device), y))
        seq = vocab.seq_slice(g * g)
    return y + params["embed"]["pos"].to(cfg.dtype)[seq][None]


def cls_head(y, params, cfg: ModelConfig):
    """Mean-pooled classification head: (B, L, C) → (B, num_classes)."""
    return y.mean(dim=1) @ params["head"]["w"].to(y.dtype)


def forward_vision(params, pixels, cfg: ModelConfig, layer_hook=None):
    """ViT forward → class logits: the patch embedding, the bidirectional
    layers (``decoder_layer`` under ``causal=False``), the final norm and
    the pooled head. ``layer_hook(i, x, lp)`` as in :func:`forward`."""
    x = vision_embed(pixels, params, cfg)
    for i, lp in enumerate(params["layers"]):
        x = layer_hook(i, x, lp) if layer_hook is not None else decoder_layer(x, lp, cfg)
    return head(x, params, cfg)


def embed_any(inputs, params, cfg: ModelConfig, vocab=None, pos_ids=None):
    """The input embedding of either modality: the token table (and its
    positions) or the patch projection."""
    if cfg.image_size:
        return vision_embed(inputs, params, cfg, vocab)
    return embed(inputs, params, cfg, vocab, pos_ids=pos_ids)


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------


def _cross_entropy_sum_impl(logits, labels, ignore_index: int = -100):
    logits = logits.float()
    mask = labels != ignore_index
    safe = torch.where(mask, labels, torch.zeros_like(labels))
    lse = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(-1, safe[..., None].long())[..., 0]
    nll = (lse - picked) * mask
    return nll.sum(), mask.sum()


def _vocab_parallel_ce_sum_impl(logits, labels, vocab, ignore_index: int = -100):
    """The token NLL sum over a vocabulary-sharded row: max and sum-exp
    all-reduced over ``vocab``'s group, the label's logit taken from the
    rank that holds it and summed there too."""
    logits = logits.float()
    n = logits.shape[-1]
    mask = labels != ignore_index
    local = labels - vocab.index * n
    inside = mask & (local >= 0) & (local < n)
    safe = torch.where(inside, local, torch.zeros_like(local))
    gmax = vocab.max(logits.max(dim=-1).values)
    sumexp = vocab.sum(torch.exp(logits - gmax[..., None]).sum(dim=-1))
    picked = logits.gather(-1, safe[..., None].long())[..., 0] * inside
    picked = vocab.sum(picked)
    nll = (torch.log(sumexp) + gmax - picked) * mask
    return nll.sum(), mask.sum()


def cross_entropy_sum(logits, labels, ignore_index: int = -100, remat: bool = False,
                      vocab=None):
    """(nll_sum, valid_token_count) in fp32, the accumulation-safe form.
    ``remat`` recomputes the fp32 cast and log-sum-exp in the backward from
    the compute-dtype logits ("cast at the consumer"). With ``vocab`` (a
    ``TPRegion`` of more than one rank) the logits are this rank's
    vocabulary shard."""
    if vocab is not None and vocab.size > 1:
        fn, args = _vocab_parallel_ce_sum_impl, (logits, labels, vocab, ignore_index)
    else:
        fn, args = _cross_entropy_sum_impl, (logits, labels, ignore_index)
    if remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def ce_remat(cfg: ModelConfig) -> bool:
    return cfg.mlp_recompute == "policy"


def batch_row_width(cfg: ModelConfig, seq: int) -> int:
    """Width of one loader batch row, the shape side of :func:`split_batch`:
    vision rows are sample_len pixels ‖ label; packed rows are tokens ‖
    segment ids, 2·(S+1) (``data/packing.py``); plain windows are S+1."""
    if cfg.image_size:
        return cfg.sample_len + 1
    if cfg.enc_layers > 0:
        return cfg.enc_seq + seq + 1
    return 2 * (seq + 1) if cfg.pack_sequences else seq + 1


def layer_seq(cfg: ModelConfig, seq: Optional[int] = None, layer: Optional[int] = None) -> int:
    """The sequence a step's layers run over: a ViT's patches, whatever
    ``seq`` says; an encoder-decoder's encoder layers (``layer`` <
    ``enc_layers``) its ``enc_seq``; else ``seq`` (the training length when
    None: for an encoder-decoder, the decoder's)."""
    if cfg.image_size:
        return cfg.n_patches
    if layer is not None and layer < cfg.enc_layers:
        return cfg.enc_seq
    return seq or cfg.max_seq_len


def _mul32(h, c: int):
    """``h · c mod 2^32`` for int64 ``h`` in [0, 2^32) and a constant c <
    2^32, in two 16-bit halves of c so that no product leaves int64: uint32
    arithmetic with wraparound, bit for bit."""
    lo = h * (c & 0xFFFF)
    hi = (h * (c >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & 0xFFFFFFFF


def mlm_positions(tokens, cfg: ModelConfig):
    """Deterministic masked-LM positions (the reference's): the uint32 hash
    ``(t·2654435761 + pos·40503)``, then ``(h ^ h >> 16)·2246822519``, its
    low 16 bits over 65536 below ``mlm_mask_rate``. The hash runs on int64
    masked to 32 bits, so the masks are the reference's bit for bit; the
    loss stays a function of (params, batch) alone."""
    mask32 = 0xFFFFFFFF
    t = tokens.long() & mask32
    pos = torch.arange(tokens.shape[-1], device=tokens.device, dtype=torch.long)
    h = (_mul32(t, 2654435761) + _mul32(pos, 40503)) & mask32
    h = _mul32(h ^ (h >> 16), 2246822519)
    frac = (h & 0xFFFF).float() / 65536.0
    return frac < cfg.mlm_mask_rate


def split_batch(batch, cfg: ModelConfig):
    """One (B, row width) batch → (model inputs, loss labels) per objective
    (the reference's ``split_batch``): 'cls' pixels ‖ label; 'mlm' the
    tokens with :func:`mlm_positions` set to the [MASK] id (vocab_size - 1)
    and labels only there (-100 elsewhere); 'clm' the next-token shift. A
    packed row (B, 2·(S+1)) = tokens ‖ segment ids keeps both halves in the
    inputs (every layer needs the segment ids); its labels are next-token
    WITHIN a segment only: a position whose successor belongs to another
    segment (a document boundary) or to padding (segment 0) carries no
    loss."""
    if cfg.objective == "cls":
        return batch[:, :-1], batch[:, -1]
    if cfg.enc_layers > 0:
        # encoder tokens ‖ decoder stream: the inputs are the encoder tokens
        # ‖ the decoder's inputs, the labels the decoder's next tokens
        return batch[:, :-1], batch[:, cfg.enc_seq + 1:]
    if cfg.objective == "mlm":
        tokens = batch[:, :-1]
        mask = mlm_positions(tokens, cfg)
        return (torch.where(mask, torch.full_like(tokens, cfg.vocab_size - 1), tokens),
                torch.where(mask, tokens, torch.full_like(tokens, -100)))
    if cfg.pack_sequences:
        s1 = batch.shape[1] // 2
        tokens, seg = batch[:, :s1], batch[:, s1:]
        inputs = torch.cat([tokens[:, :-1], seg[:, :-1]], dim=1)
        same = (seg[:, 1:] == seg[:, :-1]) & (seg[:, 1:] > 0)
        return inputs, torch.where(same, tokens[:, 1:], torch.full_like(tokens[:, 1:], -100))
    return batch[:, :-1], batch[:, 1:]


def loss_tokens_per_sample(cfg: ModelConfig, seq_len: int) -> int:
    """Static count of loss-carrying positions a sample (the fp16 seed's
    and the token counts' divisor): one for 'cls', the expected masked
    share for 'mlm', the sequence for 'clm' (an encoder-decoder's decoder
    positions: ``seq_len`` is the decoder's here, where the reference
    passes the whole row and subtracts ``enc_seq``)."""
    if cfg.objective == "cls":
        return 1
    if cfg.objective == "mlm":
        return max(1, int(seq_len * cfg.mlm_mask_rate))
    return seq_len


def lm_loss_sum(params, batch, cfg: ModelConfig, layer_hook=None):
    """(nll_sum, token_count) on a batch of :func:`batch_row_width` rows,
    per objective: 'clm' next-token (packed: (B, 2·(S+1))), 'mlm' the masked
    positions, 'cls' one class a row (the count is then the rows); an
    encoder-decoder next-token over the decoder stream of its rows."""
    inputs, labels = split_batch(batch, cfg)
    if cfg.objective == "cls":
        logits = forward_vision(params, inputs, cfg, layer_hook=layer_hook)
    elif cfg.enc_layers > 0:
        logits = forward_encdec(params, inputs[:, :cfg.enc_seq], inputs[:, cfg.enc_seq:], cfg,
                                layer_hook=layer_hook)
    else:
        logits = forward(params, inputs, cfg, layer_hook=layer_hook)
    return cross_entropy_sum(logits, labels, remat=ce_remat(cfg))


def lm_loss(params, batch, cfg: ModelConfig, layer_hook=None):
    s, n = lm_loss_sum(params, batch, cfg, layer_hook=layer_hook)
    return s / torch.clamp_min(n, 1)


def _gpt(vocab_size, hidden_size, num_layers, num_heads, max_seq_len, act_fn="gelu"):
    """A GPT-2-style (or, with relu, OPT-style) decoder preset: learned
    positions, LayerNorm, biases, tied embeddings, ffn 4h."""
    return ModelConfig(use_bias=True, vocab_size=vocab_size, hidden_size=hidden_size,
                       num_layers=num_layers, num_heads=num_heads, max_seq_len=max_seq_len,
                       pos_embed="learned", norm_type="layernorm", act_fn=act_fn,
                       tie_word_embeddings=True)


def _vit(hidden_size, num_layers, num_heads, patch_size):
    """A ViT preset: GPT's layer (learned positions, LayerNorm, biases,
    gelu, ffn 4h), bidirectional, 224-pixel images, 1000 classes."""
    return ModelConfig(use_bias=True, vocab_size=1, hidden_size=hidden_size,
                       num_layers=num_layers, num_heads=num_heads, max_seq_len=0,
                       pos_embed="learned", norm_type="layernorm", act_fn="gelu",
                       causal=False, objective="cls", image_size=224, patch_size=patch_size)


def _t5(hidden_size, layers, num_heads, ffn_dim):
    """A T5 preset: ``layers`` encoder and ``layers`` decoder layers over
    512 + 512 tokens, learned positions, RMSNorm, tanh-GELU, tied
    embeddings, T5's 32128-token vocabulary."""
    return ModelConfig(vocab_size=32128, hidden_size=hidden_size, num_layers=layers,
                       num_heads=num_heads, ffn_dim=ffn_dim, max_seq_len=512,
                       enc_layers=layers, enc_seq=512, pos_embed="learned", norm_type="rms",
                       act_fn="gelu", tie_word_embeddings=True)


# Preset configs of the families the port runs (the reference's
# PRESETS, same sizes)
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
    "gpt-0.3b": _gpt(50257, 1024, 24, 16, 1024),
    "gpt-1.5b": _gpt(50257, 1600, 48, 25, 1024),  # GPT-2 XL
    "gpt-2.7b": _gpt(50257, 2560, 32, 32, 2048),
    "gpt-6.7b": _gpt(50257, 4096, 32, 32, 2048),
    # OPT: the ReLU branch of the same code (the +2 position offset of HF
    # checkpoints is an import detail)
    "opt-125m": _gpt(50272, 768, 12, 12, 2048, "relu"),
    "opt-1.3b": _gpt(50272, 2048, 24, 32, 2048, "relu"),
    "opt-6.7b": _gpt(50272, 4096, 32, 32, 2048, "relu"),
    "opt-13b": _gpt(50272, 5120, 40, 40, 2048, "relu"),
    "opt-30b": _gpt(50272, 7168, 48, 56, 2048, "relu"),
    # Baichuan-1: LLaMA's layer; 7B with rotary positions, 13B with ALiBi
    "baichuan-7b": ModelConfig(
        vocab_size=64000, hidden_size=4096, num_layers=32, num_heads=32,
        ffn_dim=11008, max_seq_len=4096,
    ),
    "baichuan-13b": ModelConfig(
        vocab_size=64000, hidden_size=5120, num_layers=40, num_heads=40,
        ffn_dim=13696, max_seq_len=4096, pos_embed="alibi",
    ),
    # encoders: BERT (the GPT layer, bidirectional, masked-LM) and ViT (the
    # same layer over 196 or 256 patches of a 224-pixel image)
    "bert-base": _gpt(30528, 768, 12, 12, 512).replace(causal=False, objective="mlm"),
    "bert-large": _gpt(30528, 1024, 24, 16, 512).replace(causal=False, objective="mlm"),
    # encoder-decoder (the reference's legacy t5 model_type with learned
    # positions, not T5's relative bias: its documented deviation)
    "t5-base": _t5(768, 12, 12, 3072),
    "t5-large": _t5(1024, 24, 16, 4096),
    "t5-3b": _t5(1024, 24, 32, 16384),
    "vit-base": _vit(768, 12, 12, 16),
    "vit-large": _vit(1024, 24, 16, 16),
    "vit-huge": _vit(1280, 32, 16, 14),
}
