"""Step accounting: model-FLOPs estimate, tokens/s, achieved TFLOP/s, MFU
(the port's copy of ``galvatron_tpu/obs/stepstats.py``'s FLOP model).

Model FLOPs (feeds MFU) are fwd + 2x fwd backward with no recompute;
hardware FLOPs add what recompute replays. Attention-core FLOPs use the
full s x s product pair (no causal discount), Megatron's convention, so an
encoder's unmasked attention counts what a decoder's does. The head counts
the loss-carrying positions (``modeling.loss_tokens_per_sample``: the
masked ones for 'mlm', one a sample for 'cls'). A ViT's sequence is its
patches and its head has ``num_classes`` columns (the JAX package counts
the pixels as the sequence and ``vocab_size`` as the head: ROADMAP.md §3,
"Kept differences"); its patch projection is not counted, as the
reference does not count the embedding. An encoder-decoder counts what the
reference counts: all ``total_layers`` layers as uniform layers over the
whole row (``enc_seq`` + the decoder's sequence), tokens of the whole row,
no cross-attention, and the decoder's positions at the head. A Swin
pyramid counts each layer at its stage's width over its stage's tokens
(a quarter a stage), its attention core over the w² keys of a window, each
patch merge's 4C → 2C projection over its output tokens, and the head at
the last stage's width; its tokens are the stage-0 patches (the JAX package
has no Swin count and would charge every layer stage 0's width and
attention over all patches: ROADMAP.md §3, "Kept differences"). The
peak is the card's published dense bf16 rate, looked up by device name.
The rate fields are device metrics: on the CPU they are None, never a CPU
number under a device metric's name.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Union

import torch

from galvatron_tpu_torch.models.modeling import (
    ModelConfig,
    loss_tokens_per_sample,
    swin_geometry,
    swin_stage_of,
    swin_window_for,
    vision_layer_cfg,
)

# per-card peak dense bf16 TFLOP/s (NVIDIA data sheets, SXM parts at the
# full power limit), keyed by the whole torch.cuda.get_device_name(): the
# PCIe and NVL parts of the same chips ("NVIDIA H100 PCIe", "NVIDIA H100
# NVL", "NVIDIA H200 NVL") peak lower and are not in the table
_PEAK_TFLOPS_BY_NAME = {
    "NVIDIA H100 80GB HBM3": 989.0,
    "NVIDIA H200": 989.0,
}


def peak_flops_per_device(device) -> Optional[float]:
    """Peak dense FLOP/s of ``device``, or None for the CPU and cards not
    in the table (a made-up denominator would be worse than no MFU)."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    tf = _PEAK_TFLOPS_BY_NAME.get(torch.cuda.get_device_name(device))
    return None if tf is None else tf * 1e12


def attn_proj_flops_per_token(cfg: ModelConfig) -> float:
    """QKV + output projection matmul FLOPs for one token, one layer."""
    h, hd = cfg.hidden_size, cfg.head_dim
    qkv_cols = h + 2 * cfg.kv_heads * hd
    return 2.0 * h * qkv_cols + 2.0 * h * h


def attn_core_flops_per_token(cfg: ModelConfig, seq_len: int) -> float:
    """q@k^T and p@v for one token against ``seq_len`` keys (full square)."""
    return 2.0 * 2.0 * seq_len * cfg.hidden_size


def mlp_flops_per_token(cfg: ModelConfig) -> float:
    n_gemm = 3 if cfg.act_fn == "swiglu" else 2  # gate + up + down vs up + down
    return 2.0 * n_gemm * cfg.hidden_size * cfg.ffn


def layer_fwd_flops_per_token(cfg: ModelConfig, seq_len: int) -> float:
    return (
        attn_proj_flops_per_token(cfg)
        + attn_core_flops_per_token(cfg, seq_len)
        + mlp_flops_per_token(cfg)
    )


def head_flops_per_loss_token(cfg: ModelConfig) -> float:
    return 2.0 * cfg.hidden_size * (cfg.num_classes if cfg.image_size else cfg.vocab_size)


def _modes(cfg: ModelConfig, ckpt: Union[str, Sequence[str]]) -> list:
    """Every layer's recompute mode; ``ckpt`` is one mode for every layer
    or a list of per-layer modes."""
    modes = [ckpt] * cfg.total_layers if isinstance(ckpt, str) else list(ckpt)
    if len(modes) != cfg.total_layers:
        # a pipeline stage's own list would count only its layers
        raise ValueError(f"{len(modes)} recompute modes for {cfg.total_layers} layers: pass "
                         "every layer's (Runtime.ckpts), not one stage's")
    return modes


def _remat_layer_flops_per_token(cfg: ModelConfig, seq_len: int, mode: str) -> float:
    """Forward compute one layer replays in the backward, per token."""
    if mode == "full":
        return layer_fwd_flops_per_token(cfg, seq_len)
    if mode == "selective":
        return attn_core_flops_per_token(cfg, seq_len)
    return mlp_flops_per_token(cfg) if cfg.mlp_recompute != "off" else 0.0


def _remat_fwd_flops_per_token(cfg: ModelConfig, seq_len: int,
                               ckpt: Union[str, Sequence[str]]) -> float:
    """Forward compute replayed in the backward, per token over all layers."""
    return sum(_remat_layer_flops_per_token(cfg, seq_len, m) for m in _modes(cfg, ckpt))


def swin_fwd_flops_per_sample(cfg: ModelConfig, ckpt: Union[str, Sequence[str]] = "none"):
    """(forward FLOPs, forward FLOPs recompute replays) of one Swin sample:
    each layer at its stage's width over its stage's tokens, attention over
    a window's w² keys, and the patch merges' projections; the head is not
    included."""
    fwd = remat = 0.0
    for i, mode in enumerate(_modes(cfg, ckpt)):
        stage = swin_stage_of(cfg, i)[0]
        h, w, _, _ = swin_geometry(cfg, stage)
        keys = swin_window_for(cfg, stage) ** 2
        lc = vision_layer_cfg(cfg, i)
        fwd += h * w * layer_fwd_flops_per_token(lc, keys)
        remat += h * w * _remat_layer_flops_per_token(lc, keys, mode)
    for stage in range(len(cfg.swin_depths) - 1):
        h, w, c, _ = swin_geometry(cfg, stage)
        fwd += (h // 2) * (w // 2) * 2.0 * (4 * c) * (2 * c)
    return fwd, remat


@dataclass
class StepStats:
    """Per-step FLOPs for one (model, batch, recompute) shape;
    ``per_iter(iter_ms)`` turns a measured step time into JSONL fields.
    ``ckpt`` is one recompute mode or a list of every layer's modes; a step
    of ``world`` ranks shares the whole model's FLOPs among them (the
    per-device rate, the reference's: under a pipeline each stage runs only
    its layers, and the world's devices together run them all).
    ``seq_len`` is the sequence the layers run over (a ViT's patches; an
    encoder-decoder's decoder, to which its ``enc_seq`` is added)."""

    cfg: ModelConfig
    global_bsz: int
    seq_len: int
    device: torch.device
    ckpt: Union[str, Sequence[str]] = "none"
    world: int = 1

    def __post_init__(self):
        cfg = self.cfg
        loss_tokens = float(self.global_bsz) * loss_tokens_per_sample(cfg, self.seq_len)
        seq = self.seq_len + cfg.enc_seq if cfg.enc_layers else self.seq_len
        tokens = float(self.global_bsz) * seq
        if cfg.swin_depths:
            layers, remat = swin_fwd_flops_per_sample(cfg, self.ckpt)
            last = vision_layer_cfg(cfg, cfg.num_layers - 1)
            fwd = (self.global_bsz * layers
                   + loss_tokens * head_flops_per_loss_token(last))
            remat *= self.global_bsz
        else:
            fwd = (tokens * cfg.total_layers * layer_fwd_flops_per_token(cfg, seq)
                   + loss_tokens * head_flops_per_loss_token(cfg))
            remat = tokens * _remat_fwd_flops_per_token(cfg, seq, self.ckpt)
        self.model_flops_per_step = 3.0 * fwd
        self.hardware_flops_per_step = self.model_flops_per_step + remat
        self.tokens_per_step = tokens
        self.on_device = torch.device(self.device).type == "cuda"
        self._peak = peak_flops_per_device(self.device)

    def per_iter(self, iter_ms: Optional[float],
                 nonpad_tokens: Optional[float] = None) -> Dict[str, Optional[float]]:
        """tokens/s (global), achieved model TFLOP/s, MFU and HFU per card
        of one measured iteration; all None off the card (and MFU/HFU for a
        card of unknown peak).

        ``nonpad_tokens`` (packed sequences): the batch's real-token count.
        ``tokens_per_s`` and MFU/HFU then count non-pad tokens only (padded
        positions burn FLOPs but are not useful work); the pad-inclusive
        rate is ``tokens_per_s_raw`` and the ratio ``packing_efficiency``
        (the reference's fields; the ratio is reported on the CPU too)."""
        out: Dict[str, Optional[float]] = {
            "tokens_per_s": None, "tflops_per_device": None, "mfu": None, "hfu": None,
        }
        raw = self.tokens_per_step
        useful = 1.0
        if nonpad_tokens is not None:
            # a property of the batch, not a device rate: on the CPU too
            useful = min(1.0, float(nonpad_tokens) / raw) if raw > 0 else 1.0
            out["tokens_per_s_raw"] = None
            out["packing_efficiency"] = useful
        if not self.on_device or not iter_ms or iter_ms <= 0:
            return out
        s = iter_ms / 1000.0
        rate = useful * self.model_flops_per_step / s / self.world
        out["tokens_per_s"] = useful * raw / s
        out["tflops_per_device"] = rate / 1e12
        if nonpad_tokens is not None:
            out["tokens_per_s_raw"] = raw / s
        if self._peak:
            out["mfu"] = rate / self._peak
            out["hfu"] = useful * self.hardware_flops_per_step / s / self.world / self._peak
        return out
