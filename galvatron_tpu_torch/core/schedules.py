"""Learning-rate schedule (the port's copy of ``LRSchedule`` in
``galvatron_tpu/core/schedules.py``).

Evaluated in fp32 like the reference, which computes it inside the jitted
update from the fp32 step count: a tensor step gives a 0-d fp32 tensor, an
int step a float. Batch-size ramp-up and the fp16 dynamic loss scaler are
not ported yet (ROADMAP.md §1).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class LRSchedule:
    """lr(step): linear warmup from ``warmup_init_lr`` to ``lr`` over
    ``warmup_iters``, then decay to ``min_lr`` at ``decay_iters`` following
    ``decay_style``, constant afterwards."""

    lr: float = 1e-4
    min_lr: float = 0.0
    warmup_iters: int = 0
    decay_iters: int = 0  # 0 → no decay (constant after warmup)
    decay_style: str = "cosine"  # 'constant' | 'linear' | 'cosine'
    warmup_init_lr: float = 0.0

    def __post_init__(self):
        if self.decay_style not in ("constant", "linear", "cosine"):
            raise ValueError(f"unknown decay_style {self.decay_style!r}")
        if self.min_lr > self.lr:
            raise ValueError("min_lr must not exceed lr")

    def __call__(self, step):
        f32 = torch.float32
        s = torch.as_tensor(step, dtype=f32)
        warm = torch.tensor(max(self.warmup_iters, 0), dtype=f32)
        wfrac = s / torch.clamp_min(warm, 1.0)
        warm_lr = self.warmup_init_lr + (self.lr - self.warmup_init_lr) * wfrac
        if self.decay_style == "constant" or self.decay_iters <= 0:
            decayed = torch.tensor(self.lr, dtype=f32)
        else:
            span = torch.tensor(max(self.decay_iters - self.warmup_iters, 1), dtype=f32)
            dfrac = torch.clamp((s - warm) / span, 0.0, 1.0)
            if self.decay_style == "linear":
                coeff = 1.0 - dfrac
            else:  # cosine
                coeff = 0.5 * (1.0 + torch.cos(math.pi * dfrac))
            decayed = self.min_lr + (self.lr - self.min_lr) * coeff
        out = torch.where(s < warm, warm_lr, decayed)
        if isinstance(step, int):
            return float(out)
        return out
