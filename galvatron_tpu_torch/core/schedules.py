"""Schedules of a training run (the port's copy of
``galvatron_tpu/core/schedules.py``): the learning rate, the global batch
size's ramp-up, and the fp16 dynamic loss scaler.

The learning rate is evaluated in fp32 like the reference, which computes it
inside the jitted update from the fp32 step count: a tensor step gives a 0-d
fp32 tensor, an int step a float. The scaler state is two 0-d tensors on the
rank's device, replicated on every rank, updated with the reference's
arithmetic (fp32 scale, int32 count of clean steps).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict

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


@dataclass(frozen=True)
class BatchSizeRampup:
    """Global batch size as a function of consumed samples (Megatron's
    ``--rampup-batch-size <start> <increment> <ramp-up samples>``).

    The size grows from ``start`` to ``target`` in steps of ``increment``;
    each intermediate size is held for an equal share of ``rampup_samples``.
    """

    start: int
    increment: int
    rampup_samples: int
    target: int

    def __post_init__(self):
        if self.increment <= 0 or self.start <= 0:
            raise ValueError("start and increment must be positive")
        if self.start > self.target:
            raise ValueError(f"start {self.start} must not exceed target {self.target}")
        if (self.target - self.start) % self.increment != 0:
            raise ValueError(
                f"target-start ({self.target}-{self.start}) must be a multiple of "
                f"increment {self.increment} (reference constraint, microbatches.py)"
            )

    def __call__(self, consumed_samples: int) -> int:
        steps = (self.target - self.start) // self.increment
        if steps == 0 or consumed_samples >= self.rampup_samples:
            return self.target
        per = self.rampup_samples / steps
        i = int(consumed_samples / per)
        return min(self.start + i * self.increment, self.target)

    def sizes(self):
        return list(range(self.start, self.target + 1, self.increment))


# ---------------------------------------------------------------------------
# fp16 dynamic loss scaling
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class LossScalerConfig:
    """The reference's defaults: initial scale 2^16, growth 2.0 every 1000
    clean steps, backoff 0.5, floor 1.0 (Megatron's DynamicGradScaler)."""

    initial_scale: float = 2.0**16
    growth_factor: float = 2.0
    backoff_factor: float = 0.5
    growth_interval: int = 1000
    min_scale: float = 1.0


def init_scaler_state(cfg: LossScalerConfig, device="cpu") -> Dict[str, Any]:
    return {
        "scale": torch.tensor(cfg.initial_scale, dtype=torch.float32, device=device),
        "good_steps": torch.zeros((), dtype=torch.int32, device=device),
    }


def all_finite(tensors) -> torch.Tensor:
    """One 0-d bool tensor: every element of every tensor is finite."""
    flags = [torch.isfinite(t).all() for t in tensors]
    return torch.stack(flags).all() if flags else torch.tensor(True)


def scaler_update(state: Dict[str, Any], finite, cfg: LossScalerConfig) -> Dict[str, Any]:
    """Next scaler state given whether this step's grads were all finite:
    growth after ``growth_interval`` consecutive clean steps; backoff (and
    a skipped update, the caller's part) on overflow."""
    scale, good = state["scale"], state["good_steps"]
    finite = torch.as_tensor(finite, device=scale.device)
    grown = torch.where(good + 1 >= cfg.growth_interval, scale * cfg.growth_factor, scale)
    backed = torch.clamp_min(scale * cfg.backoff_factor, cfg.min_scale)
    new_scale = torch.where(finite, grown, backed)
    new_good = torch.where(finite & (good + 1 < cfg.growth_interval), good + 1,
                           torch.zeros_like(good))
    return {"scale": new_scale, "good_steps": new_good}


def scaled_value_and_grad(loss_fn, scale):
    """The fp16 loss-scaling pattern: the backward runs on ``loss * scale``,
    gradients come back unscaled in fp32 and the loss value is exact.
    ``loss_fn(params, *args)`` takes a list of tensors that require grad;
    the returned function gives ``(loss, grads)``. The hybrid runtime seeds
    its micro-batch backward the same way (``parallel/hybrid.py``)."""

    def run(params, *args):
        loss = loss_fn(params, *args)
        sgrads = torch.autograd.grad(loss * scale, params)
        return loss.detach(), [g.float() / scale for g in sgrads]

    return run
