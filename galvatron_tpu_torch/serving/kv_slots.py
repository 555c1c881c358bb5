"""Per-request capacity clamp shared by the KV backends (the port's copy of
``effective_max_seq_len`` from ``galvatron_tpu/serving/kv_slots.py``; the
contiguous slot backend itself is not ported yet, ROADMAP.md §1 "Slot KV
backend")."""

from __future__ import annotations

import warnings
from typing import Optional

from galvatron_tpu_torch.models.modeling import ModelConfig


def effective_max_seq_len(cfg: ModelConfig, max_seq_len: Optional[int]) -> int:
    """Clamp a requested per-request capacity to ``cfg.max_seq_len`` (rope
    tables do not extend past it), warning when the request was larger."""
    if max_seq_len is None:
        return int(cfg.max_seq_len)
    requested = int(max_seq_len)
    if requested > cfg.max_seq_len:
        warnings.warn(
            f"requested max_seq_len={requested} exceeds model cfg.max_seq_len="
            f"{cfg.max_seq_len}; clamping — the replica serves at most "
            f"{cfg.max_seq_len} tokens per request (see max_seq_len_effective "
            "in /healthz)",
            RuntimeWarning,
            stacklevel=3,
        )
        return int(cfg.max_seq_len)
    return requested
