"""Slot-managed contiguous KV cache for the continuous-batching engine (the
port of ``galvatron_tpu/serving/kv_slots.py``), and the per-request capacity
clamp both KV backends share.

One fixed cache, ``(L, num_slots, max_seq_len, kv_heads, head_dim)`` k and v
on the engine's device, lives for the whole server lifetime; a request
borrows a *slot* (one batch row) for its duration and returns it on
retirement. Host side the class is a small allocator: a free list plus
per-slot lengths. Slots are NOT zeroed on reuse: a new request's prefill
writes positions ``[0, P)`` before any query can see them, and causal
masking hides every position beyond a row's own write offset, so stale keys
from the previous occupant are never attended.
"""

from __future__ import annotations

import threading
import warnings
from typing import List, Optional

import numpy as np

from galvatron_tpu_torch.models import generation
from galvatron_tpu_torch.models.modeling import ModelConfig


def effective_max_seq_len(cfg: ModelConfig, max_seq_len: Optional[int]) -> int:
    """Clamp a requested per-request capacity to ``cfg.max_seq_len`` (rope
    tables and position embeddings do not extend past it), warning when the
    request was larger."""
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


class SlotKVCache:
    """Fixed ``(num_slots, max_seq_len)`` KV cache on ``device`` + slot
    allocator."""

    def __init__(self, cfg: ModelConfig, num_slots: int, device,
                 max_seq_len: Optional[int] = None):
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        self.cfg = cfg
        self.device = device
        self.num_slots = int(num_slots)
        self.max_seq_len = effective_max_seq_len(cfg, max_seq_len)
        self.cache = generation.init_kv_cache(cfg, self.num_slots, self.max_seq_len, device)
        # host bookkeeping: length = tokens materialised in the slot so far
        # (prompt + generated); the next token lands at position == length.
        # The lock covers the free list and the active set: the engine loop
        # allocates and frees while handler threads read the occupancy views
        self._lock = threading.Lock()
        self.lengths = np.zeros((self.num_slots,), np.int32)
        self._free: List[int] = list(range(self.num_slots - 1, -1, -1))  # guarded-by: self._lock
        self._active: set = set()  # guarded-by: self._lock

    # -- allocator ------------------------------------------------------------

    def alloc(self) -> Optional[int]:
        """Claim a free slot (length reset to 0); None when fully occupied."""
        with self._lock:
            if not self._free:
                return None
            slot = self._free.pop()
            self._active.add(slot)
            self.lengths[slot] = 0
            return slot

    def free(self, slot: int) -> None:
        with self._lock:
            if slot not in self._active:
                raise ValueError(f"slot {slot} is not active")
            self._active.discard(slot)
            self.lengths[slot] = 0
            self._free.append(slot)

    def reset(self) -> None:
        """Release every slot and zero the cache (engine crash recovery and
        drain): the state of a fresh cache, without allocating a second one
        beside it."""
        with self._lock:
            self._active.clear()
            self.lengths[:] = 0
            self._free = list(range(self.num_slots - 1, -1, -1))
            self.cache.k.zero_()
            self.cache.v.zero_()

    # -- views ----------------------------------------------------------------

    @property
    def free_slots(self) -> int:
        with self._lock:
            return len(self._free)

    @property
    def active_count(self) -> int:
        with self._lock:
            return len(self._active)

    def active_slots(self) -> List[int]:
        with self._lock:
            return sorted(self._active)

    @property
    def occupancy(self) -> float:
        with self._lock:
            return len(self._active) / self.num_slots

    def fits(self, prompt_len: int, max_new_tokens: int) -> bool:
        """Whole lifetime of the request stays inside the slot: the last
        generated token sits at position prompt_len + max_new_tokens - 1."""
        return prompt_len >= 1 and prompt_len + max_new_tokens <= self.max_seq_len

    def audit(self) -> dict:
        """Allocator invariant check (the drain's zero-leak proof): the free
        list and the active set partition the slot range exactly."""
        with self._lock:
            free_set = set(self._free)
            ok = (
                len(free_set) == len(self._free)
                and not (free_set & self._active)
                and (free_set | self._active) == set(range(self.num_slots))
            )
            return {
                "ok": ok,
                "free": len(self._free),
                "active": len(self._active),
                "num_slots": self.num_slots,
            }
