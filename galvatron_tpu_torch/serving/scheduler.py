"""Iteration-level request scheduler (Orca, OSDI '22): the port's copy of
``galvatron_tpu/serving/scheduler.py``.

Requests enter a FIFO admission queue with a per-request deadline (TTL);
the engine admits the head whenever a slot frees and retires sequences at
decode-step granularity. A bounded queue rejects new work immediately
(``QueueFull`` → 503); a request that out-waits its deadline in queue is
expired with ``RequestExpired`` (→ 503).
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Deque, List, Optional

from galvatron_tpu_torch.serving import resilience as rz
from galvatron_tpu_torch.utils.metrics import Counters


class QueueFull(RuntimeError):
    """Admission queue at capacity: reject fast, the client backs off."""


class RequestExpired(RuntimeError):
    """Request out-lived its TTL in the admission queue or mid-prefill."""


_rid = itertools.count()


@dataclass
class Request:
    """One generation request moving through ``resilience.STATES``."""

    tokens: List[int]                 # prompt token ids
    max_new_tokens: int
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 0.0
    deadline: Optional[float] = None  # absolute time() the request may run to
    rid: int = field(default_factory=lambda: next(_rid))
    future: Future = field(default_factory=Future)
    submitted_at: float = field(default_factory=time.time)
    # engine-managed state
    slot: Optional[int] = None
    generated: List[int] = field(default_factory=list)
    first_token_at: Optional[float] = None
    state: str = rz.QUEUED
    cancel_requested: bool = False
    cancel_reason: Optional[str] = None
    # terminal detail: "eos" | "length" | "deadline"
    finish_reason: Optional[str] = None

    def cancel(self, reason: str = "cancelled") -> None:
        """Ask the engine to stop this request at the next decode iteration
        (or skip it at admission)."""
        self.cancel_requested = True
        if self.cancel_reason is None:
            self.cancel_reason = reason


class Scheduler:
    """FIFO admission queue with TTL expiry and bounded depth."""

    def __init__(self, max_queue: int = 64, default_ttl_s: Optional[float] = 30.0):
        self.max_queue = max(1, int(max_queue))
        self.default_ttl_s = default_ttl_s
        self._lock = threading.Lock()
        self._q: Deque[Request] = deque()  # guarded-by: self._lock
        self.counters = self.new_counters()

    @staticmethod
    def new_counters() -> Counters:
        return Counters(
            "submitted", "admitted", "completed", "failed",
            "rejected_queue_full", "expired", "expired_decode",
            "cancelled", "cancelled_disconnect", "shed",
        )

    def submit(self, req: Request, ttl_s: Optional[float] = None) -> Request:
        """Enqueue or raise ``QueueFull``. ``ttl_s`` overrides the default
        TTL; None with no default means the request never expires."""
        ttl = self.default_ttl_s if ttl_s is None else ttl_s
        if ttl is not None and req.deadline is None:
            req.deadline = req.submitted_at + float(ttl)
        with self._lock:
            if len(self._q) >= self.max_queue:
                self.counters.inc("rejected_queue_full")
                raise QueueFull(f"admission queue full ({self.max_queue} pending)")
            self._q.append(req)
        self.counters.inc("submitted")
        return req

    def expire(self, now: Optional[float] = None) -> List[Request]:
        """Drop every queued request past its deadline, failing its future."""
        now = time.time() if now is None else now
        dropped: List[Request] = []
        with self._lock:
            keep: Deque[Request] = deque()
            for r in self._q:
                if r.deadline is not None and now > r.deadline:
                    dropped.append(r)
                else:
                    keep.append(r)
            self._q = keep
        for r in dropped:
            rz.advance(r, rz.EXPIRED, self.counters, where="queue")
            if not r.future.done():
                r.future.set_exception(RequestExpired(
                    f"request {r.rid} expired after "
                    f"{now - r.submitted_at:.2f}s in queue"
                ))
        return dropped

    def peek(self, now: Optional[float] = None) -> Optional[Request]:
        """Head of the queue WITHOUT admitting it (expired ones shed first);
        only the engine loop pops, so peek→pop cannot race."""
        self.expire(now)
        with self._lock:
            return self._q[0] if self._q else None

    def pop(self, now: Optional[float] = None) -> Optional[Request]:
        """Next admissible request (expired ones already shed), or None."""
        self.expire(now)
        with self._lock:
            if not self._q:
                return None
            req = self._q.popleft()
        self.counters.inc("admitted")
        return req

    def _drop_all(self, state: str, reason: str, exc_for) -> List[Request]:
        with self._lock:
            dropped = list(self._q)
            self._q.clear()
        for r in dropped:
            if r.state not in rz.TERMINAL:
                rz.advance(r, state, self.counters, reason=reason)
            if not r.future.done():
                r.future.set_exception(exc_for(r))
        return dropped

    def drain(self, exc: Exception) -> List[Request]:
        """Fail every queued request (engine shutdown/crash give-up)."""
        return self._drop_all(rz.FAILED, "engine_shutdown", lambda r: exc)

    def shed_all(self) -> List[Request]:
        """Graceful drain: fail every queued-but-unstarted request fast with
        the distinct ``SHED`` status."""
        return self._drop_all(
            rz.SHED, "draining",
            lambda r: rz.RequestShed(
                f"request {r.rid} shed: server draining "
                "(queued, generation not started)"
            ),
        )

    @property
    def depth(self) -> int:
        with self._lock:
            return len(self._q)

    @property
    def saturated(self) -> bool:
        return self.depth >= self.max_queue

    def empty(self) -> bool:
        return self.depth == 0
