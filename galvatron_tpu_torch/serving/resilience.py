"""Request lifecycle state machine and in-process engine crash supervision.

The port's copy of ``galvatron_tpu/serving/resilience.py``. Every request
moves through one lifecycle::

    QUEUED → PREFILLING → DECODING → {COMPLETED, FAILED, EXPIRED,
                                      CANCELLED, SHED}

and every terminal transition lands in a scheduler counter. The
reference's tracer instants and flight-recorder dumps are not ported yet
(ROADMAP.md §1, "Serving extras").
"""

from __future__ import annotations

import random
import time
from typing import Optional

QUEUED = "QUEUED"
PREFILLING = "PREFILLING"
DECODING = "DECODING"
COMPLETED = "COMPLETED"
FAILED = "FAILED"
EXPIRED = "EXPIRED"
CANCELLED = "CANCELLED"
SHED = "SHED"

STATES = (QUEUED, PREFILLING, DECODING, COMPLETED, FAILED, EXPIRED,
          CANCELLED, SHED)

TERMINAL = frozenset((COMPLETED, FAILED, EXPIRED, CANCELLED, SHED))

#: legal transitions; PREFILLING cannot COMPLETE (the first sampled token
#: only exists once the request is DECODING)
TRANSITIONS = {
    QUEUED: frozenset((PREFILLING, COMPLETED, FAILED, EXPIRED, CANCELLED, SHED)),
    PREFILLING: frozenset((DECODING, FAILED, EXPIRED, CANCELLED)),
    DECODING: frozenset((COMPLETED, FAILED, EXPIRED, CANCELLED)),
}

#: terminal state → scheduler counter bumped on entry
_STATE_COUNTER = {
    COMPLETED: "completed",
    FAILED: "failed",
    EXPIRED: "expired",
    CANCELLED: "cancelled",
    SHED: "shed",
}


class IllegalTransition(RuntimeError):
    """A lifecycle edge outside :data:`TRANSITIONS`: a scheduling bug."""


def advance(req, state: str, counters=None, **info) -> None:
    """Move ``req`` to ``state``: validate the edge and bump the matching
    terminal counter (``info`` carries the reason, as in the reference)."""
    cur = getattr(req, "state", QUEUED)
    if state not in TRANSITIONS.get(cur, frozenset()):
        raise IllegalTransition(
            f"request {req.rid}: illegal lifecycle transition {cur} → {state}"
        )
    req.state = state
    if counters is not None:
        name = _STATE_COUNTER.get(state)
        if name:
            counters.inc(name)
        if state == CANCELLED and info.get("reason") == "disconnect":
            counters.inc("cancelled_disconnect")
        if state == EXPIRED and cur == DECODING:
            counters.inc("expired_decode")


class RequestShed(RuntimeError):
    """Queued-but-unstarted when the drain began: 503, retry elsewhere."""


class RequestCancelled(RuntimeError):
    """Cancelled before completion (client disconnect)."""


class DeadlineExceeded(RuntimeError):
    """The end-to-end deadline passed and ``deadline_policy`` is ``fail``."""


class EngineDraining(RuntimeError):
    """Admission is closed for a drain: 503 with ``Retry-After``."""

    def __init__(self, msg: str, retry_after_s: Optional[float] = None):
        super().__init__(msg)
        self.retry_after_s = retry_after_s


class EngineClosed(RuntimeError):
    """The engine is shut down (or gave up restarting)."""


class EngineRestarted(RuntimeError):
    """The engine crashed and restarted while this request was in flight;
    ``retry_after_s`` is the supervisor's own backoff."""

    def __init__(self, msg: str, retry_after_s: Optional[float] = None):
        super().__init__(msg)
        self.retry_after_s = retry_after_s


class EngineSupervisor:
    """Restart decision table for the serving engine, in-process:

    ====================================  =====================================
    condition                             decision
    ====================================  =====================================
    crash, completions since last crash   restart (budget resets — progress)
    crash, no progress, budget left       restart after full-jitter backoff
    crash, no progress, budget exhausted  give up: engine closes, /readyz
                                          unready, every request 503s
    ====================================  =====================================

    The budget counts CONSECUTIVE no-progress crashes (a progressed crash
    resets the streak to 1); the backoff before restart n is uniform in
    ``[0, min(backoff_cap_s, backoff_s · 2^(n-1))]``.
    """

    def __init__(self, max_restarts: int = 3, backoff_s: float = 0.05,
                 backoff_cap_s: float = 2.0):
        self.max_restarts = max(0, int(max_restarts))
        self.backoff_s = float(backoff_s)
        self.backoff_cap_s = float(backoff_cap_s)
        self.consecutive = 0
        self.restarts_total = 0
        self.gave_up = False
        self._last_completed = 0

    def on_crash(self, engine, exc: BaseException) -> bool:
        """One crash of the engine loop. Returns True when the loop should
        continue (recovered), False on give-up."""
        completed = engine.scheduler.counters.get("completed")
        progressed = completed > self._last_completed
        self._last_completed = completed
        self.consecutive = 1 if progressed else self.consecutive + 1
        give_up = self.consecutive > self.max_restarts
        backoff = 0.0
        if not give_up:
            cap = min(self.backoff_cap_s, self.backoff_s * 2 ** (self.consecutive - 1))
            backoff = random.uniform(0.0, cap) if cap > 0 else 0.0
        engine._crash_cleanup(exc, retry_after_s=None if give_up else backoff)
        if give_up:
            self.gave_up = True
            return False
        self.restarts_total += 1
        engine.counters.inc("engine_restarts")
        if backoff:
            time.sleep(backoff)
        return True
