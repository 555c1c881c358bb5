"""Retry with exponential backoff for transient I/O (the port's copy of
``galvatron_tpu/core/retry.py``).

Shared by checkpoint save/restore and the corpus readers: a checkpoint or
corpus filesystem may be network-attached (NFS, a fuse mount), where
transient ``OSError``s are routine and a single failed read should not kill
a multi-hour run. Deliberately I/O-scoped:
only exceptions in ``policy.retryable`` (default ``OSError``) are retried;
everything else — including corruption, structure mismatches, and the
deterministic ``OSError`` subclasses in ``policy.non_retryable``
(missing path, permission denied), which retrying cannot fix —
propagates immediately.

Backoff delays carry **full jitter** (AWS architecture-blog sense: each
delay is uniform in ``[0, base·backoff^n]``, capped). A deterministic
schedule synchronizes every host of a job: after a shared storage blip all
N hosts retry at exactly base, then exactly 2·base, ... — a thundering
herd that re-creates the overload it is backing off from on NFS/GCS.
``jitter="none"`` restores the deterministic schedule for callers that
need reproducible timing.

Two observability/bounding layers ride every call:

- **retry budget** — ``max_elapsed_s`` caps the *wall-clock* a single call
  may spend retrying (attempt count alone is a poor bound once backoff
  grows: 5 attempts at a 10s cap can hold a preemption drain hostage for
  40s). When the budget cannot cover the next backoff, the call gives up
  early with the elapsed time noted.
- **counters** — module-level :data:`RETRY_COUNTERS` (utils/metrics.py
  ``Counters``) accumulate ``io_retry`` (every retried attempt) and
  ``io_give_up`` (every exhausted call) process-wide, so storage
  flakiness is visible as a rising retry rate *before* it becomes an
  outage.
"""

from __future__ import annotations

import dataclasses
import random
import time
from typing import Any, Callable, Optional, Tuple, Type

from galvatron_tpu_torch.utils.metrics import Counters

#: process-wide transient-I/O retry telemetry
RETRY_COUNTERS = Counters("io_retry", "io_give_up")


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    # defaults sized for the stated purpose — riding out routine
    # network-filesystem stalls on multi-hour runs: 5 attempts with
    # 0.2/0.4/0.8/1.6s backoff ≈ 3s of ride-through (a 3-attempt/0.15s
    # window would lose the run to any sub-second GCS-fuse/NFS blip)
    attempts: int = 5
    base_delay_s: float = 0.2
    max_delay_s: float = 10.0
    backoff: float = 2.0
    retryable: Tuple[Type[BaseException], ...] = (OSError,)
    # deterministic OSError subclasses retrying can never fix: a typo'd path
    # or a permission problem must surface as itself on the first attempt,
    # not as a "failed after 3 attempts" transient-I/O exhaustion
    non_retryable: Tuple[Type[BaseException], ...] = (
        FileNotFoundError,
        PermissionError,
        IsADirectoryError,
        NotADirectoryError,
    )
    # "full" (default): uniform in [0, capped exponential] — decorrelates
    # the hosts of a job retrying the same shared-storage fault; "none":
    # the old deterministic schedule (reproducible-timing callers only)
    jitter: str = "full"
    # per-call wall-clock retry budget (seconds); None = bounded by attempt
    # count only. A preemption drain with 30s of grace cannot afford a
    # retry loop whose backoff alone can exceed it.
    max_elapsed_s: Optional[float] = None

    def __post_init__(self):
        if self.jitter not in ("full", "none"):
            raise ValueError(f"jitter must be 'full' or 'none', got {self.jitter!r}")

    def max_delay(self, attempt: int) -> float:
        """Deterministic ceiling for retry ``attempt`` (0-based):
        min(max_delay_s, base * backoff^n) — the jitter's upper bound."""
        return min(self.max_delay_s, self.base_delay_s * self.backoff ** attempt)

    def delay(self, attempt: int, rng=random) -> float:
        """Backoff before retry ``attempt``: full jitter draws uniformly
        from [0, :meth:`max_delay`]; ``jitter='none'`` returns the ceiling
        itself. ``rng`` (anything with ``.uniform``) is injectable so tests
        can pin the distribution."""
        cap = self.max_delay(attempt)
        if self.jitter == "none" or cap <= 0:
            return cap
        return rng.uniform(0.0, cap)


def with_retries(
    fn: Callable[[], Any],
    policy: Optional[RetryPolicy] = None,
    describe: str = "",
    on_retry: Optional[Callable[[int, BaseException], None]] = None,
    sleep: Callable[[float], None] = time.sleep,
) -> Any:
    """Run ``fn()`` with up to ``policy.attempts`` tries; exponential backoff
    between tries; the final failure propagates with the attempt count noted
    via exception note (non-retryable exceptions propagate immediately)."""
    policy = policy or RetryPolicy()
    last: Optional[BaseException] = None
    start = time.monotonic()
    attempts_made = 0
    for attempt in range(policy.attempts):
        try:
            return fn()
        except policy.retryable as e:
            if isinstance(e, policy.non_retryable):
                raise
            last = e
            attempts_made = attempt + 1
            if attempts_made >= policy.attempts:
                break
            delay = policy.delay(attempt)
            if policy.max_elapsed_s is not None and (
                time.monotonic() - start + delay > policy.max_elapsed_s
            ):
                # the budget cannot cover the next backoff: give up now
                # rather than blow the caller's deadline sleeping
                break
            RETRY_COUNTERS.inc("io_retry")
            if on_retry is not None:
                on_retry(attempt, e)
            sleep(delay)
    assert last is not None
    RETRY_COUNTERS.inc("io_give_up")
    if hasattr(last, "add_note"):  # 3.11+
        last.add_note(
            f"({describe or 'operation'} failed after {attempts_made} "
            f"attempt(s) in {time.monotonic() - start:.2f}s"
            + (f", retry budget {policy.max_elapsed_s}s" if policy.max_elapsed_s is not None else "")
            + ")"
        )
    raise last
