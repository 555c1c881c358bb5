"""The 1F1B (pipedream-flush) schedule (the port's counterpart of
``galvatron_tpu/parallel/pipeline_1f1b.py``).

The JAX package's clock: over T = chunks + 2(pp-1) ticks, on tick t stage s
forwards micro-batch ``t - s`` and backwards micro-batch ``t - 2(pp-1) + s``
when those are in range, the forward first, so the last stage runs both of
a micro-batch in one tick. Written out as action lists, the same executor as
GPipe's (``pipeline.execute``) runs it. Stage s then holds at most
``min(chunks, 2(pp-1-s)+1)`` micro-batches' activations, however many
chunks there are; the port keeps their autograd graphs where the JAX
package stashes stage inputs and recomputes (the same values).
"""

from __future__ import annotations

from galvatron_tpu_torch.parallel.pipeline import BWD, FWD, Schedule, from_ticks


def pipedream_schedule_ticks(pp: int, chunks: int):
    """The JAX package's tick model of 1F1B, the same records: ``(ticks,
    total_ticks)`` with ``{stage, tick, kind, mb}`` cells."""
    T = chunks + 2 * (pp - 1)
    ticks = []
    for s in range(pp):
        for t in range(T):
            m_f = t - s
            if 0 <= m_f < chunks:
                ticks.append({"stage": s, "tick": t, "kind": FWD, "mb": m_f})
            m_b = t - 2 * (pp - 1) + s
            if 0 <= m_b < chunks:
                ticks.append({"stage": s, "tick": t, "kind": BWD, "mb": m_b})
    return ticks, T


def pipedream_schedule(pp: int, chunks: int) -> Schedule:
    """1F1B as per-device action lists (at pp = 1: forward and backward of
    each micro-batch in turn, plain gradient accumulation)."""
    ticks, T = pipedream_schedule_ticks(pp, chunks)
    return from_ticks(pp, 1, chunks, T, [(c["stage"], c["tick"], c["kind"], c["stage"], c["mb"])
                                         for c in ticks]).check()
