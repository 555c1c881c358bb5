"""Memory-balanced pipeline stage division (the port's copy of
``galvatron_tpu/search/pp_division.py``, numpy only).

The reference's ``pp_division_memory_balanced``
(galvatron/core/search_engine.py:586-654): greedily fill stages from the
LAST stage backwards toward the average per-stage total (layer memory + the
stage's other memory), cap an over-full early stage at 1.3x the average by
shifting layers to the next stage, then repair empty stages. The port's
pipeline runs each stage's own layers (no padded stacks), so a
memory-balanced division does save memory here; the plan search (ROADMAP
§1.8) is its caller.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np


def pp_division_memory_balanced(
    layer_mem_mb: Sequence[float],
    pp: int,
    other_mem_per_stage_mb: Optional[Sequence[float]] = None,
) -> List[int]:
    """Stage division (len pp, entries >= 1, sum == len(layer_mem_mb)).

    layer_mem_mb: per-layer memory cost in stage order.
    other_mem_per_stage_mb: per-stage non-layer memory (len pp), e.g. the
      embedding on the first stage and the head on the last; zeros when
      omitted.
    """
    L = len(layer_mem_mb)
    if pp == 1:
        return [L]
    if L < pp:
        raise ValueError(f"cannot divide {L} layers over {pp} stages (>=1 each)")
    mems = np.asarray(layer_mem_mb, np.float64)
    other = (
        np.zeros(pp)
        if other_mem_per_stage_mb is None
        else np.asarray(other_mem_per_stage_mb, np.float64)
    )
    if other.shape != (pp,):
        raise ValueError(f"other_mem_per_stage_mb must have length {pp}")
    avg = (mems.sum() + other.sum()) / pp

    # greedy fill, last stage first (reference search_engine.py:610-621)
    division = [0] * pp
    stage_mem = other.copy()
    idx = L - 1
    for i in range(pp - 1, -1, -1):
        while idx >= 0:
            if i > 0 and avg - stage_mem[i] < 0.5 * mems[idx]:
                break
            stage_mem[i] += mems[idx]
            idx -= 1
            division[i] += 1

    # cap early stages at 1.3x average (reference :624-632)
    for i in range(pp - 1):
        left, right = sum(division[:i]), sum(division[: i + 1])
        cur = mems[left:right].sum() + other[i]
        while division[i] > 0 and cur > avg * 1.3:
            division[i] -= 1
            division[i + 1] += 1
            right -= 1
            cur -= mems[right]

    # repair empty stages (reference :635-644)
    for i in range(pp - 1):
        while division[i] <= 0:
            division[i] += 1
            division[i + 1] -= 1
    for i in range(pp - 1, 0, -1):
        while division[i] <= 0:
            division[i] += 1
            division[i - 1] -= 1
    assert sum(division) == L and all(n >= 1 for n in division), division
    return division


def spread_pairs(pairs: int, pp: int) -> List[int]:
    """Pairs over stages, zeros allowed, the remainder placed in
    ``balanced_division``'s stage order (the JAX package's
    ``parallel/pipeline_swin._spread_pairs``, which its search uses to lay
    out Swin sections, as the port's ``parallel/pipeline_swin`` lays out its
    pipeline)."""
    base, rem = divmod(pairs, pp)
    div = [base] * pp
    order = sorted(range(pp), key=lambda s: (abs(s - (pp - 1) / 2), -s))
    for i in range(rem):
        div[order[i]] += 1
    return div
