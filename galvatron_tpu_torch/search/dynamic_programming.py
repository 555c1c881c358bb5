"""Layer-strategy dynamic program: the C++ core with a NumPy fallback (the
port's copy of ``galvatron_tpu/search/dynamic_programming.py``, same
arithmetic, so the same inputs give the same plan in both packages).

The DP assigns one strategy per layer (pp=1) or per stage-position (pp>1)
minimizing total time under a per-device memory budget, with inter-layer
transition costs for activation resharding when the TP degree/layout changes
between adjacent layers (reference transition matrix:
dynamic_programming.py:233-272). ``run_dp`` records the route it took in
``native.ROUTE``."""

from __future__ import annotations

from typing import Tuple

import numpy as np

from galvatron_tpu_torch.core.strategy import LayerStrategy
from galvatron_tpu_torch.search.cost_model import (
    ProfiledHardware,
    ProfiledLayerType,
    _allgather_ms,
)
from galvatron_tpu_torch.search import native


def dp_numpy(
    mem: np.ndarray, intra: np.ndarray, inter: np.ndarray, budget: int
) -> Tuple[float, np.ndarray, int]:
    """Pure-NumPy DP with the same semantics as csrc/dp_core.cpp (the
    reference keeps the same dual implementation,
    dynamic_programming.py:98-128). Vectorized over the budget axis."""
    L, S = mem.shape
    INF = np.inf
    V = budget
    f = np.full((V + 1, S), INF)
    choice = np.full((L, V + 1, S), -1, np.int16)
    for s in range(S):
        if mem[0, s] <= V and np.isfinite(intra[0, s]):
            f[mem[0, s] :, s] = intra[0, s]
    for i in range(1, L):
        fn = np.full((V + 1, S), INF)
        for s in range(S):
            m = mem[i, s]
            if m > V or not np.isfinite(intra[i, s]):
                continue
            prev = f[: V + 1 - m, :] + inter[:, s][None, :]  # (V+1-m, S)
            best_si = np.argmin(prev, axis=1)
            best = prev[np.arange(prev.shape[0]), best_si]
            ok = np.isfinite(best)
            fn[m:, s] = np.where(ok, best + intra[i, s], INF)
            choice[i, m:, s] = np.where(ok, best_si, -1)
        f = fn
    flat = np.argmin(f)
    v, s = np.unravel_index(flat, f.shape)
    if not np.isfinite(f[v, s]):
        return float("inf"), np.full((L,), -1, np.int32), 0
    cost = float(f[v, s])
    res = np.empty((L,), np.int32)
    vv, ss = int(v), int(s)
    for i in range(L - 1, -1, -1):
        res[i] = ss
        if i > 0:
            si = int(choice[i, vv, ss])
            vv -= int(mem[i, ss])
            ss = si
    return cost, res, int(v)


def run_dp(mem, intra, inter, budget) -> Tuple[float, np.ndarray, int]:
    out = native.dp_core_native(mem, intra, inter, budget)
    if out is not None:
        native.ROUTE = "native"
        return out
    native.ROUTE = "numpy"
    return dp_numpy(mem, intra, inter, budget)


def transition_cost_ms(
    a: LayerStrategy,
    b: LayerStrategy,
    lt: ProfiledLayerType,
    hw: ProfiledHardware,
    world: int,
    pp: int,
    global_bsz: int,
    mixed_precision: str = "bf16",
) -> float:
    """Activation-resharding time between adjacent layers with different
    TP/layout — the port's runtime moves the activation at the layer
    boundary (``parallel/comm.redistribute``); the cost is modeled as the all-gather
    of the boundary tensor over the axes whose sharding changes (reference:
    redistribution volume, dynamic_programming.py:233-246,357-372)."""
    if (a.tp, a.tp_consec, a.sp, a.cp) == (b.tp, b.tp_consec, b.sp, b.cp):
        return 0.0
    dp_b = world // (pp * b.tp * b.cp)
    bytes_factor = 0.5 if mixed_precision == "bf16" else 1.0
    msg = lt.boundary_activation_mb_per_sample * (global_bsz / dp_b) * bytes_factor
    # resharding ≈ all-gather over the union of changed axes, bounded by the
    # larger of the two tp groups; layout flips pay the strided bandwidth
    size = max(a.tp * a.cp, b.tp * b.cp)
    if size == 1:
        size = 2  # batch-dim resharding between different dp splits
    consec = a.tp_consec and b.tp_consec
    # fwd reshard + mirrored bwd reshard
    return 2.0 * _allgather_ms(msg, size, hw.bw(size, consec))
