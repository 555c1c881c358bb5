"""Hardware profiler: collective bandwidth and the compute/communication
overlap coefficient over ``torch.distributed`` (the port's counterpart of
``galvatron_tpu/profiling/hardware.py``; reference:
galvatron/core/profiler.py:404-532, nccl-tests' ``all_reduce_perf`` /
``sendrecv_perf``, and profile_hardware/profile_overlap.py:14-160).

Every rank of the world runs :func:`profile_hardware` (the torchrun
environment contract: one rank per ``cuda:LOCAL_RANK``, NCCL on the card,
gloo on the CPU). It measures:

- **all-reduce bus bandwidth** (GB/s) for every ``(group size, consec)``
  layout ``parallel/mesh.py`` builds (consec = TP on the minor axes, the
  layout the search prices): each rank all-reduces a bf16 message of
  ``msg_mb`` MB (1e6 bytes) — the whole message on every rank, as
  nccl-tests sends it — and the value is nccl-tests' bus bandwidth
  2(n-1)/n · bytes / time. (The JAX profiler all-reduces one array sharded
  over the world, msg_mb / world per device; ROADMAP.md §3.)
- **p2p bandwidth** per pipeline degree: every stage sends ``msg_mb`` MB to
  the next (a ring, one ``batch_isend_irecv`` a step), bytes / time.
- **overlap coefficient**: a loop of 8 bf16 2048² GEMMs (256² on the
  CPU) and a world
  all-reduce of ``msg_mb`` MB, each timed alone, then together (the
  all-reduce issued asynchronously, on NCCL's stream on the card, while the
  GEMMs run on the compute stream); coe = together / max(alone), at least 1.

Each time is the median of ``iters`` windows of ``chain`` calls with one
synchronise a window, the slowest rank's (a MAX all-reduce), so every rank
writes the same numbers. A world of one rank measures nothing and writes
the JAX package's values for it: no all-reduce or p2p entries,
``overlap_coe`` 1.1. The JSON is ``utils/config_utils``'s schema (``dcn_keys``
stays empty: the port has no multi-slice layout).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from galvatron_tpu_torch.parallel.mesh import RankMesh
from galvatron_tpu_torch.search.cost_model import ProfiledHardware


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time_s(fn: Callable[[], None], device: torch.device, iters: int = 5,
            chain: int = 4) -> float:
    """Median seconds per call of ``fn`` over ``iters`` windows of ``chain``
    calls (one warm-up window first), the slowest rank's."""
    import torch.distributed as dist

    for _ in range(chain):
        fn()
    _sync(device)
    times = []
    for _ in range(iters):
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(chain):
            fn()
        _sync(device)
        times.append((time.perf_counter() - t0) / chain)
    t = torch.tensor([float(np.median(times))], dtype=torch.float64, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t.item())


def _groups(mesh: RankMesh, axes) -> List:
    """This rank's process group over ``axes`` (every rank creates every
    group of the partition, in one order, as ``new_group`` requires)."""
    import torch.distributed as dist

    mine = None
    rank = dist.get_rank()
    for ranks in mesh.partition(axes):
        g = dist.new_group(ranks)
        if rank in ranks:
            mine = g
    return mine


def profile_allreduce(mesh: RankMesh, device: torch.device, msg_mb: float = 64.0
                      ) -> Dict[str, float]:
    """Bus bandwidth (GB/s) for every (group size, consec) the world holds."""
    import torch.distributed as dist

    out: Dict[str, float] = {}
    m = len(mesh.axes.data_axes)
    n_elem = int(msg_mb * 1e6 / 2)
    x = torch.ones((n_elem,), dtype=torch.bfloat16, device=device)
    for k in range(1, m + 1):
        size = 2 ** k
        for consec in (True, False):
            if k == m and not consec:
                continue  # the full-extent group has one layout
            group = _groups(mesh, mesh.axes.tp_axes(size, consec))
            t = _time_s(lambda: dist.all_reduce(x, group=group), device)
            out[f"{size}_{int(consec)}"] = round(2.0 * (size - 1) / size * n_elem * 2 / t / 1e9, 3)
    return out


def profile_p2p(world: int, device: torch.device, msg_mb: float = 64.0) -> Dict[int, float]:
    """Send/recv bandwidth (GB/s) per pipeline degree: each stage sends
    ``msg_mb`` MB to the next stage's rank of its in-stage index."""
    import torch.distributed as dist

    out: Dict[int, float] = {}
    rank = dist.get_rank()
    n_elem = int(msg_mb * 1e6 / 2)
    send = torch.ones((n_elem,), dtype=torch.bfloat16, device=device)
    recv = torch.empty_like(send)
    pp = 2
    while pp <= world:
        mesh = RankMesh(world, pp)
        st, per = mesh.stage(rank), mesh.per_stage
        nxt = rank + (((st + 1) % pp) - st) * per
        prv = rank + (((st - 1) % pp) - st) * per

        def step():
            ops = [dist.P2POp(dist.isend, send, nxt), dist.P2POp(dist.irecv, recv, prv)]
            for w in dist.batch_isend_irecv(ops):
                w.wait()

        t = _time_s(step, device)
        out[pp] = round(n_elem * 2 / t / 1e9, 3)
        pp *= 2
    return out


def profile_overlap_coe(device: torch.device, msg_mb: float = 64.0) -> float:
    """Slowdown of a GEMM loop and an all-reduce run together over the
    slower of the two alone (reference: profile_overlap.py)."""
    import torch.distributed as dist

    # the reference's 2048² GEMMs on the card; the CPU (gloo worlds, whose
    # numbers only exercise the path) takes 256² so a loop lasts milliseconds
    n = 2048 if device.type == "cuda" else 256
    a = torch.full((n, n), 0.01, dtype=torch.bfloat16, device=device)
    x = torch.ones((int(msg_mb * 1e6 / 2),), dtype=torch.bfloat16, device=device)

    def mm():
        y = a
        for _ in range(8):
            y = y @ a
        return y

    def both():
        work = dist.all_reduce(x, async_op=True)
        mm()
        work.wait()

    t_mm = _time_s(mm, device)
    t_ar = _time_s(lambda: dist.all_reduce(x), device)
    t_both = _time_s(both, device)
    return round(max(1.0, t_both / max(t_mm, t_ar)), 4)


def profile_hardware(msg_mb: float = 64.0, out_path: Optional[str] = None,
                     device=None) -> ProfiledHardware:
    """The full sweep on this process's world (world 1: the degenerate
    values, nothing measured); rank 0 writes ``out_path``."""
    import torch.distributed as dist

    from galvatron_tpu_torch.device import rank_device

    device = rank_device(device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world == 1:
        hw = ProfiledHardware(allreduce_bw={}, p2p_bw={}, overlap_coe=1.1, dcn_keys=[])
    else:
        mesh = RankMesh(world)
        hw = ProfiledHardware(
            allreduce_bw=profile_allreduce(mesh, device, msg_mb),
            p2p_bw=profile_p2p(world, device, msg_mb),
            overlap_coe=profile_overlap_coe(device, msg_mb),
            dcn_keys=[],
        )
    if out_path and (world == 1 or dist.get_rank() == 0):
        from galvatron_tpu_torch.utils.config_utils import save_profiled_hardware

        save_profiled_hardware(hw, out_path)
    return hw
