"""Decomposed collective matmul for the TP projection seams (the port of
``galvatron_tpu/ops/collective_matmul.py``).

Under sequence parallelism a column-parallel projection is ``all-gather(x
over the sequence) → GEMM`` and its row-parallel dual ``GEMM →
reduce-scatter(y over the sequence)``, each collective blocking its GEMM.
Here the operand (or the partial-sum accumulator) travels the TP ring one
sequence chunk a step (``comm.ring_post``: asynchronous sends and receives)
while the GEMM runs on the chunk already in hand, so each hop hides behind
a 1/T-sized GEMM ("Overlap Communication with Dependent Computation via
Decomposition in Large Deep Learning Models", Wang et al., ASPLOS'23). The
GEMMs stay ``torch.matmul``: this is a schedule, not a kernel. Over NCCL
the hops overlap the GEMMs on the card; over gloo they are merely correct.

- :func:`allgather_matmul` — all-gather⊗matmul: this rank's sequence chunk
  ``x`` (b, s, k) times its weight shard ``w`` (k, n), the chunk rotated to
  the ring successor meanwhile; each product lands at the originating
  chunk's offset. Output (b, T·s, n): the full sequence, this rank's
  columns — what the gather followed by one GEMM gives.
- :func:`matmul_reducescatter` — matmul⊗reduce-scatter: ``x`` (b, S, f)
  holds this rank's columns of the full sequence and ``w`` (f, h) its rows;
  one chunk's partial product a step is added into an accumulator that
  rotates the ring, so after T steps rank i holds the sum for chunk i (the
  SP layout). ``scatter=False`` (no SP) gathers the chunks back for the
  replicated output: the reduce half of the all-reduce is pipelined, the
  gather half blocks.

Both are ``torch.autograd.Function``s whose backward is the dual ring
(through ``shard_map`` the reference gets it by transposition; here it is
written out): the all-gather⊗matmul's input gradient is a reduce-scatter
ring of ``dy @ wᵀ`` chunks, the matmul⊗reduce-scatter's an all-gather ring
of ``dy`` chunks, each weight gradient one GEMM over the whole sequence.
The ring order is the TP group's (``Group.ranks``, consecutive or strided
as the plan lays it out). A group of one rank, or a sequence the ring does
not divide, takes the plain path in ``models/modeling.py`` (the reference's
fallbacks).
"""

from __future__ import annotations

from typing import Callable, List, Optional

import torch

from galvatron_tpu_torch.parallel import comm
from galvatron_tpu_torch.parallel.mesh import Group

#: ring hops posted, forward and backward (one per step of a ring)
hops = 0


def _flat(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1, t.shape[-1])


def _shift(t: torch.Tensor, group: Group):
    """Post ``t`` to the ring successor; returns a function that waits and
    gives the predecessor's tensor."""
    global hops
    hops += 1
    (buf,), posted = comm.ring_post([t.contiguous()], group)

    def done() -> torch.Tensor:
        comm.wait_all(posted.wait())
        return buf

    return done


def _ag_ring(x: torch.Tensor, group: Group, fn: Callable[[torch.Tensor, int], None]) -> None:
    """Visit every member's chunk: ``fn(chunk, src)`` on the chunk in hand
    (from ring position ``src``) while the next one travels."""
    t_size, idx = group.size, group.index
    chunk = x.contiguous()
    for t in range(t_size):
        nxt = _shift(chunk, group) if t < t_size - 1 else None
        fn(chunk, (idx - t) % t_size)
        if nxt is not None:
            chunk = nxt()


def _rs_ring(partial: Callable[[int], torch.Tensor], group: Group) -> torch.Tensor:
    """The sum over the members of ``partial(c)`` for this rank's chunk c =
    index: the accumulator resting on member i visits i+1, ..., i+T = i, and
    at step t member i adds its partial for chunk (i - 1 - t) mod T while
    the next hop travels."""
    t_size, idx = group.size, group.index
    acc = partial((idx - 1) % t_size)
    for t in range(1, t_size):
        arrived = _shift(acc, group)
        mine = partial((idx - 1 - t) % t_size)
        acc = arrived() + mine
    return acc


def _chunks(t: torch.Tensor, parts: int) -> List[torch.Tensor]:
    return list(t.chunk(parts, dim=1))


class _AllGatherMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, group):
        t_size = group.size
        outs: List[Optional[torch.Tensor]] = [None] * t_size
        held: List[Optional[torch.Tensor]] = [None] * t_size

        def gemm(chunk, src):
            outs[src] = chunk @ w
            held[src] = chunk

        _ag_ring(x, group, gemm)
        # the gathered input, for the weight gradient (the plain path saves it too)
        ctx.save_for_backward(torch.cat(held, dim=1), w)
        ctx.group = group
        return torch.cat(outs, dim=1)

    @staticmethod
    def backward(ctx, dy):
        full, w = ctx.saved_tensors
        dys = _chunks(dy, ctx.group.size)
        wt = w.t()
        dx = _rs_ring(lambda c: dys[c] @ wt, ctx.group)
        dw = _flat(full).t() @ _flat(dy)
        return dx, dw, None


class _MatmulReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, group, scatter, act):
        a = act(x) if act is not None else x
        parts = _chunks(a, group.size)
        y = _rs_ring(lambda c: parts[c] @ w, group)
        if not scatter:
            y = comm.all_gather(y, group, 1)
        ctx.save_for_backward(x, w)
        ctx.group, ctx.scatter, ctx.act = group, scatter, act
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        group, act = ctx.group, ctx.act
        with torch.enable_grad():
            x_ = x.detach().requires_grad_(act is not None)
            a = act(x_) if act is not None else x_
        wt = w.t()
        if ctx.scatter:
            # this rank's chunk of dy in, every chunk visited: dx chunk by
            # chunk behind the ring, dw in one GEMM over the gathered dy
            das: List[Optional[torch.Tensor]] = [None] * group.size
            dys: List[Optional[torch.Tensor]] = [None] * group.size

            def gemm(chunk, src):
                das[src] = chunk @ wt
                dys[src] = chunk

            _ag_ring(dy, group, gemm)
            da, dy_full = torch.cat(das, dim=1), torch.cat(dys, dim=1)
        else:
            # the replicated output's gradient is whole on every member
            da, dy_full = dy @ wt, dy
        dw = _flat(a.detach()).t() @ _flat(dy_full)
        if act is None:
            return da, dw, None, None, None
        (dx,) = torch.autograd.grad(a, x_, da)
        return dx, dw, None, None, None


def allgather_matmul(x: torch.Tensor, w: torch.Tensor, group: Group) -> torch.Tensor:
    """``all_gather(x, dim 1) @ w`` with the gather pipelined behind the
    GEMM chunks: ``x`` (b, s, k) is this rank's sequence chunk, ``w`` (k, n)
    its weight shard; returns (b, T·s, n)."""
    return _AllGatherMatmul.apply(x, w, group)


def matmul_reducescatter(x: torch.Tensor, w: torch.Tensor, group: Group, scatter: bool = True,
                         act: Optional[Callable] = None) -> torch.Tensor:
    """``reduce_scatter(act(x) @ w, dim 1)`` (``scatter``) or
    ``all_reduce(act(x) @ w)`` with the reduction pipelined behind the GEMM
    chunks: ``x`` (b, S, f) holds this rank's columns, ``w`` (f, h) its
    rows. ``act`` (the MLP activation product) is applied in the forward and
    recomputed in the backward from the saved ``x``, as the port's 'gate'
    recompute does, so the product is never saved."""
    if x.shape[1] % group.size:
        raise ValueError(f"sequence {x.shape[1]} does not split over the TP ring of "
                         f"{group.size}")
    return _MatmulReduceScatter.apply(x, w, group, scatter, act)
