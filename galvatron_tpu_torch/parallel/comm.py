"""Collectives and point-to-point transfers of the hybrid runtime over
``torch.distributed`` groups.

The JAX package needs none of this: GSPMD inserts its collectives and a
pipeline moves activations with ``lax.ppermute``. Here they are explicit:
four collectives (``all_reduce``, ``all_gather_into_tensor``,
``reduce_scatter_tensor`` and ``all_to_all_single``) and batches of ``isend``
/ ``irecv`` (:func:`exchange`, on ``batch_isend_irecv``).

- Megatron's tensor-parallel region pairs as autograd Functions over a
  group (:class:`TPRegion`): copy (identity forward, all-reduce backward)
  and reduce (all-reduce forward, identity backward); under sequence
  parallelism, gather (all-gather of the sequence forward, reduce-scatter
  backward) and reduce-scatter (the transpose).
- ZeRO-3's parameter gather (:func:`gather_param`: all-gather forward,
  reduce-scatter of the fp32 gradient backward) and :class:`Regather`, which
  frees a gathered layer's parameters after its forward and gathers them
  again when the backward needs them.
- The redistribution of an activation between two layers' (batch rows,
  sequence slice) layouts over the ranks of one stage (:func:`redistribute`).
- A pipeline tick's sends and receives between stages (:func:`exchange`).
- The collective matmul's ring (``ops/collective_matmul.py``): the same
  shift left in flight (:func:`ring_post`), so that a GEMM queued meanwhile
  overlaps the transfer; and the gradient buckets' asynchronous
  reduce-scatter (:func:`reduce_scatter_async`).
- Context parallelism's two moves over a group: the ring shift, each
  member's tensors to its successor in the group's order (:func:`ring_shift`,
  one :func:`exchange`), and the all-to-all that re-shards an activation from
  one dimension to another (:func:`all_to_all`, ``lax.all_to_all(...,
  tiled=True)``; its backward is the move back).
- An MoE layer's moves (``models/moe.py``): the no-grad gather of the router
  logits over the token group (:func:`gather_logits`) and the dispatch and
  combine all-to-alls over the EP group (:func:`moe_dispatch`,
  :func:`moe_combine`), which GSPMD inserts at the reference's einsums.

Convention: a tensor replicated over a group holds the same value on every
member, and so does its gradient (Megatron's), so a redistribution's
backward is the same move in the other direction.

**gloo is a host transport.** When a group's backend is gloo and the tensor
lies on a card, the collective runs on a host copy and the result is copied
back; ``host_staged`` counts those calls (and the staged messages of
:func:`exchange`). NCCL never stages. A group of one rank issues no
collective.
"""

from __future__ import annotations

import warnings
from typing import List, Optional, Sequence, Tuple

import torch

from galvatron_tpu_torch.parallel.mesh import Axes, Group, RankMesh

#: collectives that ran on a host copy of a card tensor (gloo groups)
host_staged = 0
#: collectives issued (all kinds, groups of more than one rank)
issued = 0
#: zero3 parameters gathered again in a backward (:class:`Regather`)
regathered = 0
#: point-to-point messages posted (sends and receives, :func:`exchange`)
p2p = 0
#: MoE moves issued, by kind: "logits" gathers, "dispatch" / "combine"
#: all-to-alls (forward and backward each count one)
moe_moves = {"logits": 0, "dispatch": 0, "combine": 0}

# torch 2.13 renames the two tensor-list-free collectives (*_single) and warns
# on the old names, which older releases have alone
warnings.filterwarnings("ignore", message=r".*(all_gather_into_tensor|reduce_scatter_tensor)"
                        r"` is deprecated")


def reset_counts() -> None:
    global host_staged, issued, regathered, p2p
    host_staged = issued = regathered = p2p = 0
    for k in moe_moves:
        moe_moves[k] = 0


def _run(fn, out: torch.Tensor, inp: torch.Tensor, group: Group) -> torch.Tensor:
    """``fn(out, inp, pg)`` under the staging rule; returns ``out``."""
    global host_staged, issued
    issued += 1
    if group.backend == "gloo" and (out.is_cuda or inp.is_cuda):
        host_staged += 1
        h_out = out.detach().cpu()
        h_in = h_out if inp is out else inp.detach().cpu()
        fn(h_out, h_in, group.pg)
        out.copy_(h_out)
        return out
    fn(out, inp, group.pg)
    return out


def _dist():
    import torch.distributed as dist

    return dist


def all_reduce(t: torch.Tensor, group: Optional[Group], op: str = "sum") -> torch.Tensor:
    """In place over ``group``; returns ``t``."""
    if group is None or group.size == 1:
        return t
    dist = _dist()
    rop = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    return _run(lambda o, i, pg: dist.all_reduce(o, op=rop, group=pg), t, t, group)


def all_gather(t: torch.Tensor, group: Optional[Group], dim: int = 0) -> torch.Tensor:
    """The members' tensors concatenated along ``dim`` in group order."""
    if group is None or group.size == 1:
        return t
    dist = _dist()
    x = t.movedim(dim, 0).contiguous()
    out = torch.empty((group.size * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    _run(lambda o, i, pg: dist.all_gather_into_tensor(o, i, group=pg), out, x, group)
    return out.movedim(0, dim)


def reduce_scatter(t: torch.Tensor, group: Optional[Group], dim: int = 0) -> torch.Tensor:
    """The sum over the members, split along ``dim``: this member's piece."""
    if group is None or group.size == 1:
        return t
    dist = _dist()
    x = t.movedim(dim, 0).contiguous()
    if x.shape[0] % group.size:
        raise ValueError(f"reduce-scatter of {x.shape[0]} along dim {dim} over {group.size}")
    out = torch.empty((x.shape[0] // group.size,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    _run(lambda o, i, pg: dist.reduce_scatter_tensor(o, i, group=pg), out, x, group)
    return out.movedim(0, dim)


class Pending:
    """An asynchronous collective (:func:`reduce_scatter_async`): :meth:`wait`
    returns its result."""

    def __init__(self, work, out: torch.Tensor, staged=None, dim: int = 0, keep=None):
        self.work, self.out, self.staged, self.dim = work, out, staged, dim
        self.keep = keep  # the input stays alive until the collective is done

    def wait(self) -> torch.Tensor:
        if self.work is not None:
            self.work.wait()
            if self.staged is not None:
                self.out.copy_(self.staged)
            self.work = self.keep = None
        return self.out.movedim(0, self.dim)


def reduce_scatter_async(t: torch.Tensor, group: Optional[Group], dim: int = 0) -> Pending:
    """:func:`reduce_scatter` issued asynchronously (``async_op=True``): the
    same collective on the same values, so its result is the same; under
    gloo a card tensor is staged through a host copy, as in :func:`_run`."""
    global host_staged, issued
    if group is None or group.size == 1:
        return Pending(None, t.movedim(dim, 0), dim=dim)
    dist = _dist()
    x = t.movedim(dim, 0).contiguous()
    if x.shape[0] % group.size:
        raise ValueError(f"reduce-scatter of {x.shape[0]} along dim {dim} over {group.size}")
    out = torch.empty((x.shape[0] // group.size,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    issued += 1
    staged = None
    if group.backend == "gloo" and x.is_cuda:
        host_staged += 1
        staged, x = out.cpu(), x.cpu()
        work = dist.reduce_scatter_tensor(staged, x, group=group.pg, async_op=True)
    else:
        work = dist.reduce_scatter_tensor(out, x, group=group.pg, async_op=True)
    return Pending(work, out, staged, dim, keep=x)


def _all_to_all(t: torch.Tensor, group: Group, split_dim: int, cat_dim: int) -> torch.Tensor:
    n = group.size
    if t.shape[split_dim] % n:
        raise ValueError(f"all-to-all of {t.shape[split_dim]} along dim {split_dim} over {n}")
    dist = _dist()
    # piece j of the split goes to member j; piece j of the result came from it
    x = t.unflatten(split_dim, (n, t.shape[split_dim] // n)).movedim(split_dim, 0).contiguous()
    out = torch.empty_like(x)
    _run(lambda o, i, pg: dist.all_to_all_single(o, i, group=pg), out, x, group)
    return out.movedim(0, cat_dim).flatten(cat_dim, cat_dim + 1)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_dim, cat_dim):
        ctx.args = (group, split_dim, cat_dim)
        return _all_to_all(x, group, split_dim, cat_dim)

    @staticmethod
    def backward(ctx, g):
        group, split_dim, cat_dim = ctx.args
        return _all_to_all(g, group, cat_dim, split_dim), None, None, None


def all_to_all(t: torch.Tensor, group: Optional[Group], split_dim: int,
               cat_dim: int) -> torch.Tensor:
    """``t`` split along ``split_dim`` into one piece per member, piece j
    sent to member j, and the pieces that arrive concatenated along
    ``cat_dim`` in group order (``lax.all_to_all(t, axes, split_dim,
    cat_dim, tiled=True)``). Differentiable: the backward is the move back."""
    if group is None or group.size == 1:
        return t
    return _AllToAll.apply(t, group, split_dim, cat_dim)


class _MoEMove(torch.autograd.Function):
    """Chunk j of the rows to EP member j and back: its own transpose, so
    the backward is the same move on the gradient (counted under the same
    kind)."""

    @staticmethod
    def forward(ctx, x, group, kind):
        ctx.args = (group, kind)
        moe_moves[kind] += 1
        return _all_to_all(x, group, 0, 0)

    @staticmethod
    def backward(ctx, g):
        group, kind = ctx.args
        moe_moves[kind] += 1
        return _all_to_all(g.contiguous(), group, 0, 0), None, None


def moe_dispatch(rows: torch.Tensor, group: Optional[Group]) -> torch.Tensor:
    """An MoE layer's tokens to the EP members holding their experts: the
    (ep·T, h) rows, chunk j sent to member j; chunk q of the result came
    from member q. Differentiable."""
    if group is None or group.size == 1:
        return rows
    return _MoEMove.apply(rows, group, "dispatch")


def moe_combine(rows: torch.Tensor, group: Optional[Group]) -> torch.Tensor:
    """The experts' outputs back to the ranks their tokens came from (the
    reverse of :func:`moe_dispatch`). Differentiable."""
    if group is None or group.size == 1:
        return rows
    return _MoEMove.apply(rows, group, "combine")


def gather_logits(logits: torch.Tensor, group: Optional[Group]) -> torch.Tensor:
    """The router logits of every member of an MoE layer's token group,
    concatenated in group order; no gradient (the routing choice has none,
    and each rank's gate uses its own logits)."""
    if group is None or group.size == 1:
        return logits.detach()
    moe_moves["logits"] += 1
    with torch.no_grad():
        return all_gather(logits.detach().contiguous(), group, 0)


# ---------------------------------------------------------------------------
# Tensor-parallel regions (Megatron's mappings)
# ---------------------------------------------------------------------------


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.group), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, op):
        return all_reduce(x.contiguous().clone(), group, op)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.group, ctx.dim), None, None


class _ReduceScatterSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return reduce_scatter(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.group, ctx.dim), None, None


class TPRegion:
    """The tensor-parallel region of a layer (or of the embedding and head)
    over ``group``: ``enter`` before a column-parallel GEMM, ``exit`` after
    a row-parallel one. With ``sp`` the activations between regions are
    sequence-sharded (dim 1). With ``overlap`` (the plan's ``tp_overlap``)
    the projection seams of ``models/modeling.py`` run the decomposed
    collective matmul (``ops/collective_matmul.py``): under SP the
    column-parallel GEMM gathers the sequence itself (``ring``), and the
    row-parallel GEMM reduces as an accumulator ring."""

    def __init__(self, group: Group, sp: bool, overlap: bool = False):
        self.group, self.sp, self.overlap = group, sp, overlap

    @property
    def ring(self) -> bool:
        """The sequence all-gather runs inside the column-parallel GEMM."""
        return self.overlap and self.sp and self.size > 1

    @property
    def size(self) -> int:
        return self.group.size

    @property
    def index(self) -> int:
        return self.group.index

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        if self.size == 1:
            return x
        return _GatherSeq.apply(x, self.group, 1) if self.sp else _Copy.apply(x, self.group)

    def exit(self, y: torch.Tensor) -> torch.Tensor:
        if self.size == 1:
            return y
        if self.sp:
            return _ReduceScatterSeq.apply(y, self.group, 1)
        return _Reduce.apply(y, self.group, "sum")

    def seq_slice(self, seq: int) -> slice:
        """The positions this rank holds between regions."""
        if not self.sp or self.size == 1:
            return slice(0, seq)
        n = seq // self.size
        return slice(self.index * n, (self.index + 1) * n)

    def max(self, x: torch.Tensor) -> torch.Tensor:
        """All-reduce max of a tensor that needs no gradient."""
        return all_reduce(x.detach().clone(), self.group, "max")

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """All-reduce sum forward, identity backward (the sum is replicated)."""
        return x if self.size == 1 else _Reduce.apply(x, self.group, "sum")


# ---------------------------------------------------------------------------
# ZeRO-3 parameters
# ---------------------------------------------------------------------------


class _GatherParam(torch.autograd.Function):
    """A zero3 shard → the whole (TP-local) parameter in ``dtype``; the
    backward reduce-scatters the fp32 gradient back onto the shard."""

    @staticmethod
    def forward(ctx, shard, dim, group, dtype):
        ctx.dim, ctx.group, ctx.sdtype = dim, group, shard.dtype
        return all_gather(shard.detach().to(dtype), group, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g.to(ctx.sdtype), ctx.group, ctx.dim), None, None, None


class _Marker:
    """A saved view of a gathered parameter, kept as its shard."""

    __slots__ = ("shard", "dim", "group", "dtype", "size", "stride", "offset")

    def __init__(self, shard, dim, group, dtype, t):
        self.shard, self.dim, self.group, self.dtype = shard, dim, group, dtype
        self.size, self.stride, self.offset = t.size(), t.stride(), t.storage_offset()


class Regather:
    """Per-layer ZeRO-3 gathers. :meth:`gather` makes the whole parameter;
    while :meth:`saving` is active, autograd saves a view of a gathered
    parameter as a marker (the shard and the view's geometry) instead of
    the tensor, so the gathered copy is freed when the layer's forward ends
    and gathered again when the backward unpacks it. A layer under full
    recompute does not need this: its recompute gathers again."""

    def __init__(self):
        self._live: List[Tuple[int, torch.Tensor, int, Group, torch.dtype]] = []

    def gather(self, shard: torch.Tensor, dim: int, group: Group, dtype: torch.dtype):
        full = _GatherParam.apply(shard, dim, group, dtype)
        self._live.append((full.untyped_storage().data_ptr(), shard, dim, group, dtype))
        return full

    def saving(self):
        return torch.autograd.graph.saved_tensors_hooks(self._pack, self._unpack)

    def release(self) -> None:
        """End of the layer's forward: the storages are no longer matched."""
        self._live.clear()

    def _pack(self, t):
        try:
            ptr = t.untyped_storage().data_ptr()
        except (RuntimeError, NotImplementedError):
            return t
        for p, shard, dim, group, dtype in self._live:
            if p == ptr:
                return _Marker(shard, dim, group, dtype, t)
        return t

    def _unpack(self, packed):
        global regathered
        if not isinstance(packed, _Marker):
            return packed
        regathered += 1
        with torch.no_grad():
            full = all_gather(packed.shard.detach().to(packed.dtype), packed.group, packed.dim)
        return full.as_strided(packed.size, packed.stride, packed.offset)


def gather_param(shard: torch.Tensor, dim: int, group: Group, dtype: torch.dtype):
    """The whole parameter from its zero3 shard (no regather bookkeeping)."""
    return _GatherParam.apply(shard, dim, group, dtype)


# ---------------------------------------------------------------------------
# Redistribution between layer layouts
# ---------------------------------------------------------------------------

#: (batch axes, sequence axes) of an activation layout (``mesh.batch_spec``)
ActLayout = Tuple[Axes, Axes]


def _move(x: torch.Tensor, mesh: RankMesh, rank: int, world: Group, src: ActLayout,
          dst: ActLayout) -> torch.Tensor:
    """This rank's ``dst`` block from every rank's ``src`` block: one
    all-gather over ``world`` (the ranks of this rank's stage), then the
    pieces that cover the block, each taken from the lowest rank that holds
    it."""
    b, s = x.shape[0], x.shape[1]
    rows, seq = b * 2 ** len(src[0]), s * 2 ** len(src[1])
    blocks = all_gather(x.contiguous(), world, 0).reshape((world.size,) + tuple(x.shape))
    owner = {}
    for i, q in enumerate(world.ranks):
        owner.setdefault((mesh.index(q, src[0]), mesh.index(q, src[1])), i)
    nb, ns = rows // 2 ** len(dst[0]), seq // 2 ** len(dst[1])
    r0, c0 = mesh.index(rank, dst[0]) * nb, mesh.index(rank, dst[1]) * ns
    row_pieces = []
    for ri in range(r0 // b, (r0 + nb - 1) // b + 1):
        lo_r, hi_r = max(r0, ri * b), min(r0 + nb, (ri + 1) * b)
        seq_pieces = []
        for si in range(c0 // s, (c0 + ns - 1) // s + 1):
            lo_c, hi_c = max(c0, si * s), min(c0 + ns, (si + 1) * s)
            q = owner[(ri, si)]
            seq_pieces.append(blocks[q, lo_r - ri * b:hi_r - ri * b, lo_c - si * s:hi_c - si * s])
        row_pieces.append(torch.cat(seq_pieces, dim=1) if len(seq_pieces) > 1 else seq_pieces[0])
    out = torch.cat(row_pieces, dim=0) if len(row_pieces) > 1 else row_pieces[0]
    return out.contiguous()


class _Redistribute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, rank, world, src, dst):
        ctx.args = (mesh, rank, world, src, dst)
        return _move(x, mesh, rank, world, src, dst)

    @staticmethod
    def backward(ctx, g):
        mesh, rank, world, src, dst = ctx.args
        return _move(g, mesh, rank, world, dst, src), None, None, None, None, None


def redistribute(x: torch.Tensor, mesh: RankMesh, rank: int, world: Optional[Group],
                 src: ActLayout, dst: ActLayout) -> torch.Tensor:
    """Move an activation from layout ``src`` to ``dst`` over ``world``,
    the group of this rank's stage (the reference's ``constrain(x,
    activation_spec)`` at a layer boundary); the backward moves the gradient
    back. Equal layouts move nothing."""
    if tuple(map(tuple, src)) == tuple(map(tuple, dst)) or world is None or world.size == 1:
        return x
    return _Redistribute.apply(x, mesh, rank, world, src, dst)


# ---------------------------------------------------------------------------
# Point-to-point transfers between pipeline stages
# ---------------------------------------------------------------------------


def open_p2p(device: torch.device) -> None:
    """One all-reduce of an element over the default group, on every rank,
    before the first :func:`exchange`: under NCCL the first call on a group
    that ``batch_isend_irecv`` uses must involve all of its ranks."""
    dist = _dist()
    gloo = str(dist.get_backend()) == "gloo"
    dist.all_reduce(torch.zeros(1, device="cpu" if gloo else device))


class Posted:
    """Sends and receives in flight (:func:`post`): :meth:`wait` waits for
    the receives, copies staged ones onto the card, and returns the pending
    send handles."""

    def __init__(self, works=(), n_ops=0, n_send=0, landed=(), keep=()):
        self.works, self.n_ops, self.n_send = works, n_ops, n_send
        self.landed, self.keep = landed, keep

    def wait(self) -> List:
        works = self.works
        if len(works) == self.n_ops:  # one handle an op (gloo); NCCL coalesces them into one
            wait_all(works[self.n_send:])
            pending = works[:self.n_send]
        else:
            wait_all(works)
            pending = []
        for buf, h in self.landed:
            if h is not buf:
                buf.copy_(h)
        return [(w, self.keep) for w in pending]


def exchange(sends: Sequence[Tuple[torch.Tensor, int]],
             recvs: Sequence[Tuple[torch.Tensor, int]]) -> List:
    """Post one batch of ``(tensor, dst rank)`` sends and ``(buffer, src
    rank)`` receives on the default group (``batch_isend_irecv``: one NCCL
    group call, so a send and a receive between the same two ranks never
    wait on each other), wait for the receives and return the pending send
    handles (wait on them, with :func:`wait_all`, before the tensors are
    reused). Messages between two ranks match in the order posted. A wait
    is bounded by the world's timeout (``--dist_timeout_s``): gloo raises
    at it, NCCL's watchdog ends the process. Under gloo a card tensor is
    staged through a host copy, as the collectives are."""
    return post(sends, recvs).wait()


def post(sends: Sequence[Tuple[torch.Tensor, int]],
         recvs: Sequence[Tuple[torch.Tensor, int]]) -> Posted:
    """:func:`exchange` without the wait: the messages are in flight when
    it returns, and the receive buffers hold their data after
    :meth:`Posted.wait`."""
    global p2p, host_staged
    if not sends and not recvs:
        return Posted()
    dist = _dist()
    staged = str(dist.get_backend()) == "gloo"
    ops, landed, keep = [], [], []
    for t, dst in sends:
        if staged and t.is_cuda:
            host_staged += 1
            t = t.detach().cpu()
        t = t.detach().contiguous()
        keep.append(t)
        ops.append(dist.P2POp(dist.isend, t, dst))
    n_send = len(ops)
    for buf, src in recvs:
        h = buf
        if staged and buf.is_cuda:
            host_staged += 1
            h = torch.empty(buf.shape, dtype=buf.dtype)
        landed.append((buf, h))
        ops.append(dist.P2POp(dist.irecv, h, src))
    p2p += len(ops)
    return Posted(dist.batch_isend_irecv(ops), len(ops), n_send, landed, keep)


def ring_shift(tensors: Sequence[torch.Tensor], group: Group, step: int = 1) -> List[torch.Tensor]:
    """Each tensor sent to the member ``step`` places on in ``group``'s order
    (the next one by default, cyclically), and what the member ``step``
    places back sent here: new tensors, in one :func:`exchange`. Every
    member must call it with tensors of the same shapes."""
    bufs, posted = ring_post(tensors, group, step)
    wait_all(posted.wait())
    return bufs


def ring_post(tensors: Sequence[torch.Tensor], group: Group,
              step: int = 1) -> Tuple[List[torch.Tensor], Posted]:
    """:func:`ring_shift` left in flight: (the receive buffers, the
    :class:`Posted` messages). The buffers hold the predecessor's tensors
    once ``wait_all(posted.wait())`` returns; work queued meanwhile
    overlaps the transfer."""
    succ = group.ranks[(group.index + step) % group.size]
    pred = group.ranks[(group.index - step) % group.size]
    bufs = [torch.empty(t.shape, dtype=t.dtype, device=t.device) for t in tensors]
    return bufs, post([(t, succ) for t in tensors], [(b, pred) for b in bufs])


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, *tensors):
        ctx.group = group
        return tuple(ring_shift(tensors, group))

    @staticmethod
    def backward(ctx, *grads):
        return (None, *ring_shift([g.contiguous() for g in grads], ctx.group, -1))


def ring_shift_grad(tensors: Sequence[torch.Tensor], group: Group) -> List[torch.Tensor]:
    """:func:`ring_shift` under autograd: the gradients travel back the
    other way (``lax.ppermute``'s transpose)."""
    return list(_RingShift.apply(group, *tensors))


def wait_all(works) -> None:
    """Wait on handles of :func:`exchange` (or ``Work`` objects)."""
    for w in works:
        (w[0] if isinstance(w, tuple) else w).wait()
