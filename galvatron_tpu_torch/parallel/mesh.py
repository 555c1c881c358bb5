"""Ranks on binary mesh axes, and the process groups of a plan (the port's
counterpart of ``galvatron_tpu/parallel/mesh.py``).

The JAX package's ``build_mesh(pp)`` shapes its world W as ``(pp, 2, ..., 2)``
over ``jax.devices()`` in order: ``pp`` is the major axis and each stage's
W/pp devices sit on ``m = log2(W/pp)`` binary axes ``x0..x{m-1}``, major to
minor. Here rank r stands where device r stands there: it belongs to stage
``r // (W/pp)``, and its coordinate on axis ``x_i`` is bit ``m-1-i`` of its
in-stage index ``r % (W/pp)``. A layer strategy picks axes the same way
(:class:`MeshAxes`): TP of degree ``2^k`` takes the minor k axes when
consecutive, the major k when strided, and DP is the complement. A tensor
dimension split over an axis tuple is split major to minor, so a rank's
shard index along it is its coordinates on those axes read as a binary
number (:meth:`RankMesh.index`).

:class:`ProcessGroups` makes one ``torch.distributed`` group per group of
ranks a plan needs, once, in the same order on every rank (``new_group`` is
collective); a group of one rank gets no process group and issues no
collective.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from galvatron_tpu_torch.core.strategy import LayerStrategy

Axes = Tuple[str, ...]


def _log2(n: int) -> int:
    k = int(round(math.log2(n))) if n >= 1 else -1
    if k < 0 or 2**k != n:
        raise ValueError(f"{n} is not a power of two")
    return k


@dataclass(frozen=True)
class MeshAxes:
    """Axis-name bookkeeping for the factored mesh (the reference's rules)."""

    pp: str
    data_axes: Axes  # binary axes, major → minor

    def tp_axes(self, tp: int, consec: bool = True) -> Axes:
        """Axes carrying tensor parallelism for a layer with degree ``tp``."""
        k = _log2(tp)
        if k > len(self.data_axes):
            raise ValueError(f"tp={tp} exceeds mesh data extent 2^{len(self.data_axes)}")
        if k == 0:
            return ()
        return self.data_axes[-k:] if consec else self.data_axes[:k]

    def dp_axes(self, tp: int, consec: bool = True, cp: int = 1) -> Axes:
        """Axes carrying (sharded-)data parallelism: the complement of TP∪CP."""
        used = set(self.tp_axes(tp, consec)) | set(self.cp_axes(tp, consec, cp))
        return tuple(a for a in self.data_axes if a not in used)

    def cp_axes(self, tp: int, consec: bool = True, cp: int = 1) -> Axes:
        """Context-parallel axes: minor axes of the non-TP block."""
        if cp == 1:
            return ()
        k = _log2(cp)
        rest = [a for a in self.data_axes if a not in set(self.tp_axes(tp, consec))]
        if k > len(rest):
            raise ValueError(f"cp={cp} exceeds remaining mesh extent")
        return tuple(rest[-k:])

    def ep_axes(self, tp: int, consec: bool = True, ep: int = 1) -> Axes:
        """Expert-parallel axes of an MoE layer: the minor axes of the
        non-TP block, as for CP (EP subdivides data parallelism; a strategy
        never uses both)."""
        return self.cp_axes(tp, consec, ep)


def build_axes(world: int, axis_prefix: str = "x") -> MeshAxes:
    """The binary axes of ``world`` ranks (a power of two): a pp=1 world, or
    one pipeline stage."""
    m = _log2(world)
    return MeshAxes(pp="pp", data_axes=tuple(f"{axis_prefix}{i}" for i in range(m)))


def data_parallel_degree(axes: MeshAxes, s: LayerStrategy) -> int:
    return 2 ** len(axes.dp_axes(s.tp, s.tp_consec, s.cp))


def batch_spec(axes: MeshAxes, s: LayerStrategy) -> Tuple[Axes, Axes]:
    """(batch axes, sequence axes) of a (batch, seq, ...) activation entering
    a layer: the batch over the DP axes, the sequence over the TP axes under
    Megatron-SP and then over the CP axes under context parallelism (the
    reference's ``batch_spec``, in its order)."""
    dp = axes.dp_axes(s.tp, s.tp_consec, s.cp)
    seq = axes.tp_axes(s.tp, s.tp_consec) if s.sp else ()
    return dp, seq + axes.cp_axes(s.tp, s.tp_consec, s.cp)


def moe_token_axes(axes: MeshAxes, s: LayerStrategy) -> Axes:
    """Axes sharding the flattened (B·S) token dim of an MoE layer's input:
    the batch axes, then the sequence axes (the reference's). Inside a TP
    region the sequence is whole again: there the tokens differ over the DP
    and CP axes only (:meth:`RankMesh.token_axes`)."""
    dp, seq = batch_spec(axes, s)
    return dp + seq


class RankMesh:
    """The ranks of a world on the ``pp`` axis and each stage's binary axes.
    Ranks are global; an axis tuple may hold ``"pp"`` (coordinate: the
    stage) besides the binary axes (coordinates within the stage)."""

    def __init__(self, world: int, pp: int = 1):
        if pp < 1 or world % pp:
            raise ValueError(f"pp={pp} must divide world size {world}")
        self.world, self.pp = world, pp
        self.per_stage = world // pp
        self.axes = build_axes(self.per_stage)
        self._pos = {a: i for i, a in enumerate(self.axes.data_axes)}

    @property
    def world_axes(self) -> Axes:
        """Axes spanning every rank of the world."""
        return ((self.axes.pp,) if self.pp > 1 else ()) + self.axes.data_axes

    def stage(self, rank: int) -> int:
        return rank // self.per_stage

    def stage_ranks(self, stage: int) -> List[int]:
        return list(range(stage * self.per_stage, (stage + 1) * self.per_stage))

    def _size(self, axis: str) -> int:
        return self.pp if axis == self.axes.pp else 2

    def coord(self, rank: int, axis: str) -> int:
        if axis == self.axes.pp:
            return self.stage(rank)
        m = len(self.axes.data_axes)
        return (rank % self.per_stage >> (m - 1 - self._pos[axis])) & 1

    def index(self, rank: int, axes: Axes) -> int:
        """Shard index of ``rank`` along a dimension split over ``axes``."""
        i = 0
        for a in axes:
            i = self._size(a) * i + self.coord(rank, a)
        return i

    def group(self, rank: int, axes: Axes) -> List[int]:
        """The ranks that differ from ``rank`` only on ``axes``, in shard
        index order."""
        rest = [a for a in self.world_axes if a not in axes]
        key = [self.coord(rank, a) for a in rest]
        out = [q for q in range(self.world) if [self.coord(q, a) for a in rest] == key]
        return sorted(out, key=lambda q: self.index(q, axes))

    def partition(self, axes: Axes) -> List[List[int]]:
        """Every group over ``axes``, ordered by its first rank."""
        seen, out = set(), []
        for r in range(self.world):
            if r not in seen:
                g = self.group(r, axes)
                seen.update(g)
                out.append(g)
        return out

    def tp_axes(self, s: LayerStrategy) -> Axes:
        return self.axes.tp_axes(s.tp, s.tp_consec)

    def dp_axes(self, s: LayerStrategy) -> Axes:
        return self.axes.dp_axes(s.tp, s.tp_consec, s.cp)

    def cp_axes(self, s: LayerStrategy) -> Axes:
        return self.axes.cp_axes(s.tp, s.tp_consec, s.cp)

    def ep_axes(self, s: LayerStrategy) -> Axes:
        return self.axes.ep_axes(s.tp, s.tp_consec, s.ep)

    def replica_axes(self, s: LayerStrategy) -> Axes:
        """The DP axes outside the EP axes: ranks holding the same experts."""
        ep = set(self.ep_axes(s))
        return tuple(a for a in self.dp_axes(s) if a not in ep)

    def token_axes(self, s: LayerStrategy) -> Axes:
        """The axes over which an MoE layer's tokens differ inside its TP
        region: :func:`moe_token_axes` without the SP axes (the sequence is
        gathered there), i.e. its DP axes, then its CP axes."""
        tp = set(self.tp_axes(s))
        return tuple(a for a in moe_token_axes(self.axes, s) if a not in tp)

    def token_order(self, rank: int, s: LayerStrategy, rows: int, seq: int):
        """The global token indices (row-major over a ``rows`` x ``seq``
        micro-batch) that ``rank`` holds inside the TP region of a layer
        under ``s``, in its local (row, position) order."""
        import numpy as np

        r = self.batch_rows(rank, s, rows)
        cp = self.cp_axes(s)
        q = _part(seq, self.index(rank, cp), 2 ** len(cp), "sequence")
        return (np.arange(rows)[r][:, None] * seq + np.arange(seq)[q][None]).reshape(-1)

    def batch_rows(self, rank: int, s: LayerStrategy, rows: int) -> slice:
        """The rows of a ``rows``-row batch that ``rank`` holds under ``s``:
        the batch split over the DP axes. Uneven splits (which GSPMD pads)
        raise."""
        dp_axes, _ = batch_spec(self.axes, s)
        return _part(rows, self.index(rank, dp_axes), 2 ** len(dp_axes), "batch rows")

    def seq_slice(self, rank: int, s: LayerStrategy, seq: int) -> slice:
        """The sequence positions ``rank`` holds under ``s``: all of them, its
        TP shard under sequence parallelism, its CP block under context
        parallelism (the TP shard's CP block under both)."""
        _, seq_axes = batch_spec(self.axes, s)
        return _part(seq, self.index(rank, seq_axes), 2 ** len(seq_axes), "sequence")


def _part(n: int, i: int, parts: int, what: str) -> slice:
    if n % parts:
        raise ValueError(f"{what} {n} do not split evenly over {parts} ranks (the port "
                         "does not pad uneven shards)")
    size = n // parts
    return slice(i * size, (i + 1) * size)


@dataclass
class Group:
    """One group of ranks: ``ranks`` in shard index order, this rank's
    position in it, and its process group (None for a group of one)."""

    ranks: Tuple[int, ...]
    index: int
    pg: Optional[object] = None
    backend: Optional[str] = None

    @property
    def size(self) -> int:
        return len(self.ranks)


class ProcessGroups:
    """Process groups of a plan, made once and in the same order on every
    rank: for each axis tuple in ``axes_list`` (sorted), every group of that
    partition in order of its first rank; then each named partition of
    ``extra`` (name order), group by group. At world size 1 nothing is
    created."""

    def __init__(self, mesh: RankMesh, rank: int, axes_list: Iterable[Axes],
                 extra: Optional[Dict[str, List[List[int]]]] = None):
        self.mesh, self.rank = mesh, rank
        self._groups: Dict[object, Group] = {}
        wanted = sorted({tuple(a) for a in axes_list}, key=lambda a: (len(a), a))
        parts = [(axes, mesh.partition(axes)) for axes in wanted]
        parts += sorted((extra or {}).items())
        for key, partition in parts:
            mine = None
            for ranks in partition:
                pg = None
                if len(ranks) > 1:
                    import torch.distributed as dist

                    pg = dist.new_group(ranks)  # the default group's backend
                if rank in ranks:
                    mine = Group(tuple(ranks), ranks.index(rank), pg, _backend_of(pg))
            self._groups[key] = mine

    def get(self, axes: Sequence[str]) -> Group:
        return self._groups[tuple(axes)]

    def named(self, name: str) -> Optional[Group]:
        """This rank's group of the named partition ``name`` (None when it
        is in none of them)."""
        return self._groups[name]


def _backend_of(pg) -> Optional[str]:
    if pg is None:
        return None
    import torch.distributed as dist

    return str(dist.get_backend(pg))
