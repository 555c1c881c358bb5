"""Per-layer parameter and optimizer-state sharding rules on tensors (the
port's counterpart of ``param_spec`` in ``galvatron_tpu/parallel/sharding.py``).

Parameters carry a logical-axes annotation per dimension, drawn from
{"tp", "fsdp", "ep", None} (``modeling.model_annotations``). Under a layer
strategy:

- a ``"tp"`` dimension is split over the layer's TP axes (Megatron
  column-parallel output / row-parallel input);
- an ``"ep"`` dimension (an MoE layer's experts) is split over its EP axes;
- the first ``"fsdp"`` dimension that divides is split over the layer's DP
  axes, for zero3 parameters and for zero2 / zero3 optimizer state; for a
  leaf with an ``"ep"`` dimension, over the DP axes outside the EP axes
  (each EP group holds its own experts);
- a dimension that does not divide stays replicated, as in the reference.

:func:`param_layout` gives the axes of each dimension (the entries of the
reference's ``PartitionSpec``); :func:`shard` cuts a rank's piece out of a
full tensor or numpy array, :func:`unshard` puts the pieces of every rank
back together. ``pairs`` > 1 marks a dimension holding that many stacked
projections (SwiGLU's fused ``[w1 | w3]``): each projection is split on its
own, so every rank holds matching columns of both. The JAX package leaves
that pairing to GSPMD's resharding; a hand-placed column-parallel GEMM needs
it in the stored layout.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from galvatron_tpu_torch.core.strategy import LayerStrategy
from galvatron_tpu_torch.parallel.mesh import Axes, MeshAxes, RankMesh

Annotation = Tuple[Optional[str], ...]
Layout = Tuple[Optional[Axes], ...]


def param_layout(shape: Sequence[int], annot: Annotation, axes: MeshAxes, s: LayerStrategy,
                 *, for_opt_state: bool = False) -> Layout:
    """Per dimension, the axes it is split over (None: replicated): the
    reference's ``param_spec`` rules (within one pipeline stage)."""
    if len(shape) != len(annot):
        raise ValueError(f"shape {tuple(shape)} vs annotation {annot} rank mismatch")
    tp_ax = axes.tp_axes(s.tp, s.tp_consec)
    ep_ax = axes.ep_axes(s.tp, s.tp_consec, s.ep) if "ep" in annot else ()
    zero = s.dp_type == "zero3" or (for_opt_state and s.dp_type == "zero2")
    dp_ax = axes.dp_axes(s.tp, s.tp_consec, s.cp) if zero else ()
    dp_ax = tuple(a for a in dp_ax if a not in set(ep_ax))
    entries: List[Optional[Axes]] = []
    fsdp_used = False
    for dim, tag in zip(shape, annot):
        if tag == "tp" and tp_ax and dim % (2 ** len(tp_ax)) == 0:
            entries.append(tp_ax)
        elif tag == "ep" and ep_ax and dim % (2 ** len(ep_ax)) == 0:
            entries.append(ep_ax)
        elif tag == "fsdp" and dp_ax and not fsdp_used and dim % (2 ** len(dp_ax)) == 0:
            entries.append(dp_ax)
            fsdp_used = True
        else:
            entries.append(None)
    return tuple(entries)


def local_shape(shape: Sequence[int], layout: Layout) -> Tuple[int, ...]:
    return tuple(d // (2 ** len(ax)) if ax else d for d, ax in zip(shape, layout))


def _cut(x, dim: int, i: int, parts: int, pairs: int):
    """Piece ``i`` of ``parts`` along ``dim``; with ``pairs`` stacked
    projections, piece i of each, side by side."""
    shape = tuple(x.shape)
    d = shape[dim]
    if pairs == 1:
        size = d // parts
        idx = [slice(None)] * len(shape)
        idx[dim] = slice(i * size, (i + 1) * size)
        return x[tuple(idx)]
    sub = d // pairs
    size = sub // parts
    v = x.reshape(shape[:dim] + (pairs, sub) + shape[dim + 1:])
    idx = [slice(None)] * (len(shape) + 1)
    idx[dim + 1] = slice(i * size, (i + 1) * size)
    return v[tuple(idx)].reshape(shape[:dim] + (pairs * size,) + shape[dim + 1:])


def shard(x, layout: Layout, mesh: RankMesh, rank: int, pairs: Sequence[int] = ()):
    """``rank``'s piece of the full tensor (or array) ``x`` under
    ``layout``; ``pairs[dim]`` stacked projections on a dimension (1 when
    absent)."""
    for dim, ax in enumerate(layout):
        if ax:
            p = pairs[dim] if dim < len(pairs) else 1
            x = _cut(x, dim, mesh.index(rank, ax), 2 ** len(ax), p)
    return x


def _indices(d: int, i: int, parts: int, pairs: int) -> np.ndarray:
    """The positions along a dimension of size ``d`` that :func:`_cut`'s
    piece ``i`` holds, in the piece's order."""
    sub = d // pairs
    size = sub // parts
    return (np.arange(pairs)[:, None] * sub + i * size + np.arange(size)[None]).reshape(-1)


def unshard(pieces: Sequence[np.ndarray], layout: Layout, shape: Sequence[int], mesh: RankMesh,
            pairs: Sequence[int] = ()) -> np.ndarray:
    """The full array from every rank's piece (``pieces[r]`` of rank r);
    a replicated position takes the lowest rank's value."""
    out = np.zeros(tuple(shape), dtype=np.asarray(pieces[0]).dtype)
    for rank in reversed(range(mesh.world)):  # the lowest rank writes last
        idx = []
        for dim, (d, ax) in enumerate(zip(shape, layout)):
            p = pairs[dim] if dim < len(pairs) else 1
            idx.append(_indices(d, mesh.index(rank, ax), 2 ** len(ax), p) if ax
                       else np.arange(d))
        out[np.ix_(*idx)] = np.asarray(pieces[rank])
    return out
