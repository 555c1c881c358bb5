"""The interleaved (virtual-stage) schedules (the port's counterpart of
``galvatron_tpu/parallel/pipeline_interleaved.py``).

The model is cut into ``vpp·pp`` virtual stages of ``lpvs = L/(pp·vpp)``
layers; device s holds virtual stages ``{s, s+pp, ..., s+(vpp-1)·pp}``, so a
micro-batch travels the device ring ``vpp`` times. The JAX package's clock,
for device s at tick t with ``n = t - s``::

    r = n mod pp;  q = n div pp;  j = q mod vpp;  g = q div vpp;  m = g·pp + r

forwards micro-batch m through virtual stage ``s + j·pp`` (valid for
``0 <= n < vpp·chunks``). Under 'gpipe' the backward is the mirror of that
clock (autodiff of the scan); under 'pipedream_flush' (interleaved 1F1B) it
is the mirrored wave at lag ``vpp·pp``: ``n' = t - vpp·pp - (pp-1-s)``
decomposed the same way, virtual stage ``s + (vpp-1 - (q' mod vpp))·pp``.
Both feed the executor of ``pipeline.py``. ``validate_interleaved_strategies``
mirrors the JAX refusal: layer strategies repeat with period ``lpvs``.
"""

from __future__ import annotations

from galvatron_tpu_torch.core.strategy import HybridParallelConfig
from galvatron_tpu_torch.parallel.pipeline import BWD, FWD, Schedule, from_ticks, mirrored


def validate_interleaved_strategies(num_layers: int, hp: HybridParallelConfig) -> int:
    """The JAX package's check, same messages; returns layers per virtual
    stage."""
    L, pp, vpp = num_layers, hp.pp, hp.vpp
    if L % (pp * vpp) != 0:
        raise ValueError(f"pp*vpp={pp * vpp} must divide the layer count {L}")
    lpvs = L // (pp * vpp)
    for q in range(lpvs):
        base = hp.layer_strategies[q]
        for k in range(1, pp * vpp):
            other = hp.layer_strategies[k * lpvs + q]
            if other != base:
                raise ValueError(
                    f"interleaved schedule: layers at virtual-stage position {q} "
                    f"must share one strategy across all {pp * vpp} virtual "
                    f"stages (virtual stage 0 has {base}, {k} has {other})"
                )
    return lpvs


def _decompose(n: int, pp: int, vpp: int):
    r, q = n % pp, n // pp
    return r, q % vpp, q // vpp


def _forward_cells(pp: int, vpp: int, chunks: int):
    """(device, tick, virtual stage, micro-batch) of every forward."""
    cells = []
    for s in range(pp):
        for n in range(vpp * chunks):
            r, j, g = _decompose(n, pp, vpp)
            cells.append((s, n + s, s + j * pp, g * pp + r))
    return cells


def interleaved_schedule(pp: int, vpp: int, chunks: int, train: bool = True) -> Schedule:
    """Interleaved GPipe: the interleaved forward clock, its mirror as the
    backward."""
    return mirrored(pp, vpp, chunks, _forward_cells(pp, vpp, chunks), train)


def interleaved_1f1b_schedule(pp: int, vpp: int, chunks: int) -> Schedule:
    """Interleaved 1F1B: the interleaved forward clock and the mirrored
    backward wave at lag vpp·pp, over ``vpp·chunks + vpp·pp + pp - 1``
    ticks."""
    cells = [(s, t, FWD, v, m) for s, t, v, m in _forward_cells(pp, vpp, chunks)]
    for s in range(pp):
        for n in range(vpp * chunks):
            r, jj, g = _decompose(n, pp, vpp)
            cells.append((s, n + vpp * pp + (pp - 1 - s), BWD, s + (vpp - 1 - jj) * pp,
                          g * pp + r))
    T = vpp * chunks + vpp * pp + pp - 1
    return from_ticks(pp, vpp, chunks, T, cells).check()
