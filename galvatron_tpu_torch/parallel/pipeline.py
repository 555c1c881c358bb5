"""Pipeline parallelism on ``torch.distributed`` send/recv: stage layout,
schedules as per-device action lists, and the one executor that walks them
(the port's counterpart of ``galvatron_tpu/parallel/pipeline.py``).

The JAX package runs a pipeline as one clocked ``lax.scan`` inside a
manual-'pp' ``shard_map``: on tick t every stage computes, and activations
ride ``lax.ppermute`` to the next stage. Here each rank runs its own stage's
layers, and a schedule is that same clock written out: for each device
(pipeline stage) the list of ``(tick, fwd | bwd, virtual stage, micro-batch)``
actions the JAX clock formulas give (:func:`gpipe_schedule` here,
``pipedream_schedule`` in ``pipeline_1f1b.py``, the interleaved ones in
``pipeline_interleaved.py``, an encoder-decoder's coupled ones in
``pipeline_encdec.py``). :func:`execute` walks a device's list tick by
tick: at each tick it posts, in one ``comm.exchange``, the messages the
previous tick produced and the receives this tick needs, waits for the
receives, then runs the tick's actions (a forward before a backward). Every
message is consumed exactly one tick after it is produced
(:meth:`Schedule.check`), so a rank only ever waits for a sender that acts
earlier, and the per-tick batches of two neighbours match: the walk cannot
deadlock.

Where the JAX 1F1B engines stash each in-flight micro-batch's stage input
and recompute the stage forward in its backward tick (XLA's shapes are
static), the port keeps the micro-batch's autograd graph until its backward
action: the values are the same, and the live set is the same
``min(chunks, 2(pp-1-s)+1)`` micro-batches on stage s.

Layout (``stage_layout``, ``position_strategies``,
``validate_pipeline_strategies``) mirrors the JAX package, refusals and
messages included, so a plan runs in both packages or is refused in both.
The JAX package pads an uneven division to ``max(division)`` stack slots
that act as identities; here each stage simply runs its own layers.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from galvatron_tpu_torch.core.strategy import HybridParallelConfig, LayerStrategy, balanced_division
from galvatron_tpu_torch.parallel import comm

FWD, BWD = "fwd", "bwd"


# ---------------------------------------------------------------------------
# Stage layout
# ---------------------------------------------------------------------------


def stage_layout(num_layers: int, hp: HybridParallelConfig
                 ) -> Tuple[List[int], List[int], List[LayerStrategy]]:
    """(division, offsets, position_strategies): the JAX package's
    ``stage_layout``, with its refusals."""
    L, pp = num_layers, hp.pp
    div = list(hp.pp_division) if hp.pp_division else balanced_division(L, pp)
    if len(div) != pp or sum(div) != L or any(n < 1 for n in div):
        raise ValueError(
            f"pp_division {div} must have {pp} entries >= 1 summing to {L}"
        )
    offsets = [sum(div[:s]) for s in range(pp)]
    return div, offsets, position_strategies(hp.layer_strategies, div, offsets, "")


def position_strategies(strats: Sequence[LayerStrategy], div: Sequence[int],
                        offsets: Sequence[int], kind: str) -> List[LayerStrategy]:
    """The shared strategy of each stage position: layers at the same
    position of their stages must agree (the JAX package stacks them into
    one array of one sharding; the port keeps the rule so that both packages
    accept the same plans)."""
    pp = len(div)
    out: List[LayerStrategy] = []
    for j in range(max(div)):
        stages_with_j = [s for s in range(pp) if div[s] > j]
        ss = {strats[offsets[s] + j] for s in stages_with_j}
        if len(ss) > 1:
            raise ValueError(
                f"{kind + ' ' if kind else ''}layers at stage-position {j} "
                f"must share one strategy across stages "
                f"(got {sorted(map(str, ss))}); arbitrary per-layer "
                "heterogeneity is available at pp=1"
            )
        out.append(next(iter(ss)))
    return out


def validate_pipeline_strategies(num_layers: int, hp: HybridParallelConfig) -> None:
    """Raise where the JAX package's ``validate_pipeline_strategies`` does."""
    stage_layout(num_layers, hp)


def virtual_stages(cfg, hp: HybridParallelConfig) -> List[List[int]]:
    """The layers of each virtual stage of the model ``cfg`` (layers by
    strategy index: an encoder-decoder's encoder first), in order: with
    vpp = 1 stage s is its ``pp_division`` range; with vpp > 1 virtual
    stage k is layers ``[k·lpvs, (k+1)·lpvs)`` and lives on device
    ``k % pp``; an encoder-decoder at pp > 1 has 2·pp, the encoder's then
    the decoder's (``pipeline_encdec.py``)."""
    num_layers = cfg.total_layers
    if cfg.enc_layers > 0 and hp.pp > 1:
        from galvatron_tpu_torch.parallel import pipeline_encdec

        return pipeline_encdec.virtual_stages(cfg, hp)
    if hp.vpp > 1:
        lpvs = num_layers // (hp.pp * hp.vpp)
        return [list(range(k * lpvs, (k + 1) * lpvs)) for k in range(hp.pp * hp.vpp)]
    if hp.pp == 1:
        return [list(range(num_layers))]
    div, offsets, _ = stage_layout(num_layers, hp)
    return [list(range(o, o + n)) for o, n in zip(offsets, div)]


def device_layers(cfg, hp: HybridParallelConfig, device: int) -> List[int]:
    """Every layer device ``device`` holds, in the order of its virtual
    stages (``{device, device + pp, ...}``)."""
    return [i for k, ids in enumerate(virtual_stages(cfg, hp)) if k % hp.pp == device
            for i in ids]


#: held by the first stage besides the embedding: an encoder-decoder's
#: encoder final norm (its decoder's first stage, on device 0, applies it)
_FIRST_KEYS = ("embed", "enc_final_norm")


def held_tree(tree, layer_ids: Sequence[int], first: bool, last: bool, tied: bool):
    """The part of a model tree (parameters, shapes or plans) a device
    holds: its layers (``layer_ids`` are strategy indices, an
    encoder-decoder's encoder layers first: those go to ``enc_layers``, in
    ``layer_ids`` order), the embedding (and an encoder's final norm) on
    the first stage, the final norm and head on the last; with tied
    embeddings the last stage holds the token table too (its own copy)."""
    e = len(tree.get("enc_layers", ()))
    out = {"layers": [tree["layers"][i - e] for i in layer_ids if i >= e]}
    if "enc_layers" in tree:
        out["enc_layers"] = [tree["enc_layers"][i] for i in layer_ids if i < e]
    for key in tree:
        if key in ("layers", "enc_layers"):
            continue
        if key in _FIRST_KEYS and first:
            out[key] = tree[key]
        elif key == "embed" and last and tied:
            out[key] = {"tok": tree[key]["tok"]}
        elif key not in _FIRST_KEYS and last:
            out[key] = tree[key]
    return out


def layer_of(tree, i: int, local: Optional[Dict[int, int]] = None):
    """Layer ``i``'s subtree (a strategy index: an encoder-decoder's
    encoder layers first) of a whole tree, or of a held one with ``local``
    (:func:`local_index`)."""
    if local is not None:
        key, n = local[i]
        return tree[key][n]
    e = len(tree.get("enc_layers", ()))
    return tree["enc_layers"][i] if i < e else tree["layers"][i - e]


def local_index(layer_ids: Sequence[int], enc_layers: int) -> Dict[int, Tuple[str, int]]:
    """Strategy index → (list, position) in a :func:`held_tree`."""
    enc = [i for i in layer_ids if i < enc_layers]
    dec = [i for i in layer_ids if i >= enc_layers]
    return {**{i: ("enc_layers", n) for n, i in enumerate(enc)},
            **{i: ("layers", n) for n, i in enumerate(dec)}}


# ---------------------------------------------------------------------------
# Schedules
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Action:
    tick: int
    kind: str  # FWD | BWD
    vstage: int
    mb: int


@dataclass
class Schedule:
    """Per-device action lists of one step: ``actions[d]`` in tick order
    (within a tick the forward first); virtual stage k runs on device
    ``k % pp``."""

    pp: int
    vpp: int
    chunks: int
    ticks: int
    actions: List[List[Action]]

    @property
    def stages(self) -> int:
        return self.pp * self.vpp

    def device(self, vstage: int) -> int:
        return vstage % self.pp

    def check(self, train: bool = True) -> "Schedule":
        """Raise unless every micro-batch runs each virtual stage once
        forward (and once backward when ``train``) and every message (an
        activation into virtual stage k > 0, a gradient out of k < last) is
        consumed exactly one tick after its sender produced it."""
        at: Dict[Tuple[str, int, int], Tuple[int, int]] = {}
        for d, acts in enumerate(self.actions):
            for a in acts:
                key = (a.kind, a.vstage, a.mb)
                if key in at or self.device(a.vstage) != d:
                    raise ValueError(f"schedule: {a} repeated or on device {d}")
                at[key] = (a.tick, d)
        kinds = (FWD, BWD) if train else (FWD,)
        want = {(k, v, m) for k in kinds for v in range(self.stages) for m in range(self.chunks)}
        if set(at) != want:
            raise ValueError(f"schedule: missing {sorted(want - set(at))[:4]}, "
                             f"extra {sorted(set(at) - want)[:4]}")
        last = self.stages - 1
        for (kind, v, m), (t, _) in at.items():
            src = (FWD, v - 1, m) if kind == FWD else (BWD, v + 1, m)
            if (kind == FWD and v == 0) or (kind == BWD and v == last):
                continue
            if at[src][0] != t - 1:
                raise ValueError(f"schedule: {kind} of virtual stage {v}, micro-batch {m} at "
                                 f"tick {t} but its input was produced at tick {at[src][0]}")
        if train:
            for v in range(self.stages):
                for m in range(self.chunks):
                    if at[(BWD, v, m)][0] < at[(FWD, v, m)][0]:
                        raise ValueError(f"schedule: backward of ({v}, {m}) before its forward")
        return self

    def in_flight(self, device: int, vstages: Optional[Sequence[int]] = None) -> int:
        """The most micro-batches (each a virtual stage's forward whose
        backward has not run) device ``device`` holds at once; with
        ``vstages``, counting only those virtual stages' micro-batches."""
        live, peak = 0, 0
        for a in self.actions[device]:
            if vstages is not None and a.vstage not in vstages:
                continue
            live += 1 if a.kind == FWD else -1
            peak = max(peak, live)
        return peak


def from_ticks(pp: int, vpp: int, chunks: int, ticks: int,
               cells: Sequence[Tuple[int, int, str, int, int]]) -> Schedule:
    """A :class:`Schedule` from ``(device, tick, kind, vstage, mb)`` cells."""
    actions: List[List[Action]] = [[] for _ in range(pp)]
    for d, t, kind, v, m in cells:
        actions[d].append(Action(t, kind, v, m))
    for acts in actions:
        acts.sort(key=lambda a: (a.tick, a.kind != FWD))
    return Schedule(pp, vpp, chunks, ticks, actions)


def mirrored(pp: int, vpp: int, chunks: int, fwd_cells, train: bool) -> Schedule:
    """A forward clock and, when ``train``, its mirror image as the backward
    (what autodiff of a clocked scan runs): the backward of the forward at
    tick t runs at tick ``2·T - 1 - t``, T the forward ticks."""
    t_fwd = 1 + max(t for _, t, _, _ in fwd_cells)
    cells = [(d, t, FWD, v, m) for d, t, v, m in fwd_cells]
    if train:
        cells += [(d, 2 * t_fwd - 1 - t, BWD, v, m) for d, t, v, m in fwd_cells]
    return from_ticks(pp, vpp, chunks, 2 * t_fwd if train else t_fwd, cells).check(train)


def gpipe_schedule(pp: int, chunks: int, train: bool = True) -> Schedule:
    """GPipe: every forward first (stage s, micro-batch m at tick m + s),
    then the backwards in the reverse order, the last micro-batch first (the
    JAX package's ``gpipe_schedule_ticks``)."""
    return mirrored(pp, 1, chunks, [(s, m + s, s, m) for s in range(pp) for m in range(chunks)],
                    train)


# ---------------------------------------------------------------------------
# The executor
# ---------------------------------------------------------------------------


def message_parts(msg) -> tuple:
    """The tensors of one message, in order."""
    return msg if isinstance(msg, tuple) else (msg,)


def execute(sched: Schedule, device: int, peer: Callable[[int], int],
            forward: Callable, backward: Optional[Callable],
            buffer: Callable[[str, int], object]) -> int:
    """Walk ``device``'s actions of ``sched``; returns the most micro-batches
    it held in flight.

    - ``forward(k, m, x)`` runs virtual stage k on micro-batch m (``x`` is
      the received activation, None for k = 0) and returns the activation
      to send on (None from the last virtual stage);
    - ``backward(k, m, g)`` runs its backward (``g`` the received output
      gradient, None for the last virtual stage) and returns the input
      gradient to send back (None for k = 0);
    - ``buffer(kind, k)`` is an empty tensor for the message entering
      virtual stage k's forward (``FWD``) or its backward (``BWD``), or a
      tuple of them for a message of several tensors (an encoder-decoder's
      decoder stream and encoder output), which ``forward`` / ``backward``
      then take and return as tuples of the same shapes;
    - ``peer(d)`` is the rank of this rank's counterpart on device d (the
      same in-stage index).

    Messages between two ranks match in the order they are posted: the
    sender's in its action order of one tick, the receiver's in its action
    order of the next. A schedule whose actions within a tick run forwards
    first, each kind in virtual-stage order, keeps the two orders equal.
    """
    last = sched.stages - 1
    by_tick: Dict[int, List[Action]] = {}
    for a in sched.actions[device]:
        by_tick.setdefault(a.tick, []).append(a)
    out: List[Tuple[object, int]] = []  # produced last tick: (tensor, dst rank)
    pending: List = []
    live = peak = 0
    for t in range(sched.ticks):
        acts = by_tick.get(t, [])
        recvs, inputs = [], []
        for a in acts:
            if a.kind == FWD and a.vstage > 0:
                buf = buffer(FWD, a.vstage)
                recvs.append((buf, peer(sched.device(a.vstage - 1))))
            elif a.kind == BWD and a.vstage < last:
                buf = buffer(BWD, a.vstage)
                recvs.append((buf, peer(sched.device(a.vstage + 1))))
            else:
                buf = None
            inputs.append(buf)
        pending += comm.exchange(out, [(t, src) for buf, src in recvs for t in message_parts(buf)])
        out = []
        for a, x in zip(acts, inputs):
            if a.kind == FWD:
                y = forward(a.vstage, a.mb, x)
                live += 1
                peak = max(peak, live)
                if a.vstage < last:
                    out += [(t, peer(sched.device(a.vstage + 1))) for t in message_parts(y)]
            else:
                dx = backward(a.vstage, a.mb, x)
                live -= 1
                if a.vstage > 0:
                    out += [(t, peer(sched.device(a.vstage - 1))) for t in message_parts(dx)]
    if out:
        raise RuntimeError(f"schedule ended with {len(out)} unsent messages")
    comm.wait_all(pending)
    return peak
