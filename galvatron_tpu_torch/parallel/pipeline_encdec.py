"""Encoder-decoder (T5-class) pipelines: the stage layout and the two
coupled clocks (the port's counterpart of
``galvatron_tpu/parallel/pipeline_encdec.py``).

The JAX package runs two coupled sub-pipelines over the pp ring: device s
holds encoder virtual stage s and decoder virtual stage pp + s, and each
tick runs both sections. Here that is one chain of 2·pp virtual stages,
virtual stage v on device ``v % pp`` (``Schedule`` with vpp = 2): the
encoder's output wraps from device pp - 1 to device 0, where the decoder's
first stage starts that micro-batch. Both clocks come straight from the JAX
formulas, as action lists the port's executor walks
(``pipeline.execute``):

- GPipe (:func:`gpipe_schedule`): encoder forward of micro-batch m at tick
  ``m + s``, decoder forward at ``m + pp + s``, ``chunks + 2·pp - 1``
  forward ticks, the backward their mirror image;
- 1F1B (:func:`pipedream_schedule`): encoder forward ``m = t - s``, decoder
  forward ``m = t - pp - s``, decoder backward ``m = t - (3pp - 2) + s``,
  encoder backward ``m = t - (4pp - 2) + s``, ``chunks + 4·pp - 2`` ticks.
  Device s holds at most ``min(chunks, 4pp - 1 - 2s)`` encoder and
  ``min(chunks, 2pp - 1 - 2s)`` decoder micro-batches in flight, within the
  JAX stashes' ``min(chunks, 4pp - 1)`` and ``min(chunks, 2pp - 1)``.

Messages: an encoder stage passes its activation; the decoder's first stage
(device 0) applies ``enc_final_norm`` to the encoder output it receives
(the JAX GPipe's placement, kept for both clocks: the JAX 1F1B folds the
norm into every decoder section instead, the same values) and embeds the
decoder tokens; from there each decoder message is ``(y, ctx)``, the
decoder stream and the normed encoder output, and each decoder stage's
backward adds its cross-attentions' part to ctx's incoming gradient.

The layout (:class:`EncDecLayout`) mirrors the JAX package's, refusals and
messages included: a 2·pp ``pp_division`` is [encoder ‖ decoder], a
length-pp one other than the auto-filled balanced one is refused, each
stack otherwise divides evenly on its own, and a stack smaller than pp
gives zero-layer stages, which pass their messages on. Where the JAX
package pads each stack to ``max(division)`` slots and flattens them back
for its portable checkpoint, the port holds each stage's own layers and
its checkpoint keys them by global index already (``pipeline.held_tree``).
"""

from __future__ import annotations

from typing import List

from galvatron_tpu_torch.core.strategy import HybridParallelConfig, balanced_division
from galvatron_tpu_torch.parallel.pipeline import (
    Schedule,
    position_strategies,
    sections_1f1b_schedule,
    sections_gpipe_schedule,
)


class EncDecLayout:
    """Per-stack stage layout (the reference's): ``div_e`` / ``div_d`` the
    encoder's and the decoder's layers per stage, ``off_e`` / ``off_d``
    their offsets within each stack, ``enc_pos`` / ``dec_pos`` the shared
    strategy of each stage position."""

    def __init__(self, cfg, hp: HybridParallelConfig):
        E, D, pp = cfg.enc_layers, cfg.num_layers, hp.pp
        if E < 1 or D < 1:
            raise ValueError(
                f"enc-dec pipeline needs at least one encoder and one decoder "
                f"layer (got {E} enc / {D} dec)"
            )
        div = hp.pp_division
        if div is not None and len(div) == pp:
            # the auto-filled balanced division over E + D means nothing for
            # two stacks; any other length-pp division was written by a user
            if list(div) != balanced_division(E + D, pp):
                raise ValueError(
                    f"enc-dec models take a 2*pp pp_division "
                    f"([enc ‖ dec] stage splits), got the single-stack "
                    f"division {div}"
                )
            div = None
        if div is not None and len(div) == 2 * pp and sum(div) == E + D:
            self.div_e, self.div_d = list(div[:pp]), list(div[pp:])
            if sum(self.div_e) != E or sum(self.div_d) != D or min(
                self.div_e + self.div_d
            ) < 0:
                raise ValueError(
                    f"enc-dec pp_division {div} must split as enc({E}) ‖ "
                    f"dec({D}) with non-negative per-stage counts"
                )
        else:
            self.div_e = balanced_division(E, pp)
            self.div_d = balanced_division(D, pp)
        self.off_e = [sum(self.div_e[:s]) for s in range(pp)]
        self.off_d = [sum(self.div_d[:s]) for s in range(pp)]
        self.pp = pp
        self.enc_pos = position_strategies(
            hp.layer_strategies[:E], self.div_e, self.off_e, "encoder")
        self.dec_pos = position_strategies(
            hp.layer_strategies[E:], self.div_d, self.off_d, "decoder")


def validate_encdec_pipeline(cfg, hp: HybridParallelConfig) -> EncDecLayout:
    """The schedule constraints (the reference's messages) and the layout."""
    if hp.vpp > 1:
        raise ValueError("enc-dec pipeline does not compose with vpp>1")
    if hp.pipeline_type not in ("gpipe", "pipedream_flush"):
        raise ValueError(
            f"unknown pipeline_type {hp.pipeline_type!r} for the enc-dec "
            "pipeline (gpipe | pipedream_flush)"
        )
    return EncDecLayout(cfg, hp)


def virtual_stages(cfg, hp: HybridParallelConfig) -> List[List[int]]:
    """The 2·pp virtual stages' layers (strategy indices): encoder stage s,
    then decoder stage s as virtual stage pp + s."""
    lay = validate_encdec_pipeline(cfg, hp)
    E = cfg.enc_layers
    return ([list(range(o, o + n)) for o, n in zip(lay.off_e, lay.div_e)]
            + [list(range(E + o, E + o + n)) for o, n in zip(lay.off_d, lay.div_d)])


def gpipe_schedule(pp: int, chunks: int, train: bool = True) -> Schedule:
    """The coupled GPipe clock: every forward first (virtual stage v, which
    is encoder stage v or decoder stage v - pp, micro-batch m at tick
    ``m + v``), the backward its mirror image."""
    return sections_gpipe_schedule(pp, 2, chunks, train)


def pipedream_schedule(pp: int, chunks: int) -> Schedule:
    """The coupled 1F1B clock (the JAX package's formulas): a decoder
    micro-batch's backward starts on the last device in the tick of its
    last forward, runs down the decoder and wraps into the encoder."""
    return sections_1f1b_schedule(pp, 2, chunks)
