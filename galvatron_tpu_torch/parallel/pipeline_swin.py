"""Swin pipelines: the section layout of the K-section pair-stacked
pipeline (the port's counterpart of ``galvatron_tpu/parallel/pipeline_swin.py``).

A Swin pyramid's stages differ in width and tokens, so the JAX package
runs K = ``len(swin_depths)`` coupled sections over the pp ring: device s
holds a stack of layer PAIRS (a plain and a shifted-window layer) of every
section, and each tick runs section k on micro-batch ``t - k·pp - s``.
Here that is one chain of K·pp virtual stages, virtual stage v = k·pp + s
(section k's pairs on device s) on device ``v % pp`` (``Schedule`` with
vpp = K), walked by ``pipeline.execute`` under the JAX clock formulas
(``pipeline.sections_gpipe_schedule``, ``pipeline.sections_1f1b_schedule``):

- GPipe: section k forward of micro-batch ``m = t - k·pp - s``,
  ``chunks + K·pp - 1`` forward ticks, the backward their mirror image;
- 1F1B: forward ``m = t - k·pp - s``, backward ``m = t - ((2K - k)·pp - 2)
  + s``, ``chunks + 2K·pp - 2`` ticks; section k holds at most
  ``min(chunks, 2(K - k)·pp - 1)`` micro-batches in flight, the JAX stash
  rings' bound.

The patch merge between sections sits where a section's output wraps from
device pp - 1 to device 0: device 0 merges the output it receives at the
start of the next section (the JAX GPipe's placement, kept for both clocks:
the JAX 1F1B merges on the sender instead, the same values), so the
messages of section k are its (B, H_k·W_k, C_k) map and device 0 holds the
merges with the embedding.

The layout (:class:`SwinLayout`) mirrors the JAX package's, refusals and
messages included: depths must be even (pairs), no vpp > 1, GPipe or 1F1B
only, no custom ``pp_division`` (sections are split from ``swin_depths``),
and the two layers of a pair and every stage holding a pair position share
one strategy. A section with fewer pairs than pp leaves zero-pair stages,
which pass their messages on.
"""

from __future__ import annotations

from typing import List

from galvatron_tpu_torch.core.strategy import HybridParallelConfig, balanced_division


class SwinLayout:
    """Per-section pair layout (the reference's): ``div[k]`` the pairs of
    section k on each stage (zeros allowed; the JAX ``_spread_pairs``, which
    is ``balanced_division``'s order), ``off[k]`` their pair offsets,
    ``base[k]`` the section's first layer. The pairs at one position of a
    section share one strategy (the reference stacks them into one array)."""

    def __init__(self, cfg, hp: HybridParallelConfig):
        depths, pp = tuple(cfg.swin_depths), hp.pp
        if any(d % 2 for d in depths):
            raise ValueError(
                f"swin pipeline stacks layer PAIRS (plain+shifted) — depths "
                f"{depths} must all be even"
            )
        if hp.vpp > 1:
            raise ValueError("swin pipeline does not compose with vpp>1")
        if hp.pipeline_type not in ("gpipe", "pipedream_flush"):
            raise ValueError(
                "swin pipeline implements the coupled-sections schedule in "
                f"gpipe and pipedream_flush (1F1B) orderings (got "
                f"{hp.pipeline_type!r})"
            )
        if hp.pp_division is not None and list(hp.pp_division) != balanced_division(
                sum(depths), pp):
            raise ValueError(
                f"swin pipeline derives stage divisions from swin_depths "
                f"{depths} per section; a custom pp_division "
                f"({hp.pp_division}) is not honored"
            )
        self.K, self.pp = len(depths), pp
        self.base = [sum(depths[:k]) for k in range(self.K)]
        self.div = [balanced_division(d // 2, pp) for d in depths]
        self.off = [[sum(dv[:s]) for s in range(pp)] for dv in self.div]
        for k in range(self.K):
            for q in range(max(self.div[k])):
                ss = {hp.layer_strategies[self.base[k] + 2 * (self.off[k][s] + q) + half]
                      for s in range(pp) if self.div[k][s] > q for half in (0, 1)}
                if len(ss) > 1:
                    raise ValueError(
                        f"swin section {k} pair position {q}: the pair's "
                        f"layers must share one strategy across stages "
                        f"(got {sorted(map(str, ss))})"
                    )

    def layers(self, k: int, s: int) -> List[int]:
        """The layers of section k on stage s (virtual stage k·pp + s)."""
        first = self.base[k] + 2 * self.off[k][s]
        return list(range(first, first + 2 * self.div[k][s]))


def virtual_stages(cfg, hp: HybridParallelConfig) -> List[List[int]]:
    """The K·pp virtual stages' layers: section k on stage s is virtual
    stage k·pp + s."""
    lay = SwinLayout(cfg, hp)
    return [lay.layers(k, s) for k in range(lay.K) for s in range(lay.pp)]
