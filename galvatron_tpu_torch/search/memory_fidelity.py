"""Memory fidelity: the cost model's memory prediction for a plan against
what its train step really holds (the port's counterpart of
``galvatron_tpu/search/memory_fidelity.py``).

Predicted side: the search's own pricing — ``layer_memory_cost`` summed over
the heaviest stage + ``other_memory_cost`` (+ the 1F1B rings and the
transient working set) — so the check validates exactly what the DP
consumes (``predicted_train_mb``, the JAX package's arithmetic).

Measured side: the CUDA allocator's peak over the plan's train step on the
card (``torch.cuda.max_memory_allocated`` after ``reset_peak_memory_stats``),
in place of the JAX package's TPU compile-time buffer plan; the state is
what the allocator holds once the train state exists, the rest of the peak
is the step's own (gradients, activations, scratch).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from galvatron_tpu_torch.core.strategy import HybridParallelConfig
from galvatron_tpu_torch.search.cost_model import (
    ProfiledModelCosts,
    layer_memory_cost,
    other_memory_cost,
    transient_overhead_mb,
)


@dataclass
class FidelityRow:
    label: str
    predicted_mb: float
    measured_mb: float
    # measured decomposition (MB/device): state (arguments minus batch,
    # outputs aliased away), temps (grads + activations + scratch)
    state_mb: float
    temp_mb: float

    @property
    def ratio(self) -> float:
        return self.predicted_mb / max(self.measured_mb, 1e-9)


def predicted_train_mb(
    costs: ProfiledModelCosts,
    cfg,
    hp: HybridParallelConfig,
    world: int,
    global_bsz: int,
) -> float:
    """Per-device MB the search would charge this config: the heaviest
    stage's (positions x layer_memory_cost) + the embed/head/loss 'other'
    term (replicated over pp in this runtime, so charged on every stage)."""
    from galvatron_tpu_torch.core.strategy import balanced_division

    lt = costs.layer_types[0]
    pp = hp.pp
    L = cfg.total_layers
    div = list(hp.pp_division) if hp.pp_division else balanced_division(L, pp)
    stage_mb = []
    off = 0
    for st in range(pp):
        mb = 0.0
        for j in range(div[st]):
            s = hp.layer_strategies[off + j]
            mb += layer_memory_cost(
                lt, s, world, pp, global_bsz, hp.chunks, stage_idx=st,
                pipeline_type=hp.pipeline_type, mixed_precision=hp.mixed_precision,
                vpp=hp.vpp,
            ).total_mb
        off += div[st]
        stage_mb.append(mb)
    other = other_memory_cost(
        costs, world, pp, hp.vocab_tp, hp.embed_dp_type, global_bsz, hp.chunks,
        hp.mixed_precision,
    )
    # single-stack/interleaved 1F1B per-device constants — THE SAME pricing
    # evaluate() charges (cost_model.single_1f1b_rings_mb), not a
    # re-derivation that could drift
    pf = 0.0
    if pp > 1 and hp.pipeline_type == "pipedream_flush":
        from galvatron_tpu_torch.search.cost_model import single_1f1b_rings_mb

        pf = single_1f1b_rings_mb(
            lt, hp.layer_strategies[0], world, pp, global_bsz, hp.chunks,
            hp.mixed_precision, vpp=max(1, hp.vpp),
            layers_per_device=max(div),
        )
    trans = transient_overhead_mb(
        costs, min(s.tp for s in hp.layer_strategies), hp.mixed_precision
    )
    return max(stage_mb) + other + pf + trans


def measured_train_mb(
    cfg,
    hp: HybridParallelConfig,
    global_bsz: int,
    seq: Optional[int] = None,
    device=None,
) -> dict:
    """Build the plan's runtime in this process's world, run one train step
    and read the allocator: ``state_mb`` held once the train state exists,
    ``total_mb`` the peak over the step, ``temp_mb`` their difference (MB =
    1e6 bytes). Needs the card: the CPU has no allocator to read."""
    import torch

    from galvatron_tpu_torch.core.optim import AdamConfig
    from galvatron_tpu_torch.device import rank_device
    from galvatron_tpu_torch.parallel.hybrid import build_runtime

    device = rank_device(device)
    if device.type != "cuda":
        raise ValueError("measured_train_mb reads the CUDA allocator: it runs on the card")
    seq = seq or cfg.max_seq_len
    torch.cuda.synchronize(device)
    base = torch.cuda.memory_allocated(device)
    rt = build_runtime(cfg, hp, adam=AdamConfig(lr=1e-3), global_batch_size=global_bsz,
                       seq_len=seq, device=device)
    state = rt.init_state(0)
    torch.cuda.synchronize(device)
    state_b = torch.cuda.memory_allocated(device) - base
    torch.cuda.reset_peak_memory_stats(device)
    from galvatron_tpu_torch.models.modeling import batch_row_width

    # the row width of the loader's batches (packed rows carry segment ids)
    batch = torch.zeros((global_bsz, batch_row_width(cfg, seq)), dtype=torch.long)
    state, loss = rt.train_step(state, batch)
    float(loss)
    total_b = torch.cuda.max_memory_allocated(device) - base
    del state, loss, rt
    return {"state_mb": state_b / 1e6, "temp_mb": (total_b - state_b) / 1e6,
            "total_mb": total_b / 1e6}


def fidelity_row(
    label: str,
    costs: ProfiledModelCosts,
    cfg,
    hp: HybridParallelConfig,
    global_bsz: int,
    world: int = 1,
    measured: Optional[dict] = None,
) -> FidelityRow:
    """One predicted-against-measured row; ``measured`` (a
    :func:`measured_train_mb` result) is taken when given, else measured
    here on the card."""
    meas = measured if measured is not None else measured_train_mb(cfg, hp, global_bsz)
    pred = predicted_train_mb(costs, cfg, hp, world, global_bsz)
    return FidelityRow(
        label=label,
        predicted_mb=pred,
        measured_mb=meas["total_mb"],
        state_mb=meas["state_mb"],
        temp_mb=meas["temp_mb"],
    )


def format_rows(rows: List[FidelityRow]) -> str:
    out = [
        f"{'cell':<34} {'pred MB':>9} {'meas MB':>9} {'state':>8} {'temp':>8} {'ratio':>6}"
    ]
    for r in rows:
        out.append(
            f"{r.label:<34} {r.predicted_mb:>9.1f} {r.measured_mb:>9.1f} "
            f"{r.state_mb:>8.1f} {r.temp_mb:>8.1f} {r.ratio:>6.3f}"
        )
    return "\n".join(out)
