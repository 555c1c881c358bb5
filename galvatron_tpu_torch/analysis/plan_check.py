"""Static plan checker: reject bad parallelism plans in milliseconds (the
port's copy of ``galvatron_tpu/analysis/plan_check.py``: the same passes and
the same ``GTA…`` codes, on the port's ``ModelConfig`` and runtime rules).

``check_plan`` validates (strategy JSON × ModelConfig × rank topology)
without building a model and returns structured diagnostics
(``diagnostics.CODES``) with field provenance and a one-line fix hint.

Call sites: ``SearchEngine.save_result`` (self-check — an emitted plan that
fails is a search bug) and the ``check-plan`` CLI mode.

The checks, in order:
 1. JSON schema: unknown keys (GTA001 — typo'd fields silently no-op) and
    per-field decode failures (GTA002).
 2. Structural: world/pp arithmetic (GTA003), degree-product vs the stage's
    ranks (GTA004), pp_division shape (GTA005), interleave constraints
    (GTA011), the JAX package's SPMD crash cell (GTA012), stage-position
    seams (GTA013), tp_overlap without TP (GTA018).
 3. Model-dependent: layer count (GTA006), head/vocab/sequence divisibility
    (GTA007/GTA008/GTA010), expert parallelism vs expert count (GTA014).
 4. Batch: chunks and per-layer dp-extent divisibility (GTA009 — the search
    engine's strict chunk filter).
 5. Memory: cost-model feasibility vs a device budget (GTA015).
 6. Sharding on the meta device: each rank of a stage cuts its parameter
    and optimizer-state pieces out of ``torch.device("meta")`` tensors with
    the runtime's own placement rules (GTA016: pieces that do not tile a
    parameter, or a ``tp`` / ``fsdp`` dim left whole). No memory, no device.

Separately, :func:`check_topology_fingerprint` (GTA017) compares a
checkpoint's recorded topology with the live world on resume.
"""

from __future__ import annotations

import difflib
import json
from typing import Any, Dict, List, Optional, Tuple

from galvatron_tpu_torch.analysis.diagnostics import (
    ERROR,
    WARN,
    Diagnostic,
    errors,
    format_report,
)
from galvatron_tpu_torch.core.strategy import (
    HybridParallelConfig,
    LayerStrategy,
    balanced_division,
)

# The strategy-JSON schema: codec keys (strategy.to_json_dict) plus the
# extras SearchEngine.save_result and the checked-in configs carry. Anything
# else is a typo'd field that would silently no-op (GTA001).
KNOWN_KEYS = frozenset(
    HybridParallelConfig(pp=1, layer_strategies=[LayerStrategy()]).to_json_dict()
) | {
    # save_result provenance/result keys
    "search_cost_ms",
    "search_throughput_samples_per_s",
    "global_bsz",
    "memory_mb",
    "fallback_bandwidths",
    "search_restrictions",
    "homogeneity_gap_pct",
    # self-describing checked-in configs (check-plan reads these as defaults)
    "model_size",
    "model_config",
    "num_devices",
    "memory_constraint_gb",
}

# the shape fields a search emits alongside model_size so check-plan can
# rebuild the EFFECTIVE model without the caller repeating CLI overrides
# (--num_layers etc.) — the subset of ModelConfig the argument system can
# override, all JSON-serializable scalars (+ the swin_depths tuple)
MODEL_SHAPE_FIELDS = (
    "vocab_size", "hidden_size", "num_layers", "num_heads", "num_kv_heads",
    "ffn_dim", "max_seq_len", "enc_layers", "enc_seq", "image_size",
    "patch_size", "num_classes", "swin_window", "swin_depths",
    "moe_experts", "moe_capacity_factor",
)


def model_shape_dict(cfg) -> Dict[str, Any]:
    """The JSON-embeddable effective shape of ``cfg`` (save_result)."""
    out: Dict[str, Any] = {}
    for k in MODEL_SHAPE_FIELDS:
        v = getattr(cfg, k, None)
        if isinstance(v, tuple):
            v = list(v)
        out[k] = v
    return out


# fields whose ModelConfig default is None (None passes through); everything
# else coerces to int except the float-typed capacity factor
_OPTIONAL_SHAPE_FIELDS = frozenset({"num_kv_heads", "ffn_dim"})


def apply_model_shape(cfg, shape: Dict[str, Any]):
    """Overlay a plan's embedded ``model_config`` shape onto ``cfg``.
    Values are type-coerced per field; garbage entries (``"4x"``, a float
    where an int belongs) are DROPPED, never passed through —
    ``dataclasses.replace`` does not type-check, and a mistyped layer count
    would otherwise crash deep in the checker instead of degrading."""
    import dataclasses

    kw = {}
    for k in MODEL_SHAPE_FIELDS:
        if k not in shape:
            continue
        v = shape[k]
        try:
            if k == "swin_depths":
                v = tuple(int(x) for x in (v or ()))
            elif v is None:
                if k not in _OPTIONAL_SHAPE_FIELDS:
                    continue
            elif k == "moe_capacity_factor":
                v = float(v)
            else:
                v = int(v)
        except (TypeError, ValueError):
            continue
        kw[k] = v
    try:
        return dataclasses.replace(cfg, **kw)
    except (TypeError, ValueError):
        return cfg

# per-layer list keys (length mismatches against tp_sizes_enc are a classic
# hand-edit failure; dp_type_names/cp_impls are name lists, same rule)
_LAYER_LIST_KEYS = (
    "tp_consecutive_flags",
    "dp_types_enc",
    "dp_type_names",
    "checkpoint",
    "sp_flags",
    "cp_sizes_enc",
    "cp_impls",
    "ep_sizes_enc",
    "tp_overlap_flags",
)


class PlanError(ValueError):
    """Raised by fail-fast call sites; carries the structured diagnostics."""

    def __init__(self, diags: List[Diagnostic], context: str = "invalid parallelism plan"):
        self.diagnostics = diags
        super().__init__(f"{context}:\n{format_report(diags)}")


def _is_pow2(n: int) -> bool:
    return n >= 1 and (n & (n - 1)) == 0


def check_plan(
    plan: Any,
    model_config: Any = None,
    world_size: Optional[int] = None,
    *,
    global_bsz: Optional[int] = None,
    memory_budget_mb: Optional[float] = None,
    costs: Any = None,
    source: Optional[str] = None,
    abstract_pass: bool = True,
) -> List[Diagnostic]:
    """Validate a plan; returns diagnostics (empty = clean).

    ``plan`` may be a JSON file path, a decoded strategy dict, or a
    ``HybridParallelConfig``. ``model_config`` (a ``ModelConfig``) enables
    the model-dependent checks; ``world_size`` the topology checks;
    ``global_bsz`` the batch-divisibility checks; ``memory_budget_mb`` (with
    ``costs`` — a ``ProfiledModelCosts``, or analytic costs derived from the
    model config when omitted) the memory-feasibility check. Checks whose
    inputs are missing are skipped, never guessed.
    """
    diags: List[Diagnostic] = []
    d: Optional[Dict[str, Any]] = None
    plan_memory_mb: Optional[float] = None

    if isinstance(plan, str):
        source = source or plan
        try:
            with open(plan) as f:
                d = json.load(f)
        except (OSError, ValueError) as e:
            return [
                Diagnostic(
                    "GTA002",
                    f"cannot read strategy JSON: {e}",
                    hint="the file must be a JSON object in the galvatron_config schema",
                    source=source,
                )
            ]
        if not isinstance(d, dict):
            return [
                Diagnostic(
                    "GTA002",
                    f"strategy JSON must be an object, got {type(d).__name__}",
                    source=source,
                )
            ]
    elif isinstance(plan, dict):
        d = plan

    if d is not None:
        diags += _check_unknown_keys(d, source)
        hp, decode_diags = _decode(d, source)
        diags += decode_diags
        if hp is None:
            return _sorted(diags)
        # self-describing provenance keys fill any input the caller omitted —
        # a library call on an emitted config runs the SAME checks the CLI
        # would, not a silently weaker structural subset. Explicit arguments
        # always win; garbage values degrade to "absent".
        def _as_int(key):
            try:
                return int(d[key]) if d.get(key) else None
            except (TypeError, ValueError):
                return None

        if global_bsz is None:
            global_bsz = _as_int("global_bsz")
        if world_size is None:
            world_size = _as_int("num_devices")
        if memory_budget_mb is None:
            try:
                gb = float(d.get("memory_constraint_gb") or 0.0)
            except (TypeError, ValueError):
                gb = 0.0
            memory_budget_mb = gb * 1024.0 or None
        if model_config is None:
            shape = d.get("model_config")
            base = None
            if d.get("model_size"):
                from galvatron_tpu_torch.models.modeling import PRESETS

                base = PRESETS.get(d["model_size"])
            if isinstance(shape, dict):
                from galvatron_tpu_torch.models.modeling import ModelConfig

                model_config = apply_model_shape(
                    base if base is not None else ModelConfig(), shape
                )
            else:
                model_config = base
        if isinstance(d.get("memory_mb"), (int, float)):
            plan_memory_mb = float(d["memory_mb"])
    else:
        hp = plan

    diags += _check_structural(hp, world_size, source)
    if model_config is not None:
        diags += _check_model(hp, model_config, source)
    if world_size and global_bsz:
        diags += _check_batch(hp, world_size, global_bsz, source)
    if memory_budget_mb:
        diags += _check_budget(
            hp, model_config, world_size, global_bsz, memory_budget_mb,
            costs, plan_memory_mb, source,
        )
    if (
        abstract_pass
        and model_config is not None
        and world_size
        and not errors(diags)  # topology/degree errors make the mesh unbuildable
    ):
        diags += _abstract_sharding_pass(hp, model_config, world_size, source)
    return _sorted(diags)


def _sorted(diags: List[Diagnostic]) -> List[Diagnostic]:
    return sorted(diags, key=lambda x: (x.severity != ERROR, x.code, x.field))


def ensure_valid(
    plan: Any,
    model_config: Any = None,
    world_size: Optional[int] = None,
    *,
    context: str = "invalid parallelism plan",
    verbose: bool = True,
    **kw,
) -> List[Diagnostic]:
    """Fail-fast wrapper: run ``check_plan``, raise ``PlanError`` on any
    error-severity diagnostic, print warnings. Returns the diagnostics."""
    diags = check_plan(plan, model_config, world_size, **kw)
    if errors(diags):
        raise PlanError(diags, context=context)
    if verbose and diags:
        print(format_report(diags))
    return diags


def check_topology_fingerprint(
    fingerprint: Dict[str, Any],
    world_size: Optional[int],
    source: Optional[str] = None,
) -> List[Diagnostic]:
    """GTA017: a checkpoint's recorded topology vs the live mesh.

    ``fingerprint`` is the manifest-meta record the trainer writes with
    every save (``world_size``, ``mesh_shape``, ``plan_hash``,
    ``global_bsz``). A mismatching world size — the preemption/slice-shrink
    signature — is an ERROR here, as in the JAX package: the plan the
    checkpoint was training under was searched for another world. The
    port's trainer, which takes its plan from the flags of the resumed run,
    logs a ``topology_resume`` event for it and restores the portable
    checkpoint into the new layout. A changed *plan hash*
    or mesh axis layout on the SAME device count is deliberately not
    flagged: portable checkpoints reshard across plans by design
    (``mesh_shape`` rides the fingerprint for forensics, not as a gate).
    """
    out: List[Diagnostic] = []
    if not isinstance(fingerprint, dict):
        return out
    try:
        rec_world = int(fingerprint.get("world_size") or 0)
    except (TypeError, ValueError):
        rec_world = 0
    if rec_world and world_size and rec_world != world_size:
        out.append(
            Diagnostic(
                "GTA017",
                f"checkpoint was written on {rec_world} devices but the live "
                f"topology has {world_size}",
                hint="re-search a plan for this mesh and resume the portable "
                "checkpoint under it — `cli run-elastic` does this "
                "automatically (plan cache: <ckpt>/replans/, "
                "configs/strategies/)",
                field="fingerprint.world_size",
                source=source,
            )
        )
    return out


# ---------------------------------------------------------------------------
# 1. JSON schema
# ---------------------------------------------------------------------------


def _check_unknown_keys(d: Dict[str, Any], source) -> List[Diagnostic]:
    out = []
    for k in sorted(set(d) - KNOWN_KEYS):
        close = difflib.get_close_matches(k, sorted(KNOWN_KEYS), n=1)
        hint = (
            f"did you mean {close[0]!r}?"
            if close
            else "remove it, or add it to the schema if it is a new field"
        )
        out.append(
            Diagnostic(
                "GTA001",
                f"unknown key {k!r} — the runtime ignores it silently",
                hint=hint,
                field=k,
                source=source,
            )
        )
    return out


def _decode(
    d: Dict[str, Any], source
) -> Tuple[Optional[HybridParallelConfig], List[Diagnostic]]:
    """Tolerant decode with per-field provenance: list-length mismatches and
    per-layer value errors name the offending key/index instead of
    surfacing as a bare ValueError/IndexError from the codec."""
    out: List[Diagnostic] = []
    tps = d.get("tp_sizes_enc", "")
    try:
        n = len(
            [int(x) for x in (tps.split(",") if isinstance(tps, str) else tps) if x != ""]
        )
    except (ValueError, TypeError):
        n = -1
    if n == 0:
        out.append(
            Diagnostic(
                "GTA002",
                "tp_sizes_enc is missing/empty — a plan with no per-layer "
                "strategies cannot drive the runtime",
                hint="give one tp degree per layer (comma-joined string)",
                field="tp_sizes_enc",
                source=source,
            )
        )
        return None, out
    if n > 0:
        for key in _LAYER_LIST_KEYS:
            v = d.get(key)
            if v in (None, ""):
                continue
            try:
                m = len(v.split(",")) if isinstance(v, str) else len(v)
            except TypeError:  # scalar where a per-layer list belongs
                out.append(
                    Diagnostic(
                        "GTA002",
                        f"{key} must be a comma-joined string or list "
                        f"(one entry per layer), got {v!r}",
                        hint=f"write {key} like tp_sizes_enc: \"1,1,2,2\"",
                        field=key,
                        source=source,
                    )
                )
                continue
            if m != n:
                out.append(
                    Diagnostic(
                        "GTA002",
                        f"{key} has {m} entries but tp_sizes_enc has {n}",
                        hint=f"give {key} one entry per layer (or drop it for the default)",
                        field=key,
                        source=source,
                    )
                )
        if out:
            return None, out
    try:
        hp = HybridParallelConfig.from_json_dict(d)
    except (ValueError, TypeError, KeyError, IndexError, ZeroDivisionError) as e:
        out.append(
            Diagnostic(
                "GTA002",
                f"strategy fails to decode: {e}",
                hint="fix the named field; degrees must be powers of two, "
                "enums one of their documented values",
                source=source,
            )
        )
        return None, out
    return hp, out


# ---------------------------------------------------------------------------
# 2. Structural checks (no model, no device)
# ---------------------------------------------------------------------------


def _check_structural(
    hp: HybridParallelConfig, world: Optional[int], source
) -> List[Diagnostic]:
    out: List[Diagnostic] = []
    L = hp.num_layers
    if hp.chunks < 1:
        out.append(
            Diagnostic(
                "GTA002", f"chunks must be >= 1, got {hp.chunks}",
                hint="set chunks to the micro-batch count (1 = no accumulation)",
                field="chunks", source=source,
            )
        )
    if hp.vpp < 1:
        out.append(
            Diagnostic(
                "GTA002", f"vpp_deg must be >= 1, got {hp.vpp}",
                hint="1 disables the interleaved schedule", field="vpp_deg",
                source=source,
            )
        )

    per_stage = None
    if world:
        if not _is_pow2(world) or not _is_pow2(hp.pp) or world % hp.pp:
            out.append(
                Diagnostic(
                    "GTA003",
                    f"world={world}, pp={hp.pp}: world and pp must be powers "
                    "of two with pp dividing world",
                    hint="pick pp from the powers of two dividing the device count",
                    field="pp_deg",
                    source=source,
                )
            )
        else:
            per_stage = world // hp.pp

    if per_stage is not None:
        for i, s in enumerate(hp.layer_strategies):
            if s.tp * s.cp > per_stage:
                out.append(
                    Diagnostic(
                        "GTA004",
                        f"layer {i}: tp*cp = {s.tp}*{s.cp} exceeds the "
                        f"per-stage extent {per_stage} (= world/pp)",
                        hint=f"lower tp_sizes_enc[{i}]/cp_sizes_enc[{i}] or pp_deg",
                        field=f"tp_sizes_enc[{i}]",
                        source=source,
                    )
                )
            elif s.ep > per_stage // (s.tp * s.cp):
                out.append(
                    Diagnostic(
                        "GTA004",
                        f"layer {i}: ep={s.ep} exceeds the data-parallel "
                        f"extent {per_stage // (s.tp * s.cp)}",
                        hint=f"lower ep_sizes_enc[{i}] to a divisor of the dp extent",
                        field=f"ep_sizes_enc[{i}]",
                        source=source,
                    )
                )
        if hp.vocab_tp > per_stage:
            out.append(
                Diagnostic(
                    "GTA004",
                    f"vocab_tp={hp.vocab_tp} exceeds the per-stage extent {per_stage}",
                    hint="vocab_tp is bounded by world/pp",
                    field="vocab_tp",
                    source=source,
                )
            )

    div = hp.pp_division
    if div is not None:
        encdec = len(div) == 2 * hp.pp and hp.pp > 1
        if len(div) not in (hp.pp, 2 * hp.pp):
            out.append(
                Diagnostic(
                    "GTA005",
                    f"pp_division has {len(div)} entries; pp={hp.pp} needs "
                    f"{hp.pp} (or {2 * hp.pp} for enc-dec)",
                    hint="one entry per pipeline stage (enc ‖ dec for enc-dec)",
                    field="pp_division",
                    source=source,
                )
            )
        elif sum(div) != L:
            out.append(
                Diagnostic(
                    "GTA005",
                    f"pp_division sums to {sum(div)} but the plan has {L} layers",
                    hint="stage layer counts must partition the layer list",
                    field="pp_division",
                    source=source,
                )
            )
        elif any(x < (0 if encdec else 1) for x in div):
            out.append(
                Diagnostic(
                    "GTA005",
                    f"pp_division {div} has an empty stage (single-stack "
                    "pipelines need >= 1 layer per stage)",
                    hint="rebalance pp_division or lower pp_deg",
                    field="pp_division",
                    source=source,
                )
            )
    elif hp.pp > L > 0:
        out.append(
            Diagnostic(
                "GTA005",
                f"pp={hp.pp} exceeds the layer count {L}: some stage holds no layer",
                hint="lower pp_deg to at most the layer count",
                field="pp_deg",
                source=source,
            )
        )

    if hp.vpp > 1:
        if hp.pp <= 1:
            out.append(
                Diagnostic(
                    "GTA011", "vpp>1 (interleaved schedule) requires pp>1",
                    hint="set pp_deg>1 or vpp_deg=1", field="vpp_deg",
                    source=source,
                )
            )
        else:
            if L % (hp.pp * hp.vpp):
                out.append(
                    Diagnostic(
                        "GTA011",
                        f"vpp={hp.vpp} needs the layer count {L} divisible by "
                        f"pp*vpp = {hp.pp * hp.vpp}",
                        hint="pick vpp_deg so layers split evenly into virtual stages",
                        field="vpp_deg",
                        source=source,
                    )
                )
            if hp.chunks % hp.pp:
                out.append(
                    Diagnostic(
                        "GTA011",
                        f"interleaved schedule needs chunks {hp.chunks} "
                        f"divisible by pp={hp.pp}",
                        hint="micro-batches flow in groups of pp",
                        field="chunks",
                        source=source,
                    )
                )
            if div is not None and len(set(div)) > 1:
                out.append(
                    Diagnostic(
                        "GTA011",
                        "vpp>1 requires a uniform pp_division (virtual stages "
                        "are evenly stacked)",
                        hint="drop pp_division or make every stage equal",
                        field="pp_division",
                        source=source,
                    )
                )

    # the cell the JAX package's XLA partitioner crashes on (its search
    # engine's structural guard, re-derived as a diagnostic). The torch
    # runtime runs it; the port keeps the refusal so that a plan is refused
    # in both packages or in neither (ROADMAP.md §3 "Kept differences")
    if hp.pp > 1 and hp.pipeline_type == "pipedream_flush" and hp.vocab_tp > 1:
        bad = [i for i, s in enumerate(hp.layer_strategies) if s.tp > 1 and not s.sp]
        if bad:
            out.append(
                Diagnostic(
                    "GTA012",
                    f"pp>1 × pipedream_flush × vocab_tp>1 with tp>1, sp=0 "
                    f"layers {bad[:8]} is the cell the JAX package's XLA SPMD "
                    "partitioner crashes on; refused in both packages",
                    hint=f"enable sp_flags on those layers, set vocab_tp=1, or "
                    "use the gpipe schedule",
                    field=f"sp_flags[{bad[0]}]",
                    source=source,
                )
            )

    # tp_overlap is a TP-seam rewrite: without TP there is no projection
    # collective to overlap, and the runtime would silently ignore the flag
    # (the dispatch gates on tp > 1) — a plan carrying it lies about itself
    for i, s in enumerate(hp.layer_strategies):
        if s.tp_overlap and s.tp <= 1:
            out.append(
                Diagnostic(
                    "GTA018",
                    f"layer {i}: tp_overlap_flags is set but tp={s.tp} — there "
                    "is no TP projection collective to overlap",
                    hint=f"clear tp_overlap_flags[{i}] or raise tp_sizes_enc[{i}]",
                    field=f"tp_overlap_flags[{i}]",
                    source=source,
                )
            )

    out += _check_seams(hp, source)
    return out


def _check_seams(hp: HybridParallelConfig, source) -> List[Diagnostic]:
    """Stage-stack seam legality at pp>1: a (pp, …)-stacked parameter has
    exactly one sharding, so real layers at the same stack position must
    share one strategy across stages (parallel/pipeline.position_strategies;
    the enc-dec layout applies the rule per sub-stack). Redistribution
    between ADJACENT positions is always legal (the runtime moves the
    activation) — so the seam rule is purely the cross-stage one. The port's
    pipelines run each stage's own layers and keep this rule for parity
    with the JAX package (ROADMAP.md §3 "Pipeline layout rules mirrored")."""
    out: List[Diagnostic] = []
    if hp.pp <= 1 or not hp.layer_strategies:
        return out
    L = hp.num_layers
    div = hp.pp_division
    stacks: List[Tuple[str, List[int], int]] = []  # (label, division, strategy offset)
    if div is not None and len(div) == 2 * hp.pp:
        stacks = [
            ("enc", list(div[: hp.pp]), 0),
            ("dec", list(div[hp.pp:]), sum(div[: hp.pp])),
        ]
    else:
        d = list(div) if div is not None else balanced_division(L, hp.pp)
        if len(d) != hp.pp or sum(d) != L:
            return out  # malformed division already reported (GTA005)
        stacks = [("", d, 0)]
    for label, d, base in stacks:
        if sum(d) == 0:
            continue
        offsets = [base]
        for x in d[:-1]:
            offsets.append(offsets[-1] + x)
        for j in range(max(d)):
            idxs = [offsets[s] + j for s in range(hp.pp) if d[s] > j]
            if any(i >= L for i in idxs):
                return out  # malformed division already reported
            ss = {hp.layer_strategies[i] for i in idxs}
            if len(ss) > 1:
                tag = f"{label} " if label else ""
                out.append(
                    Diagnostic(
                        "GTA013",
                        f"{tag}layers {idxs} share stage position {j} but "
                        f"carry different strategies "
                        f"({sorted(str(s) for s in ss)}) — a stacked "
                        "parameter has one sharding",
                        hint="make per-layer strategies agree at each stage "
                        "position (vary by position, not by stage), or run pp=1",
                        field=f"tp_sizes_enc[{idxs[1]}]",
                        source=source,
                    )
                )
    return out


# ---------------------------------------------------------------------------
# 3. Model-dependent checks
# ---------------------------------------------------------------------------


def _check_model(hp: HybridParallelConfig, cfg, source) -> List[Diagnostic]:
    out: List[Diagnostic] = []
    if hp.num_layers != cfg.total_layers:
        out.append(
            Diagnostic(
                "GTA006",
                f"plan has {hp.num_layers} layer strategies but the model has "
                f"{cfg.total_layers} layers (encoder + decoder)",
                hint="regenerate the plan for this model (or fix --num_layers)",
                field="tp_sizes_enc",
                source=source,
            )
        )
        return out  # per-layer zips below would misalign
    enc = getattr(cfg, "enc_layers", 0)
    for i, s in enumerate(hp.layer_strategies):
        seq = cfg.enc_seq if (enc and i < enc) else cfg.max_seq_len
        if s.tp > 1 and cfg.num_heads % s.tp:
            out.append(
                Diagnostic(
                    "GTA007",
                    f"layer {i}: num_heads={cfg.num_heads} is not divisible "
                    f"by tp={s.tp} — head-sharded attention cannot split",
                    hint=f"lower tp_sizes_enc[{i}] to a divisor of num_heads",
                    field=f"tp_sizes_enc[{i}]",
                    source=source,
                )
            )
        if s.cp > 1 and s.cp_impl == "a2a" and cfg.num_heads % s.cp:
            out.append(
                Diagnostic(
                    "GTA007",
                    f"layer {i}: Ulysses (a2a) cp={s.cp} needs num_heads="
                    f"{cfg.num_heads} divisible by cp",
                    hint=f"use cp_impls[{i}]='ring' or a dividing cp degree",
                    field=f"cp_sizes_enc[{i}]",
                    source=source,
                )
            )
        if s.sp and s.tp > 1 and seq % s.tp:
            out.append(
                Diagnostic(
                    "GTA010",
                    f"layer {i}: sequence parallelism shards seq={seq} over "
                    f"tp={s.tp}, which does not divide it",
                    hint=f"disable sp_flags[{i}] or pad the sequence length",
                    field=f"sp_flags[{i}]",
                    source=source,
                )
            )
        if s.cp > 1 and seq % s.cp:
            out.append(
                Diagnostic(
                    "GTA010",
                    f"layer {i}: context parallelism splits seq={seq} into "
                    f"cp={s.cp} chunks, which does not divide it",
                    hint=f"lower cp_sizes_enc[{i}] to a divisor of the sequence",
                    field=f"cp_sizes_enc[{i}]",
                    source=source,
                )
            )
        if s.ep > 1 and (cfg.moe_experts == 0 or cfg.moe_experts % s.ep):
            out.append(
                Diagnostic(
                    "GTA014",
                    f"layer {i}: ep={s.ep} but the model has "
                    f"{cfg.moe_experts} experts"
                    + ("" if cfg.moe_experts else " (dense MLP)"),
                    hint=f"ep_sizes_enc[{i}] must divide moe_experts (1 for dense)",
                    field=f"ep_sizes_enc[{i}]",
                    source=source,
                )
            )
    if hp.vocab_tp > 1 and cfg.vocab_size % hp.vocab_tp:
        out.append(
            Diagnostic(
                "GTA008",
                f"vocab_size={cfg.vocab_size} is not divisible by "
                f"vocab_tp={hp.vocab_tp}",
                hint="pad the vocab to a multiple of vocab_tp or lower vocab_tp",
                field="vocab_tp",
                source=source,
            )
        )
    return out


# ---------------------------------------------------------------------------
# 4. Batch divisibility
# ---------------------------------------------------------------------------


def _check_batch(
    hp: HybridParallelConfig, world: int, global_bsz: int, source
) -> List[Diagnostic]:
    out: List[Diagnostic] = []
    if (
        not _is_pow2(world) or not _is_pow2(hp.pp) or world % hp.pp
        or hp.chunks < 1
    ):
        return out  # GTA002/GTA003 already cover it; extents are undefined
    if global_bsz % hp.chunks:
        out.append(
            Diagnostic(
                "GTA009",
                f"global batch {global_bsz} is not divisible by chunks={hp.chunks}",
                hint="every micro-batch must have the same rows — no ragged last chunk",
                field="chunks",
                source=source,
            )
        )
        return out
    mb = global_bsz // hp.chunks
    per_stage = world // hp.pp
    seen = set()
    for i, s in enumerate(hp.layer_strategies):
        if s.tp * s.cp > per_stage:
            continue  # GTA004 already reported; dp extent undefined
        dp = per_stage // (s.tp * s.cp)
        need = dp * s.cp  # the search engine's strict chunk filter
        if mb % need and (dp, s.cp) not in seen:
            seen.add((dp, s.cp))
            out.append(
                Diagnostic(
                    "GTA009",
                    f"layer {i}: micro-batch {mb} (= {global_bsz}/{hp.chunks} "
                    f"chunks) does not split over dp×cp = {dp}×{s.cp}",
                    hint="adjust global batch or chunks so every micro-batch "
                    "shards evenly over the layer's data axes",
                    field=f"tp_sizes_enc[{i}]",
                    source=source,
                )
            )
    return out


# ---------------------------------------------------------------------------
# 5. Memory feasibility
# ---------------------------------------------------------------------------


def _check_budget(
    hp: HybridParallelConfig,
    cfg,
    world: Optional[int],
    global_bsz: Optional[int],
    budget_mb: float,
    costs,
    plan_memory_mb: Optional[float],
    source,
) -> List[Diagnostic]:
    if plan_memory_mb is not None:
        if plan_memory_mb > budget_mb:
            return [
                Diagnostic(
                    "GTA015",
                    f"the plan's own memory_mb={plan_memory_mb:.0f} exceeds "
                    f"the budget {budget_mb:.0f} MB",
                    hint="re-search under this budget or raise --memory_constraint_gb",
                    field="memory_mb",
                    source=source,
                )
            ]
        return []
    if not (world and global_bsz) or (costs is None and cfg is None):
        return []
    if (
        not _is_pow2(world) or not _is_pow2(hp.pp) or world % hp.pp
        or hp.num_layers < 1 or hp.chunks < 1
        or (hp.vpp > 1 and hp.num_layers % (hp.pp * hp.vpp))
    ):
        return []  # GTA002/GTA003/GTA011 already reported; extents undefined
    try:
        if costs is None:
            from galvatron_tpu_torch.search.theoretical import analytic_model_costs

            costs = analytic_model_costs(cfg, mixed_precision=hp.mixed_precision)
        from galvatron_tpu_torch.search.cost_model import layer_memory_cost, other_memory_cost

        lts = costs.layer_types
        layer_type = lambda i: lts.get(i, lts[0]) if len(lts) > 1 else lts[0]
        # per-device layer set: pp=1 → all; vpp>1 → L/pp (uniform virtual
        # stacking); else the heaviest stage of the division
        L = hp.num_layers
        if hp.pp == 1:
            device_layers = list(range(L))
        elif hp.vpp > 1:
            step = L // (hp.pp * hp.vpp)
            device_layers = [
                v * hp.pp * step + q for v in range(hp.vpp) for q in range(step)
            ]
        else:
            div = hp.pp_division or balanced_division(L, hp.pp)
            if len(div) == 2 * hp.pp:
                div = [div[s] + div[hp.pp + s] for s in range(hp.pp)]
            offs = [0]
            for x in div[:-1]:
                offs.append(offs[-1] + x)
            heavy = max(range(hp.pp), key=lambda s: div[s])
            device_layers = list(range(offs[heavy], offs[heavy] + div[heavy]))
        mem = sum(
            layer_memory_cost(
                layer_type(i), hp.layer_strategies[i], world, hp.pp, global_bsz,
                hp.chunks, stage_idx=0, pipeline_type=hp.pipeline_type,
                mixed_precision=hp.mixed_precision, vpp=hp.vpp,
            ).total_mb
            for i in device_layers
        )
        mem += other_memory_cost(
            costs, world, hp.pp, vocab_tp=hp.vocab_tp,
            embed_dp_type=hp.embed_dp_type, global_bsz=global_bsz,
            chunks=hp.chunks, mixed_precision=hp.mixed_precision,
        )
    except Exception as e:  # a cost-model gap must not mask the other checks
        return [
            Diagnostic(
                "GTA015",
                f"memory feasibility could not be evaluated: {e}",
                hint="pass profiled costs, or skip the budget check",
                severity=WARN,
                source=source,
            )
        ]
    if mem > budget_mb:
        return [
            Diagnostic(
                "GTA015",
                f"cost-model memory estimate {mem:.0f} MB exceeds the "
                f"budget {budget_mb:.0f} MB (estimate excludes pipeline "
                "stash rings — the real footprint is higher)",
                hint="raise the budget, add recompute/zero3, or re-search",
                field="memory_mb",
                source=source,
            )
        ]
    return []


# ---------------------------------------------------------------------------
# 6. Sharding pass on the meta device (no memory, no device)
# ---------------------------------------------------------------------------


def _leaf_paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaf_paths(v, f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaf_paths(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def _abstract_sharding_pass(
    hp: HybridParallelConfig, cfg, world: int, source
) -> List[Diagnostic]:
    """The meta-device twin of the JAX package's ``AbstractMesh`` pass: each
    parameter's placement comes from the runtime's own rules
    (``hybrid.model_leaf_plans`` on ``parallel/sharding.py``), and every
    rank of a stage cuts its piece of the parameter (and, under zero2 /
    zero3, of its optimizer state) out of a ``torch.device("meta")`` tensor
    of the full shape. A piece set that does not tile the parameter is an
    ERROR (a TP split of a fused projection whose halves do not divide);
    a ``tp`` / ``fsdp`` dimension left whole under a degree > 1 is the
    silent replication the JAX pass warns about. Same code (GTA016)."""
    import torch

    from galvatron_tpu_torch.models import modeling
    from galvatron_tpu_torch.parallel import hybrid, pipeline
    from galvatron_tpu_torch.parallel.mesh import RankMesh
    from galvatron_tpu_torch.parallel.sharding import local_shape, shard

    if hp.num_layers != cfg.total_layers:
        return []  # GTA006 already reported; trees would misalign
    try:
        modeling.check_supported(cfg)
    except NotImplementedError:
        return []  # a family the port does not build has no pieces to check
    mesh = RankMesh(world, hp.pp)
    plans = hybrid.model_leaf_plans(cfg, hp, mesh, hybrid.param_shapes(cfg))
    ranks = mesh.stage_ranks(0)  # every stage places its layers alike
    msgs: Dict[Tuple[str, str, str], Tuple[str, str]] = {}

    def check_tree(plan_tree, s: LayerStrategy, label: str):
        for path, lp in _leaf_paths(plan_tree):
            if not lp.shape:
                continue
            full = torch.empty(lp.shape, device="meta")
            for for_opt in (False, True) if s.dp_type in ("zero2", "zero3") else (False,):
                layout = lp.opt_layout if for_opt else lp.layout
                want = local_shape(lp.shape, layout)
                got = {tuple(shard(full, layout, mesh, r, lp.pairs).shape) for r in ranks}
                if got != {want}:
                    msgs[(label, path, "spec")] = (
                        f"{label}{path}: the pieces {sorted(got)} of shape "
                        f"{lp.shape} do not tile it (layout {layout}, "
                        f"{lp.pairs} stacked projections a dim)",
                        ERROR,
                    )
                    continue
                for dim, tag, entry in zip(lp.shape, lp.annot, layout):
                    want_deg = None
                    if tag == "tp" and s.tp > 1:
                        want_deg = ("tp", s.tp)
                    elif tag == "fsdp" and (
                        s.dp_type == "zero3" or (for_opt and s.dp_type == "zero2")
                    ):
                        dp_ax = mesh.dp_axes(s)
                        if dp_ax:
                            want_deg = ("fsdp" if not for_opt else "fsdp opt-state",
                                        2 ** len(dp_ax))
                    if want_deg and entry is None:
                        kind, deg = want_deg
                        msgs[(label, path, tag + str(for_opt))] = (
                            f"{label}{path}: {kind}-annotated dim {dim} is not "
                            f"divisible by the {kind.split()[0]} degree {deg} — "
                            "the parameter is silently replicated (memory "
                            "blowout instead of a shard)",
                            WARN,
                        )

    enc = cfg.enc_layers
    seen_strategies = set()
    for i, s in enumerate(hp.layer_strategies):
        # one pass per distinct (strategy, layer kind): an encoder-decoder's
        # decoder layers carry cross-attention
        key = (s, enc and i < enc)
        if key in seen_strategies:
            continue
        seen_strategies.add(key)
        label = f"enc_layers[{i}]" if i < enc else f"layers[{i - enc}]"
        check_tree(pipeline.layer_of(plans, i), s, label)
    vocab_s = hybrid.embed_strategy(hp)
    for top in ("embed", "head", "final_norm", "enc_final_norm"):
        if top in plans:
            check_tree(plans[top], vocab_s, f"{top}/")

    return [
        Diagnostic("GTA016", msg, severity=sev,
                   hint="make the dim a multiple of its shard degree, or "
                   "drop the degree", field=key[1].strip("/"), source=source)
        for key, (msg, sev) in sorted(msgs.items())
    ]
