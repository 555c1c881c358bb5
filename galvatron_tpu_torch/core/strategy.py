"""Per-layer hybrid-parallelism strategy representation and codecs (the
port's copy of ``galvatron_tpu/core/strategy.py``, stdlib only).

The reference encodes a model-wide hybrid strategy as per-layer integer vectors
{pp_deg, tp_sizes_enc, tp_consecutive_flags, dp_types_enc, checkpoint_flags_enc}
(reference: galvatron/core/hybrid_parallel_config.py:13-87) plus a compact
string form ``pp-tp-dp[f][*][-c]`` (galvatron/utils/strategy_utils.py:3-48) and
a JSON interchange file ``galvatron_config_*.json`` with comma-joined strings
(galvatron/core/search_engine.py:326-367).

A strategy is a small frozen dataclass per transformer layer, a model-wide
``HybridParallelConfig``, and loss-free codecs to/from the reference-compatible
JSON schema, so a plan searched or saved by the JAX package loads here to the
same objects. Which of its fields the port runs is decided by
``parallel/hybrid.py``.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

DP_TYPES = ("ddp", "zero2", "zero3")
# Integer encoding used in config JSON, matching the reference's dp_types_enc
# (0 = default dp type, 1 = fsdp/zero3; we extend with explicit names).
_DP_TYPE_TO_INT = {"ddp": 0, "zero2": 0, "zero3": 1}

# Activation-recompute modes. The reference has full-layer checkpoint_wrapper
# wrapping (galvatron/core/parallel.py:109-132) plus Megatron's "selective"
# core-attention-only recompute (galvatron/core/tensor_parallel/
# transformer.py:597,615-636). JSON encoding extends the reference's 0/1
# `checkpoint` flags with 2 = selective.
_CKPT_NORMALIZE = {
    # bool keys omitted: False==0 / True==1 hash-equal, so 0/1 cover them
    0: False, "none": False, "": False, None: False,
    1: "full", "full": "full",
    2: "selective", "selective": "selective",
}
_CKPT_TO_INT = {False: 0, "full": 1, "selective": 2}


def _is_pow2(n: int) -> bool:
    return n >= 1 and (n & (n - 1)) == 0


@dataclass(frozen=True)
class LayerStrategy:
    """Hybrid-parallelism strategy for one transformer layer.

    Attributes:
      tp: tensor-parallel degree (power of two).
      tp_consec: if True, TP occupies the minor (adjacent-device) mesh axes —
        the reference's "consecutive" rank layout; if False the major axes
        (strided layout). (reference: galvatron/core/comm_groups.py:58-89)
      dp_type: 'ddp' (replicated params), 'zero2' (sharded optimizer state),
        'zero3' (fully sharded params — FSDP FULL_SHARD equivalent).
        (reference: galvatron/core/parallel.py:30-32)
      ckpt: activation rematerialization for this layer — False, 'full'
        (whole-layer remat; reference: checkpoint_wrapper wrapping,
        galvatron/core/parallel.py:109-132) or 'selective' (core-attention-only
        recompute; reference: transformer.py:597,615-636). Truthiness works:
        ``if s.ckpt`` means "any recompute".
      sp: Megatron-style sequence parallelism — activations sequence-sharded
        over the TP axes between blocks (reference: site_package/megatron/core/
        tensor_parallel/mappings_group.py:192-293).
      cp: context-parallel degree over the minor data axes; 1 disables. A
        TPU-native capability the reference lacks (SURVEY §5).
      cp_impl: 'ring' (K/V rotation with online softmax, parallel/ring.py) or
        'a2a' (Ulysses sequence↔head all-to-all, parallel/ulysses.py; needs
        num_heads % cp == 0).
      ep: expert-parallel degree for MoE layers — experts sharded over the
        minor data-parallel axes (reference EP groups: site_package/megatron/
        core/parallel_state.py:450-478; SwitchMLP transformer.py:161-295).
      tp_overlap: decomposed collective-matmul on the TP projection seams —
        the qkv/MLP-up all-gather and the output-projection reduce-scatter
        are pipelined against the matmul via shard_map/ppermute
        (ops/collective_matmul.py; Wang et al., ASPLOS'23) instead of left
        to GSPMD as blocking collectives. Only meaningful with tp>1 — the
        plan checker rejects tp_overlap on tp==1 layers (GTA018).
    """

    tp: int = 1
    tp_consec: bool = True
    dp_type: str = "ddp"
    ckpt: Any = False  # False | 'full' | 'selective' (True/0/1/2 accepted)
    sp: bool = False
    cp: int = 1
    ep: int = 1
    cp_impl: str = "ring"
    tp_overlap: bool = False

    def __post_init__(self):
        try:
            object.__setattr__(self, "ckpt", _CKPT_NORMALIZE[self.ckpt])
        except (KeyError, TypeError):
            raise ValueError(
                f"ckpt must be one of False/'full'/'selective' (or 0/1/2), got {self.ckpt!r}"
            )
        if not _is_pow2(self.tp):
            raise ValueError(f"tp degree must be a power of two, got {self.tp}")
        if not _is_pow2(self.cp):
            raise ValueError(f"cp degree must be a power of two, got {self.cp}")
        if not _is_pow2(self.ep):
            raise ValueError(f"ep degree must be a power of two, got {self.ep}")
        if self.cp > 1 and self.ep > 1:
            raise ValueError("cp and ep both >1 is unsupported (they share mesh axes)")
        if self.cp > 1 and self.ckpt == "selective":
            raise ValueError(
                "ckpt='selective' is not supported with cp>1 (the CP decoder "
                "layers have no attention-core remat hook); use ckpt='full'"
            )
        if self.cp_impl not in ("ring", "a2a"):
            raise ValueError(f"cp_impl must be 'ring' or 'a2a', got {self.cp_impl!r}")
        if self.dp_type not in DP_TYPES:
            raise ValueError(f"dp_type must be one of {DP_TYPES}, got {self.dp_type}")

    def with_(self, **kw) -> "LayerStrategy":
        return dataclasses.replace(self, **kw)


@dataclass
class HybridParallelConfig:
    """Model-wide hybrid strategy: one LayerStrategy per transformer layer plus
    global choices (reference: galvatron/core/hybrid_parallel_config.py:13-87).
    """

    pp: int = 1
    # virtual pipeline chunks per device (interleaved schedule; 1 = off).
    # Device s holds virtual stages {s, s+pp, ..., s+(vpp-1)pp}; the bubble
    # shrinks by the vpp factor (reference: the interleaved 1F1B of vendored
    # megatron core/pipeline_parallel/schedules.py:367, unused by Galvatron's
    # own engine — first-class here).
    vpp: int = 1
    layer_strategies: List[LayerStrategy] = field(default_factory=list)
    # layers per pipeline stage; len == pp, sum == len(layer_strategies)
    pp_division: Optional[List[int]] = None
    chunks: int = 1  # micro-batch count for pipeline / grad accumulation
    pipeline_type: str = "gpipe"  # 'gpipe' | 'pipedream_flush'
    vocab_tp: int = 1  # TP degree for embedding & LM head (vocab-parallel)
    vocab_sp: bool = False
    embed_dp_type: str = "ddp"  # 'embed_sdp' analogue: zero3 to shard embeddings
    # 'fp32' | 'bf16' (bf16 compute, fp32 master) | 'fp16' (+ dynamic loss
    # scaling with skip-on-overflow; reference: megatron grad_scaler.py)
    mixed_precision: str = "bf16"
    default_dp_type: str = "ddp"
    # activation-memory recompute over the MLP/norm/loss regions
    # (modeling.ModelConfig.mlp_recompute; DESIGN.md "Activation memory
    # accounting"): 'policy' (default — one gate save per layer, fp32
    # widenings rematerialized) | 'gate' (product-only remat) | 'off'
    mlp_recompute: str = "policy"
    # async ZeRO gradient overlap: pin each zero2/zero3 layer's parameter
    # cotangents to their reduce-scattered (opt-state) sharding AT THE LAYER'S
    # POINT in the backward graph (parallel/sharding.overlap_grad_sync), so
    # GSPMD issues one gradient reduce-scatter bucket per layer as its
    # backward completes — overlappable with the next layer's dgrad compute —
    # instead of a trailing blob after the whole backward. No numeric effect;
    # layout/schedule only (DESIGN.md "Overlap").
    grad_overlap: bool = False

    def __post_init__(self):
        if self.pipeline_type not in ("gpipe", "pipedream_flush"):
            raise ValueError(f"unknown pipeline_type {self.pipeline_type}")
        if self.mlp_recompute not in ("off", "gate", "policy"):
            raise ValueError(
                f"mlp_recompute must be 'off', 'gate' or 'policy', got "
                f"{self.mlp_recompute!r}"
            )
        if self.pp_division is None and self.layer_strategies:
            self.pp_division = balanced_division(len(self.layer_strategies), self.pp)

    @property
    def num_layers(self) -> int:
        return len(self.layer_strategies)

    def max_tp(self) -> int:
        degs = [s.tp * s.cp for s in self.layer_strategies] + [self.vocab_tp]
        return max(degs) if degs else 1

    def validate(self, world_size: int) -> None:
        """Strategy validity checks (reference: check_hp_config,
        galvatron/core/hybrid_parallel_config.py:109-128)."""
        if not _is_pow2(world_size):
            raise ValueError(f"world size must be a power of two, got {world_size}")
        if world_size % self.pp != 0:
            raise ValueError(f"pp={self.pp} must divide world size {world_size}")
        per_stage = world_size // self.pp
        for i, s in enumerate(self.layer_strategies):
            if s.tp * s.cp > per_stage:
                raise ValueError(
                    f"layer {i}: tp*cp={s.tp * s.cp} exceeds per-stage devices {per_stage}"
                )
            if s.ep > per_stage // (s.tp * s.cp):
                raise ValueError(
                    f"layer {i}: ep={s.ep} exceeds data-parallel extent "
                    f"{per_stage // (s.tp * s.cp)}"
                )
        if self.vocab_tp > per_stage:
            raise ValueError(f"vocab_tp={self.vocab_tp} exceeds per-stage devices")
        if self.pp_division is not None:
            # length 2*pp is the enc-dec layout: [enc division ‖ dec division]
            # (parallel/pipeline_encdec.EncDecLayout validates the split)
            if len(self.pp_division) not in (self.pp, 2 * self.pp):
                raise ValueError("pp_division length must equal pp (or 2*pp for enc-dec)")
            if sum(self.pp_division) != self.num_layers:
                raise ValueError("pp_division must sum to the layer count")
            # the 2*pp enc-dec layout allows zero-layer (fully masked)
            # stages for sub-stacks smaller than pp; single-stack pipelines
            # require at least one layer per stage
            floor = 0 if len(self.pp_division) == 2 * self.pp else 1
            if any(n < floor for n in self.pp_division):
                raise ValueError(f"pp_division entries must be >= {floor}")
            if self.vpp > 1 and len(set(self.pp_division)) > 1:
                raise ValueError(
                    "the interleaved schedule (vpp>1) requires a uniform "
                    "pp_division (virtual stages are evenly stacked)"
                )
        if self.pp > 1 and self.chunks < 1:
            raise ValueError("chunks must be >= 1")
        if self.vpp < 1:
            raise ValueError("vpp must be >= 1")
        if self.vpp > 1:
            if self.pp == 1:
                raise ValueError("vpp>1 (interleaved schedule) requires pp>1")
            # vpp composes with both schedules: 'gpipe' = interleaved clocked
            # scan (autodiff backward), 'pipedream_flush' = interleaved 1F1B
            # (hand-written mirrored backward wave, bounded activations)
            if self.num_layers % (self.pp * self.vpp) != 0:
                raise ValueError(
                    f"vpp={self.vpp} needs the layer count {self.num_layers} "
                    f"divisible by pp*vpp={self.pp * self.vpp}"
                )
            if self.chunks % self.pp != 0:
                raise ValueError(
                    f"interleaved schedule needs chunks {self.chunks} divisible "
                    f"by pp={self.pp} (micro-batches flow in groups of pp; "
                    "reference: megatron interleaved requires the same)"
                )

    # --- JSON codec (reference schema: comma-joined per-layer strings;
    # galvatron/utils/config_utils.py:34-50, search_engine.py:326-367) ---

    def to_json_dict(self) -> Dict[str, Any]:
        ls = self.layer_strategies
        return {
            "pp_deg": self.pp,
            "vpp_deg": self.vpp,
            "tp_sizes_enc": ",".join(str(s.tp) for s in ls),
            "tp_consecutive_flags": ",".join(str(int(s.tp_consec)) for s in ls),
            "dp_types_enc": ",".join(str(_DP_TYPE_TO_INT[s.dp_type]) for s in ls),
            # authoritative per-layer dp types (dp_types_enc's 0/1 is kept for
            # reference-schema compatibility but cannot distinguish ddp/zero2)
            "dp_type_names": ",".join(s.dp_type for s in ls),
            "checkpoint": ",".join(str(_CKPT_TO_INT[s.ckpt]) for s in ls),
            "sp_flags": ",".join(str(int(s.sp)) for s in ls),
            "cp_sizes_enc": ",".join(str(s.cp) for s in ls),
            "cp_impls": ",".join(s.cp_impl for s in ls),
            "ep_sizes_enc": ",".join(str(s.ep) for s in ls),
            "tp_overlap_flags": ",".join(str(int(s.tp_overlap)) for s in ls),
            "pp_division": ",".join(str(n) for n in (self.pp_division or [])),
            "chunks": self.chunks,
            "pipeline_type": self.pipeline_type,
            "vocab_tp": self.vocab_tp,
            "vocab_sp": int(self.vocab_sp),
            "embed_dp_type": self.embed_dp_type,
            "default_dp_type": self.default_dp_type,
            "mixed_precision": self.mixed_precision,
            "mlp_recompute": self.mlp_recompute,
            "grad_overlap": int(self.grad_overlap),
        }

    @classmethod
    def from_json_dict(cls, d: Dict[str, Any]) -> "HybridParallelConfig":
        def ints(key, default=None):
            v = d.get(key, default)
            if v is None or v == "":
                return None
            if isinstance(v, str):
                return [int(x) for x in v.split(",")]
            return [int(x) for x in v]

        tps = ints("tp_sizes_enc") or []
        n = len(tps)
        consec = ints("tp_consecutive_flags") or [1] * n
        default_dp = d.get("default_dp_type", "ddp")
        dp_enc = ints("dp_types_enc") or [0] * n
        dp_names = d.get("dp_type_names")
        dp_names = dp_names.split(",") if dp_names else None
        ckpt = ints("checkpoint") or [0] * n
        sp = ints("sp_flags") or [0] * n
        cp = ints("cp_sizes_enc") or [1] * n
        cp_impls = d.get("cp_impls")
        cp_impls = cp_impls.split(",") if cp_impls else ["ring"] * n
        ep = ints("ep_sizes_enc") or [1] * n
        tov = ints("tp_overlap_flags") or [0] * n
        strategies = [
            LayerStrategy(
                tp=tps[i],
                tp_consec=bool(consec[i]),
                dp_type=dp_names[i] if dp_names else ("zero3" if dp_enc[i] == 1 else default_dp),
                ckpt=ckpt[i],
                sp=bool(sp[i]),
                cp=cp[i],
                cp_impl=cp_impls[i],
                ep=ep[i],
                tp_overlap=bool(tov[i]),
            )
            for i in range(n)
        ]
        return cls(
            pp=int(d.get("pp_deg", 1)),
            vpp=int(d.get("vpp_deg", 1)),
            layer_strategies=strategies,
            pp_division=ints("pp_division"),
            chunks=int(d.get("chunks", 1)),
            pipeline_type=d.get("pipeline_type", "gpipe"),
            vocab_tp=int(d.get("vocab_tp", 1)),
            vocab_sp=bool(int(d.get("vocab_sp", 0))),
            embed_dp_type=d.get("embed_dp_type", "ddp"),
            default_dp_type=default_dp,
            mixed_precision=d.get("mixed_precision", "bf16"),
            mlp_recompute=d.get("mlp_recompute", "policy"),
            grad_overlap=bool(int(d.get("grad_overlap", 0))),
        )

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json_dict(), f, indent=2)

    @classmethod
    def load(cls, path: str) -> "HybridParallelConfig":
        with open(path) as f:
            return cls.from_json_dict(json.load(f))

    @classmethod
    def uniform(
        cls,
        num_layers: int,
        pp: int = 1,
        tp: int = 1,
        dp_type: str = "ddp",
        ckpt: bool = False,
        sp: bool = False,
        cp: int = 1,
        cp_impl: str = "ring",
        ep: int = 1,
        tp_consec: bool = True,
        tp_overlap: bool = False,
        **kw,
    ) -> "HybridParallelConfig":
        s = LayerStrategy(
            tp=tp, tp_consec=tp_consec, dp_type=dp_type, ckpt=ckpt, sp=sp,
            cp=cp, cp_impl=cp_impl, ep=ep, tp_overlap=tp_overlap,
        )
        return cls(pp=pp, layer_strategies=[s] * num_layers, vocab_tp=kw.pop("vocab_tp", tp), **kw)


def plan_hash(plan) -> str:
    """Stable content hash of a parallelism plan's SEMANTIC fields.

    ``plan`` is a :class:`HybridParallelConfig` or a strategy JSON dict;
    dicts are decoded first, so provenance keys (``search_cost_ms``,
    ``num_devices``, ``model_config``, ...) and key ordering never change
    the hash — re-searching the identical strategy for the same mesh hashes
    identically. Checkpoint manifests record this hash in their topology
    fingerprint (trainer), the elastic supervisor exposes it as
    ``current_plan_hash``, and a cross-plan resume is detected by comparing
    it (a *mismatch* is legal — portable checkpoints reshard — but worth an
    event)."""
    import hashlib

    if isinstance(plan, dict):
        plan = HybridParallelConfig.from_json_dict(plan)
    payload = json.dumps(plan.to_json_dict(), sort_keys=True)
    return "sha256:" + hashlib.sha256(payload.encode()).hexdigest()


def balanced_division(num_layers: int, pp: int) -> List[int]:
    """Even layer split across stages, remainder to the middle stages — the
    uniform fallback of the reference's memory-balanced division
    (galvatron/core/search_engine.py:586-654); the memory-aware version is
    ``search/pp_division.py``'s ``pp_division_memory_balanced`` in the JAX package."""
    base, rem = divmod(num_layers, pp)
    division = [base] * pp
    # give the extra layers to the later-middle stages (first/last stages carry
    # embedding / head memory; reference biases the same way)
    order = sorted(range(pp), key=lambda s: (abs(s - (pp - 1) / 2), -s))
    for i in range(rem):
        division[order[i]] += 1
    return division


def form_strategy(s: LayerStrategy, pp: int = 1, dp: int = 1) -> str:
    """Compact human-readable strategy string, reference style ``pp-tp-dp[f][*][-c]``
    (galvatron/utils/strategy_utils.py:3-48)."""
    tag = f"{pp}-{s.tp}-{dp}"
    if s.dp_type == "zero3":
        tag += "f"
    elif s.dp_type == "zero2":
        tag += "z"
    if not s.tp_consec:
        tag += "*"
    if s.sp:
        tag += "s"
    if s.tp_overlap:
        tag += "o"
    if s.cp > 1:
        tag += (f"r{s.cp}" if s.cp_impl == "ring" else f"u{s.cp}")
    if s.ckpt == "full":
        tag += "-c"
    elif s.ckpt == "selective":
        tag += "-cs"
    return tag
