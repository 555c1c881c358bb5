"""Hybrid-parallel training runtime on ``torch.distributed`` (the port's
counterpart of ``build_runtime`` and ``_make_layer_hook`` in
``galvatron_tpu/parallel/hybrid.py``, and of ``build_pipeline_runtime`` in
``galvatron_tpu/parallel/pipeline.py``).

Each decoder layer runs under its own strategy of the plan
(``core/strategy.py``): a TP degree on consecutive or strided ranks,
Megatron sequence parallelism, DDP, ZeRO-2 or ZeRO-3 over the ranks left
for data parallelism, and recompute ``none`` / ``full`` / ``selective``; the
embedding, final norm and head run under ``vocab_tp`` / ``vocab_sp`` /
``embed_dp_type``. Where the JAX package states a sharding and lets GSPMD
insert the collectives, this runtime issues them (``parallel/comm.py``):

- at each layer boundary the activation moves from the previous layer's
  (batch rows, sequence slice) to this layer's over the ranks of the stage
  (``comm.redistribute``; the backward is the same move back);
- zero3 parameters are gathered before the layer's forward, freed after it
  and gathered again in the backward (inside the recompute under full
  checkpointing); their gradients are reduce-scattered over DP;
- zero2 gradients are reduce-scattered, the optimizer updates this rank's
  shard against its shard of the moments, and the parameter is gathered
  back; DDP gradients are all-reduced;
- gradients of parameters replicated over a TP group that saw only this
  rank's sequence shard (norm scales and row-parallel biases under SP) are
  summed over that group; without SP every TP rank computes the whole
  gradient of a replicated parameter;
- a context-parallel layer (``cp > 1``) holds one contiguous block of the
  sequence per rank of its CP group and runs its attention core as a ring
  (``parallel/ring.py``) or by all-to-all (``parallel/ulysses.py``); its
  parameters are replicated over the CP axes, ZeRO still shards over the DP
  axes only, and its gradients are summed over the DP and the CP axes. Under
  SP as well the layer gathers its CP block over the TP group at entry and
  runs its TP region without SP (GSPMD picks that collective in the
  reference);
- an MoE layer (``models/moe.py``) routes over its whole micro-batch: the
  router logits are gathered over its token group (its DP and CP axes), and
  under ``ep > 1`` its experts are split over the EP axes and its tokens
  moved to them and back by all-to-all. An expert leaf is replicated over
  the DP axes outside the EP axes (its replica group), where ZeRO shards it
  and its gradient is summed; the router's gradient, partial in each TP
  rank's share of the experts' columns, is summed over the TP group;
- a layer whose plan sets ``tp_overlap`` (tp > 1, more than one rank, no
  CP) runs its TP seams as the decomposed collective matmul
  (``ops/collective_matmul.py``): the sequence all-gather and the
  reduction travel the TP ring behind the GEMM chunks;
- micro-batches (``chunks``) accumulate in sum form: the global token mean
  divides by the token count of the whole batch. Under the plan's
  ``grad_overlap`` (pp = 1) each zero2 / zero3 layer's gradient bucket (its
  leaves that reduce-scatter onto an optimizer shard) is divided and issued
  as an asynchronous reduce-scatter as soon as the layer's last micro-batch
  backward has accumulated it; the step waits for every bucket before the
  update. At pp > 1 the flag is accepted and changes nothing, as in the
  reference.

Encoders (``causal=False``): BERT's masked-LM rows ('mlm': the loss
divides by the masked positions of the whole batch) and ViT's pixel ‖
label rows ('cls'), whose layers run over the image's patches (``seq_len``
is then ``n_patches``); the patch projection and the pooled class head are
column-parallel over the embedding's TP group as the token table is
vocab-parallel (``modeling.vision_embed``, ``modeling.head``), and the
class cross entropy runs vocab-parallel over that shard of the classes.

Swin (``swin_depths``): each layer runs at its stage's width, heads and
tokens (``modeling.swin_layer``; a TP layer gathers the whole feature map
under SP before its window partition and scatters after ``wo``), and the
patch merge between stages is a model-level parameter under the embedding
strategy (replicated or ZeRO): the stream enters it in the embedding's
layout, gathered over the embedding's TP group under its SP, and each rank
merges its own sequence shard of the output tokens. A stage whose tokens
(under SP) or heads do not split over a layer's TP degree is refused naming
the layer: the port does not pad, where GSPMD would. At pp > 1 the stages
are K coupled sections of layer pairs (``parallel/pipeline_swin.py``).

Packed sequences (``cfg.pack_sequences``): the batch rows are tokens ‖
segment ids (``data/packing.py``); every stage derives the segment ids of
the micro-batch it runs from the rows it is given (every rank holds the
whole batch), and each layer takes its rows' ids over the whole sequence,
masks its attention per segment and gathers per-row RoPE tables from them
(also under SP, where its input is a sequence shard). The reference's
refusals hold: 'clm' only, ``attn_impl='xla'`` only, no CP, no vpp > 1.

Pipelines (pp > 1): the world is ``pp`` stages of W/pp ranks
(``mesh.RankMesh``); each stage holds and runs only its layers
(``pipeline.held_tree``), stage 0 the embedding, the last stage the final
norm, head and loss, and the plan's schedule (GPipe, 1F1B, interleaved;
``pipeline.py``) moves activations and their gradients between stages with
send/recv. Every stage runs the per-layer code above; pp = 1 is the one
stage, under 1F1B's order (a micro-batch's forward, then its backward). A
tied token table is held by the first and the last stage; the two copies'
gradients are summed over the pair of ranks of one in-stage index, the
gradient norm counts it once, and the loss reaches every rank.

``train_step(state, batch)`` takes the GLOBAL (B, S+1) token batch (packed:
(B, 2·(S+1))) on every rank (each rank keeps its rows) and updates this rank's state IN PLACE:
``{"params", "opt", "step"}`` hold its shards. At world size 1 no process
group exists and no collective runs: this is the single-device runtime.
At pp = 1 the batch may have another size than ``global_batch_size`` (the
trainer's batch-size ramp-up), as long as the plan divides it.

fp16 (``mixed_precision='fp16'``, the reference's loss-scaling path), on
every family and path: fp16 compute over the fp32 masters (the flash and
fused norm kernels run their fp16 instances), a dynamic loss scale in ``state["scaler"]``
(replicated). Each micro-batch's backward is seeded on the mean-equivalent
loss ``loss_sum * scale / n_static`` (``n_static`` the micro-batch's static
token count), so the first step at 2^16 does not overflow; the reduced
gradients are unscaled in fp32, finiteness is decided once over the whole
world (one all-reduce of one flag over every rank and stage), and on
overflow the update is skipped atomically (``core/optim.
apply_update_with_scaler``). The step counter advances either way.
"""

from __future__ import annotations

import contextlib
import functools
import os
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from galvatron_tpu_torch.core.optim import (
    AdamConfig,
    adamw_update,
    apply_update_with_scaler,
    tree_leaves,
)
from galvatron_tpu_torch.core.schedules import LossScalerConfig, all_finite, init_scaler_state
from galvatron_tpu_torch.core.strategy import HybridParallelConfig, LayerStrategy
from galvatron_tpu_torch.device import resolve_device
from galvatron_tpu_torch.models import modeling
from galvatron_tpu_torch.models.modeling import ModelConfig
from galvatron_tpu_torch.models.moe import MoEContext
from galvatron_tpu_torch.parallel import (
    comm,
    pipeline,
    pipeline_encdec,
    pipeline_swin,
    ring,
    ulysses,
)
from galvatron_tpu_torch.parallel.mesh import Group, ProcessGroups, RankMesh, batch_spec
from galvatron_tpu_torch.parallel.pipeline_1f1b import pipedream_schedule
from galvatron_tpu_torch.parallel.pipeline_interleaved import (
    interleaved_1f1b_schedule,
    interleaved_schedule,
    validate_interleaved_strategies,
)
from galvatron_tpu_torch.parallel.sharding import Layout, local_shape, param_layout, shard

#: --global_checkpoint values → per-layer recompute mode
CKPT_MODES = {0: "none", 1: "full", 2: "selective"}
_PRECISION = {"fp32": torch.float32, "bf16": torch.bfloat16, "fp16": torch.float16}


def embed_strategy(hp: HybridParallelConfig) -> LayerStrategy:
    """The embedding / final norm / head strategy (the reference's)."""
    return LayerStrategy(tp=hp.vocab_tp, tp_consec=True, dp_type=hp.embed_dp_type,
                         sp=hp.vocab_sp)


def check_packed(cfg: ModelConfig, hp: Optional[HybridParallelConfig]) -> None:
    """The reference's refusals of packed sequences (``build_runtime``),
    with its messages: everything the segment mask cannot reach is refused
    loudly rather than silently attending across documents."""
    if not cfg.pack_sequences:
        return
    if cfg.objective != "clm" or cfg.enc_layers or cfg.image_size:
        raise ValueError(
            "pack_sequences requires a decoder-only CLM model "
            "(enc-dec / vision / mlm rows carry no segment layout)"
        )
    if cfg.attn_impl != "xla":
        raise ValueError(
            "pack_sequences requires attn_impl='xla': the flash/ring "
            "Pallas kernels carry no segment mask, and running them would "
            "silently attend across packed documents"
        )
    if hp is None:
        return
    if any(s.cp > 1 for s in hp.layer_strategies):
        raise ValueError(
            "pack_sequences is incompatible with context parallelism "
            "(ring/Ulysses assume a plain causal mask)"
        )
    if hp.pp > 1 and hp.vpp > 1:
        raise ValueError(
            "pack_sequences is not threaded through the interleaved "
            "(vpp>1) schedule; use vpp=1 pipelines"
        )


def check_ep(cfg: ModelConfig, hp: HybridParallelConfig) -> None:
    """An ep > 1 layer needs an MoE model whose experts split over ep (the
    plan checker's GTA014, raised here for a plan built in code)."""
    for i, s in enumerate(hp.layer_strategies):
        if s.ep > 1 and (cfg.moe_experts == 0 or cfg.moe_experts % s.ep):
            raise ValueError(f"layer {i}: ep={s.ep} but the model has {cfg.moe_experts} experts"
                             + ("" if cfg.moe_experts else " (dense MLP)"))


def check_cp(cfg: ModelConfig, hp: HybridParallelConfig, seq_len: int) -> None:
    """The reference's refusals of context parallelism (``build_runtime``'s
    checks and the Ulysses head rule), from the shapes alone: causal
    decoder-only models, the tp-local head count split over an a2a layer's
    cp, and a sequence that splits over each cp layer's (SP and) CP ranks.
    An ALiBi model is refused too: the reference's ring and Ulysses layers
    take no bias and would drop it (ROADMAP.md §3, kept differences)."""
    cps = [(i, s) for i, s in enumerate(hp.layer_strategies) if s.cp > 1]
    if not cps:
        return
    if cfg.pos_embed == "alibi":
        raise NotImplementedError(
            f"layer {cps[0][0]}: context parallelism (cp={cps[0][1].cp}) with ALiBi positions: "
            "the reference's ring and Ulysses layers carry no ALiBi bias (its CP layers would "
            "silently drop it), so the port refuses the combination; use tp/sp for these "
            "layers")
    if not cfg.causal:
        raise ValueError(
            "context parallelism (cp>1) is causal-only (ring/Ulysses kernels "
            "assume a causal mask); encoder models must use tp/sp instead"
        )
    if cfg.enc_layers > 0:
        raise ValueError("context parallelism is not supported for enc-dec models")
    for i, s in cps:
        if s.cp_impl == "a2a":
            try:
                ulysses.check_heads(cfg.num_heads, s.tp, s.cp)
            except ValueError as e:
                raise ValueError(f"layer {i}: {e}") from None
        parts = s.cp * (s.tp if s.sp else 1)
        if seq_len % parts:
            raise ValueError(f"layer {i}: the sequence {seq_len} does not split over cp={s.cp}"
                             + (f" x tp={s.tp} (SP)" if s.sp else "") + " ranks")


# ---------------------------------------------------------------------------
# Parameter placement
# ---------------------------------------------------------------------------


@dataclass
class LeafPlan:
    """Where one parameter lives: its full shape and annotation, the
    layouts of the parameter and of its optimizer state, the stacked
    projections on its TP dim, the dtype a zero3 gather produces, and (once
    groups exist) its TP, DP and CP groups. An expert leaf's DP group is
    its replica group (the DP axes outside the EP axes); ``partial_tp``
    marks a replicated leaf whose gradient each TP rank computes only in
    part (the MoE router)."""

    shape: tuple
    annot: tuple
    strategy: LayerStrategy
    layout: Layout
    opt_layout: Layout
    pairs: tuple
    gather_dtype: torch.dtype
    partial_tp: bool = False
    tp_group: Optional[Group] = None
    dp_group: Optional[Group] = None
    cp_group: Optional[Group] = None

    @property
    def tp_dim(self) -> Optional[int]:
        return next((d for d, (ax, tag) in enumerate(zip(self.layout, self.annot))
                     if ax and tag == "tp"), None)

    @property
    def zero3_dim(self) -> Optional[int]:
        """The dim the parameter itself is split over DP (zero3), or None."""
        return next((d for d, (ax, tag) in enumerate(zip(self.layout, self.annot))
                     if ax and tag == "fsdp"), None)

    @property
    def opt_dim(self) -> Optional[int]:
        """The dim its gradient and optimizer state are split over DP."""
        return next((d for d, (ax, tag) in enumerate(zip(self.opt_layout, self.annot))
                     if ax and tag == "fsdp"), None)

    @property
    def tp_sum(self) -> bool:
        """Its gradient is summed over the TP group: replicated there, and
        computed on a sequence shard (a CP layer runs its TP region without
        SP), or in part on every rank (``partial_tp``)."""
        s = self.strategy
        if s.tp > 1 and self.partial_tp:
            return True
        return s.sp and s.tp > 1 and s.cp == 1 and self.tp_dim is None

    def counts_in_norm(self) -> bool:
        """This rank holds the lowest replica of the (reduced) gradient."""
        tp_ok = self.tp_dim is not None or self.tp_group is None or self.tp_group.index == 0
        dp_ok = self.opt_dim is not None or self.dp_group is None or self.dp_group.index == 0
        cp_ok = self.cp_group is None or self.cp_group.index == 0
        return tp_ok and dp_ok and cp_ok


def _leaf_plan(shape, annot, s: LayerStrategy, name: str, cfg: ModelConfig, mesh: RankMesh):
    pairs = tuple(modeling.tp_pairs(name, cfg) if tag == "tp" else 1 for tag in annot)
    dtype = cfg.param_dtype if name in ("scale", "bias") else cfg.dtype
    return LeafPlan(shape=tuple(shape), strategy=s, annot=tuple(annot),
                    layout=param_layout(shape, annot, mesh.axes, s),
                    opt_layout=param_layout(shape, annot, mesh.axes, s, for_opt_state=True),
                    pairs=pairs, gather_dtype=dtype)


def zip_map(fn, tree, *others, name=None):
    """``fn(leaf, *other_leaves, name)`` over matching trees (dicts keyed,
    lists in order; a tuple is a leaf: a shape or an annotation); ``name``
    is the leaf's dict key."""
    if isinstance(tree, dict):
        return {k: zip_map(fn, tree[k], *(o[k] for o in others), name=k) for k in tree}
    if isinstance(tree, list):
        return [zip_map(fn, t, *(o[i] for o in others), name=name) for i, t in enumerate(tree)]
    return fn(tree, *others, name)


def model_leaf_plans(cfg: ModelConfig, hp: HybridParallelConfig, mesh: RankMesh,
                     shapes: Any) -> Dict[str, Any]:
    """A :class:`LeafPlan` per parameter of ``shapes`` (a tree of full
    shapes): per-layer strategies for the layers (an encoder-decoder's
    encoder layers take the plan's first ``enc_layers`` entries), the
    embedding strategy for everything else, an encoder's final norm
    included (the reference's ``model_param_specs``)."""
    annots = modeling.model_annotations(cfg)
    es = embed_strategy(hp)
    out: Dict[str, Any] = {}
    for key in shapes:
        if key in ("layers", "enc_layers"):
            first = cfg.enc_layers if key == "layers" else 0  # strategy index of layer 0
            out[key] = [
                zip_map(lambda sh, a, n, s=hp.layer_strategies[first + i]:
                        _leaf_plan(sh, a, s, n, cfg, mesh), shapes[key][i], annots[key][i])
                for i in range(len(shapes[key]))]
            if cfg.moe_experts > 0:
                for lp in out[key]:
                    lp["mlp"]["router"]["w"].partial_tp = True
        else:
            out[key] = zip_map(lambda sh, a, n: _leaf_plan(sh, a, es, n, cfg, mesh),
                                shapes[key], annots[key])
    return out


def param_shapes(cfg: ModelConfig) -> Any:
    """The full parameter shapes of ``cfg``, without allocating them."""
    return zip_map(lambda t, n: tuple(t.shape), modeling.init_model_params(cfg, 0, "meta"))


def shard_tree(full: Any, plans: Any, mesh: RankMesh, rank: int) -> Any:
    """``rank``'s pieces of a full parameter tree (tensors or numpy)."""
    return zip_map(lambda t, lp, n: shard(t, lp.layout, mesh, rank, lp.pairs), full, plans)


# ---------------------------------------------------------------------------
# The runtime
# ---------------------------------------------------------------------------


@dataclass
class Runtime:
    cfg: ModelConfig
    device: torch.device
    chunks: int
    ckpt: str  # the layers' recompute mode, or 'per-layer' when they differ
    train_step: Callable
    eval_loss: Callable
    init_state: Callable
    state_from: Callable
    world: int = 1
    rank: int = 0
    ckpts: List[str] = field(default_factory=list)  # per layer of the whole model
    #: the fp16 dynamic loss scaler's config (None unless mixed_precision is fp16)
    scaler_cfg: Optional[LossScalerConfig] = None
    #: full parameter shapes and per-leaf placements (``model_leaf_plans``):
    #: what the portable checkpoint gathers and cuts (``core/checkpoint.py``)
    leaf_plans: Any = None
    mesh: Optional[RankMesh] = None
    groups: Any = None
    pp: int = 1
    stage: int = 0  # this rank's pipeline stage
    stage_layers: List[int] = field(default_factory=list)  # the layers this rank runs
    #: the last train step's "in_flight": the most micro-batches it held at once,
    #: "updated", and under grad_overlap "buckets": {"backward": issued by the
    #: backward's hooks, "after": issued after it}
    stats: Dict[str, Any] = field(default_factory=dict)


@functools.lru_cache(maxsize=8)
def _rope_tables(cfg: ModelConfig, seq: int, device: torch.device):
    return modeling.rope_tables(cfg, seq, device)


def _layer_cfg(cfg: ModelConfig, ckpt: str) -> ModelConfig:
    # full-layer recompute saves only the layer boundary: a nested gate-save
    # policy inside it is pure overhead (the reference's rule)
    return cfg.replace(mlp_recompute="off") if ckpt == "full" else cfg


def _make_layer_hook(cfg: ModelConfig, ckpt: Union[str, List[str]], layer_fn=None,
                     seq_len: Optional[int] = None):
    """Per-layer execution: 'full' recomputes the whole layer in the
    backward (saving only its input; the nested MLP policy is switched off
    there, as the reference does), 'selective' only the attention core.
    ``ckpt`` is one mode for every layer or a list of per-layer modes;
    ``layer_fn(i, x, lp, layer_cfg, cos_sin, ckpt, seg_ids, alibi)``
    replaces the plain ``decoder_layer`` call (the hybrid runtime's
    redistribution, ZeRO-3 gathers and TP region), whose input may be a
    sequence shard: the RoPE tables then cover ``seq_len`` positions.
    ``seg_ids`` (packed rows, (B, S) over the whole sequence) mask the
    attention per segment; the RoPE tables are then gathered per row by the
    per-segment positions. ``alibi`` is the model's (n,) slopes (ALiBi
    models; ``decoder_layer`` takes a TP rank's own heads' part). An
    encoder-decoder's encoder layers (i < ``enc_layers``) run
    bidirectionally over ``enc_seq`` positions; its decoder layers get
    ``enc_out`` (``layer_fn``'s last argument). A Swin layer is
    ``modeling.swin_layer`` at its stage's shapes."""

    def hook(i: int, x, lp, seg_ids=None, enc_out=None):
        mode = ckpt if isinstance(ckpt, str) else ckpt[i]
        layer_cfg = _layer_cfg(cfg, mode)
        if i < cfg.enc_layers:
            layer_cfg = modeling.encoder_cfg(layer_cfg)
        cos_sin = None
        if layer_cfg.pos_embed == "rope":
            seq = modeling.layer_seq(cfg, seq_len, i) if seq_len else x.shape[1]
            cos_sin = _rope_tables(layer_cfg, seq, x.device)
        alibi = modeling.alibi_tensor(layer_cfg, x.device)
        if layer_fn is not None:
            return layer_fn(i, x, lp, layer_cfg, cos_sin, mode, seg_ids, alibi, enc_out)
        cos_sin = _packed_tables(layer_cfg, cos_sin, seg_ids)

        def run(x_):
            if cfg.swin_depths:
                return modeling.swin_layer(x_, lp, layer_cfg, i, remat_attn=mode == "selective")
            return modeling.decoder_layer(x_, lp, layer_cfg, cos_sin,
                                          remat_attn=mode == "selective", seg_ids=seg_ids,
                                          alibi=alibi, enc_out=enc_out)

        if mode == "full" and torch.is_grad_enabled():
            return checkpoint(run, x, use_reentrant=False)
        return run(x)

    return hook


def _packed_tables(cfg: ModelConfig, cos_sin, seg_ids):
    """The shared RoPE tables gathered per row by the per-segment positions
    of ``seg_ids`` (packed rows), or as they are."""
    if seg_ids is None or cos_sin is None:
        return cos_sin
    return modeling.packed_rope_tables(cfg, modeling.positions_from_segments(seg_ids), cos_sin)


def _trainable(tree):
    """The tree's tensors as autograd leaves requiring grad. ``detach``
    shares storage, so the in-place updates still land in the caller's
    tensors; a non-leaf (e.g. a ``.to(device)`` of a tensor that requires
    grad) would otherwise never receive a ``.grad``."""
    if isinstance(tree, dict):
        return {k: _trainable(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_trainable(v) for v in tree]
    return tree.detach().requires_grad_(True)


def _world() -> tuple:
    """(world size, rank) of the default process group; 1 rank when none
    exists, and an error when the environment names a larger world that
    was never initialised."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    env = int(os.environ.get("WORLD_SIZE", "1") or 1)
    if env > 1:
        raise RuntimeError(
            f"WORLD_SIZE={env} but no process group is initialised: call "
            "core.trainer.init_distributed (cli train does) before build_runtime")
    return 1, 0


def _reduce_dp(g: torch.Tensor, lp: LeafPlan) -> torch.Tensor:
    """A gradient's reduction over its DP group: nothing for zero3 (its
    gather's backward reduce-scattered it), a reduce-scatter onto this
    rank's optimizer shard for zero2, an all-reduce for DDP."""
    if lp.zero3_dim is not None:
        return g
    if lp.opt_dim is not None:
        return comm.reduce_scatter(g, lp.dp_group, lp.opt_dim)
    return comm.all_reduce(g, lp.dp_group)


def _reduce_cp(g: torch.Tensor, lp: LeafPlan) -> torch.Tensor:
    """A context-parallel layer's gradient summed over its CP group: each
    member computed it on its own block of the sequence, against the same
    (replicated) parameter. Nothing for a layer without CP."""
    return comm.all_reduce(g, lp.cp_group)


def _opt_view(p: torch.Tensor, lp: LeafPlan) -> torch.Tensor:
    """The part of a zero2 parameter this rank updates (the whole local
    tensor otherwise)."""
    if lp.zero3_dim is not None or lp.opt_dim is None:
        return p
    size = p.shape[lp.opt_dim] // lp.dp_group.size
    return p.narrow(lp.opt_dim, lp.dp_group.index * size, size)


def _sum_tied(g: torch.Tensor, group: Optional[Group]) -> torch.Tensor:
    """The tied token table's gradient summed over its two copies (the first
    and the last stage's ranks of one in-stage index)."""
    return comm.all_reduce(g, group)


class _Buckets:
    """The per-layer gradient buckets of one train step under
    ``grad_overlap``: a hook on each bucketed leaf counts the leaves of its
    layer whose gradient the last micro-batch's backward has accumulated
    (``armed``); with the layer's last one, every leaf of its bucket is
    divided (``divide``) and reduce-scattered asynchronously over its DP
    group. A bucket the backward never completed is issued at
    :meth:`result`."""

    def __init__(self, leaves, leaf_plans, bucket_of: Dict[int, int], divide):
        self.leaves, self.plans, self.divide = leaves, leaf_plans, divide
        self.members: Dict[int, List[int]] = {}
        for j, layer in bucket_of.items():
            self.members.setdefault(layer, []).append(j)
        self.bucket_of = bucket_of
        self.left = {layer: len(js) for layer, js in self.members.items()}
        self.pending: Dict[int, comm.Pending] = {}
        self.armed = False
        self.issued = {"backward": 0, "after": 0}  # buckets issued by the hooks / at result
        self.handles = [leaves[j].register_post_accumulate_grad_hook(self._hook(j))
                        for j in bucket_of]

    def _hook(self, j: int):
        def on_grad(p):
            if not self.armed:
                return
            layer = self.bucket_of[j]
            self.left[layer] -= 1
            if self.left[layer] == 0:
                self._issue(layer)
                self.issued["backward"] += 1
        return on_grad

    def _issue(self, layer: int) -> None:
        for j in self.members[layer]:
            lp = self.plans[j]
            self.pending[j] = comm.reduce_scatter_async(self.divide(self.leaves[j].grad),
                                                        lp.dp_group, lp.opt_dim)

    def result(self, j: int) -> torch.Tensor:
        if j not in self.pending:
            self._issue(self.bucket_of[j])
            self.issued["after"] += 1
        return self.pending.pop(j).wait()

    def remove(self) -> None:
        for h in self.handles:
            h.remove()


def _schedules(cfg: ModelConfig, hp: HybridParallelConfig, chunks: int):
    """(train schedule, eval schedule) of the plan: at pp = 1 the forward
    and backward of each micro-batch in turn (plain accumulation); an
    encoder-decoder's and a Swin pyramid's coupled clocks at pp > 1."""
    pp, vpp = hp.pp, hp.vpp
    if pp == 1:
        return pipedream_schedule(1, chunks), pipeline.gpipe_schedule(1, chunks, train=False)
    if cfg.enc_layers > 0 or cfg.swin_depths:
        # the coupled sections: an encoder-decoder's two, Swin's K stages
        k = 2 if cfg.enc_layers > 0 else len(cfg.swin_depths)
        train = (pipeline.sections_1f1b_schedule(pp, k, chunks)
                 if hp.pipeline_type == "pipedream_flush"
                 else pipeline.sections_gpipe_schedule(pp, k, chunks))
        return train, pipeline.sections_gpipe_schedule(pp, k, chunks, train=False)
    if vpp > 1:
        train = (interleaved_1f1b_schedule(pp, vpp, chunks)
                 if hp.pipeline_type == "pipedream_flush"
                 else interleaved_schedule(pp, vpp, chunks))
        return train, interleaved_schedule(pp, vpp, chunks, train=False)
    train = (pipedream_schedule(pp, chunks) if hp.pipeline_type == "pipedream_flush"
             else pipeline.gpipe_schedule(pp, chunks))
    return train, pipeline.gpipe_schedule(pp, chunks, train=False)


def build_runtime(
    cfg: ModelConfig,
    hp: Optional[HybridParallelConfig] = None,
    adam: AdamConfig = AdamConfig(),
    global_batch_size: int = 8,
    seq_len: int = 2048,
    chunks: Optional[int] = None,
    ckpt: Union[str, int, None] = None,
    mixed_precision: Optional[str] = None,
    device=None,
) -> Runtime:
    """The train/eval step of ``cfg`` under the plan ``hp`` on
    (global_batch_size, seq_len + 1) token batches (packed or vision:
    ``modeling.batch_row_width``; a vision model's layers run over its
    ``n_patches``, whatever ``seq_len`` says). Without ``hp`` the plan
    is uniform at tp=1 with ``chunks``, ``ckpt`` ('none' | 'full' |
    'selective', or the --global_checkpoint integer) and
    ``mixed_precision`` ('fp32' | 'bf16' | 'fp16'); with ``hp`` those come from the
    plan and must not be passed. The world is the default process group's
    (one rank when there is none); a plan with pp > 1 runs this rank's
    pipeline stage under the plan's schedule. ``device`` defaults to
    ``cuda`` and raises without a card unless 'cpu' is asked for."""
    device = resolve_device(device)
    seq_len = modeling.layer_seq(cfg, seq_len)
    check_packed(cfg, hp)
    if hp is not None:
        check_cp(cfg, hp, seq_len)
        check_ep(cfg, hp)
    modeling.check_supported(cfg)
    if hp is None:
        mixed_precision = mixed_precision or "bf16"
        ckpt = CKPT_MODES.get(ckpt, ckpt) if ckpt is not None else "none"
        if ckpt not in ("none", "full", "selective"):
            raise ValueError(f"unknown ckpt mode {ckpt!r}")
        if mixed_precision not in _PRECISION:
            raise ValueError(f"unknown mixed_precision {mixed_precision!r}")
        hp = HybridParallelConfig.uniform(
            cfg.total_layers, ckpt=ckpt, chunks=max(1, int(chunks or 1)),
            mixed_precision=mixed_precision, mlp_recompute=cfg.mlp_recompute)
    elif chunks is not None or ckpt is not None or mixed_precision is not None:
        raise ValueError("with a plan (hp), chunks / ckpt / mixed_precision come from the plan")
    if hp.mixed_precision not in _PRECISION:
        raise ValueError(f"unknown mixed_precision {hp.mixed_precision!r}")
    encdec = cfg.enc_layers > 0
    swin = bool(cfg.swin_depths)
    if hp.num_layers != cfg.total_layers:
        raise ValueError(f"strategy has {hp.num_layers} layer entries but the model has "
                         f"{cfg.total_layers}" + (" (encoder + decoder)" if encdec else "")
                         + " layers")
    strategies = list(hp.layer_strategies)
    es = embed_strategy(hp)
    for i, s in enumerate(strategies):
        modeling.check_tp_shapes(modeling.vision_layer_cfg(cfg, i), s.tp, f"layer {i}")
        tokens = modeling.layer_seq(cfg, seq_len, i)
        if swin and s.sp and tokens % s.tp:
            raise ValueError(f"layer {i}: its stage's {tokens} tokens do not split over "
                             f"tp={s.tp} under SP (the port does not pad them)")
    if cfg.image_size:
        for what, n in (("classes", cfg.num_classes), ("hidden", cfg.hidden_size)):
            if n % es.tp:
                raise ValueError(f"{what} {n} does not split over vocab_tp={es.tp}")
    elif cfg.vocab_size % es.tp:
        raise ValueError(f"vocab {cfg.vocab_size} does not split over vocab_tp={es.tp}")
    world, rank = _world()
    hp.validate(world)
    pp = hp.pp
    if encdec and pp > 1:
        pipeline_encdec.validate_encdec_pipeline(cfg, hp)
    elif swin and pp > 1:
        pipeline_swin.SwinLayout(cfg, hp)
    elif hp.vpp > 1:
        validate_interleaved_strategies(cfg.num_layers, hp)
    elif pp > 1:
        pipeline.validate_pipeline_strategies(cfg.num_layers, hp)
    vstages = pipeline.virtual_stages(cfg, hp)
    cfg = cfg.replace(dtype=_PRECISION[hp.mixed_precision], mlp_recompute=hp.mlp_recompute)
    fp16 = hp.mixed_precision == "fp16"
    scaler_cfg = LossScalerConfig() if fp16 else None
    chunks = max(1, hp.chunks)
    if global_batch_size % chunks:
        raise ValueError(f"global batch {global_batch_size} not divisible by chunks {chunks}")
    mesh = RankMesh(world, pp)
    mb_rows = global_batch_size // chunks
    E = cfg.enc_layers
    seqs = [modeling.layer_seq(cfg, seq_len, i) for i in range(len(strategies))]
    # Swin: each stage's first layer, where the merged stream starts
    starts = modeling.swin_stage_starts(cfg)
    for i, s in enumerate(strategies + [es]):
        what = f"layer {i}" if i < len(strategies) else "embedding/head"
        # the sequences its layout carries: the layer's own; an
        # encoder-decoder's decoder layers and embedding, the encoder's too;
        # Swin's embedding, the tokens of every merge's output
        carried = {seqs[i] if i < len(strategies) else seq_len}
        if encdec and i >= E:
            carried.add(cfg.enc_seq)
        if i == len(strategies):
            carried.update(seqs[j] for j in starts)
        try:
            mesh.batch_rows(rank, s, mb_rows)
            for sq in carried:
                mesh.seq_slice(rank, s, sq)
        except ValueError as e:
            raise ValueError(f"{what} ({s}): {e}") from None
    ckpts = [s.ckpt or "none" for s in strategies]  # LayerStrategy.ckpt: False | 'full' | 'selective'
    sched, eval_sched = _schedules(cfg, hp, chunks)
    stage = mesh.stage(rank)
    last_vstage = len(vstages) - 1
    first, last = stage == 0, stage == pp - 1
    layer_ids = pipeline.device_layers(cfg, hp, stage)
    local = pipeline.local_index(layer_ids, E)
    tied = cfg.tie_word_embeddings and pp > 1
    # where a stream turns, (virtual stage, position in it) → the layer that
    # starts the new stream: an encoder-decoder turns from its encoder to its
    # decoder at the start of the decoder's first virtual stage (device 0),
    # or before layer E of the one virtual stage at pp = 1; Swin merges into
    # stage k at the start of section k's first virtual stage (device 0), or
    # before the stage's first layer at pp = 1
    turns: Dict[tuple, int] = {}
    if encdec:
        turns[(pp, 0) if pp > 1 else (0, E)] = E
    for k in range(1, len(starts)):
        turns[(k * pp, 0) if pp > 1 else (0, starts[k])] = starts[k]
    stream_starts = {0, *turns.values()}

    axes_list = [mesh.axes.data_axes]
    for s in strategies + [es]:
        axes_list += [mesh.tp_axes(s), mesh.dp_axes(s), mesh.cp_axes(s)]
    if cfg.moe_experts > 0:
        for s in strategies:
            axes_list += [mesh.ep_axes(s), mesh.replica_axes(s), mesh.token_axes(s)]
    if pp > 1:
        axes_list += [(mesh.axes.pp,), mesh.world_axes]
    # the tied table's two copies: one group per in-stage index, made once
    extra = {"tied": [[r, r + (pp - 1) * mesh.per_stage] for r in range(mesh.per_stage)]
             } if tied else None
    groups = ProcessGroups(mesh, rank, axes_list, extra)
    # the reference's condition for the collective matmul (``with_tp_overlap_ctx``)
    overlap = [s.tp_overlap and s.tp > 1 and world > 1 and s.cp == 1 for s in strategies]
    if pp > 1 or any(s.cp > 1 and s.cp_impl == "ring" for s in strategies) or any(overlap):
        comm.open_p2p(device)  # the CP ring and the collective matmul shift with exchange too
    stage_group = groups.get(mesh.axes.data_axes)
    world_group = groups.get(mesh.world_axes)
    all_plans = model_leaf_plans(cfg, hp, mesh, param_shapes(cfg))
    plans = pipeline.held_tree(all_plans, layer_ids, first, last, tied)
    for lp in tree_leaves(plans):
        lp.tp_group = groups.get(mesh.tp_axes(lp.strategy))
        lp.dp_group = groups.get(mesh.replica_axes(lp.strategy) if "ep" in lp.annot
                                 else mesh.dp_axes(lp.strategy))
        lp.cp_group = groups.get(mesh.cp_axes(lp.strategy))
    leaf_plans = tree_leaves(plans)
    # a tied table's two copies (stage 0's and the last stage's) are summed;
    # the grad norm counts stage 0's
    tied_leaf = plans["embed"]["tok"] if tied and (first or last) else None
    tied_copy = tied_leaf if last else None
    stats: Dict[str, int] = {}

    def act_layout(s):
        return batch_spec(mesh.axes, s)

    layouts = [act_layout(s) for s in strategies]
    embed_layout = act_layout(es)
    # a CP layer runs its TP region without SP, on its CP block (``inner``)
    tp_regions = [comm.TPRegion(groups.get(mesh.tp_axes(s)), s.sp and s.cp == 1, overlap[i])
                  if s.tp > 1 else None for i, s in enumerate(strategies)]
    inner = [(layouts[i][0], mesh.cp_axes(s)) if s.cp > 1 else layouts[i]
             for i, s in enumerate(strategies)]
    cp_layers = [functools.partial(ring.ring_decoder_layer if s.cp_impl == "ring"
                                   else ulysses.ulysses_decoder_layer,
                                   group=groups.get(mesh.cp_axes(s)))
                 if s.cp > 1 else None for s in strategies]
    vocab = comm.TPRegion(groups.get(mesh.tp_axes(es)), es.sp) if es.tp > 1 else None
    embed_dp = groups.get(mesh.dp_axes(es))

    @functools.lru_cache(maxsize=None)
    def moe_ctx(i: int, rows: int):
        """Layer i's MoE groups on a micro-batch of ``rows`` global rows
        (None when its tokens are all on this rank and it has no EP)."""
        s = strategies[i]
        tokens = groups.get(mesh.token_axes(s))
        if cfg.moe_experts == 0 or (tokens.size == 1 and s.ep == 1):
            return None
        order = lambda ranks: torch.from_numpy(np.stack(  # noqa: E731
            [mesh.token_order(q, s, rows, seqs[i]) for q in ranks])).to(device)
        ep = groups.get(mesh.ep_axes(s)) if s.ep > 1 else None
        return MoEContext(tokens, order(tokens.ranks), ep,
                          order(ep.ranks) if ep is not None else None)

    def materialize(tree, tree_plans, regather=None):
        """zero3 leaves gathered (in the dtype they are used in), the rest
        as they are."""
        def leaf(p, lp, name):
            if lp.zero3_dim is None:
                return p
            if regather is not None:
                return regather.gather(p, lp.zero3_dim, lp.dp_group, lp.gather_dtype)
            return comm.gather_param(p, lp.zero3_dim, lp.dp_group, lp.gather_dtype)
        return zip_map(leaf, tree, tree_plans)

    has_zero3 = [any(lp.zero3_dim is not None
                     for lp in tree_leaves(pipeline.layer_of(all_plans, i)))
                 for i in range(len(strategies))]

    def layer_fn(i, x, lp, layer_cfg, cos_sin, mode, seg_ids=None, alibi=None, enc_out=None):
        # the input arrives in the previous layer's layout, also across a
        # stage boundary: the receiving stage moves it (a stack's first
        # layer takes the embedding's)
        x = comm.redistribute(x, mesh, rank, stage_group,
                              layouts[i - 1] if i not in stream_starts else embed_layout,
                              layouts[i])
        if enc_out is not None:
            # the encoder output (embedding layout) into this decoder
            # layer's; autograd sums its gradients over the decoder layers
            enc_out = comm.redistribute(enc_out, mesh, rank, stage_group, embed_layout,
                                        layouts[i])
        lplans = pipeline.layer_of(all_plans, i)
        if seg_ids is not None:
            # this layer's rows, over the whole sequence: the attention sees
            # all of it (no CP under packing; SP gathers it in the TP region)
            seg_ids = seg_ids[mesh.batch_rows(rank, strategies[i], seg_ids.shape[0])]
            cos_sin = _packed_tables(layer_cfg, cos_sin, seg_ids)
        if cfg.moe_experts > 0:
            ctx = moe_ctx(i, x.shape[0] << len(layouts[i][0]))
            layer_cfg = layer_cfg.replace(moe_ctx=ctx) if ctx is not None else layer_cfg

        def run(x_, regather=None):
            p = materialize(lp, lplans, regather)
            if swin:
                return modeling.swin_layer(x_, p, layer_cfg, i, remat_attn=mode == "selective",
                                           tp=tp_regions[i])
            if cp_layers[i] is not None:
                return cp_layers[i](x_, p, layer_cfg, cos_sin=cos_sin, tp=tp_regions[i])
            return modeling.decoder_layer(x_, p, layer_cfg, cos_sin,
                                          remat_attn=mode == "selective", tp=tp_regions[i],
                                          seg_ids=seg_ids, alibi=alibi, enc_out=enc_out)

        # SP with CP: the CP block, gathered over the TP group, and back
        x = comm.redistribute(x, mesh, rank, stage_group, layouts[i], inner[i])
        grad = torch.is_grad_enabled()
        if mode == "full" and grad:
            # the recompute gathers the zero3 parameters again
            y = checkpoint(run, x, use_reentrant=False)
        elif has_zero3[i] and grad:
            y = _regathering(run, x)
        else:
            y = run(x)
        return comm.redistribute(y, mesh, rank, stage_group, inner[i], layouts[i])

    def _regathering(run, x):
        rg = comm.Regather()
        with rg.saving():
            y = run(x, rg)
        rg.release()
        return y

    hook = _make_layer_hook(cfg, ckpts, layer_fn, seq_len)
    top_keys = [k for k in plans if k not in ("layers", "enc_layers")]
    top_zero3 = any(lp.zero3_dim is not None for k in top_keys for lp in tree_leaves(plans[k]))

    def to_decoder(x, top, tokens):
        """An encoder-decoder's turn: the encoder output into the embedding
        layout, ``enc_final_norm`` → ctx, and the decoder tokens embedded."""
        x = comm.redistribute(x, mesh, rank, stage_group, layouts[E - 1], embed_layout)
        ctx = modeling.norm(x, top["enc_final_norm"], cfg)
        return modeling.embed(tokens[:, cfg.enc_seq:], top, cfg, vocab), ctx

    def merge(x, top, stage):
        """Swin's patch merge after stage ``stage``: the stream into the
        embedding's layout, over the embedding's TP group under its SP the
        whole map gathered and this rank's shard of the merged tokens kept."""
        x = comm.redistribute(x, mesh, rank, stage_group, layouts[starts[stage + 1] - 1],
                              embed_layout)
        tokens = None
        if vocab is not None and vocab.sp:
            x = vocab.enter(x)
            tokens = vocab.seq_slice(seqs[starts[stage + 1]])
        return modeling.patch_merge(x, top["merges"][stage], cfg, stage, tokens)

    def stage_forward(params, k, mb, x):
        """Virtual stage k on a micro-batch ``mb`` of token rows: embed this
        rank's rows first (k = 0; otherwise ``x`` is the received
        activation), its layers, then the final norm, head and loss sum
        (the last virtual stage: returns (nll_sum, count)). An
        encoder-decoder turns to its decoder at its one of ``turns``; from
        there its activation is the pair (decoder stream, normed encoder
        output). Swin merges its stream into the next stage at each of
        ``turns``."""
        head = k == last_vstage
        ends = k == 0 or head or any(v == k for v, _ in turns)
        rg = comm.Regather() if ends and top_zero3 and torch.is_grad_enabled() else None
        top = {key: materialize(params[key], plans[key], rg) for key in top_keys} if ends else {}
        hook_kw, pos_ids = {}, None
        if cfg.pack_sequences:
            # the segment ids of every row of the micro-batch (each layer takes its own)
            hook_kw["seg_ids"] = modeling.split_packed_inputs(modeling.split_batch(mb, cfg)[0])[1]
        if ends:
            tokens, labels = modeling.split_batch(mb[mesh.batch_rows(rank, es, mb.shape[0])], cfg)
            if cfg.pack_sequences:
                tokens, _, pos_ids = modeling.split_packed_inputs(tokens)
        ctx = None
        if isinstance(x, tuple):
            x, ctx = x
        with rg.saving() if rg is not None else contextlib.nullcontext():
            if k == 0:
                x = modeling.embed_any(tokens[:, :cfg.enc_seq] if encdec else tokens, top, cfg,
                                       vocab, pos_ids=pos_ids)
            ids = vstages[k]
            for j in range(len(ids) + 1):
                if (k, j) in turns:
                    if encdec:
                        x, ctx = to_decoder(x, top, tokens)
                    else:
                        x = merge(x, top, starts.index(turns[(k, j)]) - 1)
                if j < len(ids):
                    x = hook(ids[j], x, pipeline.layer_of(params, ids[j], local), enc_out=ctx,
                             **hook_kw)
            if head:
                # a zero-layer model (the profiler's vocab fit) has no layer layout
                x = comm.redistribute(x, mesh, rank, stage_group,
                                      layouts[-1] if layouts else embed_layout, embed_layout)
                x = modeling.cross_entropy_sum(modeling.head(x, top, cfg, vocab), labels,
                                               remat=modeling.ce_remat(cfg), vocab=vocab)
        if rg is not None:
            rg.release()
        return x if ctx is None or head else (x, ctx)

    # the activation's layout after each virtual stage: that of the last
    # layer its stream has run by then (an encoder-decoder's decoder stream
    # and a Swin stage's merged stream start in the embedding's; a stage may
    # hold no layers)
    out_layouts, ran = [], []
    for k, ids in enumerate(vstages):
        ran += ids
        begin = max([i for (v, _), i in turns.items() if v <= k], default=0)
        stream = [i for i in ran if i >= begin]
        out_layouts.append(layouts[stream[-1]] if stream else embed_layout)

    def empty(layout, seq, width=cfg.hidden_size):
        b, sq = layout
        return torch.empty((mb_rows >> len(b), seq >> len(sq), width),
                           dtype=cfg.dtype, device=device)

    def buffer(kind, k):
        """An empty activation (or gradient) entering virtual stage k: the
        layout its stream has after the virtual stage that produced it; an
        encoder-decoder's decoder stream comes with the encoder output, in
        the embedding's layout; a Swin section's map has its stage's tokens
        and width."""
        v = k - 1 if kind == pipeline.FWD else k
        if swin:
            h, w, c, _ = modeling.swin_geometry(cfg, v // pp)
            return empty(out_layouts[v], h * w, c)
        if not encdec or v < pp:
            return empty(out_layouts[v], cfg.enc_seq if encdec else seq_len)
        return empty(out_layouts[v], seq_len), empty(embed_layout, cfg.enc_seq)

    def peer(d):
        return rank + (d - stage) * mesh.per_stage

    width = modeling.batch_row_width(cfg, seq_len)

    def _batch(batch) -> torch.Tensor:
        # pp = 1 takes other batch sizes (the ramp-up); a pipeline's buffers
        # are shaped for global_batch_size
        rows_ok = batch.shape[0] == global_batch_size or (pp == 1 and batch.shape[0] % chunks == 0)
        if batch.ndim != 2 or batch.shape[1] != width or not rows_ok:
            raise ValueError(f"batch must be ({global_batch_size}, {width}) tokens"
                             + (" ‖ segment ids" if cfg.pack_sequences else "")
                             + f", got {tuple(batch.shape)}")
        return torch.as_tensor(batch).to(device=device, dtype=torch.long)

    def token_count(batch) -> torch.Tensor:
        """Loss tokens of the whole batch (every rank holds all of it)."""
        return (modeling.split_batch(batch, cfg)[1] != -100).sum()

    def global_loss(tot_s, denom) -> torch.Tensor:
        """The last stage's loss sum over its head DP group, on every rank
        (rank 0 writes the records)."""
        loss = comm.all_reduce(tot_s, embed_dp) / denom if last else torch.zeros_like(tot_s)
        return comm.all_reduce(loss, groups.get((mesh.axes.pp,))) if pp > 1 else loss

    def grad_norm(grads) -> torch.Tensor:
        sq = sum(torch.sum(torch.square(g.float())) for g, lp in zip(grads, leaf_plans)
                 if lp.counts_in_norm() and lp is not tied_copy)
        if not torch.is_tensor(sq):
            sq = torch.zeros((), dtype=torch.float32, device=device)
        return torch.sqrt(comm.all_reduce(sq, world_group))

    # grad_overlap (pp = 1): each zero2 / zero3 layer's leaves that reduce-
    # scatter onto an optimizer shard (the reference pins exactly those)
    bucket_of: Dict[int, int] = {}
    if hp.grad_overlap and pp == 1:
        index = {id(lp): j for j, lp in enumerate(leaf_plans)}
        for i, s in enumerate(strategies):
            if s.dp_type in ("zero2", "zero3"):
                for lp in tree_leaves(pipeline.layer_of(plans, i, local)):
                    if lp.zero3_dim is None and lp.opt_dim is not None:
                        bucket_of[index[id(lp)]] = i

    def train_step(state: Dict[str, Any], batch):
        params = state["params"]
        leaves = tree_leaves(params)
        for p in leaves:
            p.grad = None
        batch = _batch(batch)
        denom = torch.clamp_min(token_count(batch), 1).float()
        mbs = batch.reshape(chunks, batch.shape[0] // chunks, batch.shape[1])
        # sum-form accumulation: gradients of the nll sums accumulate in
        # fp32, then one division, so the result is the global token mean
        # however the ignored tokens fall across chunks and ranks
        tot_s = torch.zeros((), dtype=torch.float32, device=device)
        if fp16:
            # the seed of the scaled backward (the reference's static loss
            # positions of a micro-batch), and the gradients' divisor
            scale = state["scaler"]["scale"]
            seed = scale / (mbs.shape[1] * modeling.loss_tokens_per_sample(cfg, seq_len))
            gdenom = denom * seed
        live: Dict[tuple, tuple] = {}  # (virtual stage, micro-batch) → (input, output)

        def forward(k, m, x):
            for t in () if x is None else pipeline.message_parts(x):
                t.requires_grad_(True)
            y = stage_forward(params, k, mbs[m], x)
            if k == last_vstage:
                y = y[0]
                tot_s.add_(y.detach())
            live[(k, m)] = (x, y)
            return None if k == last_vstage else y

        def divide(g):
            # before the reduction, as the post-backward loop does
            if fp16:
                g.div_(gdenom)
            elif chunks > 1:
                g.div_(denom)
            return g

        buckets = _Buckets(leaves, leaf_plans, bucket_of, divide) if bucket_of else None

        def backward(k, m, g):
            x, y = live.pop((k, m))
            if buckets is not None:
                buckets.armed = m == chunks - 1  # pp = 1: the last micro-batch's backward
            if k == last_vstage:
                if fp16:
                    (y * seed).backward()
                else:
                    (y / denom if chunks == 1 else y).backward()
            else:
                # an encoder-decoder's (y, ctx): a stage passes ctx on, and
                # its gradient gathers each stage's cross-attention share
                torch.autograd.backward(pipeline.message_parts(y), pipeline.message_parts(g))
            if k == 0:
                return None
            grads = tuple(t.grad if t.grad is not None else torch.zeros_like(t)
                          for t in pipeline.message_parts(x))
            return grads if isinstance(x, tuple) else grads[0]

        try:
            in_flight = pipeline.execute(sched, stage, peer, forward, backward, buffer)
        finally:
            if buckets is not None:
                buckets.remove()
        grads = []
        for p in leaves:
            if p.grad is None:  # a leaf the loss does not reach (Swin's wo_b)
                p.grad = torch.zeros_like(p)
        for j, (p, lp) in enumerate(zip(leaves, leaf_plans)):
            if buckets is not None and j in bucket_of:
                g = buckets.result(j)  # the step waits for every bucket
            else:
                g = _reduce_dp(divide(p.grad), lp)
            g = _reduce_cp(g, lp)
            if lp.tp_sum:
                g = comm.all_reduce(g, lp.tp_group)
            if lp is tied_leaf:
                g = _sum_tied(g, groups.named("tied"))
            grads.append(g)
        views = [_opt_view(p, lp) for p, lp in zip(leaves, leaf_plans)]
        loss = global_loss(tot_s, denom).detach()
        updated = True
        if fp16:
            # one verdict for the whole world: a non-finite gradient or loss
            # on any rank or stage skips every rank's update
            bad = (~all_finite(grads + [loss])).float()
            finite = comm.all_reduce(bad, world_group).item() == 0
            gn = grad_norm(grads) if adam.grad_clip is not None and finite else None
            updated = apply_update_with_scaler(state, loss, grads, adam, scaler_cfg,
                                               finite=finite, params=views, grad_norm=gn)
        else:
            gn = grad_norm(grads) if adam.grad_clip is not None else None
            adamw_update(views, grads, state["opt"], adam, grad_norm=gn)
        with torch.no_grad():
            for p, v, lp in zip(leaves, views, leaf_plans):
                if v is not p and updated:  # zero2: every rank's updated part back
                    p.copy_(comm.all_gather(v, lp.dp_group, lp.opt_dim))
        for p in leaves:
            p.grad = None
        state["step"] += 1
        stats["in_flight"] = in_flight
        stats["updated"] = updated
        if buckets is not None:
            stats["buckets"] = dict(buckets.issued)
        return state, loss

    @torch.no_grad()
    def eval_loss(state, batch):
        batch = _batch(batch)
        denom = torch.clamp_min(token_count(batch), 1).float()
        mbs = batch.reshape(chunks, mb_rows, batch.shape[1])
        tot_s = torch.zeros((), dtype=torch.float32, device=device)

        def forward(k, m, x):
            y = stage_forward(state["params"], k, mbs[m], x)
            if k != last_vstage:
                return y
            tot_s.add_(y[0])
            return None

        pipeline.execute(eval_sched, stage, peer, forward, None, buffer)
        return global_loss(tot_s, denom)

    def state_from(params):
        """A fresh train state over this rank's parameter pieces (fp32
        master tensors on the runtime's device; at world size 1, the whole
        tree; under a pipeline, the part its stage holds:
        ``pipeline.held_tree``)."""
        def check(t, lp, name):
            want = local_shape(lp.shape, lp.layout)
            if t.device != device or t.dtype != cfg.param_dtype or tuple(t.shape) != want:
                raise ValueError(
                    f"state_from needs {cfg.param_dtype} pieces of shape {want} on {device}, "
                    f"got {t.dtype} {tuple(t.shape)} on {t.device}")
            return torch.zeros(local_shape(lp.shape, lp.opt_layout), dtype=torch.float32,
                               device=device)
        mu = zip_map(check, params, plans)
        nu = zip_map(lambda t, n: torch.zeros_like(t), mu)
        state = {"params": _trainable(params), "opt": {"mu": mu, "nu": nu, "count": 0},
                 "step": 0}
        if fp16:
            state["scaler"] = init_scaler_state(scaler_cfg, device)
        return state

    def init_state(seed: int):
        """Every rank draws the whole model from ``seed`` and keeps its
        pieces, as tensors of their own (the whole tree is then freed)."""
        def piece(t, lp, name):
            if all(ax is None for ax in lp.layout):
                return t
            return shard(t, lp.layout, mesh, rank, lp.pairs).clone(
                memory_format=torch.contiguous_format)
        full = modeling.init_model_params(cfg, seed, device)
        held = pipeline.held_tree(full, layer_ids, first, last, tied)
        del full
        return state_from(zip_map(piece, held, plans))

    uniform = ckpts[0] if len(set(ckpts)) == 1 else "per-layer"
    return Runtime(cfg=cfg, device=device, chunks=chunks, ckpt=uniform,
                   train_step=train_step, eval_loss=eval_loss, init_state=init_state,
                   state_from=state_from, world=world, rank=rank, ckpts=ckpts, pp=pp,
                   stage=stage, stage_layers=layer_ids, stats=stats,
                   scaler_cfg=scaler_cfg, leaf_plans=all_plans, mesh=mesh, groups=groups)
