"""Flags of the ported modes: the model group, the ``generate`` group (modes
``generate`` and ``serve``), the step-program group, the training group, the
hybrid-parallel GLOBAL flags
(pipelines: ``--pp_deg``, ``--pp_division``, ``--vpp_deg``,
``--pipeline_type``; TP with its layout, SP, context parallelism
(``--context_parallel_deg``, ``--context_parallel_impl``), DDP / ZeRO-2 /
ZeRO-3, recompute, vocab TP / SP, chunks, and ``--galvatron_config_path``), and the
``search``, ``profile``, ``profile_hardware`` and ``check_plan`` groups of
``galvatron_tpu/core/arguments.py`` with the reference's names and defaults,
plus ``--device`` (where a mode touches a device) and ``--dist_backend``.
The training services' flags (``--data_path``, ``--data_mixture``,
``--prefetch_depth``, ``--pack_sequences``, ``--save``, ``--load``,
``--save_interval``, ``--keep_last_n``, ``--rampup_batch_size``,
``--mixed_precision fp16``), the overlap plan flags (``--global_tp_overlap``,
``--grad_overlap``), ``serve --load``, ``--load_hf`` (train, generate,
serve) and ``export-hf``'s ``--output_dir`` keep the reference's names and
defaults. Flags of unported features (multi-slice ``--num_slices``, ...)
are absent, so passing one is an argparse error rather than a silently
ignored option."""

from __future__ import annotations

import argparse
import dataclasses
from typing import Optional, Sequence

import torch

from galvatron_tpu_torch.core.optim import AdamConfig
from galvatron_tpu_torch.core.schedules import LRSchedule
from galvatron_tpu_torch.core.strategy import HybridParallelConfig
from galvatron_tpu_torch.models.modeling import PRESETS, ModelConfig


def _add_model_args(p: argparse.ArgumentParser):
    g = p.add_argument_group("model")
    g.add_argument("--model_size", type=str, default="llama-0.3b", choices=sorted(PRESETS))
    g.add_argument(
        "--set_model_config_manually", type=int, default=0,
        help="1 = require the full manual model config (vocab/hidden/layers/heads); "
        "0 = preset sizes, with any explicitly-passed flags overriding",
    )
    g.add_argument("--vocab_size", type=int, default=None)
    g.add_argument("--hidden_size", type=int, default=None)
    g.add_argument("--num_layers", type=int, default=None)
    g.add_argument("--num_heads", type=int, default=None)
    g.add_argument("--num_kv_heads", type=int, default=None)
    g.add_argument("--ffn_dim", type=int, default=None)
    g.add_argument("--seq_length", type=int, default=None)
    # the other families' shape flags: the search, the plan checker and
    # training read them all (ViT, Swin and the T5 encoder-decoder)
    g.add_argument("--enc_layers", type=int, default=None,
                   help="encoder layers (enc-dec families; 0 = decoder-only)")
    g.add_argument("--enc_seq", type=int, default=None)
    g.add_argument("--image_size", type=int, default=None,
                   help="vision families: input image side (pixels)")
    g.add_argument("--patch_size", type=int, default=None)
    g.add_argument("--num_classes", type=int, default=None)
    g.add_argument("--swin_window", type=int, default=None)
    g.add_argument("--swin_depths", type=str, default=None,
                   help="comma list, e.g. 2,2,18,2 (must sum to --num_layers)")
    g.add_argument("--moe_experts", type=int, default=None,
                   help="switch-MoE expert count (0/None = dense MLP)")
    g.add_argument("--moe_capacity_factor", type=float, default=None)


def _add_generate_args(p: argparse.ArgumentParser):
    """``generate`` and ``serve`` share one group, as in the reference."""
    g = p.add_argument_group("generate")
    g.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="where the model runs; 'cuda' without a card is an error")
    g.add_argument("--load", type=str, default=None,
                   help="checkpoint directory (trainer state): its newest committed "
                   "step's params; default = random weights from seed 0")
    g.add_argument("--load_hf", type=str, default=None,
                   help="local HuggingFace checkpoint directory (LLaMA, Baichuan-1, "
                   "GPT-2, OPT; models/convert.py): the model shape comes from its "
                   "config.json; exclusive with --load")
    g.add_argument("--tokenizer", type=str, default="byte",
                   help="'byte' (the only tokenizer ported so far; the HF tokenizer is "
                   "ROADMAP.md §1.11's remainder)")
    g.add_argument("--prompt", type=str, action="append", default=None,
                   help="generate: a prompt (repeatable; default 'Hello')")
    g.add_argument("--max_new_tokens", type=int, default=64,
                   help="generate: tokens per prompt; serve: a request's default "
                   "tokens_to_generate")
    g.add_argument("--temperature", type=float, default=0.0)
    g.add_argument("--top_k", type=int, default=0)
    g.add_argument("--top_p", type=float, default=0.0)
    g.add_argument("--seed", type=int, default=1234,
                   help="generate: the sampling generator's seed; serve: the "
                   "per-request sampling seed base")
    g.add_argument("--attn_impl", type=str, default="auto", choices=["auto", "flash", "xla"],
                   help="attention override for the model config; 'auto' keeps the "
                   "model's own (the cache forwards attend with the einsum path and "
                   "the paged-decode kernel whatever it says)")
    g.add_argument("--port", type=int, default=5000)
    g.add_argument("--host", type=str, default="127.0.0.1")
    g.add_argument("--num_slots", type=int, default=4,
                   help="KV slots = max concurrently decoding requests (0 disables "
                   "the engine: the serialized single-shot path)")
    g.add_argument("--prefill_chunk", type=int, default=32,
                   help="prompt tokens prefilled per forward when a request joins")
    g.add_argument("--kv_num_blocks", type=int, default=0,
                   help="paged KV backend: block-pool size including the null "
                   "block; -1 = auto-size to num_slots x max_blocks; 0 = the "
                   "contiguous slot cache")
    g.add_argument("--kv_block_size", type=int, default=16, help="tokens per KV block")
    g.add_argument("--prefix_cache", type=str, default="on", choices=["on", "off"],
                   help="keep refcount-0 prompt blocks registered for "
                   "copy-on-write prefix sharing (LRU-evicted under pressure)")
    g.add_argument("--request_ttl_s", type=float, default=30.0,
                   help="end-to-end request deadline; <= 0: no deadline")
    g.add_argument("--deadline_policy", type=str, default="partial",
                   choices=["partial", "fail"],
                   help="over-deadline DECODING requests: 'partial' returns the "
                   "text so far marked truncated=deadline; 'fail' 503s them")
    g.add_argument("--max_queue", type=int, default=64,
                   help="admission queue depth; beyond it requests 503")
    g.add_argument("--max_pending", type=int, default=8,
                   help="serialized path (--num_slots 0): queued /api requests "
                   "beyond which requests 503")
    g.add_argument("--drain_timeout_s", type=float, default=30.0,
                   help="graceful drain bound (SIGTERM or POST /drain)")
    g.add_argument("--max_engine_restarts", type=int, default=3,
                   help="consecutive no-progress in-process engine restarts "
                   "before the engine gives up")
    g.add_argument("--output_dir", type=str, default=None,
                   help="export-hf: directory for the HF-format checkpoint")


def _add_step_program_args(p: argparse.ArgumentParser):
    g = p.add_argument_group("step program")
    g.add_argument("--lr", type=float, default=1e-4)
    g.add_argument("--min_lr", type=float, default=0.0)
    g.add_argument("--lr_warmup_iters", type=int, default=0)
    g.add_argument("--lr_decay_iters", type=int, default=0, help="0 = no decay")
    g.add_argument("--lr_decay_style", type=str, default="cosine",
                   choices=["constant", "linear", "cosine"])
    g.add_argument("--weight_decay", type=float, default=0.01)
    g.add_argument("--grad_clip", type=float, default=1.0)
    g.add_argument("--mixed_precision", type=str, default="bf16",
                   choices=["fp32", "bf16", "fp16"],
                   help="compute dtype over fp32 master weights; fp16 adds dynamic "
                   "loss scaling (every family; the kernels run their fp16 instances)")
    g.add_argument("--attn_impl", type=str, default="auto", choices=["auto", "flash", "xla"],
                   help="auto = the flash kernels on the card, the einsum path on the CPU")
    g.add_argument("--mlp_recompute", type=str, default="policy",
                   choices=["off", "gate", "policy"],
                   help="activation recompute over the MLP/norm/loss regions: 'policy' "
                   "saves the swiglu gate once per layer and recomputes the fp32 "
                   "norm/cross-entropy widenings; 'gate' recomputes only the "
                   "product; 'off' saves everything")


def _add_train_args(p: argparse.ArgumentParser):
    _add_step_program_args(p)
    g = p.add_argument_group("training")
    g.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="where training runs; 'cuda' without a card is an error")
    g.add_argument("--global_train_batch_size", type=int, default=8)
    g.add_argument("--train_iters", type=int, default=10)
    g.add_argument(
        "--rampup_batch_size", type=int, nargs=3, default=None,
        metavar=("START", "INCREMENT", "SAMPLES"),
        help="global-batch-size ramp-up (reference: megatron microbatches.py); pp=1 only",
    )
    g.add_argument("--seed", type=int, default=1234)
    g.add_argument("--pack_sequences", type=int, default=0,
                   help="1 = greedy first-fit sequence packing (data/packing.py): "
                   "documents bin-packed into seq_length rows with segment ids; "
                   "attention is masked per segment, positions restart per segment "
                   "and labels are masked at boundaries. Needs --data_path or "
                   "--data_mixture and the einsum attention ('auto' picks it)")
    g.add_argument("--dist_backend", type=str, default=None, choices=["nccl", "gloo"],
                   help="process-group backend when WORLD_SIZE > 1: nccl on cuda, gloo on "
                   "cpu by default; gloo with --device cuda stages every collective "
                   "through the host")
    g.add_argument("--dist_timeout_s", type=float, default=600.0,
                   help="bound on the rendezvous and on every collective")
    _add_parallel_args(p)
    g.add_argument("--data_path", type=str, default=None,
                   help="corpus prefix: a sharded manifest (<prefix>.shards.json, "
                   "galvatron_tpu_torch.data) or a single-file <prefix>.bin/.idx.json "
                   "pair; default = synthetic tokens")
    g.add_argument("--data_mixture", type=str, default=None,
                   help="deterministic weighted multi-corpus mixture: a JSON file "
                   "({'sources': [{'name','prefix','weight'}, ...]}, see configs/data/) "
                   "or inline 'prefix=weight,prefix=weight'")
    g.add_argument("--prefetch_depth", type=int, default=0,
                   help="async input prefetch: a background host thread assembles batch "
                   "k+1 and moves it to the device while step k runs (this many in "
                   "flight; 0 = synchronous). Needs --data_path or --data_mixture")
    g.add_argument("--metrics_path", type=str, default=None,
                   help="JSONL metrics sink (one train_iter record per iteration)")
    g.add_argument("--save", type=str, default=None, help="checkpoint directory")
    g.add_argument("--keep_last_n", type=int, default=0,
                   help="checkpoint retention: after each committed save, prune all but "
                   "the newest N committed steps (0 = keep all)")
    g.add_argument("--load", type=str, default=None, help="resume directory")
    g.add_argument("--load_hf", type=str, default=None,
                   help="initialize weights from a local HuggingFace checkpoint directory "
                   "(LLaMA, Baichuan-1, GPT-2, OPT; models/convert.py; overrides the model "
                   "shape from the HF config, --seq_length still applies)")
    g.add_argument("--save_interval", type=int, default=0)
    g.add_argument("--check_loss", type=int, default=0,
                   help="1 = fail the run on a non-finite loss")


def _add_parallel_args(p: argparse.ArgumentParser):
    g = p.add_argument_group("hybrid parallelism (GLOBAL flags, used without "
                             "--galvatron_config_path)")
    g.add_argument("--pp_deg", type=int, default=1,
                   help="pipeline degree: stages of WORLD_SIZE / pp_deg ranks each")
    g.add_argument("--pp_division", type=_int_list, default=None,
                   help="comma-separated layers per pipeline stage (uneven divisions "
                   "supported; default: balanced split)")
    g.add_argument("--vpp_deg", type=int, default=1,
                   help="virtual pipeline chunks per device (interleaved schedule; needs "
                   "layers %% (pp*vpp) == 0 and chunks %% pp == 0)")
    g.add_argument("--pipeline_type", type=str, default="gpipe",
                   choices=["gpipe", "pipedream_flush"],
                   help="gpipe = every forward, then every backward; pipedream_flush = 1F1B")
    g.add_argument("--global_tp_deg", type=int, default=1)
    g.add_argument("--global_tp_consec", type=int, default=1,
                   help="1 = TP on consecutive ranks (minor mesh axes), 0 = strided")
    g.add_argument("--sdp", type=int, default=0, help="1 = zero3 on all layers")
    g.add_argument("--default_dp_type", type=str, default="ddp",
                   choices=["ddp", "zero2", "zero3"])
    g.add_argument("--global_checkpoint", type=int, default=0, choices=[0, 1, 2],
                   help="0 = off, 1 = full-layer recompute, 2 = selective "
                   "(attention-core-only recompute)")
    g.add_argument("--sequence_parallel", type=int, default=0)
    g.add_argument("--global_tp_overlap", type=int, default=0,
                   help="1 = decomposed collective matmul on the TP projection seams "
                   "of every tp>1 layer (ops/collective_matmul.py): the qkv/MLP-up "
                   "sequence all-gather and the output-projection reduction run as "
                   "rings of asynchronous sends behind the GEMM chunks")
    g.add_argument("--grad_overlap", type=int, default=0,
                   help="1 = ZeRO gradient overlap: each zero2/zero3 layer's gradient "
                   "bucket is reduce-scattered asynchronously as soon as that layer's "
                   "last micro-batch backward is done (pp=1; accepted and inert at pp>1)")
    g.add_argument("--context_parallel_deg", type=int, default=1)
    g.add_argument("--context_parallel_impl", type=str, default="ring",
                   choices=["ring", "a2a"],
                   help="ring = K/V rotation; a2a = Ulysses sequence/head "
                   "all-to-all (needs num_heads divisible by the CP degree)")
    g.add_argument("--chunks", type=int, default=-1,
                   help="micro-batches accumulated per step; -1 = heuristic (1 at pp=1)")
    g.add_argument("--vocab_tp", type=int, default=1,
                   help="TP degree of the embedding and head (vocab-parallel)")
    g.add_argument("--vocab_sp", type=int, default=0,
                   help="1 = the embedding/head activations sequence-sharded over vocab TP")
    g.add_argument("--embed_sdp", type=int, default=0, help="1 = zero3 embedding and head")
    g.add_argument("--galvatron_config_path", type=str, default=None,
                   help="per-layer strategy JSON (the reference's searched-config schema)")


def _add_search_args(p: argparse.ArgumentParser):
    """(reference: galvatron_search_args, core/arguments.py:226-313)"""
    g = p.add_argument_group("search")
    g.add_argument("--num_devices", type=int, default=8)
    g.add_argument("--memory_constraint_gb", type=float, default=16.0)
    g.add_argument("--min_bsz", type=int, default=8)
    g.add_argument("--max_bsz", type=int, default=64)
    g.add_argument("--bsz_scale", type=int, default=2)
    g.add_argument("--settle_bsz", type=int, default=-1, help="search exactly this bsz")
    g.add_argument("--recommend_min_bsz", type=int, default=0,
                   help="1 = raise the sweep's min bsz to 65%% of the pure-strategy "
                   "baselines' max feasible batch (search-time saving only)")
    g.add_argument("--max_chunks", type=int, default=64)
    g.add_argument("--search_space", type=str, default="full",
                   choices=["full", "dp+tp", "dp+pp", "3d", "dp", "tp", "pp", "sdp"])
    g.add_argument("--disable_sdp", type=int, default=0)
    g.add_argument("--disable_ckpt", type=int, default=0)
    g.add_argument("--disable_sp", type=int, default=0)
    g.add_argument("--disable_tp_consec", type=int, default=0)
    g.add_argument("--enable_cp", type=int, default=0)
    g.add_argument("--enable_ep", type=int, default=0,
                   help="search expert parallelism (MoE models)")
    g.add_argument("--enable_tp_overlap", type=int, default=0,
                   help="enumerate the collective-matmul tp_overlap variant on tp>1 "
                   "layers (ops/collective_matmul.py)")
    g.add_argument("--max_ep_deg", type=int, default=8)
    g.add_argument("--max_tp_deg", type=int, default=8)
    g.add_argument("--max_vpp_deg", type=int, default=1,
                   help="search interleaved virtual-stage degrees up to this "
                   "(powers of two; 1 = plain schedules only)")
    g.add_argument("--analytic_costs", type=int, default=0,
                   help="1 = search on analytic (unprofiled) model costs")
    g.add_argument("--check_cost_model", type=int, default=0,
                   help="print the predicted per-strategy memory/time table instead "
                   "of searching")
    g.add_argument("--time_profile_path", type=str, default=None)
    g.add_argument("--memory_profile_path", type=str, default=None)
    g.add_argument("--hardware_profile_path", type=str, default=None)
    g.add_argument("--output_config_path", type=str, default=None)
    # the execution config the costs describe: the training run's
    g.add_argument("--mixed_precision", type=str, default="bf16",
                   choices=["fp32", "fp16", "bf16"])
    g.add_argument("--attn_impl", type=str, default="auto", choices=["auto", "flash", "xla"],
                   help="auto = flash for --device cuda, the model's own otherwise")
    g.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="where an in-process profile and --validate_top_k run (profile "
                   "paths or --analytic_costs 1 touch no device)")
    g.add_argument("--validate_top_k", type=int, default=0,
                   help="after searching, TRAIN the top-k candidates a few steps each "
                   "and report measured vs predicted iteration time and whether the "
                   "predicted ranking holds (needs --num_devices == this world's size)")
    g.add_argument("--report_homogeneity_gap", type=int, default=0,
                   help="after searching a pp>1 config, run per-stage DPs with "
                   "stage-specific memory and report the predicted cost of the "
                   "cross-stage position sharing")


def _add_profile_args(p: argparse.ArgumentParser):
    """(reference: galvatron_profile_args, core/arguments.py:139-184)"""
    g = p.add_argument_group("profile")
    g.add_argument("--profile_type", type=str, default="both",
                   choices=["computation", "memory", "both"])
    g.add_argument("--profile_batch_size", type=int, default=8)
    g.add_argument("--layernum_min", type=int, default=0,
                   help="0 = adaptive (scales with the model's layer count)")
    g.add_argument("--layernum_max", type=int, default=0)
    g.add_argument("--output_prefix", type=str, default=None)


def _add_hardware_args(p: argparse.ArgumentParser):
    """(reference: galvatron_profile_hardware_args, core/arguments.py:186-223)"""
    g = p.add_argument_group("profile-hardware")
    g.add_argument("--profile_size_mb", type=float, default=64.0)
    g.add_argument("--hardware_output_path", type=str, default="hardware_config.json")
    g.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="cuda:LOCAL_RANK over NCCL, or the CPU over gloo")
    g.add_argument("--dist_backend", type=str, default=None, choices=["nccl", "gloo"])
    g.add_argument("--dist_timeout_s", type=float, default=600.0)


def _add_check_plan_args(p: argparse.ArgumentParser):
    """Static plan validation (analysis/plan_check.py; no device)."""
    g = p.add_argument_group("check-plan")
    g.add_argument("config_paths", nargs="*",
                   help="strategy JSON files to validate (galvatron_config schema)")
    g.add_argument("--galvatron_config_path", type=str, action="append",
                   default=None, help="additional strategy JSON (repeatable)")
    g.add_argument("--num_devices", type=int, default=0,
                   help="world size to validate against; 0 = the JSON's own "
                   "num_devices key (emitted by the search engine)")
    g.add_argument("--global_bsz", type=int, default=0,
                   help="global batch for the divisibility checks; 0 = the "
                   "JSON's own global_bsz key")
    g.add_argument("--memory_constraint_gb", type=float, default=0.0,
                   help="per-device budget for the feasibility check; 0 = "
                   "the JSON's own memory_constraint_gb key (else skipped)")
    g.add_argument("--strict", type=int, default=0,
                   help="1 = warnings (unknown keys, silent replication) "
                   "also fail the check")
    g.add_argument("--no_abstract_pass", type=int, default=0,
                   help="1 = skip the meta-device sharding pass")


def build_parser(mode: str, model_default: Optional[str] = None) -> argparse.ArgumentParser:
    """The parser of ``mode``; ``model_default`` (a per-family entry
    package's) replaces the ``--model_size`` default, also where the mode
    would otherwise default it to the plan's own."""
    p = argparse.ArgumentParser(f"galvatron_tpu_torch {mode}")
    _add_model_args(p)
    if model_default:
        p.set_defaults(model_size=model_default)
    if mode in ("generate", "serve", "export_hf"):
        _add_generate_args(p)
    elif mode == "train":
        _add_train_args(p)
    elif mode == "search":
        _add_search_args(p)
    elif mode == "profile":
        _add_profile_args(p)
        _add_train_args(p)
    elif mode == "profile_hardware":
        _add_hardware_args(p)
    elif mode == "check_plan":
        _add_check_plan_args(p)
        # None, not the preset default, so that the JSON's own model_size
        # key wins when no flag is given (unless a family entry pinned it)
        if not model_default:
            p.set_defaults(model_size=None)
    else:
        raise ValueError(f"mode {mode!r} is not ported yet (ROADMAP.md §1)")
    return p


def initialize_galvatron(mode: str, args: Optional[Sequence[str]] = None,
                         model_default: Optional[str] = None) -> argparse.Namespace:
    return build_parser(mode, model_default).parse_args(args)


def model_config_from_args(ns: argparse.Namespace, base: Optional[ModelConfig] = None
                           ) -> ModelConfig:
    """Preset lookup (or ``base``: check-plan's plan-embedded shape);
    explicitly passed shape flags override it."""
    cfg = base if base is not None else PRESETS[ns.model_size]
    overrides = {}
    for field, attr in [
        ("vocab_size", "vocab_size"), ("hidden_size", "hidden_size"),
        ("num_layers", "num_layers"), ("num_heads", "num_heads"),
        ("num_kv_heads", "num_kv_heads"), ("ffn_dim", "ffn_dim"),
        ("max_seq_len", "seq_length"),
        ("enc_layers", "enc_layers"), ("enc_seq", "enc_seq"),
        ("image_size", "image_size"), ("patch_size", "patch_size"),
        ("num_classes", "num_classes"), ("swin_window", "swin_window"),
        ("moe_experts", "moe_experts"), ("moe_capacity_factor", "moe_capacity_factor"),
    ]:
        v = getattr(ns, attr, None)
        if v is not None:
            overrides[field] = v
    if getattr(ns, "swin_depths", None):
        overrides["swin_depths"] = tuple(int(d) for d in str(ns.swin_depths).split(",") if d)
    if getattr(ns, "set_model_config_manually", 0):
        missing = [f for f in ("vocab_size", "hidden_size", "num_layers", "num_heads")
                   if f not in overrides]
        if missing:
            raise ValueError(f"--set_model_config_manually 1 requires {missing} to be passed")
    return dataclasses.replace(cfg, **overrides)


def resolve_execution_config(cfg: ModelConfig, ns: argparse.Namespace, device) -> ModelConfig:
    """Attention implementation and compute dtype from the flags: the rule
    the trainer, the profiler and the search share, so that the profiled
    (or priced) program is the one training runs. ``device`` is where the
    training runs; nothing is allocated there."""
    cfg = resolve_attn_impl(cfg, ns, device)
    mp = getattr(ns, "mixed_precision", None)
    if mp:
        cfg = cfg.replace(dtype={"bf16": torch.bfloat16, "fp16": torch.float16,
                                 "fp32": torch.float32}[mp])
    return cfg


def resolve_attn_impl(cfg: ModelConfig, ns: argparse.Namespace, device) -> ModelConfig:
    """Apply --attn_impl: 'auto' means the flash kernels on the card and the
    config's own default on the CPU (the reference's rule: flash on an
    accelerator), and the einsum path for packed sequences on either."""
    impl = getattr(ns, "attn_impl", "auto")
    if impl != "auto":
        return cfg.replace(attn_impl=impl)
    if cfg.pack_sequences:
        # packed sequences need the segment-masked einsum path; 'auto' must
        # not pick the flash kernels (build_runtime would refuse them loudly)
        return cfg.replace(attn_impl="xla")
    if torch.device(device).type == "cuda":
        return cfg.replace(attn_impl="flash")
    return cfg


def adam_config_from_args(ns: argparse.Namespace) -> AdamConfig:
    """Optimizer config from the step-program flags; an LR schedule only
    when warmup or decay is asked for."""
    lr_schedule = None
    if getattr(ns, "lr_warmup_iters", 0) or getattr(ns, "lr_decay_iters", 0):
        lr_schedule = LRSchedule(
            lr=ns.lr, min_lr=ns.min_lr, warmup_iters=ns.lr_warmup_iters,
            decay_iters=ns.lr_decay_iters, decay_style=ns.lr_decay_style,
        )
    return AdamConfig(lr=ns.lr, weight_decay=ns.weight_decay, grad_clip=ns.grad_clip,
                      lr_schedule=lr_schedule)


def hybrid_config_from_args(ns: argparse.Namespace, num_layers: int,
                            world: int) -> HybridParallelConfig:
    """GLOBAL flags → a uniform strategy, or the JSON file → per-layer
    strategies (the reference's two config modes)."""
    if ns.galvatron_config_path:
        hp = HybridParallelConfig.load(ns.galvatron_config_path)
        if hp.num_layers != num_layers:
            raise ValueError(f"config has {hp.num_layers} layers, model has {num_layers}")
        return hp
    chunks = ns.chunks if ns.chunks > 0 else default_chunks(
        ns.global_train_batch_size, ns.pp_deg, world)
    hp = HybridParallelConfig.uniform(
        num_layers,
        pp=ns.pp_deg,
        vpp=ns.vpp_deg,
        tp=ns.global_tp_deg,
        tp_consec=bool(ns.global_tp_consec),
        dp_type="zero3" if ns.sdp else ns.default_dp_type,
        ckpt=ns.global_checkpoint,
        sp=bool(ns.sequence_parallel),
        cp=ns.context_parallel_deg,
        cp_impl=ns.context_parallel_impl,
        tp_overlap=bool(getattr(ns, "global_tp_overlap", 0)),
        grad_overlap=bool(getattr(ns, "grad_overlap", 0)),
        chunks=chunks,
        pipeline_type=ns.pipeline_type,
        vocab_tp=ns.vocab_tp,
        vocab_sp=bool(ns.vocab_sp),
        embed_dp_type="zero3" if ns.embed_sdp else "ddp",
        mixed_precision=ns.mixed_precision,
        mlp_recompute=getattr(ns, "mlp_recompute", "policy"),
    )
    if ns.pp_division:
        hp.pp_division = ns.pp_division
    return hp


def _int_list(text: str):
    """argparse type for comma-separated ints (trailing commas tolerated)."""
    try:
        return [int(x) for x in text.split(",") if x.strip()]
    except ValueError:
        raise argparse.ArgumentTypeError(f"expected comma-separated ints, got {text!r}")


def default_chunks(global_bsz: int, pp: int, world: int) -> int:
    """Micro-batch count heuristic (the reference's ``get_chunks``): 1 at
    pp=1; enough to keep a pipeline filled otherwise."""
    if pp == 1:
        return 1
    if pp > world or world % pp != 0:
        raise ValueError(f"pp={pp} must divide the device count {world}")
    local = max(1, global_bsz // (world // pp))
    return min(local, 2 * pp)
