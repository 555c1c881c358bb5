"""CLI of the port: python -m galvatron_tpu_torch.cli <mode> [flags]

  train             train a LLaMA- or GPT/OPT-family decoder under a
                    per-layer hybrid-parallel plan (--galvatron_config_path,
                    or the GLOBAL flags) on one or more ranks: synthetic
                    tokens from --seed or a corpus (--data_path,
                    --data_mixture), fp32 master weights, AdamW (bf16, fp32,
                    or fp16 under a dynamic loss scale), the flash kernels on
                    the card (--attn_impl auto), committed checkpoints
                    (--save, --load); a line and a train_iter JSONL record
                    (--metrics_path) per iteration
  generate          greedy or sampled completions of --prompt (repeatable)
                    through the KV-cache generation loop; one JSON line
                    {"prompt", "completion"} per prompt
  serve             REST generation server over the continuous-batching
                    engine on the contiguous slot KV cache (the default,
                    --kv_num_blocks 0) or the paged one (--kv_num_blocks
                    -1), or the serialized single-shot path (--num_slots
                    0); LLaMA and GPT/OPT families
  profile           per-layer time and activation memory of the model
                    (layer-difference method on the real train step) → the
                    reference-schema computation / memory JSONs
  profile-hardware  all-reduce and p2p bandwidth and the overlap coefficient
                    of this world (NCCL on the card, gloo on the CPU) → JSON
  search            the parallelism plan search (profiled, or analytic with
                    --analytic_costs 1) → a galvatron_config JSON that
                    `train --galvatron_config_path` runs
  check-plan        static plan validation (GTA… diagnostics, no device)
  export-hf         trainer checkpoint (--load) or seed weights → a
                    HuggingFace-format directory (--output_dir: config.json
                    and safetensors, sharded above 5 GB) that transformers'
                    from_pretrained loads: LlamaForCausalLM, or
                    GPT2LMHeadModel for the GPT-2-shaped configs

generate and serve take weights from a trainer checkpoint (--load: the newest
committed step, verified, an older one when it is corrupt), from a local
HuggingFace checkpoint (--load_hf: LLaMA, Baichuan-1, GPT-2 or OPT; the model
shape comes from its config.json), or initialise them from seed 0; train
takes --load_hf too. train, generate, serve, export-hf, profile and
profile-hardware run on the card (--device cuda, the default) or, when asked,
on the CPU (--device cpu). search with profile paths or --analytic_costs 1
and check-plan touch no device. The per-family entry packages
(python -m galvatron_tpu_torch.models.<family>) run these modes with their
family's default --model_size. The reference's other modes (warmup,
run-elastic, audit-comm, ...) are not ported yet (ROADMAP.md §1).
"""

from __future__ import annotations

import json
import sys
import threading
from typing import List, Optional


_MODES = ("train", "generate", "serve", "profile", "profile-hardware", "search", "check-plan",
          "export-hf")


def main(argv: Optional[List[str]] = None, model_default: Optional[str] = None) -> int:
    """Run one mode; ``model_default`` (a per-family entry package's)
    replaces the ``--model_size`` default."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    mode, rest = argv[0], argv[1:]
    if mode not in _MODES:
        print(f"mode {mode!r} is not ported yet; expected one of: {', '.join(_MODES)}",
              file=sys.stderr)
        return 2

    from galvatron_tpu_torch.core.arguments import initialize_galvatron, model_config_from_args

    if mode == "train":
        from galvatron_tpu_torch.core.trainer import train

        train(initialize_galvatron(mode, rest, model_default))
        return 0
    if mode == "search":
        return _search_mode(initialize_galvatron("search", rest, model_default))
    if mode == "profile":
        return _profile_mode(initialize_galvatron("profile", rest, model_default))
    if mode == "profile-hardware":
        return _profile_hardware_mode(initialize_galvatron("profile_hardware", rest,
                                                           model_default))
    if mode == "check-plan":
        return _check_plan_mode(initialize_galvatron("check_plan", rest, model_default))
    if mode == "export-hf":
        return _export_hf_mode(initialize_galvatron("export_hf", rest, model_default))
    from galvatron_tpu_torch.device import resolve_device
    from galvatron_tpu_torch.models import generation, modeling
    from galvatron_tpu_torch.models.tokenizer import build_tokenizer

    ns = initialize_galvatron(mode, rest, model_default)
    device = resolve_device(ns.device)
    tok = build_tokenizer(ns.tokenizer)
    if ns.load_hf:
        if ns.load:
            raise ValueError(
                "--load and --load_hf are mutually exclusive here: pick "
                "the fine-tuned trainer checkpoint (--load) or the raw "
                "pretrained HF weights (--load_hf)"
            )
        from galvatron_tpu_torch.models.convert import load_hf_checkpoint

        params, cfg = load_hf_checkpoint(ns.load_hf)
        modeling.check_supported(cfg)
        generation.check_generative(cfg, "generation" if mode == "generate" else "serving")
        if tok.vocab_size > cfg.vocab_size:
            raise ValueError(
                f"tokenizer vocab {tok.vocab_size} exceeds the pretrained "
                f"embedding {cfg.vocab_size} — ids past the table would "
                "silently clamp; use the checkpoint's own tokenizer"
            )
        print(f"serving HF checkpoint {ns.load_hf}", flush=True)
        params = modeling.cast_params(_to_device(params, device), cfg)
    else:
        cfg = model_config_from_args(ns)
        modeling.check_supported(cfg)  # before any weight is allocated
        generation.check_generative(cfg, "generation" if mode == "generate" else "serving")
        if tok.vocab_size > cfg.vocab_size:
            cfg = cfg.replace(vocab_size=tok.vocab_size)
        params = modeling.cast_params(_load_or_init_params(ns, cfg, device), cfg)
    if ns.attn_impl != "auto":
        cfg = cfg.replace(attn_impl=ns.attn_impl)
    if mode == "generate":
        return _generate_mode(ns, cfg, tok, params)
    return _serve_mode(ns, cfg, tok, params, device)


def _generate_mode(ns, cfg, tok, params) -> int:
    from galvatron_tpu_torch.models import generation

    prompts = ns.prompt or ["Hello"]
    encoded = [tok.encode(p) for p in prompts]
    outs = generation.generate_np(
        params, cfg, encoded, seed=ns.seed,
        max_new_tokens=ns.max_new_tokens, temperature=ns.temperature,
        top_k=ns.top_k, top_p=ns.top_p, eos_id=tok.eos_id, pad_id=tok.pad_id,
    )
    for p, e, o in zip(prompts, encoded, outs):
        print(json.dumps({"prompt": p, "completion": tok.decode(o[len(e):])}), flush=True)
    return 0


def _serve_mode(ns, cfg, tok, params, device) -> int:
    from galvatron_tpu_torch.server import GenerationService, run_server
    from galvatron_tpu_torch.serving.engine import Engine

    if ns.num_slots <= 0:
        # the serialized single-shot path: generate_np under one lock
        service = GenerationService(cfg, tok, None, ns.max_new_tokens, device=device,
                                    params=params, seed=ns.seed)
        run_server(service, port=ns.port, host=ns.host, max_pending=ns.max_pending,
                   drain_timeout_s=ns.drain_timeout_s)
        return 0
    engine = Engine(
        params, cfg, device=device,
        num_slots=ns.num_slots,
        prefill_chunk=ns.prefill_chunk,
        max_queue=ns.max_queue,
        request_ttl_s=ns.request_ttl_s if ns.request_ttl_s > 0 else None,
        eos_id=tok.eos_id,
        pad_id=tok.pad_id,
        seed=ns.seed,
        deadline_policy=ns.deadline_policy,
        max_engine_restarts=ns.max_engine_restarts,
        drain_timeout_s=ns.drain_timeout_s,
        kv_block_size=ns.kv_block_size,
        kv_num_blocks=ns.kv_num_blocks,
        prefix_cache=ns.prefix_cache == "on",
    )
    service = GenerationService(cfg, tok, engine, ns.max_new_tokens)
    # the server listens first (/readyz answers 503 "starting"), then one
    # real generation goes through the engine before /readyz turns 200
    service.starting = True
    listening = threading.Event()
    threading.Thread(target=_serve_warmup, args=(engine, service, listening),
                     name="serve-warmup", daemon=True).start()
    run_server(service, port=ns.port, host=ns.host, ready_event=listening,
               drain_timeout_s=ns.drain_timeout_s)
    return 0


def _export_hf_mode(ns) -> int:
    """``export-hf`` (the reference's, ``galvatron_tpu/cli.py``): the model
    of the flags, from ``--load`` or seed 0, as a HuggingFace directory. It
    writes ``config.json`` and safetensors itself (``models/hf_io.py``);
    the reference's ``.npz`` fallback for a machine without
    ``transformers`` has no counterpart, since nothing here needs it."""
    import time

    from galvatron_tpu_torch.core.arguments import model_config_from_args
    from galvatron_tpu_torch.device import resolve_device
    from galvatron_tpu_torch.models import convert, hf_io

    if not ns.output_dir:
        print("error: export-hf needs --output_dir")
        return 2
    cfg = model_config_from_args(ns)
    if cfg.act_fn == "relu":
        print(
            "error: export-hf does not support the OPT family — the +2 "
            "position offset dropped at import cannot be reconstructed "
            "for HF's padded-position rows"
        )
        return 2
    if not cfg.causal or cfg.objective != "clm" or cfg.image_size:
        print(
            "error: export-hf exports causal LM decoders only "
            "(encoder/vision families have no HF causal-LM counterpart)"
        )
        return 2
    # architecture by config shape: GPT-2-style (learned positions + biases
    # + gelu) exports as GPT2LMHeadModel, else LlamaForCausalLM
    gpt2_style = cfg.pos_embed == "learned" and cfg.use_bias and cfg.act_fn == "gelu"
    if not gpt2_style:
        convert.check_hf_llama_positions(cfg)
    params = _load_or_init_params(ns, cfg, resolve_device(ns.device))  # checked vs the config
    t0 = time.perf_counter()
    sd = convert.export_state_dict(params, cfg, gpt2_style)
    del params
    files = hf_io.write_hf_dir(ns.output_dir, convert.hf_export_config(cfg, gpt2_style), sd)
    nbytes = sum(a.nbytes for a in sd.values())
    secs = time.perf_counter() - t0
    print(f"exported HF checkpoint → {ns.output_dir} ({', '.join(files)}; "
          f"{nbytes / 1e9:.3f} GB in {secs:.3f} s)", flush=True)
    return 0


def _load_or_init_params(ns, cfg, device):
    """Params from a trainer checkpoint (``--load``; verified, newest
    committed step first) checked against the model config, or random
    weights from seed 0 as the reference's cli draws without ``--load``."""
    from galvatron_tpu_torch.models import modeling

    if not getattr(ns, "load", None):
        return modeling.init_model_params(cfg, 0, device)
    from galvatron_tpu_torch.core.checkpoint import flatten, keystr, restore_raw_checkpoint
    from galvatron_tpu_torch.parallel.hybrid import param_shapes

    raw, step = restore_raw_checkpoint(ns.load, prefix=keystr(("params",)))
    params = raw["params"]
    got = {k: tuple(v.shape) for k, v in flatten(params).items()}
    want = flatten(param_shapes(cfg))
    if got != want:
        diff = {k: (got.get(k), want.get(k)) for k in sorted(set(got) | set(want))
                if got.get(k) != want.get(k)}
        raise ValueError(f"checkpoint under {ns.load} does not match the model config (e.g. "
                         f"--vocab_size/--tokenizer mismatch); got vs want: {diff}")
    print(f"serving step {step} of {ns.load}", flush=True)
    return _to_device(params, device)


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
    return tree.to(device)


def _serve_warmup(engine, service, listening) -> None:
    """One real generation through the scheduler, then ``/readyz`` → 200."""
    listening.wait(timeout=60.0)
    try:
        engine.generate([[1]], max_new_tokens=2)
    except Exception as e:  # noqa: BLE001 — the warm-up is optional, serving is not
        print(f"serving warm-up failed (the first request pays it): "
              f"{type(e).__name__}: {str(e)[:200]}", flush=True)
    finally:
        service.starting = False
        print("serving ready: /readyz now 200", flush=True)


def _search_mode(ns) -> int:
    from galvatron_tpu_torch.core.arguments import model_config_from_args, resolve_execution_config
    from galvatron_tpu_torch.search import native
    from galvatron_tpu_torch.search.cost_model import ProfiledHardware
    from galvatron_tpu_torch.search.search_engine import (
        SearchEngine,
        SearchSpace,
        apply_search_space,
    )
    from galvatron_tpu_torch.utils.config_utils import load_profiled_hardware, load_profiled_model

    # the costs describe the program the training run will execute (kernel
    # and dtype); the device named by --device is only where it would run
    cfg = resolve_execution_config(model_config_from_args(ns), ns, ns.device)
    if bool(ns.time_profile_path) != bool(ns.memory_profile_path):
        print("error: --time_profile_path and --memory_profile_path must be "
              "given together (got only one; refusing to silently re-profile)")
        return 2
    if ns.time_profile_path and ns.memory_profile_path:
        costs = load_profiled_model(ns.time_profile_path, ns.memory_profile_path)
    elif ns.analytic_costs or ns.check_cost_model:
        from galvatron_tpu_torch.search.theoretical import analytic_model_costs

        print("using analytic (unprofiled) model costs")
        costs = analytic_model_costs(cfg)
    else:
        from galvatron_tpu_torch.profiling.model import profile_model

        print(f"no profiled model data given; profiling in-process on {ns.device}")
        costs = profile_model(cfg, bsz=ns.min_bsz, device=ns.device)
    hw = (load_profiled_hardware(ns.hardware_profile_path) if ns.hardware_profile_path
          else ProfiledHardware())
    sspace = SearchSpace(
        world_size=ns.num_devices,
        max_tp=ns.max_tp_deg,
        allow_sp=not ns.disable_sp,
        allow_ckpt=not ns.disable_ckpt,
        allow_zero2=not ns.disable_sdp,
        allow_zero3=not ns.disable_sdp,
        allow_strided=not ns.disable_tp_consec,
        allow_cp=bool(ns.enable_cp),
        allow_ep=bool(ns.enable_ep),
        allow_tp_overlap=bool(ns.enable_tp_overlap),
        max_ep=ns.max_ep_deg,
        moe_experts=cfg.moe_experts,
        max_vpp=ns.max_vpp_deg,
    )
    apply_search_space(sspace, ns.search_space)
    eng = SearchEngine(
        costs, hw, num_layers=cfg.total_layers, space=sspace,
        memory_budget_mb=ns.memory_constraint_gb * 1024.0,
        mixed_precision=ns.mixed_precision,
        section_pipeline=bool(cfg.swin_depths),
        model_config=cfg, model_name=ns.model_size,
    )
    if ns.check_cost_model:
        from galvatron_tpu_torch.core.strategy import LayerStrategy
        from galvatron_tpu_torch.search.theoretical import report as theo_report

        bsz = ns.settle_bsz if ns.settle_bsz > 0 else ns.min_bsz
        print(eng.check_cost_model(bsz, chunks=1, pp=1))
        print(theo_report(cfg, LayerStrategy(), ns.num_devices).lines())
        return 0
    if ns.settle_bsz > 0:
        bszs = [ns.settle_bsz]
    else:
        if ns.bsz_scale < 2:
            print(f"error: --bsz_scale must be >= 2, got {ns.bsz_scale}")
            return 2
        rec = 0
        if ns.recommend_min_bsz:
            # prune the grid below the recommendation (shifting its anchor
            # would skip points above it too)
            rec = min(eng.recommend_min_bsz(), ns.max_bsz)
            if rec > ns.min_bsz:
                print(f"recommend_min_bsz: pruning sweep below {rec}")
        bszs, b = [], ns.min_bsz
        while b <= ns.max_bsz:
            if b >= rec:
                bszs.append(b)
            b *= ns.bsz_scale
        if not bszs:
            bszs = [ns.max_bsz]  # rec sat between the last grid point and the cap
    if ns.validate_top_k > 0:
        cands = eng.search_topk(bszs, k=ns.validate_top_k, max_chunks=ns.max_chunks,
                                verbose=True)
        res = cands[0] if cands else None
    else:
        cands = None
        res = eng.search(bszs, max_chunks=ns.max_chunks, verbose=True)
    print(f"dp route: {native.ROUTE}"
          + (f" ({native.BUILD_ERROR})" if native.BUILD_ERROR else ""))
    if res is None:
        print("no feasible strategy under the memory budget")
        return 1
    if cands:
        print(f"Max throughput = {res.throughput_samples_per_s:.2f} samples/s "
              f"(bsz {res.global_bsz})")
        _validate_search(cands, cfg, ns)
    if ns.report_homogeneity_gap and res.config.pp > 1 and res.config.vpp == 1:
        g = eng.homogeneity_gap(res.config.pp, res.global_bsz, res.config.chunks,
                                res.config.pipeline_type)
        if g is None:
            print("homogeneity gap: n/a (not defined for this shape/schedule, or the "
                  "per-stage DP is infeasible)")
        else:
            print(f"homogeneity gap: restricted {g['restricted_ms']:.1f} ms vs "
                  f"unrestricted per-stage {g['unrestricted_ms']:.1f} ms "
                  f"(delta {g['delta_pct']:+.3f}%)")
            res.details["homogeneity_gap_pct"] = g["delta_pct"]
    elif ns.report_homogeneity_gap and res.config.vpp > 1:
        print("homogeneity gap: n/a for interleaved (vpp>1) schedules")
    out = ns.output_config_path or f"galvatron_config_{ns.model_size}_{ns.num_devices}dev.json"
    eng.save_result(res, out)
    print(f"saved searched strategy → {out}")
    return 0


def _validate_search(cands, cfg, ns) -> None:
    """Train the top-k searched candidates a few steps each through the
    runtime's own train step and report predicted against measured
    iteration time, and whether the predicted ranking (by throughput, the
    criterion the search maximizes) holds. Failures surface."""
    import gc

    import torch
    import torch.distributed as dist

    from galvatron_tpu_torch.profiling.model import measure_strategy_ms

    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != ns.num_devices:
        print(f"--validate_top_k skipped: search was for {ns.num_devices} devices "
              f"but this world has {world}")
        return
    rows = []
    for r in cands:
        ms = measure_strategy_ms(cfg, r.config, r.global_bsz, device=ns.device)
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        rows.append((r, r.global_bsz / (ms / 1000.0)))
        print(f"  pp={r.config.pp} chunks={r.config.chunks} {r.config.pipeline_type} "
              f"vpp={r.config.vpp} bsz={r.global_bsz}: predicted {r.cost_ms:.1f} ms, "
              f"measured {ms:.1f} ms (fidelity {r.cost_ms / ms:.3f})")
    if len(rows) >= 2:
        pred_order = [id(r) for r, _ in sorted(rows, key=lambda x: -x[0].throughput_samples_per_s)]
        meas_order = [id(r) for r, _ in sorted(rows, key=lambda x: -x[1])]
        agree = sum(a == b for a, b in zip(pred_order, meas_order))
        best = "confirmed" if pred_order[0] == meas_order[0] else "NOT fastest measured"
        print(f"predicted-vs-measured rank agreement: {agree}/{len(rows)} positions "
              f"(best candidate {best})")


def _profile_mode(ns) -> int:
    from galvatron_tpu_torch.core.arguments import model_config_from_args, resolve_execution_config
    from galvatron_tpu_torch.device import resolve_device
    from galvatron_tpu_torch.profiling.model import profile_model
    from galvatron_tpu_torch.utils.config_utils import save_profiled_model

    device = resolve_device(ns.device)  # raises without a card unless --device cpu
    # the attention kernel and dtype the training run will use
    cfg = resolve_execution_config(model_config_from_args(ns), ns, device)
    if bool(ns.layernum_min) != bool(ns.layernum_max):
        print("error: --layernum_min and --layernum_max must be given together "
              "(0,0 = adaptive basis)")
        return 2
    costs = profile_model(
        cfg, bsz=ns.profile_batch_size,
        layernums=(ns.layernum_min, ns.layernum_max) if ns.layernum_max else None,
        measure_time=ns.profile_type in ("computation", "both"), device=device,
    )
    lt = costs.layer_types[0]
    print(f"fwd_ms_per_sample {lt.fwd_ms_per_sample:.6g} | activation_mb_per_sample[1] "
          f"{lt.activation_mb_per_sample[1]:.6g} | other_fwd_ms_per_sample "
          f"{costs.other_fwd_ms_per_sample:.6g} | vocab fit slope "
          f"{costs.measured_vocab_slope_ms} const {costs.measured_vocab_const_ms} "
          f"({costs.measured_vocab_mp or 'none'})")
    prefix = ns.output_prefix or f"profile_{ns.model_size}"
    comp = f"{prefix}_computation.json" if ns.profile_type in ("computation", "both") else None
    mem = f"{prefix}_memory.json" if ns.profile_type in ("memory", "both") else None
    save_profiled_model(costs, comp, mem)
    print(f"saved → {', '.join(p for p in (comp, mem) if p)}")
    return 0


def _profile_hardware_mode(ns) -> int:
    import torch.distributed as dist

    from galvatron_tpu_torch.core.trainer import init_distributed
    from galvatron_tpu_torch.device import rank_device
    from galvatron_tpu_torch.profiling.hardware import profile_hardware

    device = rank_device(ns.device)  # raises without a card unless --device cpu
    created = init_distributed(device, ns.dist_backend, ns.dist_timeout_s)
    try:
        hw = profile_hardware(msg_mb=ns.profile_size_mb, out_path=ns.hardware_output_path,
                              device=device)
        if not dist.is_initialized() or dist.get_rank() == 0:
            print(f"allreduce: {hw.allreduce_bw}")
            print(f"p2p: {hw.p2p_bw}")
            print(f"overlap_coe: {hw.overlap_coe}")
            print(f"saved → {ns.hardware_output_path}")
    finally:
        if created and dist.is_initialized():
            dist.destroy_process_group()
    return 0


def _check_plan_mode(ns) -> int:
    """Validate strategy JSONs statically; exit 1 on any error diagnostic
    (warnings too under --strict). Model, world, batch and budget default
    to the JSON's own provenance keys (search-emitted plans describe
    themselves)."""
    from galvatron_tpu_torch.analysis import plan_check
    from galvatron_tpu_torch.analysis.diagnostics import errors, format_report, warnings
    from galvatron_tpu_torch.core.arguments import model_config_from_args
    from galvatron_tpu_torch.models.modeling import PRESETS, ModelConfig

    paths = list(ns.config_paths or []) + list(ns.galvatron_config_path or [])
    if not paths:
        print("error: check-plan needs at least one strategy JSON path")
        return 2
    rc = 0
    cli_model_size = ns.model_size  # a file's JSON defaults must not leak to the next
    for path in paths:
        try:
            with open(path) as f:
                d = json.load(f)
            if not isinstance(d, dict):
                d = {}
        except (OSError, ValueError):
            d = {}  # check_plan reports the parse failure as GTA002
        model_size = cli_model_size or d.get("model_size")
        shape = d.get("model_config")
        shape = shape if isinstance(shape, dict) else None
        cfg = base = None
        if model_size:
            base = PRESETS.get(model_size)
            if base is None and cli_model_size:
                print(f"error: unknown --model_size {cli_model_size!r}")
                return 2
            if base is None and shape is None:
                print(f"{path}: unknown model_size {model_size!r} and no embedded "
                      "model_config; running structural checks only")
        if cli_model_size:
            # an explicit --model_size asks whether the plan fits THAT model
            if shape is not None:
                print(f"{path}: validating against --model_size {cli_model_size} "
                      "(plan's embedded model_config shape ignored)")
        elif shape is not None:
            base = plan_check.apply_model_shape(base if base is not None else ModelConfig(),
                                                shape)
        if base is not None:
            cfg = model_config_from_args(ns, base=base)

        def _num(v):
            try:
                return float(v)
            except (TypeError, ValueError):
                return 0.0

        world = int(ns.num_devices or _num(d.get("num_devices")))
        budget_gb = ns.memory_constraint_gb or _num(d.get("memory_constraint_gb"))
        diags = plan_check.check_plan(
            d if d else path,
            source=path,
            model_config=cfg,
            world_size=world or None,
            global_bsz=ns.global_bsz or None,
            memory_budget_mb=budget_gb * 1024.0 or None,
            abstract_pass=not ns.no_abstract_pass,
        )
        scope = []
        if cfg is None:
            scope.append("no model config: structural checks only")
        if not world:
            scope.append("no num_devices: topology checks skipped")
        tag = f"  ({'; '.join(scope)})" if scope else ""
        print(f"== {path}{tag}")
        print(format_report(diags))
        if errors(diags) or (ns.strict and warnings(diags)):
            rc = 1
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
