"""Training loop of ``cli train`` (the port's counterpart of
``galvatron_tpu/core/trainer.py``).

One process per rank under the torchrun environment contract (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``): with
``WORLD_SIZE`` > 1 the default process group is initialised first
(:func:`init_distributed`; nccl on the card, gloo on the CPU, or
``--dist_backend``) and destroyed at the end, also on an error, so a failed
rank closes its connections instead of leaving the others waiting. Each
rank runs on ``cuda:LOCAL_RANK`` (or the CPU when asked), draws the same
global batch from the synthetic stream and keeps its rows; the plan comes
from ``--galvatron_config_path`` or the GLOBAL flags.

Before any model is built the plan is checked (``analysis/plan_check.
ensure_valid``, the reference's two call sites: the strategy file, or the
GLOBAL flags' plan). Per iteration: the next batch, one ``train_step``, the
loss read back (one host synchronisation, then ``torch.cuda.synchronize()``
on the card) and the host-clock ``iter_ms`` around all of it. Rank 0 alone
prints the loss (under a pipeline the last stage's, which reaches every
rank) and, with ``--metrics_path``, writes a ``train_iter`` JSONL record
(step, loss, batch_size, iter_ms and the per-device rates: tokens_per_s,
tflops_per_device, mfu, hfu; None on the CPU; ``loss_scale`` under fp16;
with ``--pack_sequences`` the rates count non-pad tokens and the record adds
``tokens_per_s_raw`` and ``packing_efficiency``).

The training services, as the reference wires them: batches from the
synthetic stream, an indexed corpus (``--data_path``) or the data pipeline
(``--data_mixture`` / ``--prefetch_depth`` / ``--pack_sequences``, ``data/``); committed portable
checkpoints (``core/checkpoint.py``) every ``--save_interval`` batches and
at the end of a run that completes (``--save``, ``--keep_last_n``); resume
(``--load``: the newest committed step, an older one when it is corrupt
with a ``ckpt_fallback`` event, the data cursor verified, GTA017's
topology check; a changed world size is a ``topology_resume`` event and
the checkpoint is cut for the new plan); ``--rampup_batch_size``; and fp16
under a dynamic loss scale (``parallel/hybrid.py``). The reference's
emergency saves (on an exception, a signal, the watchdog, the peer store),
its elastic, AOT and tracing machinery are not ported yet (ROADMAP.md §1).
"""

from __future__ import annotations

import argparse
import datetime
import math
import os
import time
from typing import Optional

import numpy as np
import torch

from galvatron_tpu_torch.core.arguments import (
    adam_config_from_args,
    hybrid_config_from_args,
    model_config_from_args,
    resolve_attn_impl,
)
from galvatron_tpu_torch.core import checkpoint as ckpt
from galvatron_tpu_torch.core.dataloader import build_dataloader
from galvatron_tpu_torch.core.schedules import BatchSizeRampup
from galvatron_tpu_torch.core.strategy import form_strategy, plan_hash
from galvatron_tpu_torch.device import rank_device
from galvatron_tpu_torch.obs.stepstats import StepStats
from galvatron_tpu_torch.models.modeling import ModelConfig, layer_seq, swin_geometry
from galvatron_tpu_torch.ops import flash_attention, fused_norm
from galvatron_tpu_torch.parallel import comm
from galvatron_tpu_torch.parallel.hybrid import build_runtime
from galvatron_tpu_torch.utils.metrics import SCHEMA_VERSION, MetricsLogger


def init_distributed(device: torch.device, backend: Optional[str] = None,
                     timeout_s: float = 600.0) -> bool:
    """Initialise the default process group from the torchrun environment
    when ``WORLD_SIZE`` > 1 (init method ``env://``); returns whether this
    call created it. At world size 1 nothing is created. ``timeout_s``
    bounds the rendezvous and every collective: an unreachable master or a
    peer that stops answering raises after it."""
    import torch.distributed as dist

    world = int(os.environ.get("WORLD_SIZE", "1") or 1)
    if world <= 1 or dist.is_initialized():
        return False
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    dist.init_process_group(backend=backend, init_method="env://",
                            rank=int(os.environ["RANK"]), world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return True


def _pipeline_desc(hp) -> str:
    if hp.pp == 1:
        return ""
    vpp = f" vpp={hp.vpp}" if hp.vpp > 1 else ""
    div = ",".join(map(str, hp.pp_division))
    return f"pp={hp.pp} pp_division={div}{vpp} pipeline={hp.pipeline_type} "


def train(ns: argparse.Namespace, cfg: Optional[ModelConfig] = None) -> dict:
    """Train up to ``ns.train_iters`` batches (counted from the start of the
    stream, so a resumed run trains the rest); returns the losses, the mean
    iter_ms, this rank's final state, its pipeline stage and layers, the
    last step's runtime stats (``Runtime.stats``), its host-staged and
    point-to-point message counts, every training kernel's
    launch count as it stands at the end of the run, the samples consumed,
    the batch sizes, the fp16 steps skipped on overflow, the final loss
    scale (None without fp16), the step it started from and the seconds of
    its checkpoint restore and saves. ``cfg`` replaces the model
    the flags describe (the way to fields that have no flag, ``fused_norm``
    among them); attention implementation and ``--mlp_recompute`` still
    come from ``ns`` (or the plan)."""
    import torch.distributed as dist

    device = rank_device(ns.device)
    created = init_distributed(device, getattr(ns, "dist_backend", None),
                               getattr(ns, "dist_timeout_s", 600.0))
    try:
        return _train(ns, cfg, device)
    finally:
        if created and dist.is_initialized():
            dist.destroy_process_group()


def _check_plan(ns: argparse.Namespace, cfg: ModelConfig, world: int, verbose: bool):
    """The plan check before any model is built (the reference's
    ``_train_impl`` call sites): the strategy file as written, or the plan
    the GLOBAL flags make."""
    from galvatron_tpu_torch.analysis import plan_check

    if ns.galvatron_config_path:
        plan_check.ensure_valid(
            ns.galvatron_config_path, model_config=cfg, world_size=world,
            global_bsz=ns.global_train_batch_size,
            context=f"refusing to start: {ns.galvatron_config_path}", verbose=verbose)
    hp = hybrid_config_from_args(ns, cfg.total_layers, world)
    if not ns.galvatron_config_path:
        plan_check.ensure_valid(
            hp, model_config=cfg, world_size=world, global_bsz=ns.global_train_batch_size,
            context="refusing to start: invalid hybrid-parallel flags", verbose=verbose)
    return hp


def _rampup(ns: argparse.Namespace, hp, world: int):
    """The ``--rampup_batch_size`` schedule, checked against the plan."""
    if not getattr(ns, "rampup_batch_size", None):
        return None
    if hp.pp > 1:
        raise ValueError("--rampup_batch_size requires pp=1 (static pipeline shapes)")
    start, inc, samples = ns.rampup_batch_size
    rampup = BatchSizeRampup(start=start, increment=inc, rampup_samples=samples,
                             target=ns.global_train_batch_size)
    for bs in rampup.sizes():
        if bs % world:
            raise ValueError(f"rampup batch size {bs} must be divisible by the device "
                             f"count {world} (global batches shard over all data axes)")
        if bs % max(1, hp.chunks):
            raise ValueError(f"rampup batch size {bs} must be divisible by chunks "
                             f"{hp.chunks} (micro-batch gradient accumulation)")
    return rampup


def _resume(ns, rt, world, fingerprint, metrics, lead):
    """(state, start_step, batch_offset, meta) restored from ``--load``, or
    None when there is nothing to resume."""
    from galvatron_tpu_torch.analysis.plan_check import PlanError, check_topology_fingerprint

    if not ns.load or not ckpt.committed_steps(ns.load):
        if ns.load and ckpt.uncommitted_steps(ns.load):
            raise FileNotFoundError(
                f"--load {ns.load}: steps {ckpt.uncommitted_steps(ns.load)} exist but none "
                "carries a manifest (partial writes). Refusing to silently start from step 0 "
                "— restore one explicitly (checkpoint.restore_checkpoint_portable(..., step=N)) "
                "and re-save to commit it, or point --load elsewhere.")
        return None
    t0 = time.perf_counter()
    state = ckpt.restore_checkpoint_portable(ns.load, rt, metrics=metrics)
    restore_s = time.perf_counter() - t0
    start_step = int(state["step"])
    m = ckpt.read_manifest(ckpt.step_path(ns.load, start_step))
    meta = m.get("meta") if m and isinstance(m.get("meta"), dict) else {}
    batch_offset = int(meta.get("batches_consumed", start_step))
    saved_fp = meta.get("fingerprint")
    if isinstance(saved_fp, dict):
        diags = check_topology_fingerprint(saved_fp, world, source=ns.load)
        other = [d for d in diags if d.field != "fingerprint.world_size"]
        if other:
            raise PlanError(other, context=f"refusing to resume {ns.load}")
        if diags:
            metrics.log("topology_resume", step=start_step, old_world=saved_fp.get("world_size"),
                        new_world=world, old_plan=saved_fp.get("plan_hash"),
                        new_plan=fingerprint["plan_hash"])
            if lead:
                print(f"topology-change resume: {saved_fp.get('world_size')} → {world} devices "
                      "(checkpoint resharded portably)", flush=True)
        elif saved_fp.get("plan_hash") not in (None, fingerprint["plan_hash"]):
            metrics.log("plan_change", step=start_step, old_plan=saved_fp.get("plan_hash"),
                        new_plan=fingerprint["plan_hash"])
    # sample-domain resume: the batch cursor converts through samples when the
    # global batch size changed since the save
    rec_bsz = meta.get("global_bsz") or (saved_fp or {}).get("global_bsz")
    samples_rec = meta.get("samples_consumed")
    bsz = ns.global_train_batch_size
    if samples_rec is not None and rec_bsz and int(rec_bsz) != bsz:
        if getattr(ns, "rampup_batch_size", None):
            raise ValueError(
                "cannot combine --rampup_batch_size with a changed --global_train_batch_size on "
                f"resume (checkpoint records bsz {rec_bsz}): the rampup schedule replays in the "
                "batch domain")
        if int(samples_rec) % bsz:
            raise ValueError(
                f"cannot resume at --global_train_batch_size {bsz}: the checkpoint consumed "
                f"{samples_rec} samples (at bsz {rec_bsz}), which is not divisible — a partial "
                f"batch would be skipped or replayed. Pick a batch size dividing {samples_rec}.")
        batch_offset = int(samples_rec) // bsz
    metrics.log("recovery", step=start_step, source="disk", resume_batches=batch_offset,
                resume_samples=meta.get("samples_consumed"), restore_s=restore_s)
    if lead:
        print(f"resumed from {ns.load} at step {start_step} ({restore_s:.3f} s)", flush=True)
    return state, start_step, batch_offset, meta, restore_s


def _load_hf(ns):
    """(params, cfg) of ``--load_hf``: the model shape comes from the HF
    config (the reference builds its model from the HF checkpoint the same
    way); ``--seq_length`` still sets the training length, and a learned
    position table is cut to it (a longer one than the table is refused)."""
    from galvatron_tpu_torch.models.convert import load_hf_checkpoint

    params, cfg = load_hf_checkpoint(ns.load_hf)
    seq = getattr(ns, "seq_length", None)
    if seq and seq != cfg.max_seq_len:
        if "pos" in params.get("embed", {}):
            if seq > cfg.max_seq_len:
                raise ValueError(f"--seq_length {seq} exceeds the checkpoint's "
                                 f"learned-position table ({cfg.max_seq_len})")
            params["embed"]["pos"] = params["embed"]["pos"][:seq].clone()
        cfg = cfg.replace(max_seq_len=seq)
    return params, cfg


def _state_from_hf(rt, hp, params, world: int, device: torch.device):
    """A train state from the imported full tree (CPU fp32): this rank's
    pieces under the plan (``bridge.shard_params``), moved to ``device``."""
    from galvatron_tpu_torch import bridge
    from galvatron_tpu_torch.parallel.hybrid import zip_map

    if world > 1 or hp.pp > 1:
        params = zip_map(lambda t, n: torch.from_numpy(np.ascontiguousarray(t)),
                         bridge.shard_params(zip_map(lambda t, n: t.numpy(), params),
                                             rt.cfg, hp, rt.rank, world))
    return rt.state_from(zip_map(lambda t, n: t.to(device=device, dtype=rt.cfg.param_dtype),
                                 params))


def _train(ns: argparse.Namespace, cfg: Optional[ModelConfig], device: torch.device) -> dict:
    import torch.distributed as dist

    world = dist.get_world_size() if dist.is_initialized() else 1
    lead = not dist.is_initialized() or dist.get_rank() == 0
    hf_params = None
    if getattr(ns, "load_hf", None):
        hf_params, hf_cfg = _load_hf(ns)
        cfg = hf_cfg if cfg is None else cfg
    if cfg is None:
        cfg = model_config_from_args(ns)
    # packing rides the model config (split_batch, the attention mask and
    # the position reset key off it), set BEFORE the attention is resolved
    # so that 'auto' lands on the segment-maskable einsum path
    if getattr(ns, "pack_sequences", 0):
        cfg = cfg.replace(pack_sequences=True)
    use_data_pipe = bool(getattr(ns, "data_mixture", None) or cfg.pack_sequences
                         or getattr(ns, "prefetch_depth", 0))
    if use_data_pipe:
        if not (ns.data_mixture or ns.data_path):
            raise ValueError("--pack_sequences/--prefetch_depth/--data_mixture need a real "
                             "corpus: pass --data_path or --data_mixture")
        if getattr(ns, "rampup_batch_size", None):
            raise ValueError(
                "--rampup_batch_size is incompatible with the data pipeline "
                "(mixture/packing/prefetch): the sample-domain cursor is defined at one "
                "global batch size")
    cfg = resolve_attn_impl(cfg, ns, device).replace(mlp_recompute=ns.mlp_recompute)
    hp = _check_plan(ns, cfg, world, lead)
    rampup = _rampup(ns, hp, world)
    seq = layer_seq(cfg)
    bsz = ns.global_train_batch_size
    rt = build_runtime(cfg, hp, adam_config_from_args(ns), global_batch_size=bsz, seq_len=seq,
                       device=device)
    c = rt.cfg
    if lead:
        strategies = sorted({form_strategy(s, rt.pp, rt.world // (rt.pp * s.tp))
                             for s in hp.layer_strategies})
        name = f"hf:{ns.load_hf}" if getattr(ns, "load_hf", None) else ns.model_size
        # an encoder-decoder: encoder + decoder layers, over enc_seq + seq;
        # Swin: each stage's layers, width, heads and tokens
        enc = (lambda n: f"{n}+") if c.enc_layers else (lambda n: "")
        shapes = (f"layers={enc(c.enc_layers)}{c.num_layers} hidden={c.hidden_size} "
                  f"heads={c.num_heads} seq={enc(c.enc_seq)}{seq}")
        if c.swin_depths:
            geo = [swin_geometry(c, k) for k in range(len(c.swin_depths))]
            shapes = (f"layers={'+'.join(map(str, c.swin_depths))} "
                      f"hidden={'/'.join(str(g[2]) for g in geo)} "
                      f"heads={'/'.join(str(g[3]) for g in geo)} "
                      f"seq={'/'.join(str(g[0] * g[1]) for g in geo)}")
        print(f"train: {name} {shapes} batch={bsz} chunks={rt.chunks} "
              f"dtype={str(c.dtype).replace('torch.', '')} attn={c.attn_impl} "
              f"ckpt={rt.ckpt} mlp_recompute={c.mlp_recompute} fused_norm={c.fused_norm} "
              f"packed={c.pack_sequences} "
              f"world={rt.world} strategies={','.join(strategies)} vocab_tp={hp.vocab_tp} "
              f"{_pipeline_desc(hp)}on {device}", flush=True)
    fingerprint = {"world_size": world, "pp": rt.pp, "plan_hash": plan_hash(hp),
                   "global_bsz": int(bsz)}
    with MetricsLogger(getattr(ns, "metrics_path", None) if lead else None) as metrics:
        resumed = _resume(ns, rt, world, fingerprint, metrics, lead)
        if resumed is None and hf_params is not None:
            state, start_step, batch_offset, meta, restore_s = (
                _state_from_hf(rt, hp, hf_params, world, device), 0, 0, {}, None)
            del hf_params
            if lead:
                print(f"initialized from HF checkpoint {ns.load_hf}", flush=True)
        elif resumed is None:
            state, start_step, batch_offset, meta, restore_s = rt.init_state(ns.seed), 0, 0, {}, None
        else:
            state, start_step, batch_offset, meta, restore_s = resumed
        saved_data_state = meta.get("data_state") if isinstance(meta.get("data_state"),
                                                                dict) else None
        if saved_data_state is not None and not use_data_pipe:
            raise ValueError(
                f"--load {ns.load}: the checkpoint records a data-pipeline cursor (sources "
                f"{sorted(saved_data_state.get('per_source_consumed', {}))}) but this run "
                "passes none of --data_mixture/--pack_sequences/--prefetch_depth. Resume with "
                "the original data flags, or point --load elsewhere.")
        data_pipe = None
        if use_data_pipe:
            from galvatron_tpu_torch.data import build_data_pipeline

            # the prefetch thread moves each batch to the rank's device
            data_pipe = build_data_pipeline(
                cfg, bsz, seq, seed=ns.seed, start_batch=batch_offset, data_path=ns.data_path,
                mixture=ns.data_mixture, pack=cfg.pack_sequences,
                prefetch_depth=ns.prefetch_depth,
                put_fn=lambda b: torch.from_numpy(b).to(device), resume_state=saved_data_state)
            loader = iter(data_pipe)
        else:
            loader = build_dataloader(cfg, bsz, seq, seed=ns.seed, start_batch=batch_offset,
                                      data_path=ns.data_path)
        out = _loop(ns, rt, state, loader, data_pipe, metrics, rampup, start_step,
                    batch_offset, fingerprint, device, lead)
    out["restore_s"] = restore_s
    return out


def _loop(ns, rt, state, loader, data_pipe, metrics, rampup, start_step, batch_offset,
          fingerprint, device, lead) -> dict:
    bsz = ns.global_train_batch_size
    seq = layer_seq(rt.cfg)
    stats: dict = {}
    on_card = device.type == "cuda"
    losses, iter_times, batch_sizes = [], [], []
    # consumed samples: under rampup the schedule replays from step 0, so a
    # resumed run sees the sizes (and per-size stream positions) an
    # uninterrupted run would
    consumed, batches_at_size = 0, {}
    if rampup is not None:
        for _ in range(batch_offset):
            b = rampup(consumed)
            batches_at_size[b] = batches_at_size.get(b, 0) + 1
            consumed += b
    else:
        consumed = batch_offset * bsz
    cur_bs = bsz
    skipped = 0
    keep_n = getattr(ns, "keep_last_n", 0)
    next_save_at = ((batch_offset // ns.save_interval + 1) * ns.save_interval
                    if ns.save and ns.save_interval else None)
    prior_skips = batch_offset - start_step
    iters_run = 0

    def save_meta():
        meta = {"batches_consumed": batch_offset + iters_run, "samples_consumed": consumed,
                "global_bsz": int(bsz), "fingerprint": fingerprint}
        if data_pipe is not None:
            meta["data_state"] = data_pipe.state(consumed)
        return meta

    save_s = []

    def save(step):
        t0 = time.perf_counter()
        ckpt.save_checkpoint_portable(ns.save, state, step, rt, keep_last_n=keep_n,
                                      meta=save_meta())
        save_s.append(time.perf_counter() - t0)
        metrics.log("ckpt_save", step=step, seconds=save_s[-1])
        if lead:
            print(f"saved step {step} → {ns.save} ({save_s[-1]:.3f} s)", flush=True)

    try:
        for it in range(batch_offset, ns.train_iters):
            if rampup is not None:
                bs = rampup(consumed)
                if bs != cur_bs or it == batch_offset:
                    cur_bs = bs
                    loader = build_dataloader(rt.cfg, bs, seq, seed=ns.seed + bs,
                                              start_batch=batches_at_size.get(bs, 0),
                                              data_path=ns.data_path)
                batches_at_size[bs] = batches_at_size.get(bs, 0) + 1
            batch = next(loader)
            if not torch.is_tensor(batch):
                batch = torch.from_numpy(batch)
            iters_run += 1
            consumed += cur_bs
            if on_card:
                torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            state, loss = rt.train_step(state, batch)
            loss_val = float(loss)
            if on_card:
                torch.cuda.synchronize(device)
            iter_ms = (time.perf_counter() - t0) * 1e3
            if ns.check_loss and not math.isfinite(loss_val):
                raise FloatingPointError(f"iter {it}: non-finite loss {loss_val}")
            skipped += not rt.stats.get("updated", True)
            losses.append(loss_val)
            iter_times.append(iter_ms)
            batch_sizes.append(cur_bs)
            scale = float(state["scaler"]["scale"]) if "scaler" in state else None
            if lead:
                extra = "" if scale is None else f" scale {scale:g}"
                print(f"iter {it}: loss {loss_val:.4f} ({iter_ms:.1f} ms){extra}", flush=True)
                if cur_bs not in stats:
                    stats[cur_bs] = StepStats(rt.cfg, cur_bs, seq, device=device, ckpt=rt.ckpts,
                                              world=rt.world)
                nonpad = data_pipe.last_meta.get("nonpad_tokens") if data_pipe else None
                rates = stats[cur_bs].per_iter(iter_ms, nonpad_tokens=nonpad)
                packed = {} if nonpad is None else {
                    "nonpad_tokens": nonpad, "tokens_per_s_raw": rates["tokens_per_s_raw"],
                    "packing_efficiency": rates["packing_efficiency"]}
                metrics.log(
                    "train_iter", schema=SCHEMA_VERSION, step=it,
                    # bare NaN/Infinity is not valid JSON
                    loss=loss_val if math.isfinite(loss_val) else str(loss_val),
                    batch_size=cur_bs, iter_ms=iter_ms,
                    tokens_per_s=rates["tokens_per_s"],
                    tflops_per_device=rates["tflops_per_device"], mfu=rates["mfu"],
                    hfu=rates["hfu"], **packed,
                    **({} if scale is None else {"loss_scale": scale}),
                )
            if next_save_at is not None and it + 1 >= next_save_at:
                save(it + 1 - prior_skips)
                next_save_at = ((it + 1) // ns.save_interval + 1) * ns.save_interval
    finally:
        # the prefetch thread stands down on every exit path, after the
        # pipeline's summary reaches the JSONL
        if data_pipe is not None:
            metrics.log("data_pipeline", **data_pipe.summary(consumed))
            data_pipe.close()
    if ns.save:
        # the exit checkpoint of a run that completed, unless the interval
        # save already committed this step at this stream position
        final_step = int(state["step"])
        committed = ckpt.committed_steps(ns.save)
        done = bool(committed) and committed[-1] == final_step
        if done:
            m = ckpt.read_manifest(ckpt.step_path(ns.save, final_step)) or {}
            done = int((m.get("meta") or {}).get("batches_consumed", -1)) == \
                batch_offset + iters_run
        if not done:
            save(final_step)
    return {
        "losses": losses,
        "iter_ms": sum(iter_times) / len(iter_times) if iter_times else None,
        "iter_times": iter_times,
        "batch_sizes": batch_sizes,
        "consumed_samples": consumed,
        "skipped_steps": skipped,
        "loss_scale": float(state["scaler"]["scale"]) if "scaler" in state else None,
        "start_step": start_step,
        "save_s": save_s,
        "state": state,
        "rank": rt.rank,
        "world": rt.world,
        "stage": rt.stage,
        "stage_layers": rt.stage_layers,
        "host_staged": comm.host_staged,
        "p2p": comm.p2p,
        "stats": dict(rt.stats),
        "launches": {"flash_fwd": flash_attention.flash_fwd.launches,
                     "flash_bwd": flash_attention.flash_bwd.launches,
                     "flash_grid_fwd": flash_attention.flash_grid_fwd.launches,
                     "flash_grid_dkdv": flash_attention.flash_grid_bwd_parts.dkv_launches,
                     "flash_grid_dq": flash_attention.flash_grid_bwd_parts.dq_launches,
                     **fused_norm.launch_counts()},
    }
