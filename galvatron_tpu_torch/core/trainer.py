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

Per iteration: the next batch, one ``train_step``, the loss read back (one
host synchronisation, then ``torch.cuda.synchronize()`` on the card) and the
host-clock ``iter_ms`` around all of it. Rank 0 alone prints the loss (under
a pipeline the last stage's, which reaches every rank) and,
with ``--metrics_path``, writes a ``train_iter`` JSONL record (step, loss,
batch_size, iter_ms and the per-device rates: tokens_per_s,
tflops_per_device, mfu, hfu; None on the CPU). The reference's resilience,
elastic, AOT, tracing, checkpoint and data-pipeline machinery is not ported
yet (ROADMAP.md §1).
"""

from __future__ import annotations

import argparse
import datetime
import math
import os
import time
from typing import Optional

import torch

from galvatron_tpu_torch.core.arguments import (
    adam_config_from_args,
    hybrid_config_from_args,
    model_config_from_args,
    resolve_attn_impl,
)
from galvatron_tpu_torch.core.dataloader import build_dataloader
from galvatron_tpu_torch.core.strategy import form_strategy
from galvatron_tpu_torch.device import rank_device
from galvatron_tpu_torch.obs.stepstats import StepStats
from galvatron_tpu_torch.models.modeling import ModelConfig
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
    """Train ``ns.train_iters`` steps; returns the losses, the mean
    iter_ms, this rank's final state, its pipeline stage and layers, its
    host-staged and point-to-point message counts, and every training
    kernel's launch count as it stands at the end of the run. ``cfg`` replaces the model
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


def _train(ns: argparse.Namespace, cfg: Optional[ModelConfig], device: torch.device) -> dict:
    import torch.distributed as dist

    world = dist.get_world_size() if dist.is_initialized() else 1
    if cfg is None:
        cfg = model_config_from_args(ns)
    cfg = resolve_attn_impl(cfg, ns, device).replace(mlp_recompute=ns.mlp_recompute)
    hp = hybrid_config_from_args(ns, cfg.num_layers, world)
    seq = cfg.max_seq_len
    bsz = ns.global_train_batch_size
    rt = build_runtime(cfg, hp, adam_config_from_args(ns), global_batch_size=bsz, seq_len=seq,
                       device=device)
    lead = rt.rank == 0
    c = rt.cfg
    if lead:
        strategies = sorted({form_strategy(s, rt.pp, rt.world // (rt.pp * s.tp))
                             for s in hp.layer_strategies})
        print(f"train: {ns.model_size} layers={c.num_layers} hidden={c.hidden_size} "
              f"heads={c.num_heads} seq={seq} batch={bsz} chunks={rt.chunks} "
              f"dtype={str(c.dtype).replace('torch.', '')} attn={c.attn_impl} "
              f"ckpt={rt.ckpt} mlp_recompute={c.mlp_recompute} fused_norm={c.fused_norm} "
              f"world={rt.world} strategies={','.join(strategies)} vocab_tp={hp.vocab_tp} "
              f"{_pipeline_desc(hp)}on {device}", flush=True)
    state = rt.init_state(ns.seed)
    loader = build_dataloader(rt.cfg, bsz, seq, seed=ns.seed)
    stats = StepStats(rt.cfg, bsz, seq, device=device, ckpt=rt.ckpts, world=rt.world)
    on_card = device.type == "cuda"
    losses, iter_times = [], []
    with MetricsLogger(getattr(ns, "metrics_path", None) if lead else None) as metrics:
        for it in range(ns.train_iters):
            batch = next(loader)
            if on_card:
                torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            state, loss = rt.train_step(state, torch.from_numpy(batch))
            loss_val = float(loss)
            if on_card:
                torch.cuda.synchronize(device)
            iter_ms = (time.perf_counter() - t0) * 1e3
            if ns.check_loss and not math.isfinite(loss_val):
                raise FloatingPointError(f"iter {it}: non-finite loss {loss_val}")
            losses.append(loss_val)
            iter_times.append(iter_ms)
            if not lead:
                continue
            print(f"iter {it}: loss {loss_val:.4f} ({iter_ms:.1f} ms)", flush=True)
            rates = stats.per_iter(iter_ms)
            metrics.log(
                "train_iter", schema=SCHEMA_VERSION, step=it,
                # bare NaN/Infinity is not valid JSON
                loss=loss_val if math.isfinite(loss_val) else str(loss_val),
                batch_size=bsz, iter_ms=iter_ms,
                tokens_per_s=rates["tokens_per_s"],
                tflops_per_device=rates["tflops_per_device"], mfu=rates["mfu"],
                hfu=rates["hfu"],
            )
    return {
        "losses": losses,
        "iter_ms": sum(iter_times) / len(iter_times) if iter_times else None,
        "iter_times": iter_times,
        "state": state,
        "rank": rt.rank,
        "world": rt.world,
        "stage": rt.stage,
        "stage_layers": rt.stage_layers,
        "host_staged": comm.host_staged,
        "p2p": comm.p2p,
        "launches": {"flash_fwd": flash_attention.flash_fwd.launches,
                     "flash_bwd": flash_attention.flash_bwd.launches,
                     "flash_grid_fwd": flash_attention.flash_grid_fwd.launches,
                     "flash_grid_dkdv": flash_attention.flash_grid_bwd_parts.dkv_launches,
                     "flash_grid_dq": flash_attention.flash_grid_bwd_parts.dq_launches,
                     **fused_norm.launch_counts()},
    }
