"""Training loop of ``cli train`` (the port's counterpart of
``galvatron_tpu/core/trainer.py``), on one device.

Per iteration: the next synthetic batch, one ``train_step``, the loss read
back (one host synchronisation, then ``torch.cuda.synchronize()`` on the
card) and the host-clock ``iter_ms`` around all of it; the loss is printed
and, with ``--metrics_path``, a ``train_iter`` JSONL record carries step,
loss, batch_size, iter_ms and the device rates (tokens_per_s,
tflops_per_device, mfu, hfu; None on the CPU). The reference's resilience,
elastic, AOT, tracing, checkpoint and data-pipeline machinery is not
ported yet (ROADMAP.md §1).
"""

from __future__ import annotations

import argparse
import math
import time
from typing import Optional

import torch

from galvatron_tpu_torch.core.arguments import (
    adam_config_from_args,
    model_config_from_args,
    resolve_attn_impl,
)
from galvatron_tpu_torch.core.dataloader import build_dataloader
from galvatron_tpu_torch.device import resolve_device
from galvatron_tpu_torch.obs.stepstats import StepStats
from galvatron_tpu_torch.models.modeling import ModelConfig
from galvatron_tpu_torch.ops import flash_attention, fused_norm
from galvatron_tpu_torch.parallel.hybrid import CKPT_MODES, build_runtime
from galvatron_tpu_torch.utils.metrics import SCHEMA_VERSION, MetricsLogger


def train(ns: argparse.Namespace, cfg: Optional[ModelConfig] = None) -> dict:
    """Train ``ns.train_iters`` steps; returns the losses, the mean
    iter_ms, the final state and every training kernel's launch count as it
    stands at the end of the run. ``cfg`` replaces the model the flags
    describe (the way to fields that have no flag, ``fused_norm`` among
    them); attention implementation and ``--mlp_recompute`` still come from
    ``ns``."""
    device = resolve_device(ns.device)
    if cfg is None:
        cfg = model_config_from_args(ns)
    cfg = resolve_attn_impl(cfg, ns, device).replace(mlp_recompute=ns.mlp_recompute)
    ckpt = CKPT_MODES[ns.global_checkpoint]
    seq = cfg.max_seq_len
    bsz = ns.global_train_batch_size
    rt = build_runtime(
        cfg, adam_config_from_args(ns), global_batch_size=bsz, seq_len=seq,
        chunks=ns.chunks if ns.chunks > 0 else 1, ckpt=ckpt,
        mixed_precision=ns.mixed_precision, device=device,
    )
    c = rt.cfg
    print(f"train: {ns.model_size} layers={c.num_layers} hidden={c.hidden_size} "
          f"heads={c.num_heads} seq={seq} batch={bsz} chunks={rt.chunks} "
          f"dtype={str(c.dtype).replace('torch.', '')} attn={c.attn_impl} "
          f"ckpt={ckpt} mlp_recompute={c.mlp_recompute} fused_norm={c.fused_norm} "
          f"on {device}", flush=True)
    state = rt.init_state(ns.seed)
    loader = build_dataloader(rt.cfg, bsz, seq, seed=ns.seed)
    stats = StepStats(rt.cfg, bsz, seq, device=device, ckpt=ckpt)
    on_card = device.type == "cuda"
    losses, iter_times = [], []
    with MetricsLogger(getattr(ns, "metrics_path", None)) as metrics:
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
        "state": state,
        "launches": {"flash_fwd": flash_attention.flash_fwd.launches,
                     "flash_bwd": flash_attention.flash_bwd.launches,
                     "flash_grid_fwd": flash_attention.flash_grid_fwd.launches,
                     "flash_grid_dkdv": flash_attention.flash_grid_bwd_parts.dkv_launches,
                     "flash_grid_dq": flash_attention.flash_grid_bwd_parts.dq_launches,
                     **fused_norm.launch_counts()},
    }
