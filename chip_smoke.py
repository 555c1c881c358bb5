#!/usr/bin/env python3
"""Smoke run of the PyTorch port (galvatron_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero without
its result line:

0. the card: ``nvidia-smi`` name and power limit, torch and CUDA versions;
1. build every kernel from ``galvatron_tpu_torch/ops/csrc`` with nvcc for
   sm_90a (one nvcc per source, all at once), with the ``-Xptxas -v`` report;
2. the paged decode kernel against its plain PyTorch version on the same
   CUDA tensors, at the serving path's shapes (llama-7b decode: 4 rows, 32
   heads, head_dim 128, 16-token blocks, 128 blocks per row, bf16), a GQA
   shape and fp32; bf16 must be within one output ulp of the plain version
   computed in fp32, fp32 within 1e-5. One JSON line per shape with the
   kernel's, the plain version's and the library call's (SDPA over
   gathered K/V, timed only) times, and the least time the card could take
   (bytes over 3.35 TB/s, or operations over the peak rate of the input
   type);
3. the flash forward and backward kernels against their plain versions on
   the same CUDA tensors: the training path's shape (b=8, h=32, s=2048,
   d=128, bf16, the stacked qkv projection view), ragged s=100 at d=64, GQA
   with kv_rep 4, and fp32. fp32 within 1e-5 (out, lse) and 1e-4
   (gradients); bf16 per element within one output ulp plus a share of
   the row's rms (``bf16_parity_excess`` within ``BF16_PARITY_TOL``). A
   control, the plain versions with one key tile dropped, must fail the
   same checks. One JSON line per case with the errors, the control's,
   kernel, plain, library (SDPA with is_causal over pre-roped q/k, and its
   autograd backward; timed only) and bound times.
   Then the grid kernels (forward, dk/dv, dq) against their plain versions
   the same way: the GPT-2 XL training shape (b=8, h=25, s=1024, d=64,
   causal, no RoPE, the stacked projection view), non-causal (b=8, h=16,
   s=512), RoPE past the blocked envelope (b=1, h=4, s=16384, d=128), GQA
   with kv_rep 4, fp32, and a bf16 call writing fp32 output; the dk/dv and
   dq kernels' own device times come from a profiler window;
4. llama-7b width at 2 layers in fp32: prefill + 8 decode steps through
   ``forward_with_cache_paged`` on the card (kernel) and on the CPU (plain
   version); logits within 1e-3, kernel launches == layers x decode steps;
5. llama-7b width and gpt-1.5b width, each at 2 layers in fp32, batch 1,
   s=512: three ``train_step``s on the card (flash kernels: blocked for
   llama, grid for GPT) and on the CPU (plain versions) from the same
   weights and batches; losses within 1e-3 and each kernel of the model's
   path launched layers x steps times, the other family's none. Then bf16
   over fp32 masters, batch 2 at the preset's sequence length: one forward
   + backward through the tensor-core kernels against the same step with
   the wrappers swapped for their plain versions on the card; the loss
   within 1e-3 and every parameter gradient within 2^-5 relative error, and
   the dropped-tile control beyond it;
6. the serving path: ``cli serve --model_size llama-7b --kv_num_blocks -1``
   (32 layers, bf16, random weights from a seed) in a thread of this
   process; 4 concurrent POST /api requests of ~50/300/700-byte prompts and
   one sharing a prefix, 32 greedy tokens each, then a repeated prompt; the
   paged kernel's launch count must equal 32 x the engine's decode steps
   and POST /drain must report no leak;
7. the LLaMA training path: ``cli train --model_size llama-7b --num_layers 4
   --train_iters 10`` (batch 8, seq 2048, bf16 over fp32 masters, AdamW)
   in-process: every loss finite, 10 ``train_iter`` JSONL records, each
   blocked flash kernel launched 4 x 10 times and the grid kernels none;
   iter_ms (mean of iterations 2-10), tokens/s, MFU and peak device memory;
   then ``torch.profiler`` over two steady steps of the same configuration:
   device busy and idle share and the top kernels by device time;
8. the GPT training path: ``cli train --model_size gpt-1.5b --train_iters
   10`` (all 48 layers, batch 8, seq 1024, bf16 over fp32 masters, AdamW)
   in-process, with the same checks and numbers: each grid kernel launched
   48 x 10 times and the blocked kernels none; then its profiler window.

The last two lines are the ``kernels`` JSON line and
``{"ok": true, "device": {...}}``. ``--out PATH`` also writes everything
measured to PATH as JSON.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_FLOPS = {"torch.bfloat16": 989e12, "torch.float32": 67e12}  # dense; fp32 off tensor cores
SERVE_LAYERS = 32
TRAIN_ITERS = 10
# the two training paths: (preset, layers driven, batch, seq)
TRAIN_PATHS = {"llama": ("llama-7b", 4, 8, 2048), "gpt": ("gpt-1.5b", 48, 8, 1024)}
# bf16 train step, kernels against plain versions on the card (phase 5):
# |loss difference| and the largest per-tensor relative gradient error.
# An H100 read 7.8e-5 and 0.009 at llama-7b width; the dropped-tile control
# 1.7e-3 and 0.146.
TRAIN_BF16_LOSS_TOL = 1e-3
TRAIN_BF16_GRAD_TOL = 2 ** -5
RESULTS: dict = {}


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def log(*a):
    print(*a, flush=True)


# ---------------------------------------------------------------------------
# phase 0: the card
# ---------------------------------------------------------------------------


def phase_card(torch):
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False: this needs an NVIDIA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    info = {"nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
            "device_count": torch.cuda.device_count(),
            "device_name": torch.cuda.get_device_name(0)}
    log("phase 0 card:", json.dumps(info))
    RESULTS["card"] = info
    return smi


# ---------------------------------------------------------------------------
# phase 1: build
# ---------------------------------------------------------------------------


def phase_build():
    from galvatron_tpu_torch.ops import _build

    t0 = time.perf_counter()
    logs = _build.build_all()
    total = time.perf_counter() - t0
    for name, entry in logs.items():
        report = [ln.strip() for ln in entry["ptxas"].splitlines()
                  if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
        log(f"phase 1 build: {name} in {entry['seconds']:.2f} s -> {entry['path']}")
        for ln in report:
            log("  ptxas:", ln)
    log(f"phase 1 build: all kernels in {total:.2f} s")
    RESULTS["build"] = {"seconds": total,
                        **{n: {"seconds": e["seconds"], "ptxas": e["ptxas"]} for n, e in logs.items()}}


# ---------------------------------------------------------------------------
# phase 2: kernel parity and timing
# ---------------------------------------------------------------------------


def time_ms(torch, fn, flush, iters=20):
    """Mean CUDA-event time of one call, L2 flushed before each (each decode
    layer reads its own pool slice cold)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def paged_case(torch, dtype, b, n, kv, d, bs, mb, offsets, seed):
    gen = torch.Generator(device="cpu").manual_seed(seed)
    nblocks = 1 + b * mb
    q = torch.randn(b, 1, n, d, generator=gen)
    k = torch.randn(nblocks, bs, kv, d, generator=gen)
    v = torch.randn(nblocks, bs, kv, d, generator=gen)
    tables = (torch.randperm(nblocks - 1, generator=gen)[: b * mb] + 1).reshape(b, mb)
    dev = "cuda"
    return (q.to(dev, dtype), k.to(dev, dtype), v.to(dev, dtype),
            tables.to(dev, torch.int32), torch.tensor(offsets, dtype=torch.int32, device=dev))


def paged_bound(torch, case):
    """Least time for this call on this data: each input byte the function
    needs read once (q, the tables, the offsets, K and V rows at positions
    <= each row's offset), the output written once; 4·d operations per
    (query head, attended token)."""
    q, k, v, tables, offsets = case
    b, _, n, d = q.shape
    _, bs, kv, _ = k.shape
    mb = tables.shape[1]
    esz = q.element_size()
    tokens = int((offsets.clamp(max=mb * bs - 1) + 1).sum().item())
    nbytes = 2 * q.numel() * esz + tables.numel() * 4 + offsets.numel() * 4 \
        + 2 * tokens * kv * d * esz
    flops = 4.0 * tokens * n * d
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[str(q.dtype)] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernels(torch):
    import torch.nn.functional as F

    from galvatron_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    bf16, fp32 = torch.bfloat16, torch.float32
    main_shape = dict(b=4, n=32, kv=32, d=128, bs=16, mb=128)
    import random

    rnd = random.Random(0)
    rand_offsets = [rnd.randrange(0, 2048) for _ in range(4)]
    cases = [
        ("paged_decode main edges", bf16, dict(main_shape), [0, 15, 16, 2047]),
        ("paged_decode main", bf16, dict(main_shape), rand_offsets),
        ("paged_decode gqa", bf16, dict(main_shape, kv=8), rand_offsets),
        ("paged_decode fp32", fp32, dict(main_shape), rand_offsets),
    ]
    lines = {}
    for i, (label, dtype, shape, offsets) in enumerate(cases):
        case = paged_case(torch, dtype, shape["b"], shape["n"], shape["kv"], shape["d"],
                          shape["bs"], shape["mb"], offsets, seed=i)
        before = fa.paged_decode_attention.launches
        out = fa.paged_decode_attention(*case)
        torch.cuda.synchronize()
        check(fa.paged_decode_attention.launches == before + 1, f"{label}: kernel did not launch")
        ref32 = fa.paged_decode_attention_plain(
            *[t.float() if t.is_floating_point() else t for t in case])
        err = (out.float() - ref32).abs()
        max_err = err.max().item()
        if dtype == bf16:
            # one bf16 ulp of the fp32 plain result, plus the fp32 tolerance
            # (the two sum in different orders; it matters only where the
            # result cancels to near zero, below ~1e-3)
            ulp = torch.exp2(torch.floor(torch.log2(ref32.abs().clamp_min(1e-30))) - 7)
            check(bool(torch.all(err <= ulp + 1e-5)),
                  f"{label}: beyond one bf16 ulp + 1e-5 (max err {max_err})")
            tol = "1 bf16 ulp of the fp32 plain result + 1e-5"
        else:
            check(max_err <= 1e-5, f"{label}: max abs err {max_err} > 1e-5")
            tol = "1e-5"
        check(bool(torch.isfinite(out).all()), f"{label}: non-finite output")
        q, k, v, tables, offs = case
        b, _, n, d = q.shape
        kvh = k.shape[2]
        s = tables.shape[1] * k.shape[1]
        kg = k[tables.long()].reshape(b, s, kvh, d).transpose(1, 2)
        vg = v[tables.long()].reshape(b, s, kvh, d).transpose(1, 2)
        kg = kg.repeat_interleave(n // kvh, dim=1).contiguous()
        vg = vg.repeat_interleave(n // kvh, dim=1).contiguous()
        mask = (torch.arange(s, device="cuda")[None] <= offs[:, None].long())[:, None, None, :]
        qh = q.transpose(1, 2).contiguous()
        lib_out = F.scaled_dot_product_attention(qh, kg, vg, attn_mask=mask)
        lib_err = (lib_out.transpose(1, 2).float() - ref32).abs().max().item()
        kernel_ms = time_ms(torch, lambda: fa.paged_decode_attention(*case), flush)
        plain_ms = time_ms(torch, lambda: fa.paged_decode_attention_plain(*case), flush)
        library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qh, kg, vg, attn_mask=mask), flush)
        bound_ms, bound_by = paged_bound(torch, case)
        line = {"shape": label, "dtype": str(dtype).replace("torch.", ""), **shape,
                "offsets": offsets, "max_abs_err": max_err, "tolerance": tol,
                "kernel_ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
                "library_max_abs_err": lib_err, "bound_ms": bound_ms, "bound_by": bound_by,
                "launches": fa.paged_decode_attention.launches - before}
        log(json.dumps(line))
        lines[label] = line
        del case, kg, vg, out, ref32
    torch.cuda.empty_cache()
    RESULTS["kernels"] = lines
    return lines["paged_decode main"]


# ---------------------------------------------------------------------------
# phase 3: flash forward / backward kernels, parity and timing
# ---------------------------------------------------------------------------

FLASH_CASES = [
    # (label, dtype name, b, h, kv heads, s, d, stacked)
    ("flash main", "bfloat16", 8, 32, 32, 2048, 128, True),
    ("flash ragged s100 d64", "bfloat16", 8, 32, 32, 100, 64, False),
    ("flash gqa kv_rep 4", "bfloat16", 8, 32, 8, 2048, 128, False),
    ("flash fp32", "float32", 2, 32, 32, 2048, 128, True),
]


@contextlib.contextmanager
def _patched(obj, **attrs):
    """Set attributes of ``obj`` for the length of a with block."""
    old = {name: getattr(obj, name) for name in attrs}
    for name, value in attrs.items():
        setattr(obj, name, value)
    try:
        yield
    finally:
        for name, value in old.items():
            setattr(obj, name, value)


def _dropped_tile_keep(torch):
    """The plain versions' causal mask with keys 0-63 dropped for the rows
    from max(64, s/2): what a kernel that skipped that tile would compute.
    The parity checks must reject it."""

    def keep(s, device):
        r = torch.arange(s, device=device)
        mask = r[:, None] >= r[None, :]
        mask[max(64, s // 2):, :64] = False
        return mask

    return keep


def _flash_err(torch, fa, got, ref, which):
    """(error, limit) of a flash kernel result against its plain version:
    fp32 the max abs error against 1e-5 (forward) or 1e-4 (backward); bf16
    ``fa.bf16_parity_excess`` against ``fa.BF16_PARITY_TOL``."""
    if got.dtype == torch.float32:
        return (got - ref).abs().max().item(), {"fwd": 1e-5, "bwd": 1e-4}[which]
    return fa.bf16_parity_excess(got, ref), fa.BF16_PARITY_TOL[which]


def flash_case(torch, dtype, b, h, kvh, s, d, stacked, seed):
    """q/k/v as the training path hands them over (views of the stacked
    (b, s, 3, h, d) projection when ``stacked``), rope tables, and do."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn((b, s, 3, h, d), generator=gen, device="cuda").to(dtype)
    qkv = qkv.permute(0, 2, 3, 1, 4)
    if stacked:
        q, k, v = qkv[:, 0], qkv[:, 1], qkv[:, 2]
    else:
        q = qkv[:, 0]
        k, v = qkv[:, 1, :kvh].contiguous(), qkv[:, 2, :kvh].contiguous()
    import numpy as np

    inv = 1.0 / (10000.0 ** (np.arange(0, d, 2) / d))
    freqs = np.outer(np.arange(s), inv)
    cos = torch.from_numpy(np.cos(freqs).astype(np.float32)).cuda()
    sin = torch.from_numpy(np.sin(freqs).astype(np.float32)).cuda()
    do = torch.randn((b, h, s, d), generator=gen, device="cuda").to(dtype)
    return q, k, v, do, cos, sin


def flash_bounds(dtype, b, h, kvh, s, d):
    """Least times of the forward and the backward on these shapes: each
    input read once and each output written once over 3.35 TB/s, or the
    causal pairs' products (2 in the forward, 5 in the backward, 2·d
    operations each per (query, key) pair at or below the diagonal) over the
    input type's peak, whichever is larger."""
    esz = 2 if dtype == "bfloat16" else 4
    pairs = b * h * s * (s + 1) / 2
    qo = b * h * s * d * esz          # one (b, h, s, d) operand
    kv = b * kvh * s * d * esz        # k or v
    tables = 2 * s * (d // 2) * 4
    lse = b * h * s * 4
    fwd_bytes = qo + 2 * kv + tables + qo + lse            # q, k, v, tables -> out, lse
    bwd_bytes = 3 * qo + 2 * kv + lse + tables + 3 * qo    # q,k,v,do,out,lse -> dq,dk,dv
    peak = PEAK_FLOPS["torch." + dtype]
    out = {}
    for name, nbytes, prods in (("fwd", fwd_bytes, 2), ("bwd", bwd_bytes, 5)):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = prods * 2 * d * pairs / peak * 1e3
        out[name] = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    return out


def phase_flash(torch):
    import math

    import torch.nn.functional as F

    from galvatron_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    lines = {}
    for i, (label, dname, b, h, kvh, s, d, stacked) in enumerate(FLASH_CASES):
        dtype = getattr(torch, dname)
        q, k, v, do, cos, sin = flash_case(torch, dtype, b, h, kvh, s, d, stacked, seed=10 + i)
        rep, sm = h // kvh, 1.0 / math.sqrt(d)
        before = (fa.flash_fwd.launches, fa.flash_bwd.launches)
        out, lse = fa.flash_fwd(q, k, v, cos, sin, sm, rep)
        grads = fa.flash_bwd(q, k, v, do, out, lse, cos, sin, sm, rep)
        torch.cuda.synchronize()
        check((fa.flash_fwd.launches, fa.flash_bwd.launches) == (before[0] + 1, before[1] + 1),
              f"{label}: a kernel did not launch")
        ref_out, ref_lse = fa.flash_fwd_blocked_plain(q, k, v, cos, sin, sm, rep)
        kf, vf = k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1)
        ref_grads = fa.flash_bwd_blocked_plain(q, kf, vf, do, out, lse, cos, sin, sm)
        # the control: the plain versions with one key tile dropped
        with _patched(fa, _causal_keep=_dropped_tile_keep(torch)):
            ctl_out, _ = fa.flash_fwd_blocked_plain(q, k, v, cos, sin, sm, rep)
            ctl_grads = fa.flash_bwd_blocked_plain(q, kf, vf, do, out, lse, cos, sin, sm)
        fwd_abs = (out.float() - ref_out.float()).abs().max().item()
        bwd_abs = max((g.float() - r.float()).abs().max().item() for g, r in zip(grads, ref_grads))
        lse_err = (lse - ref_lse).abs().max().item()
        lse_tol = 1e-5 if dtype == torch.float32 else 1e-4
        fwd_err, fwd_lim = _flash_err(torch, fa, out, ref_out, "fwd")
        bwd_err = [_flash_err(torch, fa, g, r, "bwd")[0] for g, r in zip(grads, ref_grads)]
        bwd_lim = _flash_err(torch, fa, grads[0], ref_grads[0], "bwd")[1]
        ctl_fwd = _flash_err(torch, fa, ctl_out, ref_out, "fwd")[0]
        ctl_bwd = [_flash_err(torch, fa, c, r, "bwd")[0] for c, r in zip(ctl_grads, ref_grads)]
        if dtype == torch.float32:
            tol = "fp32: max abs err, out/lse 1e-5, gradients 1e-4"
        else:
            tol = ("bf16: |err| - 1 ulp over the row's rms (bf16_parity_excess), "
                   f"out {fwd_lim}, gradients {bwd_lim}; lse 1e-4")
        finite = all(bool(torch.isfinite(t).all()) for t in (out, *grads))
        del ctl_out, ctl_grads
        # yardstick: SDPA (is_causal) over pre-roped q/k, and its autograd backward
        qr = fa._rope_f32(q, cos, sin).to(dtype).detach().requires_grad_(True)
        kr = fa._rope_f32(kf, cos, sin).to(dtype).detach().requires_grad_(True)
        vr = vf.detach().clone().requires_grad_(True)
        lib_out = F.scaled_dot_product_attention(qr, kr, vr, is_causal=True)
        kernel_fwd = time_ms(torch, lambda: fa.flash_fwd(q, k, v, cos, sin, sm, rep), flush)
        kernel_bwd = time_ms(torch, lambda: fa.flash_bwd(q, k, v, do, out, lse, cos, sin, sm, rep),
                             flush)
        plain_fwd = time_ms(torch, lambda: fa.flash_fwd_blocked_plain(q, k, v, cos, sin, sm, rep),
                            flush, iters=5)
        plain_bwd = time_ms(torch, lambda: fa.flash_bwd_blocked_plain(
            q, kf, vf, do, out, lse, cos, sin, sm), flush, iters=5)
        lib_fwd = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qr, kr, vr, is_causal=True), flush)
        lib_bwd = time_ms(torch, lambda: torch.autograd.grad(
            lib_out, (qr, kr, vr), do, retain_graph=True), flush)
        bounds = flash_bounds(dname, b, h, kvh, s, d)
        line = {"case": label, "dtype": dname, "b": b, "h": h, "kv_heads": kvh, "s": s, "d": d,
                "stacked": stacked, "tolerance": tol,
                "fwd_err": fwd_err, "bwd_err_dq_dk_dv": bwd_err,
                "control_fwd_err": ctl_fwd, "control_bwd_err_dq_dk_dv": ctl_bwd,
                "fwd_max_abs_err": fwd_abs, "lse_max_abs_err": lse_err,
                "bwd_max_abs_err": bwd_abs,
                "fwd_ms": kernel_fwd, "bwd_ms": kernel_bwd,
                "fwd_plain_ms": plain_fwd, "bwd_plain_ms": plain_bwd,
                "fwd_library_ms": lib_fwd, "bwd_library_ms": lib_bwd,
                "fwd_bound_ms": bounds["fwd"][0], "fwd_bound_by": bounds["fwd"][1],
                "bwd_bound_ms": bounds["bwd"][0], "bwd_bound_by": bounds["bwd"][1]}
        log(json.dumps(line))
        lines[label] = line
        check(finite, f"{label}: non-finite kernel output")
        check(fwd_err <= fwd_lim, f"{label}: forward err {fwd_err} > {fwd_lim}")
        check(lse_err <= lse_tol, f"{label}: lse err {lse_err} > {lse_tol}")
        for name, e, c in zip("qkv", bwd_err, ctl_bwd):
            check(e <= bwd_lim, f"{label}: d{name} err {e} > {bwd_lim}")
            check(c > bwd_lim, f"{label}: the dropped-tile control passes for d{name} ({c})")
        check(ctl_fwd > fwd_lim, f"{label}: the dropped-tile control passes the forward check")
        del q, k, v, do, out, lse, grads, ref_out, ref_lse, ref_grads, kf, vf, qr, kr, vr
        del lib_out
        torch.cuda.empty_cache()
    RESULTS["flash"] = lines
    return lines["flash main"]


GRID_CASES = [
    # (label, dtype name, b, h, kv heads, s, d, causal, rope, stacked, out fp32)
    ("grid gpt", "bfloat16", 8, 25, 25, 1024, 64, True, False, True, False),
    ("grid non-causal", "bfloat16", 8, 16, 16, 512, 64, False, False, False, False),
    ("grid rope s16384", "bfloat16", 1, 4, 4, 16384, 128, True, True, False, False),
    ("grid gqa kv_rep 4", "bfloat16", 8, 32, 8, 1024, 64, True, False, False, False),
    ("grid fp32", "float32", 2, 25, 25, 1024, 64, True, False, True, False),
    ("grid out fp32", "bfloat16", 8, 25, 25, 1024, 64, True, False, True, True),
]


def _dropped_grid_keep(torch):
    """The grid plain versions' mask (causal or full) with keys 0-63
    dropped for the rows from max(64, s/2): the control."""

    def keep(s, causal, device):
        r = torch.arange(s, device=device)
        mask = r[:, None] >= r[None, :] if causal else torch.ones(
            s, s, dtype=torch.bool, device=device)
        mask[max(64, s // 2):, :64] = False
        return mask

    return keep


def grid_bounds(dtype, b, h, kvh, s, d, causal, rope, out_esz):
    """Least times of the grid forward, the whole backward and each of its
    two kernels on these shapes: inputs read once and outputs written once
    over 3.35 TB/s, or the products over the (query, key) pairs that are
    not masked (2·d operations each; 2 products in the forward, 5 in the
    backward, 4 in the dk/dv kernel: s, dp, dv, dk; 3 in the dq kernel: s,
    dp, dq) over the input type's peak, whichever is larger."""
    esz = 2 if dtype == "bfloat16" else 4
    pairs = b * h * (s * (s + 1) / 2 if causal else s * s)
    qo = b * h * s * d * esz
    kv = b * kvh * s * d * esz
    tables = 2 * s * (d // 2) * 4 if rope else 0
    row = b * h * s * 4
    ins_bwd = 2 * qo + 2 * kv + 2 * row + tables          # q, do, k, v, lse, delta
    parts = {
        "fwd": (qo + 2 * kv + tables + b * h * s * d * out_esz + row, 2),
        "bwd": (ins_bwd + 3 * qo, 5),
        "dkdv": (ins_bwd + 2 * qo, 4),
        "dq": (ins_bwd + qo, 3),
    }
    peak = PEAK_FLOPS["torch." + dtype]
    out = {}
    for name, (nbytes, prods) in parts.items():
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = prods * 2 * d * pairs / peak * 1e3
        out[name] = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    return out


def device_ms_by_name(torch, fn, names, iters=10):
    """Mean device time per call of the kernels whose names contain each of
    ``names``, from a torch.profiler window over ``iters`` calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {n: 0.0 for n in names}
    for kname, start, end in _kernel_intervals(prof):
        for n in names:
            if n in kname:
                out[n] += (end - start) / 1e3 / iters
    check(all(v > 0 for v in out.values()), f"the profiler saw none of {names}: {out}")
    return out


def phase_grid(torch):
    """The grid forward and the grid dk/dv and dq kernels against their
    plain versions on the card, with the dropped-tile control, and their
    times beside the plain versions', SDPA's and the bounds."""
    import math

    import torch.nn.functional as F

    from galvatron_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    lines = {}
    for i, (label, dname, b, h, kvh, s, d, causal, rope, stacked, out_fp32) in enumerate(
            GRID_CASES):
        dtype = getattr(torch, dname)
        q, k, v, do, cos, sin = flash_case(torch, dtype, b, h, kvh, s, d, stacked, seed=30 + i)
        tables = (cos, sin) if rope else None
        rep, sm = h // kvh, 1.0 / math.sqrt(d)
        out_dtype = torch.float32 if out_fp32 else None
        before = (fa.flash_grid_fwd.launches, fa.flash_grid_bwd_parts.dkv_launches,
                  fa.flash_grid_bwd_parts.dq_launches)
        out, lse = fa.flash_grid_fwd(q, k, v, tables, sm, causal, rep, out_dtype)
        delta = (do.float() * out.float()).sum(-1, keepdim=True).contiguous()
        grads = fa.flash_grid_bwd_parts(q, k, v, do, lse, delta, tables, sm, causal, rep)
        torch.cuda.synchronize()
        after = (fa.flash_grid_fwd.launches, fa.flash_grid_bwd_parts.dkv_launches,
                 fa.flash_grid_bwd_parts.dq_launches)
        check(after == tuple(n + 1 for n in before), f"{label}: a kernel did not launch")
        check(out.dtype == (out_dtype or dtype), f"{label}: out is {out.dtype}")
        kf, vf = k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1)
        ref_out, ref_lse = fa.flash_fwd_grid_plain(q, k, v, tables, sm, causal, rep, out_dtype)
        ref_grads = fa.flash_bwd_grid_plain(q, kf, vf, do, lse, delta, tables, sm, causal)
        with _patched(fa, _grid_keep=_dropped_grid_keep(torch)):
            ctl_out, _ = fa.flash_fwd_grid_plain(q, k, v, tables, sm, causal, rep, out_dtype)
            ctl_grads = fa.flash_bwd_grid_plain(q, kf, vf, do, lse, delta, tables, sm, causal)
        # the rule follows the input dtype: a bf16 call writing fp32 output
        # still rounds p and ds to bf16
        rule = (lambda g, r, w: _flash_err(torch, fa, g.float(), r.float(), w)) \
            if dtype == torch.float32 else \
            (lambda g, r, w: (fa.bf16_parity_excess(g, r), fa.BF16_PARITY_TOL[w]))
        fwd_err, fwd_lim = rule(out, ref_out, "fwd")
        bwd = [rule(g, r, "bwd") for g, r in zip(grads, ref_grads)]
        bwd_err, bwd_lim = [e for e, _ in bwd], bwd[0][1]
        ctl_fwd = rule(ctl_out, ref_out, "fwd")[0]
        ctl_bwd = [rule(c, r, "bwd")[0] for c, r in zip(ctl_grads, ref_grads)]
        abs_err = [(g.float() - r.float()).abs().max().item() for g, r in zip(grads, ref_grads)]
        fwd_abs = (out.float() - ref_out.float()).abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        lse_tol = 1e-5 if dtype == torch.float32 else 1e-4
        finite = all(bool(torch.isfinite(t).all()) for t in (out, *grads))
        del ctl_out, ctl_grads
        # yardstick: SDPA over (pre-roped) q/k, and its autograd backward
        if rope:
            qr, kr = fa._rope_f32(q, cos, sin).to(dtype), fa._rope_f32(kf, cos, sin).to(dtype)
        else:
            qr, kr = q.contiguous(), kf.contiguous()
        qr, kr = qr.detach().requires_grad_(True), kr.detach().requires_grad_(True)
        vr = vf.detach().clone().requires_grad_(True)
        lib_out = F.scaled_dot_product_attention(qr, kr, vr, is_causal=causal)
        fwd_ms = time_ms(torch, lambda: fa.flash_grid_fwd(q, k, v, tables, sm, causal, rep,
                                                           out_dtype), flush)
        bwd_ms = time_ms(torch, lambda: fa.flash_grid_bwd_parts(
            q, k, v, do, lse, delta, tables, sm, causal, rep), flush)
        split = device_ms_by_name(torch, lambda: (flush.zero_(), fa.flash_grid_bwd_parts(
            q, k, v, do, lse, delta, tables, sm, causal, rep)), ["grid_dkdv", "grid_dq"])
        plain_iters = 3 if s > 4096 else 5
        plain_fwd = time_ms(torch, lambda: fa.flash_fwd_grid_plain(
            q, k, v, tables, sm, causal, rep, out_dtype), flush, iters=plain_iters)
        plain_bwd = time_ms(torch, lambda: fa.flash_bwd_grid_plain(
            q, kf, vf, do, lse, delta, tables, sm, causal), flush, iters=plain_iters)
        lib_fwd = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qr, kr, vr, is_causal=causal), flush)
        lib_bwd = time_ms(torch, lambda: torch.autograd.grad(
            lib_out, (qr, kr, vr), do, retain_graph=True), flush)
        bounds = grid_bounds(dname, b, h, kvh, s, d, causal, rope, 4 if out_fp32 else
                             (2 if dtype == torch.bfloat16 else 4))
        line = {"case": label, "dtype": dname, "b": b, "h": h, "kv_heads": kvh, "s": s, "d": d,
                "causal": causal, "rope": rope, "stacked": stacked,
                "out_dtype": str(out.dtype).replace("torch.", ""),
                "tolerance": ("fp32: max abs err, out/lse 1e-5, gradients 1e-4"
                              if dtype == torch.float32 else
                              "bf16: |err| - 1 ulp over the row's rms (bf16_parity_excess), "
                              f"out {fwd_lim}, gradients {bwd_lim}; lse 1e-4"),
                "fwd_err": fwd_err, "bwd_err_dq_dk_dv": bwd_err,
                "control_fwd_err": ctl_fwd, "control_bwd_err_dq_dk_dv": ctl_bwd,
                "fwd_max_abs_err": fwd_abs, "lse_max_abs_err": lse_err,
                "bwd_max_abs_err_dq_dk_dv": abs_err,
                "fwd_ms": fwd_ms, "bwd_ms": bwd_ms, "dkdv_ms": split["grid_dkdv"],
                "dq_ms": split["grid_dq"], "fwd_plain_ms": plain_fwd, "bwd_plain_ms": plain_bwd,
                "fwd_library_ms": lib_fwd, "bwd_library_ms": lib_bwd,
                **{f"{k}_bound_ms": v[0] for k, v in bounds.items()},
                **{f"{k}_bound_by": v[1] for k, v in bounds.items()}}
        log(json.dumps(line))
        lines[label] = line
        check(finite, f"{label}: non-finite kernel output")
        check(fwd_err <= fwd_lim, f"{label}: forward err {fwd_err} > {fwd_lim}")
        check(lse_err <= lse_tol, f"{label}: lse err {lse_err} > {lse_tol}")
        check(ctl_fwd > fwd_lim, f"{label}: the dropped-tile control passes the forward check")
        for name, e, c in zip("qkv", bwd_err, ctl_bwd):
            check(e <= bwd_lim, f"{label}: d{name} err {e} > {bwd_lim}")
            check(c > bwd_lim, f"{label}: the dropped-tile control passes for d{name} ({c})")
        del q, k, v, do, out, lse, delta, grads, ref_out, ref_lse, ref_grads, kf, vf
        del qr, kr, vr, lib_out
        torch.cuda.empty_cache()
    RESULTS["grid"] = lines
    return lines["grid gpt"]


# ---------------------------------------------------------------------------
# phase 4: full-width forward, card vs CPU
# ---------------------------------------------------------------------------


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


def phase_forward(torch):
    import numpy as np

    from galvatron_tpu_torch.models import generation, modeling
    from galvatron_tpu_torch.ops import flash_attention as fa

    cfg = modeling.PRESETS["llama-7b"].replace(num_layers=2, dtype=torch.float32)
    t0 = time.perf_counter()
    cpu_params = modeling.init_model_params(cfg, 0, "cpu")
    gpu_params = _to(cpu_params, "cuda")
    bs, mb, b, steps = 16, 8, 2, 8
    nblocks = 1 + b * mb
    rng = np.random.RandomState(0)
    tables = (rng.permutation(nblocks - 1) + 1).reshape(b, mb).astype(np.int32)
    pools = {dev: generation.init_kv_cache(cfg, nblocks, bs, dev) for dev in ("cpu", "cuda")}
    params = {"cpu": cpu_params, "cuda": gpu_params}
    tokens = rng.randint(0, cfg.vocab_size, (b, 24)).astype(np.int64)
    offsets = np.asarray([0, 5], np.int32)
    before = fa.paged_decode_attention.launches
    max_diff = 0.0
    with torch.inference_mode():
        for step in range(steps + 1):
            logits = {}
            for dev in ("cuda", "cpu"):
                out, _ = generation.forward_with_cache_paged(
                    params[dev], torch.from_numpy(tokens).to(dev), cfg, pools[dev],
                    torch.from_numpy(tables).to(dev), torch.from_numpy(offsets).to(dev))
                logits[dev] = out.float().cpu()
            check(bool(torch.isfinite(logits["cuda"]).all()), f"step {step}: non-finite logits")
            diff = (logits["cuda"] - logits["cpu"]).abs().max().item()
            max_diff = max(max_diff, diff)
            check(diff <= 1e-3, f"forward step {step}: card vs CPU logits differ by {diff}")
            offsets = offsets + tokens.shape[1]
            tokens = logits["cuda"][:, -1].argmax(-1, keepdim=True).numpy().astype(np.int64)
    launches = fa.paged_decode_attention.launches - before
    check(launches == cfg.num_layers * steps,
          f"forward: {launches} kernel launches, expected {cfg.num_layers} x {steps}")
    res = {"layers": cfg.num_layers, "hidden": cfg.hidden_size, "decode_steps": steps,
           "max_abs_logit_diff": max_diff, "tolerance": 1e-3, "launches": launches,
           "seconds": time.perf_counter() - t0}
    log("phase 4 forward:", json.dumps(res))
    RESULTS["forward"] = res
    del cpu_params, gpu_params, params, pools
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 5: full-width train steps, card vs CPU
# ---------------------------------------------------------------------------


def flash_counts(fa):
    """Every flash kernel's launch count."""
    return {"flash_fwd": fa.flash_fwd.launches, "flash_bwd": fa.flash_bwd.launches,
            "flash_grid_fwd": fa.flash_grid_fwd.launches,
            "flash_grid_dkdv": fa.flash_grid_bwd_parts.dkv_launches,
            "flash_grid_dq": fa.flash_grid_bwd_parts.dq_launches}


def reset_flash_counts(fa):
    fa.flash_fwd.launches = fa.flash_bwd.launches = fa.flash_grid_fwd.launches = 0
    fa.flash_grid_bwd_parts.dkv_launches = fa.flash_grid_bwd_parts.dq_launches = 0


def path_counts(model, n):
    """The launch counts a run of ``model``'s training path must show: n
    for each kernel of its path, 0 for the other family's."""
    mine = ("flash_fwd", "flash_bwd") if model == "llama" else (
        "flash_grid_fwd", "flash_grid_dkdv", "flash_grid_dq")
    return {k: (n if k in mine else 0) for k in
            ("flash_fwd", "flash_bwd", "flash_grid_fwd", "flash_grid_dkdv", "flash_grid_dq")}


def _delta(a, b):
    return {k: a[k] - b[k] for k in a}


def phase_train_parity(torch, model):
    import numpy as np

    from galvatron_tpu_torch.core.optim import AdamConfig
    from galvatron_tpu_torch.models import modeling
    from galvatron_tpu_torch.ops import flash_attention as fa
    from galvatron_tpu_torch.parallel.hybrid import build_runtime

    preset = TRAIN_PATHS[model][0]
    cfg = modeling.PRESETS[preset].replace(num_layers=2, max_seq_len=512, attn_impl="flash")
    steps, t0 = 3, time.perf_counter()
    adam = AdamConfig(lr=1e-4, weight_decay=0.01, grad_clip=1.0)
    cpu_params = modeling.init_model_params(cfg, 0, "cpu")
    runs = {}
    rng = np.random.RandomState(0)
    batches = [rng.randint(0, cfg.vocab_size, (1, 513)).astype(np.int32) for _ in range(steps)]
    for dev in ("cuda", "cpu"):
        rt = build_runtime(cfg, adam, global_batch_size=1, seq_len=512,
                           mixed_precision="fp32", device=dev)
        params = _to(cpu_params, dev) if dev == "cuda" else cpu_params
        state = rt.state_from(params)
        before = flash_counts(fa)
        losses = []
        for batch in batches:
            state, loss = rt.train_step(state, torch.from_numpy(batch))
            losses.append(float(loss))
        runs[dev] = (losses, _delta(flash_counts(fa), before))
        del state, params, rt
        torch.cuda.empty_cache()
    (gpu_losses, gpu_launches), (cpu_losses, cpu_launches) = runs["cuda"], runs["cpu"]
    diff = max(abs(a - b) for a, b in zip(gpu_losses, cpu_losses))
    check(all(np.isfinite(gpu_losses)), f"{preset} train parity: non-finite losses {gpu_losses}")
    check(diff <= 1e-3, f"{preset} train parity: card vs CPU losses differ by {diff}")
    want = path_counts(model, cfg.num_layers * steps)
    check(gpu_launches == want, f"{preset} train parity: launches {gpu_launches}, expected {want}")
    check(not any(cpu_launches.values()), f"{preset} train parity: the CPU run launched a kernel")
    res = {"model": preset, "layers": cfg.num_layers, "hidden": cfg.hidden_size, "seq": 512,
           "batch": 1, "dtype": "float32", "steps": steps, "card_losses": gpu_losses,
           "cpu_losses": cpu_losses, "max_abs_loss_diff": diff, "tolerance": 1e-3,
           "launches": gpu_launches, "seconds": time.perf_counter() - t0}
    log("phase 5 train parity:", json.dumps(res))
    RESULTS[f"train_parity_{model}"] = res


def phase_train_bf16(torch, model):
    """The preset's width at 2 layers, bf16 over fp32 masters, batch 2 at
    its sequence length: the loss and every parameter gradient of one
    forward + backward through the bf16 tensor-core flash kernels (blocked
    for llama, grid for GPT), against the same step with the wrappers
    swapped for their plain versions on the same card (every other op,
    cuBLAS's GEMMs included, is then the same), and against a control whose
    plain versions drop one key tile, which must fail."""
    import numpy as np

    from galvatron_tpu_torch.core.optim import tree_leaves
    from galvatron_tpu_torch.models import modeling
    from galvatron_tpu_torch.ops import flash_attention as fa

    preset, _, _, seq = TRAIN_PATHS[model]
    cfg = modeling.PRESETS[preset].replace(num_layers=2, attn_impl="flash", dtype=torch.bfloat16)
    t0 = time.perf_counter()
    params = modeling.init_model_params(cfg, 0, "cuda")
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    batch = torch.from_numpy(
        np.random.RandomState(0).randint(0, cfg.vocab_size, (2, seq + 1))).to("cuda")

    def step():
        loss = modeling.lm_loss(params, batch, cfg)
        loss.backward()
        grads = [p.grad for p in leaves]
        for p in leaves:
            p.grad = None
        return loss.item(), grads

    before = flash_counts(fa)
    loss, grads = step()
    launches = _delta(flash_counts(fa), before)
    if model == "llama":
        plain = {"flash_fwd": fa.flash_fwd_blocked_plain, "flash_bwd": fa.flash_bwd_plain}
    else:
        plain = {"flash_grid_fwd": fa.flash_fwd_grid_plain,
                 "flash_grid_bwd_parts": fa.flash_grid_bwd_parts_plain}
    with _patched(fa, **plain):
        ref_loss, ref_grads = step()
    # both families' plain versions take their causal mask from _causal_keep
    with _patched(fa, **plain, _causal_keep=_dropped_tile_keep(torch)):
        ctl_loss, ctl_grads = step()

    def worst(gs):
        errs = [((g - r).norm() / r.norm().clamp_min(1e-30)).item()
                for g, r in zip(gs, ref_grads)]
        return max(errs)

    grad_err, ctl_grad_err = worst(grads), worst(ctl_grads)
    res = {"model": preset, "layers": cfg.num_layers, "hidden": cfg.hidden_size, "seq": seq,
           "batch": 2, "dtype": "bfloat16", "loss": loss, "plain_loss": ref_loss,
           "control_loss": ctl_loss, "loss_abs_diff": abs(loss - ref_loss),
           "loss_tolerance": TRAIN_BF16_LOSS_TOL, "grad_rel_err": grad_err,
           "grad_tolerance": TRAIN_BF16_GRAD_TOL, "control_grad_rel_err": ctl_grad_err,
           "launches": launches, "seconds": time.perf_counter() - t0}
    log("phase 5 bf16 train parity:", json.dumps(res))
    RESULTS[f"train_parity_bf16_{model}"] = res
    want = path_counts(model, cfg.num_layers)
    check(launches == want, f"{preset} bf16 train parity: launches {launches}, expected {want}")
    check(all(np.isfinite([loss, *[g.sum().item() for g in grads]])),
          f"{preset} bf16 train parity: non-finite loss or gradient")
    check(abs(loss - ref_loss) <= TRAIN_BF16_LOSS_TOL,
          f"{preset} bf16 train parity: kernel vs plain losses differ by {abs(loss - ref_loss)}")
    check(grad_err <= TRAIN_BF16_GRAD_TOL,
          f"{preset} bf16 train parity: gradient relative error {grad_err} > "
          f"{TRAIN_BF16_GRAD_TOL}")
    check(ctl_grad_err > TRAIN_BF16_GRAD_TOL,
          f"{preset} bf16 train parity: the dropped-tile control passes ({ctl_grad_err})")
    del params, leaves, grads, ref_grads, ctl_grads
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 6: the serving path, cli serve
# ---------------------------------------------------------------------------


def _http(url, body=None, timeout=600):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method="GET" if body is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _text(rng, n):
    letters = "abcdefghijklmnopqrstuvwxyz     "
    return "".join(letters[i] for i in rng.randint(0, len(letters), n))


def phase_serve(torch, smi):
    import numpy as np

    from galvatron_tpu_torch import cli
    from galvatron_tpu_torch.models.tokenizer import ByteTokenizer
    from galvatron_tpu_torch.ops import flash_attention as fa

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    argv = ["serve", "--model_size", "llama-7b", "--kv_num_blocks", "-1",
            "--num_slots", "4", "--prefill_chunk", "32", "--port", str(port),
            "--request_ttl_s", "600"]
    rc, err = [], []

    def serve():
        try:
            rc.append(cli.main(argv))
        except BaseException as e:  # noqa: BLE001 — reported by the main thread
            err.append(e)
            raise

    fa.paged_decode_attention.launches = 0  # the main path's count starts here
    t0 = time.perf_counter()
    server = threading.Thread(target=serve, name="cli-serve", daemon=True)
    server.start()
    base = f"http://127.0.0.1:{port}"
    deadline = time.time() + 600
    while True:
        check(not err, f"cli serve died: {err[:1]}")
        try:
            if _http(base + "/readyz", timeout=10)[0] == 200:
                break
        except OSError:
            pass
        check(time.time() < deadline, "cli serve never became ready")
        time.sleep(0.2)
    ready_s = time.perf_counter() - t0
    rng = np.random.RandomState(0)
    p50, p300, p700 = _text(rng, 50), _text(rng, 300), _text(rng, 700)
    prompts = [p50, p300, p700, p700[:640] + _text(rng, 20)]
    results = [None] * len(prompts)

    def post(i):
        results[i] = _http(base + "/api", {"prompts": [prompts[i]], "tokens_to_generate": 32,
                                           "temperature": 0.0})

    t1 = time.perf_counter()
    posters = [threading.Thread(target=post, args=(i,)) for i in range(len(prompts))]
    for p in posters:
        p.start()
    for p in posters:
        p.join(600)
    burst_s = time.perf_counter() - t1
    tok = ByteTokenizer()
    for i, r in enumerate(results):
        check(r is not None and r[0] == 200, f"request {i}: {r}")
        n = len(r[1]["tokens"][0]) - len(tok.encode(prompts[i]))
        check(n == 32, f"request {i}: {n} generated tokens, expected 32")
    code, again = _http(base + "/api", {"prompts": [p300], "tokens_to_generate": 32})
    check(code == 200 and again["tokens"] == results[1][1]["tokens"],
          "the repeated prompt gave another completion")
    code, health = _http(base + "/healthz")
    check(code == 200, f"/healthz {code}")
    st = health["serving"]
    code, drained = _http(base + "/drain", {})
    check(code == 200 and drained.get("leaked") is False, f"/drain: {drained}")
    server.join(120)
    check(not server.is_alive() and rc == [0], f"cli serve did not exit cleanly: {rc} {err}")
    launches = fa.paged_decode_attention.launches  # read right after the main path
    check(launches == SERVE_LAYERS * st["decode_steps"],
          f"{launches} kernel launches, expected {SERVE_LAYERS} x {st['decode_steps']} decode steps")
    dh = st["decode_step_hist"]
    res = {
        "card": smi, "model": "llama-7b", "layers": health["model"]["num_layers"],
        "hidden": health["model"]["hidden_size"], "requests": len(prompts) + 1,
        "prompt_bytes": [len(p) for p in prompts],
        "ready_s": ready_s, "burst_s": burst_s,
        "ttft_p50_s": st["ttft_p50_s"], "ttft_p95_s": st["ttft_p95_s"],
        "decode_step_ms_mean": 1e3 * dh["sum"] / max(1, dh["count"]),
        "decode_steps": st["decode_steps"], "tokens_generated": st["tokens_generated"],
        "tokens_per_s": st["tokens_per_s"], "prefix_cache_hits": st["prefix_cache_hits"],
        "kernel_launches": launches, "leaked": drained["leaked"],
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    log("phase 6 serve:", json.dumps(res))
    RESULTS["serve"] = res
    return launches


# ---------------------------------------------------------------------------
# phase 7: the training path, cli train
# ---------------------------------------------------------------------------


def _kernel_intervals(prof):
    from torch.autograd import DeviceType

    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events() if e.device_type == DeviceType.CUDA]


def _union_us(intervals):
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((s, e) for _, s, e in intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def _category(name: str) -> str:
    n = name.lower()
    if "flash_grid_fwd" in n:
        return "flash_grid_fwd"
    if "flash_grid_dkdv" in n or "flash_grid_dq" in n:
        return "flash_grid_bwd"
    if "flash_fwd" in n:
        return "flash_fwd"
    if "flash_dkdv" in n or "flash_dq" in n or "flash_delta" in n:
        return "flash_bwd"
    # cuBLAS on Hopper names its GEMMs nvjet_*; older builds gemm/cutlass/xmma
    if any(k in n for k in ("nvjet", "gemm", "cutlass", "cublas", "xmma", "gemv")):
        return "matmul"
    return "other"


def phase_train(torch, smi, tmpdir, model):
    from galvatron_tpu_torch import cli
    from galvatron_tpu_torch.ops import flash_attention as fa
    from galvatron_tpu_torch.utils.metrics import read_metrics

    from galvatron_tpu_torch.models.modeling import PRESETS

    preset, layers, bsz, seq = TRAIN_PATHS[model]
    path = os.path.join(tmpdir, f"train_metrics_{model}.jsonl")
    argv = ["train", "--model_size", preset, "--train_iters", str(TRAIN_ITERS),
            "--metrics_path", path]
    if layers != PRESETS[preset].num_layers:  # depth cut (llama-7b: 4 of 32 layers)
        argv += ["--num_layers", str(layers)]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    reset_flash_counts(fa)  # the main path's counts start here
    rc = cli.main(argv)
    launches = flash_counts(fa)  # read right after the main path
    seconds = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(rc == 0, f"cli train {preset} returned {rc}")
    recs = [r for r in read_metrics(path) if r["event"] == "train_iter"]
    check(len(recs) == TRAIN_ITERS, f"{len(recs)} train_iter records, expected {TRAIN_ITERS}")
    losses = [r["loss"] for r in recs]
    check(all(isinstance(x, float) and x == x and abs(x) != float("inf") for x in losses),
          f"{preset}: non-finite losses {losses}")
    want = path_counts(model, layers * TRAIN_ITERS)  # --global_checkpoint 0: no recompute
    check(launches == want, f"{preset}: flash launches {launches}, expected {want}")
    steady = recs[1:]
    mean = lambda key: sum(r[key] for r in steady) / len(steady)  # noqa: E731
    res = {"card": smi, "model": preset, "layers": layers, "batch": bsz, "seq": seq,
           "dtype": "bfloat16", "iters": TRAIN_ITERS, "losses": losses,
           "iter_ms_mean_2_to_10": mean("iter_ms"), "iter_ms": [r["iter_ms"] for r in recs],
           "tokens_per_s": mean("tokens_per_s"), "tflops_per_device": mean("tflops_per_device"),
           "mfu": mean("mfu"), "max_memory_allocated_gb": peak_gb, "launches": launches,
           "seconds": seconds}
    log(f"phase {7 if model == 'llama' else 8} train:", json.dumps(res))
    RESULTS[f"train_{model}"] = res
    torch.cuda.empty_cache()
    return launches, res


def phase_train_profile(torch, model):
    """torch.profiler over two steady steps of the main path's
    configuration (one unprofiled warm step first)."""
    from collections import defaultdict

    from torch.profiler import ProfilerActivity, profile

    from galvatron_tpu_torch.core.dataloader import build_dataloader
    from galvatron_tpu_torch.core.optim import AdamConfig
    from galvatron_tpu_torch.models import modeling
    from galvatron_tpu_torch.parallel.hybrid import build_runtime

    preset, layers, bsz, seq = TRAIN_PATHS[model]
    cfg = modeling.PRESETS[preset].replace(num_layers=layers, attn_impl="flash")
    rt = build_runtime(cfg, AdamConfig(lr=1e-4, weight_decay=0.01, grad_clip=1.0),
                       global_batch_size=bsz, seq_len=seq, mixed_precision="bf16",
                       device="cuda")
    state = rt.init_state(1234)
    loader = build_dataloader(rt.cfg, bsz, seq, seed=1234)
    state, loss = rt.train_step(state, torch.from_numpy(next(loader)))
    float(loss)
    steps, batches = 2, [torch.from_numpy(next(loader)) for _ in range(2)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for batch in batches:
        state, loss = rt.train_step(state, batch)
        float(loss)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    batches = [torch.from_numpy(next(loader)) for _ in range(2)]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        for batch in batches:
            state, loss = rt.train_step(state, batch)
            float(loss)
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t1) * 1e3 / steps
    kernels = _kernel_intervals(prof)
    check(kernels, "the profiler recorded no device kernel")
    busy_ms = _union_us(kernels) / 1e3 / steps
    by_name, by_cat = defaultdict(lambda: [0.0, 0]), defaultdict(float)
    for name, s, e in kernels:
        by_name[name][0] += (e - s) / 1e3 / steps
        by_name[name][1] += 1
        by_cat[_category(name)] += (e - s) / 1e3 / steps
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    res = {"model": preset, "layers": layers, "steps": steps, "wall_ms_per_step": wall_ms,
           "wall_ms_per_step_profiled": prof_wall_ms, "device_busy_ms_per_step": busy_ms,
           "device_idle_share": 1.0 - busy_ms / wall_ms,
           "device_idle_share_profiled_wall": 1.0 - busy_ms / prof_wall_ms,
           "kernel_launches_per_step": len(kernels) / steps,
           "device_ms_by_category": dict(by_cat),
           "top_kernels_ms_per_step": [
               {"name": n[:90], "ms": v[0], "launches_per_step": v[1] / steps} for n, v in top]}
    log(f"phase {7 if model == 'llama' else 8} train profile:", json.dumps(res))
    RESULTS[f"train_profile_{model}"] = res
    del state, rt
    torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description="smoke run of galvatron_tpu_torch on one card")
    ap.add_argument("--out", default=None, help="also write every measurement here as JSON")
    args = ap.parse_args()
    import torch

    import galvatron_tpu_torch  # noqa: F401 — fails fast outside a checkout

    import tempfile

    smi = phase_card(torch)
    phase_build()
    paged_line = phase_kernels(torch)
    flash_line = phase_flash(torch)
    grid_line = phase_grid(torch)
    phase_forward(torch)
    for model in ("llama", "gpt"):
        phase_train_parity(torch, model)
        phase_train_bf16(torch, model)
    paged_launches = phase_serve(torch, smi)
    launches = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmpdir:
        for model in ("llama", "gpt"):
            launches[model], _ = phase_train(torch, smi, tmpdir, model)
            phase_train_profile(torch, model)
    src = "galvatron_tpu_torch/ops/csrc/"
    replaces = "galvatron_tpu/ops/flash_attention.py:"

    def grid_entry(name, source, line_no, count, err, ms, plain, bound, library):
        return {"name": name, "route": "cuda", "source": src + source,
                "replaces": replaces + line_no, "launches": launches["gpt"][count],
                "max_abs_err": err, "ms": grid_line[ms], "plain_ms": grid_line[plain],
                "bound_ms": grid_line[bound + "_bound_ms"],
                "bound_by": grid_line[bound + "_bound_by"], "library_ms": grid_line[library]}

    dq_err, dk_err, dv_err = grid_line["bwd_max_abs_err_dq_dk_dv"]
    kernels = {"kernels": [
        {"name": "paged_decode", "route": "cuda", "source": src + "paged_decode.cu",
         "replaces": replaces + "1152",
         "launches": paged_launches, "max_abs_err": paged_line["max_abs_err"],
         "ms": paged_line["kernel_ms"], "plain_ms": paged_line["plain_ms"],
         "bound_ms": paged_line["bound_ms"], "bound_by": paged_line["bound_by"],
         "library_ms": paged_line["library_ms"]},
        {"name": "flash_fwd", "route": "cuda", "source": src + "flash_fwd.cu",
         "replaces": replaces + "272",
         "launches": launches["llama"]["flash_fwd"], "max_abs_err": flash_line["fwd_max_abs_err"],
         "ms": flash_line["fwd_ms"], "plain_ms": flash_line["fwd_plain_ms"],
         "bound_ms": flash_line["fwd_bound_ms"], "bound_by": flash_line["fwd_bound_by"],
         "library_ms": flash_line["fwd_library_ms"]},
        {"name": "flash_bwd", "route": "cuda", "source": src + "flash_bwd.cu",
         "replaces": replaces + "514",
         "launches": launches["llama"]["flash_bwd"], "max_abs_err": flash_line["bwd_max_abs_err"],
         "ms": flash_line["bwd_ms"], "plain_ms": flash_line["bwd_plain_ms"],
         "bound_ms": flash_line["bwd_bound_ms"], "bound_by": flash_line["bwd_bound_by"],
         "library_ms": flash_line["bwd_library_ms"]},
        # the plain and library times of the two backward kernels are those
        # of the whole backward (the plain version and SDPA compute dq, dk
        # and dv in one call); each kernel's own time and bound are its own
        grid_entry("flash_grid_fwd", "flash_grid_fwd.cu", "123", "flash_grid_fwd",
                   grid_line["fwd_max_abs_err"], "fwd_ms", "fwd_plain_ms", "fwd",
                   "fwd_library_ms"),
        grid_entry("flash_grid_dkdv", "flash_grid_bwd.cu", "724", "flash_grid_dkdv",
                   max(dk_err, dv_err), "dkdv_ms", "bwd_plain_ms", "dkdv", "bwd_library_ms"),
        grid_entry("flash_grid_dq", "flash_grid_bwd.cu", "792", "flash_grid_dq", dq_err,
                   "dq_ms", "bwd_plain_ms", "dq", "bwd_library_ms"),
    ]}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(RESULTS, **kernels), f, indent=1)
    log(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
