#!/usr/bin/env python3
"""Where a decode step of the PyTorch port's serving engine spends its time.

    python experiments/torch_decode_profile.py [--model_size llama-7b] [--steps 16] [--out PATH]

Builds the port's ``Engine`` on the card (paged KV backend, bf16, random
weights from seed 0, 4 slots), admits 4 requests with prompts of about
50/300/700/660 tokens (so the decode offsets resemble ``chip_smoke.py``'s
main path), then measures ``--steps`` decode iterations twice:

- without the profiler: host wall time per iteration (the iteration ends in
  the engine's own logits read-back, a device sync);
- under ``torch.profiler`` (CPU + CUDA): device busy time per iteration
  (the union of kernel intervals), the device's idle share of the
  unprofiled wall time (and of the profiled one, which the profiler's host
  overhead stretches), and kernel time by name, grouped into matmul /
  paged_decode / other.

Prints one JSON line (and writes it to ``--out`` when given).
Needs a card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from collections import defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _kernel_intervals(prof):
    from torch.autograd import DeviceType

    out = []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            out.append((e.name, e.time_range.start, e.time_range.end))
    return out


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
    if "paged_decode" in n:
        return "paged_decode"
    # cuBLAS on Hopper names its GEMMs nvjet_*; older builds gemm/cutlass/xmma
    if any(k in n for k in ("nvjet", "gemm", "cutlass", "cublas", "xmma", "gemv")):
        return "matmul"
    return "other"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model_size", default="llama-7b")
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--out", default=None, help="also write the JSON line here")
    args = ap.parse_args()

    import numpy as np
    import torch

    from galvatron_tpu_torch.models import modeling
    from galvatron_tpu_torch.ops import _build
    from galvatron_tpu_torch.serving import Engine

    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA card (torch.cuda.is_available() is False)")
    _build.build_all()
    cfg = modeling.PRESETS[args.model_size]
    dev = torch.device("cuda", torch.cuda.current_device())
    params = modeling.cast_params(modeling.init_model_params(cfg, 0, dev), cfg)
    eng = Engine(params, cfg, device=dev, num_slots=4, prefill_chunk=32, kv_num_blocks=-1,
                 start_loop=False, request_ttl_s=None)
    rng = np.random.RandomState(0)
    for n in (50, 300, 700, 660):
        eng.submit(rng.randint(0, 256, (n,)).tolist(), 3 * args.steps + 8)
    for _ in range(4):  # admission (prefill) + warm decode iterations
        eng.step_once()
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    for _ in range(args.steps):
        eng.step_once()
    wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        for _ in range(args.steps):
            eng.step_once()
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t1) * 1e3 / args.steps
    kernels = _kernel_intervals(prof)
    busy_ms = _union_us(kernels) / 1e3 / args.steps
    by_name = defaultdict(lambda: [0.0, 0])
    by_cat = defaultdict(float)
    for name, s, e in kernels:
        by_name[name][0] += (e - s) / 1e3 / args.steps
        by_name[name][1] += 1
        by_cat[_category(name)] += (e - s) / 1e3 / args.steps
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    st = eng.stats()
    offsets = [int(x) for x in eng.slots.lengths]
    eng.close()
    res = {
        "card": torch.cuda.get_device_name(0), "model": args.model_size,
        "layers": cfg.num_layers, "dtype": str(cfg.dtype).replace("torch.", ""),
        "rows": 4, "steps": args.steps, "offsets_at_end": offsets,
        "wall_ms_per_step": wall_ms,
        "wall_ms_per_step_profiled": prof_wall_ms,
        "device_busy_ms_per_step": busy_ms,
        # the profiler's own host overhead stretches the profiled wall; the
        # kernels' busy time is the same either way, so the share against
        # the unprofiled wall is the honest estimate and the other a bound
        "device_idle_share": (1.0 - busy_ms / wall_ms) if kernels else None,
        "device_idle_share_profiled_wall": (1.0 - busy_ms / prof_wall_ms) if kernels else None,
        "kernel_launches_per_step": len(kernels) / args.steps,
        "device_ms_by_category": dict(by_cat),
        "top_kernels_ms_per_step": [
            {"name": n[:90], "ms": v[0], "launches_per_step": v[1] / args.steps}
            for n, v in top
        ],
        "decode_steps": st["decode_steps"],
    }
    line = json.dumps(res)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
