#!/usr/bin/env python3
"""Smoke run of the PyTorch port (galvatron_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero without
its result line:

0. the card: ``nvidia-smi`` name and power limit, torch and CUDA versions;
1. build every kernel from ``galvatron_tpu_torch/ops/csrc`` with nvcc for
   sm_90a (one nvcc per source, all at once), with the ``-Xptxas -v`` report;
2. each kernel against its plain PyTorch version on the same CUDA tensors,
   at the main path's shapes (llama-7b decode: 4 rows, 32 heads, head_dim
   128, 16-token blocks, 128 blocks per row, bf16), a GQA shape and fp32;
   bf16 must be within one output ulp of the plain version computed in
   fp32, fp32 within 1e-5. One JSON line per shape with the kernel's,
   the plain version's and the library call's (SDPA over gathered K/V,
   timed only) times, and the least time the card could take (bytes over
   3.35 TB/s, or operations over the peak rate of the input type);
3. llama-7b width at 2 layers in fp32: prefill + 8 decode steps through
   ``forward_with_cache_paged`` on the card (kernel) and on the CPU (plain
   version); logits within 1e-3, kernel launches == layers x decode steps;
4. the main path: ``cli serve --model_size llama-7b --kv_num_blocks -1``
   (32 layers, bf16, random weights from a seed) in a thread of this
   process; 4 concurrent POST /api requests of ~50/300/700-byte prompts and
   one sharing a prefix, 32 greedy tokens each, then a repeated prompt; the
   kernel's launch count must equal 32 x the engine's decode steps and
   POST /drain must report no leak.

The last two lines are the ``kernels`` JSON line and
``{"ok": true, "device": {...}}``. ``--out PATH`` also writes everything
measured to PATH as JSON.
"""

from __future__ import annotations

import argparse
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
# phase 3: full-width forward, card vs CPU
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
    log("phase 3 forward:", json.dumps(res))
    RESULTS["forward"] = res
    del cpu_params, gpu_params, params, pools
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 4: the main path, cli serve
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
    log("phase 4 serve:", json.dumps(res))
    RESULTS["serve"] = res
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description="smoke run of galvatron_tpu_torch on one card")
    ap.add_argument("--out", default=None, help="also write every measurement here as JSON")
    args = ap.parse_args()
    import torch

    import galvatron_tpu_torch  # noqa: F401 — fails fast outside a checkout

    smi = phase_card(torch)
    phase_build()
    main_line = phase_kernels(torch)
    phase_forward(torch)
    launches = phase_serve(torch, smi)
    kernels = {"kernels": [{
        "name": "paged_decode", "route": "cuda",
        "source": "galvatron_tpu_torch/ops/csrc/paged_decode.cu",
        "replaces": "galvatron_tpu/ops/flash_attention.py:1152",
        "launches": launches, "max_abs_err": main_line["max_abs_err"],
        "ms": main_line["kernel_ms"], "plain_ms": main_line["plain_ms"],
        "bound_ms": main_line["bound_ms"], "bound_by": main_line["bound_by"],
        "library_ms": main_line["library_ms"],
    }]}
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
