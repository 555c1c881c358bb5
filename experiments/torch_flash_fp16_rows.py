"""Where the blocked flash backward's dq departs from its plain version, row
by row, at the training shape (b=8, h=32, s=2048, d=128, the stacked
projection view, ``chip_smoke.py`` phase 3's inputs and seed), for bf16 on
the TMA route and fp16 on the TMA and the CUDA-core routes; and, for the
worst rows, how far the kernel and the plain version each lie from the same
function computed in fp64 from the same 16-bit inputs. Needs the card.

    python experiments/torch_flash_fp16_rows.py [--out rows.json]

Prints one JSON line per route: ``fp16_parity_excess`` / ``bf16_parity_excess``
of dq, dk and dv, the share of rows above 2^-5, and the worst rows (sequence
position, the row's rms over the tensor's, the excess, and the kernel's and
the plain version's largest error against fp64 over the row's rms).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from galvatron_tpu_torch.ops import flash_attention as fa  # noqa: E402


def row_excess(got, ref, bits):
    """Per-row ``parity_excess`` (b, h, s) and the row scale it divides by."""
    r = ref.float()
    ulp = torch.exp2(torch.floor(torch.log2(r.abs().clamp_min(1e-30))) - bits)
    floor = r.square().mean().sqrt().clamp_min(1e-30) * 2 ** -10
    rms = torch.maximum(r.square().mean(dim=-1, keepdim=True).sqrt(), floor)
    ex = (((got.float() - r).abs() - ulp) / rms).amax(dim=-1).clamp_min(0)
    return ex, rms.squeeze(-1), r.square().mean().sqrt()


def bwd_cuda_core(q, k, v, do, out, lse, cos, sin, sm):
    """flash_bwd through its C entry with no scratches: the CUDA-core route."""
    b, h, s, d = q.shape
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    route = ctypes.c_int(-1)
    err = fa._entry("galvatron_flash_bwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), out.data_ptr(), lse.data_ptr(),
        cos.data_ptr(), sin.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        delta.data_ptr(), None, None, fa._strides(q, k, v, do, out, dq, dk, dv),
        fa._DTYPE_CODE[q.dtype], b, h, 1, s, d, float(sm * fa.LOG2E), float(sm),
        torch.cuda.current_stream().cuda_stream, ctypes.byref(route))
    assert err == 0 and fa.ROUTES[route.value] == "cuda_core", (err, route.value)
    return dq, dk, dv


def dq_fp64(q, k, v, do, cos, sin, sm):
    """dq of one (b, h) slice in fp64 from the 16-bit inputs, no rounding."""
    q, k, v, do, cos, sin = (t.double() for t in (q, k, v, do, cos, sin))
    d2 = q.shape[-1] // 2

    def rope(x):
        x1, x2 = x[..., :d2], x[..., d2:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)

    def rope_t(y):
        y1, y2 = y[..., :d2], y[..., d2:]
        return torch.cat([y1 * cos + y2 * sin, y2 * cos - y1 * sin], dim=-1)

    qr, kr = rope(q), rope(k)
    sc = (qr @ kr.T) * sm
    s = sc.shape[0]
    keep = torch.ones(s, s, dtype=torch.bool, device=sc.device).tril()
    p = torch.softmax(sc.masked_fill(~keep, float("-inf")), dim=-1)
    o = p @ v
    dp = do @ v.T
    ds = p * (dp - (do * o).sum(-1, keepdim=True))
    return rope_t((ds @ kr) * sm)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    b, h, s, d = 8, 32, 2048, 128
    sm = 1.0 / math.sqrt(d)
    report = {}
    for name, dtype, seed in (("bf16 tma", torch.bfloat16, 10), ("fp16 tma", torch.float16, 14),
                              ("fp16 cuda_core", torch.float16, 14)):
        q, k, v, do, cos, sin = cs.flash_case(torch, dtype, b, h, h, s, d, True, seed)
        out, lse = fa.flash_fwd(q, k, v, cos, sin, sm)
        if name.endswith("cuda_core"):
            grads = bwd_cuda_core(q, k, v, do, out, lse, cos, sin, sm)
        else:
            grads = fa.flash_bwd(q, k, v, do, out, lse, cos, sin, sm)
        ref = fa.flash_bwd_blocked_plain(q, k, v, do, out, lse, cos, sin, sm)
        bits = 10 if dtype == torch.float16 else 7
        line = {"route": name, "dtype": str(dtype)}
        for gname, g, r in zip(("dq", "dk", "dv"), grads, ref):
            ex, rms, tensor_rms = row_excess(g, r, bits)
            line[gname] = {"max": ex.max().item(), "share_above_2^-5": (ex > 2 ** -5).float()
                           .mean().item(), "tensor_rms": tensor_rms.item()}
            if gname != "dq":
                continue
            top = torch.topk(ex.flatten(), 8)
            worst = []
            for val, idx in zip(top.values.tolist(), top.indices.tolist()):
                bi, hi, si = idx // (h * s), (idx // s) % h, idx % s
                exact = dq_fp64(q[bi, hi], k[bi, hi], v[bi, hi], do[bi, hi], cos, sin, sm)[si]
                row_rms = rms[bi, hi, si].item()
                worst.append({
                    "b": bi, "h": hi, "pos": si, "excess": val,
                    "row_rms_over_tensor": row_rms / tensor_rms.item(),
                    "kernel_vs_fp64": (g[bi, hi, si].double() - exact).abs().max().item() / row_rms,
                    "plain_vs_fp64": (r[bi, hi, si].double() - exact).abs().max().item() / row_rms,
                })
            line["dq"]["worst_rows"] = worst
        print(json.dumps(line), flush=True)
        report[name] = line
        del q, k, v, do, out, lse, grads, ref
        torch.cuda.empty_cache()
    if args.out:
        Path(args.out).write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
