"""Variants of the flash forward's Hopper mainloop
(``galvatron_tpu_torch/ops/csrc/flash_fwd_common.cuh``) side by side on one
card: each variant is the tree's source with a few named text patches,
built with the flags of ``galvatron_tpu_torch/ops/_build.py`` into
``build/torch_kernels/variants/<name>/`` and loaded in place of the tree's
library. Every variant is timed through the wrappers at the grid forward's
GPT-2 XL training shape (b=8, h=25, s=1024, d=64, causal, the stacked
projection view), a non-causal grid shape (b=8, h=16, s=512, d=64) and the
blocked forward's main shape (b=8, h=32, s=2048, d=128, RoPE), in turns
(the tree's source first and last), and held to the plain versions by
``bf16_parity_excess``. Diagnostic variants (``diag_*``) drop work to show
its share and are not expected to hold parity. (Earlier versions of this
script measured variants of earlier designs of the kernel; PERF.md says
which numbers came from which.) Needs the CUDA toolkit and
one card.

    python experiments/torch_fwd_variants.py [--variants base,exp2f,...] [--alt NAME=CSRC_DIR]
        [--split] [--rounds 8] [--out r.json]

``--alt NAME=DIR`` adds a variant built from another copy of ``csrc/`` as
it is (e.g. an earlier design unpacked with ``git archive``). The card's
clocks drift under load, so the variants take turns within each of
``--rounds`` rounds and each line reports the median, min and max over
them. Prints one JSON line per (variant, shape) and the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from galvatron_tpu_torch.ops import _build  # noqa: E402

HDR = "flash_fwd_common.cuh"
# name -> [(file, old text, new text)], applied to a copy of csrc/
VARIANTS = {
    "base": [],
    # the full-range exp2f for p and alpha instead of the SFU's ex2.approx
    "exp2f": [(HDR, "    alpha[r] = ex2(m[r] - m_new);", "    alpha[r] = exp2f(m[r] - m_new);"),
              (HDR, "    sc[i] = ex2(sc[i] - m[(i >> 1) & 1]);",
               "    sc[i] = exp2f(sc[i] - m[(i >> 1) & 1]);")],
    # a deeper ring at head_dim 64 (6 stages of 32 KB)
    "st6": [(HDR, "  static constexpr int STAGES = 3;", "  static constexpr int STAGES = D == 64 ? 6 : 3;"),
            (HDR, "constexpr int kSlots = 3;", "constexpr int kSlots = 6;")],
    # items in q-tile-major order (every (b, h)'s last q tile first, then
    # their second last, ...): items in flight together come from different
    # heads
    "qtmajor": [(HDR, "    const int qt = nqt - 1 - w % nqt, bh = w / nqt;",
                 "    const int qt = nqt - 1 - w / (a.heads * a.batch), bh = w % (a.heads * a.batch);")],
    # the grid's scale folded into the row max and the exponent's FFMA
    # (lam s - m rounded once) instead of a multiply of every score
    "lam_fold": [(HDR, "  if (GRID) {\n#pragma unroll\n"
                       "    for (int i = 0; i < BN / 2; ++i) sc[i] = __fmul_rn(sc[i], lam);\n  }\n", ""),
                 (HDR, "    const float m_new = fmaxf(m[r], v);",
                  "    const float m_new = fmaxf(m[r], GRID ? __fmul_rn(v, lam) : v);"),
                 (HDR, "    sc[i] = ex2(sc[i] - m[(i >> 1) & 1]);",
                  "    sc[i] = ex2(GRID ? __fmaf_rn(sc[i], lam, -m[(i >> 1) & 1])\n"
                  "                     : sc[i] - m[(i >> 1) & 1]);")],
    # diagnostic: clock64() around each phase of the consumer loop; the first
    # warp of each warpgroup of block 0 writes its cycle sums into lse[0:16]
    # (phases: waiting for a tile, waiting for the turn, S, softmax with the
    # O rescale and p's packing, O += p v; tiles; the whole loop) and the
    # producer lane its cycles waiting for free stages into lse[16]
    "diag_clock": [
        (HDR, "  if (wg == 1) named_arrive(kTurn, 256);\n  int g = 0;",
         "  if (wg == 1) named_arrive(kTurn, 256);\n  int g = 0;\n"
         "  long long clk[8] = {0, 0, 0, 0, 0, 0, 0, 0}, t0, tbeg = clock64();"),
        (HDR, "      if (kt > 0) mbar_wait(&full[g % STAGES], (g / STAGES) & 1);\n"
              "      named_sync(kTurn + wg, 256);  // this warpgroup's turn\n",
         "      t0 = clock64();\n"
         "      if (kt > 0) mbar_wait(&full[g % STAGES], (g / STAGES) & 1);\n"
         "      clk[0] += clock64() - t0; t0 = clock64();\n"
         "      named_sync(kTurn + wg, 256);\n"
         "      clk[1] += clock64() - t0; t0 = clock64();\n"),
        (HDR, "      named_arrive(kTurn + 1 - wg, 256);  // the other's turn\n",
         "      named_arrive(kTurn + 1 - wg, 256);\n"
         "      clk[2] += clock64() - t0; t0 = clock64();\n"),
        (HDR, "      pack_a<BN>(sc, pa);\n      wgmma_fence();\n",
         "      pack_a<BN>(sc, pa);\n      clk[3] += clock64() - t0; t0 = clock64();\n"
         "      wgmma_fence();\n"),
        (HDR, "      if (lane == 0) mbar_arrive(&empty[g % STAGES]);  // this warp is done with the stage\n    }\n",
         "      if (lane == 0) mbar_arrive(&empty[g % STAGES]);\n"
         "      clk[4] += clock64() - t0; clk[5] += 1;\n    }\n"),
        (HDR, "  if (wg == 0) named_sync(kTurn, 256);  // warpgroup 1's arrival after its last S\n}",
         "  if (wg == 0) named_sync(kTurn, 256);  // warpgroup 1's arrival after its last S\n"
         "  clk[6] = clock64() - tbeg;\n"
         "  if (blockIdx.x == 0 && lane == 0 && (warp & 3) == 0)\n"
         "    for (int i = 0; i < 8; ++i) a.lse[8 * wg + i] = (float)clk[i];\n}"),
        (HDR, "        mbar_wait(&empty[st], ((g / STAGES) & 1) ^ 1);  // a new ring passes at once\n",
         "        long long p0 = clock64();\n"
         "        mbar_wait(&empty[st], ((g / STAGES) & 1) ^ 1);  // a new ring passes at once\n"
         "        pwait += clock64() - p0;\n"),
        (HDR, "          if (kt > 0) mbar_wait(&empty[stg], ((g / STAGES) & 1) ^ 1);\n",
         "          long long p1 = clock64();\n"
         "          if (kt > 0) mbar_wait(&empty[stg], ((g / STAGES) & 1) ^ 1);\n"
         "          pwait += clock64() - p1;\n"),
        (HDR, "      int g = 0;  // ring position: key tiles loaded so far, across items\n",
         "      int g = 0;  // ring position: key tiles loaded so far, across items\n"
         "      long long pwait = 0;\n"),
        (HDR, "      // every block's last fetch is done when the last block gets here",
         "      if (blockIdx.x == 0) a.lse[16] = (float)pwait;\n"
         "      // every block's last fetch is done when the last block gets here"),
    ],
    # diagnostic: p = S (no exponential at all)
    "diag_noexp": [(HDR, "    alpha[r] = ex2(m[r] - m_new);", "    alpha[r] = 1.f;"),
                   (HDR, "    sc[i] = ex2(sc[i] - m[(i >> 1) & 1]);", "")],
}


def start_build(name, patches, workdir, base=None):
    """Start nvcc on flash_fwd.cu and flash_grid_fwd.cu of a patched copy of
    ``base`` (default: the tree's csrc/); returns {source: (library path,
    process)}."""
    csrc = workdir / name / "csrc"
    if csrc.exists():
        shutil.rmtree(csrc)
    shutil.copytree(base or _build.CSRC, csrc)
    for fname, old, new in patches:
        text = (csrc / fname).read_text()
        if old not in text:
            raise SystemExit(f"variant {name}: patch text not found in {fname}: {old!r}")
        (csrc / fname).write_text(text.replace(old, new))
    nvcc = _build._nvcc()
    procs = {}
    for src in ("flash_fwd", "flash_grid_fwd"):
        lib = workdir / name / f"lib{src}.so"
        cmd = [nvcc, *_build.NVCC_FLAGS, "-o", str(lib), str(csrc / f"{src}.cu")]
        procs[src] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    return procs


def finish_build(name, procs):
    """{source: (library path, ptxas log)} once every nvcc of a variant is done."""
    out = {}
    for src, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for variant {name} {src}:\n{log}")
        out[src] = (lib, log)
    return out


def ptxas_summary(log):
    """(registers, spill bytes) of every main_kernel in a ptxas log."""
    lines, cur, out = log.splitlines(), None, []
    for ln in lines:
        if "Compiling entry function" in ln:
            cur = "main_kernel" in ln
        elif cur and "Used" in ln and "registers" in ln:
            out.append(int(ln.split("Used")[1].split("registers")[0]))
        elif cur and "spill stores" in ln:
            out.append(ln.split(",")[1].strip())
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--alt", action="append", default=[],
                    help="NAME=DIR: a variant built from another csrc copy as it is")
    ap.add_argument("--iters", type=int, default=10, help="timed calls a turn")
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--split", action="store_true",
                    help="also time three shapes that split a block's fixed cost from a tile's")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch

    from galvatron_tpu_torch.ops import flash_attention as fa

    smi = chip_smoke.phase_card(torch)
    names = [n for n in args.variants.split(",") if n]
    alts = dict(a.split("=", 1) for a in args.alt)
    workdir = _build.BUILD_DIR / "variants"
    libs, logs = {}, {}
    started = {}
    try:
        for name in names:
            started[name] = start_build(name, VARIANTS[name], workdir)
        for name, d in alts.items():
            started[name] = start_build(name, [], workdir, Path(d).resolve())
        names += list(alts)
        for name in names:
            built = finish_build(name, started[name])
            libs[name] = {src: ctypes.CDLL(str(lib)) for src, (lib, _) in built.items()}
            logs[name] = {src: ptxas_summary(log) for src, (_, log) in built.items()}
            print(json.dumps({"variant": name, "main_kernel_registers_spills": logs[name]}),
                  flush=True)
    finally:  # a failed patch or build leaves no compiler running
        for procs in started.values():
            for _, proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    shapes = {
        "grid gpt": ("grid", 8, 25, 1024, 64, True, False),
        "grid non-causal": ("grid", 8, 16, 512, 64, False, False),
        "flash main": ("blocked", 8, 32, 2048, 128, True, True),
    }
    if args.split:
        # non-causal grid shapes of equal tiles and twice the blocks (s256
        # against s512), and of equal blocks and twice the tiles (s1024
        # against s512): a block's fixed cost and a key tile's cost apart
        shapes |= {"nc s256 b16": ("grid", 16, 16, 256, 64, False, False),
                  "nc s512 b8": ("grid", 8, 16, 512, 64, False, False),
                  "nc s1024 b4": ("grid", 4, 16, 1024, 64, False, False)}
    cases = {}
    for label, (family, b, h, s, d, causal, stacked) in shapes.items():
        q, k, v, _, cos, sin = chip_smoke.flash_case(torch, torch.bfloat16, b, h, h, s, d, stacked,
                                                     seed=7)
        sm = 1.0 / math.sqrt(d)
        if family == "grid":
            call = lambda q=q, k=k, v=v, sm=sm, c=causal: fa.flash_grid_fwd(q, k, v, None, sm, c)  # noqa: E731
            ref = fa.flash_fwd_grid_plain(q, k, v, None, sm, causal)[0]
        else:
            call = lambda q=q, k=k, v=v, cos=cos, sin=sin, sm=sm: fa.flash_fwd(q, k, v, cos, sin, sm)  # noqa: E731
            ref = fa.flash_fwd_blocked_plain(q, k, v, cos, sin, sm)[0]
        cases[label] = (call, ref)
    times = {(n, label): [] for n in names for label in cases}
    excess = {}
    real_load = _build.load
    try:
        for rnd in range(args.rounds):
            for name in names if rnd % 2 == 0 else names[::-1]:
                _build.load = lambda src, name=name: libs[name][src]
                for label, (call, ref) in cases.items():
                    if rnd == 0:
                        out, lse = call()
                        torch.cuda.synchronize()
                        excess[name, label] = fa.bf16_parity_excess(out, ref)
                        if name == "diag_clock":
                            c = lse.flatten()[:17].tolist()
                            print(json.dumps({"variant": name, "shape": label, "cycles": {
                                f"wg{wg}": dict(zip(("wait_tile", "wait_turn", "s",
                                                     "softmax", "pv", "tiles", "loop"),
                                                    c[8 * wg:8 * wg + 7]))
                                for wg in (0, 1)} | {"producer_wait_stage": c[16]}}), flush=True)
                    times[name, label].append(
                        chip_smoke.time_ms(torch, call, flush, iters=args.iters))
    finally:
        _build.load = real_load
    results = []
    for (name, label), ms in times.items():
        ms = sorted(ms)
        line = {"variant": name, "shape": label, "median_ms": ms[len(ms) // 2],
                "min_ms": ms[0], "max_ms": ms[-1], "rounds": len(ms),
                "excess": excess[name, label], "tolerance": fa.BF16_PARITY_TOL["fwd"],
                "card": smi}
        print(json.dumps(line), flush=True)
        results.append(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"ptxas": logs, "runs": results}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
