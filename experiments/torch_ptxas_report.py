"""Registers, shared memory and spills of the port's CUDA kernels, as
``nvcc -Xptxas -v`` reports them, for one source built from one or more
copies of ``galvatron_tpu_torch/ops/csrc`` side by side (e.g. the tree's and
an older commit's, unpacked with ``git archive``). Builds with the flags of
``galvatron_tpu_torch/ops/_build.py`` into ``build/torch_kernels/ptxas/``;
needs the CUDA toolkit.

    python experiments/torch_ptxas_report.py --source flash_grid_bwd \\
        --csrc old/galvatron_tpu_torch/ops/csrc --csrc galvatron_tpu_torch/ops/csrc \\
        [--sass] [--out report.json]

Prints one line per kernel and copy: the registers, spill stores / loads
and static shared memory, keyed by the demangled kernel name. With
``--sass`` (``cuobjdump`` from the same toolkit) it also compares the
instructions: for each kernel of the first copy, the kernel of each other
copy whose SASS is the same instruction for instruction (addresses,
encodings and names left out, so a kernel that only gained a template
argument still matches), or null.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from galvatron_tpu_torch.ops import _build  # noqa: E402


def parse(log: str) -> dict:
    """{kernel: {"registers", "spill_stores", "spill_loads", "smem_bytes"}}
    from one ``-Xptxas -v`` log."""
    out, cur = {}, None
    demangle = shutil.which("c++filt")
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            cur = m.group(1)
            if demangle:
                cur = subprocess.run([demangle, cur], capture_output=True, text=True).stdout.strip()
            out[cur] = {}
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            out[cur].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out[cur]["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", ln)
            out[cur]["smem_bytes"] = int(s.group(1)) if s else 0
    return out


def sass(lib: Path) -> dict:
    """{demangled kernel: tuple of its SASS instructions} of one library,
    without addresses, encodings or the function's own name."""
    tool = Path(_build._nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    out, cur = {}, None
    demangle = shutil.which("c++filt")
    for ln in text.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            cur = m.group(1)
            if demangle:
                cur = subprocess.run([demangle, cur], capture_output=True, text=True).stdout.strip()
            out[cur] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;", ln)
        if cur is not None and m:
            out[cur].append(m.group(1))
    return {k: tuple(v) for k, v in out.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", default="flash_grid_bwd")
    ap.add_argument("--csrc", action="append", required=True,
                    help="a csrc directory; repeat to compare copies")
    ap.add_argument("--sass", action="store_true",
                    help="also match each kernel's instructions across the copies")
    ap.add_argument("--out", default=None, help="also write the report here as JSON")
    args = ap.parse_args()
    nvcc = _build._nvcc()
    dest = _build.BUILD_DIR / "ptxas"
    dest.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, d in enumerate(args.csrc):
        src = Path(d) / f"{args.source}.cu"
        cmd = [nvcc, *_build.NVCC_FLAGS, "-o", str(dest / f"lib{args.source}-{i}.so"), str(src)]
        procs[d] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    report = {}
    for d, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(f"nvcc failed for {d}:\n{log}", file=sys.stderr)
            return 1
        report[d] = parse(log)
    for d, kernels in report.items():
        for name, info in sorted(kernels.items()):
            print(json.dumps({"csrc": d, "kernel": name, **info}))
    if args.sass:
        codes = [sass(dest / f"lib{args.source}-{i}.so") for i in range(len(args.csrc))]
        same = {}
        for name, body in sorted(codes[0].items()):
            same[name] = [next((n for n, b in other.items() if b == body), None)
                          for other in codes[1:]]
            print(json.dumps({"kernel": name, "instructions": len(body),
                              "same_sass_in": dict(zip(args.csrc[1:], same[name]))}))
        report["same_sass"] = same
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
