"""Registers, shared memory and spills of the port's CUDA kernels, as
``nvcc -Xptxas -v`` reports them, for one source built from one or more
copies of ``galvatron_tpu_torch/ops/csrc`` side by side (e.g. the tree's and
an older commit's, unpacked with ``git archive``). Builds with the flags of
``galvatron_tpu_torch/ops/_build.py`` into ``build/torch_kernels/ptxas/``;
needs the CUDA toolkit.

    python experiments/torch_ptxas_report.py --source flash_grid_bwd \\
        --csrc old/galvatron_tpu_torch/ops/csrc --csrc galvatron_tpu_torch/ops/csrc \\
        [--out report.json]

Prints one line per kernel and copy: the registers, spill stores / loads
and static shared memory, keyed by the demangled kernel name.
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", default="flash_grid_bwd")
    ap.add_argument("--csrc", action="append", required=True,
                    help="a csrc directory; repeat to compare copies")
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
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
