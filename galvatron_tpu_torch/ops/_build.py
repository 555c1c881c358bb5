"""Build the port's CUDA sources with ``nvcc`` at first use, load with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface, ``build/torch_kernels/lib<name>-<hash>.so`` under the
repository root, for ``sm_90a``. The hash covers the source, the flags and
the compiler path, so an edited source never loads a stale library. Nothing
is built when the package is imported: the CPU has no ``nvcc`` and the CPU
path never asks for a kernel.

``build_all()`` starts one ``nvcc`` per source, all at once, and waits for
them; ``load(name)`` builds one source if needed and returns its
``ctypes.CDLL``. ``BUILD_LOG[name]`` keeps each build's seconds and the
``-Xptxas -v`` report (registers, shared memory, spills).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

BUILD_LOG: Dict[str, dict] = {}
_loaded: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def sources() -> List[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        "/usr/local/cuda/bin/nvcc",
        shutil.which("nvcc") or "",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (CUDA_HOME/bin, /usr/local/cuda/bin, PATH): the "
        "port's kernels are built from csrc/ on a machine with the CUDA toolkit"
    )


def _target(name: str, nvcc: str) -> Path:
    h = hashlib.sha256()
    h.update((CSRC / f"{name}.cu").read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(nvcc.encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Optional[List[str]] = None) -> Dict[str, dict]:
    """Compile every missing library among ``names`` (default: all
    sources), one ``nvcc`` process per source, all started together.
    Raises ``RuntimeError`` with the compiler's output if any fails."""
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names or sources():
        target = _target(name, nvcc)
        if target.exists():
            BUILD_LOG.setdefault(name, {"seconds": 0.0, "ptxas": "(cached)", "path": str(target)})
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), time.perf_counter(), tmp, target)
    failed = []
    for name, (proc, t0, tmp, target) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOG[name] = {"seconds": time.perf_counter() - t0, "ptxas": log.strip(),
                           "path": str(target)}
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, target)  # atomic: a concurrent loader never sees half a file
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return BUILD_LOG


def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu`` (building it first if
    needed), loaded once per process."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            target = _target(name, _nvcc())
            if not target.exists():
                build_all([name])
            lib = _loaded[name] = ctypes.CDLL(str(target))
        return lib
