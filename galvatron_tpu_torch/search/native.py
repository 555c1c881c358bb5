"""The C++ DP core of the strategy search (``search/csrc/dp_core.cpp``, a
copy of the JAX package's ``csrc/dp_core.cpp``), built and bound the way the
JAX package's ``search/native.py`` does it: ``g++ -O3 -shared -fPIC`` at
first use, loaded with ctypes.

The library lands in ``build/torch_kernels/libdp_core-<hash>.so`` under the
repository root (the hash covers the source and the compiler), never in the
JAX package's ``build/libgalvatron_dp_core.so``. Where no ``g++`` builds it,
``dynamic_programming.run_dp`` takes the NumPy DP of the same semantics;
:data:`ROUTE` records which of the two ran last (``"native"`` or
``"numpy"``) and ``cli search`` prints it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np

_SRC = Path(__file__).resolve().parent / "csrc" / "dp_core.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

#: the route of the last DP: "native" (the C++ core) or "numpy"; None before any
ROUTE: Optional[str] = None
#: why the C++ core is unavailable, when it is
BUILD_ERROR: Optional[str] = None

_lib: Optional[ctypes.CDLL] = None
_load_failed = False


def _target(gxx: str) -> Path:
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join((gxx,) + _FLAGS).encode())
    return _BUILD_DIR / f"libdp_core-{h.hexdigest()[:16]}.so"


def _build(gxx: str, so: Path) -> None:
    """Compile into a temporary file and rename it into place, so that
    processes building at once never load a half-written library."""
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run([gxx, *_FLAGS, str(_SRC), "-o", tmp], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def get_dp_core() -> Optional[ctypes.CDLL]:
    """The loaded library, or None when it cannot be built or loaded
    (:data:`BUILD_ERROR` says why)."""
    global _lib, _load_failed, BUILD_ERROR
    if _lib is not None or _load_failed:
        return _lib
    gxx = shutil.which("g++")
    try:
        if gxx is None:
            raise FileNotFoundError("g++ not found on PATH")
        so = _target(gxx)
        if not so.exists():
            _build(gxx, so)
        lib = ctypes.CDLL(str(so))
    except (OSError, subprocess.SubprocessError) as e:
        _load_failed = True
        BUILD_ERROR = f"{type(e).__name__}: {str(e)[:200]}"
        return None
    lib.galvatron_dp_core.restype = ctypes.c_double
    lib.galvatron_dp_core.argtypes = [
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        ctypes.POINTER(ctypes.c_int32),
    ]
    _lib = lib
    return _lib


def dp_core_native(mem: np.ndarray, intra: np.ndarray, inter: np.ndarray, budget: int):
    """Run the native DP. mem: (L,S) int32 units; intra: (L,S); inter: (S,S).
    Returns (min_cost, res[L], mem_used) or None if the library is missing."""
    lib = get_dp_core()
    if lib is None:
        return None
    L, S = mem.shape
    if intra.shape != (L, S) or inter.shape != (S, S):
        raise ValueError(f"DP shapes disagree: mem {mem.shape}, intra {intra.shape}, "
                         f"inter {inter.shape}")
    res = np.full((L,), -1, np.int32)
    mem_used = ctypes.c_int32(0)
    cost = lib.galvatron_dp_core(
        np.int32(L), np.int32(budget), np.int32(S),
        np.ascontiguousarray(mem, np.int32),
        np.ascontiguousarray(intra, np.float64),
        np.ascontiguousarray(inter, np.float64),
        res, ctypes.byref(mem_used),
    )
    return float(cost), res, int(mem_used.value)
