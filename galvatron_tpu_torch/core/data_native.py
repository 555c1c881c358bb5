"""Deterministic seed mixing and epoch permutations (the port's copy of the
numpy parts of ``galvatron_tpu/core/data_native.py``).

The reference also builds a native helper with g++ for the permutation;
its numpy path computes the identical permutation (stable argsort of
splitmix64(seed ^ i)), so the port keeps only that.
"""

from __future__ import annotations

import numpy as np


def _splitmix64_np(x: np.ndarray) -> np.ndarray:
    z = (x + np.uint64(0x9E3779B97F4A7C15)).astype(np.uint64)
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


def mix_seed(*vals: int) -> int:
    """Collision-resistant combine of integer seed components via a
    splitmix64 chain (``(seed, epoch)`` pairs never alias)."""
    h = np.uint64(0x9E3779B97F4A7C15)
    with np.errstate(over="ignore"):
        for v in vals:
            h = _splitmix64_np(h ^ np.uint64(int(v) % (1 << 64)))
    return int(h)


def shuffle_index(n: int, seed: int) -> np.ndarray:
    """Deterministic permutation of [0, n): stable argsort of
    splitmix64(seed ^ i)."""
    with np.errstate(over="ignore"):
        keys = _splitmix64_np(np.uint64(seed) ^ np.arange(n, dtype=np.uint64))
    return np.argsort(keys, kind="stable").astype(np.int64)
