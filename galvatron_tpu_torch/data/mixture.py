"""Deterministic weighted mixture sampling over N corpora (the port's copy
of ``galvatron_tpu/data/mixture.py``: the same sample order for the same
seed).

The mixture is **position-addressable**: which source serves global sample
position ``k``, and the source-local index it serves, are pure functions of
``(weights, seed, k)`` — no consumed-state drift, no RNG stream to replay.
That is exactly the contract the sample-domain resume cursor needs (the
trainer converts a checkpoint's ``samples_consumed`` across batch-size
changes by integer arithmetic): a resumed run at any batch size reconstructs
per-source consumption at position ``k`` by counting the assignment prefix,
so zero samples are replayed and zero are skipped per source.

Assignment rule (Megatron blended-dataset style, error-feedback greedy):
position ``k`` goes to the source maximizing ``w_s·(k+1) − c_s(k)`` where
``c_s(k)`` is how many of the first ``k`` positions source ``s`` already
received. The realized ratio error is bounded by 1 sample per source at every
prefix — mixture ratios hold at any cut, not just in expectation. ``seed``
rotates the tie-break/startup phase (a fractional initial credit per source)
so different seeds interleave differently while keeping the bound.

Within a source, local index ``j`` maps through a per-epoch permutation
seeded by ``(seed, source, epoch)`` (``core/data_native.shuffle_index`` —
bit-stable across native/numpy builds), with ``epoch = j // len(source)``.
"""

from __future__ import annotations

import json
import os
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from galvatron_tpu_torch.core.data_native import mix_seed, shuffle_index


@dataclass(frozen=True)
class MixtureSource:
    name: str
    prefix: str
    weight: float


def parse_mixture(spec: str) -> List[MixtureSource]:
    """``--data_mixture`` forms: a JSON file (``{"sources": [{"name",
    "prefix", "weight"}, ...]}``) or an inline ``prefix=weight,prefix=weight``
    list (names default to the prefix basename)."""
    if os.path.exists(spec):
        with open(spec) as f:
            doc = json.load(f)
        srcs = doc.get("sources") if isinstance(doc, dict) else None
        if not isinstance(srcs, list) or not srcs:
            raise ValueError(
                f"{spec}: expected {{'sources': [{{'name','prefix','weight'}}, ...]}}"
            )
        out = []
        for i, s in enumerate(srcs):
            if not isinstance(s, dict) or "prefix" not in s:
                raise ValueError(f"{spec}: sources[{i}] needs at least a 'prefix'")
            out.append(
                MixtureSource(
                    name=str(s.get("name", os.path.basename(str(s["prefix"])))),
                    prefix=str(s["prefix"]),
                    weight=float(s.get("weight", 1.0)),
                )
            )
    else:
        out = []
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            if "=" in part:
                prefix, w = part.rsplit("=", 1)
                out.append(
                    MixtureSource(os.path.basename(prefix), prefix, float(w))
                )
            else:
                out.append(MixtureSource(os.path.basename(part), part, 1.0))
        if not out:
            raise ValueError(f"--data_mixture {spec!r}: no sources parsed")
    names = [s.name for s in out]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate mixture source names: {names}")
    total = sum(s.weight for s in out)
    if total <= 0 or any(s.weight < 0 for s in out):
        raise ValueError("mixture weights must be non-negative with a positive sum")
    return out


class MixtureSchedule:
    """Deterministic source-assignment sequence with BOUNDED memory.

    The greedy recurrence is inherently sequential, so the schedule keeps
    per-chunk STATE SNAPSHOTS (the (credit, counts) vectors every ``_CHUNK``
    positions — a few dozen bytes per snapshot) instead of materializing the
    assignment array: any chunk is recomputed exactly from its snapshot on
    demand (small LRU of decoded chunks for the sequential access pattern).
    Memory is O(k/_CHUNK · n_sources); a cold query at position k still pays
    one O(k) sequential replay to extend the snapshots (~1-5 M positions/s in
    pure Python — fine for realistic cursors; a closed-form WFQ/virtual-time
    formulation is the upgrade path if corpora ever reach 1e9+ samples).

    ``counts_at(k)`` recounts from the snapshots + one partial chunk — the
    resume-verification primitive, never a mutable counter. Thread-safe: the
    trainer's watchdog / save paths may query from another thread."""

    _CHUNK = 4096
    _CACHE = 8

    def __init__(self, weights: Sequence[float], seed: int = 1234):
        w = np.asarray(weights, np.float64)
        if w.ndim != 1 or len(w) == 0 or w.sum() <= 0 or (w < 0).any():
            raise ValueError(f"bad mixture weights {weights}")
        self.weights = w / w.sum()
        self.seed = seed
        self._lock = threading.Lock()
        n = len(self.weights)
        # seeded fractional startup credit: rotates which source leads the
        # interleave without affecting the ±1-per-source ratio bound
        jitter = np.array(
            [(mix_seed(seed, 0x5EED, s) % (1 << 20)) / float(1 << 20) for s in range(n)]
        )
        # snapshot i = exact (credit, counts) state entering position i·_CHUNK
        self._snaps: List[Tuple[List[float], List[int]]] = [
            (list(self.weights * jitter), [0] * n)
        ]
        self._chunk_cache: Dict[int, Tuple[List[int], List[int]]] = {}

    def _run_chunk(self, state, steps: int):
        """Advance ``steps`` positions from ``state`` (mutated in place),
        returning (per-position source ids, per-position source-local
        indices). Pure-Python inner loop: n_sources is small, and list ops
        beat numpy dispatch overhead at this grain."""
        credit, counts = state
        w = list(self.weights)
        n = len(w)
        src: List[int] = []
        local: List[int] = []
        for _ in range(steps):
            best, best_v = 0, credit[0] + w[0] - counts[0]
            for s in range(1, n):
                v = credit[s] + w[s] - counts[s]
                if v > best_v:
                    best, best_v = s, v
            for s in range(n):
                credit[s] += w[s]
            src.append(best)
            local.append(counts[best])
            counts[best] += 1
        return src, local

    def _ensure_snaps(self, chunk: int) -> None:
        while len(self._snaps) <= chunk:
            credit, counts = self._snaps[-1]
            state = (list(credit), list(counts))
            src, local = self._run_chunk(state, self._CHUNK)
            ci = len(self._snaps) - 1
            self._chunk_cache[ci] = (src, local)
            self._snaps.append(state)
            self._trim_cache()

    def _chunk(self, ci: int):
        self._ensure_snaps(ci + 1)
        got = self._chunk_cache.get(ci)
        if got is None:
            credit, counts = self._snaps[ci]
            got = self._run_chunk((list(credit), list(counts)), self._CHUNK)
            self._chunk_cache[ci] = got
            self._trim_cache()
        return got

    def _trim_cache(self) -> None:
        while len(self._chunk_cache) > self._CACHE:
            self._chunk_cache.pop(next(iter(self._chunk_cache)))

    def assignment(self, k: int) -> Tuple[int, int]:
        """Global position ``k`` → (source id, source-local index)."""
        with self._lock:
            ci, off = divmod(k, self._CHUNK)
            src, local = self._chunk(ci)
            return src[off], local[off]

    def counts_at(self, k: int) -> np.ndarray:
        """Per-source consumption over positions ``[0, k)`` — derived from
        the snapshot lattice + one partial chunk replay, never from mutable
        counters."""
        with self._lock:
            ci, off = divmod(k, self._CHUNK)
            self._ensure_snaps(ci)
            credit, counts = self._snaps[ci]
            if off == 0:
                return np.asarray(counts, np.int64)
            state = (list(credit), list(counts))
            self._run_chunk(state, off)
            return np.asarray(state[1], np.int64)


class MixtureDataset:
    """Weighted mixture of position-addressable sample streams.

    ``datasets[s]`` must expose ``num_samples`` and ``sample(i) -> np.ndarray``
    rows of one common width (all packed, or all windowed — never mixed).
    ``sample(k)`` resolves the global position through the schedule, then
    through the source's per-epoch permutation: pure in ``k``."""

    def __init__(self, names: Sequence[str], datasets: Sequence, weights: Sequence[float], seed: int = 1234):
        if not (len(names) == len(datasets) == len(weights)):
            raise ValueError("names/datasets/weights length mismatch")
        widths = {int(ds.sample(0).shape[0]) for ds in datasets}
        if len(widths) != 1:
            raise ValueError(
                f"mixture sources yield different row widths {sorted(widths)} — "
                "all sources must be packed, or all windowed, at one seq_len"
            )
        self.names = list(names)
        self.datasets = list(datasets)
        self.seed = seed
        self.schedule = MixtureSchedule(weights, seed=seed)
        self.row_width = widths.pop()
        self._perm_cache: Dict[Tuple[int, int], np.ndarray] = {}
        self._perm_lock = threading.Lock()

    @property
    def num_sources(self) -> int:
        return len(self.datasets)

    def _perm(self, s: int, epoch: int) -> np.ndarray:
        with self._perm_lock:
            key = (s, epoch)
            p = self._perm_cache.get(key)
            if p is None:
                p = shuffle_index(
                    self.datasets[s].num_samples, mix_seed(self.seed, s, epoch)
                )
                # bounded cache: sources wrap epochs at different rates; keep
                # the recent working set only
                if len(self._perm_cache) > 4 * len(self.datasets):
                    self._perm_cache.clear()
                self._perm_cache[key] = p
            return p

    def sample(self, k: int) -> np.ndarray:
        s, j = self.schedule.assignment(k)
        n = self.datasets[s].num_samples
        epoch, r = divmod(j, n)
        return self.datasets[s].sample(int(self._perm(s, epoch)[r]))

    def counts_at(self, k: int) -> Dict[str, int]:
        c = self.schedule.counts_at(k)
        return {name: int(c[i]) for i, name in enumerate(self.names)}

    def state_at(self, k: int) -> dict:
        """Checkpoint-meta record: the cursor in the sample domain plus the
        per-source consumption it implies (derived, so a restored record can
        be VERIFIED against a recount — see DataPipeline.verify_resume)."""
        return {
            "position": int(k),
            "per_source_consumed": self.counts_at(k),
            "weights": {n: float(w) for n, w in zip(self.names, self.schedule.weights)},
        }


class SingleSourceDataset(MixtureDataset):
    """One corpus behind the mixture interface — the degenerate mixture, so
    the pipeline/state/resume machinery has exactly one code path."""

    def __init__(self, name: str, dataset, seed: int = 1234):
        super().__init__([name], [dataset], [1.0], seed=seed)
