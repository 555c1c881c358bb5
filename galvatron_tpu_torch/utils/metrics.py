"""The JSONL metrics sink, thread-safe serving counters, a mergeable
latency histogram and a quantile window (the port's copy of
``galvatron_tpu/utils/metrics.py``'s ``MetricsLogger``, ``Counters``,
``Histogram`` and ``QuantileWindow``, on plain ``threading`` locks)."""

from __future__ import annotations

import json
import os
import threading
import time
import warnings
from typing import Any, Dict, Optional

#: version stamped as a ``schema`` field on versioned JSONL records
#: (``train_iter``); readers tolerate higher versions and extra fields
SCHEMA_VERSION = 1


class MetricsLogger:
    """Append-only JSONL metrics writer; no-op when ``path`` is None. One
    flat JSON object per event with a wall-clock timestamp. Opened in append
    mode, so a rerun appends after the previous records; a torn final line
    from a crash is repaired (or dropped, with a warning) before appending."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._f = None
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            _repair_torn_tail(path)
            self._f = open(path, "a")

    def log(self, event: str, step: Optional[int] = None, **fields: Any) -> Dict[str, Any]:
        rec: Dict[str, Any] = {"event": event, "ts": time.time()}
        if step is not None:
            rec["step"] = int(step)
        for k, v in fields.items():
            if hasattr(v, "item"):  # 0-d tensors / numpy scalars
                v = v.item()
            if not isinstance(v, (int, float, str, bool, type(None))):
                raise TypeError(f"metric {k!r} must be scalar, got {type(v).__name__}")
            rec[k] = v
        if self._f is not None:
            self._f.write(json.dumps(rec) + "\n")
            self._f.flush()
        return rec

    def close(self):
        if self._f is not None:
            self._f.flush()
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _repair_torn_tail(path: str) -> None:
    """A crash mid-write can leave a final line with no newline: a tail
    that parses as a record gets its newline, an unparseable one (a partial
    record) is truncated away with a warning."""
    try:
        size = os.path.getsize(path)
    except OSError:
        return
    if size == 0:
        return
    with open(path, "rb+") as f:
        window = min(size, 1 << 20)
        f.seek(size - window)
        data = f.read(window)
        if data.endswith(b"\n"):
            return
        nl = data.rfind(b"\n")
        tail = data[nl + 1:]
        if nl < 0 and window < size:
            f.write(b"\n")
            return
        try:
            json.loads(tail)
            f.write(b"\n")
            return
        except ValueError:
            pass
        warnings.warn(f"{path}: dropping torn final JSONL record before appending: {tail[:80]!r}")
        f.truncate(size - len(tail))


def read_metrics(path: str):
    """The records of a JSONL metrics file (a torn final line is skipped)."""
    out = []
    with open(path) as f:
        lines = f.read().splitlines()
    for i, line in enumerate(lines):
        if not line.strip():
            continue
        try:
            out.append(json.loads(line))
        except ValueError:
            if i == len(lines) - 1:
                continue
            raise
    return out


class Counters:
    """Thread-safe named integer counters."""

    def __init__(self, *names: str):
        self._lock = threading.Lock()
        self._c: Dict[str, int] = {n: 0 for n in names}  # guarded-by: self._lock

    def inc(self, name: str, n: int = 1) -> int:
        with self._lock:
            self._c[name] = self._c.get(name, 0) + n
            return self._c[name]

    def get(self, name: str) -> int:
        with self._lock:
            return self._c.get(name, 0)

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._c)


#: default latency bucket bounds (seconds) for the TTFT and e2e histograms
DEFAULT_LATENCY_BUCKETS = (
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
)


class Histogram:
    """Fixed-bucket cumulative histogram (Prometheus semantics): snapshots
    of two replicas merge by adding per-bucket counts."""

    def __init__(self, buckets=DEFAULT_LATENCY_BUCKETS):
        bs = sorted(float(b) for b in buckets)
        if not bs:
            raise ValueError("Histogram needs at least one bucket bound")
        self.buckets = tuple(bs)
        self._lock = threading.Lock()
        self._counts = [0] * len(bs)  # guarded-by: self._lock — per-bucket counts
        self._overflow = 0            # guarded-by: self._lock — above the last bound
        self._sum = 0.0               # guarded-by: self._lock
        self._count = 0               # guarded-by: self._lock

    def observe(self, x: float) -> None:
        x = float(x)
        with self._lock:
            self._sum += x
            self._count += 1
            for i, b in enumerate(self.buckets):
                if x <= b:
                    self._counts[i] += 1
                    return
            self._overflow += 1

    def snapshot(self) -> Dict[str, Any]:
        """``buckets`` maps each upper bound (as str) to its CUMULATIVE
        count; ``+Inf`` is always present and equals ``count``."""
        with self._lock:
            counts = list(self._counts)
            overflow = self._overflow
            total = self._count
            s = self._sum
        out: Dict[str, Any] = {"sum": s, "count": total, "buckets": {}}
        cum = 0
        for b, c in zip(self.buckets, counts):
            cum += c
            out["buckets"][repr(b)] = cum
        out["buckets"]["+Inf"] = cum + overflow
        return out


class QuantileWindow:
    """Fixed-size ring of float samples with quantile readout (TTFT
    p50/p95 over the last N requests); sorting happens only at read time."""

    def __init__(self, size: int = 512):
        self.size = max(1, size)
        self._lock = threading.Lock()
        self._buf: list = []  # guarded-by: self._lock
        self._i = 0           # guarded-by: self._lock
        self._n = 0           # guarded-by: self._lock

    def add(self, x: float) -> None:
        with self._lock:
            if len(self._buf) < self.size:
                self._buf.append(float(x))
            else:
                self._buf[self._i] = float(x)
            self._i = (self._i + 1) % self.size
            self._n += 1

    def quantile(self, q: float) -> Optional[float]:
        with self._lock:
            buf = list(self._buf)
        if not buf:
            return None
        buf.sort()
        idx = min(len(buf) - 1, max(0, int(round(q * (len(buf) - 1)))))
        return buf[idx]

    def summary(self) -> Dict[str, Any]:
        with self._lock:
            n = self._n
        return {"n": n, "p50": self.quantile(0.5), "p95": self.quantile(0.95)}
