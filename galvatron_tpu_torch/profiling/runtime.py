"""Runtime profiler: per-iteration time and memory during real training
(the port's counterpart of ``galvatron_tpu/profiling/runtime.py``; reference:
galvatron/core/profiler.py:88-191, CUDA allocator snapshots and CUDA-event
timing).

On the card a window is timed with two ``torch.cuda.Event`` records and one
synchronise at its end; on the CPU with the host clock around work whose
result was read back. Also hosts the cost model's fidelity report:
predicted against measured iteration time and memory.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch


def _float(v) -> None:
    """Read a tensor back (a host synchronisation on the card)."""
    if v is not None:
        float(v)


@dataclass
class RuntimeProfiler:
    """Two timing modes:

    - per-iter (``windowed=False``): synchronises every iteration (pass the
      loss to ``end_iter``); exact per-iteration times that include the
      host's wait for the device.
    - windowed (``windowed=True``): the iterations after ``warmup_iters``
      are queued freely; the window opens with an event (card) or a
      synchronised clock read (CPU) at the end of the warm-up and closes in
      ``finish`` with one synchronise; avg = window / iterations.
    """

    warmup_iters: int = 2
    windowed: bool = False
    device: Optional[torch.device] = None
    iter_times_ms: List[float] = field(default_factory=list)
    _t0: Optional[float] = None
    _iter: int = 0
    _window_t0: Optional[float] = None
    _window_ev: Optional[torch.cuda.Event] = None
    _window_iters: int = 0

    @property
    def _on_card(self) -> bool:
        return self.device is not None and torch.device(self.device).type == "cuda"

    def begin_iter(self):
        self._t0 = time.perf_counter()

    def end_iter(self, sync_value=None):
        """Per-iter mode: pass a device scalar (e.g. the loss) to wait for
        the step. Windowed mode: waits only to close the warm-up."""
        self._iter += 1
        if self.windowed:
            if self._iter == self.warmup_iters:
                _float(sync_value)
                if self._on_card:
                    self._window_ev = torch.cuda.Event(enable_timing=True)
                    self._window_ev.record()
                self._window_t0 = time.perf_counter()
            elif self._iter > self.warmup_iters:
                self._window_iters += 1
            return
        _float(sync_value)
        if self._on_card:
            torch.cuda.synchronize(self.device)
        dt = (time.perf_counter() - self._t0) * 1000.0
        if self._iter > self.warmup_iters:
            self.iter_times_ms.append(dt)

    def finish(self, sync_value=None):
        """Close the measurement window (windowed mode; no-op otherwise)."""
        if not self.windowed or self._window_t0 is None or self._window_iters == 0:
            return
        _float(sync_value)
        if self._window_ev is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            end.synchronize()
            window_ms = self._window_ev.elapsed_time(end)
        else:
            window_ms = (time.perf_counter() - self._window_t0) * 1000.0
        self.iter_times_ms = [window_ms / self._window_iters] * self._window_iters
        self._window_t0 = self._window_ev = None

    @property
    def avg_iter_ms(self) -> float:
        return float(np.mean(self.iter_times_ms)) if self.iter_times_ms else float("nan")

    def throughput(self, global_bsz: int, seq_len: int) -> Dict[str, float]:
        ms = self.avg_iter_ms
        return {
            "iter_ms": ms,
            "samples_per_s": global_bsz / (ms / 1000.0),
            "tokens_per_s": global_bsz * seq_len / (ms / 1000.0),
        }

    def memory_stats(self) -> Dict[str, float]:
        """The card's allocator: bytes held now and the peak, in MB (1e6
        bytes); empty on the CPU."""
        if not self._on_card:
            return {}
        d = torch.device(self.device)
        return {
            f"dev{d.index or 0}_bytes_in_use_mb": torch.cuda.memory_allocated(d) / 1e6,
            f"dev{d.index or 0}_peak_bytes_mb": torch.cuda.max_memory_allocated(d) / 1e6,
        }

    def report(self, global_bsz: int, seq_len: int, predicted_ms: Optional[float] = None,
               predicted_mb: Optional[float] = None, step_stats=None) -> str:
        tp = self.throughput(global_bsz, seq_len)
        lines = [
            f"avg iter: {tp['iter_ms']:.2f} ms | "
            f"{tp['samples_per_s']:.2f} samples/s | {tp['tokens_per_s']:.0f} tokens/s"
        ]
        if step_stats is not None and np.isfinite(tp["iter_ms"]):
            st = step_stats.per_iter(tp["iter_ms"])
            if st["tflops_per_device"] is not None:
                line = f"achieved {st['tflops_per_device']:.2f} TFLOP/s/device"
                if st["mfu"] is not None:
                    line += f" | MFU {st['mfu'] * 100:.1f}% | HFU {st['hfu'] * 100:.1f}%"
                lines.append(line)
        if predicted_ms is not None and np.isfinite(tp["iter_ms"]):
            lines.append(
                f"cost-model fidelity: predicted {predicted_ms:.4g} ms / measured "
                f"{tp['iter_ms']:.4g} ms = {predicted_ms / tp['iter_ms']:.3f}"
            )
        mem = self.memory_stats()
        if mem:
            peak = max(v for k, v in mem.items() if "peak" in k)
            line = f"peak memory: {peak:.0f} MB"
            if predicted_mb is not None:
                line += (f" | predicted {predicted_mb:.0f} MB = "
                         f"{predicted_mb / max(peak, 1e-9):.3f} of measured")
            lines.append(line)
        return "\n".join(lines)
