"""Phase timers and an optional profiler trace for the vid2vid loop.

Counterpart of `controlanimate_tpu/utils/profiling.py`: named wall-clock
timers on the host clock (each phase also a `torch.profiler.record_function`
range, the counterpart of jax's `TraceAnnotation`), and `maybe_trace`, which
records a `torch.profiler` trace into `trace_dir` when one is given and does
nothing otherwise. A host-clock phase that ends without a synchronise times
the enqueue of device work, not the work.
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
from collections import defaultdict
from pathlib import Path
from typing import Optional

import torch


class PhaseTimers:
    """Accumulating named wall-clock timers with JSON export. Thread-safe:
    the loop times phases from the main thread, the prefetch worker and the
    checkpoint worker."""

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def phase(self, name: str):
        with torch.profiler.record_function(name):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                dt = time.perf_counter() - t0
                with self._lock:
                    self.totals[name] += dt
                    self.counts[name] += 1

    def summary(self) -> dict:
        return {
            name: {
                "total_s": round(self.totals[name], 4),
                "count": self.counts[name],
                "mean_ms": round(1000 * self.totals[name] / max(self.counts[name], 1), 2),
            }
            for name in sorted(self.totals)
        }

    def dump(self, path: str | Path) -> None:
        Path(path).write_text(json.dumps(self.summary(), indent=2))


@contextlib.contextmanager
def maybe_trace(trace_dir: Optional[str]):
    """Record a `torch.profiler` trace (CPU, and CUDA when a card is present)
    into `trace_dir` as a Chrome trace, when a directory is given."""
    if not trace_dir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    out = Path(trace_dir)
    out.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(str(out / f"trace_{int(time.time())}.json"))
