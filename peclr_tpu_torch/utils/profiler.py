"""Profiling and throughput instrumentation (port of
peclr_tpu/utils/profiler.py).

* `trace(logdir)`: a torch.profiler capture of the CPU and, where there is
  one, the card, yielded and written as a Chrome trace to `logdir` ("" for
  none; no capture at all when None).  The trace holds the program's
  spans (below) beside torch's ops and the card's kernels.
* `span(name)`: the program's own span around a phase of its work, a
  torch.profiler user annotation while a capture is active (so it lands in
  the capture beside the card's kernels, on the profiler's clock, and in
  `trace`'s Chrome trace), else one shared no-op context manager.  Names
  are `<kind>.<phase>` (`pretrain.backward`, `warp.shift`, `pred.h2d`) and
  never hold `::`, which marks torch's own ops in a trace.
* `count(name, n)` / `counters()`: process-wide totals, added to only while
  a capture is active (`pinned_bytes`: host memory pinned anew).
* `Throughput`: images/s and an EMA of the step time, first steps skipped.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Dict, Optional

import torch
from torch.autograd import profiler as _autograd_profiler
from torch.profiler import record_function

#: what span() gives outside a capture: reusable, and re-entrant
_NO_SPAN = contextlib.nullcontext()
_counters: Dict[str, int] = {}
_counters_lock = threading.Lock()


def span(name: str):
    """A context manager that records `name` as a span of the capture that
    is active, if any: torch.profiler.record_function(name) then, else the
    shared no-op (one test of the profiler's process-wide flag)."""
    if _autograd_profiler._is_profiler_enabled:
        return record_function(name)
    return _NO_SPAN


def count(name: str, n: int) -> None:
    """Add n to the counter `name` while a capture is active."""
    if _autograd_profiler._is_profiler_enabled:
        with _counters_lock:
            _counters[name] = _counters.get(name, 0) + n


def counters() -> Dict[str, int]:
    """The counters' totals so far in this process, a copy."""
    with _counters_lock:
        return dict(_counters)


@contextlib.contextmanager
def trace(logdir: Optional[str]):
    """Capture a torch.profiler trace, yield its profile, and write it to
    `logdir`/trace_<time>.json where `logdir` is not ""."""
    if logdir is None:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    if logdir:
        os.makedirs(logdir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(
            logdir, f"trace_{time.strftime('%Y%m%d_%H%M%S')}.json"))


class Throughput:
    """Step-time / images-per-second meter with warmup skip."""

    def __init__(self, warmup_steps: int = 2, ema: float = 0.9):
        self.warmup = warmup_steps
        self.ema = ema
        self.step_time: Optional[float] = None
        self.total_images = 0
        self.total_time = 0.0
        self._count = 0
        self._last: Optional[float] = None

    def tick(self, images: int):
        """Call once per completed step with the images it consumed."""
        now = time.perf_counter()
        if self._last is not None:
            dt = now - self._last
            self._count += 1
            if self._count > self.warmup:
                self.step_time = (
                    dt if self.step_time is None
                    else self.ema * self.step_time + (1 - self.ema) * dt
                )
                self.total_images += images
                self.total_time += dt
        self._last = now

    @property
    def images_per_sec(self) -> Optional[float]:
        if self.total_time <= 0:
            return None
        return self.total_images / self.total_time

    def report(self) -> dict:
        out = {}
        if self.step_time is not None:
            out["step_time_s"] = self.step_time
        if self.images_per_sec is not None:
            out["images_per_sec"] = self.images_per_sec
        return out
