"""Profiling and throughput instrumentation (port of
peclr_tpu/utils/profiler.py).

* `trace(logdir)`: a torch.profiler capture of the CPU and, where there is
  one, the card, yielded and written as a Chrome trace to `logdir` ("" for
  none; no capture at all when None).
* `Throughput`: images/s and an EMA of the step time, first steps skipped.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional


@contextlib.contextmanager
def trace(logdir: Optional[str]):
    """Capture a torch.profiler trace, yield its profile, and write it to
    `logdir`/trace_<time>.json where `logdir` is not ""."""
    if logdir is None:
        yield None
        return
    import torch
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
