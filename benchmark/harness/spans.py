"""The program's own spans and counters in a live torch.profiler capture
(peclr_tpu_torch/utils/profiler.py: `span`, `count`), and what the card did
inside each span.

A program span is a host user annotation whose name begins with one of
PREFIXES.  Each device event of the capture (trace.py's list: kernels,
copies and sets, the user annotations left out) is credited to the
innermost program span that was open on the host when the call that
launched it ran.  The event and its launch (a call of the CUDA API)
share a correlation id; the launch's host time is looked up among the
spans of every thread, since autograd launches the backward's kernels from
a thread of its own.  Each idle interval of the card (the capture's extent
less the union of its events) is split among the innermost program spans
open on the host over it.  Nothing here reads a kernel's name or its
device time to decide where it belongs.

A capture of a program without spans gives no spans, and every total 0.
A run of the benchmark does not call `read`: trace.py:profile, frozen,
keeps its capture to itself.  benchmark/phases.py takes a capture of its
own and reads it here; the readers under metrics/ read only the counters.
"""

from __future__ import annotations

import bisect
import re
from typing import Dict, Iterable, List, NamedTuple, Tuple

#: the kinds of the program's span names (`<kind>.<phase>`)
PREFIXES = ("pretrain.", "finetune.", "warp.", "pred.")
#: the host calls that launch device work: the CUDA runtime API's
#: (cuda...) and the lower-level API's (cu...), whose names have no namespace
_LAUNCH = re.compile(r"cu(da)?[A-Z]")


class HostSpan(NamedTuple):
    name: str
    start_us: float
    end_us: float


class DeviceEvent(NamedTuple):
    start_us: float
    end_us: float
    #: the correlation id it shares with the call that launched it
    correlation: int


def events_of_profile(prof) -> tuple:
    """(program spans, {correlation id: host start of the launch call},
    device events, (first, last) µs of the capture) of a live
    torch.profiler.profile."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    spans: List[HostSpan] = []
    launches: Dict[int, float] = {}
    device: List[DeviceEvent] = []
    t0, t1 = float("inf"), float("-inf")
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() / 1e3
        end = start + e.duration_ns() / 1e3
        annotation = e.is_user_annotation()
        if e.device_type() == cuda:
            if annotation:
                continue
            device.append(DeviceEvent(start, end, e.correlation_id()))
        else:
            name = e.name()
            if annotation:
                if name.startswith(PREFIXES):
                    spans.append(HostSpan(name, start, end))
            elif _LAUNCH.match(name):
                launches[e.correlation_id()] = start
        t0, t1 = min(t0, start), max(t1, end)
    return spans, launches, device, (t0, t1)


class Timeline:
    """The host's timeline cut at every span's edges: over each piece, the
    innermost open span (the latest started; of those, the shortest)."""

    def __init__(self, spans: List[HostSpan]):
        points = sorted([(s.end_us, 0, i) for i, s in enumerate(spans)]
                        + [(s.start_us, 1, i) for i, s in enumerate(spans)])
        active: set = set()
        self.starts: List[float] = []
        self.owners: List[int] = []
        for t, opens, i in points:  # at one time, ends before starts
            (active.add if opens else active.discard)(i)
            owner = max(active, default=-1, key=lambda j: (
                spans[j].start_us, spans[j].start_us - spans[j].end_us, j))
            if self.starts and self.starts[-1] == t:
                self.owners[-1] = owner
            else:
                self.starts.append(t)
                self.owners.append(owner)

    def owner_at(self, t: float) -> int:
        """The index of the innermost span open at t, -1 where none is."""
        k = bisect.bisect_right(self.starts, t) - 1
        return self.owners[k] if k >= 0 else -1

    def pieces(self, lo: float, hi: float) -> Iterable[Tuple[int, float]]:
        """(innermost span or -1, µs) of each piece of [lo, hi)."""
        k = bisect.bisect_right(self.starts, lo) - 1
        while lo < hi:
            end = self.starts[k + 1] if k + 1 < len(self.starts) else hi
            end = min(end, hi)
            if end > lo:
                yield (self.owners[k] if k >= 0 else -1), end - lo
            lo, k = max(lo, end), k + 1


def parents(spans: List[HostSpan]) -> List[int]:
    """For each span, the index of the innermost other span that contains
    it (on any thread; of two equal spans the later listed is inner), -1
    where none does."""
    out = []
    for i, s in enumerate(spans):
        inside = [j for j, p in enumerate(spans)
                  if p.start_us <= s.start_us and p.end_us >= s.end_us
                  and (p.start_us < s.start_us or p.end_us > s.end_us
                       or j < i)]
        out.append(max(inside, default=-1, key=lambda j: (
            spans[j].start_us, spans[j].start_us - spans[j].end_us, j)))
    return out


def _busy(device: List[DeviceEvent]) -> List[Tuple[float, float]]:
    merged: List[list] = []
    for d in sorted(device):
        if merged and d.start_us <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], d.end_us)
        else:
            merged.append([d.start_us, d.end_us])
    return [tuple(m) for m in merged]


def credit(spans: List[HostSpan], launches: Dict[int, float],
           device: List[DeviceEvent], extent: Tuple[float, float]) -> dict:
    """What the card did inside each span (module docstring): device_us
    and idle_us by span name, each span counting what its inner spans
    hold; the totals of the capture; and the spans with their parents."""
    up = parents(spans)
    chains = []
    for i in range(len(spans)):
        names, j = [], i
        while j >= 0:
            if spans[j].name not in names:
                names.append(spans[j].name)
            j = up[j]
        chains.append(names)
    device_us = {s.name: 0.0 for s in spans}
    idle_us = dict(device_us)
    line = Timeline(spans)
    total = credited = 0.0
    for d in device:
        dur = d.end_us - d.start_us
        total += dur
        launched = launches.get(d.correlation)
        owner = -1 if launched is None else line.owner_at(launched)
        if owner >= 0:
            credited += dur
            for name in chains[owner]:
                device_us[name] += dur
    t0, t1 = extent
    idle_total = 0.0
    edges = [t0] + [x for iv in _busy(device) for x in iv] + [t1]
    for g0, g1 in zip(edges[::2], edges[1::2]):
        if g1 <= g0:
            continue
        idle_total += g1 - g0
        for owner, us in line.pieces(g0, g1):
            if owner >= 0:
                for name in chains[owner]:
                    idle_us[name] += us
    return {
        "spans": [{"name": s.name, "parent": spans[up[i]].name
                   if up[i] >= 0 else None,
                   "start_us": s.start_us - t0, "end_us": s.end_us - t0}
                  for i, s in enumerate(spans)],
        "device_us": device_us, "idle_us": idle_us,
        "device_us_total": total, "device_us_credited": credited,
        "idle_us_total": idle_total,
    }


def program_counters() -> Dict[str, int]:
    """The program's counters (utils/profiler.py:counters), {} where the
    program has none."""
    try:
        from peclr_tpu_torch.utils.profiler import counters
    except ImportError:
        return {}
    return counters()


def read(prof) -> dict:
    """credit() of a live capture, with the program's counters (their
    totals in this process; a run of the benchmark has one capture)."""
    spans, launches, device, extent = events_of_profile(prof)
    out = credit(spans, launches, device, extent)
    out["counters"] = program_counters()
    return out
