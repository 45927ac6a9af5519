"""Summary of a torch.profiler capture of the card: kernel time by
bucket, busy time (the union of the device's intervals), idle gaps with
the host op that overlapped each, and the top kernels.

A frozen copy of peclr_tpu_torch/scripts/trace_buckets.py at commit
9dfdca3 (`bucket`, `spans_of_profile`, `union`, `summarize`), so that a
change to the program cannot change how its trace is read; `breakdown` and
`profile` are the benchmark's own.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Callable, Dict, Iterable, List, NamedTuple, Optional

import numpy as np

#: kernels that go by their own names (lower case fragments), whatever op
#: launched them: the shift kernels of csrc/, collectives, copies and sets
NAMED = (
    ("tap_band", ("tap_band",)),
    ("shift_lerp_matmul_band", ("shift_lerp_matmul_band",)),
    ("shift_lerp_matmul_f32", ("shift_lerp_matmul_f32",)),
    ("shift_lerp_kernel", ("shift_lerp_kernel",)),
    ("nccl", ("nccl",)),
    ("memcpy", ("memcpy",)),
    ("memset", ("memset",)),
)
#: the bucket of the innermost host op a kernel was launched from: name
#: fragments of torch's convolution and BatchNorm ops (their backward
#: ones too), and torch's matrix products by name
OP_BUCKETS = (
    ("convolution", ("convolution", "conv1d", "conv2d", "conv3d",
                     "conv_depthwise", "conv_transpose")),
    ("batchnorm", ("batch_norm",)),
)
GEMM_OPS = frozenset(f"aten::{op}" for op in (
    "mm", "addmm", "bmm", "baddbmm", "addbmm", "mv", "addmv", "dot",
    "_addmm_activation"))
#: name fragments for the other kernels, tried in this order (a template's
#: arguments can hold another bucket's words, so torch's own elementwise
#: kernels are told apart first); cuDNN's FFT convolutions and cuBLAS's
#: nvjet GEMMs go by those names on the H100
FRAGMENTS = (
    ("batchnorm", ("batch_norm", "batchnorm", "bn_fw", "bn_bw")),
    ("elementwise", ("elementwise_kernel", "multi_tensor_apply",
                     "catarraybatchedcopy")),
    ("reduction", ("reduce_kernel",)),
    ("convolution", ("conv", "fprop", "dgrad", "wgrad", "winograd", "cudnn",
                     "nchwtonhwc", "nhwctonchw", "fft2d", "flip_filter")),
    ("gemm", ("gemm", "cutlass", "cublas", "matmul", "gemv", "splitk",
              "nvjet")),
    ("reduction", ("reduce", "softmax", "norm_kernel", "cumsum", "scan",
                   "sort", "topk")),
    ("elementwise", ("elementwise", "multi_tensor_apply", "catarray",
                     "copy_kernel", "fill", "index", "gather", "scatter",
                     "where", "upsample", "grid_sampler")),
)
BUCKET_NAMES = tuple(dict.fromkeys(
    name for name, _ in NAMED + OP_BUCKETS + FRAGMENTS)) + ("other",)
#: idle gaps listed in a summary
TOP_GAPS = 10


class Span(NamedTuple):
    name: str
    start_us: float
    end_us: float
    stream: int
    #: the host op a device span was launched from ("" where none is linked)
    op: str = ""


def _match(table, low: str) -> Optional[str]:
    for bucket_name, fragments in table:
        if any(f in low for f in fragments):
            return bucket_name
    return None


def bucket(name: str, op: str = "") -> str:
    """The bucket of a kernel of `name` launched from the host op `op`:
    NAMED by the name, else OP_BUCKETS or GEMM_OPS by the op, else
    FRAGMENTS by the name; "other" where none fits."""
    low = name.lower()
    return (_match(NAMED, low)
            or ("gemm" if op in GEMM_OPS else _match(OP_BUCKETS, op.lower()))
            or _match(FRAGMENTS, low) or "other")


def spans_of_profile(prof) -> tuple:
    """(device spans, host spans) of a live torch.profiler.profile: the
    card's kernels, copies and sets (its user annotations left out), each
    with the host op it was launched from, and the host's events."""
    import torch

    device, host, ops = [], [], {}
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() / 1e3
        span = Span(e.name(), start, start + e.duration_ns() / 1e3,
                    e.device_resource_id())
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not e.is_user_annotation():
                device.append((span, e.linked_correlation_id()))
        else:
            host.append(span)
            # an op's name has a namespace (aten::, autograd::, c10d::); the
            # CUDA runtime's and driver's calls, whose correlation ids are
            # CUPTI's and overlap the ops', have none
            if "::" in span.name:
                ops[e.correlation_id()] = span.name
    return [s._replace(op=ops.get(link, "")) for s, link in device], host


def union(spans: Iterable[Span]) -> List[tuple]:
    """The merged (start, end) intervals that the spans cover, in order."""
    merged: List[list] = []
    for s in sorted(spans, key=lambda s: s.start_us):
        if merged and s.start_us <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], s.end_us)
        else:
            merged.append([s.start_us, s.end_us])
    return [tuple(m) for m in merged]


def _gap_host_op(host: List[Span], starts, ends, g0: float, g1: float):
    """The host op that overlaps [g0, g1] most; of those that overlap as
    much, the innermost (shortest)."""
    if not host:
        return None
    overlap = np.clip(np.minimum(ends, g1) - np.maximum(starts, g0), 0, None)
    best = overlap.max()
    if best <= 0:
        return None
    close = np.flatnonzero(overlap >= 0.999 * best)
    inner = close[np.argmin((ends - starts)[close])]
    return host[int(inner)].name


def summarize(device: List[Span], host: List[Span], steps: float = 1.0,
              top_n: int = 25) -> dict:
    """The summary of the module docstring, per step."""
    everything = device + host
    if not everything:
        raise ValueError("the capture holds no events")
    t0 = min(s.start_us for s in everything)
    t1 = max(s.end_us for s in everything)
    out = {"steps": steps, "wall_ms": (t1 - t0) / 1e3 / steps,
           "host_ops": len(host)}
    if not device:
        out["device_time"] = "not measured (no device events)"
        return out
    by_bucket: Dict[str, float] = defaultdict(float)
    by_name: Dict[tuple, list] = defaultdict(lambda: [0.0, 0])
    for s in device:
        dur = s.end_us - s.start_us
        kind = bucket(s.name, s.op)
        by_bucket[kind] += dur
        by_name[s.name, kind][0] += dur
        by_name[s.name, kind][1] += 1
    kernel_us = sum(s.end_us - s.start_us for s in device)
    busy = union(device)
    busy_us = sum(b - a for a, b in busy)
    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i])
                   for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]),
                  key=lambda g: (-g[0], g[1]))[:TOP_GAPS]
    starts = np.array([s.start_us for s in host])
    ends = np.array([s.end_us for s in host])
    out.update({
        "kernel_ms": kernel_us / 1e3 / steps,
        "op_linked_ms": sum(s.end_us - s.start_us for s in device
                            if s.op) / 1e3 / steps,
        "busy_ms": busy_us / 1e3 / steps,
        "busy_share": busy_us / (t1 - t0),
        "device_events": len(device) / steps,
        "streams": len({s.stream for s in device}),
        "buckets_ms": {name: by_bucket[name] / 1e3 / steps
                       for name in BUCKET_NAMES if name in by_bucket},
        "idle_gaps": [{"start_ms": (g0 - t0) / 1e3, "ms": dur / 1e3,
                       "host_op": _gap_host_op(host, starts, ends, g0,
                                               g0 + dur)}
                      for dur, g0 in gaps],
        "top_kernels": [{"name": name[:120], "bucket": kind,
                         "ms": us / 1e3 / steps, "calls": n / steps}
                        for (name, kind), (us, n) in sorted(
                            by_name.items(), key=lambda kv: -kv[1][0])[:top_n]],
    })
    return out


def profile(run: Callable[[], object], device) -> dict:
    """Run run() under torch.profiler (CPU and CUDA activities), the card's
    queue empty before and after; returns {"summary": summarize's figures
    over the whole capture, "device_spans": the device's spans}.  The
    caller divides by its units of work."""
    import torch
    from torch.profiler import ProfilerActivity, profile as capture

    from benchmark.harness.common import sync

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    sync(device)
    with capture(activities=activities) as prof:
        run()
        sync(device)
    device_spans, host_spans = spans_of_profile(prof)
    summary = summarize(device_spans, host_spans, steps=1.0, top_n=25)
    return {"summary": summary, "device_spans": device_spans}


def breakdown(summary: dict, top: int = 10) -> dict:
    """The result line's breakdown: the device operations that took most
    time and the longest idle gaps by the host op beside each, in seconds
    over the capture."""
    ops = [[k["name"], k["ms"] / 1e3] for k in summary.get("top_kernels",
                                                          [])[:top]]
    gaps = [[g["host_op"] or "none", g["ms"] / 1e3]
            for g in summary.get("idle_gaps", [])[:top]]
    return {"device_ops": ops, "idle_gaps": gaps}
