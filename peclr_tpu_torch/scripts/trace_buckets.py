"""Summarise a torch.profiler capture of the card into op-category buckets,
busy time, idle gaps and the top kernels (port of the reference
repository's scripts/trace_buckets.py, which read an xplane `hlo_stats`
table).

    python -m peclr_tpu_torch.scripts.trace_buckets TRACE.json [top_n]

TRACE.json is a Chrome trace as utils/profiler.py:trace writes it (or the
newest `*.json` under a directory); `summarize_profile` takes a live
`torch.profiler.profile` instead.  TRACE_STEPS (environment, default 1)
divides the totals into per-step figures, as the reference's does.

What a summary holds, per step:
  * kernel_ms: the sum of the card's kernel, copy and set intervals
    (op_linked_ms of it launched from a host op the capture holds);
    buckets_ms splits it by category, so the buckets sum to it: a kernel
    goes by the host op it was launched from (the profiler links the two
    by correlation id; OP_BUCKETS, GEMM_OPS), so that the GEMMs and
    layout kernels cuDNN runs for a convolution count as convolution; a
    kernel of its own name (NAMED), or one launched from no op of those,
    goes by its name (FRAGMENTS);
  * busy_ms: the union of those intervals, never more than kernel_ms (the
    two agree where one stream runs one kernel at a time);
  * wall_ms: the capture's span, host and card; idle_gaps: the spans in it
    where the card ran nothing, longest (then earliest) first, each with
    the host op that overlapped it most (the innermost of those that
    cover as much);
  * top_kernels: the kernels that took the most time, with their calls.
A capture with no device events (a CPU run) gives "not measured" for the
card's numbers.
"""

from __future__ import annotations

import glob
import json
import os
import sys
from collections import defaultdict
from typing import Dict, Iterable, List, NamedTuple, Optional

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


_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation",
              "python_function")


def spans_of_chrome_trace(trace) -> tuple:
    """(device spans, host spans) of a Chrome trace: a path, or its parsed
    dict.  A device span's op is the cpu_op of its "External id"."""
    if isinstance(trace, str):
        with open(trace) as f:
            trace = json.load(f)
    device, host, ops = [], [], {}
    for e in trace.get("traceEvents", []):
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat, args = e.get("cat", ""), e.get("args", {})
        span = Span(e.get("name", ""), float(e["ts"]),
                    float(e["ts"]) + float(e["dur"]),
                    int(args.get("stream", e.get("tid", 0))
                        if cat in _DEVICE_CATS else 0))
        if cat in _DEVICE_CATS:
            device.append((span, args.get("External id")))
        elif cat in _HOST_CATS:
            host.append(span)
            if cat == "cpu_op" and "External id" in args:
                ops[args["External id"]] = span.name
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


def summarize_profile(prof, steps: float = 1.0, top_n: int = 25) -> dict:
    """summarize() of a live torch.profiler.profile."""
    return summarize(*spans_of_profile(prof), steps=steps, top_n=top_n)


def print_summary(s: dict) -> None:
    print(f"wall {s['wall_ms']:.2f} ms/step over {s['steps']:g} steps")
    if "device_time" in s:
        print(f"device: {s['device_time']}")
        return
    print(f"kernels {s['kernel_ms']:.2f} ms/step, busy {s['busy_ms']:.2f} "
          f"({100 * s['busy_share']:.1f}% of the span), {s['streams']} "
          "stream(s)")
    print("\n-- buckets (ms/step) --")
    for name, ms in sorted(s["buckets_ms"].items(), key=lambda kv: -kv[1]):
        print(f"{ms:9.3f} ms  {100 * ms / max(s['kernel_ms'], 1e-12):5.1f}%"
              f"  {name}")
    print("\n-- idle gaps, longest first --")
    for g in s["idle_gaps"]:
        print(f"{g['ms']:9.3f} ms at {g['start_ms']:9.3f} ms  {g['host_op']}")
    print(f"\n-- top {len(s['top_kernels'])} kernels (ms/step) --")
    for k in s["top_kernels"]:
        print(f"{k['ms']:9.3f} ms  x{k['calls']:>6g}  {k['bucket']:12s} "
              f"{k['name'][:80]}")


def main(argv: Optional[List[str]] = None) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    path = argv[0]
    top_n = int(argv[1]) if len(argv) > 1 else 25
    steps = float(os.environ.get("TRACE_STEPS", "1"))
    if os.path.isdir(path):
        path = sorted(glob.glob(os.path.join(path, "**", "*.json"),
                                recursive=True), key=os.path.getmtime)[-1]
    summary = summarize(*spans_of_chrome_trace(path), steps=steps,
                        top_n=top_n)
    print(f"({path})")
    print_summary(summary)
    return summary


if __name__ == "__main__":
    main()
