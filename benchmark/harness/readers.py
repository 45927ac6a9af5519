"""What the metric readers under metrics/ share.  A reader takes the run's
context and returns its number, or None where it finds nothing to read.

The context holds: kind (the entry's: pretrain, finetune, pred), window
(units of work, images and seconds of the unprofiled window; latencies_s
of each batch where the entry has them), setup_s, counts (FLOPs and bytes
a unit from shapes, the peak they are held to) and, in a --trace 1 run,
trace (the profiled span's summary, its device spans and its units)."""

from __future__ import annotations

from typing import Optional


def window_rate(ctx: dict, kind: str) -> Optional[float]:
    """Images of every unit completed in the window over its seconds."""
    if ctx.get("kind") != kind or not ctx.get("window"):
        return None
    w = ctx["window"]
    return w["images"] / w["seconds"]


def traced(ctx: dict, kind: str) -> Optional[dict]:
    """The trace of a --trace 1 run of this kind whose capture holds device
    time, else None."""
    t = ctx.get("trace")
    if ctx.get("kind") != kind or not t or "busy_ms" not in t["summary"]:
        return None
    return t


def mfu(ctx: dict, kind: str) -> Optional[float]:
    """Model FLOPs of the window's units over its seconds, as a share of
    the peak the counts name (%)."""
    if traced(ctx, kind) is None:
        return None
    c, w = ctx["counts"], ctx["window"]
    return 100.0 * c["flops_per_unit"] * w["units"] / w["seconds"] / \
        c["peak_flops"]


def bucket_ms(ctx: dict, kind: str, bucket: str) -> Optional[float]:
    """Device ms a unit of one bucket of the trace summary."""
    t = traced(ctx, kind)
    if t is None or bucket not in t["summary"]["buckets_ms"]:
        return None
    return t["summary"]["buckets_ms"][bucket] / t["units"]


def idle_pct(ctx: dict, kind: str) -> Optional[float]:
    """1 - busy ms a unit in the profiled span / ms a unit of the
    unprofiled window (%)."""
    t = traced(ctx, kind)
    if t is None:
        return None
    w = ctx["window"]
    busy = t["summary"]["busy_ms"] / t["units"]
    return 100.0 * (1.0 - busy / (1e3 * w["seconds"] / w["units"]))
