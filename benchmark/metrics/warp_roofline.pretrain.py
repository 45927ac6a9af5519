"""The warp's share of its roofline in the pretrain step: the least time
of the step's shift passes (their bytes from shapes, each read and
written once, over 3.35 TB/s) over the device time of the warp's kernels
in the profiled span, found by name (%)."""

from benchmark.harness.counts import PEAK_HBM
from benchmark.harness.readers import traced

KIND = "per_layer"
UNIT = "%"
#: name fragments of the kernels that run the shift passes
KERNEL_NAMES = ("shift_lerp_kernel",)


def read(ctx):
    t = traced(ctx, "pretrain")
    if t is None:
        return None
    us = sum(s.end_us - s.start_us for s in t["device_spans"]
             if any(k in s.name for k in KERNEL_NAMES))
    if us <= 0:
        return None
    least = ctx["counts"]["warp_bytes_per_unit"] / PEAK_HBM
    return 100.0 * least / (us / 1e6 / t["units"])
