"""Host memory the program pinned anew a predictor batch in the profiled
span, in 1e6 bytes: its `pinned_bytes` counter (utils/profiler.py, added
to only under a capture, and a run has one) over the traced batches."""

from benchmark.harness import spans
from benchmark.harness.readers import traced

KIND = "per_layer"
UNIT = "MB"


def read(ctx):
    t = traced(ctx, "pred")
    pinned = None if t is None else spans.program_counters().get(
        "pinned_bytes")
    if pinned is None:
        return None
    return pinned / t["units"] / 1e6
