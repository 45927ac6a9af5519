"""Device kernels a pretrain step in the profiled span (copies and sets
left out): a count, which repeats exactly."""

from benchmark.harness.readers import traced

KIND = "per_layer"
UNIT = "count"


def read(ctx):
    t = traced(ctx, "pretrain")
    if t is None:
        return None
    kernels = [s for s in t["device_spans"]
               if not s.name.startswith(("Memcpy", "Memset"))]
    return len(kernels) / t["units"]
