"""Model FLOPs of the window's pred units (counted from shapes) over the
unprofiled window's seconds, as a share of the card's peak (%)."""

from benchmark.harness.readers import mfu

KIND = "per_layer"
UNIT = "%"


def read(ctx):
    return mfu(ctx, "pred")
