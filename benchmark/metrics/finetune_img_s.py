"""Images of every finetune unit completed in the window, over the window's
seconds (host clock, one wait on the card at each end)."""

from benchmark.harness.readers import window_rate

KIND = "end_to_end"
UNIT = "img/s"


def read(ctx):
    return window_rate(ctx, "finetune")
