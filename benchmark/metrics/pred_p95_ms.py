"""95th percentile, over every batch of the window, of the time from its
dispatch to its keypoints on the host (ms)."""

import numpy as np

KIND = "end_to_end"
UNIT = "ms"


def read(ctx):
    if ctx.get("kind") != "pred" or not ctx.get("window"):
        return None
    lat = ctx["window"].get("latencies_s")
    if not lat:
        return None
    return float(np.percentile(np.asarray(lat) * 1e3, 95))
