"""The device's idle share: 1 - busy ms a unit in the profiled span over
ms a unit of the same run's unprofiled window (%)."""

from benchmark.harness.readers import idle_pct

KIND = "per_layer"
UNIT = "%"


def read(ctx):
    return idle_pct(ctx, "pred")
