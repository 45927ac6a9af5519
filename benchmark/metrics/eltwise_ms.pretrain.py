"""Device ms a pretrain step in elementwise kernels (residual adds, casts,
activations, the optimizer's foreach kernels), from the profiled span."""

from benchmark.harness.readers import bucket_ms

KIND = "per_layer"
UNIT = "ms"


def read(ctx):
    return bucket_ms(ctx, "pretrain", "elementwise")
