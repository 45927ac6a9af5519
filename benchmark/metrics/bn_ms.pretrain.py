"""Device ms a pretrain step in BatchNorm kernels (those launched from a
batch_norm op, or named so), from the profiled span."""

from benchmark.harness.readers import bucket_ms

KIND = "per_layer"
UNIT = "ms"


def read(ctx):
    return bucket_ms(ctx, "pretrain", "batchnorm")
