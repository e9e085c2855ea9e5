"""Device ms a train step in the "other" kernel class (elementwise,
LayerNorm, reductions, the optimizer): no GEMM, convolution, copy or
attention kernel (yardstick/kernels.py)."""

from vtgbench.harness.readers import class_ms_per_step


def read(trace):
    return class_ms_per_step(trace, "train", "other")
