"""The whole train step's share of the card's peak: the FLOPs counted for
the window's rows at their valid clips and tokens (yardstick/flops.py) over
the window's seconds, against 989 TFLOP/s (H100 SXM, dense bf16) at every
dial."""

from vtgbench.harness.readers import mfu


def read(trace):
    return mfu(trace, "train")
