"""The flash attention family's share of its least time in the traced eval
window: the sum of each call's least seconds (yardstick/bound.py, at the
steps' own masks) over the family's device seconds, pre-passes and
reduction passes included (yardstick/kernels.py)."""

from vtgbench.harness.readers import roofline


def read(trace):
    return roofline(trace, "eval", "flash")
