"""The share of the device-idle time, between the window's first and last
device record, in which the innermost program span open on the main thread
is a stage span, not the eval.infer root (harness/program.py)."""

from vtgbench.harness.program import idle_named_share


def read(trace):
    return idle_named_share(trace, "eval")
