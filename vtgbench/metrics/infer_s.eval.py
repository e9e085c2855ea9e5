"""Seconds of one run_mr_inference call (the benchmark's span around it),
mean over the window's passes."""

from vtgbench.harness.readers import mean_span


def read(trace):
    return mean_span(trace, "eval", "infer_s")
