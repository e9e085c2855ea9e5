"""Seconds of one pass's two eval_submission calls (plain and NMS'd; the
benchmark's span around them), mean over the window's passes."""

from vtgbench.harness.readers import mean_span


def read(trace):
    return mean_span(trace, "eval", "metrics_s")
