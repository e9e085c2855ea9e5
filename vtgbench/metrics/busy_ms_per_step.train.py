"""Device-busy ms a train step: the union of the profiler's kernel and
copy records over the traced window, over its steps."""

from vtgbench.harness.readers import busy_ms_per_step


def read(trace):
    return busy_ms_per_step(trace, "train")
