"""Device-busy ms an eval batch: the union of the profiler's records over
the traced passes, over their batches."""

from vtgbench.harness.readers import busy_ms_per_step


def read(trace):
    return busy_ms_per_step(trace, "eval")
