"""ms a train step the main thread waited on the prefetch queue: the
program's train.batch_wait spans over its train.steps counter
(harness/program.py)."""

from vtgbench.harness.program import ms_per


def read(trace):
    return ms_per(trace, "train", "train.batch_wait", "train.steps")
