"""ms a train step the main thread waited for the step before it to end:
the program's train.step_wait spans over its train.steps counter
(harness/program.py)."""

from vtgbench.harness.program import ms_per


def read(trace):
    return ms_per(trace, "train", "train.step_wait", "train.steps")
