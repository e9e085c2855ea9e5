"""ms a train step of batch making on the prefetch thread: the program's
data.make_batch spans (the dataset reads, the collation and the staging)
over its train.steps counter (harness/program.py)."""

from vtgbench.harness.program import ms_per


def read(trace):
    return ms_per(trace, "train", "data.make_batch", "train.steps")
