"""ms an eval batch of the dataset reads and the collation: the program's
eval.collate spans over its eval.batches counter (harness/program.py)."""

from vtgbench.harness.program import ms_per


def read(trace):
    return ms_per(trace, "eval", "eval.collate", "eval.batches")
