"""ms an eval batch of unpacking and formatting its rows: the program's
eval.rows spans over its eval.batches counter (harness/program.py)."""

from vtgbench.harness.program import ms_per


def read(trace):
    return ms_per(trace, "eval", "eval.rows", "eval.batches")
