"""ms an eval batch of dispatch (masks, upload, the feed's gather, the
forward's launches): the program's eval.dispatch spans over its
eval.batches counter (harness/program.py)."""

from vtgbench.harness.program import ms_per


def read(trace):
    return ms_per(trace, "eval", "eval.dispatch", "eval.batches")
