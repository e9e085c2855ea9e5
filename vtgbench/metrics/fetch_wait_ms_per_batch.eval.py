"""ms an eval batch the host waited for its fetch: the program's
eval.fetch_wait spans over its eval.batches counter (harness/program.py)."""

from vtgbench.harness.program import ms_per


def read(trace):
    return ms_per(trace, "eval", "eval.fetch_wait", "eval.batches")
