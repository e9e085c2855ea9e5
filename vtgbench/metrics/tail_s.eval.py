"""Seconds a pass of the host tail after the last batch: the program's
eval.gather, eval.postprocess and eval.nms spans over its eval.infer roots
(harness/program.py)."""

from vtgbench.harness.program import seconds_per_root


def read(trace):
    return seconds_per_root(trace, "eval", ("eval.gather", "eval.postprocess", "eval.nms"))
