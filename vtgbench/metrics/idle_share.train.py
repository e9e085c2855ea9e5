"""The share of the traced train window in which no operation ran on the
device: 1 - busy / window."""

from vtgbench.harness.readers import idle_share


def read(trace):
    return idle_share(trace, "train")
