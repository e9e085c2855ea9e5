"""The share of the traced eval window in which no operation ran on the
device: 1 - busy / window."""

from vtgbench.harness.readers import idle_share


def read(trace):
    return idle_share(trace, "eval")
