"""The share of the collated video rows that are valid clips, not padding:
the program's data.valid_video_rows over data.video_rows (B x the padded
length), the train epochs' deltas (harness/program.py)."""

from vtgbench.harness.program import share


def read(trace):
    return share(trace, "train", "data.valid_video_rows", "data.video_rows")
