"""Fixed-shape padding and bucketing on the host (numpy).

Counterpart of flashvtg_tpu/ops/pad.py: batches are padded to a fixed
length per bucket, and masks carry the true lengths.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

DEFAULT_BUCKETS = (75, 128, 256, 512, 1024, 2048, 4096)


def bucket_length(length: int, buckets: Sequence[int] = DEFAULT_BUCKETS) -> int:
    """Smallest bucket >= length (last bucket if none fits)."""
    for b in buckets:
        if length <= b:
            return b
    return int(buckets[-1])


def pad_batch(seqs, length: int, dtype=np.float32):
    """Pad a list of (L_i, ...) arrays to a (B, length, ...) batch + mask."""
    seqs = [np.asarray(s, dtype=dtype) for s in seqs]
    out = np.zeros((len(seqs), length) + seqs[0].shape[1:], dtype=dtype)
    mask = np.zeros((len(seqs), length), dtype=np.float32)
    for i, s in enumerate(seqs):
        n = min(len(s), length)
        out[i, :n] = s[:n]
        mask[i, :n] = 1.0
    return out, mask
