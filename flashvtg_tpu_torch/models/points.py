"""Static anchor points and pyramid validity masks.

Counterpart of flashvtg_tpu/models/points.py. Points and strict masks are
host numpy (shapes are known before the forward); the pool masks are torch,
on the device of the video mask.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from flashvtg_tpu_torch.models.components import pool_mask


def pyramid_level_sizes(length: int, strides: Sequence[int]) -> Tuple[int, ...]:
    """Per-level sequence lengths for a padded length; 0 where stride > length."""
    sizes = []
    for s in strides:
        if length < s:
            sizes.append(0)
            continue
        l = length
        for _ in range(int(np.log2(s))):
            l = (l - 2) // 2 + 1  # VALID conv, kernel 2, stride 2
        sizes.append(l)
    return tuple(sizes)


def generate_points(length: int, strides: Sequence[int]) -> np.ndarray:
    """(N, 4) float32 anchor rows (center, reg_min, reg_max, stride) for all
    present levels (reference generator.py:26-44)."""
    reg_ranges, last = [], 0.0
    for s in strides[1:]:
        reg_ranges.append((last, float(s)))
        last = float(s)
    reg_ranges.append((last, float("inf")))

    rows = []
    for s, rng, size in zip(strides, reg_ranges, pyramid_level_sizes(length, strides)):
        if size == 0:
            continue
        rows.append(
            np.stack(
                [
                    np.arange(size, dtype=np.float32) * s,
                    np.full(size, rng[0], np.float32),
                    np.full(size, rng[1], np.float32),
                    np.full(size, float(s), np.float32),
                ],
                axis=1,
            )
        )
    return np.concatenate(rows, axis=0)


def pyramid_masks_pool(video_mask: torch.Tensor, strides: Sequence[int]):
    """Per-level (B, L_s) masks via max-pooling (training semantics)."""
    length = video_mask.shape[1]
    return tuple(pool_mask(video_mask, s) for s in strides if length >= s)


def pyramid_masks_strict(valid_lengths, length: int, strides):
    """Per-sample strict point validity over the concatenated point axis.

    A point is valid iff it exists in the reference's unpadded computation:
    its level index is below the chained VALID-conv output length of the
    true length. Returns the (B, N) float32 mask and (B,) int64 counts."""
    valid_lengths = np.asarray(valid_lengths)
    per_level_valid = []
    for s, size in zip(strides, pyramid_level_sizes(length, strides)):
        if size == 0:
            continue
        l = valid_lengths.copy()
        for _ in range(int(np.log2(s))):
            l = np.maximum((l - 2) // 2 + 1, 0)
        l = np.where(valid_lengths >= s, l, 0)
        idx = np.arange(size)[None, :]
        per_level_valid.append((idx < l[:, None]).astype(np.float32))
    mask = np.concatenate(per_level_valid, axis=1)
    return mask, mask.sum(axis=1).astype(np.int64)
