"""Clip-id <-> window conversions (counterpart of flashvtg_tpu/ops/windows.py,
reference utils/windows_utils.py)."""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


def clip_ids_to_windows(clip_ids: Sequence[int]) -> List[List[int]]:
    """Group sorted clip ids into contiguous [start_id, end_id] windows.

    >>> clip_ids_to_windows([56, 57, 58, 59, 60, 61, 62, 64, 67, 68, 69, 70, 71])
    [[56, 62], [64, 64], [67, 71]]
    """
    windows = []
    start = last = clip_ids[0]
    for cid in clip_ids[1:]:
        if cid - last > 1:
            windows.append([start, last])
            start = cid
        last = cid
    windows.append([start, last])
    return windows


def windows_to_clip_ids(windows: Sequence[Sequence[int]]) -> List[int]:
    """Inverse of clip_ids_to_windows (end index inclusive)."""
    out: List[int] = []
    for w in windows:
        out.extend(range(w[0], w[1] + 1))
    return out


def clip_window_to_seconds(window: Sequence[int], clip_len: float = 2.0):
    return [window[0] * clip_len, (window[1] + 1) * clip_len]


def accuracy_at_k(scores, target, topk=(1,)):
    """precision@k over a (N, C) score matrix (reference FlashVTG/misc.py)."""
    scores = np.asarray(scores)
    target = np.asarray(target).reshape(-1, 1)
    order = np.argsort(-scores, axis=1)
    return [100.0 * (order[:, :k] == target).any(axis=1).mean() for k in topk]
