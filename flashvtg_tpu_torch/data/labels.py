"""Saliency / span label generation (host-side, numpy).

The port's copy of flashvtg_tpu/data/labels.py (reference
FlashVTG/start_end_dataset.py:231-407). All random sampling goes through an
injectable `random.Random`, so a seed fixes every draw and the two packages
draw the same labels from the same seed.
"""

from __future__ import annotations

import random
from typing import List, Sequence, Tuple

import numpy as np


def saliency_sub_as_query(
    gt_window, duration, ctx_l, rng: random.Random, max_n: int = 2
):
    """Charades/TACoS-style labels: the GT window itself is the salient span
    (oracle: start_end_dataset.py:231-256)."""
    clip_len = duration / ctx_l
    gt_st = int(gt_window[0] / clip_len)
    gt_ed = max(0, min(int(gt_window[1] / clip_len), ctx_l) - 1)
    if gt_st > gt_ed:
        gt_st = gt_ed
    if gt_st != gt_ed:
        pos = rng.sample(range(gt_st, gt_ed + 1), k=max_n)
    else:
        pos = [gt_st, gt_st]
    neg_pool = list(range(0, gt_st)) + list(range(gt_ed + 1, ctx_l))
    try:
        neg = rng.sample(neg_pool, k=max_n)
    except ValueError:
        neg = pos
    score = np.zeros(ctx_l, dtype=np.float32)
    score[gt_st : gt_ed + 1] = 1
    return pos, neg, score


def saliency_all(
    rel_clip_ids: Sequence[int],
    scores: Sequence[Sequence[int]],
    ctx_l: int,
    rng: random.Random,
    max_n: int = 1,
    add_easy_negative: bool = True,
):
    """QVHighlights labels from 3-worker scores
    (oracle: start_end_dataset.py:294-336, including the grow-by-one quirk
    when a relevant clip id falls beyond ctx_l)."""
    scores = np.asarray(scores)
    agg = scores.sum(1)
    order = np.argsort(agg)

    score_array = np.zeros(ctx_l, dtype=np.float32)
    for i, cid in enumerate(rel_clip_ids):
        if cid >= len(score_array):
            grown = np.zeros(len(score_array) + 1, dtype=np.float32)
            grown[: len(score_array)] = score_array
            score_array = grown
        score_array[cid] = agg[i]

    hard_pos = [min(rel_clip_ids[i], ctx_l - 1) for i in order[-max_n:]]
    hard_neg = [min(rel_clip_ids[i], ctx_l - 1) for i in order[:max_n]]
    easy_pos, easy_neg = [], []
    if add_easy_negative:
        easy_pool = list(set(range(ctx_l)) - set(rel_clip_ids))
        if len(easy_pool) >= max_n:
            easy_pos = rng.sample(list(rel_clip_ids), k=max_n)
            easy_neg = rng.sample(easy_pool, k=max_n)
        else:
            easy_pos, easy_neg = hard_pos, hard_neg
    return hard_pos + easy_pos, hard_neg + easy_neg, score_array


def saliency_tvsum(labels, ctx_l, max_n: int = 1):
    """TVSum: 20-annotator scores in [1,5] -> aggregate/80*12
    (oracle: start_end_dataset.py:338-360)."""
    labels = np.asarray(labels)
    agg = (labels - 1).sum(-1)[:ctx_l]
    score_array = (agg / 80 * 12).astype(np.float32)
    order = np.argsort(agg)
    pos = [min(int(i), ctx_l - 1) for i in order[-max_n:]]
    neg = [min(int(i), ctx_l - 1) for i in order[:max_n]]
    return pos, neg, score_array


def saliency_youtube(labels, ctx_l, max_n: int = 1):
    """YouTube-HL: binary per-clip labels (oracle: :362-386)."""
    agg = np.asarray(labels)[:, 0]
    score_array = agg.astype(np.float32)
    order = np.argsort(agg)
    pos = [min(int(i), ctx_l - 1) for i in order[-max_n:]]
    neg = [min(int(i), ctx_l - 1) for i in order[:max_n]]
    return pos, neg, score_array


def span_windows(
    windows: List[List[float]],
    ctx_l: int,
    clip_len: float,
    max_windows: int,
    rng: random.Random,
) -> np.ndarray:
    """GT windows in *seconds*, at most `max_windows` (randomly subsampled
    like the reference's shuffle+truncate, :389-407). The normalized cxw
    conversion of the reference's l1 path is unused by the live loss stack —
    the criterion consumes raw second-space windows (model.py:654-667) — so
    seconds are kept here."""
    if len(windows) > max_windows:
        windows = list(windows)
        rng.shuffle(windows)
        windows = windows[:max_windows]
    return np.asarray(windows, dtype=np.float32).reshape(-1, 2)
