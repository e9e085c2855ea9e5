"""Highlight-detection metrics for TVSum / YouTube-HL (numpy).

The port's copy of flashvtg_tpu/eval/hl.py (reference FlashVTG/inference.py
compute_hl_results, the UMT top-5 mAP protocol): rank the clips by predicted
saliency with a stable float64 argsort, binarise each TVSum annotator's
scores at their median (YouTube-HL's labels are binary already), and
accumulate a trapezoidal AP over the ranking (TVSum: its top 5).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


def _ranked_trapezoid_ap(ranked_labels: Sequence[float]) -> float:
    """The reference's incremental AP accumulation (inference.py:175-187)."""
    num_gt = float(sum(ranked_labels))
    if num_gt == 0:
        return 0.0
    hits = ap = rec = 0.0
    prc = 1.0
    for j, gt in enumerate(ranked_labels):
        hits += gt
        _rec = hits / num_gt
        _prc = hits / (j + 1)
        ap += (_rec - rec) * (prc + _prc) / 2
        rec, prc = _rec, _prc
    return float(ap)


def tvsum_video_ap(pred: np.ndarray, label_rows: np.ndarray, topk: int = 5):
    """Per-annotator APs of one video: pred (L,) saliency, label_rows (L, 20)
    raw scores."""
    label_rows = np.asarray(label_rows, dtype=np.float64)
    cur_pred = np.asarray(pred[: len(label_rows)], dtype=np.float64)
    inds = np.argsort(-cur_pred, kind="stable")
    aps = []
    for i in range(label_rows.shape[1]):
        col = label_rows[:, i]
        binary = (col > np.median(col)).astype(np.float64)
        aps.append(_ranked_trapezoid_ap(list(binary[inds][:topk])))
    return aps


def youtube_video_ap(pred: np.ndarray, labels: np.ndarray):
    """One AP over the whole ranking with binary labels (no top-k cut on
    this path, inference.py:189-214)."""
    labels = np.asarray(labels, dtype=np.float64).squeeze()
    cur_pred = np.asarray(pred[: len(labels)], dtype=np.float64)
    inds = np.argsort(-cur_pred, kind="stable")
    return [_ranked_trapezoid_ap(list(labels[inds]))]


def compute_hl_map(dset_name: str, preds: List[np.ndarray], labels: List) -> float:
    """Mean AP over every eval video of one domain."""
    collected = []
    for pred, label in zip(preds, labels):
        if dset_name == "tvsum":
            collected.append(tvsum_video_ap(pred, np.asarray(label)))
        elif dset_name == "youtube_uni":
            collected.append(youtube_video_ap(pred, np.asarray(label)))
        else:
            raise ValueError(f"not an HL dataset: {dset_name}")
    return float(np.mean(collected))
