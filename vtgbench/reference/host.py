"""The reference's host side: features read from the raw files, the
per-access training labels, padding, the moment decode's post-processing
and temporal NMS, written from the original FlashVTG (start_end_dataset.py,
postprocessing.py, inference.py) in plain numpy.
"""

from __future__ import annotations

import random
from typing import List

import numpy as np


def l2_normalize(x: np.ndarray) -> np.ndarray:
    """Row-wise x / (|x| + 1e-5) (the original's l2_normalize_np_array)."""
    x = np.asarray(x, np.float64)
    return x / (np.linalg.norm(x, axis=-1, keepdims=True) + 1e-5)


def video_features(path: str, max_v_l: int) -> np.ndarray:
    """A video's clips (cut to max_v_l, l2-normed) and its two TEF
    channels (start, end of each clip as a share of the video)."""
    v = l2_normalize(np.load(path)["features"][:max_v_l])
    n = len(v)
    st = np.arange(n, dtype=np.float32) / n
    tef = np.stack([st, st + np.float32(1.0 / n)], axis=1).astype(np.float64)
    return np.concatenate([v, tef], axis=1)


def text_features(path: str, max_q_l: int) -> np.ndarray:
    return l2_normalize(np.load(path)["last_hidden_state"][:max_q_l])


def pad(seqs, length: int):
    """(B, length, ...) zero-padded batch and its (B, length) 0/1 mask."""
    out = np.zeros((len(seqs), length) + seqs[0].shape[1:], np.float64)
    mask = np.zeros((len(seqs), length), np.float64)
    for i, s in enumerate(seqs):
        n = min(len(s), length)
        out[i, :n] = s[:n]
        mask[i, :n] = 1.0
    return out, mask


def span_windows(windows, max_windows: int, rng: random.Random) -> np.ndarray:
    """GT windows in seconds, at most max_windows (shuffled, then cut)."""
    if len(windows) > max_windows:
        windows = list(windows)
        rng.shuffle(windows)
        windows = windows[:max_windows]
    return np.asarray(windows, np.float32).reshape(-1, 2)


def saliency_sub_as_query(gt_window, duration, ctx_l, rng: random.Random, max_n: int = 2):
    """TACoS / Charades-style labels: the GT window is the salient span;
    max_n positive and max_n negative clips sampled."""
    clip_len = duration / ctx_l
    gt_st = int(gt_window[0] / clip_len)
    gt_ed = max(0, min(int(gt_window[1] / clip_len), ctx_l) - 1)
    if gt_st > gt_ed:
        gt_st = gt_ed
    pos = rng.sample(range(gt_st, gt_ed + 1), k=max_n) if gt_st != gt_ed else [gt_st, gt_st]
    neg_pool = list(range(0, gt_st)) + list(range(gt_ed + 1, ctx_l))
    try:
        neg = rng.sample(neg_pool, k=max_n)
    except ValueError:
        neg = pos
    score = np.zeros(ctx_l, np.float32)
    score[gt_st:gt_ed + 1] = 1
    return pos, neg, score


def rolled_neg_mask(vids: List[str]) -> np.ndarray:
    """1 where the next row (the negative pass's text) is another video."""
    rolled = list(vids[1:]) + list(vids[:1])
    return np.asarray([a != b for a, b in zip(vids, rolled)], np.float32)


def round_windows(windows: np.ndarray, clip_length: float) -> np.ndarray:
    """The post-processing of TACoS-style sets: round to clip multiples."""
    return np.round(np.asarray(windows, np.float64) / clip_length) * clip_length


def nms_scores(spans: np.ndarray, scores: np.ndarray, thd: float) -> np.ndarray:
    """Greedy temporal NMS of one query's ranked windows: repeat N times,
    take the highest unprocessed window (first on ties), zero every
    unprocessed window whose IoU with it is at least thd. Returns the
    suppressed scores in input order."""
    s = np.asarray(scores, np.float32).copy()
    st, ed = spans[:, 0], spans[:, 1]
    inter = np.clip(np.minimum(ed[:, None], ed[None, :]) - np.maximum(st[:, None], st[None, :]),
                    0, None)
    area = ed - st
    iou = (inter / (area[:, None] + area[None, :] - inter)).astype(np.float32)
    done = np.zeros(len(s), bool)
    for _ in range(len(s)):
        pick = int(np.argmax(np.where(done, -1e18, s)))
        rest = ~done
        rest[pick] = False
        s = np.where((iou[pick] >= thd) & rest, np.float32(0), s)
        done[pick] = True
    return s
