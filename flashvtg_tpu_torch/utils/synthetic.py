"""Synthetic annotation + feature fixtures, in QVHighlights and TACoS format.

`make_synthetic_qvh` is the counterpart of flashvtg_tpu/utils/synthetic.py.
With the default arguments it writes the same files, value for value, as the
JAX package's copy; the extra `min_clips` draws a per-video clip count so
that some videos are shorter than `n_clips` and the eval path's strict point
masks are exercised. `make_synthetic_tacos` writes TACoS-format rows (string
qids, windows and durations, no saliency fields) over long ragged videos.

With `split` (e.g. "train", "val") a writer names its annotation file
`<split>.jsonl` and puts the split into every vid and qid, so the splits of
one root share the feature directories without clashing. A QVHighlights
split's vids follow the dataset's `<video>_<start>_<end>` form, so the
negative-pair mask (data/collate.py, which strips that suffix) sees distinct
videos. Every row carries what training reads: relevant_windows and
duration, and for QVHighlights relevant_clip_ids and saliency_scores.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from flashvtg_tpu_torch.utils.io import save_jsonl


def make_synthetic_qvh(
    root: str,
    n_queries: int = 16,
    v_dim: int = 32,
    t_dim: int = 24,
    n_clips: int = 16,
    clip_len: float = 2.0,
    seed: int = 0,
    deterministic_labels: bool = False,
    min_clips: Optional[int] = None,
    max_q_tokens: int = 12,
    split: Optional[str] = None,
):
    """Write a small QVH-style dataset under `root`.

    Returns (ann_path, vid_dir, txt_dir). Each query gets its own video.
    `min_clips` (None = every video has `n_clips` clips) lets every fourth
    video draw its length from [min_clips, n_clips). `max_q_tokens` is the
    exclusive upper bound of the text length draw (lower bound 5).
    """
    rng = np.random.default_rng(seed)
    if deterministic_labels:
        n_clips = 2
    vdir = os.path.join(root, "vid_feats")
    qdir = os.path.join(root, "txt_feats")
    os.makedirs(vdir, exist_ok=True)
    os.makedirs(qdir, exist_ok=True)

    rows = []
    for i in range(n_queries):
        vid = f"synthvid_{i:04d}" if split is None else f"synth{split}{i:04d}_0.0_150.0"
        qid = i if split is None else f"{split}{i}"
        clips = n_clips
        if min_clips is not None and i % 4 == 3:
            clips = int(rng.integers(min_clips, n_clips))
        duration = clips * clip_len
        if deterministic_labels:
            s, e = 0, 1
        else:
            s = int(rng.integers(0, clips - 2))
            e = int(rng.integers(s + 1, clips))
        rel_ids = list(range(s, e))
        rows.append(
            dict(
                qid=qid,
                query=f"synthetic query {i}",
                duration=duration,
                vid=vid,
                relevant_clip_ids=rel_ids,
                saliency_scores=[
                    [int(x) for x in rng.integers(0, 5, 3)] for _ in rel_ids
                ],
                relevant_windows=[[s * clip_len, e * clip_len]],
            )
        )
        np.savez(
            os.path.join(vdir, f"{vid}.npz"),
            features=rng.standard_normal((clips, v_dim), dtype=np.float32),
        )
        lq = int(rng.integers(5, max_q_tokens))
        np.savez(
            os.path.join(qdir, f"qid{qid}.npz"),
            last_hidden_state=rng.standard_normal((lq, t_dim), dtype=np.float32),
        )
    ann = os.path.join(root, "synth.jsonl" if split is None else f"{split}.jsonl")
    save_jsonl(rows, ann)
    return ann, vdir, qdir


def make_synthetic_tacos(
    root: str,
    n_queries: int = 16,
    v_dim: int = 768,
    t_dim: int = 4096,
    max_clips: int = 2048,
    min_clips: int = 64,
    clip_len: float = 2.0,
    seed: int = 0,
    max_q_tokens: int = 40,
    split: Optional[str] = None,
):
    """Write a TACoS-format dataset under `root`: one video per query.

    Returns (ann_path, vid_dir, txt_dir). Rows carry a string qid, query,
    vid, duration and one relevant window, and no saliency fields, as the
    TACoS annotations do. The first video has exactly `max_clips` clips,
    every other draws its length from [min_clips, max_clips), so every
    batch padded to `max_clips` holds short rows. Text has 5 to
    `max_q_tokens` tokens.
    """
    rng = np.random.default_rng(seed)
    vdir = os.path.join(root, "vid_feats")
    qdir = os.path.join(root, "txt_feats")
    os.makedirs(vdir, exist_ok=True)
    os.makedirs(qdir, exist_ok=True)

    rows = []
    for i in range(n_queries):
        vid = f"synthtacos-v{i:04d}" if split is None else f"synthtacos-{split}-v{i:04d}"
        qid = f"{vid}_q0"
        clips = max_clips if i == 0 else int(rng.integers(min_clips, max_clips))
        s = int(rng.integers(0, clips - 2))
        e = int(rng.integers(s + 1, min(clips, s + 64)))
        rows.append(
            dict(
                qid=qid,
                query=f"synthetic tacos query {i}",
                duration=clips * clip_len,
                vid=vid,
                relevant_windows=[[s * clip_len, e * clip_len]],
            )
        )
        np.savez(
            os.path.join(vdir, f"{vid}.npz"),
            features=rng.standard_normal((clips, v_dim), dtype=np.float32),
        )
        lq = int(rng.integers(5, max_q_tokens + 1))
        np.savez(
            os.path.join(qdir, f"qid{qid}.npz"),
            last_hidden_state=rng.standard_normal((lq, t_dim), dtype=np.float32),
        )
    ann = os.path.join(root, "tacos.jsonl" if split is None else f"{split}.jsonl")
    save_jsonl(rows, ann)
    return ann, vdir, qdir
