"""Synthetic annotation + feature fixtures in the layouts of the presets.

`make_synthetic_qvh` is the counterpart of flashvtg_tpu/utils/synthetic.py.
With the default arguments it writes the same files, value for value, as the
JAX package's copy; the extra `min_clips` draws a per-video clip count so
that some videos are shorter than `n_clips` and the eval path's strict point
masks are exercised. `make_synthetic_tacos` writes TACoS-format rows (string
qids, windows and durations, no saliency fields) over long ragged videos.
`make_synthetic_tvsum` and `make_synthetic_youtube` write one domain of the
highlight-detection sets (`label` rows, `domain`, `{qid}.npz` text; TVSum's
video as `_rgb.npy` + `_opt.npy` halves), `make_synthetic_charades` writes
Charades-STA rows (windows and durations, two queries a video), with
`write_glove` for the VGG configuration's GloVe text. The length mixes of
these writers are guesses, not the datasets' own (each writer says which).
`make_synthetic_submission` makes a QVHighlights-val-sized submission and
its ground truth in memory, for the metric suite.

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


def _hd_rows(root, n_queries, t_dim, clips_range, seed, max_q_tokens, split, tag):
    """(rng, rows, vdir, qdir, clip counts) of an HD writer: one video per
    row, qid = vid, `{qid}.npz` text of 5 to max_q_tokens tokens."""
    rng = np.random.default_rng(seed)
    vdir = os.path.join(root, "vid_feats")
    qdir = os.path.join(root, "txt_feats")
    os.makedirs(vdir, exist_ok=True)
    os.makedirs(qdir, exist_ok=True)
    vids, clips = [], []
    for i in range(n_queries):
        vids.append(f"synth{tag}{'' if split is None else split}{i:04d}")
        clips.append(clips_range[1] if i == 0 else int(rng.integers(*clips_range)))
        lq = int(rng.integers(5, max_q_tokens + 1))
        np.savez(
            os.path.join(qdir, f"{vids[-1]}.npz"),
            last_hidden_state=rng.standard_normal((lq, t_dim), dtype=np.float32),
        )
    return rng, vids, vdir, qdir, clips


def make_synthetic_tvsum(
    root: str,
    n_queries: int = 5,
    domain: str = "BK",
    v_dim: int = 2816,
    t_dim: int = 512,
    min_clips: int = 60,
    max_clips: int = 330,
    clip_len: float = 2.0,
    seed: int = 0,
    max_q_tokens: int = 32,
    split: Optional[str] = None,
):
    """Write one TVSum domain under `root`: returns (ann_path, vid_dir,
    txt_dir). Each row carries `label`, (clips, 20) annotator scores in 1-5,
    `domain`, and null relevant windows / clip ids; each video is a
    `{vid}_rgb.npy` and a `{vid}_opt.npy` of v_dim / 2 channels, up to two
    clips longer than its labels (the dataset cuts them). Length mix (a
    guess): the first video max_clips clips, the others [min_clips,
    max_clips) clips of 2 s (videos of 2-11 minutes)."""
    rng, vids, vdir, qdir, clips = _hd_rows(root, n_queries, t_dim, (min_clips, max_clips),
                                            seed, max_q_tokens, split, "tvsum")
    rows = []
    for vid, n in zip(vids, clips):
        rows.append(dict(
            qid=vid, query=f"synthetic title {vid}", duration=n * clip_len, vid=vid,
            relevant_clip_ids=None, relevant_windows=None,
            label=rng.integers(1, 6, (n, 20)).astype(float).tolist(), domain=domain,
        ))
        extra = int(rng.integers(0, 3))
        for half in ("rgb", "opt"):
            np.save(os.path.join(vdir, f"{vid}_{half}.npy"),
                    rng.standard_normal((n + extra, v_dim // 2), dtype=np.float32))
    ann = os.path.join(root, "tvsum.jsonl" if split is None else f"{split}.jsonl")
    save_jsonl(rows, ann)
    return ann, vdir, qdir


def make_synthetic_youtube(
    root: str,
    n_queries: int = 8,
    domain: str = "dog",
    v_dim: int = 2816,
    t_dim: int = 512,
    min_clips: int = 30,
    max_clips: int = 300,
    seed: int = 0,
    max_q_tokens: int = 8,
    split: Optional[str] = None,
):
    """Write one YouTube-HL domain under `root`: returns (ann_path, vid_dir,
    txt_dir). Each row carries a binary `label` (clips, 1) with at least one
    highlight clip, `domain` and the domain as its query; each video is one
    `{vid}.npy`. Length mix (a guess): the first video max_clips clips, the
    others [min_clips, max_clips) clips of 1 s."""
    rng, vids, vdir, qdir, clips = _hd_rows(root, n_queries, t_dim, (min_clips, max_clips),
                                            seed, max_q_tokens, split, "yt")
    rows = []
    for vid, n in zip(vids, clips):
        label = (rng.random(n) < 0.3).astype(int)
        label[int(rng.integers(0, n))] = 1
        rows.append(dict(
            qid=vid, query=domain, duration=float(n), vid=vid, relevant_clip_ids=None,
            relevant_windows=None, label=[[int(x)] for x in label], domain=domain,
        ))
        np.save(os.path.join(vdir, f"{vid}.npy"),
                rng.standard_normal((n, v_dim), dtype=np.float32))
    ann = os.path.join(root, "youtube.jsonl" if split is None else f"{split}.jsonl")
    save_jsonl(rows, ann)
    return ann, vdir, qdir


# the words of the Charades writer's queries; write_glove covers all but the
# last, which stays out of the vocabulary (a zero row)
CHARADES_WORDS = ("person", "opens", "closes", "the", "door", "a", "book", "sits", "on",
                  "chair", "takes", "cup", "from", "table", "laughs", "holding", "phone",
                  "zzunknown")


def make_synthetic_charades(
    root: str,
    n_queries: int = 16,
    v_dim: int = 768,
    t_dim: int = 4096,
    clip_len: float = 1.0,
    min_duration: float = 15.0,
    max_duration: float = 45.0,
    max_clips: int = 256,
    seed: int = 0,
    max_q_tokens: int = 32,
    glove: bool = False,
):
    """Write a Charades-STA-format set under `root`, two queries a video:
    returns (ann_path, vid_dir, txt_dir). Rows carry an int qid (0, 1, ...),
    the query, vid, duration and one relevant window in seconds. Videos are
    `{vid}.npz` of duration / clip_len clips (at most max_clips); with
    `glove` (the VGG configuration: clip 1/6 s) the video directory is named
    `vgg_feats`, which selects the GloVe text path, and no text features
    are written (queries draw 4-10 words of CHARADES_WORDS). Length mix (a guess): the
    first video max_duration seconds, the others uniform over
    [min_duration, max_duration), about 30 s on average."""
    rng = np.random.default_rng(seed)
    vdir = os.path.join(root, "vgg_feats" if glove else "vid_feats")
    qdir = os.path.join(root, "txt_feats")
    os.makedirs(vdir, exist_ok=True)
    os.makedirs(qdir, exist_ok=True)
    rows = []
    for i in range(n_queries):
        vid = f"SYN{i // 2:04d}"
        if i % 2 == 0:
            duration = max_duration if i == 0 else round(
                float(rng.uniform(min_duration, max_duration)), 2)
            clips = min(max_clips, int(np.ceil(duration / clip_len)))
            np.savez(os.path.join(vdir, f"{vid}.npz"),
                     features=rng.standard_normal((clips, v_dim), dtype=np.float32))
        s = round(float(rng.uniform(0, duration - 3)), 2)
        e = round(float(rng.uniform(s + 2, min(duration, s + 20))), 2)
        words = rng.choice(CHARADES_WORDS, int(rng.integers(4, 11)))
        rows.append(dict(qid=i, query=" ".join(words), duration=duration, vid=vid,
                         relevant_windows=[[s, e]]))
        if not glove:
            lq = int(rng.integers(5, max_q_tokens + 1))
            np.savez(os.path.join(qdir, f"qid{i}.npz"),
                     last_hidden_state=rng.standard_normal((lq, t_dim), dtype=np.float32))
    ann = os.path.join(root, "charades.jsonl")
    save_jsonl(rows, ann)
    return ann, vdir, qdir


def write_glove(path: str, dim: int = 300, seed: int = 0) -> str:
    """A GloVe text file (`word v1 ... v_dim` lines) of the Charades
    writer's words but the last, random vectors from `seed`; returns
    `path`."""
    rng = np.random.default_rng(seed)
    with open(path, "w", encoding="utf-8") as f:
        for w in CHARADES_WORDS[:-1]:
            f.write(w + " " + " ".join(f"{x:.6f}" for x in rng.standard_normal(dim)) + "\n")
    return path


def make_synthetic_submission(n_queries: int = 1550, seed: int = 0, many_gt_every: int = 97):
    """(submission, ground truth) of a QVHighlights-val-sized set: 150 s
    videos of 75 clips, 1-3 GT windows a query (every `many_gt_every`-th
    query 16-20, past the native detection AP's limit of 15), 10 predicted
    windows and 75 saliency scores a query, about 12 annotated clips with
    three worker scores each. The mix is a guess at the split's."""
    rng = np.random.default_rng(seed)
    sub, gt = [], []
    for i in range(n_queries):
        ng = int(rng.integers(16, 21)) if i % many_gt_every == 0 else int(rng.integers(1, 4))
        starts = rng.integers(0, 70, ng) * 2.0
        wins = [[float(s), float(min(150.0, s + 2.0 * rng.integers(1, 20)))] for s in starts]
        ids = sorted({int(x) for x in rng.integers(0, 75, 12)})
        gt.append(dict(qid=i, duration=150, relevant_windows=wins, relevant_clip_ids=ids,
                       saliency_scores=[[int(x) for x in rng.integers(0, 5, 3)] for _ in ids]))
        pred_starts = rng.uniform(0, 140, 10)
        sub.append(dict(
            qid=i,
            pred_relevant_windows=[[round(a, 2), round(min(150.0, a + rng.uniform(2, 30)), 2),
                                    round(float(rng.uniform()), 4)] for a in pred_starts],
            pred_saliency_scores=[round(float(x), 4) for x in rng.standard_normal(75)]))
    return sub, gt
