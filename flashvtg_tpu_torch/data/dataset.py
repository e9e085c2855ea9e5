"""Input pipeline: jsonl annotations + pre-extracted feature files.

Counterpart of flashvtg_tpu/data/dataset.py for moment retrieval: jsonl
rows; npz/npy/pt features from several `v_feat_dirs`, concatenated; row
l2-normalisation; the two TEF channels; truncation to max_v_l / max_q_l.
Features load with numpy (the JAX package's native C++ loader does the same
job and is not ported). With load_labels (training) every access draws the
row's labels anew from the dataset's seeded random.Random, as the reference
draws them per __getitem__: GT windows (span_windows), saliency labels
(saliency_sub_as_query for charades / TACoS-style sets, saliency_all for
QVHighlights), and txt_drop_ratio's zeroed text rows. The GloVe text path
and the TVSum / YouTube-HL layouts are not ported yet and are refused.
"""

from __future__ import annotations

import dataclasses
import os
import random
from os.path import join
from typing import Optional, Sequence

import numpy as np

from flashvtg_tpu_torch.data import labels as L
from flashvtg_tpu_torch.utils.io import l2_normalize, load_jsonl

# sets whose saliency labels are the GT window itself
SUB_AS_QUERY = ("charadesSTA", "tacos", "activitynet", "nlq", "charadesSTA_internvideo2")


@dataclasses.dataclass
class DataConfig:
    dset_name: str = "hl"
    data_path: str = ""
    v_feat_dirs: Sequence[str] = ()
    q_feat_dir: str = ""
    q_feat_type: str = "last_hidden_state"
    max_q_l: int = 32
    max_v_l: int = 75
    data_ratio: float = 1.0
    ctx_mode: str = "video_tef"
    normalize_v: bool = True
    normalize_t: bool = True
    dset_domain: Optional[str] = None
    load_labels: bool = False  # training labels, drawn per access
    clip_len: float = 2.0
    max_windows: int = 5
    txt_drop_ratio: float = 0.0
    seed: int = 2024


def strip_vid_suffix(vid: str) -> str:
    """Drop the trailing `_<start>_<end>` segments of a QVHighlights vid
    (reference model.py:25-33 find_nth + :140-145), so clips cut from one
    source video count as false negatives."""
    count = vid.count("_")
    if count == 0:
        return vid
    # find_nth walks `while n > 1`: n = 0 and n = 1 both cut at the first "_"
    n = max(1, count - 1)
    seen = 0
    for i, ch in enumerate(vid):
        if ch == "_":
            seen += 1
            if seen == n:
                return vid[:i]
    return vid


def _load_array(path: str, key: Optional[str]) -> np.ndarray:
    if path.endswith(".npz"):
        return np.load(path)[key or "features"]
    if path.endswith(".npy"):
        return np.load(path)
    if path.endswith(".pt"):
        import torch

        return torch.load(path, map_location="cpu").float().numpy()
    raise ValueError(f"unsupported feature file: {path}")


def _try_paths(paths_and_keys, max_rows: int = 0, l2norm: bool = False):
    """Load the first existing candidate feature file, truncated to
    `max_rows` (0 = all) and row-l2-normalised on request."""
    last_err = None
    for path, key in paths_and_keys:
        if not os.path.exists(path):
            last_err = FileNotFoundError(path)
            continue
        try:
            arr = np.asarray(_load_array(path, key), np.float32)
        except (KeyError, ValueError) as e:
            last_err = e
            continue
        if max_rows > 0:
            arr = arr[:max_rows]
        return l2_normalize(arr) if l2norm else arr
    raise FileNotFoundError(f"no feature file found: {last_err}")


class VTGDataset:
    """One (query, video) pair per row; item i is (meta, features)."""

    def __init__(self, cfg: DataConfig, preload: bool = True):
        if cfg.dset_name in ("tvsum", "tvsum_sfc", "youtube_uni") or (
            cfg.v_feat_dirs and "vgg" in cfg.v_feat_dirs[0]
        ):
            raise NotImplementedError(
                f"{cfg.dset_name} data layout is not ported yet"
            )
        self.cfg = cfg
        self.rng = random.Random(cfg.seed)
        self.use_tef = "tef" in cfg.ctx_mode
        self.use_video = "video" in cfg.ctx_mode
        self.data = load_jsonl(cfg.data_path)
        if cfg.data_ratio != 1:
            self.data = self.data[: int(len(self.data) * cfg.data_ratio)]
        self._cache = [None] * len(self.data)
        if preload:
            for i in range(len(self.data)):
                self._cache[i] = self._build(self.data[i])

    def __len__(self):
        return len(self.data)

    def __getitem__(self, index):
        """(meta, inputs): cached features; with load_labels, labels and
        txt_drop drawn anew on every access."""
        if self._cache[index] is None:
            self._cache[index] = self._build(self.data[index])
        out = dict(self._cache[index])
        if self.cfg.txt_drop_ratio > 0:
            out["query_feat"] = self._drop_rows(out["query_feat"])
        if self.cfg.load_labels:
            self._attach_labels(self.data[index], out)
        return self.data[index], out

    def _drop_rows(self, emb):
        k = round(len(emb) * self.cfg.txt_drop_ratio)
        if k > 0:
            idx = self.rng.sample(range(len(emb)), k)
            emb = emb.copy()
            emb[idx] = 0
        return emb

    def _attach_labels(self, meta, out: dict) -> None:
        cfg = self.cfg
        if "relevant_windows" not in meta:  # a test split without labels
            return
        ctx_l = len(out["video_feat"]) if self.use_video else cfg.max_v_l
        out["gt_windows"] = L.span_windows(
            meta["relevant_windows"], ctx_l, cfg.clip_len, cfg.max_windows, self.rng
        )
        if cfg.dset_name in SUB_AS_QUERY:
            pos, neg, sal = L.saliency_sub_as_query(
                meta["relevant_windows"][0], meta["duration"], ctx_l, self.rng
            )
        else:
            pos, neg, sal = L.saliency_all(
                meta["relevant_clip_ids"], meta["saliency_scores"], ctx_l, self.rng
            )
        out["saliency_pos_labels"] = np.asarray(pos, np.int64)
        out["saliency_neg_labels"] = np.asarray(neg, np.int64)
        out["saliency_all_labels"] = np.asarray(sal, np.float32)

    def _query_feat(self, meta) -> np.ndarray:
        cfg = self.cfg
        qid = meta["qid"]
        candidates = [
            (join(cfg.q_feat_dir, f"qid{qid}.npz"), cfg.q_feat_type),
            (join(cfg.q_feat_dir, f"{qid}.npz"), cfg.q_feat_type),
            (join(cfg.q_feat_dir, f"{qid}.npy"), cfg.q_feat_type),
        ]
        trunc = cfg.max_q_l if cfg.q_feat_type == "last_hidden_state" else 0
        return _try_paths(candidates, max_rows=trunc, l2norm=cfg.normalize_t)

    def _video_feat(self, vid: str) -> np.ndarray:
        cfg = self.cfg
        feats = [
            _try_paths(
                [
                    (join(d, f"{vid}.npz"), "features"),
                    (join(d, f"{vid}.pt"), None),
                    (join(d, f"{vid}.npy"), None),
                ],
                max_rows=cfg.max_v_l,
                l2norm=cfg.normalize_v,
            )
            for d in cfg.v_feat_dirs
        ]
        n = min(len(f) for f in feats)
        return np.concatenate([f[:n] for f in feats], axis=1)

    def _build(self, meta) -> dict:
        cfg = self.cfg
        out = {"vid": meta["vid"], "qid": meta["qid"]}
        out["query_feat"] = self._query_feat(meta)
        if self.use_video:
            out["video_feat"] = self._video_feat(meta["vid"])
            ctx_l = len(out["video_feat"])
        else:
            ctx_l = cfg.max_v_l
        if self.use_tef:
            tef_st = np.arange(0, ctx_l, dtype=np.float32) / ctx_l
            tef = np.stack([tef_st, tef_st + 1.0 / ctx_l], axis=1)
            out["video_feat"] = (
                np.concatenate([out["video_feat"], tef], axis=1)
                if self.use_video
                else tef
            )
        return out
