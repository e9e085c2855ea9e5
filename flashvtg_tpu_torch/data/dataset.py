"""Input pipeline: jsonl annotations + pre-extracted feature files.

Counterpart of flashvtg_tpu/data/dataset.py for moment retrieval: jsonl
rows; npz/npy/pt features from several `v_feat_dirs`, concatenated; row
l2-normalisation; the two TEF channels; truncation to max_v_l / max_q_l.
Features load with numpy (the JAX package's native C++ loader does the same
job and is not ported). With load_labels (training) every access draws the
row's labels anew from the dataset's seeded random.Random, as the reference
draws them per __getitem__: GT windows (span_windows), saliency labels
(saliency_sub_as_query for charades / TACoS-style sets, saliency_all for
QVHighlights, saliency_tvsum / saliency_youtube for the highlight-detection
sets, whose GT windows are one zero row), and txt_drop_ratio's zeroed text
rows. With eos_first (the FlashVTG_ms InternVideo2 text) a `{qid}.npy`
query, when no `.npz` one exists, is reordered to its last (EOS) row
followed by rows 4..-1, before the max_q_l cut and the l2-norm.

The highlight-detection (HD) layouts: TVSum and YouTube-HL train and
evaluate per domain (dset_domain, refused when missing); their text is
`{qid}.npz` `last_hidden_state`, read as it is: no l2-norm and no max_q_l
cut, unlike the MR sets. A TVSum video is `{vid}_rgb.npy` + `{vid}_opt.npy`,
each cut to max_v_l, concatenated and l2-normalised after the
concatenation (else `{vid}.npy` / `.npz`), and its clips past the label
rows are dropped after the TEF. With a first video directory whose path
holds "vgg" (Charades-STA VGG), the text is the query's GloVe vectors
(data/glove.py).
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
TVSUM_DOMAINS = ("BK", "BT", "DS", "FM", "GA", "MS", "PK", "PR", "VT", "VU")
YOUTUBE_DOMAINS = ("dog", "gymnastics", "parkour", "skating", "skiing", "surfing")
# the highlight-detection sets: saliency rows only, scored by eval/hl.py
HD_SETS = ("tvsum", "youtube_uni")


def uses_glove(v_feat_dirs: Sequence[str]) -> bool:
    """The text is GloVe vectors when the first video directory is VGG's."""
    return bool(v_feat_dirs) and "vgg" in v_feat_dirs[0]


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
    # the _ms InternVideo2 text layout of `{qid}.npy`: last row (EOS) first
    eos_first: bool = False
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
        self.cfg = cfg
        self.rng = random.Random(cfg.seed)
        self.use_tef = "tef" in cfg.ctx_mode
        self.use_video = "video" in cfg.ctx_mode
        self.use_glove = uses_glove(cfg.v_feat_dirs)
        self._glove = None
        self.data = load_jsonl(cfg.data_path)
        if cfg.data_ratio != 1:
            self.data = self.data[: int(len(self.data) * cfg.data_ratio)]
        domains = {"tvsum": TVSUM_DOMAINS, "tvsum_sfc": TVSUM_DOMAINS,
                   "youtube_uni": YOUTUBE_DOMAINS}.get(cfg.dset_name)
        if domains is not None:
            if cfg.dset_domain not in domains:
                name = "tvsum" if cfg.dset_name == "tvsum_sfc" else cfg.dset_name
                raise ValueError(
                    f"{name} trains per domain: pass --dset_domain, one of "
                    f"{sorted(domains)} (got {cfg.dset_domain!r})"
                )
            self.data = [d for d in self.data if d["domain"] == cfg.dset_domain]
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

    def features_only(self, index):
        """(meta, inputs) with the cached features alone: no labels and no
        txt_drop, so no draw of the label stream is consumed (the device
        feed's bulk pass, data/feed.py)."""
        if self._cache[index] is None:
            self._cache[index] = self._build(self.data[index])
        return self.data[index], dict(self._cache[index])

    def _drop_rows(self, emb):
        k = round(len(emb) * self.cfg.txt_drop_ratio)
        if k > 0:
            idx = self.rng.sample(range(len(emb)), k)
            emb = emb.copy()
            emb[idx] = 0
        return emb

    def _attach_labels(self, meta, out: dict) -> None:
        cfg = self.cfg
        ctx_l = len(out["video_feat"]) if self.use_video else cfg.max_v_l
        if cfg.dset_name == "tvsum":
            out["gt_windows"] = np.zeros((1, 2), np.float32)
            pos, neg, sal = L.saliency_tvsum(meta["label"], ctx_l)
            out["video_feat"] = out["video_feat"][: len(sal)]
        elif cfg.dset_name == "youtube_uni":
            out["gt_windows"] = np.zeros((1, 2), np.float32)
            pos, neg, sal = L.saliency_youtube(meta["label"], ctx_l)
        elif "relevant_windows" not in meta:  # a test split without labels
            return
        else:
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
        if self.use_glove:
            if self._glove is None:
                from flashvtg_tpu_torch.data.glove import GloveEmbedder

                self._glove = GloveEmbedder.default()
            return self._glove(meta["query"])
        qid = meta["qid"]
        if cfg.dset_name in HD_SETS:
            q = np.load(join(cfg.q_feat_dir, f"{qid}.npz"))["last_hidden_state"]
            return np.asarray(q, np.float32)
        candidates = [
            (join(cfg.q_feat_dir, f"qid{qid}.npz"), cfg.q_feat_type),
            (join(cfg.q_feat_dir, f"{qid}.npz"), cfg.q_feat_type),
            (join(cfg.q_feat_dir, f"{qid}.npy"), cfg.q_feat_type),
        ]
        trunc = cfg.max_q_l if cfg.q_feat_type == "last_hidden_state" else 0
        npy_path = candidates[2][0]
        if cfg.eos_first and os.path.exists(npy_path) and not any(
            os.path.exists(p) for p, _ in candidates[:2]
        ):
            # the EOS row, then rows 4..-1, before the cut and the l2-norm
            q = _try_paths([(npy_path, None)])
            q = np.concatenate([q[-1:], q[4:-1]], axis=0)
            q = q[:trunc] if trunc else q
            return l2_normalize(q) if cfg.normalize_t else q
        return _try_paths(candidates, max_rows=trunc, l2norm=cfg.normalize_t)

    def _video_feat(self, vid: str) -> np.ndarray:
        feats = [self._dir_feat(d, vid) for d in self.cfg.v_feat_dirs]
        n = min(len(f) for f in feats)
        return np.concatenate([f[:n] for f in feats], axis=1)

    def _dir_feat(self, d: str, vid: str) -> np.ndarray:
        """One feature directory's rows of a video, cut to max_v_l. TVSum's
        rgb + optical-flow halves are l2-normed over their concatenation."""
        cfg = self.cfg
        rgb_path = join(d, f"{vid}_rgb.npy")
        if cfg.dset_name == "tvsum" and os.path.exists(rgb_path):
            rgb = _try_paths([(rgb_path, None)], max_rows=cfg.max_v_l)
            opt = _try_paths([(join(d, f"{vid}_opt.npy"), None)], max_rows=cfg.max_v_l)
            f = np.concatenate([rgb, opt], -1)
            return l2_normalize(f) if cfg.normalize_v else f
        if cfg.dset_name == "tvsum":
            candidates = [(join(d, f"{vid}.npy"), None), (join(d, f"{vid}.npz"), "features")]
        else:
            candidates = [
                (join(d, f"{vid}.npz"), "features"),
                (join(d, f"{vid}.pt"), None),
                (join(d, f"{vid}.npy"), None),
            ]
        return _try_paths(candidates, max_rows=cfg.max_v_l, l2norm=cfg.normalize_v)

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
        # TVSum drops the clips past the label rows (a fixed cut, so it
        # belongs to the cached features)
        if cfg.dset_name == "tvsum" and "video_feat" in out and "label" in meta:
            n = min(len(meta["label"]), cfg.max_v_l, len(out["video_feat"]))
            out["video_feat"] = out["video_feat"][:n]
        return out
