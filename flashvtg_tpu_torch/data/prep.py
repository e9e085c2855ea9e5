"""Dataset preparation: regenerate the TVSum / YouTube-HL jsonl annotations.

The port's copy of flashvtg_tpu/data/prep.py (reference
data/tvsum/preprocess_json.py and data/youtube_uni/preprocess_json.py).
Given the raw annotation json (per-video anno / match arrays) and the
feature root (to keep the videos with features in every feature directory),
it writes train / val jsonl rows in the FlashVTG format:
  {qid, query, duration, vid, relevant_clip_ids: None,
   relevant_windows: None, label, domain}

Usage:
  python -m flashvtg_tpu_torch.data.prep tvsum --anno tvsum_anno.json \
      --feat_root /feats/tvsum --out_dir data/tvsum
  python -m flashvtg_tpu_torch.data.prep youtube --anno youtube_anno.json \
      --feat_root /feats/youtube_uni --out_dir data/youtube_uni
"""

from __future__ import annotations

import argparse
import json
import os
from glob import glob
from typing import Dict

import numpy as np

from flashvtg_tpu_torch.data.youtube_splits import YOUTUBE_SPLITS
from flashvtg_tpu_torch.utils.io import save_jsonl

# TVSum's domain splits (reference data/tvsum/tvsum_splits.py, the same
# table as TVSUM_SPLITS in FlashVTG/start_end_dataset.py:15-56)
TVSUM_SPLITS = {
    "BK": {"train": ["WxtbjNsCQ8A", "EE-bNr36nyA", "oDXZc0tZe04", "uGu_10sucQo"],
           "val": ["Se3oxnaPsz0"]},
    "BT": {"train": ["eQu1rNs0an0", "qqR6AEXwxoQ", "EYqVtI9YWJA", "iVt07TCkFM0"],
           "val": ["JgHubY5Vw3Y"]},
    "DS": {"train": ["kLxoNp-UchI", "NyBmCxDoHJU", "jcoYJXDG9sw", "-esJrBWj2d8"],
           "val": ["E11zDS9XGzg"]},
    "FM": {"train": ["_xMr-HKMfVA", "byxOvuiIJV0", "VuWGsYPqAX8", "xmEERLqJ2kU"],
           "val": ["JKpqYvAdIsw"]},
    "GA": {"train": ["xxdtq8mxegs", "i3wAGJaaktw", "0tmA_C6XwfM", "3eYKfiOEJNs"],
           "val": ["Bhxk-O1Y7Ho"]},
    "MS": {"train": ["Hl-__g2gn_A", "WG0MBPpPC6I", "LRw_obCPUt0", "37rzWOQsNIw"],
           "val": ["Yi4Ij2NM7U4"]},
    "PK": {"train": ["GsAD1KT1xo8", "XkqCExn6_Us", "b626MiF1ew4", "PJrm840pAUI"],
           "val": ["cjibtmSLxQ4"]},
    "PR": {"train": ["RBCABdttQmI", "z_6gVvQb2d0", "4wU_LUjG5Ic", "91IHQYk1IQM"],
           "val": ["fWutDQy1nnY"]},
    "VT": {"train": ["gzDbaEs1Rlg", "XzYM3PfTM4w", "98MoyGZKHXc", "AwmHb44_ouw"],
           "val": ["J0nA4VgnoCo"]},
    "VU": {"train": ["akI8YFjEmUw", "HT5vyqe0Xaw", "vdmoEJ5YbrQ", "xwqBXPGE9pQ"],
           "val": ["sTEELN-vY30"]},
}


def videos_with_features(feat_root: str):
    """Videos whose feature file exists in every feature subdirectory (None:
    no subdirectory, no filter)."""
    feat_dirs = sorted(glob(os.path.join(feat_root, "*")))
    if not feat_dirs:
        return None
    per_dir = [
        {os.path.basename(fn)[:-4] for fn in glob(os.path.join(fd, "*"))}
        for fd in feat_dirs
    ]
    return set.intersection(*per_dir)


def build_rows(anno: Dict, splits: Dict, dataset: str, available=None,
               sfc: bool = False):
    """(train rows, val rows). dataset='tvsum' writes the shipped
    tvsum_train.jsonl form, the raw (L, 20) annotator scores that the
    `tvsum` preset's labels and 20-annotator AP read; sfc=True writes the
    reference preprocess_json.py's one summed column instead (its `_sfc`
    variant). dataset='youtube' writes binary match labels."""
    train_rows, val_rows = [], []
    for vid, entry in anno.items():
        if available is not None and vid not in available:
            continue
        duration = float(entry["frames"]) / float(entry["fps"])
        domain = entry["domain"]
        if dataset == "tvsum":
            query = entry["title"]
            if sfc:  # reference preprocess_json.py:71-75
                label = [[s] for s in np.asarray(entry["anno"]).sum(1).tolist()]
            else:
                label = [list(map(float, r)) for r in entry["anno"]]
        else:  # youtube: binary match indicator (UniVTG convention)
            query = entry["domain"]
            label = [[1 if s > 0 else 0] for s in entry["match"]]
        row = {
            "qid": vid,
            "query": query,
            "duration": duration,
            "vid": vid,
            "relevant_clip_ids": None,
            "relevant_windows": None,
            "label": label,
            "domain": domain,
        }
        if dataset == "youtube":
            row.update(
                frames=float(entry["frames"]),
                fps=float(entry["fps"]),
                clip=entry["clip"],
                match=entry["match"],
            )
        split = splits.get(domain, {})
        if vid in split.get("train", ()):
            train_rows.append(row)
        elif vid in split.get("val", ()):
            val_rows.append(row)
    return train_rows, val_rows


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("dataset", choices=["tvsum", "youtube"])
    parser.add_argument("--anno", required=True, help="raw annotation json")
    parser.add_argument("--feat_root", default=None)
    parser.add_argument("--out_dir", required=True)
    parser.add_argument("--splits_json", default=None,
                        help="override the vendored domain splits")
    parser.add_argument("--sfc", action="store_true",
                        help="tvsum only: write the reference preprocess_json.py's "
                             "summed-annotator labels into *_sfc.jsonl files instead "
                             "of the standard 20-column tvsum_train.jsonl form")
    args = parser.parse_args(argv)

    with open(args.anno) as f:
        anno = json.load(f)
    if args.splits_json:
        with open(args.splits_json) as f:
            splits = json.load(f)
    elif args.dataset == "tvsum":
        splits = TVSUM_SPLITS
    else:
        splits = YOUTUBE_SPLITS

    available = videos_with_features(args.feat_root) if args.feat_root else None
    sfc = bool(args.sfc and args.dataset == "tvsum")
    train_rows, val_rows = build_rows(anno, splits, args.dataset, available, sfc=sfc)

    os.makedirs(args.out_dir, exist_ok=True)
    prefix = "tvsum" if args.dataset == "tvsum" else "youtube"
    suffix = "_sfc" if sfc else ""
    save_jsonl(train_rows, os.path.join(args.out_dir, f"{prefix}_train{suffix}.jsonl"))
    save_jsonl(
        val_rows,
        os.path.join(
            args.out_dir,
            f"tvsum_val{suffix}.jsonl" if prefix == "tvsum" else "youtube_valid.jsonl",
        ),
    )
    print(f"train {len(train_rows)}, val {len(val_rows)}")


if __name__ == "__main__":
    main()
