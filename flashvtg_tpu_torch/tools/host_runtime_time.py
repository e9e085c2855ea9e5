"""Times the flagship eval's feature loading on the host: the split read row
by row, and the device feed's build, whose thread pool reads the rows.

    python -m flashvtg_tpu_torch.tools.host_runtime_time [--queries 1550]
        [--root DIR] [--device cuda] [--seed 0]

Writes a QVHighlights-val-sized split at the flagship's widths under --root
(default: a temporary directory), or reuses the one already there: --queries
videos of 75 clips, SlowFast (2304) and CLIP (512) `.npz` features in two
directories, CLIP text `qid{qid}.npz` `last_hidden_state` of 5 to 32 tokens
(utils/synthetic.py:make_synthetic_qvh for the CLIP video, the text and the
annotations). Then it times:
  * `preload_s`: VTGDataset with preload (one thread, row by row, the
    cut to max_v_l / max_q_l and the l2-norm), and its ms a row;
  * `feed_build_s`: data/feed.py:build_device_feed of the eval split (the
    preset's eval collator at max_v_l) on --device from a dataset without
    preload, so its thread pool reads every row.
The files are read warm: the split was just written or read before. Prints
the card's name and power limit (on --device cuda), the host's CPU model
and cores, then one JSON line, which holds the host runtime's counts of
rows loaded natively and declined where the tree has
flashvtg_tpu_torch/runtime.

It uses only the package's dataset and feed functions, so it also times
another tree of the package (one without the host runtime reads every file
with numpy): put that tree first on PYTHONPATH and run this file by its
path.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

SLOWFAST_DIM, CLIP_DIM, CLIPS = 2304, 512, 75


def write_split(root: str, n_queries: int, seed: int):
    """(annotation path, (SlowFast dir, CLIP dir), text dir) of the split
    under `root`, written unless its annotation file is there."""
    from flashvtg_tpu_torch.utils.io import load_jsonl
    from flashvtg_tpu_torch.utils.synthetic import make_synthetic_qvh

    ann = os.path.join(root, "val.jsonl")
    sf_dir, clip_dir, txt_dir = (os.path.join(root, d) for d in
                                 ("slowfast", "vid_feats", "txt_feats"))
    if not os.path.exists(ann):
        ann, clip_dir, txt_dir = make_synthetic_qvh(
            root, n_queries=n_queries, v_dim=CLIP_DIM, t_dim=CLIP_DIM, n_clips=CLIPS,
            seed=seed, max_q_tokens=33, split="val")
        os.makedirs(sf_dir, exist_ok=True)
        rng = np.random.default_rng(seed + 1)
        for row in load_jsonl(ann):
            np.savez(os.path.join(sf_dir, f"{row['vid']}.npz"),
                     features=rng.standard_normal((CLIPS, SLOWFAST_DIM), dtype=np.float32))
    return ann, (sf_dir, clip_dir), txt_dir


def cpu_model() -> str:
    """The host CPU's model name as lscpu gives it; where that is unknown
    (a virtual machine may hide it), its vendor, family and model numbers."""
    fields = {}
    for line in subprocess.run(["lscpu"], capture_output=True, text=True).stdout.splitlines():
        key, _, value = line.partition(":")
        fields[key.strip()] = value.strip()
    name = fields.get("Model name", "unknown")
    if name in ("", "unknown"):
        name = (f"{fields.get('Vendor ID', '?')} family {fields.get('CPU family', '?')} "
                f"model {fields.get('Model', '?')} (model name unknown)")
    return name


def measure(ann, v_dirs, txt_dir, device) -> dict:
    import torch

    from flashvtg_tpu_torch.data.collate import Collator
    from flashvtg_tpu_torch.data.dataset import VTGDataset
    from flashvtg_tpu_torch.data.feed import build_device_feed
    from flashvtg_tpu_torch.train.config import from_preset
    from flashvtg_tpu_torch.train.infer import eval_data_config

    has_runtime = importlib.util.find_spec("flashvtg_tpu_torch.runtime") is not None
    if has_runtime:
        from flashvtg_tpu_torch import runtime

        runtime.reset_counts()
    cfg = from_preset("qvhighlights_slowclip", eval_path=ann, v_feat_dirs=v_dirs,
                      t_feat_dir=txt_dir)
    dcfg = eval_data_config(cfg, ann)
    t0 = time.perf_counter()
    ds = VTGDataset(dcfg)
    preload_s = time.perf_counter() - t0

    fresh = VTGDataset(dcfg, preload=False)
    collator = Collator(max_q_l=cfg.max_q_l, v_buckets=cfg.v_buckets,
                        fixed_v_len=cfg.max_v_l, dset_name=cfg.dset_name)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    feed = build_device_feed(fresh, collator, device)
    feed_build_s = time.perf_counter() - t0  # build_device_feed ends synchronised
    n = len(ds)
    assert n == len(fresh) and all(len(v) == n for v in feed.values())
    return dict(
        tree=os.path.dirname(os.path.dirname(os.path.abspath(sys.modules[
            "flashvtg_tpu_torch"].__file__))),
        host_runtime=has_runtime, rows=n, preload_s=preload_s, preload_ms_a_row=preload_s * 1e3 / n,
        feed_build_s=feed_build_s, feed_bytes=sum(t.numel() * t.element_size()
                                                  for t in feed.values()),
        counts=runtime.counts() if has_runtime else None)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--queries", type=int, default=1550)
    ap.add_argument("--root", default=None, help="where the split is written or reused")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            print("host_runtime_time: CUDA is not available", file=sys.stderr)
            return 2
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip().splitlines()[0])
    print(f"{cpu_model()}, {len(os.sched_getaffinity(0))} cores", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        root = args.root or tmp
        os.makedirs(root, exist_ok=True)
        t0 = time.perf_counter()
        ann, v_dirs, txt_dir = write_split(root, args.queries, args.seed)
        split_s = time.perf_counter() - t0
        res = measure(ann, v_dirs, txt_dir, device)
    print(json.dumps(dict(res, split_s=split_s, device=str(device))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
