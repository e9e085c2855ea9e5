"""Where the device time of one eval or train step goes, on the card.

    python -m flashvtg_tpu_torch.tools.profile_eval [--preset qvhighlights_slowclip]
        [--bsz <the preset's eval_bsz, or bsz with --train>] [--steps 10] [--train]

Any preset of train/config.py but the `_ms` ones: qvhighlights_slowclip,
tacos, tvsum, youtube_uni, charades, charades_internvideo2, charades_vgg,
... Builds the preset's model at full width and depth (random weights from
--seed), one batch of random features at the preset's video bucket with
ragged video lengths (`video_lengths`: 60-330 clips of Lv 1000 for the HD
sets, videos of 15-45 s for Charades-STA, max(20, Lv / 32) clips to Lv
otherwise) and ragged text, and profiles --steps eval steps (forward +
decode, or the forward alone for the HD sets, inputs already on the card)
with torch.profiler; with --train, train steps instead (train forward with
both passes, losses, backward, clipping, AdamW; every dropout at its
preset value), on labels of one window per video (saliency 1 inside it,
two positive and two negative clips, as TACoS labels are drawn) or, for
the HD sets, TVSum-like clip scores. Prints the card's name and power
limit, then one JSON line: host wall time and device-busy time per step,
the idle share, device time by kernel class (each of the port's attention
kernels by name, forward and backward, GEMMs, convolutions, the rest) and
the top kernels by device time.
"""

from __future__ import annotations

import argparse
import collections
import json
import re
import subprocess
import time

import numpy as np
import torch

from flashvtg_tpu_torch.data.dataset import HD_SETS
from flashvtg_tpu_torch.models.flashvtg import build_model
from flashvtg_tpu_torch.models.points import pyramid_masks_strict
from flashvtg_tpu_torch.train.config import from_preset
from flashvtg_tpu_torch.train.infer import make_eval_step
from flashvtg_tpu_torch.train.loop import make_optimizer, make_train_step
from flashvtg_tpu_torch.utils.runtime import resolve_device


def kernel_class(name: str) -> str:
    low = name.lower()
    if "flash_attention_kernel" in low:
        return "flash_attention"
    if "flash_bwd_" in low:
        return "flash_attention_bwd"
    if "aca_attention_bwd" in low:  # the kernel and its chunk-sum pass
        return "aca_attention_bwd"  # the ACA and the short self-attention's
    hm = re.search(r"aca_attention_kernel<\d+,\s*(true|false)", low)
    if hm:
        # one template: with the head mean it is the ACA core, without it
        # the short masked self-attention
        return "aca_attention" if hm.group(1) == "true" else "masked_attention"
    if "gemm" in low or "cutlass" in low or "xmma" in low or "matmul" in low:
        return "gemm"
    if "conv" in low or "cudnn" in low:
        return "conv"
    if "memcpy" in low or "memset" in low:
        return "memcpy/memset"
    return "other"


def video_lengths(cfg, rng, b):
    """Ragged valid clip counts of a batch, guessed length mixes: TVSum-like
    60-330 clips for the HD sets (videos of 2-11 minutes at 2 s), videos of
    15-45 s for Charades-STA, max(20, Lv / 32) to Lv clips otherwise."""
    lv = cfg.max_v_l
    if cfg.dset_name in HD_SETS:
        lo, hi = 60, 330
    elif cfg.dset_name.startswith("charadesSTA"):
        lo, hi = int(15 / cfg.clip_length), int(45 / cfg.clip_length)
    else:
        lo, hi = max(20, lv // 32), lv
    return rng.integers(min(lo, lv), min(hi, lv) + 1, b)


def hd_labels(rng, v_lens, lv, max_windows):
    """HD train targets: TVSum-like clip scores (annotator sums over 80
    times 12) on the valid clips, the highest and the lowest clip as the
    positive and the negative, GT windows one zero row."""
    b = len(v_lens)
    valid = np.arange(lv)[None] < np.asarray(v_lens)[:, None]
    sal = np.where(valid, rng.integers(0, 81, (b, lv)) / 80 * 12, 0).astype(np.float32)
    pos = np.argmax(np.where(valid, sal, -1), axis=1)[:, None]
    neg = np.argmin(np.where(valid, sal, 99), axis=1)[:, None]
    gt = np.full((b, max_windows, 2), np.inf, np.float32)
    gt[:, 0] = 0.0
    return dict(saliency_all_labels=sal, saliency_pos_labels=pos.astype(np.int64),
                saliency_neg_labels=neg.astype(np.int64), gt_windows=gt,
                real_neg_mask=np.ones(b, np.float32))


def window_labels(rng, v_lens, lv, clip_length, max_windows):
    """Train targets of one window per video, in TACoS's form: saliency 1
    inside the window, two positive clips in it and two negatives outside,
    the window in seconds, the other window slots +inf."""
    b = len(v_lens)
    sal = np.zeros((b, lv), np.float32)
    pos, neg = np.zeros((b, 2), np.int64), np.zeros((b, 2), np.int64)
    gt = np.full((b, max_windows, 2), np.inf, np.float32)
    for i, n in enumerate(v_lens):
        s = int(rng.integers(0, n - 2))
        e = int(rng.integers(s + 1, min(n, s + 64)))
        sal[i, s:e] = 1.0
        pos[i] = rng.integers(s, e, 2)
        neg[i] = [int(x) for x in rng.choice(np.r_[0:s, e:n], 2)]
        gt[i, 0] = (s * clip_length, e * clip_length)
    return dict(saliency_all_labels=sal, saliency_pos_labels=pos, saliency_neg_labels=neg,
                gt_windows=gt, real_neg_mask=np.ones(b, np.float32))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--preset", default="qvhighlights_slowclip")
    ap.add_argument("--bsz", type=int, default=None)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--train", action="store_true", help="profile train steps")
    args = ap.parse_args()

    dev = resolve_device("cuda")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0])
    cfg = from_preset(args.preset)
    model = build_model(cfg.model_config(), dev, args.seed)
    rng = np.random.default_rng(args.seed)
    b = args.bsz or (cfg.bsz if args.train else cfg.eval_bsz)
    lv, lq = cfg.max_v_l, cfg.max_q_l
    v_lens = video_lengths(cfg, rng, b)
    q_lens = rng.integers(5, lq + 1, b)
    batch = {
        "src_txt": rng.standard_normal((b, lq, cfg.t_feat_dim), dtype=np.float32),
        "src_txt_mask": (np.arange(lq)[None] < q_lens[:, None]).astype(np.float32),
        "src_vid": rng.standard_normal((b, lv, cfg.total_v_feat_dim), dtype=np.float32),
        "src_vid_mask": (np.arange(lv)[None] < v_lens[:, None]).astype(np.float32),
    }
    hd = cfg.dset_name in HD_SETS
    if args.train and hd:
        batch.update(hd_labels(rng, v_lens, lv, cfg.max_windows))
    elif args.train:
        batch.update(window_labels(rng, v_lens, lv, cfg.clip_length, cfg.max_windows))
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    if args.train:
        optimizer, scheduler = make_optimizer(cfg, model.parameters(), 1)
        train_step = make_train_step(model.train(), cfg.loss_config(), optimizer, scheduler,
                                     cfg.grad_clip, torch.Generator().manual_seed(args.seed))

        def step():
            train_step(batch)
    else:
        pv = torch.from_numpy(pyramid_masks_strict(v_lens, lv, cfg.strides)[0]).to(dev)
        eval_step = make_eval_step(model, cfg.max_num_moment, saliency_only=hd)

        def step():
            eval_step(batch, pv)
    for _ in range(3):
        step()
    torch.cuda.synchronize()

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    per_name = collections.defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            per_name[e.name][0] += e.time_range.elapsed_us()
            per_name[e.name][1] += 1
    busy_us = sum(us for us, _ in per_name.values())
    classes = collections.defaultdict(float)
    for name, (us, _) in per_name.items():
        classes[kernel_class(name)] += us
    n = args.steps
    top = sorted(per_name.items(), key=lambda kv: -kv[1][0])[:12]
    print(json.dumps({
        "preset": args.preset, "mode": "train" if args.train else "eval", "bsz": b, "steps": n,
        # the self-attention's valid keys: the flash kernel skips the rest
        "valid_clips": int(v_lens.sum()), "padded_clips": b * lv,
        "wall_ms_per_step": wall * 1e3 / n,
        "device_busy_ms_per_step": busy_us / 1e3 / n if busy_us else None,
        "idle_share": 1 - busy_us / 1e6 / wall if busy_us else None,
        "class_ms_per_step": {k: v / 1e3 / n for k, v in classes.items()},
        "top": [
            {"name": name[:90], "ms_per_step": us / 1e3 / n, "calls_per_step": c / n}
            for name, (us, c) in top
        ],
    }))


if __name__ == "__main__":
    main()
