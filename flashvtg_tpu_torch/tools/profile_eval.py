"""Where the device time of one eval or train step goes, on the card.

    python -m flashvtg_tpu_torch.tools.profile_eval [--preset qvhighlights_slowclip]
        [--bsz <the preset's eval_bsz, or bsz with --train>] [--steps 10] [--train]
        [--precision float32 [tensorfloat32 bfloat16]] [--feed] [--scan K]

Any preset of train/config.py: qvhighlights_slowclip, tacos, tvsum,
youtube_uni, charades, charades_internvideo2, charades_vgg, and the
FlashVTG_ms presets tvsum_ms and youtube_uni_ms. Builds the preset's model
(its variant's) at full width and depth (random weights from
--seed), one batch of random features at the preset's video bucket with
ragged video lengths (`video_lengths`: 60-330 clips of Lv 1000 for the HD
sets, videos of 15-45 s for Charades-STA, max(20, Lv / 32) clips to Lv
otherwise) and ragged text, and profiles --steps eval steps (forward +
decode, or the forward alone for the HD sets, inputs already on the card)
with torch.profiler; with --train, train steps instead (train forward with
both passes, losses, backward, clipping, AdamW; every dropout at its
preset value), on labels of one window per video (saliency 1 inside it,
two positive and two negative clips, as TACoS labels are drawn) or, for
the HD sets, TVSum-like clip scores. Each --precision mode (the
eval or train step's dial, utils/runtime.py:matmul_precision) is profiled
in turn on the same model and batch. Prints the card's name and power
limit, then one JSON line a mode: host wall time and device-busy time per
step, the idle share, the achieved TFLOP/s, `mfu` and `mfu_effective` at
the wall time (utils/flops.py: the core model's analytic FLOPs at the
padded shapes, against the bf16 peak and the dial's measured eval or
train ceiling; none for FlashVTG_ms), device time by kernel class (each of the port's
attention kernels by name, forward and backward, GEMMs, convolutions,
casts: the kernels of every dtype conversion, autocast's included, found
by their `aten::_to_copy` op; the rest) and the top kernels by device
time. For a FlashVTG_ms model it also reports
`lgi_attention`: the device time of the plain LGI attention modules
(models/lgi.py MHACore: projections, logits, softmax, dropout, p.v), the
kernels launched inside them (forward) and by the autograd nodes of their
ops (backward, matched by sequence number), and its share of the busy time;
these kernels are also in the classes above.

--feed and --scan K profile the feeding modes instead, each on its own
line, at the first --precision: with --train, the streamed step (the batch
placed per step, blocking), the streamed epoch with the copy ahead, the
feed step (labels and row indices uploaded per step, the features gathered
from a device-resident feed) and, with --scan K, the streamed epoch's
graph replays and the scan epoch (K steps a chunk, each a CUDA-graph
replay), all through
utils/scanbench.py's harness (the production step at the preset's shapes,
synthetic features); for eval (--scan does not apply), the streamed and the
feed path of train/infer.py (one upload, the packed step, one non-blocking
fetch a batch, PIPELINE_DEPTH batches in flight) over --steps batches of a
synthetic split. Each line has the host wall time and device-busy time per
step and the idle share; a graph's replayed kernels are in the class
breakdown by name.
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
from flashvtg_tpu_torch.models import build_model
from flashvtg_tpu_torch.models.lgi import MHACore
from flashvtg_tpu_torch.models.points import pyramid_masks_strict
from flashvtg_tpu_torch.train.config import from_preset
from flashvtg_tpu_torch.train.infer import make_eval_step
from flashvtg_tpu_torch.train.loop import make_optimizer, make_train_step
from flashvtg_tpu_torch.utils.flops import step_mfu
from flashvtg_tpu_torch.utils.runtime import PRECISIONS, resolve_device


def kernel_class(name: str) -> str:
    low = name.lower()
    if "flash_attention_kernel" in low:
        return "flash_attention"
    if "flash_bwd_" in low:
        return "flash_attention_bwd"
    if "aca_attention_bwd" in low:  # the kernel and its chunk-sum pass
        return "aca_attention_bwd"  # the ACA and the short self-attention's
    hm = re.search(r"aca_attention_kernel<\d+,\s*\d+,\s*(true|false)", low)
    if hm:
        # one template <form, key tiles, head mean, train>: with the head
        # mean it is the ACA core, without it the short masked self-attention
        return "aca_attention" if hm.group(1) == "true" else "masked_attention"
    # cuBLAS's bf16 GEMMs on this card are its "nvjet" kernels
    if ("gemm" in low or "cutlass" in low or "xmma" in low or "matmul" in low
            or "nvjet" in low):
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


LGI_TAG = "lgi_attention"
CAST_OP = "aten::_to_copy"  # every dtype conversion; autocast's casts call it


def cast_device_us(events):
    """Device microseconds of the kernels under the outermost CAST_OP ops
    (the conversions; their kernels are elementwise copies, "other" by
    name)."""
    total = 0.0
    for e in events:
        if e.device_type != torch.autograd.DeviceType.CPU or e.name != CAST_OP:
            continue
        p = e.cpu_parent
        while p is not None and p.name != CAST_OP:
            p = p.cpu_parent
        if p is None:
            total += sum(k.duration for k in e.kernels if "memcpy" not in k.name.lower()
                         and "memset" not in k.name.lower())
            total += sum(ch.device_time_total for ch in e.cpu_children)
    return total


def mark_modules(model, cls, tag):
    """Wrap every `cls` module's forward in a profiler range named `tag`."""
    open_ranges = []

    def enter(module, args):
        rf = torch.profiler.record_function(tag)
        rf.__enter__()
        open_ranges.append(rf)

    def leave(module, args, out):
        open_ranges.pop().__exit__(None, None, None)

    n = 0
    for m in model.modules():
        if isinstance(m, cls):
            m.register_forward_pre_hook(enter)
            m.register_forward_hook(leave)
            n += 1
    return n


def marked_device_us(events, tag):
    """(forward, backward) device microseconds of the `tag` ranges: the
    kernels launched inside them, and those of the backward nodes whose
    sequence number is one of an op inside them (outermost such node)."""
    cpu = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU]
    ranges = [e for e in cpu if e.name == tag]
    seqs = set()

    def walk(e):
        for ch in e.cpu_children:
            if ch.sequence_nr >= 0:
                seqs.add((ch.sequence_nr, ch.thread))
            walk(ch)

    for r in ranges:
        walk(r)
    hits = {id(e): e for e in cpu
            if e.scope == 1 and (e.sequence_nr, e.fwd_thread) in seqs}

    def nested(e):
        p = e.cpu_parent
        while p is not None:
            if id(p) in hits:
                return True
            p = p.cpu_parent
        return False

    bwd = sum(e.device_time_total for e in hits.values() if not nested(e))
    return sum(r.device_time_total for r in ranges), bwd


def profiled(run):
    """run() under torch.profiler (device activity only), fenced by a
    synchronize: (its wall seconds, {device kernel or copy name:
    [microseconds, calls]}). It reads the profiler's raw device records:
    building its op tree (`prof.events()`) takes minutes for a few dozen
    eager train steps."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    per_name = collections.defaultdict(lambda: [0.0, 0])
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA and not e.is_user_annotation():
            per_name[e.name()][0] += e.duration_ns() / 1e3
            per_name[e.name()][1] += 1
    return wall, per_name


def busy_summary(wall, per_name, steps):
    """The per-step wall and device-busy ms, the idle share and the device
    time by kernel class of a profiled run of `steps` steps."""
    busy_us = sum(us for us, _ in per_name.values())
    classes = collections.defaultdict(float)
    for name, (us, _) in per_name.items():
        classes[kernel_class(name)] += us
    return {
        "wall_ms_per_step": wall * 1e3 / steps,
        "device_busy_ms_per_step": busy_us / 1e3 / steps,
        "idle_share": 1 - busy_us / 1e6 / wall if busy_us else None,
        "class_ms_per_step": {k: v / 1e3 / steps for k, v in classes.items()},
    }


def profile(step, steps, n_marked):
    """Profile `steps` calls of step() (after 3 warm-up calls): the JSON
    fields of one mode."""
    for _ in range(3):
        step()
    torch.cuda.synchronize()

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    per_name = collections.defaultdict(lambda: [0.0, 0])
    events = prof.events()
    for e in events:
        # the ranges' own device-side annotations are not kernels
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)):
            per_name[e.name][0] += e.time_range.elapsed_us()
            per_name[e.name][1] += 1
    busy_us = sum(us for us, _ in per_name.values())
    classes = collections.defaultdict(float)
    for name, (us, _) in per_name.items():
        classes[kernel_class(name)] += us
    casts = cast_device_us(events)
    classes["casts"] = casts
    classes["other"] -= casts
    n = steps
    top = sorted(per_name.items(), key=lambda kv: -kv[1][0])[:12]
    lgi = None
    if n_marked:
        fwd_us, bwd_us = marked_device_us(events, LGI_TAG)
        lgi = {"modules": n_marked, "fwd_ms_per_step": fwd_us / 1e3 / n,
               "bwd_ms_per_step": bwd_us / 1e3 / n,
               "share_of_busy": (fwd_us + bwd_us) / busy_us if busy_us else None}
    return {
        "wall_ms_per_step": wall * 1e3 / n,
        "device_busy_ms_per_step": busy_us / 1e3 / n if busy_us else None,
        "idle_share": 1 - busy_us / 1e6 / wall if busy_us else None,
        "class_ms_per_step": {k: v / 1e3 / n for k, v in classes.items()},
        LGI_TAG: lgi,
        "top": [
            {"name": name[:90], "ms_per_step": us / 1e3 / n, "calls_per_step": c / n}
            for name, (us, c) in top
        ],
    }


def with_mfu(line: dict, cfg, bsz: int, precision: str, train: bool) -> dict:
    """`line` with the step's utilisation at its wall time per step."""
    util = step_mfu(cfg, bsz, line["wall_ms_per_step"] / 1e3, precision, train)
    return {**line, **(util or {})}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--preset", default="qvhighlights_slowclip")
    ap.add_argument("--bsz", type=int, default=None)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--train", action="store_true", help="profile train steps")
    ap.add_argument("--precision", nargs="+", default=["float32"], choices=PRECISIONS,
                    help="the step's dial; each mode given is profiled in turn")
    ap.add_argument("--feed", action="store_true",
                    help="profile the streamed and the device-feed paths instead")
    ap.add_argument("--scan", type=int, default=0, metavar="K",
                    help="with --train: also the scan epoch, K steps a chunk")
    args = ap.parse_args()

    dev = resolve_device("cuda")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0])
    cfg = from_preset(args.preset)
    if args.feed or args.scan:
        for line in feed_modes(cfg, args, dev):
            print(json.dumps(line), flush=True)
        return
    model = build_model(cfg.model_config(), dev, args.seed)
    n_marked = mark_modules(model, MHACore, LGI_TAG)
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
    for mode in args.precision:
        if args.train:
            optimizer, scheduler = make_optimizer(cfg, model.parameters(), 1)
            train_step = make_train_step(
                model.train(), cfg.loss_config(), optimizer, scheduler, cfg.grad_clip,
                torch.Generator(device=dev).manual_seed(args.seed), mode)

            def step():
                train_step(batch)
        else:
            pv = torch.from_numpy(pyramid_masks_strict(v_lens, lv, cfg.strides)[0]).to(dev)
            eval_step = make_eval_step(model, cfg.max_num_moment, mode, saliency_only=hd)

            def step():
                eval_step(batch, pv)
        print(json.dumps({
            "preset": args.preset, "mode": "train" if args.train else "eval",
            "precision": mode, "bsz": b, "steps": args.steps,
            # the self-attention's valid keys: the flash kernel skips the rest
            "valid_clips": int(v_lens.sum()), "padded_clips": b * lv,
            **with_mfu(profile(step, args.steps, n_marked), cfg, b, mode, args.train),
        }), flush=True)


def feed_modes(cfg, args, dev):
    """The --feed / --scan lines (see the module's doc)."""
    from flashvtg_tpu_torch.utils.scanbench import ScanHarness

    cfg = cfg.replace(train_precision=args.precision[0], eval_precision=args.precision[0])
    if not args.train:
        yield from eval_feed_modes(cfg, args, dev)
        return
    b = args.bsz or cfg.bsz
    k = args.scan or args.steps
    steps = max(k, args.steps - args.steps % k)
    for mode in ["streamed", "streamed_ahead", "feed"] + (
            ["streamed_graph", "scan"] if args.scan else []):
        h = ScanHarness(cfg.replace(bsz=b), cfg.max_v_l, cfg.max_q_l, cfg.t_feat_dim,
                        device=dev, n_feed_batches=4, seed=args.seed)
        h.run(mode, k, k).cpu()  # warm-up (and the capture)
        wall, per_name = profiled(lambda: h.run(mode, steps, k, i0=k).cpu())
        yield {"preset": args.preset, "mode": "train", "feed_mode": mode,
               "scan_steps": k if mode == "scan" else 0, "precision": cfg.train_precision,
               "bsz": b, "steps": steps,
               **with_mfu(busy_summary(wall, per_name, steps), cfg, b, cfg.train_precision,
                          True)}
        del h
        torch.cuda.empty_cache()


def eval_feed_modes(cfg, args, dev):
    """Streamed and feed eval over args.steps batches of a synthetic split
    at the preset's shapes, through train/infer.py's pipelined loop."""
    import tempfile

    from flashvtg_tpu_torch.data.dataset import VTGDataset
    from flashvtg_tpu_torch.train.infer import (
        FETCHES,
        eval_data_config,
        run_hl_inference,
        run_mr_inference,
    )
    from flashvtg_tpu_torch.utils import synthetic

    b = args.bsz or cfg.eval_bsz
    hd = cfg.dset_name in HD_SETS
    writer = {"tvsum": synthetic.make_synthetic_tvsum,
              "youtube_uni": synthetic.make_synthetic_youtube,
              "tacos": synthetic.make_synthetic_tacos}.get(cfg.dset_name,
                                                           synthetic.make_synthetic_qvh)
    with tempfile.TemporaryDirectory() as tmp:
        kw = dict(n_queries=b * args.steps, v_dim=cfg.v_feat_dim, t_dim=cfg.t_feat_dim,
                  seed=args.seed)
        if writer is synthetic.make_synthetic_qvh:
            kw["n_clips"] = cfg.max_v_l
        ann, vdir, qdir = writer(tmp, **kw)
        domain = cfg.dset_domain or {"tvsum": "BK", "youtube_uni": "dog"}.get(cfg.dset_name)
        cfg = cfg.replace(eval_path=ann, v_feat_dirs=(vdir,), t_feat_dir=qdir, eval_bsz=b,
                          dset_domain=domain)
        model = build_model(cfg.model_config(), dev, args.seed)
        infer = run_hl_inference if hd else run_mr_inference
        for mode in ("off", "on"):
            c = cfg.replace(device_feed=mode)
            ds = VTGDataset(eval_data_config(c, ann))
            infer(c, model, ds)  # warm-up (and the feed's build)
            fetches = FETCHES["d2h"]
            wall, per_name = profiled(lambda: infer(c, model, ds))
            batches = -(-len(ds) // b)
            yield {"preset": args.preset, "mode": "eval",
                   "feed_mode": "feed" if mode == "on" else "streamed",
                   "precision": c.eval_precision, "bsz": b, "steps": batches,
                   "fetches_per_batch": (FETCHES["d2h"] - fetches) / batches,
                   "queries_per_s": len(ds) / wall,
                   **with_mfu(busy_summary(wall, per_name, batches), c, b, c.eval_precision,
                              False)}


if __name__ == "__main__":
    main()
