"""Times the eager train step on the card: the batch placed, then one
update (forward, criterion, backward, clip, AdamW, schedule), as train()
runs a step when it streams its batches.

    python -m flashvtg_tpu_torch.tools.step_time [--preset qvhighlights_slowclip]
        [--precision float32 bfloat16] [--blocks 4] [--iters 10] [--variants]
        [--census N]

Builds the preset's model at full width and depth (random weights from
--seed) and one synthetic batch of its train shapes (random features, one
window a video, random saliency labels), warms the step up, then times
--blocks blocks of --iters steps each with CUDA events (the host-bound
step's wall time on the card's clock: a block's end event waits for the
last step). With --variants, where the tree's optimizer is the one a CUDA
graph can capture (train/loop.py:StepLR), it also times the step with
`plain_adamw`: AdamW with a float learning rate, neither capturable nor
fused, and a constant LambdaLR, on a model of its own from the same seed
and the same batch, the two steps' blocks in turns. Prints the card's
name and power limit, then one JSON line a (precision, variant): each
block's ms a step, their mean and spread, and at the mean the achieved
TFLOP/s, `mfu` (against the bf16 peak) and `mfu_effective` (against the
dial's measured train-skeleton ceiling) of utils/flops.py, where the tree
has it. With --census N the line also
has what one step asks of the host and the card, counted
over N more steps under torch.profiler: each CPU op's and each device
kernel's (or copy's) calls a step, by name.

It uses only the package's public train functions, so it also times
another tree of the package: put that tree first on PYTHONPATH and run this
file by its path.
"""

from __future__ import annotations

import argparse
import inspect
import json
import subprocess
import sys

import numpy as np
import torch


def synthetic_batch(cfg, seed: int):
    """One collated train batch of cfg's shapes: random features of every
    row at max_v_l clips and max_q_l tokens, one window of 2-10 s a
    video, random saliency labels."""
    rng = np.random.default_rng(seed)
    b, lv, lq = cfg.bsz, cfg.max_v_l, cfg.max_q_l
    return {
        "src_txt": rng.standard_normal((b, lq, cfg.t_feat_dim)).astype(np.float32),
        "src_txt_mask": np.ones((b, lq), np.float32),
        "src_vid": rng.standard_normal((b, lv, cfg.total_v_feat_dim)).astype(np.float32),
        "src_vid_mask": np.ones((b, lv), np.float32),
        "saliency_all_labels": rng.integers(0, 4, (b, lv)).astype(np.float32),
        "saliency_pos_labels": rng.integers(0, lv, (b, 2)).astype(np.int64),
        "saliency_neg_labels": rng.integers(0, lv, (b, 2)).astype(np.int64),
        "gt_windows": np.tile(np.asarray([[[2.0, 10.0]]], np.float32), (b, 1, 1)),
        "real_neg_mask": np.ones((b,), np.float32),
    }


def time_block(fn, iters: int) -> float:
    """ms a call of fn over `iters` calls (CUDA events around the block)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def census(fn, steps: int):
    """({CPU op: calls a step}, {device kernel or copy: calls a step}) of
    `steps` calls of fn under torch.profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    counts = {"cpu": {}, "cuda": {}}
    for e in prof.profiler.kineto_results.events():
        side = "cuda" if e.device_type() == torch.autograd.DeviceType.CUDA else "cpu"
        if not e.is_user_annotation():
            counts[side][e.name()] = counts[side].get(e.name(), 0) + 1
    return ({k: n / steps for k, n in counts["cpu"].items()},
            {k: n / steps for k, n in counts["cuda"].items()})


def step_generator(device):
    """The attention-dropout generator as train() makes it: on the card
    where the seeds are drawn on the device (ops/attn_dropout.py:draw_seed
    takes a device), else on the CPU."""
    from flashvtg_tpu_torch.ops.attn_dropout import draw_seed

    on_card = "device" in inspect.signature(draw_seed).parameters
    return torch.Generator(device=device if on_card else "cpu")


def variants():
    """The variant names this tree has (see the module doc)."""
    from flashvtg_tpu_torch.train import loop

    return ["as_built", "plain_adamw"] if hasattr(loop, "StepLR") else ["as_built"]


def make_step(cfg, model, precision: str, variant: str, seed: int):
    from flashvtg_tpu_torch.train import loop

    device = next(model.parameters()).device
    if variant == "plain_adamw":
        optimizer = torch.optim.AdamW(model.parameters(), lr=cfg.lr, betas=(0.9, 0.999),
                                      eps=1e-8, weight_decay=cfg.wd)
        scheduler = torch.optim.lr_scheduler.LambdaLR(optimizer, lambda s: 1.0)
    else:
        optimizer, scheduler = loop.make_optimizer(cfg, model.parameters(), 100)
    return loop.make_train_step(model, cfg.loss_config(), optimizer, scheduler, cfg.grad_clip,
                                step_generator(device).manual_seed(seed), precision)


def utilization(cfg, precision: str, ms: float) -> dict:
    """achieved_tflops, mfu and mfu_effective of a train step of `ms`
    (utils/flops.py:step_mfu); none in a tree without utils/flops.py."""
    try:
        from flashvtg_tpu_torch.utils.flops import step_mfu
    except ImportError:
        return {}
    return step_mfu(cfg, cfg.bsz, ms / 1e3, precision, train=True) or {}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--preset", default="qvhighlights_slowclip")
    ap.add_argument("--precision", nargs="+", default=["float32", "bfloat16"])
    ap.add_argument("--blocks", type=int, default=4)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--census", type=int, default=0, metavar="N",
                    help="also count each op and kernel a step over N profiled steps")
    ap.add_argument("--tag", default="", help="a label copied into every line")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("step_time: CUDA is not available; this tool times the card", file=sys.stderr)
        return 2

    import flashvtg_tpu_torch
    from flashvtg_tpu_torch.models import build_model
    from flashvtg_tpu_torch.train import loop
    from flashvtg_tpu_torch.train.config import from_preset

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0], flush=True)
    dev = torch.device("cuda")
    cfg = from_preset(args.preset, use_tensorboard=False)
    batch = synthetic_batch(cfg, args.seed)
    def run(step):
        return lambda: step(loop.place_batch(batch, dev, transfer_dtype=cfg.transfer_dtype))

    for precision in args.precision:
        names = variants() if args.variants else ["as_built"]
        steps = {}
        for variant in names:
            model = build_model(cfg.model_config(), dev, args.seed).train()
            torch.manual_seed(args.seed)
            steps[variant] = run(make_step(cfg, model, precision, variant, args.seed))
            for _ in range(3):
                steps[variant]()
        torch.cuda.synchronize()
        # the variants' blocks in turns, the order reversed every block, so
        # the host's drift over the run falls on each variant alike
        ms = {variant: [] for variant in names}
        for block in range(args.blocks):
            for variant in (names if block % 2 == 0 else names[::-1]):
                ms[variant].append(time_block(steps[variant], args.iters))
        for variant in names:
            line = {
                "tag": args.tag, "package": flashvtg_tpu_torch.__file__, "preset": args.preset,
                "bsz": cfg.bsz, "precision": precision, "transfer_dtype": cfg.transfer_dtype,
                "variant": variant, "block_ms": ms[variant],
                "mean_ms": float(np.mean(ms[variant])),
                "spread_ms": float(np.max(ms[variant]) - np.min(ms[variant]))}
            line.update(utilization(cfg, precision, line["mean_ms"]))
            if args.census:
                line["cpu_ops_per_step"], line["kernels_per_step"] = census(steps[variant],
                                                                             args.census)
            print(json.dumps(line), flush=True)
        del steps
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
