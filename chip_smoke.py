#!/usr/bin/env python3
"""Smoke run of the PyTorch port (flashvtg_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--seed 0] [--queries 512] [--tacos-queries 64]
                          [--train-steps 3] [--hd-queries 64]

Phases, each failing loudly; phases 3-13 run at float32 by name (the
attention kernels in 3xTF32, TF32 off), phase 14 at the other dials:
  1. device: prints the card's name and power limit, requires CUDA, sets
     float32 without TF32 for matmuls and cuDNN;
  2. build: compiles every CUDA kernel of the port from its sources, one
     nvcc per source, all at once, and counts each kernel's tensor-core
     instructions in its SASS (cuobjdump): every kernel that takes a dot
     product (on mma.sync) must have some, all but the flash backward's D
     pre-pass and the ACA backward's chunk-sum pass; and per product form
     (each kernel is a template on it): the 1xTF32 and the bf16 instances
     must hold fewer than the 3xTF32 ones;
  3. kernels vs their plain PyTorch versions on the card, at the shapes the
     two eval paths give them (atol 1e-5: both are f32-accurate, the
     kernels' products in 3xTF32, and differ in the order of their sums),
     with times, bounds and yardsticks:
     the ACA and short self-attention kernel at the flagship shapes and at
     TACoS's ACA shape, the flash kernel at TACoS's encoder shape and,
     beside the short kernel, at the flagship's self-attention shapes; then
     every eval kernel at the highlight-detection (HD: B=4, Lv 1000 of
     which 60-330 clips valid, 3 dummies + 32 text keys), Charades (B=128,
     Lv 256, 15-45 clips valid, 40 dummies + 32 text keys) and Charades-VGG
     (B=16, Lv 2048, 90-270 clips valid) eval shapes, and the FlashVTG_ms
     shapes (MS_KERNEL_SHAPES), where the dummies attend over the sentence
     token alone: the ACA at nd + 1 keys with one past the dummies (HD: B=4,
     Lv 1000, Lk 4; flagship: B=256, Lv 75, Lk 11) and the short kernel at
     L = nd + 1, every key valid;
  4. flagship path: QVHighlights eval (preset qvhighlights_slowclip, full
     width and depth, random weights from --seed) over a synthetic set of
     --queries queries written to a temp dir: run_mr_inference (forward,
     decode, submission rows, NMS) and eval_submission; each kernel's launch
     count, set to 0 just before, must equal its launches per batch times
     the batches;
  5. flagship card vs CPU: the same weights on 8 of those queries, forward
     on the card and on the CPU (plain versions), within atol 3e-4 (the
     tolerance the JAX package holds against the torch reference);
  6. TACoS path: preset tacos at full width and depth (Lv 2048, 8 ACA
     layers, 35 dummies) over --tacos-queries synthetic TACoS-format queries
     (videos of 64-2048 clips, string qids), as in phase 4, with 8 ACA, 3
     short and 3 flash launches per batch; the peak memory of one eval step
     above what was allocated before it is reported, and each flash call's
     peak above what was allocated at its entry must stay under one
     (B, H, L, L) float32 tensor, while the same call through the plain
     full-logits attention, the control, must reach it (the memory-linear
     check, made on every path with the flash kernel); then card vs CPU on
     2 of the queries, one of them short, as in phase 5;
  7. training forms and backward kernels vs their plain versions, at the
     shapes of both train paths: TACoS (B=32: ACA at Lv 2048 with 35
     dummies, the dummy encoder's short self-attention at L 75, the flash
     kernel at L 2048), the flagship (B=64: ACA at Lv 75 with 10 dummies,
     the short kernel at L 42 and L 75) and TVSum (B=4: ACA at Lv 1000 with
     3 dummies, its backward in 4 row chunks, the last one partial; the
     short kernel at L 35, the flash kernel at L 1000, 60-330 clips
     valid); ACA with donor rows and a
     head-mean gradient; dropout 0.1 on both sides with one seed; and the
     FlashVTG_ms shapes of phase 3 in training form and backward (the ACA
     with no donor rows, as the ms trunk calls it, and a head-mean
     gradient). Each
     kernel through its launcher (timed) and once through the autograd
     Function that the model calls (aca_attention, masked_attention,
     flash_attention on tensors that require grad, then .backward):
     forwards (out, head mean, log-sum-exp) within atol 1e-5, gradients
     within 1e-4 of the largest |plain| value (f32 sums in another order),
     with times, bounds and yardsticks (the training forwards:
     scaled_dot_product_attention with dropout_p on tensors that require
     grad; the backwards: torch.autograd through it, forward + backward
     minus forward); the
     flash forward + backward's peak above its inputs against one
     (B, H, L, L) f32 tensor (4.29 GB);
  8. train paths, one per preset (qvhighlights_slowclip at B=64, tacos at
     B=32 and Lv 2048; full width and depth, every dropout at its preset
     value): train() on a synthetic train split for --train-steps steps
     (one epoch) and its eval through run_mr_inference with the eval
     losses (the forward with the negative pass), under torch.profiler:
     each kernel's launches as the card ran them (the profiler's kernel
     records; with the feed and scan_steps by default the steps after two
     eager warm-up steps are CUDA-graph replays) equal to its launches per
     step times the steps plus the eval's, and its wrapper's count, set to
     0 just before (eager launches only), above 0 and at most that; finite
     losses (read back from the run's
     scalars.jsonl); a step timed with CUDA events; the step's peak
     memory (< 80 GB); then card vs CPU on one 2-row step with every
     dropout at 0, the CPU step in float64 as the reference (the CPU's
     float32 step's distance to it is reported): losses within rtol 1e-4;
     clipped gradients leaf by leaf within 1e-3 of the leaf's largest
     |gradient| (floored at 1e-2 of the largest over all leaves); the AdamW
     update within 1% of lr where the gradient's sign is sure (|g| over 100
     times the leaf's gradient disagreement: a first Adam step moves a
     weight by about lr sign(g), so elsewhere it carries no information);
  9. HD eval: youtube_uni at full width and depth (Lv 1000, 2 ACA, 2 short
     and 3 flash launches a batch of 4) over --hd-queries synthetic videos
     of one domain through run_hl_inference (the saliency-only forward and
     the domain's mAP, which must lie in [0, 1]), launch counts as in phase
     4, the step's time and its peak memory above its inputs; then tvsum on
     8 videos of one domain in the rgb + opt layout; card vs CPU on 2
     videos each, as in phase 5;
 10. TVSum train: train() on one synthetic domain of 4 train videos and 1
     val video (B=4, one step an epoch, Lv 1000, every dropout at its
     preset value) for --train-steps steps (epochs), then its HD eval after
     the last, checked as in
     phase 8, card vs CPU included;
 11. Charades-STA MR eval: charades (Lv 256, eval_bsz 128) over 256 and
     charades_vgg (Lv 2048, eval_bsz 16, 300-d GloVe text from a vocabulary
     file the phase writes and points FLASHVTG_GLOVE_PATH at) over 32
     synthetic queries, through
     run_mr_inference and eval_submission as in phase 4, card vs CPU on 2
     queries each;
 12. cli: the port's CLI (flashvtg_tpu_torch/cli.py) on the card at the
     flagship's full width and depth, on a synthetic QVHighlights split of
     96 train and 64 val rows: `train` for 3 epochs at bsz 32 with an eval
     every epoch, `infer --resume model_best.ckpt` (in this process and
     once as `python -m flashvtg_tpu_torch.cli`), `export`, `infer` from the
     export, then `train --resume auto --n_epoch 4`; it asserts the best
     epoch's brief metrics (eval.log.txt) equal every infer's, the resumed
     run starting at epoch index 3, the checkpoint files, the card-written
     model_latest.ckpt loading on the CPU (weights, AdamW, StepLR), and each
     kernel's launches over the in-process calls (12 train steps, 6 evals)
     as in phase 8, and prints each call's wall time;
 13. ms: the FlashVTG_ms variant at full width and depth (random weights
     from --seed): (a) youtube_uni_ms over --hd-queries and tvsum_ms over 8
     synthetic videos through run_hl_inference, as phase 9 (2 ACA, 2 short
     at L 4, 3 flash launches a batch; the flash calls memory-linear; card
     vs CPU on 2 videos); (b) tvsum_ms train() as phase 10 (4 ACA, 2 short,
     6 flash forward launches a step, as many backward: the negative pass
     reruns the ACA layers and the encoder, not the dummy encoder); (c) the
     flagship with variant=ms, use_dfl and use_eos over --queries
     synthetic queries through run_mr_inference with the eval losses (the
     negative pass: 12 ACA and 8 short launches a batch) and
     eval_submission, card vs CPU on 8 queries, the DFL-decoded spans within
     2e-3;
 14. precision: (a) every kernel at the 1xTF32 and the bf16 form against its
     plain version at the same form (which rounds its product operands as
     the kernel does), at every shape of phases 3 and 7, within FORM_RTOL
     of max(max |plain|, 0.1), timed beside its bound at the rate of the
     form's function (bf16 at the bf16 rate) and sdpa (bf16 operands, or
     the TF32 flag); each of the six kernels at each of the three forms
     within its form's band of error against the f32-accurate plain version
     (FORM_F32_BAND) and nearest the plain version at its own form; (b) at float32, tensorfloat32 and bfloat16: the
     flagship eval (B 256, 512 queries), the TACoS eval and the YouTube-HL
     eval through run_mr_inference / run_hl_inference, each mode's forward
     against the card's own float32 forward (within PRECISION_FWD_BAND);
     the TACoS train step at B 32 (bfloat16 also with transfer_dtype
     bfloat16) and the tvsum_ms train step through make_train_step, time,
     peak memory and, at dropout 0, the total loss and the gradients
     against the float32 step's (PRECISION_GRAD_BAND);
     train() of tvsum at tensorfloat32 and at bfloat16 (with the bf16
     wire); the CLI: `train` at its default bfloat16, `infer --serving`
     (1xTF32) and `infer --serving --eval_precision bfloat16`. Every launch
     of a path is counted at its dial's form; every dial restores the TF32
     flags, checked at the end.
 15. feed: the device-resident feed and the scan epoch (CUDA-graph replays):
     (a) the flagship train step (B 64, full width, the default bfloat16
     dial, preset dropout) through utils/scanbench.py on a 1024-row feed
     (0.87 GiB f32, 16 steps an epoch) in three modes, streamed per step,
     feed per step, feed + scan (chunks of SCAN_K = 8 replays), each on a
     fresh model from --seed: steps/s, wall and device-busy ms a step, the
     idle share, peak memory, the feed's copy seconds and bytes; the graph
     path's loss vectors against the eager feed path's within
     GRAPH_LOSS_RTOL; each mode's launches as the card ran them, read from
     the profiler's kernel records of its profiled steps, a step's times
     the steps, the wrappers' counts equal to them in the eager modes and 0
     in the replays (the scan's counts: its two eager warm-up steps'); at
     float32 and dropout 0, 8 steps a mode, the
     parameters within GRAPH_PARAM_RTOL of each leaf's largest |value|
     (graph against eager is also reported bit for bit); (b) the same for
     tvsum_ms (B 4, Lv 1000); (c) with phases 4 and 9, the flagship eval
     (B 256, --queries) and the YouTube-HL eval (B 4) with the feed against
     streamed: outputs bit-equal, one device-to-host fetch a batch, q/s and
     idle shares; (d) the CLI `train --device_feed on --scan_steps 4` (two
     epochs of 4 steps at bsz 32, the flagship's full width, its default
     dials) in a fresh process, and `infer` on its model_best.ckpt, the
     brief metrics identical; and a TACoS split of 9,790 rows under the default
     budget: its estimate, streamed by "auto", nothing built.
 16. streamed: the streamed train step as the JAX loop runs it (each batch
     staged in pinned memory on the prefetch thread and copied ahead on a
     copy stream, one CUDA-graph replay a step at a fixed max_v_l):
     (a) the TACoS train step (B 32, Lv 2048, full width, preset dropout)
     on phase 8's synthetic TACoS split (96 rows, collated as train()
     collates them) through utils/scanbench.py's three streamed modes
     (streamed: the blocking per-step copy; streamed_ahead: the copy ahead,
     eager steps; streamed_graph: the copy ahead, graph replays) at
     bfloat16 and float32: steps/s, wall and device-busy ms a step, the
     idle share, peak memory, the capture's seconds, the step's mfu; each
     mode's launches as the card ran them (16 ACA, 3 short and 6 flash
     forward launches a step and as many backward, times the steps), the
     wrappers' counts 0 in the replays; under deterministic_cudnn the loss
     vectors graph against copy-ahead eager against blocking within
     GRAPH_LOSS_RTOL and, at float32 and dropout 0, the parameters after 8
     steps within GRAPH_PARAM_RTOL (bit-equality reported); (b) the
     flagship streamed step (B 64, synthetic features) at bfloat16 in the
     same three modes; (c) train() on the TACoS split with device_feed off,
     2 epochs of 3 steps: the wrappers count the two eager warm-up steps
     and the eval alone (every other step a replay); `cli train
     --device_feed off` in a fresh process (the flagship, 2 epochs of 4
     steps), then `infer` on its model_best.ckpt, the brief metrics
     identical; (d) the same TACoS train() with profile_dir: a trace of the
     first epoch that names the port's kernels and holds each kernel's
     launches of its 3 steps; train() with debug_nans on a flagship split
     with one NaN feature clip raises, and on the clean split gives the
     loss vectors of the run without it; (e) tools/matmul_ceiling.py's
     ceilings on this card, and the mfu of the flagship eval (phase 4, and
     with the feed) and of the flagship and TACoS train steps (blocking
     and graph, each dial of (a) and (b)).
The synthetic HD and Charades length mixes are guesses (utils/synthetic.py).
Then one line {"kernels": [...]}, a row per kernel and form, and, last,
{"ok": true, "device": {...}}.
Exits non-zero, printing no result, without CUDA or without the package.
"""

import argparse
import contextlib
import functools
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

F32_PEAK = 67e12  # H100 SXM float32 outside the tensor cores, FLOP/s
# dot products on the tensor cores at the rate of the function each product
# form computes (flashvtg_tpu_torch/ops/forms.py), from the H100 SXM data
# sheet's dense rates: f32-accurate products (3xTF32) at the TF32 rate,
# 495 TFLOP/s, over its three TF32 products; TF32 products at 495; bf16
# operands with f32 sums at the bf16 rate, 989, whatever instruction a
# kernel takes them on (the port's take them on the TF32 one, so they can
# reach half this bound at best)
DOT_PEAK = {"3xtf32": 495e12 / 3, "1xtf32": 495e12, "bf16": 989e12}
HBM_RATE = 3.35e12  # H100 SXM device memory, bytes/s
KERNEL_ATOL = 1e-5
# phase 14: a kernel against its plain version at the same form (which
# rounds the same operands), relative to max(max |plain|, 0.1): about 2-3
# times the largest gap the card has shown over the shapes of phases 3 and 7
# (4.2e-4 at 1xTF32, the ACA training forward's; 2.6e-3 at bf16, the short
# backward's); the forms' arithmetic against float64 is held within
# 2e-3 / 1.6e-2 in tests/test_torch_tf32x3.py
FORM_RTOL = {"1xtf32": 1e-3, "bf16": 6e-3}
# phase 14: each kernel at each form, its relative RMS distance
# (rms(kernel - plain) / rms(plain)) to the f32-accurate plain version, the
# form's own error, within a band per form; the bands do not meet, so they
# tell the three forms apart (the HMMA count cannot tell 1xTF32 from bf16).
# The card read at most 1.0e-6 at 3xTF32, 4.0e-4 - 5.9e-4 at 1xTF32 and
# 3.2e-3 - 4.8e-3 at bf16. And the plain version at the kernel's own form
# must be the nearest of the three
FORM_F32_BAND = {"3xtf32": (0.0, 1e-5), "1xtf32": (1e-4, 1.2e-3), "bf16": (1.5e-3, 1.2e-2)}
# phase 14: a mode's eval forward against the card's own float32 forward
# (the worst output, each relative to max(max |float32|, 0.1)), and a train
# step's gradients at dropout 0 (|g - g32| / |g32| over every parameter),
# each within a band (floor, limit); the bands of the two modes do not meet,
# so each dial is told from the other and from float32. The card read
# 8.6e-4 - 1.2e-3 / 9.4e-3 - 1.25e-2 (forwards, tensorfloat32 / bfloat16)
# and 1.7e-3 - 6.4e-3 / 1.2e-2 - 2.2e-2 (gradients)
PRECISION_FWD_BAND = {"tensorfloat32": (1e-4, 4e-3), "bfloat16": (4e-3, 3e-2)}
PRECISION_LOSS_RTOL = 1e-2  # the total loss at dropout 0, against float32's
PRECISION_GRAD_BAND = {"tensorfloat32": (1e-4, 9e-3), "bfloat16": (9e-3, 5e-2)}
FORWARD_ATOL = 3e-4
SPAN_ATOL = 2e-3  # decoded windows, seconds (tests/test_torch_model.py)
GRAD_RTOL = 1e-4  # kernel vs plain gradients, relative to the largest |plain|
STEP_LOSS_RTOL = 1e-4  # card vs CPU train step
STEP_GRAD_RTOL = 1e-3  # per leaf, relative to its largest |gradient|
STEP_GRAD_FLOOR = 1e-2  # ... floored at this share of the largest over all leaves
TRAIN_DROPOUT = 0.1  # the presets' attention dropout


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def time_ms(fn, iters=50, warmup=5):
    """Mean device milliseconds of fn over `iters` launches (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound(b, lv, lk, heads, nd, key_valid, want_head_mean, backward=False,
                    pairs=None, form="3xtf32"):
    """(bound_ms, bound_by) for one attention kernel call, the same for the
    same work whatever implements it: each input read once and each output
    written once over the memory rate, against the operations this data
    needs, dot products at the tensor-core rate of `form` (DOT_PEAK: 3xTF32
    for f32 accuracy) and the rest at the f32 peak. A masked key's probability is 0, so it needs
    no work: q.k and the softmax (about five operations a probability, one
    more for the head mean) run over the valid (b, h, i, j) pairs, p.v over
    those past the nd dummies. `pairs` gives
    both counts where a mask beyond key_valid (the donor rows) removes
    pairs; by default every query row meets every valid key. The backward
    (`backward`) recomputes q.k and does dq and dk over the valid pairs and
    dO.v and dv over the value pairs, plus about six operations a pair (exp,
    dP, dS); it reads q, k, v, dO, the key mask, the log-sum-exp (and the
    head-mean gradient, or for self-attention over many keys O) and writes
    dq, dk, dv. Self-attention (the short and the flash kernel) is lv = lk,
    nd = 0, no head mean."""
    d = heads * 32
    if pairs is None:
        pairs = (heads * lv * float(key_valid.sum().item()),
                 heads * lv * float(key_valid[:, nd:].sum().item()))
    valid_pairs, value_pairs = pairs
    if backward:
        nbytes = 4 * (3 * b * lv * d + 4 * b * lk * d + b * lk + b * heads * lv)
        if want_head_mean:
            nbytes += 4 * b * lv * lk
        elif lv > 128:  # the flash backward also reads O
            nbytes += 4 * b * lv * d
        dots = 3 * 2 * 32 * valid_pairs + 2 * 2 * 32 * value_pairs
        other = 6 * valid_pairs
    else:
        nbytes = 4 * (2 * b * lv * d + 2 * b * lk * d + b * lk)
        if want_head_mean:
            nbytes += 4 * b * lv * lk
        dots = 2 * 32 * valid_pairs + 2 * 32 * value_pairs  # q.k, p.v
        other = (6 if want_head_mean else 5) * valid_pairs  # softmax
    t_bytes = nbytes / HBM_RATE
    t_ops = max(dots / DOT_PEAK[form], other / F32_PEAK)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def mode_of(form):
    """The precision dial whose attention kernels take `form`."""
    from flashvtg_tpu_torch.utils.runtime import KERNEL_FORMS

    (mode,) = (m for m, f in KERNEL_FORMS.items() if f == form)
    return mode


def in_dial(form, fn, *args, **kwargs):
    """fn(*args, **kwargs) inside the precision dial whose attention
    kernels take `form` (float32 by name for 3xTF32)."""
    from flashvtg_tpu_torch.utils.runtime import matmul_precision

    with matmul_precision(mode_of(form), "cuda"):
        return fn(*args, **kwargs)


def time_in_dial(form, fn, **kw):
    """time_ms of fn with the dial of `form` entered once around the whole
    loop (its own cost is not the kernel's)."""
    from flashvtg_tpu_torch.utils.runtime import matmul_precision

    with matmul_precision(mode_of(form), "cuda"):
        return time_ms(fn, **kw)


def form_name(name, form):
    """A kernel's row name: its own at 3xTF32, name@form at the others."""
    return name if form == "3xtf32" else f"{name}@{form}"


def check_kernel(what, pairs, form):
    """(max |kernel - plain|, the same over max(max |plain|, 0.1)) over the
    (kernel, plain) output pairs (None skipped); fails above KERNEL_ATOL
    (absolute) at 3xTF32, above FORM_RTOL (relative) at the other forms."""
    import torch

    pairs = [(x, y) for x, y in pairs if x is not None]
    torch.cuda.synchronize()
    err = max((x - y).abs().max().item() for x, y in pairs)
    rel = max(rel_err(x, y) for x, y in pairs)
    if not (err <= KERNEL_ATOL if form == "3xtf32" else rel <= FORM_RTOL[form]):
        raise AssertionError(f"{what} [{form}] vs plain: max |err| {err}, relative {rel}")
    return err, rel


def library_ms(form, fn, *tensors, **kw):
    """A yardstick PyTorch call's time in the dial of `form` (the TF32 flag
    is the tensorfloat32 dial's), its operands in bf16 for the bf16 form."""
    import torch

    if form == "bf16":
        tensors = tuple(t.to(torch.bfloat16) if t.is_floating_point() else t for t in tensors)
    return time_in_dial(form, lambda: fn(*tensors), **kw)


def ragged_mask(rng, b, n, lo, hi, always=0):
    """(b, n) float32 mask: `always` leading ones, then a valid prefix of
    [lo, hi) more positions per row."""
    import torch

    lens = always + rng.integers(lo, hi, b)
    return torch.from_numpy((np.arange(n)[None] < lens[:, None]).astype(np.float32))


def phase_kernels(dev, seed, form="3xtf32"):
    """Phase 3 (and phase 14 at the other forms): each kernel against its
    plain version at `form`, timed beside its bound. Returns the rows of the
    kernels line and the other shapes' readings, which are logged."""
    import torch
    import torch.nn.functional as F

    from flashvtg_tpu_torch.ops import aca, chunked_attn

    rng = np.random.default_rng(seed)
    g = torch.Generator().manual_seed(seed)
    b, heads, lv, nd, lq = 256, 8, 75, 10, 32
    lk = nd + lq

    def qkv(lq_, lk_):
        return qkv_b(g, dev, b, heads, lq_, lk_)

    rows = []
    # ACA: 75 video queries over 10 dummies + up to 32 text keys
    q, k, v = qkv(lv, lk)
    valid = ragged_mask(rng, b, lk, 5, lq + 1, always=nd).to(dev)
    out, hm = in_dial(form, aca.aca_attention, q, k, v, valid, heads, nd)
    ref_out, ref_hm = aca.aca_attention_plain(q, k, v, valid, heads, nd, form=form)
    err, rel = check_kernel("aca_attention", ((out, ref_out), (hm, ref_hm)), form)
    bound, by = attention_bound(b, lv, lk, heads, nd, valid, True, form=form)
    log("aca_attention: library_ms is null: no single PyTorch call computes a "
        "softmax over dummies + text, values without the dummies and the head mean")
    rows.append(dict(
        name=form_name("aca_attention", form), kernel="aca_attention", form=form,
        route="cuda", source="flashvtg_tpu_torch/csrc/aca_attention.cu",
        replaces="scripts/bench_aca.py:40",
        shape=f"B={b} H={heads} Lv={lv} Lk={lk} Dh=32 nd={nd}",
        max_abs_err=err, max_rel_err=rel,
        ms=time_in_dial(form, lambda: aca.aca_attention(q, k, v, valid, heads, nd)),
        plain_ms=time_ms(lambda: aca.aca_attention_plain(q, k, v, valid, heads, nd, form=form)),
        bound_ms=bound, bound_by=by, library_ms=None,
    ))

    # masked self-attention: the dummy encoder (42 tokens) and the encoder
    # (75 clips); the kernels line carries the encoder shape (3 of the 5
    # launches per batch), the other shape is logged
    shapes = {}
    for name, length, mask in (
        ("dummy_encoder", lk, ragged_mask(rng, b, lk, 5, lq + 1, always=nd)),
        ("encoder", lv, ragged_mask(rng, b, lv, 20, lv + 1)),
    ):
        q, k, v = qkv(length, length)
        mask = mask.to(dev)
        out = in_dial(form, aca.masked_attention, q, k, v, mask, heads)
        ref = aca.masked_attention_plain(q, k, v, mask, heads, form)
        err, rel = check_kernel(f"masked_attention L={length}", ((out, ref),), form)
        qh, kh, vh = (
            x.view(b, length, heads, 32).transpose(1, 2).contiguous() for x in (q, k, v)
        )
        flash = in_dial(form, chunked_attn.flash_attention, q, k, v, mask, heads)
        # the flash kernel's plain version rounds p before its normalisation:
        # held against its own plain version at the other forms
        flash_ref = ref if form == "3xtf32" else chunked_attn.flash_attention_plain(
            q, k, v, mask, heads, form=form)
        flash_err, _ = check_kernel(f"flash_attention L={length}", ((flash, flash_ref),), form)
        bool_mask = (mask > 0)[:, None, None, :]
        bound, by = attention_bound(b, length, length, heads, 0, mask, False, form=form)
        shapes[form_name(name, form)] = dict(
            form=form, shape=f"B={b} H={heads} L={length} Dh=32", max_abs_err=err,
            max_rel_err=rel,
            ms=time_in_dial(form, lambda: aca.masked_attention(q, k, v, mask, heads)),
            # the flash kernel on the same inputs: is the short one worth keeping?
            flash_ms=time_in_dial(form, lambda: chunked_attn.flash_attention(q, k, v, mask,
                                                                             heads)),
            flash_max_abs_err=flash_err,
            plain_ms=time_ms(lambda: aca.masked_attention_plain(q, k, v, mask, heads, form)),
            bound_ms=bound, bound_by=by,
            library_ms=library_ms(
                form, lambda *t: F.scaled_dot_product_attention(*t[:3], attn_mask=t[3]),
                qh, kh, vh, bool_mask),
        )
        log(f"masked_attention[{name}, {form}]: {json.dumps(shapes[form_name(name, form)])}")
    enc = shapes[form_name("encoder", form)]
    rows.append(dict(
        name=form_name("masked_attention", form), kernel="masked_attention",
        route="cuda", source="flashvtg_tpu_torch/csrc/aca_attention.cu",
        replaces="scripts/bench_flash.py:57",
        **{**enc, "max_abs_err": max(m["max_abs_err"] for m in shapes.values()),
           "max_rel_err": max(m["max_rel_err"] for m in shapes.values())},
    ))

    # TACoS: 2048 clips over 35 dummies + up to 40 text tokens (logged), and
    # the encoder's self-attention over 2048 clips of 64-2048 valid
    shapes[form_name("tacos_aca", form)] = aca_eval_reading(dev, g, rng, 8, 2048, 35, 40,
                                                            form=form)
    log(f"aca_attention[tacos, {form}]: {json.dumps(shapes[form_name('tacos_aca', form)])}")
    reading = self_eval_reading(dev, g, 8, ragged_mask(rng, 8, 2048, 64, 2049).to(dev), form)
    rows.append(dict(
        name=form_name("flash_attention", form), route="cuda",
        source="flashvtg_tpu_torch/csrc/flash_attention.cu",
        replaces="scripts/bench_flash.py:57", **reading,
    ))
    return rows, shapes


# (B, Lv, dummies, text tokens, fewest and most valid clips) of the eval
# paths of the HD and Charades presets
SLICE_EVAL_SHAPES = {
    "hd_eval": (4, 1000, 3, 32, 60, 330),
    "charades_eval": (128, 256, 40, 32, 15, 45),
    "charades_vgg_eval": (16, 2048, 40, 32, 90, 270),
}


def aca_eval_reading(dev, g, rng, b, lv, nd, lq, valid=None, form="3xtf32"):
    """The ACA kernel against its plain version at one eval shape and
    `form`, timed; the key mask ragged text after nd dummies, or `valid`."""
    from flashvtg_tpu_torch.ops import aca

    heads, lk = 8, nd + lq
    q, k, v = qkv_b(g, dev, b, heads, lv, lk)
    if valid is None:
        valid = ragged_mask(rng, b, lk, 5, lq + 1, always=nd).to(dev)
    out, hm = in_dial(form, aca.aca_attention, q, k, v, valid, heads, nd)
    ref_out, ref_hm = aca.aca_attention_plain(q, k, v, valid, heads, nd, form=form)
    shape = f"B={b} H={heads} Lv={lv} Lk={lk} Dh=32 nd={nd}"
    err, rel = check_kernel(f"aca_attention {shape}", ((out, ref_out), (hm, ref_hm)), form)
    bound, by = attention_bound(b, lv, lk, heads, nd, valid, True, form=form)
    return dict(
        kernel="aca_attention", form=form, shape=shape, max_abs_err=err, max_rel_err=rel,
        ms=time_in_dial(form, lambda: aca.aca_attention(q, k, v, valid, heads, nd), iters=20),
        plain_ms=time_ms(lambda: aca.aca_attention_plain(q, k, v, valid, heads, nd, form=form),
                         iters=10),
        bound_ms=bound, bound_by=by, library_ms=None,
    )


def self_eval_reading(dev, g, b, valid, form="3xtf32"):
    """Masked self-attention over the keys of `valid` against its plain
    version at `form`: the short kernel up to 128 keys, the flash kernel
    past; timed beside scaled_dot_product_attention with the same boolean
    mask (on bf16 operands for the bf16 form, with the TF32 flag for
    1xTF32)."""
    import torch.nn.functional as F

    from flashvtg_tpu_torch.ops import aca, chunked_attn

    heads, length = 8, valid.shape[1]
    if length > aca.MAX_KEYS:
        name, fn, plain = ("flash_attention", chunked_attn.flash_attention,
                           chunked_attn.flash_attention_plain)
    else:
        name, fn, plain = "masked_attention", aca.masked_attention, aca.masked_attention_plain
    q, k, v = qkv_b(g, dev, b, heads, length, length)
    shape = f"B={b} H={heads} L={length} Dh=32, valid keys {int(valid.sum().item())} of {b * length}"
    err, rel = check_kernel(f"{name} {shape}", ((in_dial(form, fn, q, k, v, valid, heads),
                                                 plain(q, k, v, valid, heads, form=form)),),
                            form)
    qh, kh, vh = (x.view(b, length, heads, 32).transpose(1, 2).contiguous() for x in (q, k, v))
    bool_mask = (valid > 0)[:, None, None, :]
    bound, by = attention_bound(b, length, length, heads, 0, valid, False, form=form)
    return dict(
        kernel=name, form=form, shape=shape, max_abs_err=err, max_rel_err=rel,
        ms=time_in_dial(form, lambda: fn(q, k, v, valid, heads), iters=20),
        plain_ms=time_ms(lambda: plain(q, k, v, valid, heads, form=form), iters=10),
        bound_ms=bound, bound_by=by,
        library_ms=library_ms(
            form, lambda *t: F.scaled_dot_product_attention(*t[:3], attn_mask=t[3]),
            qh, kh, vh, bool_mask, iters=20),
    )


def phase_slice_kernels(dev, seed, form="3xtf32"):
    """Phase 3, second part (and phase 14's at the other forms): each eval
    kernel of the HD and Charades paths (the ACA layers, the dummy
    encoder's short self-attention, the encoder's flash attention) at
    SLICE_EVAL_SHAPES, and the FlashVTG_ms shapes."""
    import torch

    rng = np.random.default_rng(seed + 2)
    g = torch.Generator().manual_seed(seed + 2)
    shapes = {}
    for path, (b, lv, nd, lq, lo, hi) in SLICE_EVAL_SHAPES.items():
        text = ragged_mask(rng, b, nd + lq, 5, lq + 1, always=nd).to(dev)
        video = ragged_mask(rng, b, lv, lo, hi + 1).to(dev)
        for length, reading in ((lv, aca_eval_reading(dev, g, rng, b, lv, nd, lq, form=form)),
                                (nd + lq, self_eval_reading(dev, g, b, text, form)),
                                (lv, self_eval_reading(dev, g, b, video, form))):
            key = form_name(f"{path} {reading['kernel']} L={length}", form)
            shapes[key] = reading
            log(f"[slice kernels] {key}: {json.dumps(reading)}")
    for path, (b, lv, nd) in MS_KERNEL_SHAPES.items():
        keys = torch.ones((b, nd + 1), device=dev)  # dummies + the sentence token
        for length, reading in ((lv, aca_eval_reading(dev, g, rng, b, lv, nd, 1, keys, form)),
                                (nd + 1, self_eval_reading(dev, g, b, keys, form))):
            key = form_name(f"{path}_eval {reading['kernel']} L={length}", form)
            shapes[key] = reading
            log(f"[ms kernels] {key}: {json.dumps(reading)}")
    return shapes


# (B, Lv, dummies) of the FlashVTG_ms paths: the HD presets and the flagship.
# The ACA layers see the nd dummies and the sentence token, every key valid,
# and the dummy encoder's short self-attention the same nd + 1 tokens
MS_KERNEL_SHAPES = {
    "ms_hd": (4, 1000, 3),
    "ms_flagship": (256, 75, 10),
}


def qkv_b(g, dev, b, heads, lq_, lk_):
    """Random q (b, lq_, heads*32), k and v (b, lk_, heads*32) on the card."""
    import torch

    return tuple(
        torch.randn((b, n, heads * 32), generator=g).to(dev) for n in (lq_, lk_, lk_)
    )


MR_ONLY_SETS = ("charadesSTA", "charadesSTA_internvideo2", "tacos", "nlq")  # no saliency rows


def synthetic_writer(cfg):
    """The synthetic writer of a preset (utils/synthetic.py): QVHighlights
    format (every fourth video 20 clips to Lv) for the flagship, TACoS
    format (64 to 2048 clips, string qids) for tacos, one domain of TVSum
    (rgb + opt halves) or YouTube-HL for the HD sets, and Charades-STA rows
    (videos of 15-45 s) for the charades presets, the 4096-d VGG video (the
    width that also selects its post-processor) in a "vgg" directory, as
    its real layout has it, so that the dataset reads GloVe text."""
    from flashvtg_tpu_torch.data.dataset import HD_SETS
    from flashvtg_tpu_torch.utils import synthetic as S

    if cfg.dset_name == "tacos":
        return functools.partial(
            S.make_synthetic_tacos, v_dim=cfg.v_feat_dim, t_dim=cfg.t_feat_dim,
            max_clips=cfg.max_v_l, min_clips=64, clip_len=cfg.clip_length,
            max_q_tokens=cfg.max_q_l,
        )
    if cfg.dset_name in HD_SETS:
        writer = S.make_synthetic_tvsum if cfg.dset_name == "tvsum" else S.make_synthetic_youtube
        return functools.partial(writer, domain=cfg.dset_domain, v_dim=cfg.v_feat_dim,
                                 t_dim=cfg.t_feat_dim)
    if cfg.dset_name.startswith("charadesSTA"):
        return functools.partial(
            S.make_synthetic_charades, v_dim=cfg.v_feat_dim, t_dim=cfg.t_feat_dim,
            clip_len=cfg.clip_length, max_clips=cfg.max_v_l, max_q_tokens=cfg.max_q_l,
            glove=cfg.v_feat_dim == 4096,
        )
    return functools.partial(
        S.make_synthetic_qvh, v_dim=cfg.v_feat_dim, t_dim=cfg.t_feat_dim,
        n_clips=cfg.max_v_l, clip_len=cfg.clip_length, min_clips=20,
        max_q_tokens=cfg.max_q_l + 1,
    )


def rel_err(got, ref):
    """max |got - ref| over max |ref| (floored at 0.1: a gradient that is 0
    up to rounding, as dq of a row with one valid key, is held at 1e-5
    absolute)."""
    return ((got - ref).abs().max() / ref.abs().max().clamp_min(0.1)).item()


def sdpa_backward_ms(q, k, v, valid, heads, d_out, form="3xtf32"):
    """The backward's yardstick: torch.autograd.grad through
    scaled_dot_product_attention with the same boolean key mask (and no
    dropout), forward + backward minus forward, ms; on bf16 operands for
    the bf16 form, with the TF32 flag for 1xTF32."""
    import torch
    import torch.nn.functional as F

    b = q.shape[0]
    dtype = torch.bfloat16 if form == "bf16" else q.dtype
    qh, kh, vh = (x.view(b, -1, heads, 32).transpose(1, 2).contiguous().to(dtype)
                  .requires_grad_() for x in (q, k, v))
    d_oh = d_out.view(b, -1, heads, 32).transpose(1, 2).contiguous().to(dtype)
    mask = (valid > 0)[:, None, None, :]

    def fwd():
        return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)

    def both():
        return torch.autograd.grad(fwd(), (qh, kh, vh), d_oh)

    return (time_in_dial(form, both, iters=10, warmup=2)
            - time_in_dial(form, fwd, iters=10, warmup=2))


def sdpa_train_forward_ms(q, k, v, valid, heads, p, form="3xtf32"):
    """The training forward's yardstick: scaled_dot_product_attention with
    the same boolean key mask and dropout_p on tensors that require grad
    (so that it also keeps what its backward needs, the log-sum-exp), ms;
    operands as sdpa_backward_ms's. Its dropout mask is Philox's, not the
    port's hash: the same function up to which probabilities drop."""
    import torch
    import torch.nn.functional as F

    b = q.shape[0]
    dtype = torch.bfloat16 if form == "bf16" else q.dtype
    qh, kh, vh = (x.view(b, -1, heads, 32).transpose(1, 2).contiguous().to(dtype)
                  .requires_grad_() for x in (q, k, v))
    mask = (valid > 0)[:, None, None, :]
    return time_in_dial(form, lambda: F.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=mask, dropout_p=p), iters=10, warmup=2)


def aca_pairs(key_valid, query_valid, donor_rows, nd):
    """(valid (b, h, i, j) pairs, those past the nd dummies) of an ACA call
    with donor rows: the mask the kernel applies, counted on the card."""
    qpad = (query_valid <= 0)[donor_rows.long()]  # (B, H, Lv)
    kpad = (key_valid <= 0)[donor_rows.long()]  # (B, H, Lk)
    ok = (key_valid > 0)[:, None, None, :] & ~(qpad[..., :, None] & kpad[..., None, :])
    return float(ok.sum().item()), float(ok[..., nd:].sum().item())


def function_grads(call, inputs, d_outs):
    """(dq, dk, dv) through the autograd Function that the model calls:
    call(q, k, v) on copies of `inputs` that require grad, then backward with
    `d_outs`; and the peak device memory of that forward + backward above
    what was allocated before it, bytes."""
    import torch

    leaves = [x.detach().clone().requires_grad_() for x in inputs]
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    outs = call(*leaves)
    torch.autograd.backward(outs if isinstance(outs, tuple) else (outs,), d_outs)
    torch.cuda.synchronize()
    return [x.grad for x in leaves], torch.cuda.max_memory_allocated() - before


def backward_reading(shape, bwd, bwd_plain, fn, bound, library_ms, form="3xtf32"):
    """A backward kernel against its plain version, through its launcher and
    through its autograd Function (`fn`, function_grads' result): relative
    errors (within GRAD_RTOL at 3xTF32, the form's FORM_RTOL at the others),
    bit-for-bit repeat, times. `bound` is attention_bound's (ms, by)."""
    import torch

    got, ref = bwd(), bwd_plain()
    torch.cuda.synchronize()
    errs = [rel_err(x, y) for x, y in zip(got, ref)]
    fn_errs = [rel_err(x, y) for x, y in zip(fn[0], ref)]
    limit = GRAD_RTOL if form == "3xtf32" else FORM_RTOL[form]
    if not max(errs + fn_errs) <= limit:
        raise AssertionError(f"backward {shape} [{form}] vs plain: relative errors {errs} "
                             f"(launcher), {fn_errs} (autograd Function) > {limit}")
    if not all(torch.equal(x, y) for x, y in zip(got, bwd())):
        raise AssertionError(f"backward {shape} [{form}]: two launches disagree")
    return dict(
        form=form, shape=shape,
        max_abs_err=max((x - y).abs().max().item() for x, y in zip(got, ref)),
        max_rel_err=max(errs), function_rel_err=max(fn_errs),
        function_fwd_bwd_peak_bytes=fn[1], ms=time_ms(bwd, iters=10, warmup=2),
        plain_ms=time_ms(bwd_plain, iters=3, warmup=1), bound_ms=bound[0],
        bound_by=bound[1], library_ms=library_ms,
    )


def forward_reading(shape, got, ref, fwd, fwd_plain, bound, library_ms=None, form="3xtf32"):
    """A training-form forward (out, head mean, log-sum-exp) against its
    plain version with the same dropout seed, timed."""
    err, rel = check_kernel(f"training forward {shape}", zip(got, ref), form)
    return dict(form=form, shape=shape, max_abs_err=err, max_rel_err=rel,
                ms=time_ms(fwd, iters=10, warmup=2),
                plain_ms=time_ms(fwd_plain, iters=3, warmup=1), bound_ms=bound[0],
                bound_by=bound[1], library_ms=library_ms)


def aca_train_case(dev, g, b, lv, nd, heads, p, seed, valid, vmask, form="3xtf32"):
    """The ACA core in training form at `form`: lv video queries over nd
    dummies and the text keys of `valid`, a head-mean gradient; with
    `vmask` (the videos' clips) the donor-row mask of the core model's train
    path, without it none (the FlashVTG_ms trunk). Returns (kernel name,
    forward reading, backward reading)."""
    import torch

    from flashvtg_tpu_torch.models.transformer import tiled_attn_donors
    from flashvtg_tpu_torch.ops import aca
    from flashvtg_tpu_torch.ops.attn_dropout import draw_seed

    lk = valid.shape[1]
    q, k, v = qkv_b(g, dev, b, heads, lv, lk)
    d_out = torch.randn((b, lv, heads * 32), generator=g).to(dev)
    d_hm = torch.randn((b, lv, lk), generator=g).to(dev)
    donors = None if vmask is None else tiled_attn_donors(b, heads, dev)
    drop_seed = draw_seed(torch.Generator().manual_seed(seed))
    args = (q, k, v, valid, heads, nd, True, p, drop_seed, vmask, donors)
    pairs = None if vmask is None else aca_pairs(valid, vmask, donors, nd)
    shape = f"B={b} H={heads} Lv={lv} Lk={lk} Dh=32 nd={nd} p={p}" + (
        "" if vmask is None else ", donor rows")
    fwd = functools.partial(aca._launch, *args, want_lse=True, form=form)
    fwd_plain = functools.partial(aca.aca_attention_plain, *args, want_lse=True, form=form)
    got, ref = fwd(), fwd_plain()
    fwd_reading = forward_reading(
        shape, got, ref, fwd, fwd_plain,
        attention_bound(b, lv, lk, heads, nd, valid, True, pairs=pairs, form=form), form=form,
    )
    rest = (d_out, d_hm, heads, nd, p, drop_seed, vmask, donors)
    fn = function_grads(
        functools.partial(in_dial, form, aca.aca_attention, key_valid=valid, num_heads=heads,
                          num_dummies=nd, dropout=p,
                          generator=torch.Generator().manual_seed(seed),
                          query_valid=vmask, donor_rows=donors),
        (q, k, v), (d_out, d_hm),
    )
    return "aca_attention", fwd_reading, backward_reading(
        shape,
        functools.partial(aca._launch_bwd, q, k, v, valid, got[2], *rest, form=form),
        functools.partial(aca.aca_attention_bwd_plain, q, k, v, valid, ref[2], *rest,
                          form=form),
        fn, attention_bound(b, lv, lk, heads, nd, valid, True, backward=True, pairs=pairs,
                            form=form),
        None, form,
    )


def self_train_case(dev, g, b, heads, p, seed, valid, form="3xtf32"):
    """Masked self-attention in training form at `form` over the keys of
    `valid`: the short kernel up to 128 keys, the flash kernel past.
    Returns (kernel name, forward reading, backward reading)."""
    import torch

    from flashvtg_tpu_torch.ops import aca, chunked_attn
    from flashvtg_tpu_torch.ops.attn_dropout import draw_seed

    length = valid.shape[1]
    q, k, v = qkv_b(g, dev, b, heads, length, length)
    d_out = torch.randn((b, length, heads * 32), generator=g).to(dev)
    drop_seed = draw_seed(torch.Generator().manual_seed(seed))
    shape = f"B={b} H={heads} L={length} Dh=32 p={p}"
    call = dict(key_valid=valid, num_heads=heads, dropout=p,
                generator=torch.Generator().manual_seed(seed))
    if length > aca.MAX_KEYS:
        name = "flash_attention"
        shape += f", valid keys {int(valid.sum().item())} of {b * length}"
        args = (q, k, v, valid, heads, p, drop_seed)
        fwd = functools.partial(chunked_attn._launch, *args, want_lse=True, form=form)
        fwd_plain = functools.partial(chunked_attn.flash_attention_plain, *args, want_lse=True,
                                      form=form)
        got, ref = fwd(), fwd_plain()
        bwd = functools.partial(chunked_attn._launch_bwd, q, k, v, valid, *got, d_out, heads,
                                p, drop_seed, form=form)
        bwd_plain = functools.partial(chunked_attn.flash_attention_bwd_plain, q, k, v, valid,
                                      *ref, d_out, heads, p, drop_seed, form=form)
        call = functools.partial(in_dial, form, chunked_attn.flash_attention, **call)
    else:
        name = "masked_attention"
        args = (q, k, v, valid, heads, 0, False, p, drop_seed)
        fwd = functools.partial(aca._launch, *args, want_lse=True, form=form)
        fwd_plain = functools.partial(aca.aca_attention_plain, *args, want_lse=True, form=form)
        got, ref = fwd(), fwd_plain()
        rest = (d_out, None, heads, 0, p, drop_seed)
        bwd = functools.partial(aca._launch_bwd, q, k, v, valid, got[2], *rest, form=form)
        bwd_plain = functools.partial(aca.aca_attention_bwd_plain, q, k, v, valid, ref[2],
                                      *rest, form=form)
        call = functools.partial(in_dial, form, aca.masked_attention, **call)
    fwd_reading = forward_reading(
        shape, got, ref, fwd, fwd_plain,
        attention_bound(b, length, length, heads, 0, valid, False, form=form),
        sdpa_train_forward_ms(q, k, v, valid, heads, p, form), form,
    )
    return name, fwd_reading, backward_reading(
        shape, bwd, bwd_plain, function_grads(call, (q, k, v), (d_out,)),
        attention_bound(b, length, length, heads, 0, valid, False, backward=True, form=form),
        sdpa_backward_ms(q, k, v, valid, heads, d_out, form), form,
    )


# (B, Lv, dummies, text tokens, fewest and most clips of a video) of each
# train path
TRAIN_KERNEL_SHAPES = {
    "tacos_train": (32, 2048, 35, 40, 64, 2048),
    "flagship_train": (64, 75, 10, 32, 20, 75),
    "tvsum_train": (4, 1000, 3, 32, 60, 330),
}


def phase_train_kernels(dev, seed, form="3xtf32"):
    """Phase 7 (and phase 14's at the other forms): the training forms and
    the backward kernels at each train path's shapes and `form`, dropout on,
    through their launchers (timed) and through the autograd Functions that
    the model calls. Returns the backward kernels' rows (at the TACoS train
    shapes, errors the largest over every shape) and every shape's
    readings, which are logged."""
    import torch

    rng = np.random.default_rng(seed + 1)
    g = torch.Generator().manual_seed(seed + 1)
    heads, p = 8, TRAIN_DROPOUT
    shapes, readings = {}, {}
    for path, (b, lv, nd, lq, min_clips, max_clips) in TRAIN_KERNEL_SHAPES.items():
        text = ragged_mask(rng, b, nd + lq, 5, lq + 1, always=nd).to(dev)
        video = ragged_mask(rng, b, lv, min_clips, max_clips + 1).to(dev)
        cases = (  # the ACA layers, the dummy encoder, the encoder
            aca_train_case(dev, g, b, lv, nd, heads, p, seed, text, video, form),
            self_train_case(dev, g, b, heads, p, seed, text, form),
            self_train_case(dev, g, b, heads, p, seed, video, form),
        )
        for (name, fwd, bwd), length in zip(cases, (lv, nd + lq, lv)):
            shapes[form_name(f"{path} {name} L={length}", form)] = fwd
            shapes[form_name(f"{path} {name}_bwd L={length}", form)] = bwd
            readings.setdefault(name + "_bwd", []).append(bwd)
        bhll = 4 * b * heads * lv * lv
        if lv > 128:  # the flash forward + backward's peak: memory-linear
            peak = shapes[form_name(f"{path} flash_attention_bwd L={lv}", form)][
                "function_fwd_bwd_peak_bytes"]
            if not peak < bhll:
                raise AssertionError(
                    f"flash fwd + bwd peak +{peak} B >= one (B, H, L, L) f32 {bhll} B")
            shapes[form_name(f"{path} flash_fwd_bwd_memory", form)] = dict(
                peak_above_inputs_bytes=peak, bhll_f32_bytes=bhll)
    for path, (b, lv, nd) in MS_KERNEL_SHAPES.items():
        keys = torch.ones((b, nd + 1), device=dev)  # dummies + the sentence token
        cases = (aca_train_case(dev, g, b, lv, nd, heads, p, seed, keys, None, form),
                 self_train_case(dev, g, b, heads, p, seed, keys, form))
        for (name, fwd, bwd), length in zip(cases, (lv, nd + 1)):
            shapes[form_name(f"{path}_train {name} L={length}", form)] = fwd
            shapes[form_name(f"{path}_train {name}_bwd L={length}", form)] = bwd
            readings[name + "_bwd"].append(bwd)
    source = {"aca_attention_bwd": "aca_attention_bwd.cu",
              "masked_attention_bwd": "aca_attention_bwd.cu",
              "flash_attention_bwd": "flash_attention_bwd.cu"}
    rows = []
    for name, found in readings.items():
        rows.append(dict(
            found[0], name=form_name(name, form), kernel=name, route="cuda",
            source="flashvtg_tpu_torch/csrc/" + source[name], replaces="scripts/bench_flash.py:67",
            **{key: max(r[key] for r in found)
               for key in ("max_abs_err", "max_rel_err", "function_rel_err")},
        ))
    return rows, shapes


def make_dataset(root, cfg, n_queries, seed, load_labels=False):
    """The synthetic eval set of a preset, written under `root` and loaded
    (with its train labels drawn when `load_labels`, for the eval losses).
    Where the dataset reads GloVe text (a "vgg" video directory), a GloVe
    file of the queries' words is written too and FLASHVTG_GLOVE_PATH
    points at it."""
    from flashvtg_tpu_torch.data.dataset import VTGDataset, uses_glove
    from flashvtg_tpu_torch.train.infer import eval_data_config
    from flashvtg_tpu_torch.utils.synthetic import write_glove

    ann, vdir, qdir = synthetic_writer(cfg)(root, n_queries=n_queries, seed=seed)
    if uses_glove((vdir,)):
        os.environ["FLASHVTG_GLOVE_PATH"] = write_glove(
            os.path.join(root, "glove.6B.300d.txt"), dim=cfg.t_feat_dim, seed=seed)
    cfg = cfg.replace(eval_path=ann, v_feat_dirs=(vdir,), t_feat_dir=qdir)
    return cfg, VTGDataset(eval_data_config(cfg, ann, load_labels=load_labels))


def check_submission(sub, ds, cfg):
    assert len(sub) == len(ds), (len(sub), len(ds))
    assert [s["qid"] for s in sub] == [m["qid"] for m in ds.data]
    for s, (_, feats) in zip(sub, (ds[i] for i in range(len(ds)))):
        wins = np.asarray(s["pred_relevant_windows"], np.float64)
        assert 0 < len(wins) <= cfg.max_num_moment and wins.shape[1] == 3
        assert np.isfinite(wins).all()
        if cfg.dset_name in MR_ONLY_SETS:  # the rows carry no saliency
            assert "pred_saliency_scores" not in s
            continue
        sal = np.asarray(s["pred_saliency_scores"], np.float64)
        assert len(sal) == min(len(feats["video_feat"]), cfg.max_v_l)
        assert np.isfinite(sal).all()


def reset_launch_counts():
    from flashvtg_tpu_torch.ops import aca, chunked_attn

    aca.reset_launch_counts()
    chunked_attn.reset_launch_counts()


def launch_counts():
    from flashvtg_tpu_torch.ops import aca, chunked_attn

    return {**aca.launch_counts(), **chunked_attn.launch_counts()}


def form_launch_counts():
    """{product form: {kernel: launches}} since the last reset."""
    from flashvtg_tpu_torch.ops import aca, chunked_attn

    return {form: {**aca.FORM_LAUNCHES[form], **chunked_attn.FORM_LAUNCHES[form]}
            for form in aca.FORM_LAUNCHES}


def counted(mode):
    """Each kernel's launches since the last reset, all of them at the
    form of the precision dial `mode` (every launch of a path runs in its
    dial's form), and those by form."""
    from flashvtg_tpu_torch.utils.runtime import KERNEL_FORMS

    form = KERNEL_FORMS[mode]
    launches, by_form = launch_counts(), form_launch_counts()
    assert by_form[form] == launches, (form, by_form, launches)
    return launches, by_form


# the device function that one launch of each kernel runs exactly once, by
# a pattern on its demangled name in the profiler's kernel records (the
# first template argument is the product form's id, ops/forms.py); the
# other device functions of a launch (the ACA backward's chunk sum, the
# flash backward's D and dk / dv passes) are left out. The ACA and the
# short self-attention's backwards are one device function, read as one.
BWD_PAIR = "aca_attention_bwd+masked_attention_bwd"
DEVICE_FUNCTIONS = (
    (r"aca_attention_kernel<(\d+),\s*\d+,\s*true", "aca_attention"),
    (r"aca_attention_kernel<(\d+),\s*\d+,\s*false", "masked_attention"),
    (r"aca_attention_bwd_kernel<(\d+)", BWD_PAIR),
    (r"flash_attention_kernel<(\d+)", "flash_attention"),
    (r"flash_bwd_dq_kernel<(\d+)", "flash_attention_bwd"),
)


def group_of(kernel):
    return BWD_PAIR if kernel in ("aca_attention_bwd", "masked_attention_bwd") else kernel


def grouped(counts):
    """{kernel: n} summed into DEVICE_FUNCTIONS' groups."""
    out = {group: 0 for _, group in DEVICE_FUNCTIONS}
    for name, n in counts.items():
        out[group_of(name)] += n
    return out


def device_launch_table(per_name):
    """{form: {group: launches}} of a profiled run's {device name: [us,
    calls]} (tools/profile_eval.py:profiled): the kernels' launches as the
    card ran them, those of eager calls and of CUDA-graph replays alike."""
    from flashvtg_tpu_torch.ops.forms import FORMS

    table = {form: grouped({}) for form in FORMS}
    for name, (_, calls) in per_name.items():
        for pattern, group in DEVICE_FUNCTIONS:
            m = re.search(pattern, name)
            if m:
                table[FORMS[int(m.group(1))]][group] += calls
                break
    return table


def device_launches(run):
    """(run()'s result, device_launch_table of run() under torch.profiler)."""
    from flashvtg_tpu_torch.tools.profile_eval import profiled

    box = []
    _, per_name = profiled(lambda: box.append(run()))
    return box[0], device_launch_table(per_name)


def at_form(form, counts):
    """{form: counts} with every other form's counts at 0."""
    from flashvtg_tpu_torch.ops.forms import FORMS

    return {f: counts if f == form else dict.fromkeys(counts, 0) for f in FORMS}


def add_tables(*tables):
    return {form: {g: sum(t[form][g] for t in tables) for g in tables[0][form]}
            for form in tables[0]}


def check_device_launches(what, table, want, eager):
    """A path's launches as the card ran them (`table`, device_launch_table)
    equal `want` ({form: {kernel: n}}: every step, eager or a graph replay,
    and every eval batch) in every form; the launches its wrappers counted
    (`eager`, {form: {kernel: n}}: eager calls only, a capture counts
    nothing) are at most those, and more than 0 for each kernel `want` has."""
    for form, counts in want.items():
        assert table[form] == grouped(counts), (what, form, table[form], grouped(counts))
        seen = grouped(eager[form])
        assert all(seen[g] <= n for g, n in table[form].items()), (what, form, seen)
        assert all(eager[form][k] > 0 for k, n in counts.items() if n), (what, form, eager)


def launches_per_batch(cfg):
    """Each kernel's launches in one eval forward: the ACA layers; the
    dummy encoder (num_dummies + max_q_l tokens) on the short kernel; the
    encoder on the short kernel up to 128 clips, on the flash kernel past."""
    from flashvtg_tpu_torch.ops.aca import MAX_KEYS

    assert cfg.num_dummies + cfg.max_q_l <= MAX_KEYS
    long_video = cfg.max_v_l > MAX_KEYS
    return {
        "aca_attention": cfg.t2v_layers,
        "masked_attention": cfg.dummy_layers + (0 if long_video else cfg.enc_layers),
        "flash_attention": cfg.enc_layers if long_video else 0,
    }


def score_mr(cfg, ds, out):
    """The MR eval's output checked (submission rows, finite metrics) and
    scored by eval_submission, with and without NMS."""
    from flashvtg_tpu_torch.eval.metrics import eval_submission

    sub, sub_nms, _ = out
    check_submission(sub, ds, cfg)
    check_submission(sub_nms, ds, cfg)
    metrics, metrics_nms = eval_submission(sub, ds.data), eval_submission(sub_nms, ds.data)
    for m in (metrics, metrics_nms):
        assert m["brief"] and all(np.isfinite(v) for v in m["brief"].values())
    return dict(brief=metrics["brief"], brief_nms=metrics_nms["brief"])


def score_hl(cfg, ds, result):
    """The HD eval's output checked: one finite saliency row per video, cut
    to its clips, and the domain's mAP (run_hl_inference scores it) in
    [0, 1]."""
    assert list(result["saliency"]) == [m["qid"] for m in ds.data]
    for sal, (_, feats) in zip(result["saliency"].values(), (ds[i] for i in range(len(ds)))):
        assert sal.shape == (min(len(feats["video_feat"]), cfg.max_v_l),)
        assert np.isfinite(sal).all()
    assert 0.0 <= result["brief"]["mAP"] <= 1.0, result["brief"]
    return dict(brief=result["brief"])


def phase_path(dev, cfg, ds, seed, infer, score, per_batch=None):
    """Phases 4, 6, 9, 11 and 13: one preset's eval through the kernels:
    infer(cfg, model, ds) (run_mr_inference or run_hl_inference) warmed up,
    then run with the launch counts set to 0 just before and read just
    after, each kernel's count equal to `per_batch` (default
    launches_per_batch) times the batches, then score(cfg, ds, output)."""
    import torch

    from flashvtg_tpu_torch.models import build_model

    model = build_model(cfg.model_config(), dev, seed)
    infer(cfg, model, ds)  # warm-up: cuBLAS / cuDNN plans
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    reset_launch_counts()
    t0 = time.perf_counter()
    out = infer(cfg, model, ds)
    torch.cuda.synchronize()
    t_infer = time.perf_counter() - t0
    launches, by_form = counted(cfg.eval_precision)
    scored = score(cfg, ds, out)
    t_total = time.perf_counter() - t0

    n_batches = -(-len(ds) // cfg.eval_bsz)
    assert len(ds) % cfg.eval_bsz == 0, "use a multiple of eval_bsz queries"
    for name, n in (per_batch or launches_per_batch(cfg)).items():
        assert launches[name] == n * n_batches, (name, launches[name], n * n_batches)
    return model, dict(
        queries=len(ds), batches=n_batches, eval_bsz=cfg.eval_bsz, max_v_l=cfg.max_v_l,
        eval_precision=cfg.eval_precision, launches=launches, form_launches=by_form,
        launches_per_batch=sum(launches.values()) / n_batches,
        infer_s=t_infer, infer_qps=len(ds) / t_infer,
        with_metrics_s=t_total, with_metrics_qps=len(ds) / t_total,
        peak_mem_bytes=torch.cuda.max_memory_allocated(), **scored,
    )


def step_inputs(dev, cfg, ds):
    """One full eval batch on the card, padded to the preset's bucket, and
    its strict point masks."""
    import torch

    from flashvtg_tpu_torch.data.collate import MODEL_KEYS, Collator
    from flashvtg_tpu_torch.models.points import pyramid_masks_strict

    batch = Collator(cfg.max_q_l, cfg.v_buckets, cfg.max_v_l)(
        [ds[i] for i in range(cfg.eval_bsz)]
    )
    placed = {k: torch.from_numpy(batch[k]).to(dev) for k in MODEL_KEYS}
    strict = pyramid_masks_strict(batch["valid_v_lens"], cfg.max_v_l, cfg.strides)[0]
    return placed, torch.from_numpy(strict).to(dev)


def eval_step(dev, model, cfg, ds):
    """One full eval batch's step at cfg.eval_precision (forward + decode;
    the HD sets' forward alone) as a call on tensors already on the card."""
    from flashvtg_tpu_torch.data.dataset import HD_SETS
    from flashvtg_tpu_torch.train.infer import make_eval_step

    placed, pv = step_inputs(dev, cfg, ds)
    step = make_eval_step(model, cfg.max_num_moment, cfg.eval_precision,
                          saliency_only=cfg.dset_name in HD_SETS)
    return lambda: step(placed, pv)


def full_logits_attention(q, k, v, key_valid, num_heads, dropout=0.0, generator=None):
    """The memory check's control: the encoder's self-attention in its plain
    full-logits form, which holds (B, H, L, L) logits and probabilities."""
    from flashvtg_tpu_torch.ops.aca import masked_attention_plain

    assert dropout == 0.0
    return masked_attention_plain(q, k, v, key_valid, num_heads)


def step_memory(run, cfg):
    """Device memory of one eval step against one (B, H, L, L) float32
    tensor, the logits the flash kernel never holds, bytes: the step's peak
    above what was allocated before it (reported), and the largest peak of
    a flash_attention call above what was allocated at the call's entry,
    which must stay under that tensor. The control runs the same calls
    through the plain full-logits attention, whose peak must reach it: else
    the measurement could not see the logits."""
    from unittest import mock

    import torch

    from flashvtg_tpu_torch.models import transformer

    def peak_above(fn):
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        return torch.cuda.max_memory_allocated() - before, out

    def measured(attend, seen):
        def call(*args, **kw):
            extra, out = peak_above(lambda: attend(*args, **kw))
            seen.append(extra)
            return out
        return call

    logits = 4 * cfg.eval_bsz * cfg.nheads * cfg.max_v_l ** 2
    res = dict(step_extra_peak_bytes=peak_above(run)[0], bhll_f32_bytes=logits)
    for tag, attend in (("kernel", transformer.flash_attention),
                        ("plain", full_logits_attention)):
        seen = []
        with mock.patch.object(transformer, "flash_attention", measured(attend, seen)):
            run()
        assert len(seen) == cfg.enc_layers, seen
        res[f"{tag}_flash_call_peak_bytes"] = max(seen)
    assert res["kernel_flash_call_peak_bytes"] < logits, (
        f"flash call peak +{res['kernel_flash_call_peak_bytes']} B >= one (B, H, L, L) "
        f"f32 {logits} B")
    assert res["plain_flash_call_peak_bytes"] >= logits, (
        f"control: full-logits call peak +{res['plain_flash_call_peak_bytes']} B < {logits} B")
    return res


def phase_card_vs_cpu(dev, model, cfg, ds, seed, n, spans=False):
    """Phases 5 and 6: the same weights on the card and on the CPU, over the
    first n queries (a short video among them); with `spans` the decoded
    windows of the eval step too (phase 13: the DFL decode), within
    SPAN_ATOL, and their scores within FORWARD_ATOL."""
    import torch

    from flashvtg_tpu_torch.data.collate import MODEL_KEYS, Collator
    from flashvtg_tpu_torch.models import build_model
    from flashvtg_tpu_torch.models.points import pyramid_masks_strict
    from flashvtg_tpu_torch.train.infer import make_eval_step

    batch = Collator(cfg.max_q_l, cfg.v_buckets, cfg.max_v_l)([ds[i] for i in range(n)])
    assert batch["valid_v_lens"].min() < cfg.max_v_l  # a short video is in
    strict = pyramid_masks_strict(batch["valid_v_lens"], cfg.max_v_l, cfg.strides)[0]
    host = [torch.from_numpy(batch[k]) for k in MODEL_KEYS] + [torch.from_numpy(strict)]
    cpu_model = build_model(cfg.model_config(), "cpu", seed)
    with torch.no_grad():
        ref = cpu_model(*host)
        out = model(*(t.to(dev) for t in host))
    errs = {}
    for key in ("saliency_scores", "t2vattnvalues", "attn_weights", "out_class", "out_coord"):
        o = out[key].cpu()
        assert torch.isfinite(o).all(), key
        errs[key] = (o - ref[key]).abs().max().item()
        assert errs[key] <= FORWARD_ATOL, (key, errs[key])
    if spans:
        decoded = []
        for m, d in ((cpu_model, "cpu"), (model, dev)):
            step = make_eval_step(m, cfg.max_num_moment)
            placed = dict(zip(MODEL_KEYS, (t.to(d) for t in host)))
            decoded.append([t.cpu() for t in step(placed, host[-1].to(d))[:2]])
        (ref_spans, ref_scores), (got_spans, got_scores) = decoded
        errs["spans"] = (got_spans - ref_spans).abs().max().item()
        errs["span_scores"] = (got_scores - ref_scores).abs().max().item()
        assert errs["spans"] <= SPAN_ATOL, ("spans", errs["spans"])
        assert errs["span_scores"] <= FORWARD_ATOL, ("span scores", errs["span_scores"])
    return errs


def run_preset(dev, preset, n_queries, n_compare, seed, feed_compare=False, **overrides):
    """Data, the eval path (phase_path through run_mr_inference, or
    run_hl_inference for the HD sets), its device step and card vs CPU for
    one preset; with `feed_compare`, phase 15 (c) on the same split
    (feed_vs_streamed_eval)."""
    from flashvtg_tpu_torch.data.dataset import HD_SETS
    from flashvtg_tpu_torch.train.config import from_preset
    from flashvtg_tpu_torch.train.infer import run_hl_inference, run_mr_inference

    cfg = from_preset(preset, **{"eval_precision": "float32", **overrides})
    glove_before = os.environ.get("FLASHVTG_GLOVE_PATH")
    try:
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            cfg, ds = make_dataset(tmp, cfg, n_queries, seed)
            log(f"[{preset} data] {len(ds)} queries written and loaded in "
                f"{time.perf_counter() - t0:.2f} s")
            infer, score = ((run_hl_inference, score_hl) if cfg.dset_name in HD_SETS
                            else (run_mr_inference, score_mr))
            model, path = phase_path(dev, cfg, ds, seed, infer, score)
            if feed_compare:
                path["feed_vs_streamed"] = feed_vs_streamed_eval(cfg, model, ds, infer)
                log(f"[feed eval {preset}] {json.dumps(path['feed_vs_streamed'])}")
            run = eval_step(dev, model, cfg, ds)
            path["step_ms"] = time_ms(run, iters=20, warmup=3)
            path["step_qps"] = cfg.eval_bsz / path["step_ms"] * 1e3
            if launches_per_batch(cfg)["flash_attention"]:
                path.update(step_memory(run, cfg))
            log(f"[{preset} path] {json.dumps(path)}")
            path["card_vs_cpu_max_abs_err"] = phase_card_vs_cpu(
                dev, model, cfg, ds, seed, n_compare
            )
            log(f"[{preset} card vs cpu] max |err| "
                f"{json.dumps(path['card_vs_cpu_max_abs_err'])}")
    finally:
        if glove_before is None:
            os.environ.pop("FLASHVTG_GLOVE_PATH", None)
        else:
            os.environ["FLASHVTG_GLOVE_PATH"] = glove_before
    return path


def train_launches_per_step(cfg):
    """Each kernel's launches in one train step: the forward of the positive
    and the negative pass (the dummy encoder runs once), and one backward
    launch for each forward launch."""
    per = launches_per_batch(cfg)
    passes = 2 if cfg.use_neg else 1
    long_video = per["flash_attention"] > 0
    per = {
        "aca_attention": cfg.t2v_layers * passes,
        "masked_attention": cfg.dummy_layers + (0 if long_video else cfg.enc_layers * passes),
        "flash_attention": cfg.enc_layers * passes if long_video else 0,
    }
    per.update({f"{name}_bwd": n for name, n in per.items()})
    return per


def make_train_split(root, cfg, n_train, n_val, seed):
    """A synthetic train split of n_train rows and an eval split of n_val
    rows under `root`, sharing the feature directories."""
    writer = synthetic_writer(cfg)
    ann, vdir, qdir = writer(root, n_queries=n_train, seed=seed, split="train")
    val, _, _ = writer(root, n_queries=n_val, seed=seed + 1, split="val")
    return cfg.replace(train_path=ann, eval_path=val, v_feat_dirs=(vdir,), t_feat_dir=qdir)


def train_batch(cfg, rows):
    """Collated train rows `rows` of cfg.train_path (labels drawn)."""
    from flashvtg_tpu_torch.data.collate import Collator
    from flashvtg_tpu_torch.data.dataset import VTGDataset
    from flashvtg_tpu_torch.train.loop import train_data_config

    ds = VTGDataset(train_data_config(cfg, cfg.train_path), preload=False)
    collate = Collator(cfg.max_q_l, cfg.v_buckets, cfg.max_v_l, max_windows=cfg.max_windows,
                       dset_name=cfg.dset_name)
    return collate([ds[i] for i in rows])


def train_step_time(dev, model, cfg, seed, batch=None):
    """Device time of one train step at cfg.train_precision on a batch
    already on the card (CUDA events over 5 steps), ms, the step's peak
    memory, bytes, and the time of the same step with the batch's copy to
    the card (place_batch at cfg.transfer_dtype) in it, ms. `batch`: a
    collated batch (default: the first bsz rows of cfg.train_path)."""
    import torch

    from flashvtg_tpu_torch.train.loop import make_optimizer, make_train_step, place_batch

    batch = train_batch(cfg, range(cfg.bsz)) if batch is None else batch
    placed = place_batch(batch, dev, transfer_dtype=cfg.transfer_dtype)
    optimizer, scheduler = make_optimizer(cfg, model.parameters(), 1)
    step = make_train_step(model, cfg.loss_config(), optimizer, scheduler,
                           cfg.grad_clip, torch.Generator(device=dev).manual_seed(seed),
                           cfg.train_precision)
    step(placed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = time_ms(lambda: step(placed), iters=5, warmup=1)
    peak = torch.cuda.max_memory_allocated()
    with_copy = time_ms(lambda: step(place_batch(batch, dev, transfer_dtype=cfg.transfer_dtype)),
                        iters=5, warmup=1)
    return ms, peak, with_copy


def train_card_vs_cpu(dev, cfg, seed, n_rows):
    """One 2-row step at full width with every dropout at 0 (dummy_dropout
    and input_dropout included), the same weights on the card (float32)
    and on the CPU in float64, the reference: losses, clipped gradients,
    parameters after the AdamW step. Not against a CPU float32 step: at a
    ReLU whose input is within rounding of 0, two float32 runs can take its
    two sides, and the gradient is discontinuous there (the tvsum_ms step's
    CPU float32 run takes one such ReLU the other way, 4e-3 of its leaf). The rows: the shortest video of the first 8 (of n_rows) and
    another."""
    import dataclasses

    import torch

    from flashvtg_tpu_torch.models import build_model
    from flashvtg_tpu_torch.train.loop import make_optimizer, make_train_step, place_batch

    cfg = cfg.replace(dropout=0.0, input_dropout=0.0)
    mcfg = dataclasses.replace(cfg.model_config(), dummy_dropout=0.0)
    first = train_batch(cfg, range(min(8, n_rows)))
    short = int(np.argmin(first["valid_v_lens"]))
    assert first["valid_v_lens"][short] < cfg.max_v_l  # a short video is in
    batch = train_batch(cfg, [0 if short else 1, short])
    runs = {}
    for name, d, dtype in (("cpu64", "cpu", torch.float64), ("card", dev, torch.float32)):
        model = build_model(mcfg, d, seed).to(dtype).train()
        before = {n: p.detach().to("cpu", torch.float64, copy=True)
                  for n, p in model.named_parameters()}
        optimizer, scheduler = make_optimizer(cfg, model.parameters(), 1)
        step = make_train_step(model, cfg.loss_config(), optimizer, scheduler,
                               cfg.grad_clip, precision="float32")
        losses = {k: v.item() for k, v in step(place_batch(batch, d, dtype)).items()}
        named = [(n, p) for n, p in model.named_parameters() if p.grad is not None]
        runs[name] = (losses, {n: p.grad.cpu().double() for n, p in named},
                      {n: p.detach().cpu().double() - before[n] for n, p in named})
    (l_ref, g_ref, u_ref), (l_card, g_card, u_card) = runs["cpu64"], runs["card"]
    # each leaf relative to its own largest gradient, floored at a share of
    # the largest over all leaves (a leaf whose gradients all sit at that
    # floor's rounding is held in absolute terms)
    floor = STEP_GRAD_FLOOR * max(g.abs().max().item() for g in g_ref.values())

    loss_err = max(abs(l_card[k] - v) / max(abs(v), 1e-6) for k, v in l_ref.items())
    grad_errs = {n: (g_card[n] - g).abs().max().item() / max(g.abs().max().item(), floor)
                 for n, g in g_ref.items()}
    worst = max(grad_errs, key=grad_errs.get)
    # the first AdamW step moves a weight by lr (g / (|g| + eps) + wd p):
    # it carries the sign of each gradient, so updates are compared where
    # the sign is beyond the gradients' disagreement, to 1% of lr
    update_err, compared = 0.0, 0
    for n, g in g_ref.items():
        sure = g.abs() > 100 * (g_card[n] - g).abs().max()
        if sure.any():
            update_err = max(update_err, (u_card[n] - u_ref[n])[sure].abs().max().item())
            compared += int(sure.sum().item())
    total = sum(g.numel() for g in g_ref.values())
    assert all(np.isfinite(v) for v in l_card.values())
    assert loss_err <= STEP_LOSS_RTOL, ("losses", loss_err, l_card, l_ref)
    assert grad_errs[worst] <= STEP_GRAD_RTOL, ("gradients", worst, grad_errs[worst])
    assert compared > total // 4, ("updates compared", compared, total)
    assert update_err <= 1e-2 * cfg.lr, ("updates", update_err)
    return dict(reference="cpu float64", loss_rel_err=loss_err, grad_rel_err=grad_errs[worst],
                grad_worst_leaf=worst, update_abs_err=update_err, updates_compared=compared,
                weights=total, rows=len(batch["vid"]), valid_v_lens=batch["valid_v_lens"].tolist())


def read_train_run(run_dir):
    """(per-step losses from scalars.jsonl, the eval.log.txt lines as
    (epoch, metrics)) of a train() results directory."""
    with open(os.path.join(run_dir, "tensorboard_log", "scalars.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    losses = [{k[len("train/"):]: v for k, v in r.items() if k.startswith("train/")}
              for r in rows if any(k.startswith("train/") for k in r)]
    evals = []
    if os.path.exists(os.path.join(run_dir, "eval.log.txt")):
        with open(os.path.join(run_dir, "eval.log.txt")) as f:
            for line in f:
                epoch = int(line.split("[Epoch] ")[1].split()[0])
                evals.append((epoch, json.loads(line.split("[Metrics] ", 1)[1])))
    return losses, evals


def eval_launches(cfg):
    """Each kernel's launches in one eval batch inside train(): the HD sets'
    saliency forward; the MR sets' forward with the negative pass, for the
    eval losses (the forward launches of a train step)."""
    from flashvtg_tpu_torch.data.dataset import HD_SETS

    if cfg.dset_name in HD_SETS:
        return launches_per_batch(cfg)
    return {k: v for k, v in train_launches_per_step(cfg).items() if not k.endswith("_bwd")}


def run_train_preset(dev, preset, steps, seed, n_train=None, n_val=None, **overrides):
    """Phases 8 and 10 for one preset: train() for `steps` steps on n_train
    rows (default one epoch) with one eval, after the last epoch, on n_val
    rows (default eval_bsz), its launches and losses, the step's time and
    memory, card vs CPU."""
    import torch

    from flashvtg_tpu_torch.train.config import from_preset
    from flashvtg_tpu_torch.train.infer import _tail_bucket
    from flashvtg_tpu_torch.train.loop import train
    from flashvtg_tpu_torch.utils.runtime import KERNEL_FORMS

    cfg = from_preset(preset, **{"use_tensorboard": False, "train_precision": "float32",
                                 "eval_precision": "float32", **overrides})
    n_train = n_train or steps * cfg.bsz
    n_val = n_val or cfg.eval_bsz
    epochs = -(-steps // max(1, n_train // cfg.bsz))
    cfg = cfg.replace(n_epoch=epochs, eval_epoch=epochs)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        cfg = make_train_split(tmp, cfg, n_train, n_val, seed)
        log(f"[{preset} train data] {n_train} + {n_val} rows written in "
            f"{time.perf_counter() - t0:.2f} s")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        (model, _, run_dir), table = device_launches(
            lambda: train(cfg, os.path.join(tmp, "run"), dev, max_steps=steps))
        t_train = time.perf_counter() - t0
        launches, by_form = counted(cfg.train_precision)
        assert cfg.eval_precision == cfg.train_precision
        peak = torch.cuda.max_memory_allocated()
        losses, evals = read_train_run(run_dir)
        assert len(losses) == steps and len(evals) == 1, (len(losses), len(evals))
        assert all(np.isfinite(v) for h in losses for v in h.values())
        brief = evals[0][1]["brief"]
        assert np.isfinite(list(brief.values())).all()
        assert _tail_bucket(n_val, cfg.eval_bsz) == n_val  # the eval is one full batch
        per_step = train_launches_per_step(cfg)
        per_eval = eval_launches(cfg)
        want = {name: n * steps + per_eval.get(name, 0) for name, n in per_step.items()}
        check_device_launches(f"{preset} train", table,
                              at_form(KERNEL_FORMS[cfg.train_precision], want), by_form)
        assert peak < 80e9, f"train peak {peak} B"
        step_ms, step_peak, step_copy_ms = train_step_time(dev, model.train(), cfg, seed)
        path = dict(
            preset=preset, bsz=cfg.bsz, max_v_l=cfg.max_v_l, steps=steps, eval_rows=n_val,
            train_precision=cfg.train_precision, transfer_dtype=cfg.transfer_dtype,
            launches=launches, form_launches=by_form, device_launches=table,
            launches_per_step=per_step, train_s=t_train,
            losses_first=losses[0], losses_last=losses[-1],
            brief=brief, peak_mem_bytes=peak, step_ms=step_ms,
            step_rows_per_s=cfg.bsz / step_ms * 1e3, step_peak_mem_bytes=step_peak,
            step_with_copy_ms=step_copy_ms,
        )
        log(f"[{preset} train path] {json.dumps(path)}")
        del model
        if cfg.train_precision == "float32":  # the other dials: phase 14
            path["card_vs_cpu"] = train_card_vs_cpu(dev, cfg, seed, n_train)
            log(f"[{preset} train card vs cpu] {json.dumps(path['card_vs_cpu'])}")
    return path


def load_on_cpu(cfg, path, steps_per_epoch, seed):
    """A checkpoint written on the card, loaded on the CPU (map_location):
    the weights into a CPU model, AdamW's and StepLR's state into theirs;
    returns the number of tensors loaded, every one on the CPU."""
    import torch

    from flashvtg_tpu_torch.models import build_model
    from flashvtg_tpu_torch.train.loop import load_checkpoint, load_model_weights, make_optimizer
    from flashvtg_tpu_torch.utils.convert import model_state

    ckpt = load_checkpoint(path, "cpu")
    model = build_model(cfg.model_config(), "cpu", seed)
    load_model_weights(model, model_state(ckpt))
    optimizer, scheduler = make_optimizer(cfg, model.parameters(), steps_per_epoch)
    optimizer.load_state_dict(ckpt["optimizer"])
    scheduler.load_state_dict(ckpt["lr_scheduler"])
    tensors = [t for s in optimizer.state.values() for t in s.values() if torch.is_tensor(t)]
    tensors += list(model.state_dict().values())
    assert tensors and all(t.device.type == "cpu" for t in tensors)
    return len(tensors)


def run_cli(dev, seed, n_train=96, n_val=64, epochs=3, bsz=32):
    """Phase 12: train -> infer -> export -> infer -> resume through the
    port's CLI at the flagship's full width and depth on the card."""
    import glob

    import torch

    from flashvtg_tpu_torch import cli
    from flashvtg_tpu_torch.train.config import from_preset

    preset = "qvhighlights_slowclip"
    cfg = from_preset(preset, bsz=bsz)
    times = {}
    with tempfile.TemporaryDirectory() as tmp:
        cfg = make_train_split(tmp, cfg, n_train, n_val, seed)
        flags = [
            "--device", str(dev), "--seed", str(seed), "--bsz", str(bsz), "--eval_epoch", "1",
            "--train_path", cfg.train_path, "--eval_path", cfg.eval_path,
            "--v_feat_dirs", *cfg.v_feat_dirs, "--t_feat_dir", cfg.t_feat_dir,
            "--results_root", os.path.join(tmp, "results"), "--exp_id", "cli",
            "--use_tensorboard", "false", "--train_precision", "float32",
            "--eval_precision", "float32",
        ]

        tables = []

        def call(name, *argv):
            t0 = time.perf_counter()
            rc, table = device_launches(lambda: cli.main(list(argv)))
            assert rc == 0, name
            tables.append(table)
            times[name] = time.perf_counter() - t0
            log(f"[cli] {name}: {times[name]:.2f} s")

        reset_launch_counts()
        call("train", "train", preset, *flags, "--n_epoch", str(epochs))
        (run_dir,) = glob.glob(os.path.join(tmp, "results", "*"))
        for name in ("model_best.ckpt", "model_latest.ckpt", "opt.json", "eval.log.txt"):
            assert os.path.isfile(os.path.join(run_dir, name)), name
        losses, evals = read_train_run(run_dir)
        assert [e for e, _ in evals] == list(range(epochs)), evals
        assert len(losses) == epochs * (n_train // bsz)
        best = os.path.join(run_dir, "model_best.ckpt")
        best_epoch = torch.load(best, map_location="cpu", weights_only=False)["epoch"]
        best_brief = dict(evals)[best_epoch]["brief"]
        cpu_loaded = load_on_cpu(cfg, os.path.join(run_dir, "model_latest.ckpt"),
                                 n_train // bsz, seed)
        export_dir = os.path.join(tmp, "export")
        exported = os.path.join(export_dir, "model.ckpt")
        call("infer", "infer", preset, *flags, "--resume", best)
        call("export", "export", preset, *flags, "--resume", best, "--export_path", exported)
        call("infer_export", "infer", preset, *flags, "--resume", exported)
        # the resumed run's directory is named to the second
        time.sleep(max(0.0, 1.05 - (time.time() % 1.0)))
        call("train_resume_auto", "train", preset, *flags, "--n_epoch", str(epochs + 1),
             "--resume", "auto")
        launches, by_form = counted("float32")

        sub_dir = os.path.join(tmp, "sub")
        t0 = time.perf_counter()
        done = subprocess.run(
            [sys.executable, "-m", "flashvtg_tpu_torch.cli", "infer", preset, *flags,
             "--resume", best, "--eval_results_dir", sub_dir],
            cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True, text=True,
            timeout=600,
        )
        times["infer_subprocess"] = time.perf_counter() - t0
        log(f"[cli] infer_subprocess: {times['infer_subprocess']:.2f} s")
        assert done.returncode == 0, done.stderr[-4000:]

        def brief_of(d):
            with open(os.path.join(d, f"infer_{cfg.dset_name}_val_preds_metrics.json")) as f:
                return json.load(f)["brief"]

        briefs = {"infer": brief_of(run_dir), "infer_export": brief_of(export_dir),
                  "infer_subprocess": brief_of(sub_dir)}
        for name, b in briefs.items():
            assert b == best_brief, (name, b, best_brief)
        resumed = [d for d in glob.glob(os.path.join(tmp, "results", "*")) if d != run_dir]
        assert len(resumed) == 1, resumed
        r_losses, r_evals = read_train_run(resumed[0])
        assert [e for e, _ in r_evals] == [epochs], r_evals  # epoch index 3 only
        assert len(r_losses) == n_train // bsz
        r_latest = torch.load(os.path.join(resumed[0], "model_latest.ckpt"), map_location="cpu",
                              weights_only=False)
        assert r_latest["epoch"] == epochs, r_latest["epoch"]

        steps = (epochs + 1) * (n_train // bsz)
        evals_run = epochs + 1 + 2  # the train-time evals and the two in-process infers
        per_step, per_eval = train_launches_per_step(cfg), eval_launches(cfg)
        want = {name: n * steps + per_eval.get(name, 0) * evals_run
                for name, n in per_step.items()}
        table = add_tables(*tables)
        check_device_launches("cli", table, at_form("3xtf32", want), by_form)
    return dict(preset=preset, bsz=bsz, train_rows=n_train, val_rows=n_val, epochs=epochs,
                best_epoch=best_epoch, best_brief=best_brief, call_s=times,
                card_ckpt_tensors_loaded_on_cpu=cpu_loaded, launches=launches,
                form_launches=by_form, device_launches=table, resumed_first_epoch=r_evals[0][0],
                losses_first=losses[0], losses_last=losses[-1])


def run_ms_mr_eval(dev, n_queries, n_compare, seed, **overrides):
    """Phase 13 (c): the flagship with variant=ms, use_dfl and use_eos at
    full width (B 256, Lv 75) through run_mr_inference with the eval losses
    (the forward's negative pass) and eval_submission; the device step
    (forward + DFL decode); card vs CPU with the decoded spans."""
    from flashvtg_tpu_torch.losses import declared_loss_keys
    from flashvtg_tpu_torch.train.config import from_preset
    from flashvtg_tpu_torch.train.infer import run_mr_inference

    cfg = from_preset("qvhighlights_slowclip", variant="ms", use_dfl=True, use_eos=True,
                      **{"eval_precision": "float32", **overrides})
    loss_cfg = cfg.loss_config()

    def infer(cfg, model, ds):
        return run_mr_inference(cfg, model, ds, loss_cfg=loss_cfg)

    def score(cfg, ds, out):
        losses = out[2]
        assert sorted(losses) == list(declared_loss_keys(loss_cfg)), sorted(losses)
        assert "loss_eos" in losses and all(np.isfinite(v) for v in losses.values()), losses
        return dict(score_mr(cfg, ds, out), eval_losses=losses)

    with tempfile.TemporaryDirectory() as tmp:
        cfg, ds = make_dataset(tmp, cfg, n_queries, seed, load_labels=True)
        model, path = phase_path(dev, cfg, ds, seed, infer, score, per_batch=eval_launches(cfg))
        path["step_ms"] = time_ms(eval_step(dev, model, cfg, ds), iters=20, warmup=3)
        path["step_qps"] = cfg.eval_bsz / path["step_ms"] * 1e3
        log(f"[ms mr path] {json.dumps(path)}")
        path["card_vs_cpu_max_abs_err"] = phase_card_vs_cpu(dev, model, cfg, ds, seed,
                                                            n_compare, spans=True)
        log(f"[ms mr card vs cpu] max |err| {json.dumps(path['card_vs_cpu_max_abs_err'])}")
    return path


PRECISION_MODES = ("float32", "tensorfloat32", "bfloat16")


def phase_form_identity(dev, seed):
    """Phase 14: each of the six kernels at each of the three forms,
    through its launcher, against the plain versions at all three, on one
    set of inputs a kernel: the flagship's ACA (B 64, Lv 75, 10 dummies,
    ragged text; in training form with donor rows for the backward), the
    encoder's short self-attention at L 75, the flash kernel at B 2 and
    L 2048; the backwards at dropout 0.1 with a head-mean gradient for the
    ACA. The distance of the kernel at F to the plain version at G is
    rms(kernel - plain) / rms(plain), the largest over the outputs; the
    distance to the 3xTF32 (f32-accurate) plain version must lie in
    FORM_F32_BAND[F], and that to F's be the least of the three. Returns
    {kernel: {form: {plain's form: distance}}}."""
    import torch

    from flashvtg_tpu_torch.models.transformer import tiled_attn_donors
    from flashvtg_tpu_torch.ops import aca, chunked_attn
    from flashvtg_tpu_torch.ops.forms import FORMS

    g = torch.Generator().manual_seed(seed + 3)
    rng = np.random.default_rng(seed + 3)
    heads, p, drop_seed = 8, TRAIN_DROPOUT, 1234
    b, lv, nd, lq = 64, 75, 10, 32

    def grads_of(b_, lq_):
        return torch.randn((b_, lq_, heads * 32), generator=g).to(dev)

    q, k, v = qkv_b(g, dev, b, heads, lv, nd + lq)
    text = ragged_mask(rng, b, nd + lq, 5, lq + 1, always=nd).to(dev)
    video = ragged_mask(rng, b, lv, 20, lv + 1).to(dev)
    donors = tiled_attn_donors(b, heads, dev)
    aca_train = (q, k, v, text, heads, nd, True, p, drop_seed, video, donors)
    lse = aca.aca_attention_plain(*aca_train, want_lse=True)[2]
    d_hm = torch.randn((b, lv, nd + lq), generator=g).to(dev)
    qs, ks, vs = qkv_b(g, dev, b, heads, lv, lv)
    lse_s = aca.aca_attention_plain(qs, ks, vs, video, heads, 0, False, p, drop_seed,
                                    want_lse=True)[2]
    bf, lf = 2, 2048
    qf, kf, vf = qkv_b(g, dev, bf, heads, lf, lf)
    keys = ragged_mask(rng, bf, lf, 1024, lf + 1).to(dev)
    out_f, lse_f = chunked_attn.flash_attention_plain(qf, kf, vf, keys, heads, p, drop_seed,
                                                      want_lse=True)
    cases = {  # kernel: (launcher, plain version, arguments)
        "aca_attention": (aca._launch, aca.aca_attention_plain, (q, k, v, text, heads, nd)),
        "masked_attention": (aca._launch, aca.aca_attention_plain,
                             (qs, ks, vs, video, heads, 0, False)),
        "flash_attention": (chunked_attn._launch, chunked_attn.flash_attention_plain,
                            (qf, kf, vf, keys, heads)),
        "aca_attention_bwd": (aca._launch_bwd, aca.aca_attention_bwd_plain,
                              (q, k, v, text, lse, grads_of(b, lv), d_hm, heads, nd, p,
                               drop_seed, video, donors)),
        "masked_attention_bwd": (aca._launch_bwd, aca.aca_attention_bwd_plain,
                                 (qs, ks, vs, video, lse_s, grads_of(b, lv), None, heads, 0, p,
                                  drop_seed)),
        "flash_attention_bwd": (chunked_attn._launch_bwd, chunked_attn.flash_attention_bwd_plain,
                                (qf, kf, vf, keys, out_f, lse_f, grads_of(bf, lf), heads, p,
                                 drop_seed)),
    }

    def outputs(res):
        return [t for t in (res if isinstance(res, tuple) else (res,)) if t is not None]

    def distance(got, ref):
        return max(((x - y).double().pow(2).mean().sqrt()
                    / y.double().pow(2).mean().sqrt()).item() for x, y in zip(got, ref))

    found = {}
    for name, (launch, plain, args) in cases.items():
        plains = {f: outputs(plain(*args, form=f)) for f in FORMS}
        found[name] = {}
        for form in FORMS:
            got = outputs(launch(*args, form=form))
            torch.cuda.synchronize()
            dist = {f: distance(got, ref) for f, ref in plains.items()}
            found[name][form] = dist
            floor, limit = FORM_F32_BAND[form]
            if not (floor <= dist["3xtf32"] <= limit
                    and dist[form] == min(dist.values())):
                raise AssertionError(f"{name} at {form}: distances to the plain versions "
                                     f"{dist}, to 3xtf32's outside {(floor, limit)} or not "
                                     "nearest its own form's")
    return found
FORWARD_KEYS = ("saliency_scores", "t2vattnvalues", "attn_weights", "out_class", "out_coord")


def forward_at(mode, model, placed, pv):
    """The eval forward of a placed batch at `mode`, outputs in float32."""
    import torch

    from flashvtg_tpu_torch.data.collate import MODEL_KEYS
    from flashvtg_tpu_torch.utils.runtime import float32_outputs, matmul_precision

    with torch.no_grad(), matmul_precision(mode, pv.device):
        out = model(*(placed[k] for k in MODEL_KEYS), point_valid=pv)
    return float32_outputs(out)


def in_band(what, mode, value, bands):
    """Fails unless floor <= value <= limit, (floor, limit) = bands[mode]."""
    floor, limit = bands[mode]
    assert floor <= value <= limit, (what, mode, value, (floor, limit))


def vs_float32(mode, got, ref, what):
    """Each output's max |got - ref| over max(max |ref|, 0.1), and a failure
    where the worst lies outside PRECISION_FWD_BAND[mode]."""
    import torch

    errs = {}
    for key in ref:
        assert torch.isfinite(got[key]).all(), (what, mode, key)
        errs[key] = rel_err(got[key], ref[key])
    in_band(what, mode, max(errs.values()), PRECISION_FWD_BAND)
    return errs


def run_precision_eval(dev, preset, n_queries, seed, **overrides):
    """Phase 14: one preset's eval at each precision dial: phase_path
    (run_mr_inference or run_hl_inference; every launch at the dial's
    form), the eval step's time, the metrics, and the forward of one full
    eval batch held against the card's own float32 forward
    (PRECISION_FWD_BAND). Returns {mode: path}."""
    from flashvtg_tpu_torch.data.dataset import HD_SETS
    from flashvtg_tpu_torch.train.config import from_preset
    from flashvtg_tpu_torch.train.infer import run_hl_inference, run_mr_inference

    cfg = from_preset(preset, **overrides)
    infer, score = ((run_hl_inference, score_hl) if cfg.dset_name in HD_SETS
                    else (run_mr_inference, score_mr))
    out, ref = {}, None
    with tempfile.TemporaryDirectory() as tmp:
        cfg, ds = make_dataset(tmp, cfg, n_queries, seed)
        for mode in PRECISION_MODES:
            cfg_m = cfg.replace(eval_precision=mode)
            model, path = phase_path(dev, cfg_m, ds, seed, infer, score)
            path["step_ms"] = time_ms(eval_step(dev, model, cfg_m, ds), iters=20, warmup=3)
            path["step_qps"] = cfg.eval_bsz / path["step_ms"] * 1e3
            fwd = forward_at(mode, model, *step_inputs(dev, cfg, ds))
            fwd = {k: fwd[k] for k in FORWARD_KEYS}
            if ref is None:
                ref = fwd
            else:
                path["vs_float32_rel_err"] = vs_float32(mode, fwd, ref, preset)
            log(f"[{preset} {mode}] {json.dumps(path)}")
            out[mode] = path
    return out


def zero_dropout_step(dev, cfg, batch, seed):
    """One train step at cfg.train_precision and cfg.transfer_dtype with
    every dropout at 0, unclipped: (total loss, every parameter's gradient
    in one float64 vector)."""
    import dataclasses

    import torch

    from flashvtg_tpu_torch.models import build_model
    from flashvtg_tpu_torch.train.loop import make_optimizer, make_train_step, place_batch

    cfg = cfg.replace(dropout=0.0, input_dropout=0.0)
    model = build_model(dataclasses.replace(cfg.model_config(), dummy_dropout=0.0), dev,
                        seed).train()
    optimizer, scheduler = make_optimizer(cfg, model.parameters(), 1)
    step = make_train_step(model, cfg.loss_config(), optimizer, scheduler, 0.0,
                           precision=cfg.train_precision)
    loss = step(place_batch(batch, dev, transfer_dtype=cfg.transfer_dtype))
    grads = torch.cat([p.grad.flatten().double() for p in model.parameters()])
    return loss["weighted_loss_overall"].item(), grads


def run_precision_train(dev, preset, seed, configs, n_rows=None, **overrides):
    """Phase 14: one preset's train step (make_train_step) at each
    (train_precision, transfer_dtype) of `configs`, the first float32: the
    step's time on a batch already on the card and with its copy to the card
    in it, the step's peak memory, launches by form (every one at the dial's
    form); and one step with every dropout at 0 from the same weights against
    the float32 step's: total loss within PRECISION_LOSS_RTOL, gradients
    (|g - g32| / |g32| over every parameter) within PRECISION_GRAD_BAND.
    Returns {"mode/transfer_dtype": reading}."""
    import torch

    from flashvtg_tpu_torch.models import build_model
    from flashvtg_tpu_torch.train.config import from_preset

    cfg = from_preset(preset, use_tensorboard=False, **overrides)
    out, ref = {}, None
    with tempfile.TemporaryDirectory() as tmp:
        cfg = make_train_split(tmp, cfg, n_rows or cfg.bsz, cfg.eval_bsz, seed)
        batch = train_batch(cfg, range(cfg.bsz))
        for mode, wire in configs:
            cfg_m = cfg.replace(train_precision=mode, transfer_dtype=wire)
            model = build_model(cfg_m.model_config(), dev, seed).train()
            torch.cuda.synchronize()
            reset_launch_counts()
            step_ms, peak, with_copy = train_step_time(dev, model, cfg_m, seed, batch)
            launches, by_form = counted(mode)
            del model
            loss, grads = zero_dropout_step(dev, cfg_m, batch, seed)
            reading = dict(preset=preset, bsz=cfg.bsz, max_v_l=cfg.max_v_l, train_precision=mode,
                           transfer_dtype=wire, step_ms=step_ms,
                           step_rows_per_s=cfg.bsz / step_ms * 1e3, step_with_copy_ms=with_copy,
                           step_peak_mem_bytes=peak, launches=launches,
                           form_launches=by_form, dropout0_total_loss=loss)
            if ref is None:
                assert (mode, wire) == ("float32", "float32")
                ref = (loss, grads)
            else:
                reading["loss_rel_err"] = abs(loss - ref[0]) / abs(ref[0])
                reading["grad_rel_err"] = ((grads - ref[1]).norm() / ref[1].norm()).item()
                assert reading["loss_rel_err"] <= PRECISION_LOSS_RTOL, reading
                in_band(f"{preset} train step", mode, reading["grad_rel_err"],
                        PRECISION_GRAD_BAND)
            del grads
            torch.cuda.empty_cache()
            log(f"[{preset} train step {mode}/{wire}] {json.dumps(reading)}")
            out[f"{mode}/{wire}"] = reading
    return out


def run_precision_cli(dev, seed, n_train=32, n_val=64, bsz=32):
    """Phase 14: the CLI at the flagship's full width at its default train
    precision (bfloat16, as the JAX CLI's): `train` for one epoch (its steps
    on bf16 operands, its eval at the default eval_precision, float32;
    opt.json records bfloat16 and no serving flag), then `infer --serving`
    of its model_latest.ckpt (every launch in 1xTF32) and `infer --serving
    --eval_precision bfloat16` (the explicit flag wins: every launch on bf16
    operands); last `train` at tensorfloat32 with the bf16 wire (its steps
    in 1xTF32), into a results root of its own."""
    import glob

    import torch

    from flashvtg_tpu_torch import cli
    from flashvtg_tpu_torch.train.config import from_preset

    preset = "qvhighlights_slowclip"
    cfg = from_preset(preset, bsz=bsz)
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        cfg = make_train_split(tmp, cfg, n_train, n_val, seed)
        flags = [
            "--device", str(dev), "--seed", str(seed), "--bsz", str(bsz), "--eval_epoch", "1",
            "--train_path", cfg.train_path, "--eval_path", cfg.eval_path,
            "--v_feat_dirs", *cfg.v_feat_dirs, "--t_feat_dir", cfg.t_feat_dir,
            "--results_root", os.path.join(tmp, "results"), "--exp_id", "cli",
            "--use_tensorboard", "false",
        ]
        tf32_root = os.path.join(tmp, "results_tf32")
        # (name, argv, the forms its launches take, the opt.json's train dials)
        calls = (
            ("train", ["train", preset, *flags, "--n_epoch", "1"], ("bf16", "3xtf32"),
             ("bfloat16", "float32")),
            ("infer_serving", ["infer", preset, *flags, "--serving"], ("1xtf32",), None),
            ("infer_serving_bf16", ["infer", preset, *flags, "--serving", "--eval_precision",
                                    "bfloat16"], ("bf16",), None),
            ("train_tf32", ["train", preset, *flags, "--n_epoch", "1", "--train_precision",
                            "tensorfloat32", "--transfer_dtype", "bfloat16", "--results_root",
                            tf32_root], ("1xtf32", "3xtf32"), ("tensorfloat32", "bfloat16")),
        )
        for name, argv, forms, dials in calls:
            if dials is None:  # infer the first train's model_latest.ckpt
                (run_dir,) = glob.glob(os.path.join(tmp, "results", "*"))
                argv += ["--resume", os.path.join(run_dir, "model_latest.ckpt")]
            reset_launch_counts()
            t0 = time.perf_counter()
            assert cli.main(argv) == 0, name
            torch.cuda.synchronize()
            by_form = form_launch_counts()
            n = {form: sum(counts.values()) for form, counts in by_form.items()}
            assert all(n[f] > 0 for f in forms) and sum(n.values()) == sum(
                n[f] for f in forms), (name, forms, by_form)
            res[name] = dict(call_s=time.perf_counter() - t0, forms=forms, form_launches=by_form)
            log(f"[cli {name}] {json.dumps(res[name])}")
            if dials is not None:
                root = tf32_root if name == "train_tf32" else os.path.join(tmp, "results")
                (run_dir,) = glob.glob(os.path.join(root, "*"))
                with open(os.path.join(run_dir, "opt.json")) as f:
                    opt = json.load(f)
                assert (opt["train_precision"], opt["transfer_dtype"]) == dials, opt
                assert "serving" not in opt, opt
    return res


# phase 15: the device-resident feed, the scan epoch, the pipelined eval
FEED_TRAIN = {  # preset: (Lv, Lq, text dim, feed rows, timed steps)
    # 1024 rows of the flagship (0.87 GiB of f32 features, 16 steps of B 64)
    "qvhighlights_slowclip": (75, 32, 512, 1024, 16),
    "tvsum_ms": (1000, 32, 512, 32, 8),  # B 4, Lv 1000
}
SCAN_K = 8  # steps a chunk of the scan epoch
GRAPH_PARAM_RTOL = 1e-6  # modes' parameters after 8 f32 steps at dropout 0, of each leaf's max
GRAPH_LOSS_RTOL = 1e-5  # the graph path's loss vectors against the eager per-step path's


def busy_ms(run):
    """(wall seconds, device-busy microseconds, device_launch_table) of run()
    under torch.profiler."""
    from flashvtg_tpu_torch.tools.profile_eval import profiled

    wall, per_name = profiled(run)
    return wall, sum(us for us, _ in per_name.values()), device_launch_table(per_name)


PROFILED_WINDOWS = 3  # profiled windows a mode may take to show its launches whole


def profiled_steps(run, want):
    """(wall seconds, device-busy microseconds, device_launch_table, the
    windows taken, the wrappers' counts {form: {kernel: n}} in the window
    kept) of run(), train steps under torch.profiler, whose kernel records
    must hold `want` ({form: {kernel: launches}}). The profiler can lose
    kernel records: on the card one window of 8 TACoS steps read 142 and
    another 144 of the 152 backward ACA launches that every other window,
    the wrappers' counts and the graph's own replays held. A window
    whose records differ from `want` is logged and the steps are profiled
    again, up to PROFILED_WINDOWS windows; a mode none of whose windows
    holds its launches fails."""
    tables = []
    for window in range(1, PROFILED_WINDOWS + 1):
        before = form_launch_counts()
        wall, busy_us, table = busy_ms(run)
        counted_in = {f: {k: n - before[f][k] for k, n in c.items()}
                      for f, c in form_launch_counts().items()}
        if all(table[f] == grouped(w) for f, w in want.items()):
            return wall, busy_us, table, window, counted_in
        tables.append(table)
        log(f"[profiler] window {window}: the kernel records differ from a step's launches "
            f"times the steps: {json.dumps(table)}")
    raise AssertionError(("no profiled window holds the launches", want, tables))


def params_of(model):
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def leaf_gap(a, b):
    """The largest |a - b| of any leaf over that leaf's largest |b|."""
    return max(((a[n] - b[n]).abs().max() / b[n].abs().max().clamp_min(1e-30)).item() for n in b)


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN's deterministic algorithms inside: two eager runs of the same
    train step otherwise differ in the convolutions' weight gradients (the
    card read 8-step parameter gaps of 0.1-0.5 of a leaf between two runs
    of one mode), which AdamW carries into every leaf; with them, every
    mode is bit-equal run to run."""
    import torch

    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = saved


def feed_train_modes(dev, preset, seed, **overrides):
    """Phase 15 (a) and (b): ScanHarness (utils/scanbench.py) at the preset's
    full width in three modes (streamed per step, feed per step, feed + scan
    in chunks of SCAN_K graph replays), each on a fresh model from `seed`,
    as a user runs them: ScanHarness.time_scan (one chunk of warm-up: the
    scan's eager warm-up steps and its capture; then the timed steps, wall
    time) and the same number of steps again under torch.profiler
    (device-busy time, idle share), whose kernel records give each
    kernel's launches as the card ran them: a step's times the steps in
    every mode, the wrappers' counts equal to them in the eager modes and 0
    in the replays (the scan's counts are its eager warm-up steps'). Then,
    under deterministic_cudnn,
    the equalities: the graph path's loss vectors against the eager feed
    path's over 2 chunks at the preset's dropout; at float32 and dropout 0,
    one chunk a mode from one init, the parameters leaf by leaf."""
    import dataclasses

    import torch

    from flashvtg_tpu_torch.train.config import from_preset
    from flashvtg_tpu_torch.train.graph import WARMUP_STEPS
    from flashvtg_tpu_torch.utils.runtime import KERNEL_FORMS
    from flashvtg_tpu_torch.utils.scanbench import ScanHarness

    lv, lq, t_dim, rows, steps = FEED_TRAIN[preset]
    cfg = from_preset(preset, use_tensorboard=False, **overrides)
    per_step = train_launches_per_step(cfg)
    form = KERNEL_FORMS[cfg.train_precision]
    out = {"preset": preset, "bsz": cfg.bsz, "max_v_l": lv, "feed_rows": rows,
           "scan_steps": SCAN_K, "train_precision": cfg.train_precision, "dropout": cfg.dropout}
    for mode in ("streamed", "feed", "scan"):
        reset_launch_counts()
        h = ScanHarness(cfg, lv, lq, t_dim, device=dev, n_feed_batches=rows // cfg.bsz,
                        seed=seed)
        reading = {}
        if mode != "streamed":
            h.feed
            reading.update(feed_s=h.feed_s, feed_bytes=h.feed_bytes)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        sps, warm_s, losses = h.time_scan(SCAN_K, steps, mode)
        assert torch.isfinite(losses).all(), mode
        peak = torch.cuda.max_memory_allocated()
        # the profiled steps as the card ran them: every kernel of a step,
        # eager or replayed; the wrappers count the eager launches alone
        want = at_form(form, {k: n * steps for k, n in per_step.items()})
        prof_wall, busy_us, table, windows, counted_in = profiled_steps(
            lambda: h.run(mode, steps, SCAN_K, i0=SCAN_K + steps).cpu(), want)
        if mode == "scan":
            assert not any(n for c in counted_in.values() for n in c.values()), counted_in
        else:
            assert all(table[f] == grouped(counted_in[f]) for f in table), (mode, counted_in)
        wall = steps / sps
        reading.update(
            warmup_chunk_s=warm_s, steps_per_s=sps, wall_ms_per_step=wall * 1e3 / steps,
            device_busy_ms_per_step=busy_us / 1e3 / steps,
            idle_share=1 - busy_us / 1e6 / wall, profiled_wall_ms_per_step=prof_wall * 1e3 / steps,
            peak_mem_bytes=peak, profiled_windows=windows)
        if mode == "scan":
            fs = h.feed_steps(graph=True)
            reading.update(capture_s=fs.capture_s, replays=fs.replays)
            # counted at the wrappers: the eager warm-up steps alone
            launches, by_form = counted(cfg.train_precision)
            assert fs.warm == WARMUP_STEPS and launches == {
                k: n * WARMUP_STEPS for k, n in per_step.items()}, (launches, fs.warm)
            out["launches"], out["form_launches"] = launches, by_form
            out["device_launches"], out["profiled_replays"] = table, steps
        out[mode] = reading
        log(f"[feed train {preset} {mode}] {json.dumps(reading)}")
        del h
        torch.cuda.empty_cache()

    with deterministic_cudnn():
        losses = {}
        for mode in ("feed", "scan"):
            h = ScanHarness(cfg, lv, lq, t_dim, device=dev, n_feed_batches=2, seed=seed)
            losses[mode] = h.run(mode, 2 * SCAN_K, SCAN_K).cpu()
            del h
        gap = ((losses["scan"] - losses["feed"]).abs()
               / losses["feed"].abs().clamp_min(1e-6)).max().item()
        out["scan_vs_feed_loss_rel_gap"] = gap
        assert gap <= GRAPH_LOSS_RTOL, gap

        cfg32 = cfg.replace(train_precision="float32", dropout=0.0, input_dropout=0.0)
        mcfg = dataclasses.replace(cfg32.model_config(), dummy_dropout=0.0)
        params = {}
        for mode in ("streamed", "feed", "scan"):
            h = ScanHarness(cfg32, lv, lq, t_dim, device=dev, n_feed_batches=2, seed=seed,
                            model_config=mcfg)
            h.run(mode, SCAN_K, SCAN_K).cpu()
            params[mode] = params_of(h.model)
            del h
        torch.cuda.empty_cache()
    pairs = (("scan", "feed"), ("feed", "streamed"), ("scan", "streamed"))
    out["f32_param_gap"] = {f"{a}_vs_{b}": leaf_gap(params[a], params[b]) for a, b in pairs}
    out["f32_bit_equal"] = {f"{a}_vs_{b}": all(torch.equal(params[a][n], params[b][n])
                                               for n in params[b]) for a, b in pairs}
    assert max(out["f32_param_gap"].values()) <= GRAPH_PARAM_RTOL, out["f32_param_gap"]
    summary = {k: v for k, v in out.items() if k not in ("streamed", "feed", "scan")}
    log(f"[feed train {preset}] {json.dumps(summary)}")
    return out


def feed_vs_streamed_eval(cfg, model, ds, infer):
    """Phase 15 (c): one eval split through `infer` with the device feed and
    streamed (each warmed up, then timed, then profiled): the outputs bit
    for bit equal (the submissions with and without NMS and the eval
    losses; the HD mAP and saliency rows), one device-to-host fetch a batch
    in both, the queries (videos) a second and the idle share of each."""
    import torch

    from flashvtg_tpu_torch.train.infer import FETCHES

    res, outs = {}, {}
    batches = -(-len(ds) // cfg.eval_bsz)
    for mode in ("on", "off"):
        c = cfg.replace(device_feed=mode)
        infer(c, model, ds)
        assert (getattr(ds, "_device_feed_cache", None) is not None) or mode == "off"
        fetches = FETCHES["d2h"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs[mode] = infer(c, model, ds)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        per_batch = (FETCHES["d2h"] - fetches) / batches
        assert per_batch == 1, (mode, per_batch)
        _, busy_us, _ = busy_ms(lambda: infer(c, model, ds))
        res["feed" if mode == "on" else "streamed"] = dict(
            queries_per_s=len(ds) / wall, wall_s=wall, fetches_per_batch=per_batch,
            device_busy_ms_per_batch=busy_us / 1e3 / batches, idle_share=1 - busy_us / 1e6 / wall)
    on, off = outs["on"], outs["off"]
    if isinstance(on, dict):  # run_hl_inference
        assert on["brief"] == off["brief"], (on["brief"], off["brief"])
        assert list(on["saliency"]) == list(off["saliency"])
        assert all(np.array_equal(on["saliency"][q], off["saliency"][q]) for q in on["saliency"])
    else:
        assert on == off, "eval with the feed differs from the streamed eval"
    res["bit_equal"] = True
    return res


class _Rows:
    """A stand-in split of n rows for the budget gates (nothing is read)."""

    def __init__(self, n):
        self.n = n
        self.cfg = type("DataCfg", (), {"txt_drop_ratio": 0.0})()

    def __len__(self):
        return self.n


def tacos_feed_gate(dev):
    """Phase 15 (d), second part: a TACoS split of 9,790 rows under the
    default budget: its estimate, and "auto" streaming it (the train and the
    eval gate), with nothing built."""
    from flashvtg_tpu_torch.data.feed import estimate_feed_bytes, resident_feed_bytes
    from flashvtg_tpu_torch.train.config import from_preset
    from flashvtg_tpu_torch.train.infer import _maybe_device_feed
    from flashvtg_tpu_torch.train.loop import train_feed

    cfg = from_preset("tacos")
    est = estimate_feed_bytes(9790, cfg.max_v_l, cfg.total_v_feat_dim, cfg.max_q_l,
                              cfg.t_feat_dim, 2 if cfg.transfer_dtype == "bfloat16" else 4)
    before = resident_feed_bytes()
    assert cfg.device_feed == "auto" and est > cfg.device_feed_budget_gb * 2**30
    assert train_feed(cfg, _Rows(9790), None, dev) is None
    assert _maybe_device_feed(cfg, _Rows(9790), cfg.max_v_l, dev) is None
    assert resident_feed_bytes() == before
    return dict(rows=9790, estimate_bytes=est, budget_gb=cfg.device_feed_budget_gb,
                auto_streams=True)


def run_cli_feed(dev, seed, n_train=128, n_val=64, epochs=2, bsz=32, scan=4,
                 device_feed="on"):
    """Phase 15 (d): the CLI's `train` with --device_feed on --scan_steps 4
    at the flagship's full width and its default dials (4 steps an epoch:
    two eager warm-up steps and the capture in the first chunk, replays
    after), in a fresh process as a user starts it (nothing of this one
    warmed: the forward's device constants, the kernels' libraries, cuBLAS),
    then `infer` on its model_best.ckpt in this one: the best epoch's brief
    metrics equal infer's; the infer's launches, one eval's. Phase 16 (c):
    the same with --device_feed off and the default scan_steps (`scan`
    None): the streamed epoch, each step after two eager warm-up steps a
    replay, each batch copied ahead from pinned memory."""
    import glob

    import torch

    from flashvtg_tpu_torch import cli
    from flashvtg_tpu_torch.train.config import from_preset

    preset = "qvhighlights_slowclip"
    cfg = from_preset(preset, bsz=bsz)
    with tempfile.TemporaryDirectory() as tmp:
        cfg = make_train_split(tmp, cfg, n_train, n_val, seed)
        flags = [
            "--device", str(dev), "--seed", str(seed), "--bsz", str(bsz), "--eval_epoch", "1",
            "--train_path", cfg.train_path, "--eval_path", cfg.eval_path,
            "--v_feat_dirs", *cfg.v_feat_dirs, "--t_feat_dir", cfg.t_feat_dir,
            "--results_root", os.path.join(tmp, "results"), "--exp_id", "feed",
            "--use_tensorboard", "false",
        ]
        t0 = time.perf_counter()
        done = subprocess.run(
            [sys.executable, "-m", "flashvtg_tpu_torch.cli", "train", preset, *flags,
             "--n_epoch", str(epochs), "--device_feed", device_feed,
             *(["--scan_steps", str(scan)] if scan else [])],
            cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True, text=True,
            timeout=600,
        )
        train_s = time.perf_counter() - t0
        assert done.returncode == 0, done.stderr[-4000:]
        (run_dir,) = glob.glob(os.path.join(tmp, "results", "*"))
        with open(os.path.join(run_dir, "opt.json")) as f:
            opt = json.load(f)
        assert (opt["train_precision"], opt["device_feed"], opt["scan_steps"]) == (
            cfg.train_precision, device_feed, scan or cfg.scan_steps), opt
        losses, evals = read_train_run(run_dir)
        assert len(losses) == epochs * (n_train // bsz)
        assert all(np.isfinite(v) for h in losses for v in h.values())
        best = os.path.join(run_dir, "model_best.ckpt")
        best_epoch = torch.load(best, map_location="cpu", weights_only=False)["epoch"]
        best_brief = dict(evals)[best_epoch]["brief"]
        reset_launch_counts()
        t0 = time.perf_counter()
        assert cli.main(["infer", preset, *flags, "--resume", best]) == 0
        infer_s = time.perf_counter() - t0
        launches, by_form = counted(cfg.eval_precision)
        with open(os.path.join(run_dir, f"infer_{cfg.dset_name}_val_preds_metrics.json")) as f:
            infer_brief = json.load(f)["brief"]
        assert infer_brief == best_brief, (infer_brief, best_brief)
        want = eval_launches(cfg)
        assert all(launches[k] == want.get(k, 0) for k in launches), (launches, want)
    return dict(preset=preset, bsz=bsz, train_rows=n_train, epochs=epochs,
                scan_steps=scan or cfg.scan_steps, device_feed=device_feed,
                train_precision=cfg.train_precision, train_subprocess_s=train_s,
                infer_s=infer_s, best_epoch=best_epoch, best_brief=best_brief,
                launches=launches, form_launches=by_form, losses_last=losses[-1])


# phase 16: the streamed train step as the JAX loop runs it
STREAMED_TRAIN = {  # preset: {dial: timed steps}
    "tacos": {"bfloat16": 8, "float32": 4},  # B 32, Lv 2048: the headline streamed split
    "qvhighlights_slowclip": {"bfloat16": 8},  # B 64: the host-bound case
}
STREAMED_K = 4  # the warm-up chunk: two eager warm-up steps, the capture, one replay
STREAMED_SYNTHETIC_BATCHES = 4  # host batches of the flagship's synthetic features


def streamed_gap(a, b):
    """The largest |a - b| of two loss buffers over |b| (floored at 1e-6)."""
    return ((a - b).abs() / b.abs().clamp_min(1e-6)).max().item()


def streamed_train_modes(dev, preset, seed, source=None):
    """Phase 16 (a) and (b): the streamed train step at the preset's full
    width through utils/scanbench.py in its three streamed modes (the
    blocking per-step copy; the copy ahead on a copy stream, eager steps;
    the copy ahead with each step a graph replay), at each of the preset's
    STREAMED_TRAIN dials, each on a fresh model from `seed`, its batches
    from `source` (a SplitSource: phase 8's TACoS split) or the harness's
    synthetic features: as phase 15 times its modes (time_scan after a
    warm-up chunk of STREAMED_K steps, then as many steps again under
    torch.profiler), steps/s, wall and device-busy ms a step, the idle
    share, peak memory, the capture's seconds and the step's utilisation
    at its wall time; each mode's launches as the card ran them, a step's
    times the steps, the wrappers' counts equal to them in the eager modes
    and 0 in the replays. Then, under deterministic_cudnn, at each dial the
    loss vectors of 2 chunks at the preset's dropout: the graph's against
    the copy-ahead eager mode's, and those against the blocking mode's,
    within GRAPH_LOSS_RTOL; at float32 these 8 steps run with every dropout
    at 0, and the parameters after them lie within GRAPH_PARAM_RTOL across
    the three modes. Bit-equality is reported beside each."""
    import dataclasses

    import torch

    from flashvtg_tpu_torch.train.config import from_preset
    from flashvtg_tpu_torch.train.graph import WARMUP_STEPS
    from flashvtg_tpu_torch.utils.flops import step_mfu
    from flashvtg_tpu_torch.utils.runtime import KERNEL_FORMS
    from flashvtg_tpu_torch.utils.scanbench import STREAMED_MODES, ScanHarness

    dials = STREAMED_TRAIN[preset]
    base = from_preset(preset, use_tensorboard=False)
    lv, lq, t_dim = base.max_v_l, base.max_q_l, base.t_feat_dim
    per_step = train_launches_per_step(base)
    out = {"preset": preset, "bsz": base.bsz, "max_v_l": lv, "dropout": base.dropout,
           "batches": "split" if source is not None else "synthetic", "timed_steps": dials,
           "warmup_chunk": STREAMED_K, "dials": {}}

    def harness(cfg, **kw):
        return ScanHarness(cfg, lv, lq, t_dim, device=dev, seed=seed, source=source,
                           n_feed_batches=STREAMED_SYNTHETIC_BATCHES, **kw)

    for dial, steps in dials.items():
        cfg = base.replace(train_precision=dial)
        form = KERNEL_FORMS[dial]
        res = {"train_precision": dial, "transfer_dtype": cfg.transfer_dtype}
        for mode in STREAMED_MODES:
            reset_launch_counts()
            h = harness(cfg)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            sps, warm_s, losses = h.time_scan(STREAMED_K, steps, mode)
            assert torch.isfinite(losses).all(), (preset, dial, mode)
            peak = torch.cuda.max_memory_allocated()
            want = at_form(form, {k: n * steps for k, n in per_step.items()})
            prof_wall, busy_us, table, windows, counted_in = profiled_steps(
                lambda: h.run(mode, steps, STREAMED_K, i0=STREAMED_K + steps).cpu(), want)
            graph = mode == "streamed_graph"
            if graph:
                assert not any(n for c in counted_in.values() for n in c.values()), counted_in
            else:
                assert all(table[f] == grouped(counted_in[f]) for f in table), (mode, counted_in)
            wall = steps / sps
            reading = dict(
                warmup_chunk_s=warm_s, steps_per_s=sps, wall_ms_per_step=wall * 1e3 / steps,
                device_busy_ms_per_step=busy_us / 1e3 / steps,
                idle_share=1 - busy_us / 1e6 / wall,
                profiled_wall_ms_per_step=prof_wall * 1e3 / steps, peak_mem_bytes=peak,
                profiled_windows=windows, **step_mfu(cfg, cfg.bsz, wall / steps, dial, train=True))
            if graph:
                ss = h.streamed_steps(graph=True)
                reading.update(capture_s=ss.capture_s, replays=ss.replays)
                # counted at the wrappers: the eager warm-up steps alone
                launches, by_form = counted(dial)
                assert ss.warm == WARMUP_STEPS and launches == {
                    k: n * WARMUP_STEPS for k, n in per_step.items()}, (launches, ss.warm)
                res.update(launches=launches, form_launches=by_form, device_launches=table,
                           profiled_replays=steps)
            res[mode] = reading
            log(f"[streamed train {preset} {dial} {mode}] {json.dumps(reading)}")
            del h
            torch.cuda.empty_cache()

        # the equalities: at float32 with every dropout at 0, whose 8 steps
        # also give the parameters; else at the preset's dropout
        f32 = dial == "float32"
        cfg_eq, mcfg = cfg, None
        if f32:
            cfg_eq = cfg.replace(dropout=0.0, input_dropout=0.0)
            mcfg = dataclasses.replace(cfg_eq.model_config(), dummy_dropout=0.0)
        losses, params = {}, {}
        with deterministic_cudnn():
            for mode in STREAMED_MODES:
                h = harness(cfg_eq, model_config=mcfg)
                losses[mode] = h.run(mode, 2 * STREAMED_K, STREAMED_K).cpu()
                params[mode] = params_of(h.model) if f32 else None
                del h
                torch.cuda.empty_cache()
        pairs = (("streamed_graph", "streamed_ahead"), ("streamed_ahead", "streamed"))
        res["loss_dropout"] = cfg_eq.dropout
        res["loss_rel_gap"] = {f"{a}_vs_{b}": streamed_gap(losses[a], losses[b])
                               for a, b in pairs}
        res["loss_bit_equal"] = {f"{a}_vs_{b}": torch.equal(losses[a], losses[b])
                                 for a, b in pairs}
        assert max(res["loss_rel_gap"].values()) <= GRAPH_LOSS_RTOL, res["loss_rel_gap"]
        if f32:
            pairs += (("streamed_graph", "streamed"),)
            out["f32_param_gap"] = {f"{a}_vs_{b}": leaf_gap(params[a], params[b])
                                    for a, b in pairs}
            out["f32_bit_equal"] = {f"{a}_vs_{b}": all(
                torch.equal(params[a][n], params[b][n]) for n in params[b]) for a, b in pairs}
            assert max(out["f32_param_gap"].values()) <= GRAPH_PARAM_RTOL, out["f32_param_gap"]
        out["dials"][dial] = res
    summary = {k: v for k, v in out.items() if k != "dials"}
    summary.update({d: {k: v for k, v in r.items() if k.startswith("loss_")}
                    for d, r in out["dials"].items()})
    log(f"[streamed train {preset}] {json.dumps(summary)}")
    return out


def poison_first_row(cfg):
    """One clip of the features of cfg.train_path's first row set to NaN."""
    with open(cfg.train_path) as f:
        vid = json.loads(f.readline())["vid"]
    path = os.path.join(cfg.v_feat_dirs[0], f"{vid}.npz")
    with np.load(path) as z:
        arrays = dict(z)
    key = "features" if "features" in arrays else next(iter(arrays))
    arrays[key][min(3, len(arrays[key]) - 1)] = np.nan
    np.savez(path, **arrays)


def trace_launch_table(log_dir):
    """device_launch_table of the kernel records in the one torch.profiler
    trace under log_dir, and the kernels' names."""
    import glob

    (trace,) = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    per_name = {}
    for e in events:
        if e.get("cat") == "kernel":
            per_name.setdefault(e["name"], [0.0, 0])[1] += 1
    return device_launch_table(per_name), sorted(per_name), os.path.getsize(trace)


def streamed_train_runs(dev, seed, tacos_split):
    """Phase 16 (c) and (d) through train(): (c) on the TACoS split with
    device_feed off, 2 epochs of 3 steps at the default bfloat16 dial and
    profile_dir set: the wrappers count the two eager warm-up steps and the
    eval alone, so every other step was a replay; the trace of the first
    epoch names the port's kernels and holds each kernel's launches of its
    3 steps (two eager, one replay); (d) on a flagship split of 128 rows
    (4 steps of 32): train() with debug_nans gives the loss vectors of the
    run without it (a graph run, under deterministic_cudnn), and on the
    same split with one NaN feature clip raises FloatingPointError (or
    anomaly mode's RuntimeError)."""
    import torch

    from flashvtg_tpu_torch.train.config import from_preset
    from flashvtg_tpu_torch.train.graph import WARMUP_STEPS
    from flashvtg_tpu_torch.train.loop import epoch_mode, train
    from flashvtg_tpu_torch.utils.runtime import KERNEL_FORMS

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        cfg = tacos_split.replace(device_feed="off", n_epoch=2, eval_epoch=2,
                                  use_tensorboard=False, profile_dir=os.path.join(tmp, "prof"))
        n_rows = jsonl_rows(cfg.train_path)
        per_epoch = n_rows // cfg.bsz
        assert epoch_mode(cfg, dev, n_rows).graph and per_epoch > WARMUP_STEPS
        reset_launch_counts()
        t0 = time.perf_counter()
        with deterministic_cudnn():
            _, _, run_dir = train(cfg, os.path.join(tmp, "run"), dev)
        train_s = time.perf_counter() - t0
        by_form = form_launch_counts()
        losses, evals = read_train_run(run_dir)
        assert len(losses) == 2 * per_epoch and len(evals) == 1, (len(losses), len(evals))
        assert all(np.isfinite(v) for h in losses for v in h.values())
        per_step, per_eval = train_launches_per_step(cfg), eval_launches(cfg)
        eval_batches = -(-jsonl_rows(cfg.eval_path) // cfg.eval_bsz)
        # the steps at the train dial's form, the eval at the eval dial's
        want = add_tables(
            at_form(KERNEL_FORMS[cfg.train_precision],
                    {k: n * WARMUP_STEPS for k, n in per_step.items()}),
            at_form(KERNEL_FORMS[cfg.eval_precision],
                    {k: per_eval.get(k, 0) * eval_batches for k in per_step}))
        assert by_form == want, (by_form, want)
        table, names, trace_bytes = trace_launch_table(cfg.profile_dir)
        first_epoch = at_form(KERNEL_FORMS[cfg.train_precision],
                              {k: n * per_epoch for k, n in per_step.items()})
        assert all(table[f] == grouped(w) for f, w in first_epoch.items()), table
        for kernel in ("aca_attention_kernel", "aca_attention_bwd_kernel",
                       "flash_attention_kernel", "flash_bwd_dq_kernel"):
            assert any(kernel in n for n in names), kernel
        out["tacos_train"] = dict(
            rows=n_rows, steps=len(losses), replays=len(losses) - WARMUP_STEPS,
            train_s=train_s, form_launches=by_form,
            trace_bytes=trace_bytes, trace_device_launches=table,
            trace_kernels=[n for n in names if "attention" in n or "flash" in n][:8],
            losses_last=losses[-1], brief=evals[0][1]["brief"])
        log(f"[streamed train() tacos] {json.dumps(out['tacos_train'])}")

        preset = "qvhighlights_slowclip"
        flag = make_train_split(os.path.join(tmp, "flag"),
                                from_preset(preset, bsz=32, use_tensorboard=False,
                                            device_feed="off", n_epoch=1),
                                128, 32, seed)
        runs = {}
        with deterministic_cudnn():
            for name, debug_nans in (("plain", False), ("debug_nans", True)):
                _, _, run_dir = train(flag.replace(debug_nans=debug_nans),
                                      os.path.join(tmp, name), dev)
                runs[name] = read_train_run(run_dir)[0]
        assert len(runs["plain"]) == 4
        gap = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-6)
                  for a, b in zip(runs["debug_nans"], runs["plain"]) for k in b)
        assert gap <= GRAPH_LOSS_RTOL, gap
        assert not torch.is_anomaly_enabled()
        poison_first_row(flag)
        t0 = time.perf_counter()
        try:
            train(flag.replace(debug_nans=True), os.path.join(tmp, "nan"), dev)
            raised = None
        except (FloatingPointError, RuntimeError) as e:
            raised = f"{type(e).__name__}: {str(e)[:200]}"
        assert raised is not None, "debug_nans did not raise on a NaN feature row"
        assert not torch.is_anomaly_enabled()
        out["debug_nans"] = dict(
            preset=preset, rows=128, steps=len(runs["plain"]), clean_loss_rel_gap=gap,
            clean_bit_equal=runs["debug_nans"] == runs["plain"], raised=raised,
            raise_s=time.perf_counter() - t0)
        log(f"[debug_nans] {json.dumps(out['debug_nans'])}")
    return out


def jsonl_rows(path):
    """The rows of an annotation file (a jsonl)."""
    with open(path) as f:
        return sum(1 for line in f if line.strip())


def utilisation(dev, paths, streamed):
    """Phase 16 (e): tools/matmul_ceiling.py's readings on this card, and
    the utilisation (utils/flops.py) of the flagship eval (phase 4's
    queries a second end to end, its device step's, and phase 15's with the
    feed) and of the flagship and TACoS train steps (phase 16's three modes
    at each dial, and phase 15's flagship modes), each against the bf16
    peak (`mfu`) and its
    dial's measured ceiling (`mfu_effective`, also against the ceilings of
    this run)."""
    from flashvtg_tpu_torch.tools.matmul_ceiling import measure
    from flashvtg_tpu_torch.train.config import from_preset
    from flashvtg_tpu_torch.utils.scanbench import STREAMED_MODES
    from flashvtg_tpu_torch.utils.flops import (
        H100_PEAK_TFLOPS,
        MEASURED_SKELETON_TFLOPS,
        MEASURED_TRAIN_SKELETON_TFLOPS,
        mfu,
        model_flops,
    )

    t0 = time.perf_counter()
    ceilings = measure(dev)
    ceilings["seconds"] = time.perf_counter() - t0
    log(f"[matmul ceiling] {json.dumps(ceilings)}")
    measured = {
        "eval": {d: ceilings["skeleton"][d]["tflops"] for d in PRECISION_MODES},
        "train": {d: ceilings["skeleton_train"][d]["tflops"] for d in PRECISION_MODES},
    }
    for kind, table in measured.items():
        for dial, tflops in table.items():
            assert 0 < tflops <= H100_PEAK_TFLOPS[dial], (kind, dial, tflops)

    def util(flops, seconds, dial, train):
        got = mfu(flops, seconds, dial, ceilings=MEASURED_TRAIN_SKELETON_TFLOPS if train
                  else None)
        got["mfu_effective_this_run"] = got["achieved_tflops"] / measured[
            "train" if train else "eval"][dial]
        return got

    flag = from_preset("qvhighlights_slowclip")
    per_query = model_flops(flag.model_config(), 1, flag.max_q_l, flag.max_v_l)["fwd"]
    rows = {}
    p4 = paths["flagship"]  # phase 4
    feed = p4["feed_vs_streamed"]["feed"]["queries_per_s"]
    for name, qps in (("infer", p4["infer_qps"]), ("step", p4["step_qps"]), ("feed", feed)):
        rows[f"flagship_eval_{name}"] = dict(
            precision=p4["eval_precision"], qps=qps,
            **util(per_query * qps, 1.0, p4["eval_precision"], False))
    def train_rows(preset, tag, dial, readings):
        cfg = from_preset(preset)
        step = model_flops(cfg.model_config(), cfg.bsz, cfg.max_q_l, cfg.max_v_l,
                           train=True)["fwd_bwd"]
        for mode, r in readings.items():
            ms = r["wall_ms_per_step"]
            rows[f"{preset}_{tag}_{mode}_{dial}"] = dict(
                precision=dial, bsz=cfg.bsz, step_ms=ms, **util(step, ms / 1e3, dial, True))

    for preset, res in streamed.items():
        for dial, r in res["dials"].items():
            train_rows(preset, "train", dial, {m: r[m] for m in STREAMED_MODES})
    p15 = paths["feed_train_flagship"]  # phase 15 (a)
    train_rows("qvhighlights_slowclip", "feed_train", p15["train_precision"],
               {m: p15[m] for m in ("streamed", "feed", "scan")})
    out = {"ceilings": ceilings, "measured_tflops": measured,
           "committed_tflops": {"eval": MEASURED_SKELETON_TFLOPS,
                                "train": MEASURED_TRAIN_SKELETON_TFLOPS},
           "rows": rows}
    log(f"[utilisation] {json.dumps(rows)}")
    return out


def run_phase16(dev, seed, paths):
    """Phase 16 in order, its paths added to `paths` (their launches go into
    the kernels line); returns (the streamed modes' readings by preset,
    streamed_train_runs's, utilisation's)."""
    from flashvtg_tpu_torch.train.config import from_preset
    from flashvtg_tpu_torch.utils.scanbench import SplitSource

    streamed = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        # phase 8's TACoS split: 3 steps of B 32 and one eval batch
        tacos = make_train_split(tmp, from_preset("tacos", use_tensorboard=False), 96, 8,
                                 seed)
        source = SplitSource(tacos)
        log(f"[streamed data] {time.perf_counter() - t0:.2f} s")
        streamed_phases = {
            "tacos": lambda: streamed_train_modes(dev, "tacos", seed, source),
            "qvhighlights_slowclip": lambda: streamed_train_modes(
                dev, "qvhighlights_slowclip", seed),
        }
        for preset, run in streamed_phases.items():
            t0 = time.perf_counter()
            streamed[preset] = run()
            log(f"[streamed_train_{preset}] {time.perf_counter() - t0:.2f} s")
            for dial, res in streamed[preset]["dials"].items():
                paths[f"streamed_train_{preset}/{dial}"] = res
        del source
        t0 = time.perf_counter()
        runs = streamed_train_runs(dev, seed, tacos)
        log(f"[streamed_train_runs] {time.perf_counter() - t0:.2f} s")
    paths["streamed_train_run_tacos"] = runs["tacos_train"]
    t0 = time.perf_counter()
    paths["streamed_cli"] = run_cli_feed(dev, seed, device_feed="off", scan=None)
    paths["streamed_cli"]["wall_s"] = time.perf_counter() - t0
    log(f"[streamed_cli] {paths['streamed_cli']['wall_s']:.2f} s")
    t0 = time.perf_counter()
    util = utilisation(dev, paths, streamed)
    log(f"[utilisation] {time.perf_counter() - t0:.2f} s")
    return streamed, runs, util


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--queries", type=int, default=512)
    ap.add_argument("--tacos-queries", type=int, default=64)
    ap.add_argument("--train-steps", type=int, default=3)
    ap.add_argument("--hd-queries", type=int, default=64)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: CUDA is not available; this script runs on the card only")
        return 2

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    from flashvtg_tpu_torch import kernels
    from flashvtg_tpu_torch.utils.runtime import resolve_device

    dev = resolve_device("cuda")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    reports = kernels.build_all()
    for name in kernels.SOURCES:
        kernels.load(name)
        log(f"[build] {name}:\n{reports[name]}")
    log(f"[build] {time.perf_counter() - t0:.2f} s")
    hmma = {name: kernels.sass_mma_counts(name) for name in kernels.SOURCES}
    log(f"[build] tensor-core instructions (SASS HMMA lines) per kernel: {json.dumps(hmma)}")
    for name in kernels.SOURCES:  # every product on mma.sync
        for fn, n in hmma[name].items():
            # the flash pre-pass D = rowsum(dO O) and the ACA backward's sum of
            # its chunks' partial dk and dv have no product
            if "delta" not in fn and "reduce" not in fn:
                assert n > 0, f"{fn}: no tensor-core instruction"
    # every kernel with a product in each form, summed over its instances:
    # one TF32 product a dot in the 1xTF32 and bf16 forms, three in 3xTF32
    hmma_forms = {k: v for name in kernels.SOURCES
                  for k, v in kernels.hmma_by_form(hmma[name]).items()}
    log(f"[build] SASS HMMA lines per kernel and form: {json.dumps(hmma_forms)}")
    assert len(hmma_forms) == 5, hmma_forms
    for fn, per in hmma_forms.items():
        assert 0 < per["1xtf32"] < per["3xtf32"] and 0 < per["bf16"] < per["3xtf32"], (fn, per)

    rows, shapes = phase_kernels(dev, args.seed)
    log(f"[kernels] {json.dumps(rows)}")
    shapes.update(phase_slice_kernels(dev, args.seed))

    train_rows, train_shapes = phase_train_kernels(dev, args.seed)
    log(f"[train kernels] {json.dumps(train_rows)} {json.dumps(train_shapes)}")
    rows += train_rows
    shapes.update(train_shapes)

    phases = {
        "flagship": lambda: run_preset(dev, "qvhighlights_slowclip", args.queries, 8,
                                       args.seed, feed_compare=True),
        "tacos": lambda: run_preset(dev, "tacos", args.tacos_queries, 2, args.seed),
        "flagship_train": lambda: run_train_preset(dev, "qvhighlights_slowclip",
                                                   args.train_steps, args.seed),
        "tacos_train": lambda: run_train_preset(dev, "tacos", args.train_steps, args.seed),
        "hd_youtube_eval": lambda: run_preset(dev, "youtube_uni", args.hd_queries, 2,
                                              args.seed, feed_compare=True, dset_domain="dog"),
        "hd_tvsum_eval": lambda: run_preset(dev, "tvsum", 8, 2, args.seed, dset_domain="BK"),
        # TVSum's own split of a domain: 4 train videos and 1 val video
        "tvsum_train": lambda: run_train_preset(dev, "tvsum", args.train_steps, args.seed,
                                                n_train=4, n_val=1, dset_domain="BK"),
        "charades_eval": lambda: run_preset(dev, "charades", 256, 2, args.seed),
        "charades_vgg_eval": lambda: run_preset(dev, "charades_vgg", 32, 2, args.seed),
        "cli": lambda: run_cli(dev, args.seed),
        # phase 13: the FlashVTG_ms variant
        "ms_hd_youtube_eval": lambda: run_preset(dev, "youtube_uni_ms", args.hd_queries, 2,
                                                 args.seed, dset_domain="dog"),
        "ms_hd_tvsum_eval": lambda: run_preset(dev, "tvsum_ms", 8, 2, args.seed,
                                               dset_domain="BK"),
        "ms_tvsum_train": lambda: run_train_preset(dev, "tvsum_ms", args.train_steps, args.seed,
                                                   n_train=4, n_val=1, dset_domain="BK"),
        "ms_mr_dfl_eos_eval": lambda: run_ms_mr_eval(dev, args.queries, 8, args.seed),
    }
    paths = {}
    for name, run in phases.items():  # each path with its wall time
        t0 = time.perf_counter()
        paths[name] = run()
        paths[name]["wall_s"] = time.perf_counter() - t0
        log(f"[{name}] {paths[name]['wall_s']:.2f} s")

    # phase 14: the precision dials. Every kernel at the 1xTF32 and bf16
    # forms against its plain version at the same form, at every shape of
    # phases 3 and 7; then the paths at tensorfloat32 and bfloat16, each
    # against the card's own float32 run
    t0 = time.perf_counter()
    for form in ("1xtf32", "bf16"):
        form_rows, form_shapes = phase_kernels(dev, args.seed, form)
        form_shapes.update(phase_slice_kernels(dev, args.seed, form))
        bwd_rows, bwd_shapes = phase_train_kernels(dev, args.seed, form)
        form_shapes.update(bwd_shapes)
        log(f"[precision kernels {form}] {json.dumps(form_rows + bwd_rows)} "
            f"{json.dumps(form_shapes)}")
        rows += form_rows + bwd_rows
        shapes.update(form_shapes)
    form_identity = phase_form_identity(dev, args.seed)
    log(f"[precision form identity] {json.dumps(form_identity)}")
    log(f"[precision kernels] {time.perf_counter() - t0:.2f} s")
    precision_phases = {
        "flagship_eval": lambda: run_precision_eval(dev, "qvhighlights_slowclip", args.queries,
                                                    args.seed),
        "tacos_eval": lambda: run_precision_eval(dev, "tacos", args.tacos_queries, args.seed),
        "hd_youtube_eval": lambda: run_precision_eval(dev, "youtube_uni", args.hd_queries,
                                                      args.seed, dset_domain="dog"),
        "tacos_train_step": lambda: run_precision_train(
            dev, "tacos", args.seed, [(m, "float32") for m in PRECISION_MODES]
            + [("bfloat16", "bfloat16")]),
        "ms_tvsum_train_step": lambda: run_precision_train(
            dev, "tvsum_ms", args.seed, [(m, "float32") for m in PRECISION_MODES], n_rows=4,
            dset_domain="BK"),
        "tvsum_train": lambda: {mode: run_train_preset(
            dev, "tvsum", 1, args.seed, n_train=4, n_val=1, dset_domain="BK",
            train_precision=mode, eval_precision=mode, transfer_dtype=wire)
            for mode, wire in (("tensorfloat32", "float32"), ("bfloat16", "bfloat16"))},
        "cli": lambda: run_precision_cli(dev, args.seed),
    }
    precision = {}
    for name, run in precision_phases.items():
        t0 = time.perf_counter()
        precision[name] = run()
        precision[name]["wall_s"] = time.perf_counter() - t0
        log(f"[precision {name}] {precision[name]['wall_s']:.2f} s")
        for mode, p in precision[name].items():
            if isinstance(p, dict):
                paths[f"precision_{name}/{mode}"] = p
    # every dial restored the flags: outside them the card stays in true f32
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32

    # phase 15: the device feed and the scan epoch's graph replays (the
    # eval's feed against streamed ran with phases 4 and 9)
    feed_phases = {
        "feed_train_flagship": lambda: feed_train_modes(dev, "qvhighlights_slowclip",
                                                        args.seed),
        "feed_train_tvsum_ms": lambda: feed_train_modes(dev, "tvsum_ms", args.seed),
        "feed_cli": lambda: {**run_cli_feed(dev, args.seed),
                             "tacos_gate": tacos_feed_gate(dev)},
    }
    for name, run in feed_phases.items():
        t0 = time.perf_counter()
        paths[name] = run()
        paths[name]["wall_s"] = time.perf_counter() - t0
        log(f"[{name}] {paths[name]['wall_s']:.2f} s")

    streamed, runs, util = run_phase16(dev, args.seed, paths)

    for row in rows:  # the largest errors over every shape of the kernel and form
        for key in ("max_abs_err", "max_rel_err"):
            row[key] = max([row[key]] + [
                r[key] for r in shapes.values()
                if r.get("kernel") == row["kernel"] and r.get("form") == row["form"]])
        by_path = {name: p["form_launches"][row["form"]][row["kernel"]]
                   for name, p in paths.items() if "form_launches" in p}
        row["launches"] = sum(by_path.values())
        row["launches_by_path"] = {k: v for k, v in by_path.items() if v}
        assert row["launches"] > 0, f"{row['name']} never launched on the paths"
        # the train paths' launches as the card ran them (graph replays
        # included), read from the profiler's kernel records
        row["device_function"] = group_of(row["kernel"])
        row["device_launches"] = sum(p["device_launches"][row["form"]][row["device_function"]]
                                     for p in paths.values() if "device_launches" in p)
    keys = ("name", "form", "route", "source", "replaces", "launches", "max_abs_err",
            "max_rel_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape",
            "launches_by_path", "device_function", "device_launches")
    print(json.dumps({"paths": paths, "kernel_shapes": shapes, "sass_hmma": hmma,
                      "sass_hmma_by_form": hmma_forms, "form_identity": form_identity,
                      "streamed_train": {p: {k: v for k, v in r.items() if k != "dials"}
                                         for p, r in streamed.items()},
                      "debug_nans": runs["debug_nans"], "utilisation": util}))
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
