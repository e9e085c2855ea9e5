#!/usr/bin/env python3
"""Smoke run of the PyTorch port (flashvtg_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--seed 0] [--queries 512] [--tacos-queries 64]
                          [--train-steps 3] [--hd-queries 64]

Phases, each failing loudly:
  1. device: prints the card's name and power limit, requires CUDA, sets
     float32 without TF32 for matmuls and cuDNN;
  2. build: compiles every CUDA kernel of the port from its sources, one
     nvcc per source, all at once, and counts each kernel's tensor-core
     instructions in its SASS (cuobjdump): every kernel that takes a dot
     product (3xTF32 on mma.sync) must have some, all but the flash
     backward's D pre-pass and the ACA backward's chunk-sum pass;
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
     (B=16, Lv 2048, 90-270 clips valid) eval shapes;
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
     head-mean gradient; dropout 0.1 on both sides with one seed. Each
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
     value): train() on a synthetic train split for --train-steps steps and
     one eval through run_mr_inference, each kernel's launch count, set to
     0 just before, equal to its launches per step times the steps plus the
     eval's; finite losses; a step timed with CUDA events; the step's peak
     memory (< 80 GB); then card vs CPU on one 2-row step with every
     dropout at 0: losses within rtol 1e-4; clipped gradients leaf by
     leaf within 1e-3 of the leaf's largest |gradient| (floored at 1e-2 of
     the largest over all leaves); the AdamW update within 1% of lr where
     the gradient's sign is sure (|g| over 100 times the leaf's gradient
     disagreement: a first Adam step moves a weight by about lr sign(g),
     so elsewhere it carries no information);
  9. HD eval: youtube_uni at full width and depth (Lv 1000, 2 ACA, 2 short
     and 3 flash launches a batch of 4) over --hd-queries synthetic videos
     of one domain through run_hl_inference (the saliency-only forward and
     the domain's mAP, which must lie in [0, 1]), launch counts as in phase
     4, the step's time and its peak memory above its inputs; then tvsum on
     8 videos of one domain in the rgb + opt layout; card vs CPU on 2
     videos each, as in phase 5;
 10. TVSum train: train() on one synthetic domain of 4 train videos and 1
     val video (B=4, one step an epoch, Lv 1000, every dropout at its
     preset value) for --train-steps steps, then its HD eval, checked as in
     phase 8, card vs CPU included;
 11. Charades-STA MR eval: charades (Lv 256, eval_bsz 128) over 256 and
     charades_vgg (Lv 2048, eval_bsz 16, 300-d GloVe text from a vocabulary
     file the phase writes and points FLASHVTG_GLOVE_PATH at) over 32
     synthetic queries, through
     run_mr_inference and eval_submission as in phase 4, card vs CPU on 2
     queries each.
The synthetic HD and Charades length mixes are guesses (utils/synthetic.py).
Then one line {"kernels": [...]} and, last, {"ok": true, "device": {...}}.
Exits non-zero, printing no result, without CUDA or without the package.
"""

import argparse
import functools
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

F32_PEAK = 67e12  # H100 SXM float32 outside the tensor cores, FLOP/s
# f32-accurate dot products on the tensor cores: the H100 SXM data sheet's
# dense TF32 rate, 495 TFLOP/s, over the three TF32 products of 3xTF32
TF32X3_PEAK = 495e12 / 3
HBM_RATE = 3.35e12  # H100 SXM device memory, bytes/s
KERNEL_ATOL = 1e-5
FORWARD_ATOL = 3e-4
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
                    pairs=None):
    """(bound_ms, bound_by) for one attention kernel call, the same for the
    same work whatever implements it: each input read once and each output
    written once over the memory rate, against the operations this data
    needs, dot products at the f32-accurate tensor-core rate (3xTF32) and
    the rest at the f32 peak. A masked key's probability is 0, so it needs
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
    t_ops = max(dots / TF32X3_PEAK, other / F32_PEAK)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def ragged_mask(rng, b, n, lo, hi, always=0):
    """(b, n) float32 mask: `always` leading ones, then a valid prefix of
    [lo, hi) more positions per row."""
    import torch

    lens = always + rng.integers(lo, hi, b)
    return torch.from_numpy((np.arange(n)[None] < lens[:, None]).astype(np.float32))


def phase_kernels(dev, seed):
    """Phase 3: each kernel against its plain version, timed beside its
    bound. Returns the rows of the kernels line and the other shapes'
    readings, which are logged."""
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
    out, hm = aca.aca_attention(q, k, v, valid, heads, nd)
    ref_out, ref_hm = aca.aca_attention_plain(q, k, v, valid, heads, nd)
    torch.cuda.synchronize()
    err = max((out - ref_out).abs().max().item(), (hm - ref_hm).abs().max().item())
    if not err <= KERNEL_ATOL:
        raise AssertionError(f"aca_attention kernel vs twin: max |err| {err} > {KERNEL_ATOL}")
    bound, by = attention_bound(b, lv, lk, heads, nd, valid, True)
    log("aca_attention: library_ms is null: no single PyTorch call computes a "
        "softmax over dummies + text, values without the dummies and the head mean")
    rows.append(dict(
        name="aca_attention", route="cuda",
        source="flashvtg_tpu_torch/csrc/aca_attention.cu",
        replaces="scripts/bench_aca.py:40",
        shape=f"B={b} H={heads} Lv={lv} Lk={lk} Dh=32 nd={nd}",
        max_abs_err=err,
        ms=time_ms(lambda: aca.aca_attention(q, k, v, valid, heads, nd)),
        plain_ms=time_ms(lambda: aca.aca_attention_plain(q, k, v, valid, heads, nd)),
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
        out = aca.masked_attention(q, k, v, mask, heads)
        ref = aca.masked_attention_plain(q, k, v, mask, heads)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        if not err <= KERNEL_ATOL:
            raise AssertionError(f"masked_attention L={length}: max |err| {err}")
        qh, kh, vh = (
            x.view(b, length, heads, 32).transpose(1, 2).contiguous() for x in (q, k, v)
        )
        flash_err = (chunked_attn.flash_attention(q, k, v, mask, heads) - ref).abs().max()
        if not flash_err.item() <= KERNEL_ATOL:
            raise AssertionError(f"flash_attention L={length}: max |err| {flash_err}")
        bool_mask = (mask > 0)[:, None, None, :]
        bound, by = attention_bound(b, length, length, heads, 0, mask, False)
        shapes[name] = dict(
            shape=f"B={b} H={heads} L={length} Dh=32", max_abs_err=err,
            ms=time_ms(lambda: aca.masked_attention(q, k, v, mask, heads)),
            # the flash kernel on the same inputs: is the short one worth keeping?
            flash_ms=time_ms(lambda: chunked_attn.flash_attention(q, k, v, mask, heads)),
            flash_max_abs_err=flash_err.item(),
            plain_ms=time_ms(lambda: aca.masked_attention_plain(q, k, v, mask, heads)),
            bound_ms=bound, bound_by=by,
            library_ms=time_ms(
                lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=bool_mask)
            ),
        )
        log(f"masked_attention[{name}]: {json.dumps(shapes[name])}")
    enc = shapes["encoder"]
    rows.append(dict(
        name="masked_attention", route="cuda",
        source="flashvtg_tpu_torch/csrc/aca_attention.cu",
        replaces="scripts/bench_flash.py:57",
        **{**enc, "max_abs_err": max(m["max_abs_err"] for m in shapes.values())},
    ))

    # TACoS: 2048 clips over 35 dummies + up to 40 text tokens (logged), and
    # the encoder's self-attention over 2048 clips of 64-2048 valid
    shapes["tacos_aca"] = aca_eval_reading(dev, g, rng, 8, 2048, 35, 40)
    log(f"aca_attention[tacos]: {json.dumps(shapes['tacos_aca'])}")
    reading = self_eval_reading(dev, g, 8, ragged_mask(rng, 8, 2048, 64, 2049).to(dev))
    rows.append(dict(
        name="flash_attention", route="cuda",
        source="flashvtg_tpu_torch/csrc/flash_attention.cu",
        replaces="scripts/bench_flash.py:57",
        **{k: v for k, v in reading.items() if k != "kernel"},
    ))
    return rows, shapes


# (B, Lv, dummies, text tokens, fewest and most valid clips) of the eval
# paths of the HD and Charades presets
SLICE_EVAL_SHAPES = {
    "hd_eval": (4, 1000, 3, 32, 60, 330),
    "charades_eval": (128, 256, 40, 32, 15, 45),
    "charades_vgg_eval": (16, 2048, 40, 32, 90, 270),
}


def aca_eval_reading(dev, g, rng, b, lv, nd, lq):
    """The ACA kernel against its plain version at one eval shape, timed."""
    import torch

    from flashvtg_tpu_torch.ops import aca

    heads, lk = 8, nd + lq
    q, k, v = qkv_b(g, dev, b, heads, lv, lk)
    valid = ragged_mask(rng, b, lk, 5, lq + 1, always=nd).to(dev)
    out, hm = aca.aca_attention(q, k, v, valid, heads, nd)
    ref_out, ref_hm = aca.aca_attention_plain(q, k, v, valid, heads, nd)
    torch.cuda.synchronize()
    err = max((out - ref_out).abs().max().item(), (hm - ref_hm).abs().max().item())
    shape = f"B={b} H={heads} Lv={lv} Lk={lk} Dh=32 nd={nd}"
    if not err <= KERNEL_ATOL:
        raise AssertionError(f"aca_attention {shape}: max |err| {err} > {KERNEL_ATOL}")
    bound, by = attention_bound(b, lv, lk, heads, nd, valid, True)
    return dict(
        kernel="aca_attention", shape=shape, max_abs_err=err,
        ms=time_ms(lambda: aca.aca_attention(q, k, v, valid, heads, nd), iters=20),
        plain_ms=time_ms(lambda: aca.aca_attention_plain(q, k, v, valid, heads, nd), iters=10),
        bound_ms=bound, bound_by=by, library_ms=None,
    )


def self_eval_reading(dev, g, b, valid):
    """Masked self-attention over the keys of `valid` against its plain
    version: the short kernel up to 128 keys, the flash kernel past; timed
    beside scaled_dot_product_attention with the same boolean mask."""
    import torch
    import torch.nn.functional as F

    from flashvtg_tpu_torch.ops import aca, chunked_attn

    heads, length = 8, valid.shape[1]
    if length > aca.MAX_KEYS:
        name, fn, plain = ("flash_attention", chunked_attn.flash_attention,
                           chunked_attn.flash_attention_plain)
    else:
        name, fn, plain = "masked_attention", aca.masked_attention, aca.masked_attention_plain
    q, k, v = qkv_b(g, dev, b, heads, length, length)
    err = (fn(q, k, v, valid, heads) - plain(q, k, v, valid, heads)).abs().max().item()
    shape = f"B={b} H={heads} L={length} Dh=32, valid keys {int(valid.sum().item())} of {b * length}"
    if not err <= KERNEL_ATOL:
        raise AssertionError(f"{name} {shape}: max |err| {err} > {KERNEL_ATOL}")
    qh, kh, vh = (x.view(b, length, heads, 32).transpose(1, 2).contiguous() for x in (q, k, v))
    bool_mask = (valid > 0)[:, None, None, :]
    bound, by = attention_bound(b, length, length, heads, 0, valid, False)
    return dict(
        kernel=name, shape=shape, max_abs_err=err,
        ms=time_ms(lambda: fn(q, k, v, valid, heads), iters=20),
        plain_ms=time_ms(lambda: plain(q, k, v, valid, heads), iters=10),
        bound_ms=bound, bound_by=by,
        library_ms=time_ms(
            lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=bool_mask), iters=20),
    )


def phase_slice_kernels(dev, seed):
    """Phase 3, second part: each eval kernel of the HD and Charades paths
    (the ACA layers, the dummy encoder's short self-attention, the
    encoder's flash attention) at SLICE_EVAL_SHAPES."""
    import torch

    rng = np.random.default_rng(seed + 2)
    g = torch.Generator().manual_seed(seed + 2)
    shapes = {}
    for path, (b, lv, nd, lq, lo, hi) in SLICE_EVAL_SHAPES.items():
        text = ragged_mask(rng, b, nd + lq, 5, lq + 1, always=nd).to(dev)
        video = ragged_mask(rng, b, lv, lo, hi + 1).to(dev)
        for length, reading in ((lv, aca_eval_reading(dev, g, rng, b, lv, nd, lq)),
                                (nd + lq, self_eval_reading(dev, g, b, text)),
                                (lv, self_eval_reading(dev, g, b, video))):
            key = f"{path} {reading['kernel']} L={length}"
            shapes[key] = reading
            log(f"[slice kernels] {key}: {json.dumps(reading)}")
    return shapes


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


def sdpa_backward_ms(q, k, v, valid, heads, d_out):
    """The backward's yardstick: torch.autograd.grad through
    scaled_dot_product_attention with the same boolean key mask (and no
    dropout), forward + backward minus forward, ms."""
    import torch
    import torch.nn.functional as F

    b = q.shape[0]
    qh, kh, vh = (x.view(b, -1, heads, 32).transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    d_oh = d_out.view(b, -1, heads, 32).transpose(1, 2).contiguous()
    mask = (valid > 0)[:, None, None, :]

    def fwd():
        return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)

    both = time_ms(lambda: torch.autograd.grad(fwd(), (qh, kh, vh), d_oh), iters=10, warmup=2)
    return both - time_ms(fwd, iters=10, warmup=2)


def sdpa_train_forward_ms(q, k, v, valid, heads, p):
    """The training forward's yardstick: scaled_dot_product_attention with
    the same boolean key mask and dropout_p on tensors that require grad
    (so that it also keeps what its backward needs, the log-sum-exp), ms.
    Its dropout mask is Philox's, not the port's hash: the same function up
    to which probabilities drop."""
    import torch.nn.functional as F

    b = q.shape[0]
    qh, kh, vh = (x.view(b, -1, heads, 32).transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    mask = (valid > 0)[:, None, None, :]
    return time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask,
                                                          dropout_p=p),
                   iters=10, warmup=2)


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


def backward_reading(shape, bwd, bwd_plain, fn, bound, library_ms):
    """A backward kernel against its plain version, through its launcher and
    through its autograd Function (`fn`, function_grads' result): relative
    errors, bit-for-bit repeat, times. `bound` is attention_bound's (ms,
    by)."""
    import torch

    got, ref = bwd(), bwd_plain()
    torch.cuda.synchronize()
    errs = [rel_err(x, y) for x, y in zip(got, ref)]
    fn_errs = [rel_err(x, y) for x, y in zip(fn[0], ref)]
    if not max(errs + fn_errs) <= GRAD_RTOL:
        raise AssertionError(f"backward {shape} vs plain: relative errors {errs} (launcher), "
                             f"{fn_errs} (autograd Function) > {GRAD_RTOL}")
    if not all(torch.equal(x, y) for x, y in zip(got, bwd())):
        raise AssertionError(f"backward {shape}: two launches disagree")
    return dict(
        shape=shape, max_abs_err=max((x - y).abs().max().item() for x, y in zip(got, ref)),
        max_rel_err=max(errs), function_rel_err=max(fn_errs),
        function_fwd_bwd_peak_bytes=fn[1], ms=time_ms(bwd, iters=10, warmup=2),
        plain_ms=time_ms(bwd_plain, iters=3, warmup=1), bound_ms=bound[0],
        bound_by=bound[1], library_ms=library_ms,
    )


def forward_reading(shape, got, ref, fwd, fwd_plain, bound, library_ms=None):
    """A training-form forward (out, head mean, log-sum-exp) against its
    plain version with the same dropout seed, timed."""
    import torch

    torch.cuda.synchronize()
    err = max((x - y).abs().max().item() for x, y in zip(got, ref) if x is not None)
    if not err <= KERNEL_ATOL:
        raise AssertionError(f"training forward {shape}: max |err| {err} > {KERNEL_ATOL}")
    return dict(shape=shape, max_abs_err=err, ms=time_ms(fwd, iters=10, warmup=2),
                plain_ms=time_ms(fwd_plain, iters=3, warmup=1), bound_ms=bound[0],
                bound_by=bound[1], library_ms=library_ms)


def aca_train_case(dev, g, b, lv, nd, heads, p, seed, valid, vmask):
    """The ACA core in training form: lv video queries over nd dummies and
    the ragged text of `valid`, videos of `vmask`, donor rows, a head-mean
    gradient. Returns (kernel name, forward reading, backward reading)."""
    import torch

    from flashvtg_tpu_torch.models.transformer import tiled_attn_donors
    from flashvtg_tpu_torch.ops import aca
    from flashvtg_tpu_torch.ops.attn_dropout import draw_seed

    lk = valid.shape[1]
    q, k, v = qkv_b(g, dev, b, heads, lv, lk)
    d_out = torch.randn((b, lv, heads * 32), generator=g).to(dev)
    d_hm = torch.randn((b, lv, lk), generator=g).to(dev)
    donors = tiled_attn_donors(b, heads, dev)
    drop_seed = draw_seed(torch.Generator().manual_seed(seed))
    args = (q, k, v, valid, heads, nd, True, p, drop_seed, vmask, donors)
    pairs = aca_pairs(valid, vmask, donors, nd)
    shape = f"B={b} H={heads} Lv={lv} Lk={lk} Dh=32 nd={nd} p={p}, donor rows"
    fwd = functools.partial(aca._launch, *args, want_lse=True)
    fwd_plain = functools.partial(aca.aca_attention_plain, *args, want_lse=True)
    got, ref = fwd(), fwd_plain()
    fwd_reading = forward_reading(
        shape, got, ref, fwd, fwd_plain,
        attention_bound(b, lv, lk, heads, nd, valid, True, pairs=pairs),
    )
    rest = (d_out, d_hm, heads, nd, p, drop_seed, vmask, donors)
    fn = function_grads(
        functools.partial(aca.aca_attention, key_valid=valid, num_heads=heads,
                          num_dummies=nd, dropout=p,
                          generator=torch.Generator().manual_seed(seed),
                          query_valid=vmask, donor_rows=donors),
        (q, k, v), (d_out, d_hm),
    )
    return "aca_attention", fwd_reading, backward_reading(
        shape,
        functools.partial(aca._launch_bwd, q, k, v, valid, got[2], *rest),
        functools.partial(aca.aca_attention_bwd_plain, q, k, v, valid, ref[2], *rest),
        fn, attention_bound(b, lv, lk, heads, nd, valid, True, backward=True, pairs=pairs),
        None,
    )


def self_train_case(dev, g, b, heads, p, seed, valid):
    """Masked self-attention in training form over the keys of `valid`: the
    short kernel up to 128 keys, the flash kernel past. Returns (kernel
    name, forward reading, backward reading)."""
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
        fwd = functools.partial(chunked_attn._launch, *args, want_lse=True)
        fwd_plain = functools.partial(chunked_attn.flash_attention_plain, *args, want_lse=True)
        got, ref = fwd(), fwd_plain()
        bwd = functools.partial(chunked_attn._launch_bwd, q, k, v, valid, *got, d_out, heads,
                                p, drop_seed)
        bwd_plain = functools.partial(chunked_attn.flash_attention_bwd_plain, q, k, v, valid,
                                      *ref, d_out, heads, p, drop_seed)
        call = functools.partial(chunked_attn.flash_attention, **call)
    else:
        name = "masked_attention"
        args = (q, k, v, valid, heads, 0, False, p, drop_seed)
        fwd = functools.partial(aca._launch, *args, want_lse=True)
        fwd_plain = functools.partial(aca.aca_attention_plain, *args, want_lse=True)
        got, ref = fwd(), fwd_plain()
        rest = (d_out, None, heads, 0, p, drop_seed)
        bwd = functools.partial(aca._launch_bwd, q, k, v, valid, got[2], *rest)
        bwd_plain = functools.partial(aca.aca_attention_bwd_plain, q, k, v, valid, ref[2], *rest)
        call = functools.partial(aca.masked_attention, **call)
    fwd_reading = forward_reading(shape, got, ref, fwd, fwd_plain,
                                  attention_bound(b, length, length, heads, 0, valid, False),
                                  sdpa_train_forward_ms(q, k, v, valid, heads, p))
    return name, fwd_reading, backward_reading(
        shape, bwd, bwd_plain, function_grads(call, (q, k, v), (d_out,)),
        attention_bound(b, length, length, heads, 0, valid, False, backward=True),
        sdpa_backward_ms(q, k, v, valid, heads, d_out),
    )


# (B, Lv, dummies, text tokens, fewest and most clips of a video) of each
# train path
TRAIN_KERNEL_SHAPES = {
    "tacos_train": (32, 2048, 35, 40, 64, 2048),
    "flagship_train": (64, 75, 10, 32, 20, 75),
    "tvsum_train": (4, 1000, 3, 32, 60, 330),
}


def phase_train_kernels(dev, seed):
    """Phase 7: the training forms and the backward kernels at each train
    path's shapes, dropout on, through their launchers (timed) and through
    the autograd Functions that the model calls. Returns the backward
    kernels' rows (at the TACoS train shapes, errors the largest over every
    shape) and every shape's readings, which are logged."""
    import torch

    rng = np.random.default_rng(seed + 1)
    g = torch.Generator().manual_seed(seed + 1)
    heads, p = 8, TRAIN_DROPOUT
    shapes, readings = {}, {}
    for path, (b, lv, nd, lq, min_clips, max_clips) in TRAIN_KERNEL_SHAPES.items():
        text = ragged_mask(rng, b, nd + lq, 5, lq + 1, always=nd).to(dev)
        video = ragged_mask(rng, b, lv, min_clips, max_clips + 1).to(dev)
        cases = (  # the ACA layers, the dummy encoder, the encoder
            aca_train_case(dev, g, b, lv, nd, heads, p, seed, text, video),
            self_train_case(dev, g, b, heads, p, seed, text),
            self_train_case(dev, g, b, heads, p, seed, video),
        )
        for (name, fwd, bwd), length in zip(cases, (lv, nd + lq, lv)):
            shapes[f"{path} {name} L={length}"] = fwd
            shapes[f"{path} {name}_bwd L={length}"] = bwd
            readings.setdefault(name + "_bwd", []).append(bwd)
        bhll = 4 * b * heads * lv * lv
        if lv > 128:  # the flash forward + backward's peak: memory-linear
            peak = shapes[f"{path} flash_attention_bwd L={lv}"]["function_fwd_bwd_peak_bytes"]
            if not peak < bhll:
                raise AssertionError(
                    f"flash fwd + bwd peak +{peak} B >= one (B, H, L, L) f32 {bhll} B")
            shapes[f"{path} flash_fwd_bwd_memory"] = dict(peak_above_inputs_bytes=peak,
                                                          bhll_f32_bytes=bhll)
    source = {"aca_attention_bwd": "aca_attention_bwd.cu",
              "masked_attention_bwd": "aca_attention_bwd.cu",
              "flash_attention_bwd": "flash_attention_bwd.cu"}
    rows = []
    for name, found in readings.items():
        rows.append(dict(
            found[0], name=name, route="cuda", source="flashvtg_tpu_torch/csrc/" + source[name],
            replaces="scripts/bench_flash.py:67",
            **{key: max(r[key] for r in found)
               for key in ("max_abs_err", "max_rel_err", "function_rel_err")},
        ))
    return rows, shapes


def make_dataset(root, cfg, n_queries, seed):
    """The synthetic eval set of a preset, written under `root` and loaded.
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
    return cfg, VTGDataset(eval_data_config(cfg, ann))


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

    return {**aca.LAUNCHES, **chunked_attn.LAUNCHES}


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

    sub, sub_nms = out
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


def phase_path(dev, cfg, ds, seed, infer, score):
    """Phases 4, 6, 9 and 11: one preset's eval through the kernels:
    infer(cfg, model, ds) (run_mr_inference or run_hl_inference) warmed up,
    then run with the launch counts set to 0 just before and read just
    after, then score(cfg, ds, output)."""
    import torch

    from flashvtg_tpu_torch.models.flashvtg import build_model

    model = build_model(cfg.model_config(), dev, seed)
    infer(cfg, model, ds)  # warm-up: cuBLAS / cuDNN plans
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    reset_launch_counts()
    t0 = time.perf_counter()
    out = infer(cfg, model, ds)
    torch.cuda.synchronize()
    t_infer = time.perf_counter() - t0
    launches = launch_counts()
    scored = score(cfg, ds, out)
    t_total = time.perf_counter() - t0

    n_batches = -(-len(ds) // cfg.eval_bsz)
    assert len(ds) % cfg.eval_bsz == 0, "use a multiple of eval_bsz queries"
    for name, n in launches_per_batch(cfg).items():
        assert launches[name] == n * n_batches, (name, launches[name], n * n_batches)
    return model, dict(
        queries=len(ds), batches=n_batches, eval_bsz=cfg.eval_bsz, max_v_l=cfg.max_v_l,
        launches=launches,
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
    """One full eval batch's step (forward + decode; the HD sets' forward
    alone) as a call on tensors already on the card."""
    from flashvtg_tpu_torch.data.dataset import HD_SETS
    from flashvtg_tpu_torch.train.infer import make_eval_step

    placed, pv = step_inputs(dev, cfg, ds)
    step = make_eval_step(model, cfg.max_num_moment, saliency_only=cfg.dset_name in HD_SETS)
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


def phase_card_vs_cpu(dev, model, cfg, ds, seed, n):
    """Phases 5 and 6: the same weights on the card and on the CPU, over the
    first n queries (a short video among them)."""
    import torch

    from flashvtg_tpu_torch.data.collate import MODEL_KEYS, Collator
    from flashvtg_tpu_torch.models.flashvtg import build_model
    from flashvtg_tpu_torch.models.points import pyramid_masks_strict

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
    return errs


def run_preset(dev, preset, n_queries, n_compare, seed, **overrides):
    """Data, the eval path (phase_path through run_mr_inference, or
    run_hl_inference for the HD sets), its device step and card vs CPU for
    one preset."""
    from flashvtg_tpu_torch.data.dataset import HD_SETS
    from flashvtg_tpu_torch.train.config import from_preset
    from flashvtg_tpu_torch.train.infer import run_hl_inference, run_mr_inference

    cfg = from_preset(preset, **overrides)
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


def train_step_time(dev, model, cfg, seed):
    """Device time of one train step on a batch already on the card (CUDA
    events over 5 steps), ms, and the step's peak memory, bytes."""
    import torch

    from flashvtg_tpu_torch.train.loop import make_optimizer, make_train_step, place_batch

    placed = place_batch(train_batch(cfg, range(cfg.bsz)), dev)
    optimizer, scheduler = make_optimizer(cfg, model.parameters(), 1)
    step = make_train_step(model, cfg.loss_config(), optimizer, scheduler, cfg.grad_clip,
                           torch.Generator().manual_seed(seed))
    step(placed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = time_ms(lambda: step(placed), iters=5, warmup=1)
    return ms, torch.cuda.max_memory_allocated()


def train_card_vs_cpu(dev, cfg, seed, n_rows):
    """One 2-row step at full width with every dropout at 0 (dummy_dropout
    and input_dropout included), the same weights on the card and on the
    CPU: losses, clipped gradients, parameters after the AdamW step. The
    rows: the shortest video of the first 8 (of n_rows) and another."""
    import dataclasses

    import torch

    from flashvtg_tpu_torch.models.flashvtg import build_model
    from flashvtg_tpu_torch.train.loop import make_optimizer, make_train_step, place_batch

    cfg = cfg.replace(dropout=0.0, input_dropout=0.0)
    mcfg = dataclasses.replace(cfg.model_config(), dummy_dropout=0.0)
    first = train_batch(cfg, range(min(8, n_rows)))
    short = int(np.argmin(first["valid_v_lens"]))
    assert first["valid_v_lens"][short] < cfg.max_v_l  # a short video is in
    batch = train_batch(cfg, [0 if short else 1, short])
    runs = {}
    for d in ("cpu", dev):
        model = build_model(mcfg, d, seed).train()
        before = {n: p.detach().cpu().clone() for n, p in model.named_parameters()}
        optimizer, scheduler = make_optimizer(cfg, model.parameters(), 1)
        step = make_train_step(model, cfg.loss_config(), optimizer, scheduler, cfg.grad_clip)
        losses = {k: v.item() for k, v in step(place_batch(batch, d)).items()}
        named = [(n, p) for n, p in model.named_parameters() if p.grad is not None]
        runs[str(d)] = (losses, {n: p.grad.cpu() for n, p in named},
                        {n: p.detach().cpu() - before[n] for n, p in named})
    (l_cpu, g_cpu, u_cpu), (l_card, g_card, u_card) = runs["cpu"], runs[str(dev)]
    loss_err = max(abs(l_card[k] - v) / max(abs(v), 1e-6) for k, v in l_cpu.items())
    # each leaf relative to its own largest gradient, floored at a share of
    # the largest over all leaves (a leaf whose gradients all sit at that
    # floor's rounding is held in absolute terms)
    floor = STEP_GRAD_FLOOR * max(g.abs().max().item() for g in g_cpu.values())
    grad_errs = {n: (g_card[n] - g).abs().max().item() / max(g.abs().max().item(), floor)
                 for n, g in g_cpu.items()}
    worst = max(grad_errs, key=grad_errs.get)
    # the first AdamW step moves a weight by lr (g / (|g| + eps) + wd p):
    # it carries the sign of each gradient, so updates are compared where
    # the sign is beyond the gradients' disagreement, to 1% of lr
    update_err, compared = 0.0, 0
    for n, g in g_cpu.items():
        sure = g.abs() > 100 * (g_card[n] - g).abs().max()
        if sure.any():
            update_err = max(update_err, (u_card[n] - u_cpu[n])[sure].abs().max().item())
            compared += int(sure.sum().item())
    total = sum(g.numel() for g in g_cpu.values())
    assert all(np.isfinite(v) for v in l_card.values())
    assert loss_err <= STEP_LOSS_RTOL, ("losses", loss_err, l_card, l_cpu)
    assert grad_errs[worst] <= STEP_GRAD_RTOL, ("gradients", worst, grad_errs[worst])
    assert compared > total // 4, ("updates compared", compared, total)
    assert update_err <= 1e-2 * cfg.lr, ("updates", update_err)
    return dict(loss_rel_err=loss_err, grad_rel_err=grad_errs[worst], grad_worst_leaf=worst,
                update_abs_err=update_err, updates_compared=compared, weights=total,
                rows=len(batch["vid"]), valid_v_lens=batch["valid_v_lens"].tolist())


def run_train_preset(dev, preset, steps, seed, n_train=None, n_val=None, **overrides):
    """Phases 8 and 10 for one preset: train() on n_train rows (default one
    epoch of `steps` steps) and its eval on n_val rows (default eval_bsz),
    its launches and losses, the step's time and memory, card vs CPU."""
    import torch

    from flashvtg_tpu_torch.train.config import from_preset
    from flashvtg_tpu_torch.train.infer import _tail_bucket
    from flashvtg_tpu_torch.train.loop import train

    cfg = from_preset(preset, **overrides)
    n_train = n_train or steps * cfg.bsz
    n_val = n_val or cfg.eval_bsz
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        cfg = make_train_split(tmp, cfg, n_train, n_val, seed)
        log(f"[{preset} train data] {n_train} + {n_val} rows written in "
            f"{time.perf_counter() - t0:.2f} s")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        model, result = train(cfg, dev, max_steps=steps)
        torch.cuda.synchronize()
        t_train = time.perf_counter() - t0
        launches = launch_counts()
        peak = torch.cuda.max_memory_allocated()
        assert result["steps"] == steps
        assert all(np.isfinite(v) for h in result["losses"] for v in h.values())
        assert np.isfinite(list(result["metrics"]["brief"].values())).all()
        assert _tail_bucket(n_val, cfg.eval_bsz) == n_val  # the eval is one full batch
        per_step = train_launches_per_step(cfg)
        per_eval = launches_per_batch(cfg)
        for name, n in per_step.items():
            want = n * steps + per_eval.get(name, 0)
            assert launches[name] == want, (name, launches[name], want)
        assert peak < 80e9, f"train peak {peak} B"
        step_ms, step_peak = train_step_time(dev, model.train(), cfg, seed)
        path = dict(
            preset=preset, bsz=cfg.bsz, max_v_l=cfg.max_v_l, steps=steps, eval_rows=n_val,
            launches=launches, launches_per_step=per_step, train_s=t_train,
            losses_first=result["losses"][0], losses_last=result["losses"][-1],
            brief=result["metrics"]["brief"], peak_mem_bytes=peak, step_ms=step_ms,
            step_rows_per_s=cfg.bsz / step_ms * 1e3, step_peak_mem_bytes=step_peak,
        )
        log(f"[{preset} train path] {json.dumps(path)}")
        del model
        path["card_vs_cpu"] = train_card_vs_cpu(dev, cfg, seed, n_train)
        log(f"[{preset} train card vs cpu] {json.dumps(path['card_vs_cpu'])}")
    return path


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
    for name in kernels.SOURCES:  # every product in 3xTF32 on mma.sync
        for fn, n in hmma[name].items():
            # the flash pre-pass D = rowsum(dO O) and the ACA backward's sum of
            # its chunks' partial dk and dv have no product
            if "delta" not in fn and "reduce" not in fn:
                assert n > 0, f"{fn}: no tensor-core instruction"

    rows, shapes = phase_kernels(dev, args.seed)
    log(f"[kernels] {json.dumps(rows)}")
    shapes.update(phase_slice_kernels(dev, args.seed))

    train_rows, train_shapes = phase_train_kernels(dev, args.seed)
    log(f"[train kernels] {json.dumps(train_rows)} {json.dumps(train_shapes)}")
    rows += train_rows
    shapes.update(train_shapes)

    paths = {
        "flagship": run_preset(dev, "qvhighlights_slowclip", args.queries, 8, args.seed),
        "tacos": run_preset(dev, "tacos", args.tacos_queries, 2, args.seed),
        "flagship_train": run_train_preset(dev, "qvhighlights_slowclip", args.train_steps,
                                           args.seed),
        "tacos_train": run_train_preset(dev, "tacos", args.train_steps, args.seed),
        "hd_youtube_eval": run_preset(dev, "youtube_uni", args.hd_queries, 2, args.seed,
                                      dset_domain="dog"),
        "hd_tvsum_eval": run_preset(dev, "tvsum", 8, 2, args.seed, dset_domain="BK"),
        # TVSum's own split of a domain: 4 train videos and 1 val video
        "tvsum_train": run_train_preset(dev, "tvsum", args.train_steps, args.seed, n_train=4,
                                        n_val=1, dset_domain="BK"),
        "charades_eval": run_preset(dev, "charades", 256, 2, args.seed),
        "charades_vgg_eval": run_preset(dev, "charades_vgg", 32, 2, args.seed),
    }

    for row in rows:  # the largest error over every shape of the kernel
        row["max_abs_err"] = max([row["max_abs_err"]] + [
            r["max_abs_err"] for r in shapes.values() if r.get("kernel") == row["name"]])
        by_path = {name: p["launches"][row["name"]] for name, p in paths.items()}
        row["launches"] = sum(by_path.values())
        row["launches_by_path"] = by_path
        assert row["launches"] > 0, f"{row['name']} never launched on the paths"
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "shape", "launches_by_path")
    print(json.dumps({"paths": paths, "kernel_shapes": shapes, "sass_hmma": hmma}))
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
