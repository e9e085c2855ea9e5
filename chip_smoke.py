#!/usr/bin/env python3
"""Smoke run of the PyTorch port (flashvtg_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--seed 0] [--queries 512] [--tacos-queries 64]

Phases, each failing loudly:
  1. device: prints the card's name and power limit, requires CUDA, sets
     float32 without TF32 for matmuls and cuDNN;
  2. build: compiles every CUDA kernel of the port from its sources, one
     nvcc per source, all at once;
  3. kernels vs their plain PyTorch versions on the card, at the shapes the
     two eval paths give them (atol 1e-5: both compute in float32 and differ
     only in the order of their sums), with times, bounds and yardsticks:
     the ACA and short self-attention kernel at the flagship shapes and at
     TACoS's ACA shape, the flash kernel at TACoS's encoder shape and,
     beside the short kernel, at the flagship's self-attention shapes;
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
     above what was allocated before it must stay under one (B, H, L, L)
     float32 tensor (the memory-linear check); then card vs CPU on 2 of the
     queries, one of them short, as in phase 5.
Then one line {"kernels": [...]} and, last, {"ok": true, "device": {...}}.
Exits non-zero, printing no result, without CUDA or without the package.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

F32_PEAK = 67e12  # H100 SXM float32 outside the tensor cores, FLOP/s
HBM_RATE = 3.35e12  # H100 SXM device memory, bytes/s
KERNEL_ATOL = 1e-5
FORWARD_ATOL = 3e-4


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


def attention_bound(b, lv, lk, heads, nd, key_valid, want_head_mean):
    """(bound_ms, bound_by) for one attention kernel call: each input read
    once and each output written once over the memory rate, against the
    float32 operations this data needs over the f32 peak. A masked key's
    probability is 0, so it needs no work: q.k and the softmax (about five
    operations a probability, one more for the head mean) run over the valid
    keys, p.v over the valid keys past the nd dummies. Self-attention (the
    short and the flash kernel) is lv = lk, nd = 0, no head mean."""
    d = heads * 32
    nbytes = 4 * (2 * b * lv * d + 2 * b * lk * d + b * lk)
    if want_head_mean:
        nbytes += 4 * b * lv * lk
    valid_keys = float(key_valid.sum().item())
    valid_values = float(key_valid[:, nd:].sum().item())
    ops = 2 * 32 * heads * lv * valid_keys  # q.k
    ops += 2 * 32 * heads * lv * valid_values  # p.v
    ops += (6 if want_head_mean else 5) * heads * lv * valid_keys  # softmax
    t_bytes, t_ops = nbytes / HBM_RATE, ops / F32_PEAK
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
    b, lv, nd, lq = 8, 2048, 35, 40
    lk = nd + lq
    q, k, v = qkv_b(g, dev, b, heads, lv, lk)
    valid = ragged_mask(rng, b, lk, 5, lq + 1, always=nd).to(dev)
    out, hm = aca.aca_attention(q, k, v, valid, heads, nd)
    ref_out, ref_hm = aca.aca_attention_plain(q, k, v, valid, heads, nd)
    torch.cuda.synchronize()
    err = max((out - ref_out).abs().max().item(), (hm - ref_hm).abs().max().item())
    if not err <= KERNEL_ATOL:
        raise AssertionError(f"aca_attention at the TACoS shape: max |err| {err}")
    bound, by = attention_bound(b, lv, lk, heads, nd, valid, True)
    shapes["tacos_aca"] = dict(
        shape=f"B={b} H={heads} Lv={lv} Lk={lk} Dh=32 nd={nd}", max_abs_err=err,
        ms=time_ms(lambda: aca.aca_attention(q, k, v, valid, heads, nd), iters=20),
        plain_ms=time_ms(lambda: aca.aca_attention_plain(q, k, v, valid, heads, nd),
                         iters=10),
        bound_ms=bound, bound_by=by, library_ms=None,
    )
    log(f"aca_attention[tacos]: {json.dumps(shapes['tacos_aca'])}")

    q, k, v = qkv_b(g, dev, b, heads, lv, lv)
    valid = ragged_mask(rng, b, lv, 64, lv + 1).to(dev)
    out = chunked_attn.flash_attention(q, k, v, valid, heads)
    ref = chunked_attn.flash_attention_plain(q, k, v, valid, heads)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    if not err <= KERNEL_ATOL:
        raise AssertionError(f"flash_attention kernel vs plain: max |err| {err}")
    qh, kh, vh = (x.view(b, lv, heads, 32).transpose(1, 2).contiguous() for x in (q, k, v))
    bool_mask = (valid > 0)[:, None, None, :]
    bound, by = attention_bound(b, lv, lv, heads, 0, valid, False)
    rows.append(dict(
        name="flash_attention", route="cuda",
        source="flashvtg_tpu_torch/csrc/flash_attention.cu",
        replaces="scripts/bench_flash.py:57",
        shape=f"B={b} H={heads} L={lv} Dh=32, valid keys {int(valid.sum().item())} "
              f"of {b * lv}",
        max_abs_err=err,
        ms=time_ms(lambda: chunked_attn.flash_attention(q, k, v, valid, heads), iters=20),
        plain_ms=time_ms(lambda: chunked_attn.flash_attention_plain(q, k, v, valid, heads),
                         iters=10),
        bound_ms=bound, bound_by=by,
        library_ms=time_ms(
            lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=bool_mask),
            iters=20,
        ),
    ))
    return rows, shapes


def qkv_b(g, dev, b, heads, lq_, lk_):
    """Random q (b, lq_, heads*32), k and v (b, lk_, heads*32) on the card."""
    import torch

    return tuple(
        torch.randn((b, n, heads * 32), generator=g).to(dev) for n in (lq_, lk_, lk_)
    )


def make_dataset(root, cfg, n_queries, seed):
    """The synthetic set of a preset, written under `root` and loaded:
    QVHighlights format (every fourth video 20 clips to Lv) for the
    flagship, TACoS format (64 to 2048 clips, string qids) for tacos."""
    from flashvtg_tpu_torch.train.infer import eval_data_config
    from flashvtg_tpu_torch.data.dataset import VTGDataset
    from flashvtg_tpu_torch.utils.synthetic import make_synthetic_qvh, make_synthetic_tacos

    if cfg.dset_name == "tacos":
        ann, vdir, qdir = make_synthetic_tacos(
            root, n_queries=n_queries, v_dim=cfg.v_feat_dim, t_dim=cfg.t_feat_dim,
            max_clips=cfg.max_v_l, min_clips=64, clip_len=cfg.clip_length, seed=seed,
            max_q_tokens=cfg.max_q_l,
        )
    else:
        ann, vdir, qdir = make_synthetic_qvh(
            root, n_queries=n_queries, v_dim=cfg.v_feat_dim, t_dim=cfg.t_feat_dim,
            n_clips=cfg.max_v_l, clip_len=cfg.clip_length, seed=seed, min_clips=20,
            max_q_tokens=cfg.max_q_l + 1,
        )
    cfg = cfg.replace(eval_path=ann, v_feat_dirs=(vdir,), t_feat_dir=qdir)
    return cfg, VTGDataset(eval_data_config(cfg, ann))


def check_submission(sub, ds, cfg):
    assert len(sub) == len(ds), (len(sub), len(ds))
    assert [s["qid"] for s in sub] == [m["qid"] for m in ds.data]
    for s, (_, feats) in zip(sub, (ds[i] for i in range(len(ds)))):
        wins = np.asarray(s["pred_relevant_windows"], np.float64)
        assert 0 < len(wins) <= cfg.max_num_moment and wins.shape[1] == 3
        assert np.isfinite(wins).all()
        if cfg.dset_name == "tacos":  # MR only: the rows carry no saliency
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


def phase_path(dev, cfg, ds, seed):
    """Phases 4 and 6: one preset's eval through the kernels."""
    import torch

    from flashvtg_tpu_torch.eval.metrics import eval_submission
    from flashvtg_tpu_torch.models.flashvtg import build_model
    from flashvtg_tpu_torch.train.infer import run_mr_inference

    model = build_model(cfg.model_config(), dev, seed)
    run_mr_inference(cfg, model, ds)  # warm-up: cuBLAS / cuDNN plans
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    reset_launch_counts()
    t0 = time.perf_counter()
    sub, sub_nms = run_mr_inference(cfg, model, ds)
    torch.cuda.synchronize()
    t_infer = time.perf_counter() - t0
    launches = launch_counts()
    metrics = eval_submission(sub, ds.data)
    metrics_nms = eval_submission(sub_nms, ds.data)
    t_total = time.perf_counter() - t0

    n_batches = -(-len(ds) // cfg.eval_bsz)
    assert len(ds) % cfg.eval_bsz == 0, "use a multiple of eval_bsz queries"
    for name, n in launches_per_batch(cfg).items():
        assert launches[name] == n * n_batches, (name, launches[name], n * n_batches)
    check_submission(sub, ds, cfg)
    check_submission(sub_nms, ds, cfg)
    for m in (metrics, metrics_nms):
        assert m["brief"] and all(np.isfinite(v) for v in m["brief"].values())
    return model, dict(
        queries=len(ds), batches=n_batches, eval_bsz=cfg.eval_bsz, max_v_l=cfg.max_v_l,
        launches=launches,
        launches_per_batch=sum(launches.values()) / n_batches,
        infer_s=t_infer, infer_qps=len(ds) / t_infer,
        with_metrics_s=t_total, with_metrics_qps=len(ds) / t_total,
        peak_mem_bytes=torch.cuda.max_memory_allocated(),
        brief=metrics["brief"], brief_nms=metrics_nms["brief"],
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


def step_time(dev, model, cfg, ds):
    """Device time of one full eval batch (forward + decode) on tensors
    already on the card, ms."""
    from flashvtg_tpu_torch.train.infer import make_eval_step

    placed, pv = step_inputs(dev, cfg, ds)
    step = make_eval_step(model, cfg.max_num_moment)
    return time_ms(lambda: step(placed, pv), iters=20, warmup=3)


def step_memory(dev, model, cfg, ds):
    """Peak device memory of one eval step above what was allocated before
    it, bytes, against one (B, H, L, L) float32 tensor: the logits the
    kernel never holds."""
    import torch

    from flashvtg_tpu_torch.train.infer import make_eval_step

    placed, pv = step_inputs(dev, cfg, ds)
    step = make_eval_step(model, cfg.max_num_moment)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = step(placed, pv)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - before
    del out
    logits = 4 * cfg.eval_bsz * cfg.nheads * cfg.max_v_l ** 2
    assert extra < logits, f"eval step peak +{extra} B >= one (B, H, L, L) f32 {logits} B"
    return dict(step_extra_peak_bytes=extra, bhll_f32_bytes=logits)


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


def run_preset(dev, preset, n_queries, n_compare, seed):
    """Data, the eval path, its device step and card vs CPU for one preset."""
    from flashvtg_tpu_torch.train.config import from_preset

    cfg = from_preset(preset)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        cfg, ds = make_dataset(tmp, cfg, n_queries, seed)
        log(f"[{preset} data] {len(ds)} queries written and loaded in "
            f"{time.perf_counter() - t0:.2f} s")
        model, path = phase_path(dev, cfg, ds, seed)
        path["step_ms"] = step_time(dev, model, cfg, ds)
        path["step_qps"] = cfg.eval_bsz / path["step_ms"] * 1e3
        if launches_per_batch(cfg)["flash_attention"]:
            path.update(step_memory(dev, model, cfg, ds))
        log(f"[{preset} path] {json.dumps(path)}")
        path["card_vs_cpu_max_abs_err"] = phase_card_vs_cpu(
            dev, model, cfg, ds, seed, n_compare
        )
        log(f"[{preset} card vs cpu] max |err| "
            f"{json.dumps(path['card_vs_cpu_max_abs_err'])}")
    return path


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--queries", type=int, default=512)
    ap.add_argument("--tacos-queries", type=int, default=64)
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

    rows, shapes = phase_kernels(dev, args.seed)
    log(f"[kernels] {json.dumps(rows)}")

    paths = {
        "flagship": run_preset(dev, "qvhighlights_slowclip", args.queries, 8, args.seed),
        "tacos": run_preset(dev, "tacos", args.tacos_queries, 2, args.seed),
    }

    for row in rows:
        by_path = {name: p["launches"][row["name"]] for name, p in paths.items()}
        row["launches"] = sum(by_path.values())
        row["launches_by_path"] = by_path
        assert row["launches"] > 0, f"{row['name']} never launched on the paths"
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "shape", "launches_by_path")
    print(json.dumps({"paths": paths, "kernel_shapes": shapes}))
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
