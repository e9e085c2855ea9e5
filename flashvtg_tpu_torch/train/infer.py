"""Batched inference: features -> ranked moments + saliency -> HD mAP.

Counterpart of flashvtg_tpu/train/infer.py (`make_eval_step`,
`run_mr_inference`, `apply_nms`, `run_hl_inference`). Forward, decode and
top-k run batched on the model's device; each batch is moved host ->
device, and host code only formats the jsonl rows, byte for byte as the JAX
package does (f64 4-decimal rounding, f32-noise NMS scores, parked pad
slots). The highlight-detection sets (TVSum, YouTube-HL) take the
saliency-only step, the forward with no decode, and score the saliency
with eval/hl.py's mAP. Not ported yet: the device-resident feed, mesh
sharding, pipelining and eval losses.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from flashvtg_tpu_torch.data.collate import MODEL_KEYS, Collator
from flashvtg_tpu_torch.data.dataset import DataConfig, VTGDataset
from flashvtg_tpu_torch.eval.hl import compute_hl_map
from flashvtg_tpu_torch.eval.postprocess import build_post_processor
from flashvtg_tpu_torch.models.flashvtg import FlashVTGModel, decode_boundaries
from flashvtg_tpu_torch.models.points import pyramid_masks_strict
from flashvtg_tpu_torch.ops.nms import suppress_overlaps


def eval_data_config(cfg, path: str) -> DataConfig:
    """Eval DataConfig of an ExperimentConfig (the JAX loop's _dataset_cfg
    with load_labels=False)."""
    return DataConfig(
        dset_name=cfg.dset_name,
        data_path=path,
        v_feat_dirs=tuple(cfg.v_feat_dirs),
        q_feat_dir=cfg.t_feat_dir,
        q_feat_type=cfg.q_feat_type,
        max_q_l=cfg.max_q_l,
        max_v_l=cfg.max_v_l,
        data_ratio=cfg.data_ratio,
        ctx_mode=cfg.ctx_mode,
        normalize_v=not cfg.no_norm_vfeat,
        normalize_t=not cfg.no_norm_tfeat,
        dset_domain=cfg.dset_domain,
    )


def make_eval_step(model: FlashVTGModel, top_k: int, precision: str = "float32",
                   saliency_only: bool = False):
    """step(batch, point_valid) -> (spans, scores, saliency): forward +
    decode + rank for one batch of device tensors. `saliency_only` (the HD
    sets, which read only the saliency channel) skips the decode: spans and
    scores are then None."""
    if precision != "float32":
        raise NotImplementedError(f"eval precision {precision!r} is not ported yet")

    @torch.no_grad()
    def step(batch, point_valid):
        out = model(
            batch["src_txt"], batch["src_txt_mask"], batch["src_vid"],
            batch["src_vid_mask"], point_valid=point_valid,
        )
        if saliency_only:
            return None, None, out["saliency_scores"]
        spans, scores = decode_boundaries(
            out["out_class"], out["out_coord"], out["point"],
            model.cfg.clip_length, point_valid=point_valid, top_k=top_k,
        )
        return spans, scores, out["saliency_scores"]

    return step


def _tail_bucket(n: int, bsz: int) -> int:
    """Largest power of two (capped at bsz) that fits a tail of n rows: the
    tail splits into its binary decomposition (14 -> 8 + 4 + 2), so every
    batch is exactly full at a fixed size."""
    b = 1
    while b * 2 <= min(n, bsz):
        b *= 2
    return b


def _batched(dataset: VTGDataset, collator: Collator, bsz: int, order=None):
    n = len(dataset)
    order = list(range(n)) if order is None else list(order)
    i = 0
    while i < n:
        take = bsz if n - i >= bsz else _tail_bucket(n - i, bsz)
        idx = order[i : i + take]
        yield len(idx), idx, collator([dataset[j] for j in idx])
        i += take


def _eval_plan(cfg, dataset: VTGDataset):
    """(fixed_v_len, iteration order): bucket_eval visits the longest videos
    first so each batch lands in one length bucket."""
    if cfg.bucket_eval:
        lens = [float(r.get("duration", 0.0)) for r in dataset.data]
        return None, list(np.argsort(lens)[::-1])
    return (cfg.max_v_l if cfg.max_v_l > 0 else None), None


def _strict_or_none(strict, valid_v_lens, lv):
    """No strict mask for batches without padded rows: the masks are then
    all ones, and point_valid=None takes the direct conf-head path with the
    same outputs."""
    if int(np.min(valid_v_lens)) == lv:
        return None
    return strict


def _run_step(step, batch, strides, device):
    """One collated batch through `step` on `device`, with its strict point
    masks (None where no row is padded): (the step's outputs on the host,
    None kept, each row's point count)."""
    lv = batch["src_vid"].shape[1]
    strict, counts = pyramid_masks_strict(batch["valid_v_lens"], lv, strides)
    strict = _strict_or_none(strict, batch["valid_v_lens"], lv)
    dev = {k: torch.from_numpy(batch[k]).to(device) for k in MODEL_KEYS}
    point_valid = None if strict is None else torch.from_numpy(strict).to(device)
    outs = step(dev, point_valid)
    return [None if t is None else t.cpu().numpy() for t in outs], counts


def run_mr_inference(
    cfg, model: FlashVTGModel, dataset: VTGDataset, nms_thd: Optional[float] = None,
) -> Tuple[List[dict], Optional[List[dict]]]:
    """Submission rows (and NMS'd rows) for an MR dataset, on the device
    that holds the model's parameters."""
    device = next(model.parameters()).device
    fixed_v_len, order = _eval_plan(cfg, dataset)
    collator = Collator(
        max_q_l=cfg.max_q_l, v_buckets=cfg.v_buckets, fixed_v_len=fixed_v_len
    )
    step = make_eval_step(model, cfg.max_num_moment, cfg.eval_precision)
    nms = nms_thd if nms_thd is not None else cfg.nms_thd

    submission: List[dict] = []
    for real, idx, batch in _batched(dataset, collator, cfg.eval_bsz, order):
        (spans, scores, saliency), counts = _run_step(step, batch, cfg.strides, device)
        # 4-decimal rounding in float64: reproduces float(f"{x:.4f}") for
        # float32-origin values
        sal_r = np.round(saliency.astype(np.float64), 4)
        for j in range(real):
            meta = batch["meta"][j]
            n = min(cfg.max_num_moment, int(counts[j]))
            dur = meta.get("duration", 1e9)
            win = np.clip(spans[j, :n], 0, dur)
            rows = np.round(
                np.concatenate([win, scores[j, :n, None]], axis=1).astype(np.float64),
                4,
            ).tolist()
            entry = dict(
                qid=meta["qid"],
                query=meta.get("query", ""),
                vid=meta["vid"],
                pred_relevant_windows=rows,
            )
            lvalid = int(batch["valid_v_lens"][j])
            entry["pred_saliency_scores"] = sal_r[j, :lvalid].tolist()
            submission.append(entry)

    post = build_post_processor(cfg.dset_name, cfg.clip_length, cfg.v_feat_dim)
    submission = post(submission)

    if cfg.dset_name in ("charadesSTA", "charadesSTA_internvideo2", "tacos", "nlq"):
        for s in submission:
            s.pop("pred_saliency_scores", None)

    submission_nms = None
    if nms is not None and nms != -1:
        submission_nms = apply_nms(submission, nms, cfg.nms_type, device=device)
    return submission, submission_nms


def run_hl_inference(cfg, model: FlashVTGModel, dataset: VTGDataset) -> dict:
    """TVSum / YouTube-HL: the saliency of every video of one domain on the
    device that holds the model's parameters, then the domain's mAP (TVSum
    top-5, YouTube-HL over the whole ranking). Returns {"brief": {"mAP":
    rounded to 5 places}, "saliency": {qid: (valid clips,) float32}}."""
    device = next(model.parameters()).device
    fixed_v_len, order = _eval_plan(cfg, dataset)
    collator = Collator(
        max_q_l=cfg.max_q_l, v_buckets=cfg.v_buckets, fixed_v_len=fixed_v_len,
        dset_name=cfg.dset_name,
    )
    step = make_eval_step(model, cfg.max_num_moment, cfg.eval_precision, saliency_only=True)
    preds, labels, saliency = [], [], {}
    for real, idx, batch in _batched(dataset, collator, cfg.eval_bsz, order):
        (_, _, sal), _ = _run_step(step, batch, cfg.strides, device)
        for j in range(real):
            meta = batch["meta"][j]
            # the metric ranks the row up to the label length, as the JAX
            # package's does
            preds.append(sal[j])
            labels.append(meta["label"])
            saliency[meta["qid"]] = sal[j, : int(batch["valid_v_lens"][j])]
    mean_ap = compute_hl_map(cfg.dset_name, preds, labels)
    return {"brief": {"mAP": round(mean_ap, 5)}, "saliency": saliency}


def apply_nms(submission: List[dict], nms_thd: float, nms_type: str,
              device=None):
    """Batched NMS over every query's ranked windows on `device` (None: the
    card)."""
    from flashvtg_tpu_torch.utils.runtime import resolve_device

    device = resolve_device(device)
    k = max(len(s["pred_relevant_windows"]) for s in submission)
    n = len(submission)
    if all(len(s["pred_relevant_windows"]) == k for s in submission):
        arr = np.asarray([s["pred_relevant_windows"] for s in submission], np.float32)
        spans = np.ascontiguousarray(arr[..., :2])
        scores = np.ascontiguousarray(arr[..., 2])
    else:
        spans = np.zeros((n, k, 2), np.float32)
        scores = np.zeros((n, k), np.float32)
        for i, s in enumerate(submission):
            rows = np.asarray(s["pred_relevant_windows"], np.float32)
            m = len(rows)
            spans[i, :m] = rows[:, :2]
            scores[i, :m] = rows[:, 2]
            # park unused slots far away so they cannot suppress real windows
            if m < k:
                far = 1e7 + np.arange(k - m, dtype=np.float32)[:, None] * 10
                spans[i, m:] = np.concatenate([far, far + 1], axis=1)

    out_spans, out_scores = suppress_overlaps(
        torch.from_numpy(spans).to(device), torch.from_numpy(scores).to(device),
        nms_thd, nms_type,
    )
    out_spans, out_scores = out_spans.cpu().numpy(), out_scores.cpu().numpy()
    result = []
    for i, s in enumerate(submission):
        m = len(s["pred_relevant_windows"])
        keep = out_spans[i, :, 0] < 1e6  # drop parked pad slots
        # scores serialize as the f64 expansion of their f32 value, as the
        # reference's NMS round-trip through a default-dtype tensor does
        rows = np.concatenate(
            [
                out_spans[i][keep][:m].astype(np.float64),
                out_scores[i][keep][:m].astype(np.float64)[:, None],
            ],
            axis=1,
        ).tolist()
        result.append({**s, "pred_relevant_windows": rows})
    return result
