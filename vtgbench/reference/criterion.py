"""The FlashVTG training criterion in plain PyTorch, for the reference.

A frozen copy of the criterion the original trains with (FlashVTG/model.py
SetCriterion, blocks/loss.py BundleLoss, and the nncore focal / L1 / BCE
losses in their mmdet form), batched with masks: the focal classification
loss on the anchor points, the L1 boundary regression on the assigned
points, the sampled NCE saliency loss, the label loss, and the two-channel
saliency loss with its negative pair. The original's quirks are kept: the
attention channel's dead false-negative rank term, the collapse of that
term with a single false negative, and the BCE over the padded length.
`criterion(cfg, outputs, targets)` returns the loss dict with the weighted
total under "weighted_loss_overall"; `cfg` holds the loss weights.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F


def weight_reduce(loss, weight=None, avg_factor=None, reduction="mean"):
    """Elementwise weighting + reduction (reference blocks/utils.py:26-52)."""
    if weight is not None:
        loss = loss * weight
    if avg_factor is not None:
        if reduction != "mean":
            raise ValueError("avg_factor requires mean reduction")
        return loss.sum() / avg_factor
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def bce_with_logits(pred, target):
    """Numerically stable binary cross entropy on logits."""
    return torch.clamp(pred, min=0) - pred * target + torch.log1p(torch.exp(-pred.abs()))


def sigmoid_focal_loss(pred, target, weight=None, avg_factor=None, alpha=0.25, gamma=2.0):
    """Sigmoid focal loss (nncore `FocalLoss`, mmdet formulation)."""
    p = torch.sigmoid(pred)
    pt = (1 - p) * target + p * (1 - target)
    focal_weight = (alpha * target + (1 - alpha) * (1 - target)) * pt ** gamma
    return weight_reduce(bce_with_logits(pred, target) * focal_weight, weight, avg_factor)


def l1_loss(pred, target, weight=None, avg_factor=None):
    return weight_reduce((pred - target).abs(), weight, avg_factor)


def dynamic_bce_loss(pred, target, weight=None, avg_factor=None):
    """BCE-with-logits against per-sample max-normalized soft targets
    (nncore `DynamicBCELoss`, the HD configs)."""
    row_max = target.amax(dim=-1, keepdim=True).clamp_min(1e-6)
    soft = (target / row_max).clamp(0.0, 1.0)
    return weight_reduce(bce_with_logits(pred, soft), weight, avg_factor)


def quality_focal_loss(pred, label, score, weight=None, avg_factor=None, beta=2.0):
    """Quality focal loss (reference blocks/loss.py:14-40): negatives BCE to
    0 scaled by sigmoid(pred)^beta, positives BCE to the IoU `score` scaled
    by |score - sigmoid(pred)|^beta."""
    p = torch.sigmoid(pred)
    neg = bce_with_logits(pred, torch.zeros_like(pred)) * p ** beta
    pos = bce_with_logits(pred, score) * (score - p).abs() ** beta
    return weight_reduce(torch.where(label > 0, pos, neg), weight, avg_factor)


def distribution_focal_loss(pred, label, weight=None, avg_factor=None):
    """Distribution focal loss over discretised offsets (reference
    blocks/loss.py:43-71): cross entropy to the two bins around each
    continuous label in [0, C - 1), weighted by the distance to the other.
    pred (B, N, C) bin logits, label (B, N)."""
    c = pred.shape[-1]
    disl = label.to(torch.int64).clamp(0, c - 1)  # truncation, as astype(int32)
    disr = (disl + 1).clamp(0, c - 1)
    wl = disr.to(pred.dtype) - label
    wr = label - disl.to(pred.dtype)
    logp = F.log_softmax(pred, dim=-1)
    ce_l = -torch.gather(logp, -1, disl[..., None])[..., 0]
    ce_r = -torch.gather(logp, -1, disr[..., None])[..., 0]
    return weight_reduce(ce_l * wl + ce_r * wr, weight, avg_factor)


def nce_similarity(video_emb, query_emb, temperature=0.07, max_scale=100.0):
    """The sampled InfoNCE's logits before the mask, (B, Lv): each clip
    embedding's cosine with its row's pooled query, scaled (reference
    blocks/loss.py:141-191). It reads one row at a time, so a split batch
    computes it on its own rows before the batch is gathered."""
    scale = min(math.exp(math.log(1.0 / temperature)), max_scale)
    vn = video_emb / torch.linalg.vector_norm(video_emb, dim=-1, keepdim=True).clamp_min(1e-8)
    qn = query_emb / torch.linalg.vector_norm(query_emb, dim=-1, keepdim=True).clamp_min(1e-8)
    return (vn * qn).sum(-1) * scale


def sampled_nce_loss(i_sim, video_msk, saliency, pos_clip, direction=("row", "col")):
    """Sampled InfoNCE between clip embeddings and the pooled query over
    their `nce_similarity` logits (reference blocks/loss.py:141-191): only
    clips whose saliency does not exceed the positive clip's take part.
    Masked clips get -1e30, not -inf (a column masked
    in every row stays finite)."""
    b = i_sim.shape[0]
    rows = torch.arange(b, device=i_sim.device)
    pos_scores = saliency[rows, pos_clip][:, None]
    loss_msk = (saliency <= pos_scores).to(video_msk.dtype) * video_msk
    i_sim = i_sim + torch.where(loss_msk > 0, 0.0, -1e30).to(i_sim.dtype)
    loss = 0.0
    if "row" in direction:
        loss = loss - F.log_softmax(i_sim, dim=1)[rows, pos_clip].sum() / b
    if "col" in direction:
        loss = loss - F.log_softmax(i_sim.T, dim=1)[pos_clip, rows].sum() / b
    return loss

NEG_LARGE = -1e3  # the reference's value for masked saliency scores


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """Loss bundle + weights (reference CLI flags and data/MR*.py loss_cfg)."""

    label_loss_coef: float = 4.0
    lw_saliency: float = 0.1
    lw_reg: float = 0.2
    lw_cls: float = 1.0
    lw_sal: float = 0.1
    lw_wattn: float = 1.0
    saliency_margin: float = 0.2
    sample_radius: float = 1.5
    loss_cls: Optional[str] = "focal"  # focal | dynamic_bce | None
    loss_reg: Optional[str] = "l1"  # l1 | None
    loss_sal: Optional[str] = "nce"  # nce | None
    nce_direction: Tuple[str, ...] = ("row", "col")
    loss_qfl: bool = False
    clip_length: float = 2.0
    dset_name: str = "hl"


def rank_contrastive_loss(scores, labels, valid, row_weight):
    """12-level ranking contrastive loss over one score matrix (reference
    model.py:370-390): for thresholds 1..11, clips with label >= t are
    positives of a masked log-softmax over score / 0.5. Mean over weighted
    rows, averaged over the 12 levels."""
    tau = 0.5
    denom_rows = row_weight.sum().clamp_min(1e-6)
    total = 0.0
    for t in range(1, 12):
        pos = (labels >= t).to(scores.dtype) * valid
        any_pos_row = (pos.sum(dim=1) > 0).to(scores.dtype)
        logits = scores / tau
        logits = logits - logits.amax(dim=1, keepdim=True)
        log_prob = logits - torch.log(torch.exp(logits).sum(dim=1, keepdim=True) + 1e-6)
        mean_log_prob_pos = (pos * log_prob * valid).sum(1) / (pos.sum(1) + 1e-6)
        row_loss = -mean_log_prob_pos * any_pos_row
        level_has_pos = (pos.sum() > 0).to(scores.dtype)
        total = total + level_has_pos * (row_loss * row_weight).sum() / denom_rows
    return total / 12.0


def margin_pair_loss(scores, pos_idx, neg_idx, margin):
    """Hinge between sampled positive and negative clips (model.py:429-439)."""
    b, p = pos_idx.shape
    rows = torch.arange(b, device=scores.device)[:, None]
    pos = scores[rows, pos_idx]
    neg = scores[rows, neg_idx]
    return torch.clamp(margin + neg - pos, min=0).sum() / (b * p) * 2.0


def _masked_scores(scores, valid):
    return valid * scores + (1.0 - valid) * NEG_LARGE


def _saliency_channel(scores, scores_neg, labels, valid, real_neg, pos_idx, neg_idx,
                      margin, neg_pair_weight, neg_is_prob: bool,
                      include_false_neg_rank: bool = True):
    """One saliency channel (encoder scores or t2v attention values), the
    reference's real-neg / false-neg / no-neg branches folded into one
    masked computation. `include_false_neg_rank=False` keeps the reference
    bug of the attention channel."""
    b = scores.shape[0]
    loss = margin_pair_loss(scores, pos_idx, neg_idx, margin)
    if scores_neg is not None:
        prob_neg = scores_neg if neg_is_prob else torch.sigmoid(scores_neg)
        per_clip = -torch.log(torch.clamp(1.0 - prob_neg, min=1e-12))
        row_sums = (per_clip * valid).sum(dim=1)
        n_real = real_neg.sum().clamp_min(1e-6)
        loss = loss + neg_pair_weight * (row_sums * real_neg).sum() / n_real

        cat_valid = torch.cat([valid, valid], dim=1)
        cat_scores = _masked_scores(torch.cat([scores, scores_neg], dim=1), cat_valid)
        cat_labels = torch.cat([labels, torch.zeros_like(labels)], dim=1)
        loss = loss + rank_contrastive_loss(cat_scores, cat_labels, cat_valid, real_neg)

        if include_false_neg_rank:
            # with exactly one false negative the
            # reference's term collapses to ~0
            false_neg = 1.0 - real_neg
            term = rank_contrastive_loss(_masked_scores(scores, valid), labels, valid,
                                         false_neg)
            loss = loss + torch.where(false_neg.sum() > 1, term, torch.zeros_like(term))
    else:
        loss = loss + rank_contrastive_loss(
            _masked_scores(scores, valid), labels, valid, scores.new_ones((b,))
        )
    return loss


def loss_saliency(outputs, targets, cfg: LossConfig):
    """Composite saliency loss over both channels (model.py:348-643)."""
    labels = targets["saliency_all_labels"]
    valid = outputs["video_msk"].to(outputs["saliency_scores"].dtype)
    pos_idx = targets["saliency_pos_labels"]
    neg_idx = targets["saliency_neg_labels"]
    have_neg = "saliency_scores_neg" in outputs
    real_neg = outputs.get("real_neg_mask") if have_neg else None
    npw = 0.0 if cfg.dset_name == "youtube_uni" else 1.0  # model.py:441-444

    sal = _saliency_channel(
        outputs["saliency_scores"], outputs.get("saliency_scores_neg"), labels, valid,
        real_neg, pos_idx, neg_idx, cfg.saliency_margin, npw, neg_is_prob=False,
    )
    attn = _saliency_channel(
        outputs["t2vattnvalues"], outputs.get("t2vattnvalues_neg"), labels, valid,
        real_neg, pos_idx, neg_idx, cfg.saliency_margin, npw, neg_is_prob=True,
        include_false_neg_rank=not have_neg,
    )
    # BCE of the attention channel against binarized saliency, unmasked over
    # the padded length as in the reference (model.py:538-542)
    probs = outputs["t2vattnvalues"].clamp(1e-7, 1 - 1e-7)
    binary = labels.clamp(0.0, 1.0)
    bce = -(binary * torch.log(probs) + (1 - binary) * torch.log(1 - probs)).mean()
    return sal + cfg.lw_wattn * (attn + bce)


def loss_label(outputs, targets):
    """SetCriterion.loss_labels (model.py:339-346)."""
    sal = targets["saliency_all_labels"]
    conf = outputs["out_class"][:, : sal.shape[1], 0]

    def norm(x):
        return (x - x.amin()) / (x.amax() - x.amin())

    return ((norm(sal) - norm(conf)) ** 2).mean()


def assign_targets(points, gt_bnd, sample_radius):
    """Anchor-point target assignment, batched (reference loss.py:214-267).
    points (N, 4) rows (center, reg_min, reg_max, stride) in clip units;
    gt_bnd (B, M, 2) in clip units, +inf padded. Returns cls_tgt (B, N) in
    {0, 1} and reg_tgt (B, N, 2), stride-normalized offsets."""
    center = points[:, 0][None, :, None]
    stride = points[:, 3][None, :, None]
    gt_valid = torch.isfinite(gt_bnd).all(-1)  # (B, M)
    big = 1e9  # a finite stand-in for padded rows: no inf - inf
    gs = torch.where(gt_valid[:, None, :], gt_bnd[:, None, :, 0], big)
    ge = torch.where(gt_valid[:, None, :], gt_bnd[:, None, :, 1], big)
    s = center - gs  # (B, N, M)
    e = ge - center
    inf = torch.full_like(gt_bnd[..., 0], float("inf"))
    lens = torch.where(gt_valid, gt_bnd[..., 1] - gt_bnd[..., 0], inf)
    lens = lens[:, None, :].expand_as(s)
    if sample_radius > 0:
        gc = (gs + ge) / 2
        t_min = gc - stride * sample_radius
        t_max = gc + stride * sample_radius
        dist_s = center - torch.maximum(t_min, gs)
        dist_e = torch.minimum(t_max, ge) - center
        cls_msk = torch.minimum(dist_s, dist_e) >= 0
    else:
        cls_msk = torch.minimum(s, e) >= 0
    reg_dist = torch.maximum(s, e)
    reg_msk = (reg_dist >= points[None, :, 1, None]) & (reg_dist <= points[None, :, 2, None])
    lens = torch.where(cls_msk & reg_msk & gt_valid[:, None, :], lens, float("inf"))
    min_len, min_idx = lens.min(dim=2)
    matched = (lens <= min_len[..., None] + 1e-3) & torch.isfinite(lens)
    cls_tgt = matched.sum(dim=2).clamp(0, 1).to(points.dtype)
    r_all = torch.stack([s, e], dim=-1)  # (B, N, M, 2)
    idx = min_idx[..., None, None].expand(-1, -1, 1, 2)
    reg_tgt = torch.gather(r_all, 2, idx)[:, :, 0] / stride
    return cls_tgt, reg_tgt


def _pred_gt_iou(points, reg_pred, reg_tgt):
    """Per-point IoU between decoded pred and GT boxes (loss.py:269-300)."""
    center = points[None, :, 0]
    stride = points[None, :, 3]
    ps = center - reg_pred[..., 0] * stride
    pe = center + reg_pred[..., 1] * stride
    gs = center - reg_tgt[..., 0] * stride
    ge = center + reg_tgt[..., 1] * stride
    inter = (torch.minimum(pe, ge) - torch.maximum(ps, gs)).clamp(min=0)
    union = (torch.maximum(pe, ge) - torch.minimum(ps, gs)).clamp(min=1e-6)
    return inter / union


def bundle_losses(outputs, targets, cfg: LossConfig) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    points = outputs["point"]
    src = outputs["out_class"][..., 0]
    msk = torch.cat(outputs["pymid_msk"], dim=1).to(src.dtype)
    cls_tgt = reg_tgt = None
    if cfg.loss_reg is not None or cfg.loss_qfl:
        gt_clip = targets["gt_windows"] * (1.0 / cfg.clip_length)  # * fps
        cls_tgt, reg_tgt = assign_targets(points.to(src.dtype), gt_clip, cfg.sample_radius)
    if cfg.loss_reg == "l1":
        w = cls_tgt[..., None].expand(-1, -1, 2)
        out["loss_reg"] = l1_loss(outputs["out_coord"], reg_tgt, weight=w, avg_factor=w.sum())
    if cfg.loss_reg is None:
        cls_tgt = targets["saliency_all_labels"]

    if cfg.loss_cls == "focal":
        out["loss_cls"] = sigmoid_focal_loss(src, cls_tgt, weight=msk, avg_factor=msk.sum())
    elif cfg.loss_cls == "dynamic_bce":
        # HD path: out_class covers the stride-1 level only
        n = min(src.shape[1], cls_tgt.shape[1])
        out["loss_cls"] = dynamic_bce_loss(
            src[:, :n], cls_tgt[:, :n], weight=msk[:, :n], avg_factor=msk[:, :n].sum()
        )
    if cfg.loss_sal == "nce":
        out["loss_sal"] = sampled_nce_loss(
            outputs["nce_sim"], outputs["video_msk"].to(src.dtype),
            targets["saliency_all_labels"], targets["saliency_pos_labels"][:, 0],
            direction=cfg.nce_direction,
        )
    if cfg.loss_qfl:
        score = _pred_gt_iou(points.to(src.dtype), outputs["out_coord"], reg_tgt)
        out["loss_qfl"] = quality_focal_loss(src, cls_tgt, score, weight=msk,
                                             avg_factor=msk.sum())
    return out


def row_reductions(outputs, targets, cfg: LossConfig) -> Dict[str, torch.Tensor]:
    """What the criterion reads of one row at a time, reduced on that row:
    "nce_sim", the sampled NCE's logits (B, Lv), in place of video_emb (B,
    Lv, D) and query_emb. A split batch reduces its own rows before the
    batch is gathered (losses/__init__.py)."""
    if cfg.loss_sal != "nce":
        return {}
    return {"nce_sim": nce_similarity(outputs["video_emb"], outputs["query_emb"])}


def compute_losses(outputs, targets, cfg: LossConfig) -> Dict[str, torch.Tensor]:
    """The loss dict of a forward's outputs."""
    return batch_losses({**outputs, **row_reductions(outputs, targets, cfg)}, targets, cfg)


def batch_losses(outputs, targets, cfg: LossConfig) -> Dict[str, torch.Tensor]:
    """The loss dict of outputs that hold `row_reductions`' keys."""
    losses = bundle_losses(outputs, targets, cfg)
    losses["loss_label"] = loss_label(outputs, targets)
    losses["loss_saliency"] = loss_saliency(outputs, targets, cfg)
    return losses


def loss_keys(cfg: LossConfig) -> Tuple[str, ...]:
    """The sorted key set `compute_losses` produces for `cfg`."""
    keys = ["loss_label", "loss_saliency"]
    if cfg.loss_reg == "l1":
        keys.append("loss_reg")
    if cfg.loss_cls in ("focal", "dynamic_bce"):
        keys.append("loss_cls")
    if cfg.loss_sal == "nce":
        keys.append("loss_sal")
    if cfg.loss_qfl:
        keys.append("loss_qfl")
    return tuple(sorted(keys))


def weighted_total(losses: Dict[str, torch.Tensor], cfg: LossConfig):
    """Weighted sum over the reference weight_dict keys (train.py:62-64);
    keys outside it (loss_qfl) are logged, not optimized."""
    weights = {
        "loss_label": cfg.label_loss_coef,
        "loss_saliency": cfg.lw_saliency,
        "loss_reg": cfg.lw_reg,
        "loss_cls": cfg.lw_cls,
        "loss_sal": cfg.lw_sal,
    }
    return sum(losses[k] * w for k, w in weights.items() if k in losses)


def criterion(cfg: LossConfig, outputs, targets) -> Dict[str, torch.Tensor]:
    """The loss dict of a forward's outputs, with the weighted total."""
    losses = compute_losses(outputs, targets, cfg)
    losses["weighted_loss_overall"] = weighted_total(losses, cfg)
    return losses
