"""Elementary loss primitives (torch, mask/avg_factor-reduced).

Counterpart of flashvtg_tpu/losses/basic.py (reference blocks/loss.py and
blocks/utils.py, plus the nncore losses FocalLoss, L1Loss and
DynamicBCELoss in their mmdet formulations); the quality and distribution
focal losses serve the FlashVTG_ms criterion (losses/criterion_ms.py).
"""

from __future__ import annotations

import math

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
    Masked clips get -1e30, not -inf, as the JAX package (a column masked
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
