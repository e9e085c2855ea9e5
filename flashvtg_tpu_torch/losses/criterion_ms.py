"""The FlashVTG_ms criterion.

Counterpart of flashvtg_tpu/losses/criterion_ms.py (reference
FlashVTG_ms/loss.py SetCriterion): margin ranking + rank-contrastive +
negative-pair BCE over the real-negative rows only (no false-negative
branches, unlike the core criterion), focal classification with alpha = -1,
L1 or distribution-focal (DFL) regression, the similarity-score sampled NCE,
the phrase-slot orthogonality, the quality focal loss (computed, weight 0)
and, under use_eos, the EOS InfoNCE. Targets as losses/criterion.py's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from flashvtg_tpu_torch.losses.basic import (
    bce_with_logits,
    distribution_focal_loss,
    quality_focal_loss,
)
from flashvtg_tpu_torch.losses.criterion import (
    _masked_scores,
    assign_targets,
    margin_pair_loss,
    rank_contrastive_loss,
)


@dataclasses.dataclass(frozen=True)
class MSLossConfig:
    """Weights and switches of the _ms criterion (mirror of the JAX one)."""

    label_loss_coef: float = 4.0
    lw_saliency: float = 0.1
    lw_reg: float = 0.2
    lw_cls: float = 1.0
    lw_sal: float = 0.1
    lw_phrase: float = 1.0
    lw_wattn: float = 1.0
    saliency_margin: float = 0.2
    sample_radius: float = 1.5
    use_dfl: bool = False
    num_bins: int = 16
    clip_length: float = 2.0
    dset_name: str = "tvsum"
    phrase_ortho_r: float = 0.5
    use_eos: bool = False
    lw_eos: float = 1.0


def ms_targets(points, gt_windows, cfg: MSLossConfig):
    """(cls_tgt, reg_tgt) of losses/criterion.py:assign_targets; with DFL
    the offsets are quantised to bin units (reference loss.py:328-333)."""
    cls_tgt, reg_tgt = assign_targets(points, gt_windows * (1.0 / cfg.clip_length),
                                      cfg.sample_radius)
    if cfg.use_dfl:
        bin_size = cfg.sample_radius / (cfg.num_bins - 1)
        reg_tgt = reg_tgt.clamp(0.0, cfg.sample_radius - 1e-8) / bin_size
        reg_tgt = torch.where(reg_tgt >= cfg.num_bins - 1, reg_tgt - 1e-3, reg_tgt)
    return cls_tgt, reg_tgt


def loss_cls_ms(out_class, cls_tgt, pymid_msk):
    """Focal loss with alpha = -1 (no class balance), loss.py:566-585."""
    pred = out_class[..., 0]
    msk = torch.cat(pymid_msk, dim=1).to(pred.dtype)
    p = torch.sigmoid(pred)
    pt = p * cls_tgt + (1 - p) * (1 - cls_tgt)
    loss = bce_with_logits(pred, cls_tgt) * (1 - pt) ** 2.0
    return (loss * msk).sum() / msk.sum()


def loss_reg_ms(out_coord, cls_tgt, reg_tgt, cfg: MSLossConfig):
    """L1 over the positive points, or DFL of each side's bin logits."""
    if not cfg.use_dfl:
        msk = cls_tgt[..., None].expand(-1, -1, 2)
        diff = (out_coord - reg_tgt).abs() * msk
        return diff.sum() / msk.sum().clamp_min(1.0)
    nb = cfg.num_bins
    ls = distribution_focal_loss(out_coord[..., :nb], reg_tgt[..., 0], weight=cls_tgt,
                                 avg_factor=cls_tgt.sum())
    le = distribution_focal_loss(out_coord[..., nb:], reg_tgt[..., 1], weight=cls_tgt,
                                 avg_factor=cls_tgt.sum())
    return (ls + le) * 0.5


def loss_sal_ms(sim_score, video_msk, saliency, pos_clip, temperature=0.07,
                max_scale=100.0):
    """Similarity-score sampled NCE (loss.py:138-188; the cosine is the
    model's sim_score), masked clips at -1e30 as losses/basic.py's."""
    b = sim_score.shape[0]
    rows = torch.arange(b, device=sim_score.device)
    pos_scores = saliency[rows, pos_clip][:, None]
    loss_msk = (saliency <= pos_scores).to(video_msk.dtype) * video_msk
    scale = min(math.exp(math.log(1.0 / temperature)), max_scale)
    i_sim = sim_score * scale + torch.where(loss_msk > 0, 0.0, -1e30).to(sim_score.dtype)
    loss = -F.log_softmax(i_sim, dim=1)[rows, pos_clip].sum() / b
    return loss - F.log_softmax(i_sim.T, dim=1)[pos_clip, rows].sum() / b


def loss_phrase_slot(slot_att, r=0.5):
    """Orthogonality of the slots' attention maps (loss.py:417-429)."""
    n = slot_att.shape[1]
    eye = torch.eye(n, dtype=slot_att.dtype, device=slot_att.device)[None] * r
    gram = torch.einsum("bnl,bml->bnm", slot_att, slot_att)
    p = torch.sqrt(((gram - eye) ** 2).sum(dim=(1, 2)).clamp_min(1e-12))
    return (p ** 2).mean()


def loss_qfl_ms(outputs, cls_tgt, reg_tgt, cfg: MSLossConfig):
    """Quality focal loss against the IoU of the decoded and the target
    boxes; with DFL the offsets are the expectation over the bin indices
    (not the bin centres), as the reference has it."""
    points = outputs["point"]
    msk = torch.cat(outputs["pymid_msk"], dim=1).to(outputs["out_class"].dtype)
    center = points[None, :, 0]
    stride = points[None, :, 3]
    coord = outputs["out_coord"]
    if cfg.use_dfl:
        nb = cfg.num_bins
        bins = torch.arange(nb, dtype=coord.dtype, device=coord.device)
        start = (torch.softmax(coord[..., :nb], -1) * bins).sum(-1)
        end = (torch.softmax(coord[..., nb:], -1) * bins).sum(-1)
    else:
        start, end = coord[..., 0], coord[..., 1]
    ps, pe = center - start * stride, center + end * stride
    gs = center - reg_tgt[..., 0] * stride
    ge = center + reg_tgt[..., 1] * stride
    inter = (torch.minimum(pe, ge) - torch.maximum(ps, gs)).clamp(min=0)
    union = (torch.maximum(pe, ge) - torch.minimum(ps, gs)).clamp(min=1e-6)
    return quality_focal_loss(outputs["out_class"][..., 0], cls_tgt, inter / union,
                              weight=msk, avg_factor=msk.sum())


def loss_eos_ms(eos_slot, eos_emb, context_agg, pos_clip, temperature=0.1):
    """EOS InfoNCE (reference FlashVTG_ms/loss.py:431-460): over l2-normalised
    vectors at temperature 0.1, eos_slot[i] must retrieve eos_emb[i] among
    the batch, and its own video's first positive clip of context_agg.
    eos_slot, eos_emb (B, 1, C); context_agg (B, T, C); pos_clip (B,)."""

    def l2n(x):
        return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(1e-12)

    slot, emb = l2n(eos_slot[:, 0]), l2n(eos_emb[:, 0])
    rows = torch.arange(slot.shape[0], device=slot.device)
    loss_eos = -F.log_softmax(slot @ emb.T / temperature, dim=1)[rows, rows].mean()
    pos_feat = l2n(context_agg[rows, pos_clip])
    loss_pos = -F.log_softmax(slot @ pos_feat.T / temperature, dim=1)[rows, rows].mean()
    return loss_eos + loss_pos


def loss_saliency_ms(outputs, targets, cfg: MSLossConfig):
    """Both channels (encoder scores, t2v attention values) over the real
    negatives: margin (no x2 scale, loss.py:207-208), negative-pair BCE,
    rank-contrastive; and the attention channel's BCE against the binarised
    labels (loss.py:471-530)."""
    labels = targets["saliency_all_labels"]
    valid = outputs["video_msk"].to(outputs["saliency_scores"].dtype)
    pos_idx = targets["saliency_pos_labels"]
    neg_idx = targets["saliency_neg_labels"]
    real_neg = outputs["real_neg_mask"]
    n_real = real_neg.sum().clamp_min(1e-6)
    cat_valid = torch.cat([valid, valid], dim=1)
    cat_labels = torch.cat([labels, torch.zeros_like(labels)], dim=1)

    def channel(scores, scores_neg, neg_is_prob):
        prob_neg = scores_neg if neg_is_prob else torch.sigmoid(scores_neg)
        per_clip = -torch.log(torch.clamp(1.0 - prob_neg, min=1e-12))
        neg_pair = ((per_clip * valid).sum(1) * real_neg).sum() / n_real
        cat_scores = _masked_scores(torch.cat([scores, scores_neg], dim=1), cat_valid)
        rank = rank_contrastive_loss(cat_scores, cat_labels, cat_valid, real_neg)
        margin = margin_pair_loss(scores, pos_idx, neg_idx, cfg.saliency_margin) / 2.0
        return margin + neg_pair + rank

    sal = channel(outputs["saliency_scores"], outputs["saliency_scores_neg"], False)
    attn = channel(outputs["t2vattnvalues"], outputs["t2vattnvalues_neg"], True)
    probs = outputs["t2vattnvalues"].clamp(1e-7, 1 - 1e-7)
    binary = labels.clamp(0.0, 1.0)
    bce = -(binary * torch.log(probs) + (1 - binary) * torch.log(1 - probs)).mean()
    return sal + cfg.lw_wattn * (attn + bce)


def loss_label_ms(outputs, targets):
    sal = targets["saliency_all_labels"]
    conf = outputs["out_class"][:, : sal.shape[1], 0]

    def norm(x):
        return (x - x.amin()) / (x.amax() - x.amin())

    return ((norm(sal) - norm(conf)) ** 2).mean()


def compute_losses_ms(outputs, targets, cfg: MSLossConfig) -> Dict[str, torch.Tensor]:
    points = outputs["point"].to(outputs["out_class"].dtype)
    cls_tgt, reg_tgt = ms_targets(points, targets["gt_windows"], cfg)
    losses = {
        "loss_saliency": loss_saliency_ms(outputs, targets, cfg),
        "loss_label": loss_label_ms(outputs, targets),
        "loss_phrase_slot": loss_phrase_slot(outputs["slot_att"], cfg.phrase_ortho_r),
        "loss_sal": loss_sal_ms(
            outputs["sim_score"], outputs["video_msk"].to(outputs["sim_score"].dtype),
            targets["saliency_all_labels"], targets["saliency_pos_labels"][:, 0],
        ),
        "loss_reg": loss_reg_ms(outputs["out_coord"], cls_tgt, reg_tgt, cfg),
        "loss_cls": loss_cls_ms(outputs["out_class"], cls_tgt, outputs["pymid_msk"]),
        "loss_qfl": loss_qfl_ms(outputs, cls_tgt, reg_tgt, cfg),
    }
    if cfg.use_eos:
        losses["loss_eos"] = loss_eos_ms(
            outputs["eos_slot"], outputs["eos_emb"], outputs["context_agg"],
            targets["saliency_pos_labels"][:, 0],
        )
    return losses


def loss_keys_ms(cfg: MSLossConfig) -> Tuple[str, ...]:
    """The sorted key set `compute_losses_ms` produces for `cfg`."""
    keys = ["loss_saliency", "loss_label", "loss_phrase_slot", "loss_sal", "loss_reg",
            "loss_cls", "loss_qfl"] + (["loss_eos"] if cfg.use_eos else [])
    return tuple(sorted(keys))


def weighted_total_ms(losses: Dict[str, torch.Tensor], cfg: MSLossConfig):
    """The weighted sum; loss_qfl is in the reference's weight dict with
    weight 0 (model.py:431): computed and logged, never optimised."""
    weights = {
        "loss_label": cfg.label_loss_coef,
        "loss_saliency": cfg.lw_saliency,
        "loss_reg": cfg.lw_reg,
        "loss_cls": cfg.lw_cls,
        "loss_sal": cfg.lw_sal,
        "loss_phrase_slot": cfg.lw_phrase,
        "loss_qfl": 0.0,
        "loss_eos": cfg.lw_eos,
    }
    return sum(losses[k] * w for k, w in weights.items() if k in losses)
