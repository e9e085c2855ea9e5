"""Temporal-span math on torch tensors (counterpart of flashvtg_tpu/ops/span.py).

Operates on float tensors whose last axis is a [start, end] or
[center, width] pair (reference span_utils.py).
"""

from __future__ import annotations

import torch


def span_xx_to_cxw(spans):
    """(..., 2) [st, ed] -> (..., 2) [center, width]."""
    center = (spans[..., 0] + spans[..., 1]) * 0.5
    width = spans[..., 1] - spans[..., 0]
    return torch.stack([center, width], dim=-1)


def span_cxw_to_xx(spans):
    """(..., 2) [center, width] -> (..., 2) [st, ed]."""
    st = spans[..., 0] - 0.5 * spans[..., 1]
    ed = spans[..., 0] + 0.5 * spans[..., 1]
    return torch.stack([st, ed], dim=-1)


def temporal_iou_and_union(spans1, spans2):
    """Pairwise IoU and union, (..., N, M) each. Zero-union pairs give
    inf/nan as in the reference (no epsilon)."""
    areas1 = spans1[..., 1] - spans1[..., 0]
    areas2 = spans2[..., 1] - spans2[..., 0]
    left = torch.maximum(spans1[..., :, None, 0], spans2[..., None, :, 0])
    right = torch.minimum(spans1[..., :, None, 1], spans2[..., None, :, 1])
    inter = (right - left).clamp_min(0)
    union = areas1[..., :, None] + areas2[..., None, :] - inter
    return inter / union, union


def temporal_iou(spans1, spans2):
    return temporal_iou_and_union(spans1, spans2)[0]


def generalized_temporal_iou(spans1, spans2):
    """Pairwise 1-D gIoU, (..., N, M)."""
    iou, union = temporal_iou_and_union(spans1, spans2)
    left = torch.minimum(spans1[..., :, None, 0], spans2[..., None, :, 0])
    right = torch.maximum(spans1[..., :, None, 1], spans2[..., None, :, 1])
    enclosing = (right - left).clamp_min(0)
    return iou - (enclosing - union) / enclosing
