"""Batched temporal non-maximum suppression in plain torch.

Counterpart of flashvtg_tpu/ops/nms.py (`temporal_nms_scores` vmapped by
`suppress_overlaps`). The JAX side runs it as jnp, not Pallas; here it is N
greedy steps over the whole batch at once, on whatever device the inputs
live on. Semantics (reference inference.py:36-57 `post_processing_mr_nms`):
repeat N times, pick the highest-scoring unprocessed window (first index on
ties) and mark it processed; then zero every unprocessed window with
IoU >= thd ("normal"), or scale every unprocessed window by (1 - IoU)
("linear"). Suppressed windows keep score 0 and sink in the final stable
descending sort.
"""

from __future__ import annotations

import torch

from flashvtg_tpu_torch.ops.span import temporal_iou

NEG = -1e18


def temporal_nms_scores(spans, scores, nms_thd, nms_type: str = "normal"):
    """Greedy NMS scores for a batch: spans (B, N, 2), scores (B, N) ->
    suppressed scores (B, N) in input row order."""
    if nms_type not in ("normal", "linear"):
        raise ValueError(f"Unknown nms_type: {nms_type}")
    b, n = scores.shape
    iou = temporal_iou(spans, spans)  # (B, N, N)
    scores = scores.float()
    processed = torch.zeros((b, n), dtype=torch.bool, device=scores.device)
    cols = torch.arange(n, device=scores.device)[None, :]
    zero = scores.new_tensor(0.0)
    for _ in range(n):
        cand = torch.where(processed, scores.new_tensor(NEG), scores)
        pick = torch.argmax(cand, dim=1)  # first maximal index
        row = torch.gather(iou, 1, pick[:, None, None].expand(b, 1, n))[:, 0]
        remaining = ~processed & (cols != pick[:, None])
        if nms_type == "normal":
            scores = torch.where((row >= nms_thd) & remaining, zero, scores)
        else:
            scores = torch.where(remaining, scores * (1.0 - row), scores)
        processed = processed.scatter(1, pick[:, None], True)
    return scores


def suppress_overlaps(spans, scores, nms_thd, nms_type: str = "normal"):
    """Batched NMS + stable descending re-sort: (B, N, 2), (B, N) ->
    (spans_sorted, scores_sorted); equal scores keep input order."""
    new_scores = temporal_nms_scores(spans, scores, nms_thd, nms_type)
    scores_sorted, order = torch.sort(new_scores, dim=-1, descending=True, stable=True)
    spans_sorted = torch.gather(spans, 1, order[..., None].expand(-1, -1, 2))
    return spans_sorted, scores_sorted
