"""Moment-retrieval and highlight-detection metric suite.

Counterpart of flashvtg_tpu/eval/metrics.py (reference
standalone_eval/eval.py and utils.py). As in the JAX package, the per-query
APs run in the native batched kernels of the host runtime
(flashvtg_tpu_torch/runtime: mr_ap_batch for every query of compute_mr_ap,
one hl_ap_batch call for eval_highlight). `detection_ap` and
`binary_ap_columns` are the plain numpy versions those kernels are
bit-identical to: detection_ap scores the queries mr_ap_batch declines, and
the tests hold the kernels against both.

  * MR mAP: VOC-interpolated detection AP per query at IoU 0.5:0.05:0.95,
    for GT-length buckets short (0,10] / middle (10,30] / long (30,150] /
    full.
  * MR R1@thd: share of queries whose top-1 window reaches IoU >= thd with
    the best-matching GT window, 0.3:0.05:0.95; plus mIoU.
  * HL mAP / HIT@1 at min worker scores Fair(2) / Good(3) / VeryGood(4).

Each `eval_submission` call is the root span `eval.metrics`
(utils/observability.py; recorded while a torch profiler records).
"""

from __future__ import annotations

from collections import OrderedDict, defaultdict
from typing import Dict, List, Sequence

import numpy as np

from flashvtg_tpu_torch import runtime
from flashvtg_tpu_torch.utils import observability as obs

MR_AP_THDS = tuple(float(f"{e:.2f}") for e in np.linspace(0.5, 0.95, 10))
MR_R1_THDS = tuple(float(f"{e:.2f}") for e in np.linspace(0.3, 0.95, 14))


def _round2(x) -> float:
    """The reference's `float(f"{100 * v:.2f}")` rounding."""
    return float(f"{100 * x:.2f}")


def iou_cross(spans1: np.ndarray, spans2: np.ndarray) -> np.ndarray:
    """(N, 2) x (M, 2) -> (N, M) pairwise temporal IoU."""
    areas1 = spans1[:, 1] - spans1[:, 0]
    areas2 = spans2[:, 1] - spans2[:, 0]
    left = np.maximum(spans1[:, None, 0], spans2[None, :, 0])
    right = np.minimum(spans1[:, None, 1], spans2[None, :, 1])
    inter = np.clip(right - left, 0, None)
    union = areas1[:, None] + areas2[None, :] - inter
    return inter / union


def iou_paired(pred: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """(N, 2) x (N, 2) -> (N,) rowwise IoU; the denominator is
    span(min start, max end), as in the reference's utils.py:15-31."""
    inter = np.maximum(
        0, np.minimum(pred[:, 1], gt[:, 1]) - np.maximum(pred[:, 0], gt[:, 0])
    )
    union = np.maximum(pred[:, 1], gt[:, 1]) - np.minimum(pred[:, 0], gt[:, 0])
    return np.divide(inter, union, out=np.zeros_like(inter), where=union != 0)


def _voc_interp_ap(precision: np.ndarray, recall: np.ndarray) -> float:
    """VOC-2011 interpolated AP (reference utils.py:64-80)."""
    mprec = np.concatenate([[0.0], precision, [0.0]])
    mrec = np.concatenate([[0.0], recall, [1.0]])
    mprec = np.maximum.accumulate(mprec[::-1])[::-1]
    idx = np.where(mrec[1:] != mrec[:-1])[0] + 1
    return float(np.sum((mrec[idx] - mrec[idx - 1]) * mprec[idx]))


def detection_ap(
    gt_windows: np.ndarray,
    pred_windows: np.ndarray,
    pred_scores: np.ndarray,
    thresholds: Sequence[float] = MR_AP_THDS,
) -> np.ndarray:
    """AP of one query's ranked windows vs its GT set: greedy one-to-one
    matching in descending score order with per-threshold GT locking
    (reference utils.py:83-166). Returns (num_thresholds,) AP values."""
    num_thds = len(thresholds)
    num_gts = len(gt_windows)
    num_preds = len(pred_windows)
    ap = np.zeros(num_thds)
    if num_preds == 0:
        return ap

    order = np.argsort(-pred_scores, kind="stable")
    pred_windows = pred_windows[order]

    tp = np.zeros((num_thds, num_preds))
    fp = np.zeros((num_thds, num_preds))
    locked = np.full((num_thds, num_gts), -1)

    if num_gts == 0:
        fp[:] = 1
    else:
        iou = iou_cross(pred_windows, gt_windows)  # (P, G)
        for p in range(num_preds):
            # descending IoU; ties resolved as argsort()[::-1]
            by_iou = np.argsort(iou[p])[::-1]
            for t, thd in enumerate(thresholds):
                assigned = False
                for g in by_iou:
                    if iou[p, g] < thd:
                        fp[t, p] = 1
                        assigned = True
                        break
                    if locked[t, g] >= 0:
                        continue
                    tp[t, p] = 1
                    locked[t, g] = p
                    assigned = True
                    break
                if not assigned:
                    fp[t, p] = 1

    tp_cum = np.cumsum(tp, axis=1).astype(np.float64)
    fp_cum = np.cumsum(fp, axis=1).astype(np.float64)
    recall = tp_cum / float(num_gts)
    precision = tp_cum / (tp_cum + fp_cum)
    for t in range(num_thds):
        ap[t] = _voc_interp_ap(precision[t], recall[t])
    return ap


def _score_order(y_score: np.ndarray):
    """(descending-score order, threshold indices into the sorted scores)."""
    order = np.argsort(-y_score, kind="mergesort")
    sorted_scores = y_score[order]
    distinct = np.where(np.diff(sorted_scores))[0]
    thd_idx = np.concatenate([distinct, [len(sorted_scores) - 1]])
    return order, thd_idx


def _pr_from_sorted(y_true_sorted: np.ndarray, thd_idx: np.ndarray):
    """(precision, recall) from labels already in descending-score order
    (a replica of sklearn's precision_recall_curve for binary labels)."""
    tps = np.cumsum(y_true_sorted)[thd_idx]
    fps = 1 + thd_idx - tps
    precision = tps / (tps + fps)
    recall = tps / tps[-1] if tps[-1] > 0 else np.zeros_like(tps)
    sl = slice(None, None, -1)
    return (
        np.concatenate([precision[sl], [1.0]]),
        np.concatenate([recall[sl], [0.0]]),
    )


def _ap_from_pr(precision, recall) -> float:
    recall = recall.astype(np.float32)
    precision = np.maximum.accumulate(precision)
    indices = np.where(np.diff(recall))
    return float(np.mean(precision[indices]))


def binary_ap_columns(y_true_mat: np.ndarray, y_score: np.ndarray) -> np.ndarray:
    """Interpolated binary AP (reference utils.py:169-209 `get_ap`) for K
    label columns ranked by one score vector, sorting once."""
    y_true_mat = np.asarray(y_true_mat, np.float64)
    order, thd_idx = _score_order(np.asarray(y_score, np.float64))
    sorted_mat = y_true_mat[:, order]
    out = np.zeros(y_true_mat.shape[0])
    for k in range(y_true_mat.shape[0]):
        col = y_true_mat[k]
        if not (col != col.flat[0]).any():  # single-valued label column
            out[k] = 0 if col.flat[0] == 0 else 1
            continue
        precision, recall = _pr_from_sorted(sorted_mat[k], thd_idx)
        out[k] = _ap_from_pr(precision, recall)
    return out


def compute_mr_ap(submission, ground_truth, max_pred_windows: int = 10):
    pred_by_qid = {}
    for d in submission:
        wins = np.asarray(d["pred_relevant_windows"], dtype=np.float64)
        if max_pred_windows is not None:
            wins = wins[:max_pred_windows]
        pred_by_qid[d["qid"]] = wins
    gt_by_qid = defaultdict(list)
    for d in ground_truth:
        gt_by_qid[d["qid"]].extend(d["relevant_windows"])

    qids = list(pred_by_qid)
    preds_list = [
        w.reshape(-1, w.shape[-1])[:, :3] if w.size else np.zeros((0, 3))
        for w in (pred_by_qid[q] for q in qids)
    ]
    gts_list = [np.asarray(gt_by_qid[q], dtype=np.float64).reshape(-1, 2) for q in qids]
    # every query through the native kernel; the rows it declines (G == 0,
    # G > 15, P > 126) through detection_ap
    ap_mat, handled = runtime.mr_ap_batch(preds_list, gts_list, MR_AP_THDS)
    for i in np.flatnonzero(~handled):
        wins, gts = preds_list[i], gts_list[i]
        if len(wins):
            ap_mat[i] = detection_ap(gts, wins[:, :2], wins[:, 2])
    ap_thds = ap_mat.mean(0)
    out = {str(t): v for t, v in zip(MR_AP_THDS, ap_thds)}
    out["average"] = float(np.mean(ap_thds))
    return {k: _round2(v) for k, v in out.items()}


def compute_mr_r1(submission, ground_truth):
    pred_top1 = {d["qid"]: d["pred_relevant_windows"][0][:2] for d in submission}
    gt_best = {}
    for d in ground_truth:
        windows = d["relevant_windows"]
        best = 0
        if len(windows) > 0:
            ious = iou_cross(
                np.asarray([pred_top1[d["qid"]]], dtype=np.float64),
                np.asarray(windows, dtype=np.float64),
            )[0]
            best = int(np.argmax(ious))
        gt_best[d["qid"]] = windows[best]

    qids = list(pred_top1.keys())
    pred = np.asarray([pred_top1[q] for q in qids], dtype=np.float64)
    gt = np.asarray([gt_best[q] for q in qids], dtype=np.float64)
    paired = iou_paired(pred, gt)
    miou = _round2(float(np.mean(paired)))
    r1 = {str(t): _round2(float(np.mean(paired >= t))) for t in MR_R1_THDS}
    return r1, miou


_LENGTH_RANGES = ((0, 10), (10, 30), (30, 150), (0, 150))
_RANGE_NAMES = ("short", "middle", "long", "full")


def _filter_by_gt_length(submission, ground_truth, min_l, max_l):
    """Keep GT windows with length in (min_l, max_l] and matching submissions."""
    if min_l == 0 and max_l == 150:
        return submission, ground_truth
    gt_kept, qids = [], set()
    for d in ground_truth:
        wins = [w for w in d["relevant_windows"] if min_l < (w[1] - w[0]) <= max_l]
        if wins:
            gt_kept.append({**d, "relevant_windows": wins})
            qids.add(d["qid"])
    return [d for d in submission if d["qid"] in qids], gt_kept


def eval_moment_retrieval(submission, ground_truth):
    out = {}
    for (lo, hi), name in zip(_LENGTH_RANGES, _RANGE_NAMES):
        sub, gt = _filter_by_gt_length(submission, ground_truth, lo, hi)
        if len(gt) == 0:
            dummy = {str(k): 0.0 for k in np.linspace(0.5, 0.95, 19)}
            dummy["average"] = 0.0
            out[name] = {"MR-mAP": dummy, "MR-R1": dummy}
            continue
        ap = compute_mr_ap(sub, gt)
        r1, miou = compute_mr_r1(sub, gt)
        out[name] = {"MR-mIoU": miou, "MR-mAP": ap, "MR-R1": r1}
    return out


def make_gt_saliency(gt_row: dict, clip_length: float = 2) -> np.ndarray:
    """Dense (num_clips, 3) worker saliency scores from sparse annotations."""
    num_clips = int(gt_row["duration"] / clip_length)
    dense = np.zeros((num_clips, 3))
    dense[np.asarray(gt_row["relevant_clip_ids"])] = np.asarray(gt_row["saliency_scores"])
    return dense


_HL_THRESHOLDS = ((2, "Fair"), (3, "Good"), (4, "VeryGood"))


def eval_highlight(submission, ground_truth):
    preds = {d["qid"]: d for d in submission}
    gt_dense = {d["qid"]: make_gt_saliency(d) for d in ground_truth}
    n_thd = len(_HL_THRESHOLDS)
    hits = np.zeros((n_thd, len(preds), 3))
    ap_scores = np.zeros((n_thd, len(preds), 3))
    scores_list, labels_list = [], []
    for i, (qid, d) in enumerate(preds.items()):
        scores = np.asarray(d["pred_saliency_scores"])
        top = int(np.argmax(scores))
        dense = gt_dense[qid]  # (num_clips, 3 workers)
        y_pred = scores
        if len(dense) < len(y_pred):
            y_pred = y_pred[: len(dense)]
        elif len(dense) > len(y_pred):
            y_pred = np.concatenate([y_pred, np.zeros(len(dense) - len(y_pred))])
        cols = []
        for t, (min_score, _) in enumerate(_HL_THRESHOLDS):
            gt_bin = (dense >= min_score).astype(float)
            if top < len(gt_bin):  # HIT@1: top clip positive for any worker
                hits[t, i] = gt_bin[top]
            cols.append(gt_bin.T)  # (3 workers, num_clips)
        scores_list.append(np.asarray(y_pred, np.float64))
        labels_list.append(np.concatenate(cols, axis=0))
    # the 9 (threshold x worker) AP columns of every query in one native call
    if preds:
        ap = runtime.hl_ap_batch(scores_list, labels_list)
        ap_scores = ap.reshape(len(preds), n_thd, 3).transpose(1, 0, 2)
    out = {}
    for t, (_, name) in enumerate(_HL_THRESHOLDS):
        out[f"HL-min-{name}"] = {
            "HL-mAP": float(f"{100 * np.mean(ap_scores[t]):.2f}"),
            "HL-Hit1": float(f"{100 * np.mean(np.max(hits[t], 1)):.2f}"),
        }
    return out


@obs.root("eval.metrics")
def eval_submission(submission, ground_truth, verbose=False, match_number=True):
    """Full metric dict with a sorted "brief" block (reference eval.py:271-344).
    `verbose` is accepted for call compatibility and prints nothing."""
    pred_qids = {e["qid"] for e in submission}
    gt_qids = {e["qid"] for e in ground_truth}
    if match_number:
        assert pred_qids == gt_qids, (
            "qids in ground_truth and submission must match. "
            "use `match_number=False` if you wish to disable this check"
        )
    else:
        shared = pred_qids & gt_qids
        submission = [e for e in submission if e["qid"] in shared]
        ground_truth = [e for e in ground_truth if e["qid"] in shared]

    metrics: Dict[str, dict] = {}
    brief = OrderedDict()
    if "pred_relevant_windows" in submission[0]:
        mr = eval_moment_retrieval(submission, ground_truth)
        metrics.update(mr)
        mr_brief = {
            "MR-full-mAP": mr["full"]["MR-mAP"]["average"],
            "MR-full-mAP@0.5": mr["full"]["MR-mAP"]["0.5"],
            "MR-full-mAP@0.75": mr["full"]["MR-mAP"]["0.75"],
            "MR-short-mAP": mr["short"]["MR-mAP"]["average"],
            "MR-middle-mAP": mr["middle"]["MR-mAP"]["average"],
            "MR-long-mAP": mr["long"]["MR-mAP"]["average"],
            "MR-full-mIoU": mr["full"]["MR-mIoU"],
            "MR-full-R1@0.3": mr["full"]["MR-R1"]["0.3"],
            "MR-full-R1@0.5": mr["full"]["MR-R1"]["0.5"],
            "MR-full-R1@0.7": mr["full"]["MR-R1"]["0.7"],
        }
        brief.update(sorted(mr_brief.items(), key=lambda x: x[0]))

    if "pred_saliency_scores" in submission[0]:
        hl = eval_highlight(submission, ground_truth)
        metrics.update(hl)
        brief.update(
            (f"{k}-{sub_k.split('-')[1]}", v[sub_k])
            for k, v in hl.items()
            for sub_k in v
        )

    final = OrderedDict()
    final["brief"] = brief
    final.update(sorted(metrics.items(), key=lambda x: x[0]))
    return final
