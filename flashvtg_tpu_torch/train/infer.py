"""Batched inference: features -> ranked moments + saliency -> HD mAP.

Counterpart of flashvtg_tpu/train/infer.py (`make_eval_step`,
`run_mr_inference`, `apply_nms`, `run_hl_inference`). Forward, decode and
top-k run batched on the model's device; each batch is moved host ->
device, and host code only formats the jsonl rows, byte for byte as the JAX
package does (f64 4-decimal rounding, f32-noise NMS scores, parked pad
slots). With a `loss_cfg` and a labelled split, `run_mr_inference` also
evaluates the criterion on every batch (the forward with the negative pass,
`force_neg`) and returns its means over the split, weighted by rows, as the
reference logs eval losses (inference.py:300-306). The highlight-detection
sets (TVSum, YouTube-HL) take the saliency-only step, the forward with no
decode, and score the saliency with eval/hl.py's mAP. The FlashVTG_ms model
(models/flashvtg_ms.py) takes the same paths, with its own criterion for the
eval losses and, under use_dfl, the DFL decode. The forward runs at the
config's eval_precision (utils/runtime.py:matmul_precision, the counterpart
of the JAX step's jax.default_matmul_precision scope); its outputs are cast
to float32 before the decode, the criterion and NMS, which run in f32.

A batch costs one host-to-device copy, the step, and one device-to-host
copy. With a fixed video length the split's features go on the device once
(data/feed.py; `_maybe_device_feed`, gated by device_feed and its budget,
cached on the dataset; always float32), and a batch uploads its labels,
row indices and point mask alone (data/feed.py:upload, one pinned,
non-blocking copy); else the whole collated batch goes up in that one copy.
The packed step returns one (B, C) float32 tensor per batch (spans,
scores, saliency, the loss vector), copied without blocking into pinned
memory with a CUDA event; `_pipelined` keeps PIPELINE_DEPTH batches in
flight and waits on the oldest one's event only. The rows, rounding, NMS
and eval losses are those of one fetch per output.

Each inference call is the root span `eval.infer` (utils/observability.py;
recorded while a torch profiler records), with spans per batch, the batch
number their id: `eval.collate` (the dataset reads and the Collator),
`eval.dispatch` (masks, upload, feed gather, the forward's launches),
`eval.fetch_wait` (the host blocked on the batch's fetch) and `eval.rows`
(unpacking and formatting); and per call `eval.gather`, `eval.postprocess`
and `eval.nms`. Counters: `eval.batches`, and `eval.fetches` (the
device-to-host copies, one a batch).

Under a process group (parallel/mesh.py; the counterpart of the JAX
package's `_eval_shardings` / `_batch_putter`) the two inference loops deal
the split's batches to the ranks, batch i to rank i % world, each batch
whole on its rank (so a batch's arithmetic, its negative pass and its
eval losses are one process's); every rank reads every row in the
one-process order, so the per-access label draws are one process's. The
rows, saliencies and losses of the batches are then gathered to every
rank and put back in batch order: the submission and the loss sums are
byte for byte one process's, and every rank computes the same metrics
(train/loop.py:evaluate writes them on rank 0 alone).
"""

from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from flashvtg_tpu_torch.data.collate import MODEL_KEYS, TRAIN_KEYS, Collator
from flashvtg_tpu_torch.data.dataset import DataConfig, VTGDataset
from flashvtg_tpu_torch.data.feed import (
    build_device_feed,
    estimate_feed_bytes,
    gather_rows,
    resident_feed_bytes,
    upload,
)
from flashvtg_tpu_torch.eval.hl import compute_hl_map
from flashvtg_tpu_torch.eval.postprocess import build_post_processor
from flashvtg_tpu_torch.losses import criterion
from flashvtg_tpu_torch.models.points import pyramid_masks_strict
from flashvtg_tpu_torch.ops.nms import suppress_overlaps
from flashvtg_tpu_torch.parallel import mesh
from flashvtg_tpu_torch.utils import observability as obs
from flashvtg_tpu_torch.utils.runtime import check_precision, float32_outputs, matmul_precision

# batches in flight before the host waits on the oldest one's fetch
PIPELINE_DEPTH = 4


def eval_data_config(cfg, path: str, load_labels: bool = False) -> DataConfig:
    """Eval DataConfig of an ExperimentConfig (the JAX loop's _dataset_cfg
    with train=False): labels, for the eval losses, drawn from the config's
    seed when `load_labels`; no text-row dropout."""
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
        load_labels=load_labels,
        clip_len=cfg.clip_length,
        max_windows=cfg.max_windows,
        eos_first=cfg.eos_first,
        seed=cfg.seed,
    )


def make_eval_step(model, top_k: int, precision: str = "float32",
                   saliency_only: bool = False, loss_cfg=None, packed: bool = False):
    """step(batch, point_valid) -> (spans, scores, saliency, losses):
    forward + decode + rank for one batch of device tensors. `saliency_only`
    (the HD sets, which read only the saliency channel) skips the decode:
    spans and scores are then None. With `loss_cfg` the batch carries its
    labels (TRAIN_KEYS), the forward takes the negative pass too, and losses
    holds the criterion's batch means (0-d tensors, the weighted total
    included; the _ms criterion for an MSLossConfig); else it is {}. The
    model's own `decode` ranks the spans. `precision` is the forward's dial
    (float32, tensorfloat32 or bfloat16; anything else raises); the outputs
    leave it in float32.

    With `packed` the step returns one (B, C) float32 tensor instead,
    [spans 2K | scores K | saliency Lv | losses L (the same in every row)]
    (no spans and scores with `saliency_only`), so that a batch needs one
    fetch; `step.unpack(arr, lv)` takes the fetched array back apart into
    (spans, scores, saliency, {loss key: float}), the losses in the
    criterion's order (`step.loss_keys`, known after the first call)."""
    check_precision(precision)
    device = next(model.parameters()).device

    @torch.no_grad()
    def step(batch, point_valid):
        with matmul_precision(precision, device):
            out = model(
                batch["src_txt"], batch["src_txt_mask"], batch["src_vid"],
                batch["src_vid_mask"], point_valid=point_valid,
                real_neg_mask=batch.get("real_neg_mask"), force_neg=loss_cfg is not None,
            )
        out = float32_outputs(out)
        losses = criterion(loss_cfg, out, batch) if loss_cfg is not None else {}
        if saliency_only:
            return None, None, out["saliency_scores"], losses
        spans, scores = model.decode(out, point_valid, top_k)
        return spans, scores, out["saliency_scores"], losses

    if not packed:
        return step
    loss_keys: List[str] = []

    @torch.no_grad()
    def packed_step(batch, point_valid):
        spans, scores, sal, losses = step(batch, point_valid)
        b = sal.shape[0]
        parts = [] if saliency_only else [spans.reshape(b, -1), scores]
        parts.append(sal)
        if losses:
            loss_keys[:] = list(losses)
            vec = torch.stack([losses[k] for k in loss_keys]).float()
            parts.append(vec[None].expand(b, -1))
        return torch.cat([p.float() for p in parts], dim=1)

    def unpack(arr: np.ndarray, lv: int):
        off, spans, scores = 0, None, None
        if not saliency_only:
            k = (arr.shape[1] - lv - len(loss_keys)) // 3
            spans = arr[:, : 2 * k].reshape(arr.shape[0], k, 2)
            scores = arr[:, 2 * k : 3 * k]
            off = 3 * k
        losses = dict(zip(loss_keys, arr[0, off + lv :].tolist()))
        return spans, scores, arr[:, off : off + lv], losses

    packed_step.loss_keys = loss_keys
    packed_step.unpack = unpack
    return packed_step


def _tail_bucket(n: int, bsz: int) -> int:
    """Largest power of two (capped at bsz) that fits a tail of n rows: the
    tail splits into its binary decomposition (14 -> 8 + 4 + 2), so every
    batch is exactly full at a fixed size."""
    b = 1
    while b * 2 <= min(n, bsz):
        b *= 2
    return b


def _batch_rows(n: int, bsz: int, order=None):
    """The row indices of each batch of a split of n rows, in `order`."""
    order = list(range(n)) if order is None else list(order)
    i = 0
    while i < n:
        take = bsz if n - i >= bsz else _tail_bucket(n - i, bsz)
        yield order[i : i + take]
        i += take


def _batched(dataset: VTGDataset, collator: Collator, bsz: int, order=None):
    for idx in _batch_rows(len(dataset), bsz, order):
        yield len(idx), idx, collator([dataset[j] for j in idx])


def _dealt_batches(dataset: VTGDataset, collator: Collator, bsz: int, order=None):
    """(batch number, rows, row indices, collated batch) of the batches
    dealt to this rank (batch i to rank i % world; every batch in one
    process); the other ranks' rows are read (their label draws) and not
    collated."""
    w, r = mesh.world(), mesh.rank()
    for bi, idx in enumerate(_batch_rows(len(dataset), bsz, order)):
        with obs.span("eval.collate", bi):
            samples = [dataset[j] for j in idx]
            batch = collator(samples) if bi % w == r else None
        if batch is not None:
            yield bi, len(idx), idx, batch


def _dealt(per_batch: List[tuple]) -> List[tuple]:
    """Every rank's (batch number, ...) results, gathered and in batch
    order: one process's sequence under a process group."""
    if mesh.world() == 1:
        return per_batch
    return sorted((item for part in mesh.all_gather_objects(per_batch) for item in part),
                  key=lambda item: item[0])


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


def _has_labels(dataset: VTGDataset) -> bool:
    """Whether the rows carry training labels (a test split may load labels
    yet have none), probed without consuming the dataset's label draws."""
    if not len(dataset) or not dataset.cfg.load_labels:
        return False
    state = dataset.rng.getstate()
    try:
        _, sample = dataset[0]
    finally:
        dataset.rng.setstate(state)
    return "saliency_all_labels" in sample


def _maybe_device_feed(cfg, dataset: VTGDataset, fixed_v_len, device):
    """The eval split's device feed (float32, cached on the dataset under
    (fixed_v_len, max_q_l, device)), or None: device_feed off, a bucketed
    video length, per-access txt_drop (streamed and resident text would
    differ), or, under "auto", more bytes than are left of
    device_feed_budget_gb beside the feeds already resident (the JAX
    package's gate)."""
    if cfg.device_feed == "off" or fixed_v_len is None or dataset.cfg.txt_drop_ratio > 0:
        return None
    key = (fixed_v_len, cfg.max_q_l, str(torch.device(device)))
    cached = getattr(dataset, "_device_feed_cache", None)
    if cached is not None and cached[0] == key:
        return cached[1]
    if cfg.device_feed != "on":
        est = estimate_feed_bytes(len(dataset), fixed_v_len, cfg.total_v_feat_dim,
                                  cfg.max_q_l, cfg.t_feat_dim, 4)
        if est > cfg.device_feed_budget_gb * 2**30 - resident_feed_bytes():
            return None
    collator = Collator(max_q_l=cfg.max_q_l, v_buckets=cfg.v_buckets,
                        fixed_v_len=fixed_v_len, dset_name=cfg.dset_name)
    feed = build_device_feed(dataset, collator, device)
    dataset._device_feed_cache = (key, feed)
    return feed


def _fetch(t: torch.Tensor):
    """(host tensor, CUDA event or None): `t` copied to pinned host memory
    without blocking, the event recorded after the copy; a CPU tensor as it
    is. Counted as eval.fetches."""
    obs.count("eval.fetches")
    if t.device.type != "cuda":
        return t, None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(t.device))
    return host, done


def _dispatch(step, batch, idx, feed, lv, strides, device, keys):
    """Launch one collated batch through the packed `step` on `device`
    without waiting for it: its `keys` present in the batch (the labels
    alone in feed mode, plus the row indices), and its strict point masks
    (None where no row is padded), in one upload; in feed mode the
    features gathered from `feed`. Returns (each row's point count, the
    pending fetch of the packed result)."""
    strict, counts = pyramid_masks_strict(batch["valid_v_lens"], lv, strides)
    strict = _strict_or_none(strict, batch["valid_v_lens"], lv)
    arrays = {k: batch[k] for k in keys if k in batch}
    if feed is not None:
        arrays["idx"] = np.asarray(idx, np.int64)
    if strict is not None:
        arrays["point_valid"] = strict
    dev = upload(arrays, device)
    if feed is not None:
        dev.update(gather_rows(feed, dev.pop("idx")))
    point_valid = dev.pop("point_valid", None)
    return counts, _fetch(step(dev, point_valid))


def _ready(fetched, bi: int) -> np.ndarray:
    """The fetched array of batch `bi`, once its copy has ended."""
    host, done = fetched
    with obs.span("eval.fetch_wait", bi):
        if done is not None:
            done.synchronize()
    return host.numpy()


def _pipelined(fn, items, depth: int = PIPELINE_DEPTH):
    """(item, fn(item)) in order, with up to `depth` calls made before the
    oldest is yielded: fn must only launch device work, and the consumer's
    wait on the result is the fence."""
    q: deque = deque()
    for item in items:
        q.append((item, fn(item)))
        if len(q) >= depth:
            yield q.popleft()
    while q:
        yield q.popleft()


def _mr_entries(cfg, batch, real: int, counts, spans, scores, saliency) -> List[dict]:
    """The submission rows of a batch's `real` rows."""
    entries = []
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
        entries.append(entry)
    return entries


@obs.root("eval.infer")
def run_mr_inference(
    cfg, model, dataset: VTGDataset, nms_thd: Optional[float] = None,
    loss_cfg=None,
) -> Tuple[List[dict], Optional[List[dict]], Dict[str, float]]:
    """(submission rows, NMS'd rows or None, eval losses) for an MR dataset,
    on the device that holds the model's parameters. The eval losses are the
    criterion's means over the split when `loss_cfg` is given and the rows
    carry labels, else {}: every batch is exactly full (the binary tail of
    _batched), so its means weigh by its rows."""
    device = next(model.parameters()).device
    fixed_v_len, order = _eval_plan(cfg, dataset)
    with_losses = loss_cfg is not None and _has_labels(dataset)
    feed = _maybe_device_feed(cfg, dataset, fixed_v_len, device)
    collator = Collator(
        max_q_l=cfg.max_q_l, v_buckets=cfg.v_buckets, fixed_v_len=fixed_v_len,
        max_windows=cfg.max_windows, dset_name=cfg.dset_name, pad_features=feed is None,
    )
    step = make_eval_step(model, cfg.max_num_moment, cfg.eval_precision,
                          loss_cfg=loss_cfg if with_losses else None, packed=True)
    keys = TRAIN_KEYS if with_losses else MODEL_KEYS
    nms = nms_thd if nms_thd is not None else cfg.nms_thd

    def dispatch(item):
        bi, _, idx, batch = item
        with obs.span("eval.dispatch", bi):
            lv = fixed_v_len if feed is not None else batch["src_vid"].shape[1]
            return lv, _dispatch(step, batch, idx, feed, lv, cfg.strides, device, keys)

    per_batch = []  # (batch number, rows, losses, entries) of this rank's batches
    for (bi, real, idx, batch), (lv, (counts, fetched)) in _pipelined(
            dispatch, _dealt_batches(dataset, collator, cfg.eval_bsz, order)):
        arr = _ready(fetched, bi)
        with obs.span("eval.rows", bi):
            spans, scores, saliency, losses = step.unpack(arr, lv)
            per_batch.append((bi, real, losses,
                              _mr_entries(cfg, batch, real, counts, spans, scores, saliency)))
        obs.count("eval.batches")

    submission: List[dict] = []
    loss_sums: Dict[str, float] = {}
    n_rows = 0
    with obs.span("eval.gather"):
        for _, real, losses, entries in _dealt(per_batch):
            for k, v in losses.items():
                loss_sums[k] = loss_sums.get(k, 0.0) + v * real
            n_rows += real
            submission.extend(entries)

    with obs.span("eval.postprocess"):
        post = build_post_processor(cfg.dset_name, cfg.clip_length, cfg.v_feat_dim)
        submission = post(submission)
        if cfg.dset_name in ("charadesSTA", "charadesSTA_internvideo2", "tacos", "nlq"):
            for s in submission:
                s.pop("pred_saliency_scores", None)

    submission_nms = None
    if nms is not None and nms != -1:
        with obs.span("eval.nms"):
            submission_nms = apply_nms(submission, nms, cfg.nms_type, device=device)
    eval_losses = {k: v / n_rows for k, v in loss_sums.items()} if loss_sums else {}
    return submission, submission_nms, eval_losses


@obs.root("eval.infer")
def run_hl_inference(cfg, model, dataset: VTGDataset) -> dict:
    """TVSum / YouTube-HL: the saliency of every video of one domain on the
    device that holds the model's parameters, then the domain's mAP (TVSum
    top-5, YouTube-HL over the whole ranking). Returns {"brief": {"mAP":
    rounded to 5 places}, "saliency": {qid: (valid clips,) float32}}."""
    device = next(model.parameters()).device
    fixed_v_len, order = _eval_plan(cfg, dataset)
    feed = _maybe_device_feed(cfg, dataset, fixed_v_len, device)
    collator = Collator(
        max_q_l=cfg.max_q_l, v_buckets=cfg.v_buckets, fixed_v_len=fixed_v_len,
        dset_name=cfg.dset_name, pad_features=feed is None,
    )
    step = make_eval_step(model, cfg.max_num_moment, cfg.eval_precision, saliency_only=True,
                          packed=True)

    def dispatch(item):
        bi, _, idx, batch = item
        with obs.span("eval.dispatch", bi):
            lv = fixed_v_len if feed is not None else batch["src_vid"].shape[1]
            return lv, _dispatch(step, batch, idx, feed, lv, cfg.strides, device, MODEL_KEYS)

    per_batch = []  # (batch number, [(qid, saliency row, label, valid clips)])
    for (bi, real, idx, batch), (lv, (_, fetched)) in _pipelined(
            dispatch, _dealt_batches(dataset, collator, cfg.eval_bsz, order)):
        arr = _ready(fetched, bi)
        with obs.span("eval.rows", bi):
            _, _, sal, _ = step.unpack(arr, lv)
            per_batch.append((bi, [(batch["meta"][j]["qid"], sal[j].copy(),
                                    batch["meta"][j]["label"], int(batch["valid_v_lens"][j]))
                                   for j in range(real)]))
        obs.count("eval.batches")
    preds, labels, saliency = [], [], {}
    for _, rows in _dealt(per_batch):
        for qid, row, label, lvalid in rows:
            # the metric ranks the row up to the label length, as the JAX
            # package's does
            preds.append(row)
            labels.append(label)
            saliency[qid] = row[:lvalid]
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
