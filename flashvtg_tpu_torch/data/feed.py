"""The device-resident feature feed, and the one-copy upload of a batch.

Counterpart of flashvtg_tpu/data/feed.py. A streamed train or eval batch
carries its padded features to the card at every step (a flagship train
batch, B 64: 58 MB of float32 features), and the per-step host-to-device
copy and dispatch, not the card, then set the pace. The feed collates every
row of a split once at the fixed shapes, puts the four feature and mask
tensors (FEED_KEYS) on the device a single time, and each step gathers its
rows there by index: what crosses per step is the labels and the row
indices (kilobytes).

Labels are not stored: the dataset draws them anew at every access (the
reference's per-__getitem__ sampling), so they stream with each step, and
the feed's bulk pass reads `features_only`, which draws none.

The budget is shared: the train feed and the eval feed are resident
together during in-training eval, so a caller gates a new feed on
`estimate_feed_bytes(...) <= budget - resident_feed_bytes()`. Each feed is
tracked by a weak reference to one of its tensors, so a freed feed frees
its share.

`upload` puts a dict of host arrays on the device with one copy: the
arrays are packed into one pinned staging buffer (16-byte aligned) and
copied without blocking the host; the device tensors are views of the one
copy. On the CPU the arrays are wrapped as they are.

A streamed train batch (no feed: the split is over the budget, or its
lengths or text change per step) crosses the same way, split in two so the
copy runs ahead of the step that reads it (train/loop.py:
run_streamed_epoch): `stage_batch`, on the prefetch thread, puts the
collated arrays in their wire dtypes (`wire_dtypes`: the features in bf16
under the bf16 wire, rounded on the host as `place_batch` rounds them;
other floats float32, integer labels int64) into one pinned buffer, each
converted in its one copy there; on the
main thread `copy_ahead` allocates the device buffer on a dedicated copy
stream, issues the non-blocking copy there and records an event, which the
compute stream waits on before the step (`PlacedBatch.wait`). The device
buffer is marked as used by the compute stream (`record_stream`), so the
caching allocator hands it out again only after the step that reads it;
the pinned buffer is handed out again only after its copy (the caching
host allocator records the copy's stream). The step widens the bf16
features on the card.
"""

from __future__ import annotations

import logging
import time
import weakref
from typing import Dict, Optional, Sequence

import numpy as np
import torch

logger = logging.getLogger(__name__)

FEED_KEYS = ("src_vid", "src_vid_mask", "src_txt", "src_txt_mask")
NARROWED_KEYS = ("src_vid", "src_txt")  # the features: most of the bytes

# (weak reference to one tensor of a feed, the feed's bytes)
_LIVE_FEEDS: list = []

# rows of a piece of the copy to the device: bounds the pinned staging buffer
_PIECE_BYTES = 256 << 20


def resident_feed_bytes() -> int:
    """Bytes held by the feeds still alive in this process."""
    global _LIVE_FEEDS
    _LIVE_FEEDS = [(r, b) for r, b in _LIVE_FEEDS if r() is not None]
    return sum(b for _, b in _LIVE_FEEDS)


def estimate_feed_bytes(n: int, max_v_l: int, v_dim: int, max_q_l: int,
                        t_dim: int, dtype_bytes: int = 4) -> int:
    """A feed's bytes: n rows of features at `dtype_bytes` and their masks
    (counted at the same width, as the JAX package counts them)."""
    per_row = max_v_l * v_dim + max_q_l * t_dim  # features
    per_row += max_v_l + max_q_l  # masks
    return n * per_row * dtype_bytes


def build_device_feed(dataset, collator, device, dtype: Optional[torch.dtype] = None,
                      chunk: int = 256, workers: int = 8) -> Dict[str, torch.Tensor]:
    """{key: (N, ...) tensor on `device`} for FEED_KEYS: every row of
    `dataset` collated by `collator` (its fixed shapes, pad_features on).
    `dtype` narrows the two feature tensors (NARROWED_KEYS; bfloat16 rounds
    to nearest even on the host, as the streamed train batch's bf16 wire);
    the masks stay float32. The rows' feature loads are warmed on a thread
    pool (each row read by one worker), then `chunk` rows at a time are
    collated and copied to their slice of the device tensors through a
    pinned staging piece, so no second host copy of the whole feed is made."""
    t0 = time.perf_counter()
    device = torch.device(device)
    n = len(dataset)
    get = dataset.features_only
    if workers > 1 and n > workers:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=workers) as ex:
            for _ in ex.map(get, range(n)):
                pass
    feed: Dict[str, torch.Tensor] = {}
    for start in range(0, n, chunk):
        batch = collator([get(i) for i in range(start, min(start + chunk, n))])
        for key in FEED_KEYS:
            rows = torch.from_numpy(np.ascontiguousarray(batch[key]))
            if dtype is not None and key in NARROWED_KEYS:
                rows = rows.to(dtype)
            if key not in feed:
                feed[key] = torch.empty((n,) + tuple(rows.shape[1:]), dtype=rows.dtype,
                                        device=device)
            _copy_rows(feed[key], start, rows)
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()
    total = sum(t.numel() * t.element_size() for t in feed.values())
    if feed:
        _LIVE_FEEDS.append((weakref.ref(feed["src_vid"]), total))
    logger.info("device feed: %d rows, %.2f GB on %s (%.2f GB resident in all), %.2f s",
                n, total / 2**30, device, resident_feed_bytes() / 2**30,
                time.perf_counter() - t0)
    return feed


def _copy_rows(dst: torch.Tensor, start: int, rows: torch.Tensor) -> None:
    """dst[start : start + len(rows)] = rows; to a CUDA tensor through one
    pinned piece of at most _PIECE_BYTES at a time (the copy of a piece
    ends before its buffer is written again)."""
    if dst.device.type != "cuda":
        dst[start : start + len(rows)] = rows
        return
    row_bytes = max(1, rows[0].numel() * rows.element_size()) if len(rows) else 1
    step = max(1, _PIECE_BYTES // row_bytes)
    for i in range(0, len(rows), step):
        piece = rows[i : i + step].pin_memory()
        dst[start + i : start + i + len(piece)].copy_(piece, non_blocking=True)
        # the piece's buffer is freed here and may be handed out again only
        # after the copy (the caching host allocator records its use)


def _pack(tensors: Dict[str, torch.Tensor], dtypes: Optional[Dict[str, torch.dtype]] = None,
          pin: bool = True):
    """(one uint8 host buffer, pinned with `pin`, holding every tensor's
    values in its dtype in `dtypes` (default its own; a conversion is made
    in the one copy into the buffer), each at a 16-byte aligned offset; the
    layout [(key, dtype, shape, offset)])."""
    layout, off = [], 0
    for k, t in tensors.items():
        dtype = t.dtype if dtypes is None else dtypes[k]
        off = -(-off // 16) * 16
        layout.append((k, dtype, tuple(t.shape), off))
        off += t.numel() * dtype.itemsize
    host = torch.empty(max(off, 16), dtype=torch.uint8, pin_memory=pin)
    for view, (k, *_) in zip(_unpack(host, layout).values(), layout):
        view.copy_(tensors[k])
    return host, layout


def _unpack(dev: torch.Tensor, layout) -> Dict[str, torch.Tensor]:
    """The tensors of `layout` as views of the device copy `dev`."""
    out = {}
    for k, dtype, shape, o in layout:
        n = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        out[k] = dev[o : o + n].view(dtype).view(shape)
    return out


def upload(arrays: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """{key: tensor on `device`} of host arrays, dtypes kept, with one
    non-blocking host-to-device copy from one pinned buffer (see the
    module's doc). On the CPU, the arrays wrapped without a copy."""
    device = torch.device(device)
    tensors = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in arrays.items()}
    if device.type != "cuda":
        return tensors
    host, layout = _pack(tensors)
    return _unpack(host.to(device, non_blocking=True), layout)


def wire_dtypes(batch: Dict, keys: Sequence[str], transfer_dtype: str = "float32"):
    """({key: host tensor} of `keys` (those in `batch`), {key: the dtype it
    crosses to the device in}): integer arrays int64; with transfer_dtype
    "bfloat16" the features (NARROWED_KEYS) bf16, rounded to nearest even
    (the JAX loop's astype(bfloat16)); other floating arrays float32, the
    step's dtype."""
    tensors, dtypes = {}, {}
    for key in keys:
        if key in batch:
            t = tensors[key] = torch.from_numpy(np.asarray(batch[key]))
            if not t.is_floating_point():
                dtypes[key] = torch.int64
            elif transfer_dtype == "bfloat16" and key in NARROWED_KEYS:
                dtypes[key] = torch.bfloat16
            else:
                dtypes[key] = torch.float32
    return tensors, dtypes


class StagedBatch:
    """A batch's host tensors in their wire dtypes (`wire_dtypes`): on the
    card's side packed into one pinned buffer (`pin`), each converted in
    its one copy into it; else converted and kept as they are."""

    def __init__(self, tensors: Dict[str, torch.Tensor], dtypes: Dict[str, torch.dtype],
                 pin: bool):
        self.host = self.layout = self.tensors = None
        if pin:
            self.host, self.layout = _pack(tensors, dtypes=dtypes)
        else:
            self.tensors = {k: t.to(dtypes[k]) for k, t in tensors.items()}


def stage_batch(batch: Dict, keys: Sequence[str], device,
                transfer_dtype: str = "float32") -> StagedBatch:
    """`batch`'s `keys` staged for `device`: pinned and packed for the card
    (host work, made on the prefetch thread), wrapped for the CPU."""
    return StagedBatch(*wire_dtypes(batch, keys, transfer_dtype),
                       pin=torch.device(device).type == "cuda")


class PlacedBatch:
    """A batch on the device and the event its copy records (None: the
    tensors are ready, as on the CPU). `wait()` makes the current stream
    wait for the copy and returns the tensors."""

    def __init__(self, tensors: Dict[str, torch.Tensor], ready=None):
        self.tensors, self.ready = tensors, ready

    def wait(self) -> Dict[str, torch.Tensor]:
        if self.ready is not None:
            torch.cuda.current_stream().wait_event(self.ready)
        return self.tensors


def copy_ahead(staged: StagedBatch, device, stream=None) -> PlacedBatch:
    """Issue the staged batch's copy to `device` on the copy stream
    `stream`, without blocking the host: the device buffer is allocated on
    that stream and marked as used by the current (compute) stream, which
    reads it after `PlacedBatch.wait`. On the CPU, the staged tensors."""
    device = torch.device(device)
    if device.type != "cuda":
        return PlacedBatch(staged.tensors)
    compute = torch.cuda.current_stream(device)
    with torch.cuda.stream(stream):
        dev = torch.empty(staged.host.numel(), dtype=torch.uint8, device=device)
        dev.copy_(staged.host, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record(stream)
    dev.record_stream(compute)
    return PlacedBatch(_unpack(dev, staged.layout), ready)


def widen_features(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """`batch` with its bf16 tensors (the features of the bf16 wire) widened
    to float32, on their device; other tensors as they are."""
    return {k: v.float() if v.dtype == torch.bfloat16 else v for k, v in batch.items()}


def gather_rows(feed: Dict[str, torch.Tensor], idx: torch.Tensor,
                dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """The batch's feature tensors: rows `idx` (int64, on the feed's device)
    of every feed tensor, widened to `dtype` where the feed is narrower."""
    out = {}
    for key, store in feed.items():
        t = store.index_select(0, idx)
        out[key] = t if t.dtype == dtype else t.to(dtype)
    return out
