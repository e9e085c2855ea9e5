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
"""

from __future__ import annotations

import logging
import time
import weakref
from typing import Dict, Optional

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


def _torch_dtype(np_dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, np_dtype)).dtype


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


def upload(arrays: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """{key: tensor on `device`} of host arrays, dtypes kept, with one
    non-blocking host-to-device copy from one pinned buffer (see the
    module's doc). On the CPU, the arrays wrapped without a copy."""
    device = torch.device(device)
    if device.type != "cuda":
        return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in arrays.items()}
    layout, off = [], 0
    for k, v in arrays.items():
        v = np.ascontiguousarray(v)
        off = -(-off // 16) * 16
        layout.append((k, v, off))
        off += v.nbytes
    host = torch.empty(max(off, 16), dtype=torch.uint8, pin_memory=True)
    view = host.numpy()
    for _, v, o in layout:
        view[o : o + v.nbytes] = v.reshape(-1).view(np.uint8)
    dev = host.to(device, non_blocking=True)
    return {
        k: dev[o : o + v.nbytes].view(_torch_dtype(v.dtype)).view(v.shape)
        for k, v, o in layout
    }


def gather_rows(feed: Dict[str, torch.Tensor], idx: torch.Tensor,
                dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """The batch's feature tensors: rows `idx` (int64, on the feed's device)
    of every feed tensor, widened to `dtype` where the feed is narrower."""
    out = {}
    for key, store in feed.items():
        t = store.index_select(0, idx)
        out[key] = t if t.dtype == dtype else t.to(dtype)
    return out
