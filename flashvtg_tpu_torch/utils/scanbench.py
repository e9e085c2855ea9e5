"""The scan-epoch measurement harness (counterpart of
flashvtg_tpu/utils/scanbench.py).

One fixture for everything that times the train step's feeding modes
(chip_smoke.py phases 15 and 16, tools/profile_eval.py), so that they
measure the same thing: the production step (train/loop.py:
make_train_step), a device-resident feed of synthetic features at given
shapes, and synthetic label batches (or, for the streamed modes, the
collated batches of a train split, `SplitSource`), driven by the
production code of each mode:
  streamed        the blocking per-step copy, the loop before the copy ran
                  ahead: batches made on the prefetch thread
                  (train/loop.py:_prefetched), each placed by
                  train/loop.py:place_batch (the transfer_dtype wire) on the
                  main thread, then the eager step
  streamed_ahead  the streamed epoch (train/loop.py:run_streamed_epoch):
                  batches staged in pinned memory on the prefetch thread,
                  step i + 1's copy issued on a copy stream while step i
                  runs, each step eager (train/graph.py:StreamedSteps)
  streamed_graph  the same, each step a replay of the captured graph on the
                  card
  feed            per-step feed mode: labels and row indices uploaded per
                  step (train/loop.py:run_chunk, one step a chunk),
                  features gathered on the device (train/graph.py:
                  FeedSteps, eager)
  scan            chunks of k steps: one upload a chunk (train/loop.py:
                  run_chunk), each step a replay of the captured graph on
                  the card
`time_scan(k, steps)` runs one chunk (the warm-up steps and the capture)
and then `steps` steps in chunks of k, the per-chunk upload inside the
timed loop and the one fetch of the loss buffer as the fence; it returns
(steps/s, the first chunk's seconds, the losses), and times the other
modes alike (the streamed modes take k steps as their warm-up chunk).
"""

from __future__ import annotations

import functools
import random
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

MODES = ("streamed", "streamed_ahead", "streamed_graph", "feed", "scan")
STREAMED_MODES = MODES[:3]


class SplitSource:
    """source(i) -> step i's collated batch of a train split, as train()
    collates it (train/loop.py:train_data_config, the Collator at the
    fixed max_v_l): rows i * bsz ... (i + 1) * bsz - 1, modulo the split's
    rows, their labels drawn at each access. `reset()` restarts the label
    stream, so each harness on the source sees the same batches."""

    def __init__(self, cfg):
        from flashvtg_tpu_torch.data.collate import Collator
        from flashvtg_tpu_torch.data.dataset import VTGDataset
        from flashvtg_tpu_torch.train.loop import train_data_config

        self.bsz = cfg.bsz
        self.dataset = VTGDataset(train_data_config(cfg, cfg.train_path))
        self.collator = Collator(cfg.max_q_l, cfg.v_buckets, cfg.max_v_l,
                                 max_windows=cfg.max_windows, dset_name=cfg.dset_name)

    def reset(self) -> None:
        self.dataset.rng = random.Random(self.dataset.cfg.seed)

    def __call__(self, i: int) -> Dict:
        rows = (np.arange(self.bsz) + i * self.bsz) % len(self.dataset)
        return self.collator([self.dataset[int(j)] for j in rows])


@functools.lru_cache(maxsize=1)
def synthetic_arrays(seed: int, n_rows: int, lv: int, lq: int, t_dim: int, v_dim: int,
                     bsz: int):
    """({key: (n_rows, ...)} synthetic features and masks, one label batch
    of bsz rows), drawn from `seed`; the last call's arrays are kept, so
    the harnesses of one measurement (a fresh one a mode) share them
    (read only) rather than draw gigabytes again."""
    host = np.random.default_rng(seed)
    features = {} if n_rows == 0 else {
        "src_txt": host.standard_normal((n_rows, lq, t_dim)).astype(np.float32),
        "src_txt_mask": np.ones((n_rows, lq), np.float32),
        "src_vid": host.standard_normal((n_rows, lv, v_dim)).astype(np.float32),
        "src_vid_mask": np.ones((n_rows, lv), np.float32),
    }
    labels = {
        "saliency_all_labels": host.integers(0, 4, (bsz, lv)).astype(np.float32),
        "saliency_pos_labels": host.integers(0, lv, (bsz, 2)).astype(np.int64),
        "saliency_neg_labels": host.integers(0, lv, (bsz, 2)).astype(np.int64),
        "gt_windows": np.tile(np.asarray([[[2.0, 10.0]]], np.float32), (bsz, 1, 1)),
        "real_neg_mask": np.ones((bsz,), np.float32),
    }
    return features, labels


class ScanHarness:
    """The production train step at synthetic shapes (see the module doc):
    `cfg` gives the model (`model_config` overrides cfg.model_config()),
    bsz, precision and transfer_dtype; lv, lq and t_dim the feature shapes.
    With `source` (a SplitSource, its label stream restarted here) the
    streamed modes take their batches from it, and no synthetic features
    are made. Attributes: model, step, keys, feed (lazy), n_rows, labels
    (one label batch, every step's), host_features."""

    def __init__(self, cfg, lv: int, lq: int, t_dim: int, *, device=None,
                 n_feed_batches: int = 4, seed: int = 0, model_config=None,
                 source: Optional[Callable[[int], Dict]] = None):
        from flashvtg_tpu_torch.models import build_model
        from flashvtg_tpu_torch.train.loop import make_optimizer, make_train_step
        from flashvtg_tpu_torch.utils.runtime import resolve_device

        self.cfg = cfg
        self.device = resolve_device(device)
        self.bsz, self.lv, self.lq = cfg.bsz, lv, lq
        self.model = build_model(model_config or cfg.model_config(), self.device, seed).train()
        torch.manual_seed(seed)  # feature dropout and DropPath, as train() seeds them
        optimizer, scheduler = make_optimizer(cfg, self.model.parameters(), 100)
        self.step = make_train_step(
            self.model, cfg.loss_config(), optimizer, scheduler, cfg.grad_clip,
            torch.Generator(device=self.device).manual_seed(seed), cfg.train_precision)
        self.keys = self.step.loss_keys
        self.n_rows = n_feed_batches * cfg.bsz
        self.source = source
        if source is not None:
            source.reset()
        self.host_features, self.labels = synthetic_arrays(
            seed, 0 if source is not None else self.n_rows, lv, lq, t_dim,
            cfg.total_v_feat_dim, cfg.bsz)
        self._feed = None
        self.feed_s = None
        self.steps = {}

    @property
    def feed(self) -> Dict[str, torch.Tensor]:
        """The synthetic feed on the device (features in transfer_dtype),
        made at first use by the feed's own copy (data/feed.py, pinned
        pieces); `feed_s` its seconds (no collation: the rows are made)."""
        if self._feed is None:
            from flashvtg_tpu_torch.data.feed import NARROWED_KEYS, _copy_rows

            t0 = time.perf_counter()
            narrow = torch.bfloat16 if self.cfg.transfer_dtype == "bfloat16" else None
            feed = {}
            for key, v in self.host_features.items():
                t = torch.from_numpy(v)
                if narrow is not None and key in NARROWED_KEYS:
                    t = t.to(narrow)
                feed[key] = torch.empty(t.shape, dtype=t.dtype, device=self.device)
                _copy_rows(feed[key], 0, t)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self._feed, self.feed_s = feed, time.perf_counter() - t0
        return self._feed

    @property
    def feed_bytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.feed.values())

    def _rows(self, i: int) -> np.ndarray:
        return (np.arange(self.bsz) + i * self.bsz) % self.n_rows

    def stack(self, i0: int, k: int) -> Dict[str, np.ndarray]:
        """Steps i0 .. i0 + k - 1's stacked labels and row indices, as the
        train loop's prefetch thread makes them (train/loop.py:stack_chunk)."""
        from flashvtg_tpu_torch.train.loop import stack_chunk

        return stack_chunk([(self._rows(i), self.labels) for i in range(i0, i0 + k)])

    def feed_steps(self, graph: bool):
        """The FeedSteps of each kind, one per harness (a graph is captured
        once)."""
        from flashvtg_tpu_torch.train.graph import FeedSteps

        if ("feed", graph) not in self.steps:
            self.steps["feed", graph] = FeedSteps(self.step, self.feed,
                                                  graph=graph and self.device.type == "cuda")
        return self.steps["feed", graph]

    def streamed_steps(self, graph: bool):
        """The StreamedSteps of each kind, one per harness."""
        from flashvtg_tpu_torch.train.graph import StreamedSteps

        if ("streamed", graph) not in self.steps:
            self.steps["streamed", graph] = StreamedSteps(
                self.step, graph=graph and self.device.type == "cuda")
        return self.steps["streamed", graph]

    def batch(self, i: int) -> Dict:
        """Step i's collated batch, features included: the source's, or the
        synthetic features' rows with the one label batch."""
        if self.source is not None:
            return self.source(i)
        return {**self.labels,
                **{key: v[self._rows(i)] for key, v in self.host_features.items()}}

    def run(self, mode: str, steps: int, k: int = 1, loss_buf=None, i0: int = 0):
        """`steps` steps of `mode` from step index i0 into `loss_buf` (made
        when None); returns the buffer, not fetched."""
        from flashvtg_tpu_torch.train.loop import (
            _prefetched,
            place_batch,
            run_chunk,
            run_streamed_epoch,
        )

        if mode not in MODES:
            raise ValueError(f"unknown mode {mode!r}; expected one of {MODES}")
        if loss_buf is None:
            loss_buf = torch.zeros((steps, len(self.keys)), device=self.device)
        row = 0
        if mode in ("feed", "scan"):  # chunks of k steps, of one step per step
            fs = self.feed_steps(graph=mode == "scan")
            k = k if mode == "scan" else 1
            while row + k <= steps:
                row = run_chunk(fs, self.stack(i0 + row, k), loss_buf, row, self.device)
            return loss_buf
        if mode == "streamed":
            for _, batch in _prefetched(lambda j: self.batch(i0 + j), steps):
                loss_buf[row].copy_(self.step.vector(
                    place_batch(batch, self.device, transfer_dtype=self.cfg.transfer_dtype)))
                row += 1
            return loss_buf
        run_streamed_epoch(self.streamed_steps(graph=mode == "streamed_graph"),
                           lambda j: (self._rows(i0 + j), self.batch(i0 + j)), steps, loss_buf,
                           self.device, self.cfg.transfer_dtype)
        return loss_buf

    def time_scan(self, k: int, steps: int, mode: str = "scan"):
        """One warm-up chunk of k steps (for "scan": the eager warm-up steps
        and the capture), then `steps` steps (rounded down to chunks of k)
        timed, fenced by the one fetch of their loss buffer. Returns (steps
        a second, the warm-up seconds, the host losses of every step run,
        warm-up first)."""
        t0 = time.perf_counter()
        warm = self.run(mode, k, k).cpu()
        warm_s = time.perf_counter() - t0
        steps = steps - steps % k
        t0 = time.perf_counter()
        host = self.run(mode, steps, k, i0=k).cpu()
        dt = time.perf_counter() - t0
        if not torch.isfinite(host).all():
            raise RuntimeError("non-finite train losses in the scan harness")
        return steps / dt, warm_s, torch.cat([warm, host])
