"""The scan-epoch measurement harness (counterpart of
flashvtg_tpu/utils/scanbench.py).

One fixture for everything that times the train step's feeding modes
(chip_smoke.py phase 15, tools/profile_eval.py), so that they measure the
same thing: the production step (train/loop.py:make_train_step), a
device-resident feed of synthetic features at given shapes, and synthetic
label batches, driven by the production code of each mode:
  streamed  the collated batch (features included) placed per step
            (train/loop.py:place_batch, the transfer_dtype wire)
  feed      per-step feed mode: labels and row indices uploaded per step
            (train/loop.py:run_chunk, one step a chunk), features gathered
            on the device (train/graph.py:FeedSteps, eager)
  scan      chunks of k steps: one upload a chunk (train/loop.py:run_chunk),
            each step a replay of the captured graph on the card
`time_scan(k, steps)` runs one chunk (the warm-up steps and the capture)
and then `steps` steps in chunks of k, the per-chunk upload inside the
timed loop and the one fetch of the loss buffer as the fence; it returns
(steps/s, the first chunk's seconds, the losses), and times the other
modes alike.
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

MODES = ("streamed", "feed", "scan")


class ScanHarness:
    """The production train step at synthetic shapes (see the module doc):
    `cfg` gives the model (`model_config` overrides cfg.model_config()),
    bsz, precision and transfer_dtype; lv, lq and t_dim the feature shapes.
    Attributes: model, step, keys, feed (lazy), n_rows, labels (one label
    batch, every step's), host_features."""

    def __init__(self, cfg, lv: int, lq: int, t_dim: int, *, device=None,
                 n_feed_batches: int = 4, seed: int = 0, model_config=None):
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
        host = np.random.default_rng(seed)
        v_dim = cfg.total_v_feat_dim
        self.host_features = {
            "src_txt": host.standard_normal((self.n_rows, lq, t_dim)).astype(np.float32),
            "src_txt_mask": np.ones((self.n_rows, lq), np.float32),
            "src_vid": host.standard_normal((self.n_rows, lv, v_dim)).astype(np.float32),
            "src_vid_mask": np.ones((self.n_rows, lv), np.float32),
        }
        bsz = cfg.bsz
        self.labels: Dict[str, np.ndarray] = {
            "saliency_all_labels": host.integers(0, 4, (bsz, lv)).astype(np.float32),
            "saliency_pos_labels": host.integers(0, lv, (bsz, 2)).astype(np.int64),
            "saliency_neg_labels": host.integers(0, lv, (bsz, 2)).astype(np.int64),
            "gt_windows": np.tile(np.asarray([[[2.0, 10.0]]], np.float32), (bsz, 1, 1)),
            "real_neg_mask": np.ones((bsz,), np.float32),
        }
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

        if graph not in self.steps:
            self.steps[graph] = FeedSteps(self.step, self.feed,
                                          graph=graph and self.device.type == "cuda")
        return self.steps[graph]

    def run(self, mode: str, steps: int, k: int = 1, loss_buf=None, i0: int = 0):
        """`steps` steps of `mode` from step index i0 into `loss_buf` (made
        when None); returns the buffer, not fetched."""
        from flashvtg_tpu_torch.train.loop import place_batch, run_chunk

        if mode not in MODES:
            raise ValueError(f"unknown mode {mode!r}; expected one of {MODES}")
        if loss_buf is None:
            loss_buf = torch.zeros((steps, len(self.keys)), device=self.device)
        row = 0
        if mode != "streamed":  # the feed: chunks of k steps, of one step per step
            fs = self.feed_steps(graph=mode == "scan")
            k = k if mode == "scan" else 1
            while row + k <= steps:
                row = run_chunk(fs, self.stack(i0 + row, k), loss_buf, row, self.device)
            return loss_buf
        for i in range(i0, i0 + steps):
            batch = {**self.labels,
                     **{key: v[self._rows(i)] for key, v in self.host_features.items()}}
            loss_buf[row].copy_(self.step.vector(
                place_batch(batch, self.device, transfer_dtype=self.cfg.transfer_dtype)))
            row += 1
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
