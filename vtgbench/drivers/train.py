"""Training traffic: the program's production epoch, timed.

Set-up builds what `train()` builds (train/loop.py): the model, AdamW and
StepLR (`make_optimizer`), the train step (`make_train_step`) with its
attention-dropout generator, the epoch's mode (`epoch_mode`: the device
feed with chunks of graph replays, `FeedSteps` + `run_chunked_epoch`, or
the streamed epoch with a replay a step, `StreamedSteps` +
`run_streamed_epoch`), and for the streamed epoch the split's dataset
(`VTGDataset`, features preloaded through the native loader) and its
`Collator`. The weights come from the seed (harness/weights.py). Set-up
then drives that one object through its first three steps, on three
batches of different rows, through the window's own call and feed; those
are the steps the output check follows (their losses, the first
gradient as AdamW holds it after one step, the parameters after three).

The window runs epochs as `train()` does (a shuffle from the seed, one
loss fetch an epoch, the epoch's fence) until `seconds` have passed, the
last epoch cut to end near it; `train_rows_per_s` is the rows of every
step run over the window's time.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from vtgbench.harness import data
from vtgbench.harness.cell import experiment_config
from vtgbench.harness.weights import make_weights

CHECKED_STEPS = 3


class TrainDriver:
    def __init__(self, cell, seed: int, device, trace):
        self.cell, self.seed, self.trace = cell, seed, trace
        self.device = torch.device(device)
        self.config, self.traffic = cell.config, cell.traffic
        self.lengths: Dict[int, tuple] = {}  # step -> (clip counts, token counts, real_neg)
        self.checked: dict = {}

    # set-up
    def setup(self) -> None:
        from flashvtg_tpu_torch.data.collate import Collator
        from flashvtg_tpu_torch.data.dataset import VTGDataset
        from flashvtg_tpu_torch.models import build_model
        from flashvtg_tpu_torch.train.graph import FeedSteps, StreamedSteps
        from flashvtg_tpu_torch.train.loop import (
            epoch_mode,
            make_optimizer,
            make_train_step,
            run_chunked_epoch,
            run_streamed_epoch,
            train_data_config,
        )

        tr, seed, dev = self.traffic, self.seed, self.device
        files = tr["data"] == "files"
        extra = dict(seed=seed)
        if files:
            path, vdir, tdir = data.split(tr, self.config, seed)
            extra.update(train_path=path, v_feat_dirs=(vdir,), t_feat_dir=tdir)
        cfg = self.cfg = experiment_config(self.config, tr, **extra)
        n_rows = tr["rows"]
        self.mode = mode = epoch_mode(cfg, dev, n_rows)
        if mode.feed != (not files):
            raise RuntimeError(f"epoch_mode chose feed={mode.feed} for {tr['name']}, whose "
                               "rows are meant for the other path")
        self.model = build_model(cfg.model_config(), dev, 0).train()
        self.weights = make_weights(self.model, seed, dev)
        with torch.no_grad():
            for name, p in self.model.named_parameters():
                p.copy_(self.weights[name])
        torch.manual_seed(seed)  # feature dropout and DropPath, as train() seeds them
        self.steps_per_epoch = max(1, n_rows // cfg.bsz)
        optimizer, scheduler = make_optimizer(cfg, self.model.parameters(), self.steps_per_epoch)
        self.optimizer = optimizer
        self.generator = torch.Generator(device=dev).manual_seed(seed)
        step = make_train_step(self.model, cfg.loss_config(), optimizer, scheduler,
                               cfg.grad_clip, self.generator, cfg.train_precision)
        self.keys = step.loss_keys
        self.shuffler = np.random.default_rng(seed)
        if files:
            self.dataset = VTGDataset(train_data_config(cfg, path))
            collator = Collator(cfg.max_q_l, cfg.v_buckets, cfg.max_v_l,
                                max_windows=cfg.max_windows, dset_name=cfg.dset_name)
            self.steps = StreamedSteps(step, graph=mode.graph)

            def batch(rows):
                return collator([self.dataset[int(j)] for j in rows])

            def run(host_batch, n, loss_buf):
                return run_streamed_epoch(self.steps, host_batch, n, loss_buf, dev,
                                          cfg.transfer_dtype)
        else:
            self.feed = data.device_feed(tr, self.config, seed, dev)
            self.labels = data.row_labels(tr, self.config, seed)
            self.token_counts = self.feed["src_txt_mask"].sum(1).long().cpu().numpy()
            self.steps = FeedSteps(step, self.feed, graph=mode.graph)
            ones = np.ones(cfg.bsz, np.float32)

            def batch(rows):
                out = {k: v[rows] for k, v in self.labels.items()}
                out["real_neg_mask"] = ones
                return out

            def run(host_batch, n, loss_buf):
                return run_chunked_epoch(self.steps, host_batch, n, mode.chunk, loss_buf, dev)
        self._batch, self._run = batch, run
        self.rows = np.arange(n_rows)
        self._check_steps()

    def _host_batch(self, order, first_step: int, record: bool):
        bsz = self.cfg.bsz

        def host_batch(i):
            rows = order[i * bsz:(i + 1) * bsz]
            if len(rows) < bsz:
                return None
            b = self._batch(rows)
            if record:
                self.lengths[first_step + i] = self._lengths(rows, b)
            return rows, b
        return host_batch

    def _lengths(self, rows, batch):
        if "src_vid_mask" in batch:
            return (batch["src_vid_mask"].sum(1).astype(int), batch["src_txt_mask"].sum(1)
                    .astype(int), batch["real_neg_mask"])
        lv = self.config["max_v_l"]
        return np.full(len(rows), lv), self.token_counts[rows], batch["real_neg_mask"]

    def _check_steps(self) -> None:
        """The first three steps of the one train object, kept for the
        output check: rows 0-95 of the seed's first shuffle, one step, then
        two."""
        dev = self.device
        self.shuffler.shuffle(self.rows)
        order = self.rows.copy()
        cuda_state = torch.cuda.get_rng_state(dev) if dev.type == "cuda" else torch.get_rng_state()
        gen_state = self.generator.get_state()
        loss_buf = torch.zeros((CHECKED_STEPS, len(self.keys)), device=dev)
        self._run(self._host_batch(order, 0, False), 1, loss_buf)
        params = [p for p in self.model.parameters()]
        names = [n for n, _ in self.model.named_parameters()]
        by_param = {id(p): n for n, p in zip(names, params)}
        grads = {by_param[id(p)]: st["exp_avg"].detach().clone() / 0.1
                 for p, st in self.optimizer.state.items()}
        self._run(self._host_batch(order[self.cfg.bsz:], 1, False), CHECKED_STEPS - 1,
                  loss_buf[1:])
        after = {n: p.detach().clone() for n, p in self.model.named_parameters()}
        losses = loss_buf.cpu()
        self.checked = dict(order=order[:CHECKED_STEPS * self.cfg.bsz], rng_state=cuda_state,
                            gen_state=gen_state, losses=losses, grads=grads, after=after)
        if not self.mode.feed:
            return
        idx = torch.as_tensor(self.checked["order"], device=dev)
        self.checked["features"] = {k: v.index_select(0, idx).clone()
                                    for k, v in self.feed.items()}

    # the window
    def window(self, seconds: float) -> dict:
        bsz = self.cfg.bsz
        steps = bad = 0
        epoch_s = None
        with self.trace.window():
            t0 = time.perf_counter()
            while True:
                elapsed = time.perf_counter() - t0
                n = self.steps_per_epoch
                if epoch_s is not None and elapsed + epoch_s > seconds:
                    n = max(1, int(round((seconds - elapsed) / epoch_s * n)))
                self.shuffler.shuffle(self.rows)
                loss_buf = torch.zeros((n, len(self.keys)), device=self.device)
                e0 = time.perf_counter()
                with self.trace.span("epoch"):
                    done = self._run(self._host_batch(self.rows.copy(), steps, True), n, loss_buf)
                with self.trace.span("loss fetch"):
                    host = loss_buf[:done].cpu()
                if epoch_s is None:
                    epoch_s = time.perf_counter() - e0
                bad += int((~torch.isfinite(host).all(dim=1)).sum())
                steps += done
                if time.perf_counter() - t0 >= seconds:
                    break
        total = self.trace.window_s
        self.trace.steps = steps
        self.trace.meta = [self.lengths[i] for i in range(steps)]
        self.trace.extra.update(mode="train", precision=self.cfg.train_precision,
                                config=self.config)
        self.attempted, self.failed = steps, bad
        return {"train_rows_per_s": steps * bsz / total}

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        for name in ("steps", "feed", "model", "optimizer", "dataset", "_run", "_batch"):
            self.__dict__.pop(name, None)
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    def check(self) -> List[tuple]:
        from vtgbench.harness.check_train import compare

        return compare(self)
