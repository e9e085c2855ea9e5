"""Eval traffic: whole passes over an eval split, timed.

A pass is what the train loop's eval and `cli infer` run for a moment
retrieval split (train/loop.py:evaluate, without writing files):
`run_mr_inference` (the device feed where the split fits its budget, the
pipelined batches, one fetch a batch, row formatting, post-processing and
NMS), then `eval_submission` on the plain and on the NMS'd submission.
Set-up builds the dataset (`VTGDataset`, features preloaded through the
native loader) and the model with the seed's weights, and runs one pass,
which builds the device feed and every kernel. The window runs passes
until `seconds` have passed; `eval_qps` is the queries of every pass over
the window's time. Of each pass the harness keeps what the output check
reads: the seed's sample of queries' plain and NMS'd rows (as arrays) and
both metric dicts; the last pass's submissions are kept whole, each pass's
replacing the one before, as the production loop holds one.
"""

from __future__ import annotations

import json
import time
from typing import List

import numpy as np
import torch

from vtgbench.harness import data
from vtgbench.harness.check_eval import sample_rows
from vtgbench.harness.cell import experiment_config
from vtgbench.harness.weights import make_weights


class EvalDriver:
    def __init__(self, cell, seed: int, device, trace):
        self.cell, self.seed, self.trace = cell, seed, trace
        self.device = torch.device(device)
        self.config, self.traffic = cell.config, cell.traffic
        self.outputs: List[tuple] = []
        self.last = None

    def setup(self) -> None:
        from flashvtg_tpu_torch.data.dataset import VTGDataset
        from flashvtg_tpu_torch.models import build_model
        from flashvtg_tpu_torch.train.infer import eval_data_config

        tr, seed, dev = self.traffic, self.seed, self.device
        self.path, self.vdir, self.tdir = data.split(tr, self.config, seed)
        cfg = self.cfg = experiment_config(self.config, tr, seed=seed, eval_path=self.path,
                                           v_feat_dirs=(self.vdir,), t_feat_dir=self.tdir)
        self.dataset = VTGDataset(eval_data_config(cfg, self.path))
        self.model = build_model(cfg.model_config(), dev, 0).eval()
        self.weights = make_weights(self.model, seed, dev)
        with torch.no_grad():
            for name, p in self.model.named_parameters():
                p.copy_(self.weights[name])
        with open(self.path) as f:
            rows = [json.loads(line) for line in f]
        clip = float(self.config["clip_length"])
        lv = self.config["max_v_l"]
        clips = np.asarray([min(int(round(r["duration"] / clip)), lv) for r in rows])
        tokens = np.asarray([min(r["tokens"], self.config["max_q_l"]) for r in rows])
        bsz = cfg.eval_bsz
        if len(rows) % bsz:
            raise ValueError("the split's rows must fill whole eval batches")
        # each batch's (clip counts, token counts, no negative pass)
        self.batch_lengths = [(clips[i:i + bsz], tokens[i:i + bsz], None)
                              for i in range(0, len(rows), bsz)]
        self.sample = {r["qid"] for r in sample_rows(rows, seed)}
        self.keep(self.one_pass())

    def one_pass(self):
        from flashvtg_tpu_torch.eval.metrics import eval_submission
        from flashvtg_tpu_torch.train.infer import run_mr_inference

        with self.trace.span("infer"):
            sub, sub_nms, _ = run_mr_inference(self.cfg, self.model, self.dataset)
        with self.trace.span("metrics"):
            metrics = eval_submission(sub, self.dataset.data)
            metrics_nms = eval_submission(sub_nms, self.dataset.data)
        return sub, sub_nms, metrics, metrics_nms

    def keep(self, out) -> None:
        """What the check reads of a pass: the sampled queries' (qid, rows)
        plain and NMS'd and both metric dicts; `last` the pass whole."""
        sub, sub_nms, metrics, metrics_nms = out
        pick = lambda s: [(e["qid"], np.asarray(e["pred_relevant_windows"], np.float64))
                          for e in s if e["qid"] in self.sample]
        self.outputs.append((pick(sub), pick(sub_nms), metrics, metrics_nms))
        self.last = out

    def window(self, seconds: float) -> dict:
        self.outputs.clear()
        self.trace.spans.clear()
        with self.trace.window():
            t0 = time.perf_counter()
            while True:
                self.keep(self.one_pass())
                if time.perf_counter() - t0 >= seconds:
                    break
        passes = len(self.outputs)
        n = len(self.dataset)
        self.trace.steps = passes * len(self.batch_lengths)
        self.trace.meta = self.batch_lengths * passes
        self.trace.extra.update(mode="eval", precision=self.cfg.eval_precision,
                                config=self.config,
                                infer_s=self.trace.span_seconds("infer"),
                                metrics_s=self.trace.span_seconds("metrics"))
        self.attempted, self.failed = passes * n, 0
        return {"eval_qps": passes * n / self.trace.window_s}

    def release(self) -> None:
        for name in ("model", "dataset"):
            self.__dict__.pop(name, None)
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    def check(self):
        from vtgbench.harness.check_eval import compare

        return compare(self)
