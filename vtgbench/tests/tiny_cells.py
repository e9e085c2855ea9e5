"""Cells of the benchmark shrunk to CPU size for the tests: the real
configuration and traffic files with small widths, depths and rows, and
the real cell's limits."""

from __future__ import annotations

import json
import os
import types

from vtgbench.harness.cell import PACKAGE

SMALL = dict(v_feat_dim=24, t_feat_dim=16, hidden_dim=64, nheads=2, dim_feedforward=64,
             enc_layers=1, t2v_layers=2, dummy_layers=1, num_dummies=3, max_q_l=8,
             num_mlp_layers=3, max_num_moment=10)
TRAFFIC = {
    "train-streamed-bf16": dict(rows=32, videos=5, clips=[20, 160], tokens=[3, 8], bsz=4,
                                device_feed="off"),
    "train-scan-bf16": dict(rows=40, tokens=[3, 8], bsz=8),
    "eval-feed-f32": dict(rows=16, videos=3, clips=[20, 160], tokens=[3, 8], eval_bsz=4),
}
WORKLOADS = {"tacos-train-bf16": ("tacos", "train-streamed-bf16"),
             "qvh-train-bf16": ("qvhighlights_slowclip", "train-scan-bf16"),
             "tacos-eval-f32": ("tacos", "eval-feed-f32")}


def load(sub: str, name: str) -> dict:
    with open(os.path.join(PACKAGE, sub, name + ".json")) as f:
        return json.load(f)


def tiny_cell(workload: str, widths: bool = False, **traffic):
    """A Cell-like object of `workload` at CPU size (with `widths`, the
    configuration's own widths and depths, only the lengths cut);
    `traffic` overrides."""
    config_name, traffic_name = WORKLOADS[workload]
    config = load("configs", config_name)
    config.update({} if widths else SMALL, max_v_l=160 if config_name == "tacos" else 12)
    t = load("traffic", traffic_name)
    t.update(TRAFFIC[traffic_name], **traffic)
    path = os.path.join(PACKAGE, "limits", workload + ".json")
    limits = load("limits", workload)["limits"] if os.path.exists(path) else {}
    return types.SimpleNamespace(name=workload, config=config, traffic=t, chips=1,
                                 limits=lambda: dict(limits), per_layer=lambda: [],
                                 end_to_end=lambda: [
                                     {"name": "setup_s", "unit": "s"},
                                     {"name": "train_rows_per_s", "unit": "rows/s"},
                                     {"name": "eval_qps", "unit": "queries/s"}])
