"""Span post-processing (counterpart of flashvtg_tpu/eval/postprocess.py;
reference postprocessing.py PostProcessorDETR and inference.py:312-352)."""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np


@dataclasses.dataclass
class PostProcessor:
    clip_length: float = 2.0
    min_ts_val: float = 0.0
    max_ts_val: float = 150.0
    min_w_l: float = 2.0
    max_w_l: float = 150.0
    move_window_method: str = "left"
    process_func_names: Sequence[str] = ("clip_ts", "round_multiple")

    def process_windows(self, windows: np.ndarray) -> np.ndarray:
        """windows: (..., 2) [st, ed] in seconds."""
        w = np.asarray(windows, dtype=np.float64)
        for name in self.process_func_names:
            if name == "clip_ts":
                w = np.clip(w, self.min_ts_val, self.max_ts_val)
            elif name == "round_multiple":
                w = np.round(w / self.clip_length) * self.clip_length
            elif name == "clip_window_l":
                w = self._clip_window_lengths(w)
            else:
                raise ValueError(f"unknown process step {name}")
        return w

    def _clip_window_lengths(self, w):
        lengths = w[..., 1] - w[..., 0]
        for bound, selector in (
            (self.min_w_l, lengths < self.min_w_l),
            (self.max_w_l, lengths > self.max_w_l),
        ):
            if selector.any():
                if self.move_window_method == "left":
                    w[..., 1] = np.where(selector, w[..., 0] + bound, w[..., 1])
                elif self.move_window_method == "right":
                    w[..., 0] = np.where(selector, w[..., 1] - bound, w[..., 0])
                else:  # center
                    c = (w[..., 0] + w[..., 1]) / 2
                    w[..., 0] = np.where(selector, c - bound / 2, w[..., 0])
                    w[..., 1] = np.where(selector, c + bound / 2, w[..., 1])
        return w

    def __call__(self, lines):
        for line in lines:
            rows = np.asarray(line["pred_relevant_windows"], dtype=np.float64)
            if len(rows) == 0:
                continue
            wins = self.process_windows(rows[:, :2])
            line["pred_relevant_windows"] = [
                [float(a), float(b), float(f"{s:.4f}")]
                for (a, b), s in zip(wins, rows[:, 2])
            ]
        return lines


def build_post_processor(dset_name: str, clip_length: float, v_feat_dim: int = 0):
    """Per-dataset processor selection (reference inference.py:312-352)."""
    if dset_name in ("hl", "qv_internvideo2"):
        return PostProcessor(
            clip_length=clip_length, min_ts_val=0, max_ts_val=150,
            min_w_l=2, max_w_l=150, move_window_method="left",
            process_func_names=("clip_ts", "round_multiple"),
        )
    if dset_name in ("charadesSTA", "charadesSTA_internvideo2"):
        if v_feat_dim == 4096:  # vgg
            return PostProcessor(
                clip_length=clip_length, min_ts_val=0, max_ts_val=360,
                min_w_l=12, max_w_l=360, move_window_method="left",
                process_func_names=("clip_ts", "round_multiple"),
            )
        return PostProcessor(
            clip_length=clip_length, min_ts_val=0, max_ts_val=150,
            min_w_l=2, max_w_l=60, move_window_method="left",
            process_func_names=("clip_ts", "round_multiple"),
        )
    return PostProcessor(
        clip_length=clip_length, min_ts_val=0, max_ts_val=50000,
        min_w_l=0, max_w_l=50000, move_window_method="left",
        process_func_names=("round_multiple",),
    )
