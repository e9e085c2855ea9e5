"""The port's counterpart of `__graft_entry__.entry()`: the flagship
QVHighlights model and an example batch, on the card by default."""

from __future__ import annotations

import numpy as np
import torch

from flashvtg_tpu_torch.models import build_model
from flashvtg_tpu_torch.models.points import pyramid_masks_strict
from flashvtg_tpu_torch.train.config import from_preset
from flashvtg_tpu_torch.utils.runtime import resolve_device


def entry(device=None, seed: int = 0, bsz: int = 8, **overrides):
    """(model, example_args) for preset qvhighlights_slowclip: call
    `model(*example_args)` for the eval forward. `overrides` go to the
    preset (e.g. smaller widths on the CPU)."""
    device = resolve_device(device)
    cfg = from_preset("qvhighlights_slowclip", **overrides)
    lv, lq = cfg.max_v_l, cfg.max_q_l
    model = build_model(cfg.model_config(), device, seed)
    strict, _ = pyramid_masks_strict(np.full(bsz, lv), lv, cfg.strides)
    host = np.random.default_rng(seed)

    def put(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device)

    example_args = (
        put(host.standard_normal((bsz, lq, cfg.t_feat_dim), dtype=np.float32)),
        put(np.ones((bsz, lq))),
        put(host.standard_normal((bsz, lv, cfg.total_v_feat_dim), dtype=np.float32)),
        put(np.ones((bsz, lv))),
        put(strict),
    )
    return model, example_args
