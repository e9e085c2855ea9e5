"""The port's models: FlashVTGModel (models/flashvtg.py) and the FlashVTG_ms
variant (models/flashvtg_ms.py). `build_model` picks one by its config."""

from __future__ import annotations

import torch
from torch import nn

from flashvtg_tpu_torch.models.flashvtg import FlashVTGModel, ModelConfig
from flashvtg_tpu_torch.models.flashvtg_ms import FlashVTGMSModel, MSModelConfig
from flashvtg_tpu_torch.utils.runtime import resolve_device


def build_model(cfg: ModelConfig, device=None, seed: int = 0) -> nn.Module:
    """The model of `cfg`, a FlashVTGModel or, for an MSModelConfig, a
    FlashVTGMSModel, with weights drawn from `seed` (torch init on the CPU,
    outside the global RNG stream), moved to `device` (None: the card), in
    eval mode (call .train() for the train forward)."""
    device = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = (FlashVTGMSModel if isinstance(cfg, MSModelConfig) else FlashVTGModel)(cfg)
    return model.to(device).eval()


__all__ = ["FlashVTGMSModel", "FlashVTGModel", "MSModelConfig", "ModelConfig", "build_model"]
