"""The original's optimisation step in plain PyTorch: the gradients clipped
by their global norm (g * min(1, c / |g|)), then AdamW (betas 0.9 / 0.999,
eps 1e-8, decoupled weight decay: p <- p (1 - lr wd), then the Adam step
with bias corrections)."""

from __future__ import annotations

from typing import Dict

import torch


def clip_global(grads: Dict[str, torch.Tensor], max_norm: float) -> Dict[str, torch.Tensor]:
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g)
                                                 for g in grads.values()]))
    factor = torch.clamp(max_norm / norm, max=1.0) if max_norm > 0 else 1.0
    return {k: g * factor for k, g in grads.items()}


class AdamW:
    def __init__(self, params: Dict[str, torch.Tensor], lr: float, wd: float,
                 betas=(0.9, 0.999), eps: float = 1e-8):
        self.lr, self.wd, self.betas, self.eps = lr, wd, betas, eps
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}
        self.t = 0

    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]):
        """The updated parameters (new tensors)."""
        self.t += 1
        b1, b2 = self.betas
        out = {}
        for k, p in params.items():
            g = grads[k]
            self.m[k] = b1 * self.m[k] + (1 - b1) * g
            self.v[k] = b2 * self.v[k] + (1 - b2) * g * g
            m_hat = self.m[k] / (1 - b1 ** self.t)
            v_hat = self.v[k] / (1 - b2 ** self.t)
            out[k] = p * (1 - self.lr * self.wd) - self.lr * m_hat / (v_hat.sqrt() + self.eps)
        return out
