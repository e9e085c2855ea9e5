"""Model weights made on the device from the seed, in one draw.

One uniform draw in [-1, 1) covers every parameter; each leaf takes its
slice, scaled by what its layer is: linear and convolution weights
u sqrt(6 / fan_in) (He-uniform: activations keep their scale through the
ReLU stacks, so the heads' logits are of order 1 as a trained model's are,
and a lower precision shows in the scores), biases 0.02 u, LayerNorm weights
1 + 0.05 u, PReLU slopes 0.25 + 0.05 u, embeddings and the dummy tokens
sqrt(3) u (unit variance), the level coefficients 1 + 0.1 u and the
class / confidence mix 0.5 + 0.1 u. The same tensors go to the program and
to the reference.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
from torch import nn


def leaf_kinds(model: nn.Module) -> Dict[str, str]:
    """{parameter name: kind} by the module that holds it."""
    kinds = {}
    for mod_name, mod in model.named_modules():
        for p_name, _ in mod.named_parameters(recurse=False):
            full = f"{mod_name}.{p_name}" if mod_name else p_name
            if isinstance(mod, nn.LayerNorm):
                kinds[full] = "norm_" + p_name
            elif isinstance(mod, nn.PReLU):
                kinds[full] = "prelu"
            elif isinstance(mod, nn.Embedding):
                kinds[full] = "unit"
            elif p_name.endswith("bias"):
                kinds[full] = "bias"
            elif full in ("dummy_rep_token", "dummy_rep_pos"):
                kinds[full] = "unit"
            elif full == "coef":
                kinds[full] = "coef"
            elif full == "x":
                kinds[full] = "mix"
            else:
                kinds[full] = "weight"
    return kinds


def make_weights(model: nn.Module, seed: int, device) -> Dict[str, torch.Tensor]:
    """{name: tensor} for every parameter of `model`, on `device`, float32."""
    shapes = {k: tuple(p.shape) for k, p in model.named_parameters()}
    kinds = leaf_kinds(model)
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    total = sum(math.prod(s) for s in shapes.values())
    flat = torch.empty(total, device=device).uniform_(-1.0, 1.0, generator=g)
    out, off = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        u = flat[off:off + n].view(shape)
        off += n
        kind = kinds[name]
        if kind == "weight":
            u = u * math.sqrt(6.0 / max(n // shape[0], 1))
        elif kind in ("bias", "norm_bias"):
            u = 0.02 * u
        elif kind == "norm_weight":
            u = 1.0 + 0.05 * u
        elif kind == "prelu":
            u = 0.25 + 0.05 * u
        elif kind == "unit":
            u = math.sqrt(3.0) * u
        elif kind == "coef":
            u = 1.0 + 0.1 * u
        elif kind == "mix":
            u = 0.5 + 0.1 * u
        out[name] = u.clone()
    return out
