"""Counter-based attention-dropout mask, the torch side of csrc/attn_dropout.cuh.

Attention dropout (nn.Dropout on the probabilities, JAX
flashvtg_tpu/models/transformer.py:118-120, 260-262 and
flashvtg_tpu/ops/chunked_attn.py:38-40) keeps probability (b, h, i, j) with
chance 1 - p and scales it by 1 / (1 - p). The kernels cannot afford to
store a (B, H, Lq, Lk) mask, so keep(b, h, i, j) is a pure 32-bit integer
hash of (seed, b * H + h, i, j) that the kernels evaluate in registers, in
the forward and again in the backward. `keep_scale` evaluates the same hash
with torch integer ops (int64, masked to 32 bits after every product), so a
kernel and its plain version agree mask for mask. The formula is written at
the top of the CUDA header.

One seed per attention call, drawn by `draw_seed` from an explicit
torch.Generator as a 0-d int32 tensor on the model's device, which the
kernels read from device memory: a CUDA graph that captures a step then
draws a new seed at every replay (the generator is registered with the
graph) where a by-value integer would be frozen into it. JAX's threefry /
RBG streams are not reproduced: parity with the JAX package runs with
dropout at 0.
"""

from __future__ import annotations

from typing import Optional

import torch

_M32 = 0xFFFFFFFF
_MUL1, _MUL2, _MUL_KEY = 0x7FEB352D, 0x2C1B3C6D, 0x27D4EB2D


def _mix32(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = (x * _MUL1) & _M32
    x = x ^ (x >> 15)
    x = (x * _MUL2) & _M32
    return x ^ (x >> 16)


def threshold(p: float) -> int:
    """floor(p * 2^24): a key survives where its hash's top 24 bits are at
    or above it."""
    if not 0.0 <= p < 1.0:
        raise ValueError(f"dropout rate {p} outside [0, 1)")
    return int(p * (1 << 24))


def draw_seed(generator: Optional[torch.Generator] = None, device=None) -> torch.Tensor:
    """One 31-bit seed for one attention call: a 0-d int32 tensor on
    `device` (default: the generator's, else the CPU), drawn on the device
    from `generator` (None: the device's default generator), without a
    host sync. A generator of another device draws there and the seed is
    copied over, which a graph capture refuses."""
    device = torch.device(device) if device is not None else (
        generator.device if generator is not None else torch.device("cpu"))
    src = generator.device if generator is not None else device
    seed = torch.randint(0, 1 << 31, (), generator=generator, device=src, dtype=torch.int32)
    return seed if src == device else seed.to(device)


def seed_tensor(seed, device) -> torch.Tensor:
    """`seed` (an int, or a 0-d tensor as draw_seed gives) as the 0-d int32
    tensor on `device` that the kernels read."""
    if isinstance(seed, torch.Tensor):
        return seed.to(device=device, dtype=torch.int32).reshape(())
    return torch.tensor(int(seed), dtype=torch.int32).to(device)


def keep_scale(seed, p: float, batch: int, heads: int, rows: torch.Tensor,
               lk: int, dtype=torch.float32) -> torch.Tensor:
    """(B, H, len(rows), Lk) tensor of 1 / (1 - p) where the probability
    survives and 0 where it drops, for query rows `rows` (an int64 tensor of
    row indices, on the device wanted). `seed` is an int or a 0-d tensor
    (draw_seed's), read on the device without a host sync."""
    device = rows.device
    if isinstance(seed, torch.Tensor):
        seed = seed.to(device=device, dtype=torch.int64) & _M32
    else:
        seed = int(seed)
    bh = torch.arange(batch * heads, device=device, dtype=torch.int64).view(batch, heads)
    head = _mix32(seed ^ _mix32(bh))
    row = _mix32((head[..., None] + rows.to(torch.int64)) & _M32)
    key = (torch.arange(lk, device=device, dtype=torch.int64) * _MUL_KEY) & _M32
    keep = (_mix32(row[..., None] ^ key) >> 8) >= threshold(p)
    return keep.to(dtype) * (1.0 / (1.0 - p))
