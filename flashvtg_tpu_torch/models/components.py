"""Building-block modules of the FlashVTG network, in PyTorch.

Counterpart of flashvtg_tpu/models/components.py. Sequence tensors stay
channels-last (B, L, D) at every public call, as in the JAX package; the
convolutions permute to torch's (B, D, L) inside. Submodule names follow the
reference torch checkpoint (LayerNorm / net.1, convs.i / fc.layers.i,
module.1 / module.3, blocks.j.{5i+1, 5i+3}).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from flashvtg_tpu_torch.ops.layer_norm import LayerNorm


# host-made constant arrays of the forward, one copy per (key, device), with
# the pinned host array each was copied from: a forward that a CUDA graph
# captures, or that runs under torch.cuda.set_sync_debug_mode("error") (the
# graph's warm-up steps, train/graph.py), may not copy from pageable host
# memory, so the copy is made once, from pinned memory and without a sync,
# at the first call, and the pinned source is kept for as long as its copy
_CONSTANTS: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}


def device_constant(key: tuple, device, make: Callable[[], np.ndarray]) -> torch.Tensor:
    """The array `make()` as a tensor on `device`, made and copied there at
    the first call for (`key`, device), on the current stream without a
    host sync (pinned, non-blocking on the card), and reused after."""
    device = torch.device(device)
    full = key + (device,)
    hit = _CONSTANTS.get(full)
    if hit is None:
        host = torch.from_numpy(make())
        if device.type == "cuda":
            host = host.pin_memory()
        hit = _CONSTANTS[full] = (host, host.to(device, non_blocking=True))
    return hit[1]


def sine_position_embedding(
    mask: torch.Tensor,
    num_pos_feats: int,
    temperature: float = 10000.0,
    normalize: bool = True,
    scale: float = 2 * math.pi,
) -> torch.Tensor:
    """1-D sine PE over the cumulative sum of the validity mask, (B, L, F)
    (reference position_encoding.py:35-72)."""
    x_embed = torch.cumsum(mask.float(), dim=1)
    if normalize:
        x_embed = x_embed / (x_embed[:, -1:] + 1e-6) * scale
    # dim_t built in float64 and rounded once, as the JAX package does
    def make():
        dim_np = np.arange(num_pos_feats, dtype=np.float64)
        return (temperature ** (2 * (dim_np // 2) / num_pos_feats)).astype(np.float32)

    dim_t = device_constant(("sine_dim_t", num_pos_feats, temperature), mask.device, make)
    pos = x_embed[:, :, None] / dim_t
    pos = torch.stack([torch.sin(pos[:, :, 0::2]), torch.cos(pos[:, :, 1::2])], dim=3)
    return pos.reshape(pos.shape[0], pos.shape[1], -1)


class TrainablePositionalEncoding(nn.Module):
    """Learned positions + LN + dropout over text tokens (reference
    position_encoding.py:10-32); live only under use_txt_pos."""

    def __init__(self, max_positions: int, d: int, dropout: float = 0.1):
        super().__init__()
        self.position_embeddings = nn.Embedding(max_positions, d)
        self.LayerNorm = LayerNorm(d, eps=1e-5)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x):
        pos = self.position_embeddings.weight[: x.shape[1]]
        return self.dropout(self.LayerNorm(x + pos[None]))


def drop_path(x: torch.Tensor, rate: float, training: bool) -> torch.Tensor:
    """Per-sample stochastic depth (reference transformer.py:454-467): a
    whole batch row of the branch is dropped with chance `rate`, survivors
    scaled by 1 / (1 - rate). Identity outside training."""
    if not training or rate == 0.0:
        return x
    keep = 1.0 - rate
    shape = (x.shape[0],) + (1,) * (x.ndim - 1)
    mask = torch.floor(keep + torch.rand(shape, dtype=x.dtype, device=x.device))
    return x / keep * mask


class DropPath(nn.Module):
    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x):
        return drop_path(x, self.rate, self.training)


class LinearLayer(nn.Module):
    """LayerNorm -> Dropout -> Linear -> optional ReLU (model.py:767-789);
    the dropout acts in train mode only."""

    def __init__(self, in_dim: int, out_dim: int, dropout: float, relu: bool):
        super().__init__()
        self.LayerNorm = LayerNorm(in_dim, eps=1e-5)
        self.net = nn.Sequential(nn.Dropout(dropout), nn.Linear(in_dim, out_dim))
        self.relu = relu

    def forward(self, x):
        x = self.net(self.LayerNorm(x))
        return F.relu(x) if self.relu else x


class InputProj(nn.ModuleList):
    """`n_layers` LinearLayers; ReLU on all but the last (model.py:98-110)."""

    def __init__(self, in_dim: int, hidden_dim: int, n_layers: int = 2,
                 dropout: float = 0.5):
        super().__init__(
            LinearLayer(
                in_dim if i == 0 else hidden_dim, hidden_dim, dropout,
                relu=(i != n_layers - 1),
            )
            for i in range(n_layers)
        )

    def forward(self, x):
        for layer in self:
            x = layer(x)
        return x


class MLP(nn.Module):
    """ReLU MLP, no activation after the last layer (model.py:755-765)."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int, num_layers: int):
        super().__init__()
        dims = [in_dim] + [hidden_dim] * (num_layers - 1) + [out_dim]
        self.layers = nn.ModuleList(
            nn.Linear(dims[i], dims[i + 1]) for i in range(num_layers)
        )

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


def _conv_lengthwise(conv: nn.Module, x: torch.Tensor, weight=None):
    """Apply a Conv1d over the L axis of a channels-last (B, L, C) tensor."""
    w = conv.weight if weight is None else weight
    y = F.conv1d(x.transpose(1, 2), w, conv.bias, conv.stride, conv.padding)
    return y.transpose(1, 2)


class ConvHead(nn.Module):
    """Conv1d(k) -> ReLU -> Conv1d(k) regression head (blocks.py:89-105).

    `mask` (B, L) zeroes the intermediate activations at invalid positions,
    so the second conv sees zeros past each sample's true length."""

    def __init__(self, dims: int, out_dims: int, kernel_size: int = 3):
        super().__init__()
        pad = kernel_size // 2
        self.module = nn.Sequential(
            nn.Identity(),
            nn.Conv1d(dims, dims, kernel_size, padding=pad),
            nn.ReLU(),
            nn.Conv1d(dims, out_dims, kernel_size, padding=pad),
        )

    def forward(self, x, mask: Optional[torch.Tensor] = None):
        x = _conv_lengthwise(self.module[1], x)
        if mask is not None:
            x = x * mask[..., None]
        x = F.relu(x)
        return _conv_lengthwise(self.module[3], x)


class ConfidenceScorer(nn.Module):
    """Conv stack along the point axis + MLP to a scalar (model.py:44-71).

    The reference holds Conv2d (out, in, 1, k) weights over a (B, C, 1, N)
    layout; that is a 1-D conv over N, run here as one with the (1, k)
    kernel squeezed."""

    def __init__(self, channels: int, kernel_size: int, num_conv_layers: int = 1,
                 num_mlp_layers: int = 3):
        super().__init__()
        pad = kernel_size // 2
        self.convs = nn.ModuleList(
            nn.Conv2d(channels, channels, (1, kernel_size), padding=(0, pad))
            for _ in range(num_conv_layers)
        )
        self.fc = MLP(channels, channels // 2, 1, num_mlp_layers)

    def forward(self, x, mask: Optional[torch.Tensor] = None):
        for conv in self.convs:
            y = F.conv1d(
                x.transpose(1, 2), conv.weight[:, :, 0, :], conv.bias,
                padding=conv.padding[1],
            )
            x = y.transpose(1, 2)
            if mask is not None:
                x = x * mask[..., None]
            x = F.relu(x)
        return self.fc(x)


class AdaPooling(nn.Module):
    """Attention-pool text tokens into one query embedding (blocks.py:73-85)."""

    def __init__(self, d: int):
        super().__init__()
        self.att = nn.Linear(d, 1, bias=False)

    def forward(self, x, mask):
        a = self.att(x)
        # -inf at the masked tokens (a + where(mask, 0, -inf) for finite a)
        a = a.masked_fill(mask[..., None] != 1, float("-inf"))
        a = torch.softmax(a, dim=1)  # (B, L, 1)
        return torch.einsum("bld,blo->bod", x, a)  # (B, 1, D)


class _ToChannelsFirst(nn.Module):
    def forward(self, x):
        return x.transpose(1, 2)


def _pyramid_level(d: int, stride: int) -> nn.Sequential:
    """log2(stride) x [Permute, Conv1d(2, s=2), Permute, LayerNorm, ReLU]
    (blocks.py:21-70); the reference builds but never applies `pre_conv`,
    so it is omitted. Stride 1 holds no parameters (a bare ReLU)."""
    layers: List[nn.Module] = []
    for _ in range(int(math.log2(stride))):
        layers += [
            _ToChannelsFirst(),
            nn.Conv1d(d, d, 2, stride=2),
            _ToChannelsFirst(),
            LayerNorm(d, eps=1e-5),
            nn.ReLU(),
        ]
    return nn.Sequential(*layers)


class ConvPyramid(nn.Module):
    """Temporal feature pyramid; each level from the full-resolution input.

    Reference quirk kept: the stride-1 level is `nn.ReLU(inplace=True)`,
    which mutates the input, so every later level and the returned
    `video_emb` see relu(x)."""

    def __init__(self, d: int, strides: Sequence[int]):
        super().__init__()
        self.strides = tuple(strides)
        self.blocks = nn.ModuleList(_pyramid_level(d, s) for s in self.strides)

    def forward(self, x) -> Tuple[List[torch.Tensor], torch.Tensor]:
        outs = []
        for s, block in zip(self.strides, self.blocks):
            if x.shape[1] < s:  # level structurally absent
                continue
            if s == 1:
                x = F.relu(x)
                outs.append(x)
            else:
                outs.append(block(x))
        return outs, x


def pool_mask(mask: torch.Tensor, stride: int) -> torch.Tensor:
    """Max-pool a (B, L) validity mask with kernel = stride = `stride`
    (reference blocks.py:63 F.max_pool1d); output length (L - s) // s + 1."""
    if stride == 1:
        return mask
    b, l = mask.shape
    out_len = (l - stride) // stride + 1
    trimmed = mask[:, : out_len * stride]
    return trimmed.reshape(b, out_len, stride).amax(dim=2)
