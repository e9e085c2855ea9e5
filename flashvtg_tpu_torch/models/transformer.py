"""FlashVTG transformer stack in PyTorch (channels-last, mask-driven).

Counterpart of flashvtg_tpu/models/transformer.py. Every attention core runs
through a hand-written kernel: the Adaptive Cross-Attention with its
dummy-dropping value product and fused head mean (ops/aca.py), and the
masked self-attention, which goes by key count: up to aca.MAX_KEYS (128) to
the same kernel with no dummies, past it to the memory-linear flash kernel
(ops/chunked_attn.py). Only the projections around the kernels are F.linear. Layer attribute names are the reference's
(self_attn, linear1, activation, linear2, norm1, norm2), so reference
checkpoints load as they are.

Eval only: the train-time donor-row mask (JAX transformer.py:34-67,
107-116), dropout and DropPath are identities here and are not ported.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from flashvtg_tpu_torch.ops.aca import MAX_KEYS, aca_attention, masked_attention
from flashvtg_tpu_torch.ops.chunked_attn import flash_attention


class AdaptiveCrossAttention(nn.Module):
    """Projection-less multi-head cross attention with dummy-token dropping.

    q (B, Lv, D) video queries (pos added), k (B, Lk, D) text keys (dummies
    first, pos added), v (B, Lk, D) raw text values, key_valid (B, Lk).
    Returns out_proj(out) and the head-mean map (B, Lv, Lk)."""

    def __init__(self, d: int, num_heads: int, num_dummies: int):
        super().__init__()
        self.num_heads = num_heads
        self.num_dummies = num_dummies
        self.out_proj = nn.Linear(d, d)

    def forward(self, q, k, v, key_valid):
        out, head_mean = aca_attention(
            q, k, v, key_valid, self.num_heads, self.num_dummies,
            want_head_mean=True,
        )
        return self.out_proj(out), head_mean


class T2VEncoderLayer(nn.Module):
    """One ACA layer. The FFN reads LN1(x) but the residual accumulates on
    the un-normalized x; LN2 closes the block (reference transformer.py:311-369)."""

    def __init__(self, d: int, num_heads: int, num_dummies: int,
                 dim_feedforward: int):
        super().__init__()
        self.self_attn = AdaptiveCrossAttention(d, num_heads, num_dummies)
        self.linear1 = nn.Linear(d, dim_feedforward)
        self.activation = nn.PReLU()
        self.linear2 = nn.Linear(dim_feedforward, d)
        self.norm1 = nn.LayerNorm(d, eps=1e-5)
        self.norm2 = nn.LayerNorm(d, eps=1e-5)

    def forward(self, vid, txt, pos_vid, pos_txt, txt_valid):
        attn_out, attn_weights = self.self_attn(
            vid + pos_vid, txt + pos_txt, txt, txt_valid
        )
        x = vid + attn_out
        x = x + self.linear2(self.activation(self.linear1(self.norm1(x))))
        return self.norm2(x), attn_weights


class T2VEncoder(nn.Module):
    """Stack of ACA layers; returns the fused video and the layer-averaged
    head-mean map (reference transformer.py:179-214)."""

    def __init__(self, num_layers: int, d: int, num_heads: int, num_dummies: int,
                 dim_feedforward: int):
        super().__init__()
        self.layers = nn.ModuleList(
            T2VEncoderLayer(d, num_heads, num_dummies, dim_feedforward)
            for _ in range(num_layers)
        )

    def forward(self, vid, txt, pos_vid, pos_txt, txt_valid):
        attn_sum = None
        for layer in self.layers:
            vid, w = layer(vid, txt, pos_vid, pos_txt, txt_valid)
            attn_sum = w if attn_sum is None else attn_sum + w
        return vid, attn_sum / len(self.layers)


class SelfAttention(nn.Module):
    """Multi-head self-attention, q = k = x + pos, v = x, with the packed
    q/k/v projection of torch's nn.MultiheadAttention.

    The JAX layer switches to its query-chunked form past attn_chunk (512)
    clips; both of its forms compute the same function, so the switch here
    follows what the kernels take: masked_attention up to MAX_KEYS keys,
    flash_attention beyond."""

    def __init__(self, d: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d, d))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d))
        self.out_proj = nn.Linear(d, d)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, x, pos, valid):
        d = x.shape[-1]
        w, b = self.in_proj_weight, self.in_proj_bias
        qk_in = x if pos is None else x + pos
        q = F.linear(qk_in, w[:d], b[:d])
        k = F.linear(qk_in, w[d : 2 * d], b[d : 2 * d])
        v = F.linear(x, w[2 * d :], b[2 * d :])
        attend = masked_attention if x.shape[1] <= MAX_KEYS else flash_attention
        return self.out_proj(attend(q, k, v, valid, self.num_heads))


class EncoderLayer(nn.Module):
    """Post-norm encoder layer (reference transformer.py:387-421)."""

    def __init__(self, d: int, num_heads: int, dim_feedforward: int):
        super().__init__()
        self.self_attn = SelfAttention(d, num_heads)
        self.linear1 = nn.Linear(d, dim_feedforward)
        self.activation = nn.PReLU()
        self.linear2 = nn.Linear(dim_feedforward, d)
        self.norm1 = nn.LayerNorm(d, eps=1e-5)
        self.norm2 = nn.LayerNorm(d, eps=1e-5)

    def forward(self, x, pos, valid):
        x = self.norm1(x + self.self_attn(x, pos, valid))
        return self.norm2(x + self.linear2(self.activation(self.linear1(x))))


class Encoder(nn.Module):
    def __init__(self, num_layers: int, d: int, num_heads: int,
                 dim_feedforward: int):
        super().__init__()
        self.layers = nn.ModuleList(
            EncoderLayer(d, num_heads, dim_feedforward)
            for _ in range(num_layers)
        )

    def forward(self, x, pos, valid):
        for layer in self.layers:
            x = layer(x, pos, valid)
        return x
