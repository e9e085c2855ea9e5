"""FlashVTG transformer stack in PyTorch (channels-last, mask-driven).

Counterpart of flashvtg_tpu/models/transformer.py. Every attention core runs
through a hand-written kernel: the Adaptive Cross-Attention with its
dummy-dropping value product and fused head mean (ops/aca.py), and the
masked self-attention, which goes by key count: up to aca.MAX_KEYS (128) to
the same kernel with no dummies, past it to the memory-linear flash kernel
(ops/chunked_attn.py). In training each core goes through its kernels'
autograd Function (forward with the row log-sum-exp, attention dropout
evaluated in the kernel, backward kernel). Only the projections around the
kernels are F.linear. Layer attribute names are the reference's (self_attn,
linear1, activation, dropout, linear2, norm1, norm2, dropout1, dropout2),
so reference checkpoints load as they are.

Train mode (module.train()) adds what the JAX layers do with
deterministic=False: attention dropout, FFN dropout, DropPath on both
residual branches, and, when the caller passes donor rows, the reference's
misaligned ACA train mask (`tiled_attn_donors`, `neg_pass_donors`). Donor
rows index the whole batch: under data parallelism (parallel/mesh.py) the
caller computes them over the global batch, keeps its own rows, and hands
the ACA layers the global batch's masks as the donor tables.
Attention-dropout seeds are drawn from the `generator` a forward is given
(torch's default CPU generator when None), one per attention call; FFN
dropout and DropPath draw from torch's generator of the tensor's device.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from flashvtg_tpu_torch.models.components import DropPath
from flashvtg_tpu_torch.ops.aca import MAX_KEYS, aca_attention, masked_attention
from flashvtg_tpu_torch.ops.chunked_attn import flash_attention
from flashvtg_tpu_torch.ops.layer_norm import LayerNorm


def tiled_attn_donors(batch: int, num_heads: int, device=None) -> torch.Tensor:
    """(B, H) donor rows of the reference's misaligned ACA attn_mask
    (JAX transformer.py:34-48): the per-row (query_pad x key_pad) mask is
    tiled head-major but read batch-major, so row b, head h is masked with
    row (b * H + h) % B's padding pattern."""
    b = torch.arange(batch, device=device)[:, None]
    h = torch.arange(num_heads, device=device)[None, :]
    return (b * num_heads + h) % batch


def neg_pass_donors(real_neg_mask: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Donor rows of the negative pass (JAX transformer.py:51-67): the
    reference runs it on the real-negative rows only, so the donor
    arithmetic runs over their filtered indices, mapped back to batch rows.
    Rows that are not real negatives get a valid donor; their outputs are
    excluded from every loss."""
    m = real_neg_mask > 0
    order = torch.argsort((~m).to(torch.int8), stable=True)  # real negatives first
    r = m.sum().clamp_min(1)
    fidx = (torch.cumsum(m.long(), dim=0) - 1).clamp_min(0)
    h = torch.arange(num_heads, device=real_neg_mask.device)[None, :]
    return order[(fidx[:, None] * num_heads + h) % r]


class AdaptiveCrossAttention(nn.Module):
    """Projection-less multi-head cross attention with dummy-token dropping.

    q (B, Lv, D) video queries (pos added), k (B, Lk, D) text keys (dummies
    first, pos added), v (B, Lk, D) raw text values, key_valid (B, Lk).
    Returns out_proj(out) and the head-mean map (B, Lv, Lk), whose
    probabilities are never dropped."""

    def __init__(self, d: int, num_heads: int, num_dummies: int, dropout: float = 0.1):
        super().__init__()
        self.num_heads = num_heads
        self.num_dummies = num_dummies
        self.dropout = dropout
        self.out_proj = nn.Linear(d, d)

    def forward(self, q, k, v, key_valid, donor_query_valid=None, donor_rows=None,
                generator: Optional[torch.Generator] = None, donor_key_valid=None):
        out, head_mean = aca_attention(
            q, k, v, key_valid, self.num_heads, self.num_dummies, want_head_mean=True,
            dropout=self.dropout if self.training else 0.0, generator=generator,
            donor_query_valid=donor_query_valid, donor_rows=donor_rows,
            donor_key_valid=donor_key_valid,
        )
        return self.out_proj(out), head_mean


class T2VEncoderLayer(nn.Module):
    """One ACA layer. The FFN reads LN1(x) but the residual accumulates on
    the un-normalized x; LN2 closes the block (reference transformer.py:311-369)."""

    def __init__(self, d: int, num_heads: int, num_dummies: int,
                 dim_feedforward: int, dropout: float = 0.1):
        super().__init__()
        self.self_attn = AdaptiveCrossAttention(d, num_heads, num_dummies, dropout)
        self.linear1 = nn.Linear(d, dim_feedforward)
        self.activation = nn.PReLU()
        self.dropout = nn.Dropout(dropout)
        self.linear2 = nn.Linear(dim_feedforward, d)
        self.norm1 = LayerNorm(d, eps=1e-5)
        self.norm2 = LayerNorm(d, eps=1e-5)
        self.dropout1 = DropPath(dropout)
        self.dropout2 = DropPath(dropout)

    def forward(self, vid, txt, pos_vid, pos_txt, txt_valid, vid_valid=None,
                donor_rows=None, generator=None, txt_valid_table=None):
        attn_out, attn_weights = self.self_attn(
            vid + pos_vid, txt + pos_txt, txt, txt_valid, vid_valid, donor_rows, generator,
            txt_valid_table,
        )
        x = vid + self.dropout1(attn_out)
        ffn = self.linear2(self.dropout(self.activation(self.linear1(self.norm1(x)))))
        x = x + self.dropout2(ffn)
        return self.norm2(x), attn_weights


class T2VEncoder(nn.Module):
    """Stack of ACA layers; returns the fused video and the layer-averaged
    head-mean map (reference transformer.py:179-214). With donor_rows,
    vid_valid and txt_valid_table (None: txt_valid) are the donor tables."""

    def __init__(self, num_layers: int, d: int, num_heads: int, num_dummies: int,
                 dim_feedforward: int, dropout: float = 0.1):
        super().__init__()
        self.layers = nn.ModuleList(
            T2VEncoderLayer(d, num_heads, num_dummies, dim_feedforward, dropout)
            for _ in range(num_layers)
        )

    def forward(self, vid, txt, pos_vid, pos_txt, txt_valid, vid_valid=None,
                donor_rows=None, generator=None, txt_valid_table=None):
        attn_sum = None
        for layer in self.layers:
            vid, w = layer(vid, txt, pos_vid, pos_txt, txt_valid, vid_valid, donor_rows,
                           generator, txt_valid_table)
            attn_sum = w if attn_sum is None else attn_sum + w
        return vid, attn_sum / len(self.layers)


class SelfAttention(nn.Module):
    """Multi-head self-attention, q = k = x + pos, v = x, with the packed
    q/k/v projection of torch's nn.MultiheadAttention.

    The JAX layer switches to its query-chunked form past attn_chunk (512)
    clips; both of its forms compute the same function, so the switch here
    follows what the kernels take: masked_attention up to MAX_KEYS keys,
    flash_attention beyond."""

    def __init__(self, d: int, num_heads: int, dropout: float = 0.1):
        super().__init__()
        self.num_heads = num_heads
        self.dropout = dropout
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d, d))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d))
        self.out_proj = nn.Linear(d, d)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, x, pos, valid, generator=None):
        d = x.shape[-1]
        w, b = self.in_proj_weight, self.in_proj_bias
        qk_in = x if pos is None else x + pos
        q = F.linear(qk_in, w[:d], b[:d])
        k = F.linear(qk_in, w[d : 2 * d], b[d : 2 * d])
        v = F.linear(x, w[2 * d :], b[2 * d :])
        attend = masked_attention if x.shape[1] <= MAX_KEYS else flash_attention
        out = attend(q, k, v, valid, self.num_heads,
                     dropout=self.dropout if self.training else 0.0, generator=generator)
        return self.out_proj(out)


class EncoderLayer(nn.Module):
    """Post-norm encoder layer (reference transformer.py:387-421)."""

    def __init__(self, d: int, num_heads: int, dim_feedforward: int, dropout: float = 0.1):
        super().__init__()
        self.self_attn = SelfAttention(d, num_heads, dropout)
        self.linear1 = nn.Linear(d, dim_feedforward)
        self.activation = nn.PReLU()
        self.dropout = nn.Dropout(dropout)
        self.linear2 = nn.Linear(dim_feedforward, d)
        self.norm1 = LayerNorm(d, eps=1e-5)
        self.norm2 = LayerNorm(d, eps=1e-5)
        self.dropout1 = DropPath(dropout)
        self.dropout2 = DropPath(dropout)

    def forward(self, x, pos, valid, generator=None):
        x = self.norm1(x + self.dropout1(self.self_attn(x, pos, valid, generator)))
        ffn = self.linear2(self.dropout(self.activation(self.linear1(x))))
        return self.norm2(x + self.dropout2(ffn))


class Encoder(nn.Module):
    def __init__(self, num_layers: int, d: int, num_heads: int,
                 dim_feedforward: int, dropout: float = 0.1):
        super().__init__()
        self.layers = nn.ModuleList(
            EncoderLayer(d, num_heads, dim_feedforward, dropout)
            for _ in range(num_layers)
        )

    def forward(self, x, pos, valid, generator=None):
        for layer in self.layers:
            x = layer(x, pos, valid, generator)
        return x
