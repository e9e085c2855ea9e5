"""Phrase-aware LGI modules of the FlashVTG_ms variant, in PyTorch.

Counterpart of flashvtg_tpu/models/lgi.py (reference FlashVTG_ms/LGI.py):
PhraseGenerate (entropy-gated word importance and learnable phrase slots),
PhraseContext (Hadamard phrase x video maps, per-phrase temporal
self-attention, a phrase-conditioned low-rank dynamic convolution), TSA
(the temporal self-attention fusion stack) and SaliencyProj. Module and
parameter names are the reference's (phrase_att.i, kv_proj,
att.in_proj_weight, fc_t.0, phrase_proj.0 / .2, kernel_params.k3, ...), so
a reference FlashVTG_ms `.ckpt` loads with strict=True, as
`utils.convert.state_dict_from_jax_ms` output does.

The attention cores here are plain PyTorch (einsum, softmax, dropout): they
are XLA on the JAX side, not Pallas, and are not routed through the port's
kernels. Dropout (train mode) draws from torch's generator of the tensor's
device, as the FFN dropout of models/transformer.py does.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from flashvtg_tpu_torch.models.components import sine_position_embedding
from flashvtg_tpu_torch.ops.layer_norm import LayerNorm
from flashvtg_tpu_torch.utils.runtime import widened


def _split_heads(x, num_heads):
    b, l, d = x.shape
    return x.reshape(b, l, num_heads, d // num_heads).transpose(1, 2)


def _merge_heads(x):
    b, h, l, hd = x.shape
    return x.transpose(1, 2).reshape(b, l, h * hd)


class MHACore(nn.Module):
    """torch nn.MultiheadAttention's function and parameters (packed
    in_proj, out_proj): q, k, v projected, q scaled by head_dim^-0.5 after
    its projection, keys with key_valid <= 0 masked to -inf, softmax in
    float32, dropout on the probabilities, out projection. With `need_weights` the
    head mean of the undropped probabilities is returned too."""

    def __init__(self, d: int, num_heads: int, dropout: float = 0.1):
        super().__init__()
        self.num_heads = num_heads
        self.dropout = dropout
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d, d))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d))
        self.out_proj = nn.Linear(d, d)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, q_in, k_in, v_in, key_valid=None, need_weights: bool = False):
        d = q_in.shape[-1]
        w, b = self.in_proj_weight, self.in_proj_bias
        hd = d // self.num_heads
        q = _split_heads(F.linear(q_in, w[:d], b[:d]) * hd ** -0.5, self.num_heads)
        k = _split_heads(F.linear(k_in, w[d : 2 * d], b[d : 2 * d]), self.num_heads)
        v = _split_heads(F.linear(v_in, w[2 * d :], b[2 * d :]), self.num_heads)
        # the einsums follow the precision dial (bf16 under autocast); the
        # mask, the softmax and the head mean stay in float32 (or float64), so the -inf
        # fill and the probabilities keep f32 range and rounding
        (logits,) = widened(torch.einsum("bhqd,bhkd->bhqk", q, k))
        if key_valid is not None:
            logits = logits.masked_fill((key_valid <= 0)[:, None, None, :], float("-inf"))
        weights = torch.softmax(logits, dim=-1)
        dropped = F.dropout(weights, self.dropout, self.training)
        out = self.out_proj(_merge_heads(torch.einsum("bhqk,bhkd->bhqd", dropped, v)))
        head_mean = weights.sum(dim=1) / self.num_heads if need_weights else None
        return out, head_mean


class CrossAttentionBlock(nn.Module):
    """LGI CrossAttention (LGI.py:536-572): q and kv projections around an
    MHA, residual + LN, then a ReLU linear with residual + LN. Returns the
    updated queries and the head-mean attention."""

    def __init__(self, d: int, num_heads: int, dropout: float = 0.1):
        super().__init__()
        self.q_proj = nn.Linear(d, d)
        self.kv_proj = nn.Linear(d, 2 * d)
        self.att = MHACore(d, num_heads, dropout)
        self.norm = LayerNorm(d, eps=1e-5)
        self.linear = nn.Linear(d, d)
        self.norm1 = LayerNorm(d, eps=1e-5)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x, y, key_valid=None):
        k, v = self.kv_proj(y).chunk(2, dim=-1)
        att, attn = self.att(self.q_proj(x), k, v, key_valid, need_weights=True)
        x = self.norm(x + self.dropout(att))
        update = self.dropout(F.relu(self.linear(x)))
        return self.norm1(x + update), attn


class SelfAttentionBlock(nn.Module):
    """LGI SelfAttention (LGI.py:447-476): q / k / v pre-projections, MHA,
    residual + LN."""

    def __init__(self, d: int, num_heads: int, dropout: float = 0.1):
        super().__init__()
        self.q_proj = nn.Linear(d, d)
        self.k_proj = nn.Linear(d, d)
        self.v_proj = nn.Linear(d, d)
        self.att = MHACore(d, num_heads, dropout)
        self.norm = LayerNorm(d, eps=1e-5)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x, valid=None):
        update, _ = self.att(self.q_proj(x), self.k_proj(x), self.v_proj(x), valid)
        return self.norm(x + self.dropout(update))


class PhraseGenerate(nn.Module):
    """Entropy-gated phrase slots (LGI.py:137-244). Word importance is 1 -
    the normalised entropy of each word's attention over the valid clips;
    learnable slots cross-attend to the gated words (layer 0) and to the
    words with their positions (later layers). Returns (slots (B, N, C),
    word->video attention (B, Lq - 1, Lv), gate (B, Lq - 1), the layers'
    mean slot attention (B, N, Lq - 1))."""

    def __init__(self, d: int, num_phrase: int, num_heads: int, dropout: float,
                 num_layers: int):
        super().__init__()
        self.word_proj = nn.Linear(d, d)
        self.video_proj = nn.Linear(d, d)
        self.learnable_phrase = nn.Parameter(torch.randn(1, num_phrase, d))
        self.phrase_att = nn.ModuleList(
            CrossAttentionBlock(d, num_heads, dropout) for _ in range(num_layers)
        )

    def forward(self, txt_emb, txt_mask, video_feats, video_mask):
        b, _, c = txt_emb.shape
        word_emb, word_mask = txt_emb[:, 1:], txt_mask[:, 1:]
        word_pos = sine_position_embedding(word_mask, c, normalize=False)

        # entropy gate over the word -> video attention (LGI.py:157-181)
        sim = torch.einsum("blc,btc->blt", self.word_proj(word_emb),
                           self.video_proj(video_feats))
        sim = sim.masked_fill((video_mask <= 0)[:, None, :], float("-inf"))
        attn = torch.softmax(sim, dim=2)
        entropy = -(attn * torch.log(attn + 1e-6)).sum(dim=2)
        vid_len = video_mask.sum(dim=1)
        gate = (1.0 - entropy / torch.log(vid_len + 1e-6)[:, None]).clamp(0.0, 1.0)

        slots = self.learnable_phrase.expand(b, -1, -1)
        slot_attns = []
        words = gate[..., None] * word_emb + word_pos
        for i, layer in enumerate(self.phrase_att):
            if i == 1:
                words = word_emb + word_pos
            slots, a = layer(slots, words, word_mask)
            slot_attns.append(a)
        return slots, attn, gate, torch.stack(slot_attns, dim=1).mean(dim=1)


class HadamardProduct(nn.Module):
    """Phrase x video bilinear maps (LGI.py:426-445): (B, N, T, C)."""

    def __init__(self, d: int):
        super().__init__()
        self.fc_1 = nn.Linear(d, d)
        self.fc_2 = nn.Linear(d, d)
        self.fc_3 = nn.Linear(d, d)
        self.norm = LayerNorm(d, eps=1e-5)
        self.norm1 = LayerNorm(d, eps=1e-5)

    def forward(self, phrase, video):
        x1 = F.relu(self.fc_1(phrase))[:, :, None, :]
        x2 = F.relu(self.fc_2(video))[:, None, :, :]
        x = self.fc_3(self.norm(x1 * x2))
        return F.relu(self.norm1(x))


class LowRankDynamicConv(nn.Module):
    """Phrase-conditioned dynamic temporal convolution (LGI.py:283-359). For
    each kernel size k a rank-`rank` phrase-specific kernel contracts the
    (k x N x C) window of the per-phrase context maps around each clip into
    a C vector; the k's outputs are concatenated -> linear -> dropout -> LN
    -> ReLU. context_emb (B, T, N, C), phrase_slot (B, N, C)."""

    def __init__(self, d: int, rank: int = 32, t_kernels: Sequence[int] = (1, 3, 5),
                 dropout: float = 0.1):
        super().__init__()
        self.rank = rank
        self.t_kernels = tuple(t_kernels)
        self.phrase_proj = nn.Sequential(
            nn.Linear(d, 4 * d), nn.ReLU(), nn.Linear(4 * d, d * rank)
        )
        self.kernel_params = nn.ParameterDict(
            {f"k{k}": nn.Parameter(torch.randn(rank, d, k)) for k in self.t_kernels}
        )
        self.linear_out = nn.Linear(len(self.t_kernels) * d, d)
        self.norm = LayerNorm(d, eps=1e-5)
        self.dropout = nn.Dropout(dropout)

    def forward(self, context_emb, phrase_slot):
        b, t, n, c = context_emb.shape
        pp = self.phrase_proj(phrase_slot).reshape(b, n, c, self.rank)
        outs = []
        for k in self.t_kernels:
            dyn = torch.einsum("bncr,rdk->bnckd", pp, self.kernel_params[f"k{k}"])
            pad = k // 2
            xp = F.pad(context_emb, (0, 0, 0, 0, pad, pad))
            window = torch.stack([xp[:, i : i + t] for i in range(k)], dim=2)  # (B,T,k,N,C)
            outs.append(torch.einsum("btknc,bnckd->btd", window, dyn))
        out = self.dropout(self.linear_out(torch.cat(outs, dim=-1)))
        return F.relu(self.norm(out))


class PhraseContextLayer(nn.Module):
    """Per-phrase temporal self-attention + FFN (LGI.py:363-384)."""

    def __init__(self, d: int, num_heads: int, dropout: float = 0.1):
        super().__init__()
        self.t_att = SelfAttentionBlock(d, num_heads, dropout)
        self.fc_t = nn.Sequential(nn.Linear(d, d), nn.ReLU(), nn.Dropout(dropout))
        self.norm_t = LayerNorm(d, eps=1e-5)

    def forward(self, x, valid):
        x = self.t_att(x, valid)
        return self.norm_t(x + self.fc_t(x))


class PhraseContext(nn.Module):
    """Hadamard maps -> temporal self-attention per phrase -> dynamic
    convolution (LGI.py:387-424). Returns (the aggregate (B, T, C), the raw
    maps (B, N, T, C), the refined maps (B, N, T, C))."""

    def __init__(self, d: int, num_layers: int, num_heads: int, dropout: float,
                 rank: int = 32, t_kernels: Sequence[int] = (1, 3, 5)):
        super().__init__()
        self.product = HadamardProduct(d)
        self.layers = nn.ModuleList(
            PhraseContextLayer(d, num_heads, dropout) for _ in range(num_layers)
        )
        self.local_context = LowRankDynamicConv(d, rank, t_kernels, dropout)

    def forward(self, phrase_slot, vid_feat, vid_mask):
        b, t, c = vid_feat.shape
        n = phrase_slot.shape[1]
        maps = self.product(phrase_slot, vid_feat)  # (B, N, T, C)
        x = maps.reshape(b * n, t, c)
        mask_rep = vid_mask.repeat_interleave(n, dim=0)  # row b*n + i is video b
        x = x + sine_position_embedding(mask_rep, c, normalize=False)
        for layer in self.layers:
            x = layer(x, mask_rep)
        refined = x.reshape(b, n, t, c)
        agg = self.local_context(refined.transpose(1, 2), phrase_slot)
        return agg, maps, refined


class TSALayer(nn.Module):
    """Temporal self-attention + ReLU linear with residual + LN. `norm1` is
    the reference's parameter that its forward never applies (held so that
    a reference checkpoint loads with strict=True)."""

    def __init__(self, d: int, num_heads: int, dropout: float = 0.1):
        super().__init__()
        self.t_att = SelfAttentionBlock(d, num_heads, dropout)
        self.linear = nn.Linear(d, d)
        self.norm = LayerNorm(d, eps=1e-5)
        self.norm1 = LayerNorm(d, eps=1e-5)  # unread
        self.dropout = nn.Dropout(dropout)

    def forward(self, x, valid=None):
        x = self.t_att(x, valid)
        return self.norm(x + self.dropout(F.relu(self.linear(x))))


class TSA(nn.Module):
    """Temporal self-attention fusion stack (LGI.py:625-642)."""

    def __init__(self, d: int, num_heads: int, dropout: float = 0.1, num_layers: int = 2):
        super().__init__()
        self.layers = nn.ModuleList(
            TSALayer(d, num_heads, dropout) for _ in range(num_layers)
        )

    def forward(self, x, valid=None):
        for layer in self.layers:
            x = layer(x, valid)
        return x


class SaliencyProj(nn.Module):
    """Clip-vs-global saliency head (LGI.py:673-690): the global vector is
    the mean over the valid clips, or over the whole padded length when
    `valid` is None (the reference's train path)."""

    def __init__(self, d: int):
        super().__init__()
        self.proj1 = nn.Linear(d, d)
        self.proj2 = nn.Linear(d, d)

    def forward(self, x, valid: Optional[torch.Tensor] = None):
        d = x.shape[-1]
        if valid is None:
            global_x = x.mean(dim=1)
        else:
            denom = valid.sum(dim=1, keepdim=True).clamp_min(1.0)
            global_x = (x * valid[..., None]).sum(dim=1) / denom
        return (self.proj1(x) * self.proj2(global_x)[:, None, :]).sum(-1) / math.sqrt(d)
