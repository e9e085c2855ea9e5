"""Plain masked-softmax attention for the reference model, forward and
backward, one block of query rows at a time.

One function covers every attention core of FlashVTG: the Adaptive
Cross-Attention (ACA: dummy keys take part in the softmax and the head mean
but not in p.v; the training mask of "donor" rows) and the self-attention
of the encoders (no dummies, no head mean). It is written from the model's
equations, softmax(q k^T / sqrt(Dh) + mask) v, and computes the logits of
one block of rows at a time, so that Lv = 2048 fits: the forward keeps the
row log-sum-exp and the backward recomputes the probabilities from it.

Attention dropout keeps probability (b, h, i, j) by a 32-bit integer hash of
(seed, b * H + h, i, j) and scales the survivors by 1 / (1 - p); the hash
is FlashVTG's port's documented mask (keep when the top 24 bits of the hash
are at or above p * 2^24), written out again here.

`form` (reference/forms.py:Form) rounds the operands of every product
(`form.op`) and, in the backward, the gradients that enter one
(`form.grad`); none for the reference itself. Sums are in the tensors'
dtype.
"""

from __future__ import annotations

import torch

from vtgbench.reference.forms import Form

_M32 = 0xFFFFFFFF
_MUL1, _MUL2, _MUL_KEY = 0x7FEB352D, 0x2C1B3C6D, 0x27D4EB2D
ROWS = 256  # query rows a block


def _mix32(x):
    x = x ^ (x >> 16)
    x = (x * _MUL1) & _M32
    x = x ^ (x >> 15)
    x = (x * _MUL2) & _M32
    return x ^ (x >> 16)


def keep_scale(seed, p, b, h, rows, lk, dtype):
    """(B, H, len(rows), Lk): 1 / (1 - p) where (b, h, row, j) survives,
    else 0; `seed` a 0-d integer tensor."""
    device = rows.device
    seed = seed.to(device=device, dtype=torch.int64) & _M32
    bh = torch.arange(b * h, device=device, dtype=torch.int64).view(b, h)
    head = _mix32(seed ^ _mix32(bh))
    row = _mix32((head[..., None] + rows.to(torch.int64)) & _M32)
    key = (torch.arange(lk, device=device, dtype=torch.int64) * _MUL_KEY) & _M32
    keep = (_mix32(row[..., None] ^ key) >> 8) >= int(p * (1 << 24))
    return keep.to(dtype) * (1.0 / (1.0 - p))


def _heads(x, h):
    b, l, d = x.shape
    return x.reshape(b, l, h, d // h).transpose(1, 2)


def _merge(x):
    b, h, l, hd = x.shape
    return x.transpose(1, 2).reshape(b, l, h * hd)


def _masked(qh, kh, i0, key_valid, donor_q, donor_rows, donor_k, op):
    logits = torch.einsum("bhqd,bhkd->bhqk", op(qh[:, :, i0:i0 + ROWS]), op(kh))
    masked = (key_valid <= 0)[:, None, None, :]
    if donor_rows is not None:
        qpad = (donor_q <= 0)[donor_rows][:, :, i0:i0 + ROWS]  # (B, H, rows)
        kpad = (donor_k <= 0)[donor_rows]  # (B, H, Lk)
        masked = masked | (qpad[..., :, None] & kpad[..., None, :])
    return logits.masked_fill(masked, float("-inf"))


class Attention(torch.autograd.Function):
    """out (B, Lq, H*Dh) and the head-mean map (B, Lq, Lk) or None."""

    @staticmethod
    def forward(ctx, q, k, v, key_valid, heads, nd, head_mean, p, seed, donor_q, donor_rows,
                donor_k, form):
        op = form.op
        scale = (q.shape[-1] // heads) ** -0.5
        qh, kh, vh = _heads(q * scale, heads), _heads(k, heads), _heads(v, heads)
        b, h, lq, _ = qh.shape
        lk = kh.shape[2]
        outs, lses, means = [], [], []
        for i0 in range(0, lq, ROWS):
            logits = _masked(qh, kh, i0, key_valid, donor_q, donor_rows, donor_k, op)
            lse = torch.logsumexp(logits, dim=-1)
            w = torch.exp(logits - lse[..., None])
            if head_mean:
                means.append(w.sum(dim=1) / heads)
            if p > 0:
                rows = torch.arange(i0, i0 + w.shape[2], device=q.device)
                w = w * keep_scale(seed, p, b, h, rows, lk, w.dtype)
            outs.append(torch.einsum("bhqk,bhkd->bhqd", op(w[..., nd:]), op(vh[:, :, nd:])))
            lses.append(lse)
        ctx.save_for_backward(q, k, v, key_valid, torch.cat(lses, dim=2), seed, donor_q,
                              donor_rows, donor_k)
        ctx.args = (heads, nd, p, form)
        out = _merge(torch.cat(outs, dim=2))
        return out, (torch.cat(means, dim=1) if head_mean else None)

    @staticmethod
    def backward(ctx, d_out, d_mean):
        q, k, v, key_valid, lse, seed, donor_q, donor_rows, donor_k = ctx.saved_tensors
        heads, nd, p, form = ctx.args
        op, gr = form.op, form.grad
        scale = (q.shape[-1] // heads) ** -0.5
        qh, kh, vh = _heads(q * scale, heads), _heads(k, heads), _heads(v, heads)
        doh = _heads(d_out, heads)
        b, h, lq, _ = qh.shape
        lk = kh.shape[2]
        dk, dv = torch.zeros_like(kh), torch.zeros_like(vh)
        dqs = []
        for i0 in range(0, lq, ROWS):
            logits = _masked(qh, kh, i0, key_valid, donor_q, donor_rows, donor_k, op)
            pr = torch.exp(logits - lse[:, :, i0:i0 + ROWS, None])
            z = torch.ones_like(pr)
            if p > 0:
                rows = torch.arange(i0, i0 + pr.shape[2], device=q.device)
                z = keep_scale(seed, p, b, h, rows, lk, pr.dtype)
            z[..., :nd] = 0  # dummy keys never reach p.v
            do_c = doh[:, :, i0:i0 + ROWS]
            dp = z * torch.einsum("bhqd,bhkd->bhqk", gr(do_c), op(vh))
            if d_mean is not None:
                dp = dp + d_mean[:, None, i0:i0 + ROWS] / heads
            ds = pr * (dp - (pr * dp).sum(dim=-1, keepdim=True))
            dqs.append(torch.einsum("bhqk,bhkd->bhqd", gr(ds), op(kh)) * scale)
            dk = dk + torch.einsum("bhqk,bhqd->bhkd", gr(ds), op(qh[:, :, i0:i0 + ROWS]))
            dv = dv + torch.einsum("bhqk,bhqd->bhkd", op(pr * z), gr(do_c))
        return ((_merge(torch.cat(dqs, dim=2)), _merge(dk), _merge(dv))
                + (None,) * 10)


def attention(q, k, v, key_valid, heads, nd=0, head_mean=False, p=0.0, seed=None,
              donor_q=None, donor_rows=None, donor_k=None, form=Form()):
    """Masked attention of merged-head q (B, Lq, D), k and v (B, Lk, D) with
    key mask key_valid (B, Lk); `nd` leading dummy keys left out of p.v;
    with donor_rows (B, H) the ACA training mask also hides (i, j) where
    donor_q[d, i] and donor_k[d, j] are both padding, d = donor_rows[b, h].
    Returns (out, head_mean or None)."""
    if seed is None:
        seed = torch.zeros((), dtype=torch.int32, device=q.device)
    return Attention.apply(q, k, v, key_valid, heads, nd, head_mean, p, seed, donor_q,
                           donor_rows, donor_k, form)
