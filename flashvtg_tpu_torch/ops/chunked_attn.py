"""Memory-linear masked self-attention for long clip sequences: kernels +
plain versions, forward and backward.

Counterpart of flashvtg_tpu/ops/chunked_attn.py, which the JAX encoder runs
whenever a video has more clips than attn_chunk (the long-video presets:
2048 clips at tacos and charades_vgg), and whose backward the JAX train step
gets from jax.checkpoint (each query chunk's probabilities recomputed).
Kernels, hand-written CUDA for sm_90a, their products on the tensor cores in
3xTF32 (f32-accurate), that never hold the
(B, H, L, L) logits in device memory:
  * csrc/flash_attention.cu, an online softmax over key tiles; it takes the
    place of the long, memory-linear form of JAX's library Pallas
    flash_attention (scripts/bench_flash.py:57). Its training form also
    writes the row log-sum-exp and applies attention dropout
    (ops/attn_dropout.py) inside the tile loop.
  * csrc/flash_attention_bwd.cu, the FlashAttention-2 backward: it takes the
    place of that library kernel's VJP (timed as forward + backward at
    scripts/bench_flash.py:62-74), recomputing the probabilities from q, k
    and the log-sum-exp.
What bounds each kernel on the card, and what its design does about it, is
written at the top of its source.

  * chunked_attention_plain(q, k, v, valid, chunk_size, ...): the JAX
    function's layout, (B, H, L, Dh) with q pre-scaled, one query chunk at a
    time.
  * flash_attention(q, k, v, key_valid, num_heads, dropout, generator) and
    flash_attention_plain(...): the model's merged-head layout (B, L, H*Dh),
    as ops/aca.py:masked_attention; flash_attention_bwd_plain is the
    backward's plain version.

Without gradients or dropout (eval), flash_attention launches the eval form
of the forward kernel as it always did; otherwise it goes through one
torch.autograd.Function holding both kernels. A CPU tensor goes to the plain
versions (inside the same Function); a CUDA tensor launches the kernels or
raises, with no fallback. LAUNCHES counts each kernel's launches where it
launches and nowhere else.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from flashvtg_tpu_torch.ops.aca import (
    HEAD_DIM,
    _aligned,
    _check_operands,
    _check_rc,
    _merge_heads,
    _split_heads,
    _stream,
)
from flashvtg_tpu_torch.ops.attn_dropout import draw_seed, keep_scale, threshold

LAUNCHES: Dict[str, int] = {"flash_attention": 0, "flash_attention_bwd": 0}

MAX_LEN = 4096  # the largest v_bucket; the kernel keeps one bit per 128 keys
PLAIN_CHUNK = 512  # the JAX package's attn_chunk default


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _chunk_scale(seed, p, q_c, i, length):
    b, h, c, _ = q_c.shape
    rows = torch.arange(i, i + c, device=q_c.device)
    return keep_scale(seed, p, b, h, rows, length, q_c.dtype)


def chunked_attention_plain(q, k, v, valid, chunk_size: int, dropout: float = 0.0,
                            seed: int = 0, want_lse: bool = False):
    """Masked softmax(q k^T) v, one chunk of query rows at a time: the
    live logits are (B, H, chunk, L). q (B, H, L, Dh) pre-scaled, k and v
    (B, H, L, Dh), valid (B, L) with 1 = valid key. Returns (B, H, L, Dh),
    and the row log-sum-exp (B, H, L) second when `want_lse`. Dropout keeps
    probability (b, h, i, j) by ops/attn_dropout.py's hash of `seed`."""
    invalid = valid[:, None, None, :] <= 0
    length = q.shape[2]
    outs, lses = [], []
    for i in range(0, length, chunk_size):
        logits = torch.einsum("bhqd,bhkd->bhqk", q[:, :, i : i + chunk_size], k)
        logits = logits.masked_fill(invalid, float("-inf"))
        weights = torch.softmax(logits, dim=-1)
        if dropout > 0:
            weights = weights * _chunk_scale(seed, dropout, weights, i, length)
        outs.append(torch.einsum("bhqk,bhkd->bhqd", weights, v))
        if want_lse:
            lses.append(torch.logsumexp(logits, dim=-1))
    out = torch.cat(outs, dim=2)
    return (out, torch.cat(lses, dim=2)) if want_lse else out


def flash_attention_plain(q, k, v, key_valid, num_heads: int, dropout: float = 0.0,
                          seed: int = 0, want_lse: bool = False):
    """The plain version in the merged-head layout: split heads, scale q,
    chunked_attention_plain, merge heads (and the (B, H, L) log-sum-exp
    second when `want_lse`)."""
    head_dim = q.shape[-1] // num_heads
    res = chunked_attention_plain(
        _split_heads(q * head_dim ** -0.5, num_heads),
        _split_heads(k, num_heads),
        _split_heads(v, num_heads),
        key_valid, PLAIN_CHUNK, dropout, seed, want_lse,
    )
    return (_merge_heads(res[0]), res[1]) if want_lse else _merge_heads(res)


def flash_attention_bwd_plain(q, k, v, key_valid, out, lse, d_out, num_heads: int,
                              dropout: float = 0.0, seed: int = 0):
    """(dq, dk, dv) of flash_attention_plain by the FlashAttention-2
    formulas, one query chunk at a time: D = rowsum(dO * O),
    P = exp(logits - lse), dS = P (z (dO v^T) - D), dq = scale dS k,
    dk = dS^T (scale q), dv = (P z)^T dO, z the dropout scale. A row whose
    batch row has no valid key gets zeros, as the kernels give."""
    head_dim = q.shape[-1] // num_heads
    scale = head_dim ** -0.5
    qh = _split_heads(q * scale, num_heads)
    kh, vh = _split_heads(k, num_heads), _split_heads(v, num_heads)
    d_oh = _split_heads(d_out, num_heads)
    delta = (d_oh * _split_heads(out, num_heads)).sum(dim=-1)
    invalid = key_valid[:, None, None, :] <= 0
    length = q.shape[1]
    dk, dv = torch.zeros_like(kh), torch.zeros_like(vh)
    dqs = []
    for i in range(0, length, PLAIN_CHUNK):
        q_c, do_c = qh[:, :, i : i + PLAIN_CHUNK], d_oh[:, :, i : i + PLAIN_CHUNK]
        logits = torch.einsum("bhqd,bhkd->bhqk", q_c, kh)
        p = torch.exp(logits - lse[:, :, i : i + PLAIN_CHUNK, None])
        p = torch.where(invalid, torch.zeros_like(p), p)
        dp = torch.einsum("bhqd,bhkd->bhqk", do_c, vh)
        pz = p
        if dropout > 0:
            z = _chunk_scale(seed, dropout, q_c, i, length)
            pz, dp = p * z, dp * z
        ds = torch.where(
            invalid, torch.zeros_like(p), p * (dp - delta[:, :, i : i + PLAIN_CHUNK, None])
        )
        dqs.append(torch.einsum("bhqk,bhkd->bhqd", ds, kh) * scale)
        dk = dk + torch.einsum("bhqk,bhqd->bhkd", ds, q_c)
        dv = dv + torch.einsum("bhqk,bhqd->bhkd", pz, do_c)
    return _merge_heads(torch.cat(dqs, dim=2)), _merge_heads(dk), _merge_heads(dv)


def _check_self(tag, q, k, v, key_valid, num_heads):
    b, length, lk = _check_operands(tag, q, k, v, key_valid, num_heads)
    if lk != length:
        raise ValueError(
            f"{tag}: shapes q {tuple(q.shape)} k {tuple(k.shape)}: "
            "self-attention takes as many keys as queries"
        )
    if not 1 <= length <= MAX_LEN:
        raise ValueError(f"{tag}: length {length} outside [1, {MAX_LEN}]")
    return b, length


def _launch(q, k, v, key_valid, num_heads, dropout=0.0, seed=0, want_lse=False):
    """The forward kernel, with flash_attention_plain's arguments and
    results. Without LSE or dropout it launches the eval entry; otherwise
    the training entry, which also writes the row log-sum-exp."""
    from flashvtg_tpu_torch import kernels

    tag = "flash kernel"
    b, length = _check_self(tag, q, k, v, key_valid, num_heads)
    out = torch.empty_like(q)
    lib = kernels.load("flash_attention")
    if not (want_lse or dropout > 0):
        rc = lib.flashvtg_flash_attention_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), key_valid.data_ptr(),
            out.data_ptr(), b, length, num_heads, HEAD_DIM, HEAD_DIM ** -0.5, _stream(q),
        )
        _check_rc(tag, rc)
        return out
    lse = q.new_empty((b, num_heads, length))
    rc = lib.flashvtg_flash_attention_train_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), key_valid.data_ptr(),
        out.data_ptr(), lse.data_ptr(), b, length, num_heads, HEAD_DIM,
        HEAD_DIM ** -0.5, seed, threshold(dropout), 1.0 / (1.0 - dropout), _stream(q),
    )
    _check_rc(tag, rc)
    return (out, lse) if want_lse else out


def _launch_bwd(q, k, v, key_valid, out, lse, d_out, num_heads, dropout=0.0, seed=0):
    """The backward kernel, with flash_attention_bwd_plain's arguments."""
    from flashvtg_tpu_torch import kernels

    tag = "flash backward kernel"
    b, length = _check_self(tag, q, k, v, key_valid, num_heads)
    d_out = _aligned(d_out)
    if d_out.shape != q.shape or d_out.dtype != torch.float32:
        raise ValueError(f"{tag}: d_out {tuple(d_out.shape)} {d_out.dtype}")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    # scratch: D = rowsum(dO * O) from the pre-pass, then overwritten in
    # place with D' = rowsum(P z dP) by the dq kernel, which must run before
    # the dk/dv kernel that reads D'
    delta = q.new_empty((b, num_heads, length))
    rc = kernels.load("flash_attention_bwd").flashvtg_flash_attention_bwd_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), key_valid.data_ptr(),
        out.data_ptr(), lse.data_ptr(), d_out.data_ptr(), delta.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, length, num_heads, HEAD_DIM,
        HEAD_DIM ** -0.5, seed, threshold(dropout), 1.0 / (1.0 - dropout), _stream(q),
    )
    _check_rc(tag, rc)
    return dq, dk, dv


class _FlashFn(torch.autograd.Function):
    """Training form of the long self-attention: the forward with LSE and
    dropout, and its backward; kernels on the card, plain versions on the
    CPU."""

    @staticmethod
    def forward(ctx, q, k, v, key_valid, num_heads, dropout, seed):
        on_cpu = q.device.type == "cpu"
        out, lse = (flash_attention_plain if on_cpu else _launch)(
            q, k, v, key_valid, num_heads, dropout, seed, want_lse=True
        )
        if not on_cpu:
            LAUNCHES["flash_attention"] += 1
        ctx.save_for_backward(q, k, v, key_valid, out, lse)
        ctx.args = (num_heads, dropout, seed)
        return out

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, key_valid, out, lse = ctx.saved_tensors
        num_heads, dropout, seed = ctx.args
        on_cpu = q.device.type == "cpu"
        dq, dk, dv = (flash_attention_bwd_plain if on_cpu else _launch_bwd)(
            q, k, v, key_valid, out, lse, d_out, num_heads, dropout, seed
        )
        if not on_cpu:
            LAUNCHES["flash_attention_bwd"] += 1
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, key_valid, num_heads: int, dropout: float = 0.0,
                    generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Self-attention core softmax(q k^T / sqrt(Dh), key mask) v over any
    number of keys, (B, L, H*Dh)."""
    grads = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    if not grads and dropout == 0:
        if q.device.type == "cpu":
            return flash_attention_plain(q, k, v, key_valid, num_heads)
        out = _launch(q, k, v, key_valid, num_heads)
        LAUNCHES["flash_attention"] += 1
        return out
    seed = draw_seed(generator) if dropout > 0 else 0
    return _FlashFn.apply(q, k, v, key_valid, num_heads, dropout, seed)
