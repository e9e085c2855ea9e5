"""Fused attention for the ACA and self-attention layers: kernel + plain twin.

Kernel: csrc/aca_attention.cu, hand-written CUDA for sm_90a, f32 on CUDA
cores. It replaces the Pallas kernel scripts/bench_aca.py:_aca_kernel (the
TPU's fused ACA attention), whose function runs at every ACA layer of the
model (flashvtg_tpu/models/transformer.py:80-128); with no dummies and no
head mean the same kernel is the masked self-attention core
(transformer.py:236-264). What bounds it on the card, and what the design
does about it, is written at the top of the CUDA source.

Two entry points, one kernel:
  * aca_attention(q, k, v, key_valid, num_heads, num_dummies, want_head_mean)
  * masked_attention(q, k, v, key_valid, num_heads)  (nd = 0, no head mean)

q, k, v are (B, L, H*Dh) in the model's merged-head layout. A CPU tensor
goes to the plain PyTorch twin (`*_plain`); a CUDA tensor launches the
kernel or raises, with no fallback. Each wrapper counts its launches in
LAUNCHES, where it launches and nowhere else.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

LAUNCHES: Dict[str, int] = {"aca_attention": 0, "masked_attention": 0}

HEAD_DIM = 32
MAX_KEYS = 128


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _split_heads(x, num_heads):
    b, l, d = x.shape
    return x.reshape(b, l, num_heads, d // num_heads).transpose(1, 2)


def _merge_heads(x):
    b, h, l, hd = x.shape
    return x.transpose(1, 2).reshape(b, l, h * hd)


def aca_attention_plain(q, k, v, key_valid, num_heads: int, num_dummies: int,
                        want_head_mean: bool = True):
    """The twin: einsum, masked_fill, softmax, slice, einsum."""
    head_dim = q.shape[-1] // num_heads
    qh = _split_heads(q * head_dim ** -0.5, num_heads)
    kh = _split_heads(k, num_heads)
    vh = _split_heads(v, num_heads)
    nd = num_dummies
    logits = torch.einsum("bhqd,bhkd->bhqk", qh, kh)
    logits = logits.masked_fill(key_valid[:, None, None, :] <= 0, float("-inf"))
    weights = torch.softmax(logits, dim=-1)  # dummies included
    out = torch.einsum("bhqk,bhkd->bhqd", weights[..., nd:], vh[:, :, nd:])
    head_mean = weights.sum(dim=1) / num_heads if want_head_mean else None
    return _merge_heads(out), head_mean


def masked_attention_plain(q, k, v, key_valid, num_heads: int):
    return aca_attention_plain(q, k, v, key_valid, num_heads, 0, False)[0]


def _check_operands(tag, q, k, v, key_valid, num_heads):
    """Checks of the kernels' launchers: float32 contiguous CUDA operands on
    one device, q/k/v 16-byte aligned, q (B, Lq, H*Dh) beside k and v
    (B, Lk, H*Dh) and key_valid (B, Lk), head dim 32. Returns (B, Lq, Lk)."""
    if q.device.type != "cuda":
        raise ValueError(f"{tag}: tensors on {q.device}, expected CPU or CUDA")
    b, lq, dm = q.shape
    lk = k.shape[1]
    for name, t in (("q", q), ("k", k), ("v", v), ("key_valid", key_valid)):
        if t.dtype != torch.float32:
            raise TypeError(f"{tag}: {name} is {t.dtype}, expected float32")
        if not t.is_contiguous():
            raise ValueError(f"{tag}: {name} is not contiguous")
        if name != "key_valid" and t.data_ptr() % 16:
            raise ValueError(f"{tag}: {name} is not 16-byte aligned")
        if t.device != q.device:
            raise ValueError(f"{tag}: {name} on {t.device}, q on {q.device}")
    if k.shape != (b, lk, dm) or v.shape != (b, lk, dm) or key_valid.shape != (b, lk):
        raise ValueError(
            f"{tag}: shapes q {tuple(q.shape)} k {tuple(k.shape)} "
            f"v {tuple(v.shape)} key_valid {tuple(key_valid.shape)}"
        )
    if dm % num_heads or dm // num_heads != HEAD_DIM:
        raise ValueError(f"{tag}: head dim {dm / num_heads} != {HEAD_DIM}")
    return b, lq, lk


def _launch(q, k, v, key_valid, num_heads, num_dummies, want_head_mean):
    from flashvtg_tpu_torch import kernels

    b, lv, lk = _check_operands("aca kernel", q, k, v, key_valid, num_heads)
    if lk > MAX_KEYS:
        raise ValueError(
            f"aca kernel: {lk} keys > {MAX_KEYS}; self-attention over more "
            "keys goes to ops/chunked_attn.py:flash_attention"
        )
    if not 0 <= num_dummies <= lk:
        raise ValueError(f"aca kernel: num_dummies {num_dummies} outside [0, {lk}]")
    out = torch.empty_like(q)
    head_mean = q.new_empty((b, lv, lk)) if want_head_mean else None
    lib = kernels.load("aca_attention")
    rc = lib.flashvtg_aca_attention_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), key_valid.data_ptr(),
        out.data_ptr(), head_mean.data_ptr() if want_head_mean else None,
        b, lv, lk, num_heads, HEAD_DIM, num_dummies, HEAD_DIM ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"aca kernel launch failed: CUDA error {rc}")
    return out, head_mean


def aca_attention(q, k, v, key_valid, num_heads: int, num_dummies: int,
                  want_head_mean: bool = True
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """ACA core: (out (B, Lv, H*Dh), head_mean (B, Lv, Lk) or None)."""
    if q.device.type == "cpu":
        return aca_attention_plain(q, k, v, key_valid, num_heads, num_dummies,
                                   want_head_mean)
    result = _launch(q, k, v, key_valid, num_heads, num_dummies, want_head_mean)
    LAUNCHES["aca_attention"] += 1
    return result


def masked_attention(q, k, v, key_valid, num_heads: int) -> torch.Tensor:
    """Self-attention core softmax(q k^T / sqrt(Dh), key mask) v, (B, L, H*Dh)."""
    if q.device.type == "cpu":
        return masked_attention_plain(q, k, v, key_valid, num_heads)
    out, _ = _launch(q, k, v, key_valid, num_heads, 0, False)
    LAUNCHES["masked_attention"] += 1
    return out
