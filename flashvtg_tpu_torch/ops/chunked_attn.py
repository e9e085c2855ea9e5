"""Memory-linear masked self-attention for long clip sequences: kernel +
plain versions.

Counterpart of flashvtg_tpu/ops/chunked_attn.py, which the JAX encoder runs
whenever a video has more clips than attn_chunk (the long-video presets:
2048 clips at tacos and charades_vgg). Kernel: csrc/flash_attention.cu,
hand-written CUDA for sm_90a, f32 on CUDA cores, an online softmax over key
tiles that never holds the (B, H, L, L) logits in device memory. It takes
the place of the long, memory-linear form of JAX's library Pallas
flash_attention (scripts/bench_flash.py:57). What bounds it on the card, and
what the design does about it, is written at the top of the CUDA source.

  * chunked_attention_plain(q, k, v, valid, chunk_size): the JAX function's
    layout, (B, H, L, Dh) with q pre-scaled, one query chunk at a time.
  * flash_attention(q, k, v, key_valid, num_heads) and
    flash_attention_plain(...): the model's merged-head layout (B, L, H*Dh),
    as ops/aca.py:masked_attention.

A CPU tensor goes to the plain version; a CUDA tensor launches the kernel or
raises, with no fallback. `flash_attention` counts its launches in LAUNCHES,
where it launches and nowhere else. Attention dropout is training's and is
not ported.
"""

from __future__ import annotations

from typing import Dict

import torch

from flashvtg_tpu_torch.ops.aca import HEAD_DIM, _check_operands, _merge_heads, _split_heads

LAUNCHES: Dict[str, int] = {"flash_attention": 0}

MAX_LEN = 4096  # the largest v_bucket; the kernel keeps one bit per 128 keys
PLAIN_CHUNK = 512  # the JAX package's attn_chunk default


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def chunked_attention_plain(q, k, v, valid, chunk_size: int):
    """Masked softmax(q k^T) v, one chunk of query rows at a time: the
    live logits are (B, H, chunk, L). q (B, H, L, Dh) pre-scaled, k and v
    (B, H, L, Dh), valid (B, L) with 1 = valid key. Returns (B, H, L, Dh)."""
    invalid = valid[:, None, None, :] <= 0
    outs = []
    for i in range(0, q.shape[2], chunk_size):
        logits = torch.einsum("bhqd,bhkd->bhqk", q[:, :, i : i + chunk_size], k)
        weights = torch.softmax(logits.masked_fill(invalid, float("-inf")), dim=-1)
        outs.append(torch.einsum("bhqk,bhkd->bhqd", weights, v))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=2)


def flash_attention_plain(q, k, v, key_valid, num_heads: int):
    """The plain version in the merged-head layout: split heads, scale q,
    chunked_attention_plain, merge heads."""
    head_dim = q.shape[-1] // num_heads
    out = chunked_attention_plain(
        _split_heads(q * head_dim ** -0.5, num_heads),
        _split_heads(k, num_heads),
        _split_heads(v, num_heads),
        key_valid,
        PLAIN_CHUNK,
    )
    return _merge_heads(out)


def _launch(q, k, v, key_valid, num_heads):
    from flashvtg_tpu_torch import kernels

    b, length, lk = _check_operands("flash kernel", q, k, v, key_valid, num_heads)
    if lk != length:
        raise ValueError(
            f"flash kernel: shapes q {tuple(q.shape)} k {tuple(k.shape)}: "
            "self-attention takes as many keys as queries"
        )
    if not 1 <= length <= MAX_LEN:
        raise ValueError(f"flash kernel: length {length} outside [1, {MAX_LEN}]")
    out = torch.empty_like(q)
    lib = kernels.load("flash_attention")
    rc = lib.flashvtg_flash_attention_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), key_valid.data_ptr(),
        out.data_ptr(), b, length, num_heads, HEAD_DIM, HEAD_DIM ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"flash kernel launch failed: CUDA error {rc}")
    return out


def flash_attention(q, k, v, key_valid, num_heads: int) -> torch.Tensor:
    """Self-attention core softmax(q k^T / sqrt(Dh), key mask) v over any
    number of keys, (B, L, H*Dh)."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, key_valid, num_heads)
    out = _launch(q, k, v, key_valid, num_heads)
    LAUNCHES["flash_attention"] += 1
    return out
