"""Memory-linear masked self-attention for long clip sequences: kernels +
plain versions, forward and backward.

Counterpart of flashvtg_tpu/ops/chunked_attn.py, which the JAX encoder runs
whenever a video has more clips than attn_chunk (the long-video presets:
2048 clips at tacos and charades_vgg), and whose backward the JAX train step
gets from jax.checkpoint (each query chunk's probabilities recomputed).
Kernels, hand-written CUDA for sm_90a, their products on the tensor cores in
the current dial's form (ops/forms.py: 3xTF32, f32-accurate, at float32;
1xTF32 at tensorfloat32; bf16 operands at bfloat16), that never hold the
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
raises, with no fallback. FORM_LAUNCHES counts each kernel's launches by
product form where it launches and nowhere else (launch_counts sums the
forms; a call inside a CUDA-graph capture launches nothing and is not
counted, as in ops/aca.py). As ops/aca.py's wrappers, flash_attention reads the product form at the call
and takes float32 operands with autocast off.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from flashvtg_tpu_torch.ops.aca import (
    HEAD_DIM,
    _aligned,
    _check_operands,
    _check_rc,
    _launching,
    _merge_heads,
    _seed_ptr,
    _split_heads,
    _stream,
)
from flashvtg_tpu_torch.ops.attn_dropout import draw_seed, keep_scale, seed_tensor, threshold
from flashvtg_tpu_torch.ops.forms import FORM_IDS, FORMS, autocast_off, product
from flashvtg_tpu_torch.utils.runtime import kernel_form, widened

KERNELS = ("flash_attention", "flash_attention_bwd")
# each kernel's launches by product form (ops/forms.py)
FORM_LAUNCHES: Dict[str, Dict[str, int]] = {form: dict.fromkeys(KERNELS, 0) for form in FORMS}

MAX_LEN = 4096  # the largest v_bucket; the kernel keeps one bit per 128 keys
PLAIN_CHUNK = 512  # the JAX package's attn_chunk default
KERNEL_KEYS = 64  # keys a step of the forward kernel's online softmax (kChunk)


def launch_counts() -> Dict[str, int]:
    """Each kernel's launches over every form since the last reset."""
    return {name: sum(counts[name] for counts in FORM_LAUNCHES.values()) for name in KERNELS}


def reset_launch_counts() -> None:
    for counts in FORM_LAUNCHES.values():
        counts.update(dict.fromkeys(KERNELS, 0))


def _count(name: str, form: str) -> None:
    if _launching():  # a capture records the kernel, it launches nothing
        FORM_LAUNCHES[form][name] += 1


def _chunk_scale(seed, p, q_c, i, length):
    b, h, c, _ = q_c.shape
    rows = torch.arange(i, i + c, device=q_c.device)
    return keep_scale(seed, p, b, h, rows, length, q_c.dtype)


def chunked_attention_plain(q, k, v, valid, chunk_size: int, dropout: float = 0.0,
                            seed: int = 0, want_lse: bool = False, form: str = "3xtf32"):
    """Masked softmax(q k^T) v, one chunk of query rows at a time: the
    live logits are (B, H, chunk, L). q (B, H, L, Dh) pre-scaled, k and v
    (B, H, L, Dh), valid (B, L) with 1 = valid key. Returns (B, H, L, Dh),
    and the row log-sum-exp (B, H, L) second when `want_lse`. Dropout keeps
    probability (b, h, i, j) by ops/attn_dropout.py's hash of `seed`. At
    "3xtf32" torch's softmax and logsumexp; at the rounded forms the
    kernel's online softmax (_online_softmax_pv), so that the operands
    rounded are the kernel's."""
    invalid = valid[:, None, None, :] <= 0
    length = q.shape[2]
    outs, lses = [], []
    for i in range(0, length, chunk_size):
        logits = product("bhqd,bhkd->bhqk", q[:, :, i : i + chunk_size], k, form)
        logits = logits.masked_fill(invalid, float("-inf"))
        z = _chunk_scale(seed, dropout, logits, i, length) if dropout > 0 else None
        if form == "3xtf32":
            weights = torch.softmax(logits, dim=-1)
            outs.append(product("bhqk,bhkd->bhqd", weights if z is None else weights * z, v,
                                form))
            if want_lse:
                lses.append(torch.logsumexp(logits, dim=-1))
            continue
        out, lse = _online_softmax_pv(logits, v, z, form)
        outs.append(out)
        lses.append(lse)
    out = torch.cat(outs, dim=2)
    return (out, torch.cat(lses, dim=2)) if want_lse else out


def _online_softmax_pv(logits, v, z, form):
    """(softmax(logits) (z) v, log-sum-exp) as the forward kernel takes
    them: over steps of KERNEL_KEYS keys, p = exp(s - m_c) with m_c the row
    max over the keys up to the step's last (0 while no key is valid), times
    the dropout scale z, feeds p.v with its operands rounded as `form`
    rounds them; each step's product is rescaled by exp(m_c - m) to the row
    max m, and the sum divided by the undropped row sum l; lse = m + log l.
    A row with no valid key gives NaN (the kernel, zeros)."""
    b, h, rows, length = logits.shape
    steps = -(-length // KERNEL_KEYS)
    pad = steps * KERNEL_KEYS - length
    s = torch.nn.functional.pad(logits, (0, pad), value=float("-inf"))
    s = s.view(b, h, rows, steps, KERNEL_KEYS)
    m_run = s.amax(dim=-1).cummax(dim=-1).values  # (B, H, rows, steps)
    seen = m_run > float("-inf")
    e = torch.exp(s - torch.where(seen, m_run, 0.0)[..., None])
    m = m_run[..., -1:]
    rescale = torch.where(seen, torch.exp(m_run - m), 0.0)
    l = (e.sum(dim=-1) * rescale).sum(dim=-1, keepdim=True)
    if z is not None:
        e = e * torch.nn.functional.pad(z, (0, pad), value=1.0).view(e.shape)
    vs = torch.nn.functional.pad(v, (0, 0, 0, pad)).view(b, h, steps, KERNEL_KEYS, -1)
    pv = product("bhqnk,bhnkd->bhqnd", e, vs, form)
    out = (pv * rescale[..., None]).sum(dim=-2) / l
    return out, (m + torch.log(l)).squeeze(-1)


def flash_attention_plain(q, k, v, key_valid, num_heads: int, dropout: float = 0.0,
                          seed: int = 0, want_lse: bool = False, form: str = "3xtf32"):
    """The plain version in the merged-head layout: split heads, scale q,
    chunked_attention_plain, merge heads (and the (B, H, L) log-sum-exp
    second when `want_lse`)."""
    head_dim = q.shape[-1] // num_heads
    res = chunked_attention_plain(
        _split_heads(q * head_dim ** -0.5, num_heads),
        _split_heads(k, num_heads),
        _split_heads(v, num_heads),
        key_valid, PLAIN_CHUNK, dropout, seed, want_lse, form,
    )
    return (_merge_heads(res[0]), res[1]) if want_lse else _merge_heads(res)


def flash_attention_bwd_plain(q, k, v, key_valid, out, lse, d_out, num_heads: int,
                              dropout: float = 0.0, seed: int = 0, form: str = "3xtf32"):
    """(dq, dk, dv) of flash_attention_plain by the FlashAttention-2
    formulas, one query chunk at a time: D = rowsum(dO * O),
    P = exp(logits - lse), dS = P (z (dO v^T) - D), dq = scale dS k,
    dk = dS^T (scale q), dv = (P z)^T dO, z the dropout scale; every
    product's operands rounded as the kernels' `form` rounds them. At the
    rounded forms dk as the dk/dv kernel takes it: scale dS'^T q, with dS'
    from D' = rowsum(P z dP) (equal to D in exact arithmetic; the dq kernel
    sums it from its own P and dP). A row whose batch row has no valid key
    gets zeros, as the kernels give."""
    head_dim = q.shape[-1] // num_heads
    scale = head_dim ** -0.5
    q_raw = _split_heads(q, num_heads)
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
        logits = product("bhqd,bhkd->bhqk", q_c, kh, form)
        p = torch.exp(logits - lse[:, :, i : i + PLAIN_CHUNK, None])
        p = torch.where(invalid, torch.zeros_like(p), p)
        dp = product("bhqd,bhkd->bhqk", do_c, vh, form)
        pz = p
        if dropout > 0:
            z = _chunk_scale(seed, dropout, q_c, i, length)
            pz, dp = p * z, dp * z
        ds = torch.where(
            invalid, torch.zeros_like(p), p * (dp - delta[:, :, i : i + PLAIN_CHUNK, None])
        )
        dqs.append(product("bhqk,bhkd->bhqd", ds, kh, form) * scale)
        if form == "3xtf32":
            dk = dk + product("bhqk,bhqd->bhkd", ds, q_c, form)
        else:
            ds = torch.where(invalid, torch.zeros_like(p),
                             p * (dp - (p * dp).sum(dim=-1, keepdim=True)))
            dk = dk + product("bhqk,bhqd->bhkd", ds, q_raw[:, :, i : i + PLAIN_CHUNK],
                              form) * scale
        dv = dv + product("bhqk,bhqd->bhkd", pz, do_c, form)
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


def _launch(q, k, v, key_valid, num_heads, dropout=0.0, seed=0, want_lse=False,
            form="3xtf32"):
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
            out.data_ptr(), b, length, num_heads, HEAD_DIM, HEAD_DIM ** -0.5, FORM_IDS[form],
            _stream(q),
        )
        _check_rc(tag, rc)
        return out
    lse = q.new_empty((b, num_heads, length))
    seed_ptr, _seed = _seed_ptr(seed, dropout, q.device)
    rc = lib.flashvtg_flash_attention_train_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), key_valid.data_ptr(),
        out.data_ptr(), lse.data_ptr(), b, length, num_heads, HEAD_DIM,
        HEAD_DIM ** -0.5, seed_ptr, threshold(dropout), 1.0 / (1.0 - dropout), FORM_IDS[form],
        _stream(q),
    )
    _check_rc(tag, rc)
    return (out, lse) if want_lse else out


def _launch_bwd(q, k, v, key_valid, out, lse, d_out, num_heads, dropout=0.0, seed=0,
                form="3xtf32"):
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
    seed_ptr, _seed = _seed_ptr(seed, dropout, q.device)
    rc = kernels.load("flash_attention_bwd").flashvtg_flash_attention_bwd_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), key_valid.data_ptr(),
        out.data_ptr(), lse.data_ptr(), d_out.data_ptr(), delta.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, length, num_heads, HEAD_DIM,
        HEAD_DIM ** -0.5, seed_ptr, threshold(dropout), 1.0 / (1.0 - dropout), FORM_IDS[form],
        _stream(q),
    )
    _check_rc(tag, rc)
    return dq, dk, dv


class _FlashFn(torch.autograd.Function):
    """Training form of the long self-attention: the forward with LSE and
    dropout, and its backward in the forward's product form; kernels on the
    card, plain versions on the CPU. `seed` is the call's 0-d seed tensor
    (an int is put on the device; None without dropout), saved for the
    backward."""

    @staticmethod
    def forward(ctx, q, k, v, key_valid, num_heads, dropout, seed, form):
        on_cpu = q.device.type == "cpu"
        if dropout > 0 and not isinstance(seed, torch.Tensor):
            seed = seed_tensor(seed, q.device)
        out, lse = (flash_attention_plain if on_cpu else _launch)(
            q, k, v, key_valid, num_heads, dropout, seed, want_lse=True, form=form
        )
        if not on_cpu:
            _count("flash_attention", form)
        ctx.save_for_backward(q, k, v, key_valid, out, lse, seed)
        ctx.args = (num_heads, dropout, form)
        return out

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, key_valid, out, lse, seed = ctx.saved_tensors
        num_heads, dropout, form = ctx.args
        on_cpu = q.device.type == "cpu"
        with autocast_off(q):
            dq, dk, dv = (flash_attention_bwd_plain if on_cpu else _launch_bwd)(
                q, k, v, key_valid, out, lse, d_out, num_heads, dropout, seed, form=form,
            )
        if not on_cpu:
            _count("flash_attention_bwd", form)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q, k, v, key_valid, num_heads: int, dropout: float = 0.0,
                    generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Self-attention core softmax(q k^T / sqrt(Dh), key mask) v over any
    number of keys, (B, L, H*Dh), in the current dial's product form; bf16
    operands are taken in float32."""
    form = kernel_form()
    q, k, v = widened(q, k, v)
    with autocast_off(q):
        grads = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
        if not grads and dropout == 0:
            if q.device.type == "cpu":
                return flash_attention_plain(q, k, v, key_valid, num_heads, form=form)
            out = _launch(q, k, v, key_valid, num_heads, form=form)
            _count("flash_attention", form)
            return out
        seed = draw_seed(generator, q.device) if dropout > 0 else None
        return _FlashFn.apply(q, k, v, key_valid, num_heads, dropout, seed, form)
