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
    (ops/attn_dropout.py) inside the tile loop. At the bf16 form the same
    entry first launches a pre-pass (stage_kv alone) that rounds k and v to
    bf16 into one (2, B, L, H*Dh) allocation, which the kernel's TMA copies
    read; the training form keeps it for the backward, which then rounds
    only scale q, q and dO.
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
    _ptr,
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
# the backward's return code for a TMA map that did not encode: this plus
# the encode's CUresult (csrc/flash_attention_bwd.cu kTensorMapError)
TENSOR_MAP_ERROR = 1 << 16


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


def _plain(t) -> bool:
    """Whether a call on `t` takes the plain versions: a tensor on the CPU."""
    return t.device.type == "cpu"


def stage_kv_plain(k, v):
    """The bf16 form's pre-pass in PyTorch: k and v (B, L, H*Dh) rounded
    to bf16, to nearest even, as one (2, B, L, H*Dh) tensor."""
    return torch.stack((k, v)).to(torch.bfloat16)


def stage_kv(k, v):
    """The bf16 form's pre-pass alone (csrc/flash_attention.cu
    flash_fwd_stage_kernel, which the bf16 forward's entry launches before
    its kernel): k and v as one (2, B, L, H*Dh) bf16 tensor, the copies the
    bf16 forward's TMA copies read and the training form hands to the
    backward. The kernel on the card, stage_kv_plain on the CPU."""
    return stage_kv_plain(k, v) if _plain(k) else _launch_stage(k, v)


def _launch_stage(k, v):
    from flashvtg_tpu_torch import kernels

    tag = "flash pre-pass kernel"
    if k.device.type != "cuda" or v.device != k.device:
        raise ValueError(f"{tag}: k on {k.device}, v on {v.device}, expected one CUDA device")
    if k.dim() != 3 or v.shape != k.shape or k.shape[-1] % HEAD_DIM:
        raise ValueError(f"{tag}: shapes k {tuple(k.shape)} v {tuple(v.shape)}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != torch.float32:
            raise TypeError(f"{tag}: {name} is {t.dtype}, expected float32")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{tag}: {name} is not contiguous and 16-byte aligned")
    b, length, d = k.shape
    kv = torch.empty((2, b, length, d), dtype=torch.bfloat16, device=k.device)
    rc = kernels.load("flash_attention").flashvtg_flash_attention_stage_bf16(
        k.data_ptr(), v.data_ptr(), kv[0].data_ptr(), kv[1].data_ptr(), b, length,
        d // HEAD_DIM, _stream(k),
    )
    _check_rc(tag, rc)
    return kv


def _check_launch(tag, rc):
    """Raises on a C entry's nonzero return: a TMA map that did not encode
    (TENSOR_MAP_ERROR plus its CUresult) or a CUDA error."""
    if rc >= TENSOR_MAP_ERROR:
        raise RuntimeError(f"{tag}: cuTensorMapEncodeTiled failed: CUresult "
                           f"{rc - TENSOR_MAP_ERROR}")
    _check_rc(tag, rc)


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
            form="3xtf32", keep_kv=False):
    """The forward kernel, with flash_attention_plain's arguments and
    results. Without LSE or dropout it launches the eval entry; otherwise
    the training entry, which also writes the row log-sum-exp. At the bf16
    form the entry launches the pre-pass first, into one (2, B, L, H*Dh)
    bf16 allocation made here (stage_kv's result); with `want_lse` and
    `keep_kv` it comes third (None at the other forms), for the backward."""
    from flashvtg_tpu_torch import kernels

    tag = "flash kernel"
    b, length = _check_self(tag, q, k, v, key_valid, num_heads)
    out = torch.empty_like(q)
    kv, kv_ptrs = None, (None, None)
    if form == "bf16":
        kv = torch.empty((2, *k.shape), dtype=torch.bfloat16, device=k.device)
        kv_ptrs = (kv.data_ptr(), kv.data_ptr() + 2 * k.numel())  # its two halves
    lib = kernels.load("flash_attention")
    if not (want_lse or dropout > 0):
        rc = lib.flashvtg_flash_attention_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), key_valid.data_ptr(),
            out.data_ptr(), *kv_ptrs, b, length, num_heads, HEAD_DIM, HEAD_DIM ** -0.5,
            FORM_IDS[form], _stream(q),
        )
        _check_launch(tag, rc)
        return out
    lse = q.new_empty((b, num_heads, length))
    seed_ptr, _seed = _seed_ptr(seed, dropout, q.device)
    rc = lib.flashvtg_flash_attention_train_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), key_valid.data_ptr(),
        out.data_ptr(), lse.data_ptr(), *kv_ptrs, b, length, num_heads, HEAD_DIM,
        HEAD_DIM ** -0.5, seed_ptr, threshold(dropout), 1.0 / (1.0 - dropout), FORM_IDS[form],
        _stream(q),
    )
    _check_launch(tag, rc)
    if not want_lse:
        return out
    return (out, lse, kv) if keep_kv else (out, lse)


def _launch_bwd(q, k, v, key_valid, out, lse, d_out, num_heads, dropout=0.0, seed=0,
                form="3xtf32", kv=None):
    """The backward kernel, with flash_attention_bwd_plain's arguments. At
    the bf16 form `kv` may hold the training forward's bf16 copies of these
    k and v (stage_kv's); the pre-pass then rounds only scale q, q and dO."""
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
    # the bf16 form's scratch: the pre-pass's bf16 copies of scale q, q, k,
    # v and dO, which the product kernels' TMA copies read (one allocation),
    # k's and v's the forward's when it handed them over
    staged = [None] * 5
    if form == "bf16":
        if kv is not None and (kv.shape != (2, *k.shape) or kv.dtype != torch.bfloat16
                               or kv.device != k.device or not kv.is_contiguous()):
            raise ValueError(f"{tag}: kv {tuple(kv.shape)} {kv.dtype} on {kv.device}, "
                             f"expected stage_kv's of k {tuple(k.shape)}")
        own = torch.empty((5 if kv is None else 3, *q.shape), dtype=torch.bfloat16,
                          device=q.device).unbind()
        staged = list(own) if kv is None else [own[0], own[1], kv[0], kv[1], own[2]]
    seed_ptr, _seed = _seed_ptr(seed, dropout, q.device)
    rc = kernels.load("flash_attention_bwd").flashvtg_flash_attention_bwd_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), key_valid.data_ptr(),
        out.data_ptr(), lse.data_ptr(), d_out.data_ptr(), delta.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), *(_ptr(t) for t in staged),
        int(kv is None), b, length, num_heads, HEAD_DIM, HEAD_DIM ** -0.5, seed_ptr,
        threshold(dropout), 1.0 / (1.0 - dropout), FORM_IDS[form], _stream(q),
    )
    _check_launch(tag, rc)
    return dq, dk, dv


class _FlashFn(torch.autograd.Function):
    """Training form of the long self-attention: the forward with LSE and
    dropout, and its backward in the forward's product form; kernels on the
    card, plain versions on the CPU. `seed` is the call's 0-d seed tensor
    (an int is put on the device; None without dropout), saved for the
    backward, and so are the bf16 forward's copies of k and v (stage_kv),
    which the backward takes in place of rounding k and v again."""

    @staticmethod
    def forward(ctx, q, k, v, key_valid, num_heads, dropout, seed, form):
        if dropout > 0 and not isinstance(seed, torch.Tensor):
            seed = seed_tensor(seed, q.device)
        kv = None
        if _plain(q):
            out, lse = flash_attention_plain(q, k, v, key_valid, num_heads, dropout, seed,
                                             want_lse=True, form=form)
        else:
            out, lse, kv = _launch(q, k, v, key_valid, num_heads, dropout, seed,
                                   want_lse=True, form=form, keep_kv=True)
            _count("flash_attention", form)
        ctx.save_for_backward(q, k, v, key_valid, out, lse, seed, kv)
        ctx.args = (num_heads, dropout, form)
        return out

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, key_valid, out, lse, seed, kv = ctx.saved_tensors
        num_heads, dropout, form = ctx.args
        with autocast_off(q):
            if _plain(q):
                dq, dk, dv = flash_attention_bwd_plain(q, k, v, key_valid, out, lse, d_out,
                                                       num_heads, dropout, seed, form=form)
            else:
                dq, dk, dv = _launch_bwd(q, k, v, key_valid, out, lse, d_out, num_heads,
                                         dropout, seed, form=form, kv=kv)
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
            if _plain(q):
                return flash_attention_plain(q, k, v, key_valid, num_heads, form=form)
            out = _launch(q, k, v, key_valid, num_heads, form=form)
            _count("flash_attention", form)
            return out
        seed = draw_seed(generator, q.device) if dropout > 0 else None
        return _FlashFn.apply(q, k, v, key_valid, num_heads, dropout, seed, form)
