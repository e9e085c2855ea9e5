"""Fused attention for the ACA and self-attention layers: kernels + plain
versions, forward and backward.

Kernels: csrc/aca_attention.cu (forward) and csrc/aca_attention_bwd.cu
(backward), hand-written CUDA for sm_90a, their products on the tensor cores
in the form of the current precision dial (ops/forms.py): 3xTF32
(f32-accurate) at float32, 1xTF32 at tensorfloat32, bf16 operands with f32
sums at bfloat16. The forward
replaces the Pallas kernel scripts/bench_aca.py:_aca_kernel (the TPU's fused
ACA attention), whose function runs at every ACA layer of the model
(flashvtg_tpu/models/transformer.py:80-128); with no dummies and no head
mean the same kernel is the masked self-attention core over up to 128 keys
(transformer.py:236-264), the short form of JAX's library Pallas
flash_attention. The backward replaces that library kernel's VJP, which the
JAX train step reaches through jax.grad. What bounds each kernel on the
card, and what its design does about it, is written at the top of its
source.

Two entry points share the kernels:
  * aca_attention(q, k, v, key_valid, num_heads, num_dummies, want_head_mean,
    dropout, generator, query_valid, donor_rows)
  * masked_attention(q, k, v, key_valid, num_heads, dropout, generator)
    (nd = 0, no head mean)

q, k, v are (B, L, H*Dh) in the model's merged-head layout. Without
gradients, dropout or donor rows (eval), a call launches the eval form of
the forward kernel as it always did. Otherwise it goes through one
torch.autograd.Function: the training form of the forward also writes the
row log-sum-exp, applies attention dropout (ops/attn_dropout.py, seeded per
call from `generator`) to the probabilities of p.v only (the head mean keeps
them undropped, as transformer.py:117-127), and takes the donor-row mask of
transformer.py:34-48, 107-116; the backward kernel recomputes the
probabilities from q, k and the log-sum-exp.

A CPU tensor goes to the plain PyTorch versions (`*_plain`, and
`aca_attention_bwd_plain` for the backward, inside the same Function); a
CUDA tensor launches the kernels or raises, with no fallback. Each wrapper
counts its launches by product form in FORM_LAUNCHES, where it launches and
nowhere else (launch_counts sums the forms); a backward counts under its
forward's name + "_bwd". A call inside a CUDA-graph capture launches
nothing (the graph records the kernel) and is not counted; the graph's
replays launch it without a Python call, so their launches are read from
the device (the profiler's kernel records), not from these counts.

The wrappers read the product form at the call (utils/runtime.py:
kernel_form; the Function keeps it for its backward) and take q, k, v in
float32 with autocast off: under the bfloat16 dial the projections arrive in
bf16, and the kernels, like their plain versions (`form=`), round the
operands of each product themselves.

A dropout seed is a 0-d int32 tensor on the device (ops/attn_dropout.py:
draw_seed), drawn there from `generator` and read by the kernels from
device memory, so a captured CUDA graph draws a new one at every replay;
the launchers also take an int, copied to the card at the call.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from flashvtg_tpu_torch.ops.attn_dropout import draw_seed, keep_scale, seed_tensor, threshold
from flashvtg_tpu_torch.ops.forms import FORM_IDS, FORMS, autocast_off, product
from flashvtg_tpu_torch.utils.runtime import kernel_form, widened

KERNELS = ("aca_attention", "masked_attention", "aca_attention_bwd", "masked_attention_bwd")
# each kernel's launches by product form (ops/forms.py)
FORM_LAUNCHES: Dict[str, Dict[str, int]] = {form: dict.fromkeys(KERNELS, 0) for form in FORMS}

HEAD_DIM = 32
MAX_KEYS = 128
BWD_CHUNK_ROWS = 256  # about this many query rows a block of the backward kernel


def bwd_tiling(lv: int, lk: int) -> Tuple[int, int, int]:
    """(tile_rows, chunks, chunk_rows) of the backward kernel: a block owns
    one (b, h) and one chunk of chunk_rows query rows, whole tiles of
    tile_rows = 16 max(5, ceil(lk / 16)) rows (a 16-row tile per warp, and
    at least a warp per 16 keys); chunk c holds rows [c chunk_rows,
    (c + 1) chunk_rows) and every chunk holds a row. csrc/aca_attention_bwd.cu
    computes chunk_rows from `chunks` by the same formula. With more than one
    chunk the kernel leaves dk and dv as partial sums per chunk in a
    workspace (bwd_workspace_shape) and a second pass adds them."""
    tile_rows = 16 * max(5, -(-lk // 16))
    tiles = -(-lv // tile_rows)
    chunks = -(-tiles // -(-BWD_CHUNK_ROWS // tile_rows))
    return tile_rows, chunks, tile_rows * -(-tiles // chunks)


def bwd_workspace_shape(b: int, num_heads: int, lv: int, lk: int):
    """The backward's scratch, (2, B, H, chunks, Lk, 32) f32 partial dk and
    dv, or None where one chunk covers every row (no second pass)."""
    chunks = bwd_tiling(lv, lk)[1]
    return None if chunks == 1 else (2, b, num_heads, chunks, lk, HEAD_DIM)


def launch_counts() -> Dict[str, int]:
    """Each kernel's launches over every form since the last reset."""
    return {name: sum(counts[name] for counts in FORM_LAUNCHES.values()) for name in KERNELS}


def reset_launch_counts() -> None:
    for counts in FORM_LAUNCHES.values():
        counts.update(dict.fromkeys(KERNELS, 0))


def _launching() -> bool:
    """Whether a kernel call on the card launches now: not inside a
    CUDA-graph capture, which only records it."""
    return not torch.cuda.is_current_stream_capturing()


def _count(name: str, form: str) -> None:
    if _launching():
        FORM_LAUNCHES[form][name] += 1


def _split_heads(x, num_heads):
    b, l, d = x.shape
    return x.reshape(b, l, num_heads, d // num_heads).transpose(1, 2)


def _merge_heads(x):
    b, h, l, hd = x.shape
    return x.transpose(1, 2).reshape(b, l, h * hd)


def _masked_logits(q, k, key_valid, num_heads, query_valid=None, donor_rows=None,
                   form="3xtf32"):
    """Scaled logits (B, H, Lq, Lk), -inf where masked: invalid keys, and
    with donor rows also where !query_valid[d, i] && !key_valid[d, j],
    d = donor_rows[b, h]. The products in `form` (ops/forms.py)."""
    head_dim = q.shape[-1] // num_heads
    logits = product(
        "bhqd,bhkd->bhqk",
        _split_heads(q * head_dim ** -0.5, num_heads), _split_heads(k, num_heads), form,
    )
    masked = (key_valid <= 0)[:, None, None, :]
    if donor_rows is not None:
        donor = donor_rows.long()
        qpad = (query_valid <= 0)[donor]  # (B, H, Lq)
        kpad = (key_valid <= 0)[donor]  # (B, H, Lk)
        masked = masked | (qpad[..., :, None] & kpad[..., None, :])
    return logits.masked_fill(masked, float("-inf"))


def _dropout_scale(seed, p, logits):
    b, h, lq, lk = logits.shape
    rows = torch.arange(lq, device=logits.device)
    return keep_scale(seed, p, b, h, rows, lk, logits.dtype)


def _softmax(logits, form, want_lse):
    """(softmax of logits over the last axis, its log-sum-exp or None). At
    "3xtf32" torch's own softmax; at the rounded forms the kernel's order,
    e = exp(s - max), p = e / l, lse = max + log(l), so that the operands
    that p.v rounds are the kernel's."""
    if form == "3xtf32":
        return torch.softmax(logits, dim=-1), (
            torch.logsumexp(logits, dim=-1) if want_lse else None)
    m = logits.amax(dim=-1, keepdim=True)
    e = torch.exp(logits - m)
    l = e.sum(dim=-1, keepdim=True)
    return e / l, (m + torch.log(l)).squeeze(-1)


def aca_attention_plain(q, k, v, key_valid, num_heads: int, num_dummies: int,
                        want_head_mean: bool = True, dropout: float = 0.0,
                        seed: int = 0, query_valid=None, donor_rows=None,
                        want_lse: bool = False, form: str = "3xtf32"):
    """The plain version: einsum, masked_fill, softmax, dropout, slice,
    einsum, the two products' operands rounded as the kernel's `form`
    rounds them (tests/test_torch_tf32x3.py holds it to that arithmetic).
    Returns (out, head_mean or None), and the row log-sum-exp (B, H, Lq)
    third when `want_lse`."""
    nd = num_dummies
    logits = _masked_logits(q, k, key_valid, num_heads, query_valid, donor_rows, form)
    weights, lse = _softmax(logits, form, want_lse)  # dummies included
    head_mean = weights.sum(dim=1) / num_heads if want_head_mean else None
    if dropout > 0:
        weights = weights * _dropout_scale(seed, dropout, logits)
    out = product(
        "bhqk,bhkd->bhqd", weights[..., nd:], _split_heads(v, num_heads)[:, :, nd:], form
    )
    if want_lse:
        return _merge_heads(out), head_mean, lse
    return _merge_heads(out), head_mean


def masked_attention_plain(q, k, v, key_valid, num_heads: int, form: str = "3xtf32"):
    return aca_attention_plain(q, k, v, key_valid, num_heads, 0, False, form=form)[0]


def aca_attention_bwd_plain(q, k, v, key_valid, lse, d_out, d_head_mean,
                            num_heads: int, num_dummies: int, dropout: float = 0.0,
                            seed: int = 0, query_valid=None, donor_rows=None,
                            form: str = "3xtf32"):
    """(dq, dk, dv) of aca_attention_plain, by the formulas the backward
    kernel uses: P = exp(logits - lse),
    dP_ij = [j >= nd] z_ij (dO_i . v_j) + dHeadMean_ij / H,
    dS = P (dP - rowsum(P dP)), dq = scale dS k, dk = dS^T (scale q) (at
    the rounded forms scale dS^T q, as the kernel), dv = (P z)^T dO over keys j >= nd, with z the dropout scale; every
    product's operands rounded as the kernel's `form` rounds them."""
    nd = num_dummies
    head_dim = q.shape[-1] // num_heads
    scale = head_dim ** -0.5
    logits = _masked_logits(q, k, key_valid, num_heads, query_valid, donor_rows, form)
    p = torch.exp(logits - lse[..., None])
    z = _dropout_scale(seed, dropout, logits) if dropout > 0 else torch.ones_like(p)
    z[..., :nd] = 0  # the dummies' probabilities never reach p.v
    d_oh = _split_heads(d_out, num_heads)
    dp = z * product("bhqd,bhkd->bhqk", d_oh, _split_heads(v, num_heads), form)
    if d_head_mean is not None:
        dp = dp + d_head_mean[:, None] / num_heads
    ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True))
    dq = product("bhqk,bhkd->bhqd", ds, _split_heads(k, num_heads), form) * scale
    if form == "3xtf32":
        dk = product("bhqk,bhqd->bhkd", ds, _split_heads(q * scale, num_heads), form)
    else:  # the kernel scales after the product, which rounds q itself
        dk = product("bhqk,bhqd->bhkd", ds, _split_heads(q, num_heads), form) * scale
    dv = product("bhqk,bhqd->bhkd", p * z, d_oh, form)
    return _merge_heads(dq), _merge_heads(dk), _merge_heads(dv)


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


def _check_shape(tag, q, k, v, key_valid, num_heads, num_dummies):
    b, lv, lk = _check_operands(tag, q, k, v, key_valid, num_heads)
    if lk > MAX_KEYS:
        raise ValueError(
            f"{tag}: {lk} keys > {MAX_KEYS}; self-attention over more "
            "keys goes to ops/chunked_attn.py:flash_attention"
        )
    if not 0 <= num_dummies <= lk:
        raise ValueError(f"{tag}: num_dummies {num_dummies} outside [0, {lk}]")
    return b, lv, lk


def _aligned(t):
    """`t` contiguous and 16-byte aligned, as the kernels read it (a
    gradient may arrive as a strided or offset view)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _ptr(t):
    return None if t is None else t.data_ptr()


def _seed_ptr(seed, dropout, device):
    """(the kernel's seed pointer, or None without dropout; the 0-d int32
    tensor it points into, kept alive by the caller until the launch)."""
    if dropout <= 0:
        return None, None
    t = seed_tensor(seed, device)
    return t.data_ptr(), t


def _check_rc(tag, rc):
    if rc != 0:
        raise RuntimeError(f"{tag} launch failed: CUDA error {rc}")


def _donor_operands(tag, query_valid, donor_rows, b, lv, num_heads, q):
    if donor_rows is None:
        return None, None
    query_valid = query_valid.to(torch.float32).contiguous()
    donor_rows = donor_rows.to(torch.int32).contiguous()
    if query_valid.shape != (b, lv) or donor_rows.shape != (b, num_heads):
        raise ValueError(
            f"{tag}: query_valid {tuple(query_valid.shape)} / donor_rows "
            f"{tuple(donor_rows.shape)}, expected ({b}, {lv}) / ({b}, {num_heads})"
        )
    if query_valid.device != q.device or donor_rows.device != q.device:
        raise ValueError(f"{tag}: donor operands not on {q.device}")
    return query_valid, donor_rows


def _launch(q, k, v, key_valid, num_heads, num_dummies, want_head_mean=True,
            dropout=0.0, seed=0, query_valid=None, donor_rows=None, want_lse=False,
            form="3xtf32"):
    """The forward kernel, with aca_attention_plain's arguments and results.
    Without LSE, dropout or donor rows it launches the eval entry; otherwise
    the training entry, which also writes the row log-sum-exp."""
    from flashvtg_tpu_torch import kernels

    tag = "aca kernel"
    b, lv, lk = _check_shape(tag, q, k, v, key_valid, num_heads, num_dummies)
    out = torch.empty_like(q)
    head_mean = q.new_empty((b, lv, lk)) if want_head_mean else None
    lib = kernels.load("aca_attention")
    if not (want_lse or dropout > 0 or donor_rows is not None):
        rc = lib.flashvtg_aca_attention_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), key_valid.data_ptr(),
            out.data_ptr(), _ptr(head_mean),
            b, lv, lk, num_heads, HEAD_DIM, num_dummies, HEAD_DIM ** -0.5, FORM_IDS[form],
            _stream(q),
        )
        _check_rc(tag, rc)
        return out, head_mean
    query_valid, donor_rows = _donor_operands(tag, query_valid, donor_rows, b, lv,
                                              num_heads, q)
    lse = q.new_empty((b, num_heads, lv))
    seed_ptr, _seed = _seed_ptr(seed, dropout, q.device)
    rc = lib.flashvtg_aca_attention_train_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), key_valid.data_ptr(),
        _ptr(query_valid), _ptr(donor_rows), out.data_ptr(), _ptr(head_mean),
        lse.data_ptr(), b, lv, lk, num_heads, HEAD_DIM, num_dummies, HEAD_DIM ** -0.5,
        seed_ptr, threshold(dropout), 1.0 / (1.0 - dropout), FORM_IDS[form], _stream(q),
    )
    _check_rc(tag, rc)
    return (out, head_mean, lse) if want_lse else (out, head_mean)


def _launch_bwd(q, k, v, key_valid, lse, d_out, d_head_mean, num_heads, num_dummies,
                dropout=0.0, seed=0, query_valid=None, donor_rows=None, form="3xtf32"):
    """The backward kernel, with aca_attention_bwd_plain's arguments."""
    from flashvtg_tpu_torch import kernels

    tag = "aca backward kernel"
    b, lv, lk = _check_shape(tag, q, k, v, key_valid, num_heads, num_dummies)
    query_valid, donor_rows = _donor_operands(tag, query_valid, donor_rows, b, lv,
                                              num_heads, q)
    d_out = _aligned(d_out)
    if d_out.shape != q.shape or d_out.dtype != torch.float32:
        raise ValueError(f"{tag}: d_out {tuple(d_out.shape)} {d_out.dtype}")
    if d_head_mean is not None:
        d_head_mean = d_head_mean.contiguous()
        if d_head_mean.shape != (b, lv, lk) or d_head_mean.dtype != torch.float32:
            raise ValueError(f"{tag}: d_head_mean {tuple(d_head_mean.shape)}")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    ws_shape = bwd_workspace_shape(b, num_heads, lv, lk)
    workspace = None if ws_shape is None else q.new_empty(ws_shape)
    seed_ptr, _seed = _seed_ptr(seed, dropout, q.device)
    rc = kernels.load("aca_attention_bwd").flashvtg_aca_attention_bwd_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), key_valid.data_ptr(),
        _ptr(query_valid), _ptr(donor_rows), lse.data_ptr(), d_out.data_ptr(),
        _ptr(d_head_mean), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), _ptr(workspace),
        b, lv, lk, num_heads, HEAD_DIM, num_dummies, bwd_tiling(lv, lk)[1], HEAD_DIM ** -0.5,
        seed_ptr, threshold(dropout), 1.0 / (1.0 - dropout), FORM_IDS[form], _stream(q),
    )
    _check_rc(tag, rc)
    return dq, dk, dv


class _AttentionFn(torch.autograd.Function):
    """Training form of the short/ACA attention: the forward (with LSE,
    dropout and donor rows) and its backward, in the forward's product form,
    kernels on the card and the plain versions on the CPU. `seed` is the
    call's 0-d seed tensor (an int is put on the device; None without
    dropout), saved for the backward.
    Returns out, and head_mean when asked."""

    @staticmethod
    def forward(ctx, q, k, v, key_valid, query_valid, donor_rows, num_heads,
                num_dummies, want_head_mean, dropout, seed, name, form):
        on_cpu = q.device.type == "cpu"
        if dropout > 0 and not isinstance(seed, torch.Tensor):
            seed = seed_tensor(seed, q.device)
        out, head_mean, lse = (aca_attention_plain if on_cpu else _launch)(
            q, k, v, key_valid, num_heads, num_dummies, want_head_mean, dropout, seed,
            query_valid, donor_rows, want_lse=True, form=form,
        )
        if not on_cpu:
            _count(name, form)
        ctx.save_for_backward(q, k, v, key_valid, query_valid, donor_rows, lse, seed)
        ctx.args = (num_heads, num_dummies, dropout, name, form)
        return (out, head_mean) if want_head_mean else out

    @staticmethod
    def backward(ctx, d_out, d_head_mean=None):
        q, k, v, key_valid, query_valid, donor_rows, lse, seed = ctx.saved_tensors
        num_heads, num_dummies, dropout, name, form = ctx.args
        if d_out is None:
            d_out = torch.zeros_like(q)
        on_cpu = q.device.type == "cpu"
        with autocast_off(q):
            dq, dk, dv = (aca_attention_bwd_plain if on_cpu else _launch_bwd)(
                q, k, v, key_valid, lse, d_out, d_head_mean, num_heads, num_dummies,
                dropout, seed, query_valid, donor_rows, form=form,
            )
        if not on_cpu:
            _count(name + "_bwd", form)
        return (dq, dk, dv) + (None,) * 10


def _train_form(q, k, v, dropout, donor_rows):
    return (
        dropout > 0
        or donor_rows is not None
        or (torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)))
    )


def aca_attention(q, k, v, key_valid, num_heads: int, num_dummies: int,
                  want_head_mean: bool = True, dropout: float = 0.0,
                  generator: Optional[torch.Generator] = None, query_valid=None,
                  donor_rows=None) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """ACA core: (out (B, Lv, H*Dh), head_mean (B, Lv, Lk) or None), in the
    current dial's product form; bf16 operands are taken in float32."""
    form = kernel_form()
    q, k, v = widened(q, k, v)
    with autocast_off(q):
        if not _train_form(q, k, v, dropout, donor_rows):
            if q.device.type == "cpu":
                return aca_attention_plain(q, k, v, key_valid, num_heads, num_dummies,
                                           want_head_mean, form=form)
            result = _launch(q, k, v, key_valid, num_heads, num_dummies, want_head_mean,
                             form=form)
            _count("aca_attention", form)
            return result
        seed = draw_seed(generator, q.device) if dropout > 0 else None
        res = _AttentionFn.apply(q, k, v, key_valid, query_valid, donor_rows, num_heads,
                                 num_dummies, want_head_mean, dropout, seed, "aca_attention",
                                 form)
    return res if want_head_mean else (res, None)


def masked_attention(q, k, v, key_valid, num_heads: int, dropout: float = 0.0,
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Self-attention core softmax(q k^T / sqrt(Dh), key mask) v, (B, L, H*Dh),
    in the current dial's product form; bf16 operands are taken in float32."""
    form = kernel_form()
    q, k, v = widened(q, k, v)
    with autocast_off(q):
        if not _train_form(q, k, v, dropout, None):
            if q.device.type == "cpu":
                return masked_attention_plain(q, k, v, key_valid, num_heads, form)
            out, _ = _launch(q, k, v, key_valid, num_heads, 0, False, form=form)
            _count("masked_attention", form)
            return out
        seed = draw_seed(generator, q.device) if dropout > 0 else None
        return _AttentionFn.apply(q, k, v, key_valid, None, None, num_heads, 0, False,
                                  dropout, seed, "masked_attention", form)
