"""The precision argument of the attention kernels' 3xTF32 products, on the CPU.

csrc/flash_attention.cu, csrc/flash_attention_bwd.cu, csrc/aca_attention.cu
and csrc/aca_attention_bwd.cu take every dot product on the tensor cores in
3xTF32: each f32 operand x is split into
hi = rna(x) and lo = rna(x - hi), TF32 values (cvt.rna.tf32.f32: the
mantissa rounded to 10 bits, to nearest, ties away from zero), and a.b is
taken as lo_a.hi_b + hi_a.lo_b + hi_a.hi_b with f32 sums. Here that
arithmetic is emulated in torch: the flash forward (out, lse) and the
FlashAttention-2 backward formulas of ops/chunked_attn.py
(flash_attention_bwd_plain) run with every dot product in 3xTF32, at L 300,
H 2, a key mask with holes, dropout 0 and 0.1 (the kernels' hash), and are
held against the port's plain versions run in float64 with the card
tolerances: 1e-5 absolute for forwards, 1e-4 of the largest |gradient| for
gradients. A single TF32 product (hi_a.hi_b) misses both tolerances,
so the split is needed. The plain versions themselves are held against the
JAX package in tests/test_torch_long.py and tests/test_torch_attn_grad.py.
The ACA kernels' arithmetic (the ACA layer's form: 10 dummies, the head mean
and its gradient, donor rows; and the short self-attention form: no dummies)
is held the same way, at Lv 300 over 75 keys, against ops/aca.py's plain
forward and backward in float64.

What this emulation does not show: the einsums here sum in f32 rounded to
nearest, while the tensor core's f32 accumulation truncates, so a product
chain that is too long on the card (one chain of 3xTF32 products over 4096
keys) would pass here. The kernels' accumulation order, and that it meets
the tolerances with truncation, are checked only on the card:
tests/test_torch_kernels.py (the kernels against their plain versions, and
dot_3xtf32 against an f32 FMA loop).
"""

import numpy as np
import pytest
import torch

from flashvtg_tpu_torch.models.transformer import tiled_attn_donors
from flashvtg_tpu_torch.ops import aca, chunked_attn
from flashvtg_tpu_torch.ops.aca import _merge_heads, _split_heads
from flashvtg_tpu_torch.ops.attn_dropout import keep_scale

B, L, HEADS = 2, 300, 2
SCALE = 32 ** -0.5
SEED = 777
FWD_ATOL = 1e-5
GRAD_RTOL = 1e-4


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: the low 13 mantissa bits rounded away, to
    nearest, ties away from zero (the carry may raise the exponent)."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0x1000) & 0xFFFFE000
    bits = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits)
    return bits.to(torch.int32).view(torch.float32).view(x.shape)


def split(x):
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def dot(eq, a, b, mode):
    """einsum `eq` of f32 a and b with the products taken as `mode`:
    "3x" (lo.hi + hi.lo + hi.hi, small terms first) or "1x" (hi.hi)."""
    (ah, al), (bh, bl) = split(a), split(b)
    if mode == "1x":
        return torch.einsum(eq, ah, bh)
    out = torch.einsum(eq, al, bh)
    out = out + torch.einsum(eq, ah, bl)
    return out + torch.einsum(eq, ah, bh)


def _z(p, lq, lk, dtype=torch.float32):
    return keep_scale(SEED, p, B, HEADS, torch.arange(lq), lk, dtype)


def flash_forward(q, k, v, valid, p, mode):
    """The forward kernel's arithmetic: scale q in f32, S on the emulated
    tensor cores, softmax in f32, P z V on the emulated tensor cores,
    divided by the undropped row sum; lse = m + log(l)."""
    qh, kh, vh = (_split_heads(x, HEADS) for x in (q * SCALE, k, v))
    s = dot("bhqd,bhkd->bhqk", qh, kh, mode).masked_fill(
        (valid <= 0)[:, None, None, :], float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    l = e.sum(dim=-1, keepdim=True)
    if p > 0:
        e = e * _z(p, L, L)
    out = dot("bhqk,bhkd->bhqd", e, vh, mode) / l
    return _merge_heads(out), (m + torch.log(l)).squeeze(-1)


def flash_backward(q, k, v, valid, out, lse, d_out, p, mode):
    """The backward kernels' arithmetic: D on the CUDA cores, every product
    of q.k, dO.v, dq, dk and dv on the emulated tensor cores; dk from the
    unscaled q, scaled after, as the dk/dv kernel."""
    qh, kh, vh, d_oh = (_split_heads(x, HEADS) for x in (q, k, v, d_out))
    delta = (d_oh * _split_heads(out, HEADS)).sum(dim=-1, keepdim=True)
    s = dot("bhqd,bhkd->bhqk", qh * SCALE, kh, mode)
    prob = torch.exp(s - lse[..., None]).masked_fill((valid <= 0)[:, None, None, :], 0.0)
    dp = dot("bhqd,bhkd->bhqk", d_oh, vh, mode)
    z = _z(p, L, L) if p > 0 else torch.ones_like(prob)
    ds = prob * (z * dp - delta)
    dq = dot("bhqk,bhkd->bhqd", ds, kh, mode) * SCALE
    dk = dot("bhqk,bhqd->bhkd", ds, qh, mode) * SCALE
    dv = dot("bhqk,bhqd->bhkd", prob * z, d_oh, mode)
    return tuple(_merge_heads(x) for x in (dq, dk, dv))


@pytest.fixture(scope="module")
def operands():
    rng = np.random.default_rng(31)
    q, k, v, d_out = (torch.from_numpy(rng.standard_normal((B, L, HEADS * 32), dtype=np.float32))
                      for _ in range(4))
    valid = (rng.random((B, L)) < 0.6).astype(np.float32)  # holes, not a prefix
    valid[:, 0] = 1.0
    return q, k, v, torch.from_numpy(valid), d_out


def _reference(operands, p):
    """The plain versions in float64: out, lse, (dq, dk, dv)."""
    q, k, v, valid, d_out = (x.double() for x in operands)
    out, lse = chunked_attn.flash_attention_plain(q, k, v, valid, HEADS, p, SEED, want_lse=True)
    grads = chunked_attn.flash_attention_bwd_plain(q, k, v, valid, out, lse, d_out, HEADS, p,
                                                   SEED)
    return out, lse, grads


@pytest.mark.parametrize(
    "x,want",
    [
        (1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10),  # a tie: away from zero
        (-(1.0 + 2.0 ** -11), -(1.0 + 2.0 ** -10)),
        (1.0 + 2.0 ** -11 - 2.0 ** -23, 1.0),  # just below the tie
        (2.0 - 2.0 ** -23, 2.0),  # the carry raises the exponent
    ],
)
def test_tf32_rna_rounds_to_nearest_ties_away(x, want):
    got = tf32_rna(torch.tensor([x], dtype=torch.float32))
    assert got.item() == want


def test_split_keeps_22_bits():
    x = torch.from_numpy(np.random.default_rng(32).standard_normal(4096, dtype=np.float32))
    hi, lo = split(x)
    assert torch.equal(tf32_rna(hi), hi) and torch.equal(tf32_rna(lo), lo)
    rel = ((hi.double() + lo.double() - x.double()).abs() / x.double().abs()).max().item()
    assert rel <= 2.0 ** -21


@pytest.mark.parametrize("p", [0.0, 0.1])
def test_forward_in_3xtf32_meets_f32_tolerance(operands, p):
    q, k, v, valid, _ = operands
    out, lse = flash_forward(q, k, v, valid, p, "3x")
    ref_out, ref_lse, _ = _reference(operands, p)
    assert (out.double() - ref_out).abs().max().item() <= FWD_ATOL
    assert (lse.double() - ref_lse).abs().max().item() <= FWD_ATOL


@pytest.mark.parametrize("p", [0.0, 0.1])
def test_forward_in_1xtf32_misses_it(operands, p):
    q, k, v, valid, _ = operands
    out, lse = flash_forward(q, k, v, valid, p, "1x")
    ref_out, ref_lse, _ = _reference(operands, p)
    err = max((out.double() - ref_out).abs().max().item(),
              (lse.double() - ref_lse).abs().max().item())
    assert err > FWD_ATOL


@pytest.mark.parametrize("p", [0.0, 0.1])
def test_backward_in_3xtf32_meets_f32_tolerance(operands, p):
    q, k, v, valid, d_out = operands
    out, lse = flash_forward(q, k, v, valid, p, "3x")
    grads = flash_backward(q, k, v, valid, out, lse, d_out, p, "3x")
    _, _, ref = _reference(operands, p)
    for name, got, want in zip(("dq", "dk", "dv"), grads, ref):
        err = (got.double() - want).abs().max() / want.abs().max()
        assert err.item() <= GRAD_RTOL, name


@pytest.mark.parametrize("p", [0.0, 0.1])
def test_backward_in_1xtf32_misses_it(operands, p):
    q, k, v, valid, d_out = operands
    out, lse = flash_forward(q, k, v, valid, p, "1x")
    grads = flash_backward(q, k, v, valid, out, lse, d_out, p, "1x")
    _, _, ref = _reference(operands, p)
    err = max(((got.double() - want).abs().max() / want.abs().max()).item()
              for got, want in zip(grads, ref))
    assert err > GRAD_RTOL


# --- the ACA kernels (csrc/aca_attention.cu, csrc/aca_attention_bwd.cu) ------

LK, ND = 75, 10
ACA_CASES = ["aca", "short"]  # dummies, head mean and donor rows; or none


@pytest.fixture(scope="module")
def aca_operands():
    rng = np.random.default_rng(33)
    q, d_out = (torch.from_numpy(rng.standard_normal((B, L, HEADS * 32), dtype=np.float32))
                for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((B, LK, HEADS * 32), dtype=np.float32))
            for _ in range(2))
    valid = (rng.random((B, LK)) < 0.6).astype(np.float32)  # holes past the dummies
    valid[:, :ND] = 1.0
    d_hm = torch.from_numpy(rng.standard_normal((B, L, LK), dtype=np.float32))
    query_valid = torch.from_numpy((np.arange(L)[None] < np.asarray([[L], [200]]))
                                   .astype(np.float32))
    return q, k, v, torch.from_numpy(valid), d_out, d_hm, query_valid, tiled_attn_donors(B, HEADS)


def _aca_args(aca_operands, case):
    """(q, k, v, valid, d_out, d_hm or None, nd, query_valid, donors) of a case."""
    q, k, v, valid, d_out, d_hm, query_valid, donors = aca_operands
    if case == "aca":
        return q, k, v, valid, d_out, d_hm, ND, query_valid, donors
    return q, k, v, valid, d_out, None, 0, None, None


def _aca_mask(q, k, valid, query_valid, donors):
    return torch.isinf(aca._masked_logits(q, k, valid, HEADS, query_valid, donors))


def aca_forward(q, k, v, valid, nd, p, query_valid, donors, mode):
    """The forward kernel's arithmetic: S on the emulated tensor cores, masked
    keys at -1e30, softmax and head mean in f32, P z V on the emulated
    tensor cores over the keys past the dummies; lse = m + log(l)."""
    qh, kh, vh = (_split_heads(x, HEADS) for x in (q * SCALE, k, v))
    s = dot("bhqd,bhkd->bhqk", qh, kh, mode).masked_fill(
        _aca_mask(q, k, valid, query_valid, donors), -1e30)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    l = e.sum(dim=-1, keepdim=True)
    prob = e / l
    pz = prob * _z(p, L, LK) if p > 0 else prob.clone()
    pz[..., :nd] = 0.0
    out = dot("bhqk,bhkd->bhqd", pz, vh, mode)
    return _merge_heads(out), prob.sum(dim=1) / HEADS, (m + torch.log(l)).squeeze(-1)


def aca_backward(q, k, v, valid, lse, d_out, d_hm, nd, p, query_valid, donors, mode):
    """The backward kernel's arithmetic: every product of q.k, dO.v, dq, dk
    and dv on the emulated tensor cores, P, dP, D and dS in f32; dk from the
    unscaled q, scaled after, as the kernel."""
    qh, kh, vh, d_oh = (_split_heads(x, HEADS) for x in (q, k, v, d_out))
    s = dot("bhqd,bhkd->bhqk", qh * SCALE, kh, mode)
    prob = torch.exp(s - lse[..., None]).masked_fill(
        _aca_mask(q, k, valid, query_valid, donors), 0.0)
    z = _z(p, L, LK) if p > 0 else torch.ones_like(prob)
    z[..., :nd] = 0.0
    dp = z * dot("bhqd,bhkd->bhqk", d_oh, vh, mode)
    if d_hm is not None:
        dp = dp + d_hm[:, None] / HEADS
    ds = prob * (dp - (prob * dp).sum(dim=-1, keepdim=True))
    dq = dot("bhqk,bhkd->bhqd", ds, kh, mode) * SCALE
    dk = dot("bhqk,bhqd->bhkd", ds, qh, mode) * SCALE
    dv = dot("bhqk,bhqd->bhkd", prob * z, d_oh, mode)
    return tuple(_merge_heads(x) for x in (dq, dk, dv))


def _aca_reference(args, p):
    """The plain versions in float64: out, head mean, lse, (dq, dk, dv)."""
    q, k, v, valid, d_out, d_hm, nd, query_valid, donors = args
    q, k, v, d_out = (x.double() for x in (q, k, v, d_out))
    d_hm = None if d_hm is None else d_hm.double()
    out, hm, lse = aca.aca_attention_plain(q, k, v, valid, HEADS, nd, True, p, SEED,
                                           query_valid, donors, want_lse=True)
    grads = aca.aca_attention_bwd_plain(q, k, v, valid, lse, d_out, d_hm, HEADS, nd, p, SEED,
                                        query_valid, donors)
    return out, hm, lse, grads


def _aca_forward_err(aca_operands, case, p, mode):
    q, k, v, valid, _, _, nd, query_valid, donors = args = _aca_args(aca_operands, case)
    got = aca_forward(q, k, v, valid, nd, p, query_valid, donors, mode)
    ref = _aca_reference(args, p)[:3]
    return max((x.double() - y).abs().max().item() for x, y in zip(got, ref))


def _aca_backward_err(aca_operands, case, p, mode):
    q, k, v, valid, d_out, d_hm, nd, query_valid, donors = args = _aca_args(aca_operands, case)
    lse = aca_forward(q, k, v, valid, nd, p, query_valid, donors, mode)[2]
    grads = aca_backward(q, k, v, valid, lse, d_out, d_hm, nd, p, query_valid, donors, mode)
    ref = _aca_reference(args, p)[3]
    return max(((got.double() - want).abs().max() / want.abs().max()).item()
               for got, want in zip(grads, ref))


@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("case", ACA_CASES)
def test_aca_forward_in_3xtf32_meets_f32_tolerance(aca_operands, case, p):
    assert _aca_forward_err(aca_operands, case, p, "3x") <= FWD_ATOL


@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("case", ACA_CASES)
def test_aca_forward_in_1xtf32_misses_it(aca_operands, case, p):
    assert _aca_forward_err(aca_operands, case, p, "1x") > FWD_ATOL


@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("case", ACA_CASES)
def test_aca_backward_in_3xtf32_meets_f32_tolerance(aca_operands, case, p):
    assert _aca_backward_err(aca_operands, case, p, "3x") <= GRAD_RTOL


@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("case", ACA_CASES)
def test_aca_backward_in_1xtf32_misses_it(aca_operands, case, p):
    assert _aca_backward_err(aca_operands, case, p, "1x") > GRAD_RTOL
