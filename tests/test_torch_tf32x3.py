"""The precision argument of the attention kernels' product forms, on the CPU.

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

The other two forms (ops/forms.py, csrc/attn_common.cuh), which the
tensorfloat32 and bfloat16 dials select, are held the same way against
float64 with their ceilings, FORM_RTOL of the largest |value| of each
output: 1xTF32 (one TF32 product a dot) within 2e-3, bf16 operands with f32
sums within 1.6e-2; and each plain version at a form (the kernel's oracle on
the card) equals this emulation of its form, within TWIN_RTOL (f32 sums
taken in other orders). Measured worst figures (flash and ACA, forward and
backward, dropout 0 and 0.1): printed by the form tests (-s), and recorded
in ROADMAP.md "Known differences".

What this emulation does not show: the einsums here sum in f32 rounded to
nearest, while the tensor core's f32 accumulation truncates, so a product
chain that is too long on the card (one chain of 3xTF32 products over 4096
keys) would pass here. The kernels' accumulation order, and that it meets
the tolerances with truncation, are checked only on the card:
tests/test_torch_kernels.py (the kernels against their plain versions, and
dot_3xtf32 against an f32 FMA loop).
"""

import json

import numpy as np
import pytest
import torch

from flashvtg_tpu_torch.models.transformer import tiled_attn_donors
from flashvtg_tpu_torch.ops import aca, chunked_attn
from flashvtg_tpu_torch.ops.aca import _merge_heads, _split_heads
from flashvtg_tpu_torch.ops.attn_dropout import keep_scale
from flashvtg_tpu_torch.ops.forms import dot, round_operand, tf32_rna
from flashvtg_tpu_torch.ops.forms import split_tf32 as split

B, L, HEADS = 2, 300, 2
SCALE = 32 ** -0.5
SEED = 777
FWD_ATOL = 1e-5
GRAD_RTOL = 1e-4
FORM_RTOL = {"1xtf32": 2e-3, "bf16": 1.6e-2}
TWIN_RTOL = 1e-5  # a plain version at a form against this emulation of the form


def _z(p, lq, lk, dtype=torch.float32):
    return keep_scale(SEED, p, B, HEADS, torch.arange(lq), lk, dtype)


KERNEL_KEYS = 64  # keys a step of the forward kernel's online softmax


def flash_forward(q, k, v, valid, p, mode):
    """The forward kernel's arithmetic in form `mode` (ops/forms.py): scale
    q in f32, S on the emulated tensor cores; then, a step of KERNEL_KEYS
    keys at a time, the online softmax in f32: p = exp(s - m) with m the
    row max so far, P z V of the step on the emulated tensor cores, the
    output so far rescaled by exp(m_old - m); divided by the undropped row
    sum l at the end; lse = m + log(l)."""
    qh, kh, vh = (_split_heads(x, HEADS) for x in (q * SCALE, k, v))
    s = dot("bhqd,bhkd->bhqk", qh, kh, mode).masked_fill(
        (valid <= 0)[:, None, None, :], float("-inf"))
    z = _z(p, L, L) if p > 0 else torch.ones_like(s)
    m = torch.full(s.shape[:-1] + (1,), float("-inf"))
    l = torch.zeros_like(m)
    out = torch.zeros_like(qh)
    for j in range(0, L, KERNEL_KEYS):
        s_j = s[..., j : j + KERNEL_KEYS]
        m_new = torch.maximum(m, s_j.amax(dim=-1, keepdim=True))
        m_use = torch.where(m_new > float("-inf"), m_new, 0.0)
        alpha = torch.exp(m - m_use)
        e = torch.exp(s_j - m_use)
        l = l * alpha + e.sum(dim=-1, keepdim=True)
        out = out * alpha + dot("bhqk,bhkd->bhqd", e * z[..., j : j + KERNEL_KEYS],
                                vh[:, :, j : j + KERNEL_KEYS], mode)
        m = m_new
    return _merge_heads(out / l), (m + torch.log(l)).squeeze(-1)


def flash_backward(q, k, v, valid, out, lse, d_out, p, mode):
    """The backward kernels' arithmetic: D on the CUDA cores, every product
    of q.k, dO.v, dq, dk and dv on the emulated tensor cores; dk from
    D' = rowsum(P z dP), which the dq kernel sums, and the unscaled q,
    scaled after, as the dk/dv kernel."""
    qh, kh, vh, d_oh = (_split_heads(x, HEADS) for x in (q, k, v, d_out))
    delta = (d_oh * _split_heads(out, HEADS)).sum(dim=-1, keepdim=True)
    s = dot("bhqd,bhkd->bhqk", qh * SCALE, kh, mode)
    prob = torch.exp(s - lse[..., None]).masked_fill((valid <= 0)[:, None, None, :], 0.0)
    dp = dot("bhqd,bhkd->bhqk", d_oh, vh, mode)
    z = _z(p, L, L) if p > 0 else torch.ones_like(prob)
    ds = prob * (z * dp - delta)
    dq = dot("bhqk,bhkd->bhqd", ds, kh, mode) * SCALE
    ds_k = prob * (z * dp - (prob * z * dp).sum(dim=-1, keepdim=True))
    dk = dot("bhqk,bhqd->bhkd", ds_k, qh, mode) * SCALE
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
    out, lse = flash_forward(q, k, v, valid, p, "3xtf32")
    ref_out, ref_lse, _ = _reference(operands, p)
    assert (out.double() - ref_out).abs().max().item() <= FWD_ATOL
    assert (lse.double() - ref_lse).abs().max().item() <= FWD_ATOL


@pytest.mark.parametrize("p", [0.0, 0.1])
def test_forward_in_1xtf32_misses_it(operands, p):
    q, k, v, valid, _ = operands
    out, lse = flash_forward(q, k, v, valid, p, "1xtf32")
    ref_out, ref_lse, _ = _reference(operands, p)
    err = max((out.double() - ref_out).abs().max().item(),
              (lse.double() - ref_lse).abs().max().item())
    assert err > FWD_ATOL


@pytest.mark.parametrize("p", [0.0, 0.1])
def test_backward_in_3xtf32_meets_f32_tolerance(operands, p):
    q, k, v, valid, d_out = operands
    out, lse = flash_forward(q, k, v, valid, p, "3xtf32")
    grads = flash_backward(q, k, v, valid, out, lse, d_out, p, "3xtf32")
    _, _, ref = _reference(operands, p)
    for name, got, want in zip(("dq", "dk", "dv"), grads, ref):
        err = (got.double() - want).abs().max() / want.abs().max()
        assert err.item() <= GRAD_RTOL, name


@pytest.mark.parametrize("p", [0.0, 0.1])
def test_backward_in_1xtf32_misses_it(operands, p):
    q, k, v, valid, d_out = operands
    out, lse = flash_forward(q, k, v, valid, p, "1xtf32")
    grads = flash_backward(q, k, v, valid, out, lse, d_out, p, "1xtf32")
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
    assert _aca_forward_err(aca_operands, case, p, "3xtf32") <= FWD_ATOL


@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("case", ACA_CASES)
def test_aca_forward_in_1xtf32_misses_it(aca_operands, case, p):
    assert _aca_forward_err(aca_operands, case, p, "1xtf32") > FWD_ATOL


@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("case", ACA_CASES)
def test_aca_backward_in_3xtf32_meets_f32_tolerance(aca_operands, case, p):
    assert _aca_backward_err(aca_operands, case, p, "3xtf32") <= GRAD_RTOL


@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("case", ACA_CASES)
def test_aca_backward_in_1xtf32_misses_it(aca_operands, case, p):
    assert _aca_backward_err(aca_operands, case, p, "1xtf32") > GRAD_RTOL


# --- the 1xTF32 and bf16 forms (the tensorfloat32 and bfloat16 dials) ------


def _rel(got, want):
    return ((got.double() - want.double()).abs().max() / want.double().abs().max()).item()


FLASH_OUTPUTS = ("out", "lse", "dq", "dk", "dv")
ACA_OUTPUTS = ("out", "head_mean", "lse", "dq", "dk", "dv")


def _flash_form(operands, p, form):
    q, k, v, valid, d_out = operands
    out, lse = flash_forward(q, k, v, valid, p, form)
    return (out, lse, *flash_backward(q, k, v, valid, out, lse, d_out, p, form))


def _aca_form(aca_operands, case, p, form):
    q, k, v, valid, d_out, d_hm, nd, query_valid, donors = _aca_args(aca_operands, case)
    out, hm, lse = aca_forward(q, k, v, valid, nd, p, query_valid, donors, form)
    grads = aca_backward(q, k, v, valid, lse, d_out, d_hm, nd, p, query_valid, donors, form)
    return out, hm, lse, *grads


@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("form", sorted(FORM_RTOL))
def test_flash_forms_meet_their_ceiling(operands, form, p):
    ref_out, ref_lse, ref_grads = _reference(operands, p)
    errs = {name: _rel(got, want) for name, got, want in
            zip(FLASH_OUTPUTS, _flash_form(operands, p, form), (ref_out, ref_lse, *ref_grads))}
    print(json.dumps(dict(kernel="flash", form=form, p=p, **errs)))
    assert max(errs.values()) <= FORM_RTOL[form], errs


@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("case", ACA_CASES)
@pytest.mark.parametrize("form", sorted(FORM_RTOL))
def test_aca_forms_meet_their_ceiling(aca_operands, form, case, p):
    ref_out, ref_hm, ref_lse, ref_grads = _aca_reference(_aca_args(aca_operands, case), p)
    refs = (ref_out, ref_hm, ref_lse, *ref_grads)
    errs = {name: _rel(got, want) for name, got, want in
            zip(ACA_OUTPUTS, _aca_form(aca_operands, case, p, form), refs)}
    print(json.dumps(dict(kernel="aca", case=case, form=form, p=p, **errs)))
    assert max(errs.values()) <= FORM_RTOL[form], errs


@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("form", sorted(FORM_RTOL))
def test_flash_plain_at_a_form_is_its_emulation(operands, form, p):
    """chunked_attn's plain forward and backward at `form` (the kernels'
    oracles on the card) against the emulation above, on the same inputs."""
    q, k, v, valid, d_out = operands
    want = _flash_form(operands, p, form)
    out, lse = chunked_attn.flash_attention_plain(q, k, v, valid, HEADS, p, SEED,
                                                  want_lse=True, form=form)
    grads = chunked_attn.flash_attention_bwd_plain(q, k, v, valid, want[0], want[1], d_out,
                                                   HEADS, p, SEED, form=form)
    for name, got, ref in zip(FLASH_OUTPUTS, (out, lse, *grads), want):
        assert _rel(got, ref) <= TWIN_RTOL, name


@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("case", ACA_CASES)
@pytest.mark.parametrize("form", sorted(FORM_RTOL))
def test_aca_plain_at_a_form_is_its_emulation(aca_operands, form, case, p):
    q, k, v, valid, d_out, d_hm, nd, query_valid, donors = _aca_args(aca_operands, case)
    want = _aca_form(aca_operands, case, p, form)
    out, hm, lse = aca.aca_attention_plain(q, k, v, valid, HEADS, nd, True, p, SEED,
                                           query_valid, donors, want_lse=True, form=form)
    grads = aca.aca_attention_bwd_plain(q, k, v, valid, want[2], d_out, d_hm, HEADS, nd, p,
                                        SEED, query_valid, donors, form=form)
    for name, got, ref in zip(ACA_OUTPUTS, (out, hm, lse, *grads), want):
        assert _rel(got, ref) <= TWIN_RTOL, name


def test_bf16_operand_rounding_is_to_nearest_even():
    """The bf16 form's operands: torch's bf16 cast, which rounds to nearest
    even, as csrc/attn_common.cuh's cvt.rn.bf16x2.f32 does."""
    ties = torch.tensor([0x3F808000, 0x3F818000, 0x7F7FFFFF], dtype=torch.int64)
    x = torch.where(ties >= 2 ** 31, ties - 2 ** 32, ties).to(torch.int32).view(torch.float32)
    got = round_operand(x, "bf16").view(torch.int32).tolist()
    assert got == [0x3F800000, 0x3F820000, 0x7F800000]
