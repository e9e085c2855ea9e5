"""The attention kernels' three product forms, and their arithmetic in torch.

csrc/attn_common.cuh takes every dot product of the four attention kernels
on mma.sync.m16n8k8 (tf32 in, f32 out) in one of three forms, which the
precision dials choose (utils/runtime.py:matmul_precision):
  * "3xtf32" (the float32 dial): each f32 operand x is split into the TF32
    values hi = rna(x) and lo = rna(x - hi), and a.b is taken as
    lo_a.hi_b + hi_a.lo_b + hi_a.hi_b: the accuracy of f32;
  * "1xtf32" (tensorfloat32): hi_a.hi_b alone, about three decimal digits;
  * "bf16" (bfloat16): each operand rounded to bf16, to nearest even, with
    f32 products and sums (a bf16 value is exact in TF32 and the product of
    two is exact in f32, so the kernels take it on the TF32 instruction).
`dot` is each form's products on the CPU (tests/test_torch_tf32x3.py holds
them against float64). The kernels' plain versions (ops/aca.py,
ops/chunked_attn.py) take their products through `product`: an f32 einsum
at "3xtf32", which is f32-accurate, and `dot` at the other two forms, so
that each plain version stays its kernel's oracle at every form.
"""

from __future__ import annotations

import contextlib

import torch

FORMS = ("3xtf32", "1xtf32", "bf16")
FORM_IDS = {form: i for i, form in enumerate(FORMS)}  # the C entries' `form`


def check_form(form: str) -> str:
    if form not in FORM_IDS:
        raise ValueError(f"unknown product form {form!r}; expected one of {FORMS}")
    return form


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32 of float32 x: the low 13 mantissa bits rounded
    away, to nearest, ties away from zero (the carry may raise the
    exponent)."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0x1000) & 0xFFFFE000
    bits = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits)
    return bits.to(torch.int32).view(torch.float32).view(x.shape)


def split_tf32(x: torch.Tensor):
    """(hi, lo) of float32 x, both TF32: hi = rna(x), lo = rna(x - hi)."""
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def round_operand(x: torch.Tensor, form: str) -> torch.Tensor:
    """x as the tensor core reads it in the 1xtf32 or bf16 form, in x's
    dtype (a float32 x is rounded from its own value)."""
    if form == "1xtf32":
        return tf32_rna(x.float()).to(x.dtype)
    if form == "bf16":
        return x.to(torch.bfloat16).to(x.dtype)
    raise ValueError(f"no single rounding in form {form!r}")


def dot(eq: str, a: torch.Tensor, b: torch.Tensor, form: str) -> torch.Tensor:
    """einsum `eq` of float32 a and b with the products taken in `form`:
    "3xtf32" lo.hi + hi.lo + hi.hi (small terms first), "1xtf32" hi.hi,
    "bf16" the bf16-rounded operands; f32 sums."""
    if form == "3xtf32":
        (ah, al), (bh, bl) = split_tf32(a), split_tf32(b)
        out = torch.einsum(eq, al, bh)
        out = out + torch.einsum(eq, ah, bl)
        return out + torch.einsum(eq, ah, bh)
    return torch.einsum(eq, round_operand(a, form), round_operand(b, form))


def product(eq: str, a: torch.Tensor, b: torch.Tensor, form: str = "3xtf32") -> torch.Tensor:
    """The plain versions' products: einsum `eq` in the operands' own
    precision at "3xtf32" (f32-accurate, as the kernel), else with each
    operand rounded as the kernel's form rounds it."""
    if check_form(form) == "3xtf32":
        return torch.einsum(eq, a, b)
    return dot(eq, a, b, form)


def autocast_off(t: torch.Tensor):
    """A scope with autocast off on t's device (the CPU or the card; a
    context that does nothing elsewhere): the kernels and their plain
    versions take float32 operands and round them as their form says."""
    if t.device.type in ("cpu", "cuda"):
        return torch.autocast(t.device.type, enabled=False)
    return contextlib.nullcontext()
