"""Product forms of the reference: the rounding of a product's operands
and of the gradients that enter it in the backward, for the controls that
compute the reference below the configuration's precision."""

from __future__ import annotations

import torch


def _identity(x):
    return x


def _scaled(dtype, top: float):
    def q(x):
        s = top / x.abs().amax().clamp_min(1e-30)
        return (x * s).to(dtype).to(x.dtype) / s
    return q


def _tf32(x):
    bits = x.float().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32).to(x.dtype)


# form: (rounding of a product's operands, rounding of the gradients that
# enter a product in the backward)
FORMS = {
    "exact": (None, None),
    "tf32": (_tf32, None),
    "bf16": (lambda x: x.to(torch.bfloat16).to(x.dtype),
             lambda x: x.to(torch.bfloat16).to(x.dtype)),
    # the hybrid fp8 recipe of Hopper training: e4m3 operands, e5m2
    # gradients, each tensor scaled to its type's largest finite value
    "fp8": (_scaled(torch.float8_e4m3fn, 448.0), _scaled(torch.float8_e5m2, 57344.0)),
}


class _RoundGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, q):
        ctx.q = q
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return ctx.q(g), None


class Form:
    """A product form: `form(x)` rounds an operand in the forward (its
    gradient passes unrounded: a cast's own gradient would round it to the
    narrow type with no scale); `form.out(y)` leaves a product's output as
    it is and rounds the gradient that comes back to it, which both of the
    product's backward products take; `op` and `grad` round a tensor
    directly (the attention's own backward)."""

    def __init__(self, name: str = "exact"):
        if name not in FORMS:
            raise ValueError(f"unknown form {name!r}")
        self.name = name
        op, grad = FORMS[name]
        self.op = op or _identity
        self.grad = grad or _identity
        self._has_op, self._has_grad = op is not None, grad is not None

    def __call__(self, x):
        if not self._has_op:
            return x
        return x + (self.op(x.detach()) - x).detach()

    def out(self, y):
        if not self._has_grad or not y.requires_grad:
            return y
        return _RoundGrad.apply(y, self.grad)
