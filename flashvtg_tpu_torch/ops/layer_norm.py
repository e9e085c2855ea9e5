"""LayerNorm over the last axis as one op written by hand: a forward kernel
and a fused backward (csrc/layer_norm.cu), with plain-torch twins of their
arithmetic, and `LayerNorm`, the module every layer norm of the port is.

The kernels replace no TPU kernel (XLA fuses LayerNorm into its neighbours
on the JAX side); they take the place of PyTorch's LayerNorm kernels and of
autocast's casts around them, which were the largest ops outside the
products and the attention kernels of the bf16 train step. What bounds them
(bytes) and how their design meets that is written at the top of the source.

  * layer_norm(x, weight, bias, eps): y over the last axis of x (..., d),
    y = (x - mean) rstd weight + bias, rstd = rsqrt(biased var + eps). On a
    CUDA tensor x is float32, or bfloat16 under autocast (the GEMMs and
    convolutions hand it on), and y is float32: autocast's float32 policy
    for layer_norm, which cast a bf16 x to f32 first (exact), so y is the
    same function without the cast. With a gradient wanted it goes through
    one torch.autograd.Function: the forward kernel also writes each row's
    mean and rstd (one (2, rows) allocation), and the backward writes dx
    (in x's dtype: autograd's cast back, the same rounding; not written
    where x wants no gradient), dgamma and dbeta in one pass over the rows
    plus a small pass that sums the blocks' partials in a fixed order (no
    atomics: a CUDA-graph replay gives the same bits). Without one (the
    eval under no_grad) the forward launcher is called directly, as cheap
    on the host as F.layer_norm is: one allocation, one C call, no
    statistics written.
  * On the CPU the op is torch's own layer_norm, bit for bit what
    nn.LayerNorm computes in every dtype (the CPU tests compare the port
    with the JAX package through it). layer_norm_plain and
    layer_norm_bwd_plain repeat the kernels' arithmetic in plain torch;
    the card tests and chip_smoke.py hold the kernels to them.
  * A CUDA tensor launches the kernels or raises; nothing falls back.

Each launcher counts its launches in LAUNCHES ("layer_norm",
"layer_norm_bwd"), where it launches and nowhere else: a call inside a
CUDA-graph capture only records the kernel and is not counted, and a
replay makes no Python call (its launches are read from the device). Every
call of `layer_norm`, on any device and inside a capture too, adds one to
the program counter `ops.layer_norm` (utils/observability.py).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from flashvtg_tpu_torch.utils import observability as obs

EPS = 1e-5
MAX_WIDTH = 16384  # csrc/layer_norm.cu: kMaxWidth
MAX_ROWS = 2 ** 31 - 1  # the C entries take the row count as an int
_F32, _BF16 = torch.float32, torch.bfloat16
KERNELS = ("layer_norm", "layer_norm_bwd")
LAUNCHES: Dict[str, int] = dict.fromkeys(KERNELS, 0)
# the backward's grid by (rows, d, x is bf16, device index): one wave of
# the card's SMs at the kernel's occupancy (flashvtg_layer_norm_bwd_blocks)
_BWD_BLOCKS: Dict[Tuple[int, int, bool, int], int] = {}
_LIB = None  # the loaded library (kernels.load("layer_norm"))


def launch_counts() -> Dict[str, int]:
    """Each kernel's launches since the last reset."""
    return dict(LAUNCHES)


def reset_launch_counts() -> None:
    LAUNCHES.update(dict.fromkeys(KERNELS, 0))


def _count(name: str) -> None:
    if not torch._C._cuda_isCurrentStreamCapturing():
        LAUNCHES[name] += 1


def layer_norm_plain(x, weight, bias, eps: float = EPS):
    """The forward kernel's arithmetic in plain torch: (y (..., d) float32,
    stats (2, rows): each row's mean, then its rstd), x widened to float32,
    mean and biased variance by two passes."""
    d = x.shape[-1]
    xf = x.float()
    mean = xf.sum(-1, keepdim=True) / d
    xc = xf - mean
    rstd = torch.rsqrt((xc * xc).sum(-1, keepdim=True) / d + eps)
    y = xc * rstd * weight + bias
    return y, torch.stack([mean.reshape(-1), rstd.reshape(-1)])


def layer_norm_bwd_plain(dy, x, stats, weight, want_dx: bool = True):
    """The backward kernel's arithmetic in plain torch: (dx in x's dtype, or
    None without `want_dx`; dgamma; dbeta), from dy (..., d), the forward's
    x and stats: xh = (x - mean) rstd, g = dy weight,
    dx = rstd (g - mean_j g - xh mean_j (g xh)), dgamma = sum dy xh,
    dbeta = sum dy over the rows, in float32."""
    d = x.shape[-1]
    xf, dyf = x.float().reshape(-1, d), dy.float().reshape(-1, d)
    mean, rstd = stats[0][:, None], stats[1][:, None]
    xh = (xf - mean) * rstd
    dx = None
    if want_dx:
        g = dyf * weight
        dx = rstd * (g - g.sum(-1, keepdim=True) / d - xh * (g * xh).sum(-1, keepdim=True) / d)
        dx = dx.to(x.dtype).reshape(x.shape)
    return dx, (dyf * xh).sum(0), dyf.sum(0)


def _aligned(t):
    """`t` contiguous and 16-byte aligned, as the kernels read it (a
    gradient, or a transposed convolution output, may arrive as a strided
    or offset view)."""
    if not t.is_contiguous():
        t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check(x, weight, bias) -> None:
    """The launchers' checks: x on the card, float32 (or bfloat16 under
    autocast), 1 to MAX_WIDTH wide, at most MAX_ROWS rows; weight and bias
    float32 (d,) beside it. Raises on what the kernels do not take."""
    tag = "layer_norm kernel"
    if x.device.type != "cuda":
        raise ValueError(f"{tag}: x on {x.device}, expected CPU or CUDA")
    if x.dtype != torch.float32:
        if x.dtype != torch.bfloat16:
            raise TypeError(f"{tag}: x is {x.dtype}, expected float32 or bfloat16")
        if not torch.is_autocast_enabled("cuda"):
            raise TypeError(f"{tag}: bfloat16 x outside autocast (nn.LayerNorm would return "
                            "bfloat16; the kernel writes float32, as autocast's policy)")
    d = x.shape[-1] if x.dim() else 0
    if not 1 <= d <= MAX_WIDTH or x.numel() // d > MAX_ROWS:
        raise ValueError(f"{tag}: x {tuple(x.shape)}: width outside [1, {MAX_WIDTH}] or more "
                         f"than {MAX_ROWS} rows")
    for name, p in (("weight", weight), ("bias", bias)):
        if p.dtype != torch.float32 or p.shape != (d,) or p.device != x.device:
            raise ValueError(f"{tag}: {name} must be float32 ({d},) on {x.device}, got "
                             f"{p.dtype} {tuple(p.shape)} on {p.device}")


def _check_rc(tag: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{tag} launch failed: CUDA error {rc}")


def _lib():
    """The kernels' library, loaded (and built) at the first call."""
    global _LIB
    if _LIB is None:
        from flashvtg_tpu_torch import kernels

        _LIB = kernels.load("layer_norm")
    return _LIB


def _forward(x, weight, bias, eps: float, want_stats: bool):
    """The forward kernel: (x as the kernel read it, y float32, stats (2,
    rows) or None). The eval's case, a float32 x that is contiguous and
    16-byte aligned beside float32 (d,) parameters, is told by a few
    attribute reads, so that an eval call costs the host about what
    F.layer_norm costs; anything else takes _check and _aligned."""
    d = x.shape[-1] if x.dim() else 0
    rows = x.numel() // d if d else 0
    xp, wp, bp = x.data_ptr(), weight.data_ptr(), bias.data_ptr()
    if not (x.dtype is _F32 is weight.dtype is bias.dtype and weight.shape == bias.shape == (d,)
            and 0 < d <= MAX_WIDTH and rows <= MAX_ROWS and not (xp | wp | bp) & 15
            and x.is_contiguous() and weight.is_contiguous() and bias.is_contiguous()
            and x.get_device() == weight.get_device() == bias.get_device() >= 0):
        _check(x, weight, bias)
        x, weight, bias = _aligned(x), _aligned(weight), _aligned(bias)
        xp, wp, bp = x.data_ptr(), weight.data_ptr(), bias.data_ptr()
    y = torch.empty_like(x, dtype=_F32)
    stats = torch.empty((2, rows), dtype=_F32, device=x.device) if want_stats else None
    if rows:
        rc = _lib().flashvtg_layer_norm_fwd(
            xp, wp, bp, y.data_ptr(), None if stats is None else stats.data_ptr(), rows, d,
            x.dtype is _BF16, eps, torch._C._cuda_getCurrentRawStream(x.get_device()))
        if rc:
            _check_rc("layer_norm kernel", rc)
        _count("layer_norm")
    return x, y, stats


def bwd_blocks(rows: int, d: int, bf16: bool, device) -> int:
    """The backward kernel's grid at (rows, d, x's dtype) on `device`, asked
    of the library once and kept: its partials take (2, blocks, d)."""
    device = torch.device(device)
    key = (rows, d, bool(bf16), device.index)
    blocks = _BWD_BLOCKS.get(key)
    if blocks is None:
        with torch.cuda.device(device):
            blocks = _lib().flashvtg_layer_norm_bwd_blocks(rows, d, bool(bf16))
        if blocks < 1:
            raise RuntimeError(f"layer_norm backward grid: CUDA error {-blocks}")
        _BWD_BLOCKS[key] = blocks
    return blocks


def _backward(dy, x, stats, weight, want_dx: bool):
    """The backward kernels: (dx in x's dtype or None, dgamma, dbeta), from
    the forward's x (as the kernel read it) and stats."""
    tag = "layer_norm backward kernel"
    d = x.shape[-1]
    rows = x.numel() // d
    dy = _aligned(dy if dy.dtype == torch.float32 else dy.float())
    if dy.shape != x.shape or dy.device != x.device:
        raise ValueError(f"{tag}: dy {tuple(dy.shape)} on {dy.device}, x {tuple(x.shape)}")
    dx = torch.empty_like(x) if want_dx else None
    dgamma = torch.empty(d, dtype=torch.float32, device=x.device)
    dbeta = torch.empty(d, dtype=torch.float32, device=x.device)
    if not rows:
        return dx, dgamma.zero_(), dbeta.zero_()
    bf16 = x.dtype == torch.bfloat16
    blocks = bwd_blocks(rows, d, bf16, x.device)
    part = torch.empty((2, blocks, d), dtype=torch.float32, device=x.device)
    rc = _lib().flashvtg_layer_norm_bwd(
        x.data_ptr(), dy.data_ptr(), stats.data_ptr(), weight.data_ptr(),
        None if dx is None else dx.data_ptr(), part.data_ptr(), dgamma.data_ptr(),
        dbeta.data_ptr(), rows, d, bf16, blocks,
        torch._C._cuda_getCurrentRawStream(x.get_device()))
    _check_rc(tag, rc)
    _count("layer_norm_bwd")
    return dx, dgamma, dbeta


class _LayerNormFn(torch.autograd.Function):
    """The kernels' forward (with the row statistics) and backward."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        x, y, stats = _forward(x, weight, bias, eps, True)
        ctx.save_for_backward(x, weight, stats)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, stats = ctx.saved_tensors
        dx, dgamma, dbeta = _backward(dy, x, stats, weight, ctx.needs_input_grad[0])
        return dx, dgamma, dbeta, None


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = EPS) -> torch.Tensor:
    """LayerNorm of x over its last axis (see the module's doc): torch's own
    on the CPU, the kernels on the card."""
    obs.count("ops.layer_norm")
    if not x.is_cuda:
        return F.layer_norm(x, x.shape[-1:], weight, bias, eps)
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                    or bias.requires_grad):
        return _LayerNormFn.apply(x, weight, bias, eps)
    return _forward(x, weight, bias, eps, False)[1]


class LayerNorm(nn.LayerNorm):
    """nn.LayerNorm(d, eps) over the last axis whose forward is `layer_norm`:
    the same parameters (weight, bias), so state dicts and the reference
    checkpoints' keys are unchanged."""

    def __init__(self, d: int, eps: float = EPS):
        super().__init__(d, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps)

