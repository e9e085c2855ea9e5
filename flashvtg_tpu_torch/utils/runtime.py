"""Device selection, the f32 parity switches and the precision dials.

Counterpart of flashvtg_tpu/utils/runtime.py (`setup`) and of the
`jax.default_matmul_precision` scopes around the JAX package's eval and
train steps. Entry points take an explicit `device`; None means the card.
Asking for the card where CUDA is absent is an error, never a silent move
to the CPU: the CPU runs only when the caller asks for it (the tests do).

`matmul_precision(mode, device)` is a dial's scope. The modes, and what each
maps to (JAX on the TPU sets MXU passes; here cuBLAS / cuDNN and the four
attention kernels' product form, ops/forms.py):
  float32        TF32 off (set_f32_parity); kernels in 3xTF32 (f32-accurate)
  tensorfloat32  TF32 on for cuBLAS and cuDNN; kernels in 1xTF32
  bfloat16       torch.autocast(bfloat16): GEMMs and convs take bf16
                 operands and give bf16 results; kernels on bf16 operands
                 with f32 sums
On the CPU tensorfloat32 leaves the GEMMs in f32 (no TF32 there) and the
attention kernels' plain versions round as the 1xTF32 form does.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]

PRECISIONS = ("float32", "tensorfloat32", "bfloat16")
TRANSFER_DTYPES = ("float32", "bfloat16")  # the train features on the host-to-card copy
KERNEL_FORMS = {"float32": "3xtf32", "tensorfloat32": "1xtf32", "bfloat16": "bf16"}

# the attention kernels' product form, read by their wrappers at launch;
# "3xtf32" outside any dial
_dial = {"form": "3xtf32"}


def set_f32_parity() -> None:
    """True float32 on the card. The cuDNN flag defaults to True, and the
    pyramid and head convolutions go through cuDNN; TF32 keeps about three
    decimal digits, which the parity tolerances do not absorb."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def check_precision(mode: str) -> str:
    if mode not in PRECISIONS:
        raise ValueError(f"unknown precision {mode!r}; expected one of {PRECISIONS}")
    return mode


def kernel_form() -> str:
    """The product form of the attention kernels in the current dial."""
    return _dial["form"]


@contextlib.contextmanager
def matmul_precision(mode: str, device: DeviceLike, autocast_cache: bool = True):
    """Run the enclosed code at `mode` on `device` (see the module's table),
    then restore the TF32 flags, the kernel form and autocast as they were,
    also after an exception. Raises ValueError for an unknown mode.
    `autocast_cache=False` turns off autocast's cache of bf16 weight casts,
    as a CUDA-graph capture of the enclosed code needs (the casts are the
    same; only their reuse within the scope goes)."""
    check_precision(mode)
    device_type = torch.device(device if device is not None else "cuda").type
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             _dial["form"])
    tf32 = mode == "tensorfloat32"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    _dial["form"] = KERNEL_FORMS[mode]
    try:
        if mode == "bfloat16":
            with torch.autocast(device_type, dtype=torch.bfloat16,
                                cache_enabled=autocast_cache):
                yield
        else:
            yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
         _dial["form"]) = saved


def widened(*tensors: torch.Tensor):
    """Each tensor in float32 where autocast made it narrower (bf16, f16),
    as it is where it is float32 or float64."""
    return tuple(t.float() if t.dtype in (torch.bfloat16, torch.float16) else t
                 for t in tensors)


def float32_outputs(tree):
    """`tree` (a tensor, or dicts, lists and tuples of them) widened: a
    model's outputs under autocast, before decode, NMS and the criterion,
    which run in f32 as on the JAX side."""
    if isinstance(tree, torch.Tensor):
        return widened(tree)[0]
    if isinstance(tree, dict):
        return {k: float32_outputs(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(float32_outputs(v) for v in tree)
    return tree


def resolve_device(device: DeviceLike = None) -> torch.device:
    """`device` as a torch.device; None selects "cuda". Raises when CUDA is
    asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: the port runs on the card by default; "
                "pass device='cpu' to run the plain PyTorch versions on the CPU"
            )
        set_f32_parity()
    return dev
