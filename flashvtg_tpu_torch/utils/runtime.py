"""Device selection and the f32 parity switches.

Counterpart of flashvtg_tpu/utils/runtime.py (`setup`). Entry points take an
explicit `device`; None means the card. Asking for the card where CUDA is
absent is an error, never a silent move to the CPU: the CPU runs only when
the caller asks for it (the tests do).
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def set_f32_parity() -> None:
    """True float32 on the card. The cuDNN flag defaults to True, and the
    pyramid and head convolutions go through cuDNN; TF32 keeps about three
    decimal digits, which the parity tolerances do not absorb."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


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
