"""Device kernel names, by class and by attention family.

`kernel_class` is a frozen copy of the program's profile classes
(tools/profile_eval.py:kernel_class) with one correction: the bf16 flash
forward's pre-pass `flash_fwd_stage_kernel` belongs to the flash forward,
not to "other". `family` puts every attention kernel, pre-passes and
reduction passes included, in the family whose least time the roofline
counts; `MAIN` names the one kernel each attention call launches once,
by which the launches seen in a trace are checked against the calls made.
"""

from __future__ import annotations

import re
from typing import Optional

# (family, backward) -> the kernel every call of it launches once
MAIN = {
    ("flash", False): "flash_attention_kernel",
    ("flash", True): "flash_bwd_dq_kernel",
    ("aca", False): "aca_attention_kernel",
    ("aca", True): "aca_attention_bwd_kernel",
}


def kernel_class(name: str) -> str:
    low = name.lower()
    if "flash_attention_kernel" in low or "flash_fwd_stage" in low:
        return "flash_attention"
    if "flash_bwd_" in low:
        return "flash_attention_bwd"
    if "aca_attention_bwd" in low:  # the kernel and its chunk-sum pass
        return "aca_attention_bwd"  # the ACA and the short self-attention's
    hm = re.search(r"aca_attention_kernel<\d+,\s*\d+,\s*(true|false)", low)
    if hm:
        return "aca_attention" if hm.group(1) == "true" else "masked_attention"
    if ("gemm" in low or "cutlass" in low or "xmma" in low or "matmul" in low
            or "nvjet" in low):
        return "gemm"
    if "conv" in low or "cudnn" in low:
        return "conv"
    if "memcpy" in low or "memset" in low:
        return "memcpy/memset"
    return "other"


def family(name: str) -> Optional[str]:
    low = name.lower()
    if "flash_attention_kernel" in low or "flash_fwd_stage" in low or "flash_bwd_" in low:
        return "flash"
    if "aca_attention" in low:
        return "aca"
    return None


def main_call(name: str):
    """(family, backward) of a call's main kernel, or None."""
    low = name.lower()
    for key, kernel in MAIN.items():
        if re.search(kernel + r"\b", low):
            return key
    return None
