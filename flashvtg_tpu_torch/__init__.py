"""flashvtg_tpu_torch: the PyTorch + CUDA port of flashvtg_tpu for one NVIDIA
H100.

Slice 1 runs flagship QVHighlights moment-retrieval eval end to end
(features -> forward -> decode -> submission rows -> NMS -> metrics), with
every attention core on one hand-written CUDA kernel (csrc/aca_attention.cu).
The package imports torch and numpy only; the kernel library is built and
loaded at its first CUDA launch.
"""

from flashvtg_tpu_torch.entry import entry

__all__ = ["entry"]
