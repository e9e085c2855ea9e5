"""flashvtg_tpu_torch: the PyTorch + CUDA port of flashvtg_tpu for one NVIDIA
H100.

It runs moment-retrieval eval end to end (features -> forward -> decode ->
submission rows -> NMS -> metrics) and the train step (train forward with
the negative pass, the criterion, backward, clipped AdamW; train/loop.py)
for the flagship QVHighlights preset and for the long-video TACoS preset
(2048 clips). Every attention core runs on hand-written CUDA kernels,
forward and backward: csrc/aca_attention.cu and csrc/aca_attention_bwd.cu
for the ACA layers and for self-attention over up to 128 keys,
csrc/flash_attention.cu and csrc/flash_attention_bwd.cu (memory-linear)
beyond. The package imports torch and numpy only; the kernel libraries are
built and loaded at their first CUDA launch.
"""

from flashvtg_tpu_torch.entry import entry

__all__ = ["entry"]
