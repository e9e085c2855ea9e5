"""flashvtg_tpu_torch: the PyTorch + CUDA port of flashvtg_tpu for one NVIDIA
H100.

It runs moment-retrieval eval end to end (features -> forward -> decode ->
submission rows -> NMS -> metrics), highlight detection, and training
(train forward with the negative pass, the criterion, backward, clipped
AdamW; the loop with per-epoch eval, best model, early stop, checkpoints
and resume; train/loop.py) for every preset, the phrase-aware FlashVTG_ms
variant included (models/flashvtg_ms.py, models/lgi.py), through
`python -m flashvtg_tpu_torch.cli train | infer | export` (cli.py).
Training and inference run data-parallel across processes under torchrun
(parallel/mesh.py: one process a card, the JAX mesh's global-batch
semantics), and tools/visualize.py plots predictions and the model's
attention maps. Checkpoints are reference-format `.ckpt` files. Every
attention core of the trunk runs on hand-written CUDA kernels, forward and
backward (the _ms variant's LGI attention is plain PyTorch):
csrc/aca_attention.cu and csrc/aca_attention_bwd.cu for the ACA layers and
for self-attention over up to 128 keys, csrc/flash_attention.cu and
csrc/flash_attention_bwd.cu (memory-linear) beyond. The package imports
torch and numpy only; the kernel libraries are built and loaded at their
first CUDA launch.
"""

from flashvtg_tpu_torch.entry import entry

__all__ = ["entry"]
