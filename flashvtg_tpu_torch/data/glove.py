"""GloVe word embeddings for the Charades-STA VGG configuration.

The port's copy of flashvtg_tpu/data/glove.py. The reference pulls
glove.6B.300d through torchtext (start_end_dataset.py:133-139, 226-229);
the embedder takes, in this order:
  * a plain-text GloVe file (`glove.6B.300d.txt`) named by
    FLASHVTG_GLOVE_PATH, or the (vocab.txt, vectors.npy) pair cached next
    to it by an earlier load;
  * torchtext's cache, if that package is installed (an optional import).

Out-of-vocabulary tokens map to a zero vector, as the reference's `<unk>`
row of zeros.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np


class GloveEmbedder:
    def __init__(self, stoi: Dict[str, int], vectors: np.ndarray):
        self.stoi = stoi
        self.vectors = vectors
        self.dim = vectors.shape[1]

    @classmethod
    def default(cls) -> "GloveEmbedder":
        path = os.environ.get("FLASHVTG_GLOVE_PATH")
        if path and os.path.exists(path):
            return cls.from_text_file(path)
        try:
            from torchtext import vocab as tt_vocab

            gv = tt_vocab.pretrained_aliases["glove.6B.300d"]()
            return cls(dict(gv.stoi), gv.vectors.numpy())
        except Exception as e:
            raise RuntimeError(
                "GloVe vectors unavailable: set FLASHVTG_GLOVE_PATH to a "
                "glove.6B.300d.txt file or install torchtext"
            ) from e

    @classmethod
    def from_text_file(cls, path: str) -> "GloveEmbedder":
        npy = path + ".vectors.npy"
        vocab_file = path + ".vocab.txt"
        if os.path.exists(npy) and os.path.exists(vocab_file):
            with open(vocab_file) as f:
                stoi = {w.rstrip("\n"): i for i, w in enumerate(f)}
            return cls(stoi, np.load(npy))
        stoi, rows = {}, []
        with open(path, encoding="utf-8") as f:
            for line in f:
                parts = line.rstrip().split(" ")
                stoi[parts[0]] = len(rows)
                rows.append(np.asarray(parts[1:], dtype=np.float32))
        vectors = np.stack(rows)
        # cache the pair for the next load, written to temporary names and
        # renamed, so a concurrent reader never sees half of it
        try:
            tmp = f".{os.getpid()}.tmp"
            np.save(npy + tmp, vectors)
            with open(vocab_file + tmp, "w") as f:
                f.write("\n".join(stoi))
            os.replace(npy + tmp + ".npy", npy)  # np.save appends .npy
            os.replace(vocab_file + tmp, vocab_file)
        except OSError:
            pass
        return cls(stoi, vectors)

    def __call__(self, query: str) -> np.ndarray:
        idx = [self.stoi.get(w.lower(), -1) for w in query.split()]
        out = np.zeros((len(idx), self.dim), np.float32)
        for i, j in enumerate(idx):
            if j >= 0:
                out[i] = self.vectors[j]
        return out
