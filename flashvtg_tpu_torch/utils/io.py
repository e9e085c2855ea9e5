"""Small JSON/JSONL IO helpers (counterpart of flashvtg_tpu/utils/io.py)."""

from __future__ import annotations

import json
from typing import Any, Iterable, List

import numpy as np


def load_jsonl(path) -> List[Any]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def save_jsonl(rows: Iterable[Any], path) -> None:
    with open(path, "w") as f:
        f.write("\n".join(json.dumps(r) for r in rows))


def l2_normalize(arr: np.ndarray, eps: float = 1e-5) -> np.ndarray:
    """Row-wise l2 normalization (reference basic_utils.l2_normalize_np_array)."""
    return arr / (np.linalg.norm(arr, axis=-1, keepdims=True) + eps)
