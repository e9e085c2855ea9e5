"""The port's native host runtime: the C++ feature loader and metric kernels.

Counterpart of flashvtg_tpu/runtime/__init__.py, with its own copies of the
two sources (same C ABI and semantics):

  * `load_features(path, key, max_rows, l2norm)` reads a .npy / .npz
    feature file through featload.cpp's `fl_load`, truncation and the row
    l2-norm (x / (||x|| + 1e-5)) fused, with no Python zip / npy machinery.
    It returns None for what `fl_load` declines (.pt files, dtypes other
    than little-endian f4 / f8, ranks other than 1 / 2, a missing member):
    the caller then reads the file with numpy (data/dataset.py:_try_paths).
    ctypes releases the GIL during the call, so a thread pool loads in
    parallel (data/feed.py:build_device_feed).
  * `mr_ap_batch(...)` is the batched greedy-matching detection AP of
    mr_ap.cpp, bit-identical to eval/metrics.py:detection_ap on every
    query it handles; it declines G == 0, G > 15 and P > 126 (an
    interpolation grid above 128 terms), which eval/metrics.py scores with
    detection_ap.
  * `hl_ap_batch(...)` is the batched binary ranking AP, bit-identical to
    eval/metrics.py:binary_ap_columns.

Each source is compiled by g++ at first use into `_build/` beside the
package (listed in .gitignore), under a name that carries a hash of the
source and the flags, so an edited source is rebuilt and a stale library is
never loaded; `build()` compiles every missing library, one g++ each, all
at once. A build writes a temporary file and renames it, so processes that
build at once never load a partial library. Nothing hides the library: a
missing compiler or zlib, or a failed build, raises RuntimeError with the
compiler's log. Nothing here builds at import.

`COUNTS` holds, per entry point, the rows the native code handled and the
rows it declined (`reset_counts()`, `counts()`), as kernels.py counts
launches: the tests and chip_smoke.py read them to see that the native path
ran.
"""

from __future__ import annotations

import copy
import ctypes
import hashlib
import os
import subprocess
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
CXX = "g++"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")
# name: (source, link flags)
SOURCES = {
    "featload": ("featload.cpp", ("-lz",)),
    "mrap": ("mr_ap.cpp", ()),
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}

_count_lock = threading.Lock()
COUNTS = {entry: {"native": 0, "declined": 0}
          for entry in ("load_features", "mr_ap_batch", "hl_ap_batch")}


def reset_counts() -> None:
    with _count_lock:
        for per in COUNTS.values():
            per["native"] = per["declined"] = 0


def counts() -> Dict[str, Dict[str, int]]:
    """{entry point: {"native": rows handled, "declined": rows declined}}."""
    with _count_lock:
        return copy.deepcopy(COUNTS)


def _count(entry: str, native: int, declined: int) -> None:
    with _count_lock:
        COUNTS[entry]["native"] += native
        COUNTS[entry]["declined"] += declined


def library_path(name: str) -> str:
    src, link = SOURCES[name]
    digest = hashlib.sha256(" ".join((CXX, *CXX_FLAGS, *link)).encode())
    with open(os.path.join(_HERE, src), "rb") as f:
        digest.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:16]}.so")


def compiler_version() -> str:
    """The first line of `CXX --version`."""
    return subprocess.run([CXX, "--version"], capture_output=True, text=True,
                          check=True).stdout.splitlines()[0]


def build() -> Dict[str, float]:
    """Compile every library that is missing, one g++ each, all at once.
    Returns {name: seconds of its build} for those built; raises
    RuntimeError with the compiler's log when a build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name, (src, link) in SOURCES.items():
        out = library_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [CXX, *CXX_FLAGS, "-o", tmp, os.path.join(_HERE, src), *link]
        try:
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
        except OSError as e:
            raise RuntimeError(
                f"cannot run the C++ compiler {CXX!r} ({e}): the host runtime is "
                f"built from flashvtg_tpu_torch/runtime/{src} at first use") from e
        procs[name] = (proc, tmp, out, time.perf_counter())
    seconds = {}
    for name, (proc, tmp, out, t0) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"{CXX} failed for {SOURCES[name][0]}:\n{log}")
        os.replace(tmp, out)
        seconds[name] = time.perf_counter() - t0
    return seconds


def _bind(name: str, lib: ctypes.CDLL) -> None:
    dp = ctypes.POINTER(ctypes.c_double)
    lp = ctypes.POINTER(ctypes.c_long)
    if name == "featload":
        lib.fl_load.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_long,
                                ctypes.c_int, lp, lp]
        lib.fl_load.restype = ctypes.POINTER(ctypes.c_float)
        lib.fl_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
        lib.fl_free.restype = None
    else:
        lib.mr_ap_batch.argtypes = [dp, lp, dp, lp, ctypes.c_long, dp, ctypes.c_long,
                                    dp, ctypes.POINTER(ctypes.c_ubyte)]
        lib.mr_ap_batch.restype = ctypes.c_long
        lib.hl_ap_batch.argtypes = [dp, lp, dp, ctypes.c_long, ctypes.c_long, dp]
        lib.hl_ap_batch.restype = ctypes.c_long


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `name`, built first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            if not os.path.exists(library_path(name)):
                build()
            lib = ctypes.CDLL(library_path(name))
            _bind(name, lib)
            _libs[name] = lib
    return _libs[name]


def load_features(path: str, key: str = "features", max_rows: int = 0,
                  l2norm: bool = False) -> Optional[np.ndarray]:
    """(rows, cols) float32 features of a .npy / .npz file (a rank-1 array
    is one row), cut to `max_rows` rows (0: all) and row-l2-normalised on
    request; None when `fl_load` declines the file."""
    if path.endswith(".pt"):
        _count("load_features", 0, 1)
        return None
    lib = load("featload")
    rows, cols = ctypes.c_long(), ctypes.c_long()
    ptr = lib.fl_load(path.encode(), key.encode(), max_rows, int(l2norm),
                      ctypes.byref(rows), ctypes.byref(cols))
    if not ptr:
        _count("load_features", 0, 1)
        return None
    try:
        out = np.ctypeslib.as_array(ptr, shape=(rows.value, cols.value)).copy()
    finally:
        lib.fl_free(ptr)
    _count("load_features", 1, 0)
    return out


def l2norm_replica(rows: np.ndarray) -> np.ndarray:
    """numpy replica of fl_load's fused row l2-norm, bit for bit: the sum
    of squares in float64 in row order, its square root rounded to float32,
    plus 1e-5 and the reciprocal in float32, each value times it. (The
    plain data/dataset.py path, utils/io.py:l2_normalize, divides by a
    float32 norm instead: a few ulps apart.)"""
    rows = np.asarray(rows, np.float32)
    if not rows.size:
        return rows.copy()
    sq = rows.astype(np.float64) ** 2
    norm = np.sqrt(np.cumsum(sq, axis=-1)[..., -1:]).astype(np.float32)
    inv = np.float32(1.0) / (norm + np.float32(1e-5))
    return rows * inv


def _as_pointer(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def mr_ap_batch(preds_list: Sequence, gts_list: Sequence, thresholds: Sequence[float]):
    """Batched detection AP. preds_list: per query a (P_i, >= 3) array of
    [start, end, score, ...] rows; gts_list: per query a (G_i, 2) array.
    Returns (ap (n, n_thds) float64, handled (n,) bool): the rows with
    handled False are left at 0 for detection_ap to compute."""
    if len(preds_list) != len(gts_list):
        raise ValueError(f"mr_ap_batch: {len(preds_list)} prediction sets for "
                         f"{len(gts_list)} ground-truth sets")
    lib = load("mrap")
    n = len(preds_list)
    pred_off = np.zeros(n + 1, np.int64)
    gt_off = np.zeros(n + 1, np.int64)
    pred_arrs: List[np.ndarray] = []
    gt_arrs: List[np.ndarray] = []
    for i, (p, g) in enumerate(zip(preds_list, gts_list)):
        a = np.asarray(p, np.float64)
        if a.size and (a.ndim != 2 or a.shape[1] < 3):
            raise ValueError(
                "mr_ap_batch: prediction rows must be [start, end, score, ...] "
                f"with >= 3 columns, got shape {a.shape}")
        pred_arrs.append(a.reshape(-1, a.shape[1] if a.size else 3)[:, :3])
        gt_arrs.append(np.asarray(g, np.float64).reshape(-1, 2))
        pred_off[i + 1] = pred_off[i] + len(pred_arrs[-1])
        gt_off[i + 1] = gt_off[i] + len(gt_arrs[-1])
    preds = np.ascontiguousarray(np.concatenate(pred_arrs) if pred_off[-1]
                                 else np.zeros((0, 3)))
    gts = np.ascontiguousarray(np.concatenate(gt_arrs) if gt_off[-1] else np.zeros((0, 2)))
    thds = np.ascontiguousarray(thresholds, np.float64)
    out = np.zeros((n, len(thds)), np.float64)
    handled = np.zeros(n, np.uint8)
    dp = ctypes.c_double
    lib.mr_ap_batch(_as_pointer(preds, dp), _as_pointer(pred_off, ctypes.c_long),
                    _as_pointer(gts, dp), _as_pointer(gt_off, ctypes.c_long), n,
                    _as_pointer(thds, dp), len(thds), _as_pointer(out, dp),
                    _as_pointer(handled, ctypes.c_ubyte))
    handled = handled.astype(bool)
    _count("mr_ap_batch", int(handled.sum()), int(n - handled.sum()))
    return out, handled


def hl_ap_batch(scores_list: Sequence, labels_list: Sequence) -> np.ndarray:
    """Batched binary ranking AP: per query one (n_i,) score vector and a
    (K, n_i) label matrix, K the same for every query. Returns (n, K) AP,
    bit-identical to binary_ap_columns of each query."""
    if not len(scores_list) or len(scores_list) != len(labels_list):
        raise ValueError(f"hl_ap_batch: {len(scores_list)} score vectors and "
                         f"{len(labels_list)} label matrices")
    lib = load("mrap")
    n = len(scores_list)
    k = int(np.asarray(labels_list[0]).shape[0])
    off = np.zeros(n + 1, np.int64)
    scores, labels = [], []
    for i, (s, m) in enumerate(zip(scores_list, labels_list)):
        s = np.asarray(s, np.float64).reshape(-1)
        m = np.asarray(m, np.float64)
        if m.shape != (k, len(s)):
            raise ValueError(f"hl_ap_batch: query {i} has {len(s)} scores and labels of "
                             f"shape {m.shape}, expected ({k}, {len(s)})")
        scores.append(s)
        labels.append(m.ravel())
        off[i + 1] = off[i] + len(s)
    scores_c = np.ascontiguousarray(np.concatenate(scores))
    labels_c = np.ascontiguousarray(np.concatenate(labels))
    out = np.zeros((n, k), np.float64)
    dp = ctypes.c_double
    lib.hl_ap_batch(_as_pointer(scores_c, dp), _as_pointer(off, ctypes.c_long),
                    _as_pointer(labels_c, dp), n, k, _as_pointer(out, dp))
    _count("hl_ap_batch", n, 0)
    return out
