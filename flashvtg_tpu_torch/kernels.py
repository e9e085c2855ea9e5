"""Build and load the port's CUDA kernels (nvcc + ctypes, plain C interface).

Each source under csrc/ is compiled by nvcc for sm_90a into its own shared
library, at first use, into `_build/` beside this file (listed in
.gitignore). The library name carries a hash of the source, the headers of
csrc/ and the flags, so an edited source or header is rebuilt and a stale
library is never loaded.
`build_all()` starts one nvcc per source, all at once, and waits for them.
Every kernel with a product is a template on its product form (ops/forms.py,
csrc/attn_common.cuh), so a library holds each kernel three times, and
every C entry takes the form as an int before its stream.
Nothing here runs at import: the tests import every module on machines
without nvcc or a card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from typing import Dict

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
SOURCES = {
    "aca_attention": "aca_attention.cu",
    "aca_attention_bwd": "aca_attention_bwd.cu",
    "flash_attention": "flash_attention.cu",
    "flash_attention_bwd": "flash_attention_bwd.cu",
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    found = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(found):
        raise RuntimeError(
            "nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels are "
            "built from flashvtg_tpu_torch/csrc at first use"
        )
    return found


def library_path(name: str) -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for src in [SOURCES[name], *headers]:
        with open(os.path.join(CSRC, src), "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:16]}.so")


def build_all() -> Dict[str, str]:
    """Compile every source whose library is missing, one nvcc each, all in
    parallel. Returns {name: ptxas report}; raises on any failed build."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name, src in SOURCES.items():
        out = library_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, src)]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, out)
    reports = {}
    for name, (proc, tmp, out) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {SOURCES[name]}:\n{log}")
        os.replace(tmp, out)
        with open(out + ".log", "w") as f:
            f.write(log)
        reports[name] = log
    for name in SOURCES:
        if name not in reports:
            log_path = library_path(name) + ".log"
            reports[name] = open(log_path).read() if os.path.exists(log_path) else ""
    return reports


def sass_mma_counts(name: str) -> Dict[str, int]:
    """{kernel function: its tensor-core instructions (SASS lines naming
    HMMA)} in the built library of `name`, from cuobjdump --dump-sass."""
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    tool = shutil.which("cuobjdump") or os.path.join(cuda_home, "bin", "cuobjdump")
    sass = subprocess.run([tool, "--dump-sass", library_path(name)], capture_output=True,
                          text=True, check=True).stdout
    counts: Dict[str, int] = {}
    fn = None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            counts[fn] = 0
        elif fn is not None and "HMMA" in line:
            counts[fn] += 1
    return counts


_FORM_OF = re.compile(r"\d+([a-z_]+_kernel)ILi(\d)E")


def hmma_by_form(counts: Dict[str, int]) -> Dict[str, Dict[str, int]]:
    """{kernel: {form: tensor-core instructions over its instances}} of
    sass_mma_counts' result: the form is the first template argument of
    every kernel with a product (its mangled name's `ILi<form>E`); kernels
    without one (no product) are left out."""
    from flashvtg_tpu_torch.ops.forms import FORMS

    out: Dict[str, Dict[str, int]] = {}
    for fn, n in counts.items():
        m = _FORM_OF.search(fn)
        if m:
            per = out.setdefault(m.group(1), dict.fromkeys(FORMS, 0))
            per[FORMS[int(m.group(2))]] += n
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `name`, built first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            if not os.path.exists(library_path(name)):
                build_all()
            lib = ctypes.CDLL(library_path(name))
            _bind(name, lib)
            _libs[name] = lib
    return _libs[name]


def _bind(name: str, lib: ctypes.CDLL) -> None:
    p, i, f, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint
    # scale, seed (a pointer to a uint32 in device memory), dropout
    # threshold, keep scale, form, stream
    train = [f, p, u, f, i, p]
    signatures = {
        "aca_attention": {
            "flashvtg_aca_attention_f32": [p] * 6 + [i] * 6 + [f, i, p],
            "flashvtg_aca_attention_train_f32": [p] * 9 + [i] * 6 + train,
        },
        "aca_attention_bwd": {
            "flashvtg_aca_attention_bwd_f32": [p] * 13 + [i] * 7 + train,
        },
        "flash_attention": {
            "flashvtg_flash_attention_f32": [p] * 5 + [i] * 4 + [f, i, p],
            "flashvtg_flash_attention_train_f32": [p] * 6 + [i] * 4 + train,
        },
        "flash_attention_bwd": {
            "flashvtg_flash_attention_bwd_f32": [p] * 11 + [i] * 4 + train,
        },
    }
    for fn_name, argtypes in signatures[name].items():
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = i
