"""Build and load the port's CUDA kernels (nvcc + ctypes, plain C interface).

Each source under csrc/ is compiled by nvcc for sm_90a into its own shared
library, at first use, into `_build/` beside this file (listed in
.gitignore). The library name carries a hash of the source, the headers of
csrc/ and the flags, so an edited source or header is rebuilt and a stale
library is never loaded.
`build_all()` starts one nvcc per source, all at once, and waits for them.
Every kernel with a product is a template on its product form (ops/forms.py,
csrc/attn_common.cuh), so a library holds each kernel three times, and
every attention C entry takes the form as an int before its stream (the
LayerNorm kernels of layer_norm.cu have no product and no form). The SASS helpers
below read which tensor-core instruction each instance holds (mma.sync's
HMMA, wgmma's HGMMA).
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
from typing import Dict, Iterable, List

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
    "layer_norm": "layer_norm.cu",
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


_HMMA_KIND = re.compile(r"\bHG?MMA(?:\.\w+)*")


def sass_mma_kinds(name: str) -> Dict[str, Dict[str, int]]:
    """{kernel function: {tensor-core instruction: SASS lines}} in the built
    library of `name`, from cuobjdump --dump-sass; an instruction is its
    opcode with its modifiers, which name the shape and the operand type:
    HMMA.1688.F32.TF32 is mma.sync.m16n8k8 on tf32, HMMA.16816.F32.BF16
    m16n8k16 on bf16, HGMMA.64x32x16.F32.BF16 the warpgroup product
    wgmma.m64n32k16 on bf16."""
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    tool = shutil.which("cuobjdump") or os.path.join(cuda_home, "bin", "cuobjdump")
    sass = subprocess.run([tool, "--dump-sass", library_path(name)], capture_output=True,
                          text=True, check=True).stdout
    kinds: Dict[str, Dict[str, int]] = {}
    fn = None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            kinds[fn] = {}
        elif fn is not None:
            m = _HMMA_KIND.search(line)
            if m:
                kinds[fn][m.group(0)] = kinds[fn].get(m.group(0), 0) + 1
    return kinds


def sass_mma_counts(name: str) -> Dict[str, int]:
    """{kernel function: its tensor-core instructions (SASS lines naming
    HMMA or HGMMA)} in the built library of `name`."""
    return {fn: sum(per.values()) for fn, per in sass_mma_kinds(name).items()}


_FORM_OF = re.compile(r"\d+([a-z_]+_kernel)ILi(\d)E")


def _by_form(per_function: Dict, empty, add) -> Dict[str, Dict]:
    """{kernel: {form: add(...) of its instances' values}}: the form is the
    first template argument of every kernel with a product (its mangled
    name's `ILi<form>E`); kernels without one (no product) are left out."""
    from flashvtg_tpu_torch.ops.forms import FORMS

    out: Dict[str, Dict] = {}
    for fn, value in per_function.items():
        m = _FORM_OF.search(fn)
        if m:
            per = out.setdefault(m.group(1), {f: empty() for f in FORMS})
            form = FORMS[int(m.group(2))]
            per[form] = add(per[form], value)
    return out


def mma_kinds_by_form(kinds: Dict[str, Dict[str, int]]) -> Dict[str, Dict[str, Dict[str, int]]]:
    """{kernel: {form: {instruction: SASS lines over its instances}}} of
    sass_mma_kinds' result."""
    return _by_form(kinds, dict, lambda acc, per: {
        k: acc.get(k, 0) + per.get(k, 0) for k in {**acc, **per}})


# the SASS of mma.sync.m16n8k8 on tf32 and of m16n8k16 on bf16; of wgmma
# on bf16 with f32 sums, any m64nNk16 shape (HGMMA.64x32x16.F32.BF16)
TF32_MMA, BF16_MMA = "HMMA.1688.F32.TF32", "HMMA.16816.F32.BF16"
BF16_WGMMA = "HGMMA.64xNx16.F32.BF16"
_BF16_WGMMA = re.compile(r"HGMMA\.64x\d+x16\.F32\.BF16")


def mma_kind_faults(by_form: Dict[str, Dict[str, Dict[str, int]]],
                    bf16_kernels: Iterable[str],
                    wgmma_kernels: Iterable[str] = ()) -> List[str]:
    """The instances of mma_kinds_by_form's result that break the rule of
    the product forms' instructions: the bf16 instances of `wgmma_kernels`
    on BF16_WGMMA (wgmma on bf16, any N) alone, those of `bf16_kernels` on
    BF16_MMA alone, every other instance on TF32_MMA alone. One line a
    fault, naming the kernel, the form and what its SASS holds; a kernel
    of either list missing from `by_form` is a fault too. Empty when the
    rule holds."""
    bf16_kernels, wgmma_kernels = tuple(bf16_kernels), tuple(wgmma_kernels)
    faults = [f"{fn}: no such kernel with a product form" for fn in bf16_kernels + wgmma_kernels
              if fn not in by_form]
    for fn, per in by_form.items():
        for form, found in per.items():
            if form == "bf16" and fn in wgmma_kernels:
                ok = bool(found) and all(_BF16_WGMMA.fullmatch(k) for k in found)
                want = BF16_WGMMA
            else:
                want = BF16_MMA if form == "bf16" and fn in bf16_kernels else TF32_MMA
                ok = list(found) == [want]
            if not ok:
                faults.append(f"{fn} {form}: {found}, want {want} alone")
    return faults


def hmma_by_form(counts: Dict[str, int]) -> Dict[str, Dict[str, int]]:
    """{kernel: {form: tensor-core instructions over its instances}} of
    sass_mma_counts' result."""
    return _by_form(counts, int, lambda acc, n: acc + n)


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
            "flashvtg_aca_attention_train_f32": [p] * 10 + [i] * 6 + train,
        },
        "aca_attention_bwd": {
            "flashvtg_aca_attention_bwd_f32": [p] * 14 + [i] * 7 + train,
        },
        "flash_attention": {
            # k, v, their bf16 copies, batch, len, heads, stream
            "flashvtg_flash_attention_stage_bf16": [p] * 4 + [i] * 3 + [p],
            # ... out (lse), then the bf16 form's copies of k and v
            "flashvtg_flash_attention_f32": [p] * 7 + [i] * 4 + [f, i, p],
            "flashvtg_flash_attention_train_f32": [p] * 8 + [i] * 4 + train,
        },
        "flash_attention_bwd": {
            # ... dq, dk, dv, then the bf16 form's five bf16 copies, stage_kv
            "flashvtg_flash_attention_bwd_f32": [p] * 16 + [i] * 5 + train,
        },
        "layer_norm": {
            # x, gamma, beta, y, stats, rows, d, x_bf16, eps, stream
            "flashvtg_layer_norm_fwd": [p] * 5 + [i] * 3 + [f, p],
            # rows, d, x_bf16
            "flashvtg_layer_norm_bwd_blocks": [i] * 3,
            # x, dy, stats, gamma, dx, part, dgamma, dbeta, rows, d, x_bf16,
            # blocks, stream
            "flashvtg_layer_norm_bwd": [p] * 8 + [i] * 4 + [p],
        },
    }
    for fn_name, argtypes in signatures[name].items():
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = i
