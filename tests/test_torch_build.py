"""The build helpers of flashvtg_tpu_torch/kernels.py, on the CPU (neither
nvcc nor a card is needed): a library's name follows its source, every
header of csrc/ and the nvcc flags, so an edit is rebuilt and a stale
library never loads; the tensor-core count is taken per kernel function
from cuobjdump's SASS; a missing nvcc is reported by name."""

import shutil
import subprocess

import pytest

from flashvtg_tpu_torch import kernels


def test_library_path_follows_source_headers_and_flags(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(kernels.CSRC, csrc)
    monkeypatch.setattr(kernels, "CSRC", str(csrc))
    base = {name: kernels.library_path(name) for name in kernels.SOURCES}
    assert len(set(base.values())) == len(kernels.SOURCES)
    assert {name: kernels.library_path(name) for name in kernels.SOURCES} == base
    # a header edit rebuilds every source, a source edit only its own
    header = csrc / "attn_common.cuh"
    header.write_text(header.read_text() + "\n")
    after = {name: kernels.library_path(name) for name in kernels.SOURCES}
    assert all(after[name] != base[name] for name in kernels.SOURCES)
    src = csrc / kernels.SOURCES["flash_attention"]
    src.write_text(src.read_text() + "\n")
    assert kernels.library_path("flash_attention") != after["flash_attention"]
    assert kernels.library_path("aca_attention") == after["aca_attention"]
    monkeypatch.setattr(kernels, "NVCC_FLAGS", kernels.NVCC_FLAGS + ("-lineinfo",))
    assert kernels.library_path("aca_attention") != after["aca_attention"]


def test_sass_mma_counts_per_kernel_function(monkeypatch):
    sass = "\n".join([
        "\tcode for sm_90a",
        "\t\tFunction : _Z6kernelILb1EEvPf",
        "        /*0100*/                   HMMA.1688.F32.TF32 R4, R8, R12, R4 ;",
        "        /*0110*/                   FFMA R1, R2, R3, R1 ;",
        "        /*0120*/                   HMMA.1688.F32.TF32 R16, R8, R14, R16 ;",
        "\t\tFunction : _Z7prepassPf",
        "        /*0100*/                   FFMA R1, R2, R3, R1 ;",
    ])

    def fake_run(cmd, **kwargs):
        assert "--dump-sass" in cmd and cmd[-1] == kernels.library_path("flash_attention")
        return subprocess.CompletedProcess(cmd, 0, stdout=sass, stderr="")

    monkeypatch.setattr(kernels.subprocess, "run", fake_run)
    assert kernels.sass_mma_counts("flash_attention") == {
        "_Z6kernelILb1EEvPf": 2, "_Z7prepassPf": 0}


def test_missing_nvcc_is_named(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels._nvcc()
