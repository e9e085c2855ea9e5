"""The build helpers of flashvtg_tpu_torch/kernels.py, on the CPU (neither
nvcc nor a card is needed): a library's name follows its source, every
header of csrc/ and the nvcc flags, so an edit is rebuilt and a stale
library never loads; the tensor-core count is taken per kernel function
from cuobjdump's SASS, by instruction (bf16 m16n8k16 apart from tf32
m16n8k8), and summed per product form; a missing nvcc is
reported by name; the rule of each form's instruction
(kernels.mma_kind_faults) names the instances that break it; the ACA
backward's row chunks and workspace (ops/aca.py:bwd_tiling, the formula
csrc/aca_attention_bwd.cu repeats) cover every query row once."""

import shutil
import subprocess

import pytest
import torch_threads  # noqa: F401  (torch's share of the cores under xdist)

from flashvtg_tpu_torch import kernels
from flashvtg_tpu_torch.ops import aca


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


FAKE_SASS_KINDS = "\n".join([
    "\tcode for sm_90a",
    "\t\tFunction : _ZN12_GLOBAL__N_119flash_bwd_dq_kernelILi2EEEvNS_8OperandsE",
    "        /*0100*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;",
    "        /*0110*/                   LDSM.16.MT88.4 R12, [R2] ;",
    "        /*0120*/               @P0 HMMA.16816.F32.BF16 R16, R8, R14, R16 ;",
    "\t\tFunction : _ZN12_GLOBAL__N_119flash_bwd_dq_kernelILi0EEEvNS_8OperandsE",
    "        /*0100*/                   HMMA.1688.F32.TF32 R4, R8, R12, R4 ;",
    "        /*0110*/                   HMMA.1688.F32.TF32 R4, R8, R14, R4 ;",
    "        /*0120*/                   HMMA.1688.F32.TF32 R4, R8, R16, R4 ;",
    "\t\tFunction : _ZN12_GLOBAL__N_119flash_bwd_dq_kernelILi1EEEvNS_8OperandsE",
    "        /*0100*/                   HMMA.1688.F32.TF32 R4, R8, R12, R4 ;",
    "\t\tFunction : _ZN12_GLOBAL__N_122flash_bwd_delta_kernelEPKfS1_Pfiii",
    "        /*0100*/                   FFMA R1, R2, R3, R1 ;",
])


def _fake_cuobjdump(monkeypatch, sass):
    def fake_run(cmd, **kwargs):
        assert "--dump-sass" in cmd
        return subprocess.CompletedProcess(cmd, 0, stdout=sass, stderr="")

    monkeypatch.setattr(kernels.subprocess, "run", fake_run)


def test_sass_mma_kinds_tell_the_bf16_instruction_from_the_tf32_one(monkeypatch):
    """Each kernel function's tensor-core lines by instruction, its opcode
    with the modifiers that name shape and operand type (a predicate is no
    part of it): the bf16 m16n8k16 apart from the tf32 m16n8k8; the total
    is sass_mma_counts'."""
    _fake_cuobjdump(monkeypatch, FAKE_SASS_KINDS)
    kinds = kernels.sass_mma_kinds("flash_attention_bwd")
    assert kinds == {
        "_ZN12_GLOBAL__N_119flash_bwd_dq_kernelILi2EEEvNS_8OperandsE": {"HMMA.16816.F32.BF16": 2},
        "_ZN12_GLOBAL__N_119flash_bwd_dq_kernelILi0EEEvNS_8OperandsE": {"HMMA.1688.F32.TF32": 3},
        "_ZN12_GLOBAL__N_119flash_bwd_dq_kernelILi1EEEvNS_8OperandsE": {"HMMA.1688.F32.TF32": 1},
        "_ZN12_GLOBAL__N_122flash_bwd_delta_kernelEPKfS1_Pfiii": {},
    }
    assert kernels.sass_mma_counts("flash_attention_bwd") == {
        fn: sum(per.values()) for fn, per in kinds.items()}


def test_mma_kinds_by_form_reads_each_instances_instruction(monkeypatch):
    """Per kernel and form, the instructions of its instances: what
    chip_smoke.py's build phase holds (the flash kernels' bf16 instances
    on HMMA.16816.F32.BF16 alone, every other on HMMA.1688.F32.TF32
    alone, kernels.mma_kind_faults); a kernel without a form is left out."""
    _fake_cuobjdump(monkeypatch, FAKE_SASS_KINDS)
    by_form = kernels.mma_kinds_by_form(kernels.sass_mma_kinds("flash_attention_bwd"))
    assert by_form == {"flash_bwd_dq_kernel": {
        "3xtf32": {"HMMA.1688.F32.TF32": 3},
        "1xtf32": {"HMMA.1688.F32.TF32": 1},
        "bf16": {"HMMA.16816.F32.BF16": 2},
    }}
    mixed = {"_ZN12_GLOBAL__N_121flash_bwd_dkdv_kernelILi2EEEvNS_8OperandsE":
             {"HMMA.16816.F32.BF16": 4, "HMMA.1688.F32.TF32": 1}}
    assert kernels.mma_kinds_by_form(mixed)["flash_bwd_dkdv_kernel"]["bf16"] == {
        "HMMA.16816.F32.BF16": 4, "HMMA.1688.F32.TF32": 1}


FAKE_SASS_FLASH = "\n".join([
    "\tcode for sm_90a",
    *(f"\t\tFunction : _ZN51_GLOBAL__N__e895d2d6_18_flash_attention_cu_bc10f23522flash_"
      f"attention_kernelILi{form}ELb{train}EEEvPKfS2_S2_S2_PfiifS3_jjf\n"
      f"        /*0100*/                   {instr} R4, R8, R12, R4 ;\n"
      f"        /*0110*/                   {instr} R16, R8, R14, R16 ;"
      for form, instr in ((0, "HMMA.1688.F32.TF32"), (1, "HMMA.1688.F32.TF32"),
                          (2, "HMMA.16816.F32.BF16"))
      for train in (0, 1)),
])


def _flash_kinds(monkeypatch):
    """mma_kinds_by_form of the forward's six instances (fake SASS) beside
    the backward's (FAKE_SASS_KINDS)."""
    _fake_cuobjdump(monkeypatch, FAKE_SASS_FLASH)
    by_form = kernels.mma_kinds_by_form(kernels.sass_mma_kinds("flash_attention"))
    _fake_cuobjdump(monkeypatch, FAKE_SASS_KINDS)
    by_form.update(kernels.mma_kinds_by_form(kernels.sass_mma_kinds("flash_attention_bwd")))
    return by_form


BF16_FLASH = ("flash_attention_kernel", "flash_bwd_dq_kernel")


def test_mma_kind_faults_accept_the_flash_kernels_on_the_bf16_instruction(monkeypatch):
    """chip_smoke.py's rule holds on the layout of the built libraries: the
    forward's eval and training instances and the backward's at bf16 on
    HMMA.16816.F32.BF16 alone, the 3xTF32 and 1xTF32 instances on
    HMMA.1688.F32.TF32 alone."""
    by_form = _flash_kinds(monkeypatch)
    assert by_form["flash_attention_kernel"] == {
        "3xtf32": {"HMMA.1688.F32.TF32": 4},
        "1xtf32": {"HMMA.1688.F32.TF32": 4},
        "bf16": {"HMMA.16816.F32.BF16": 4},
    }
    assert kernels.mma_kind_faults(by_form, BF16_FLASH) == []
    # the ACA kernels stay on the TF32 instruction at every form
    aca_kinds = {"aca_attention_kernel": {f: {kernels.TF32_MMA: 8} for f in by_form[
        "flash_attention_kernel"]}}
    assert kernels.mma_kind_faults({**by_form, **aca_kinds}, BF16_FLASH) == []


@pytest.mark.parametrize("bad", ["tf32", "mixed", "other_form", "missing"])
def test_mma_kind_faults_name_each_instance_that_breaks_the_rule(monkeypatch, bad):
    """A bf16 instance left on the TF32 instruction, one that mixes the two,
    a 3xTF32 instance on the bf16 one, and a kernel of the list that the
    SASS lacks: each is one fault naming the kernel and the form."""
    by_form = _flash_kinds(monkeypatch)
    fwd = by_form["flash_attention_kernel"]
    if bad == "tf32":
        fwd["bf16"] = {kernels.TF32_MMA: 64}
        want = "flash_attention_kernel bf16"
    elif bad == "mixed":
        fwd["bf16"] = {kernels.BF16_MMA: 60, kernels.TF32_MMA: 4}
        want = "flash_attention_kernel bf16"
    elif bad == "other_form":
        fwd["3xtf32"] = {kernels.BF16_MMA: 32}
        want = "flash_attention_kernel 3xtf32"
    else:
        del by_form["flash_attention_kernel"]
        want = "flash_attention_kernel: no such kernel"
    faults = kernels.mma_kind_faults(by_form, BF16_FLASH)
    assert len(faults) == 1 and faults[0].startswith(want), faults
    # a kernel off the list keeps its bf16 instance on the TF32 instruction
    if bad == "tf32":
        assert kernels.mma_kind_faults(by_form, ("flash_bwd_dq_kernel",)) == []


def test_hmma_by_form_sums_each_kernels_instances_per_form():
    """Every kernel with a product is a template whose first argument is its
    product form (ops/forms.py FORMS): the counts of its instances add up
    per form, and kernels without a form (no product) are left out."""
    counts = {
        "_ZN49_GLOBAL__N__200b3f44_16_aca_attention_cu_b480851a20aca_attention_kernelILi2ELi6"
        "ELb1ELb0EEEvPKfS2_S2_S2_PfS3_iiiiifNS_9TrainArgsE": 96,
        "_ZN49_GLOBAL__N__200b3f44_16_aca_attention_cu_b480851a20aca_attention_kernelILi2ELi8"
        "ELb0ELb1EEEvPKfS2_S2_S2_PfS3_iiiiifNS_9TrainArgsE": 128,
        "_ZN49_GLOBAL__N__200b3f44_16_aca_attention_cu_b480851a20aca_attention_kernelILi0ELi6"
        "ELb1ELb0EEEvPKfS2_S2_S2_PfS3_iiiiifNS_9TrainArgsE": 288,
        "_ZN51_GLOBAL__N__e895d2d6_18_flash_attention_cu_bc10f23522flash_attention_kernelILi1"
        "ELb1EEEvPKfS2_S2_S2_PfiifS3_jjf": 64,
        "_ZN12_GLOBAL__N_122flash_bwd_delta_kernelEPKfS1_Pfiii": 0,
    }
    assert kernels.hmma_by_form(counts) == {
        "aca_attention_kernel": {"3xtf32": 288, "1xtf32": 0, "bf16": 224},
        "flash_attention_kernel": {"3xtf32": 0, "1xtf32": 64, "bf16": 0},
    }


def test_missing_nvcc_is_named(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels._nvcc()


@pytest.mark.parametrize(
    "lv,lk",
    [(1, 1), (15, 7), (16, 8), (17, 9), (75, 42), (80, 75), (81, 75), (300, 75), (700, 42),
     (2047, 75), (2048, 75), (2048, 128), (4096, 128)],
)
def test_aca_backward_chunks_cover_every_row(lv, lk):
    tile_rows, chunks, chunk_rows = aca.bwd_tiling(lv, lk)
    # 16-row warp tiles, a warp per 16 keys at least, whole tiles a chunk
    assert tile_rows % 16 == 0 and tile_rows >= 16 * -(-lk // 16)
    assert chunk_rows % tile_rows == 0
    # every row in exactly one chunk, and no chunk empty (the kernel refuses one)
    assert (chunks - 1) * chunk_rows < lv <= chunks * chunk_rows
    rows = [c * chunk_rows + i for c in range(chunks) for i in range(chunk_rows)
            if c * chunk_rows + i < lv]
    assert rows == list(range(lv))
    # about BWD_CHUNK_ROWS rows a chunk: more chunks than tiles never
    assert chunk_rows <= max(tile_rows, aca.BWD_CHUNK_ROWS + tile_rows)
    shape = aca.bwd_workspace_shape(3, 8, lv, lk)
    if chunks == 1:  # one chunk writes dk and dv itself: no workspace, no second pass
        assert shape is None
    else:
        assert shape == (2, 3, 8, chunks, lk, aca.HEAD_DIM)
