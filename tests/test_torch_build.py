"""The build helpers of flashvtg_tpu_torch/kernels.py, on the CPU (neither
nvcc nor a card is needed): a library's name follows its source, every
header of csrc/ and the nvcc flags, so an edit is rebuilt and a stale
library never loads; the tensor-core count is taken per kernel function
from cuobjdump's SASS, by instruction (bf16 wgmma and bf16 m16n8k16 apart
from tf32 m16n8k8), and summed per product form; a missing nvcc is
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
        "\t\tFunction : _Z6wgmmaILi2EEvPf",
        "        /*0100*/                   HGMMA.64x32x16.F32.BF16 R24, gdesc[UR4], RZ, !UPT, gsb0 ;",
        "        /*0110*/                   UTMALDG.3D [UR8], [UR4] ;",
        "        /*0120*/                   HGMMA.64x32x16.F32.BF16 R24, R56, gdesc[UR8], R24, gsb0 ;",
        "        /*0130*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;",
    ])

    def fake_run(cmd, **kwargs):
        assert "--dump-sass" in cmd and cmd[-1] == kernels.library_path("flash_attention")
        return subprocess.CompletedProcess(cmd, 0, stdout=sass, stderr="")

    monkeypatch.setattr(kernels.subprocess, "run", fake_run)
    # wgmma's HGMMA lines count as tensor-core instructions beside HMMA's
    assert kernels.sass_mma_counts("flash_attention") == {
        "_Z6kernelILb1EEvPf": 2, "_Z7prepassPf": 0, "_Z6wgmmaILi2EEvPf": 3}


# the flash backward: the dq kernel's bf16 instance on wgmma (an A from
# shared memory, a predicated one with A from registers, a TMA copy), its
# 3xTF32 and 1xTF32 instances on m16n8k8; the dk/dv kernel's likewise; the
# D and staging pre-passes (no product)
FAKE_SASS_KINDS = "\n".join([
    "\tcode for sm_90a",
    "\t\tFunction : _ZN12_GLOBAL__N_119flash_bwd_dq_kernelILi2EEEvNS_8OperandsENS_8TileMapsE",
    "        /*0100*/                   HGMMA.64x32x16.F32.BF16 R24, gdesc[UR4], RZ, !UPT, gsb0 ;",
    "        /*0110*/                   UTMALDG.3D [UR8], [UR4] ;",
    "        /*0120*/               @P0 HGMMA.64x32x16.F32.BF16 R88, R56, gdesc[UR8], R88, gsb0 ;",
    "\t\tFunction : _ZN12_GLOBAL__N_119flash_bwd_dq_kernelILi0EEEvNS_8OperandsENS_8TileMapsE",
    "        /*0100*/                   HMMA.1688.F32.TF32 R4, R8, R12, R4 ;",
    "        /*0110*/                   HMMA.1688.F32.TF32 R4, R8, R14, R4 ;",
    "        /*0120*/                   HMMA.1688.F32.TF32 R4, R8, R16, R4 ;",
    "\t\tFunction : _ZN12_GLOBAL__N_119flash_bwd_dq_kernelILi1EEEvNS_8OperandsENS_8TileMapsE",
    "        /*0100*/                   HMMA.1688.F32.TF32 R4, R8, R12, R4 ;",
    *(f"\t\tFunction : _ZN12_GLOBAL__N_121flash_bwd_dkdv_kernelILi{form}EEEvNS_8OperandsENS_8"
      f"TileMapsE\n        /*0100*/                   {instr} R24, R8, R12, R24 ;"
      for form, instr in ((0, "HMMA.1688.F32.TF32"), (1, "HMMA.1688.F32.TF32"),
                          (2, "HGMMA.64x32x16.F32.BF16"))),
    "\t\tFunction : _ZN12_GLOBAL__N_122flash_bwd_delta_kernelEPKfS1_Pfiii",
    "        /*0100*/                   FFMA R1, R2, R3, R1 ;",
    "\t\tFunction : _ZN12_GLOBAL__N_122flash_bwd_stage_kernelENS_8OperandsEPKfNS_10StagedBF16Ei",
    "        /*0100*/                   F2FP.BF16.F32.PACK_AB R1, R2, R3 ;",
])


def _fake_cuobjdump(monkeypatch, sass):
    def fake_run(cmd, **kwargs):
        assert "--dump-sass" in cmd
        return subprocess.CompletedProcess(cmd, 0, stdout=sass, stderr="")

    monkeypatch.setattr(kernels.subprocess, "run", fake_run)


def test_sass_mma_kinds_tell_the_bf16_instruction_from_the_tf32_one(monkeypatch):
    """Each kernel function's tensor-core lines by instruction, its opcode
    with the modifiers that name shape and operand type (a predicate is no
    part of it): wgmma's HGMMA on bf16 apart from the tf32 m16n8k8; the
    total is sass_mma_counts'."""
    _fake_cuobjdump(monkeypatch, FAKE_SASS_KINDS)
    kinds = kernels.sass_mma_kinds("flash_attention_bwd")
    dq = "_ZN12_GLOBAL__N_119flash_bwd_dq_kernelILi{}EEEvNS_8OperandsENS_8TileMapsE"
    dkdv = "_ZN12_GLOBAL__N_121flash_bwd_dkdv_kernelILi{}EEEvNS_8OperandsENS_8TileMapsE"
    assert kinds == {
        dq.format(2): {"HGMMA.64x32x16.F32.BF16": 2},
        dq.format(0): {"HMMA.1688.F32.TF32": 3},
        dq.format(1): {"HMMA.1688.F32.TF32": 1},
        dkdv.format(0): {"HMMA.1688.F32.TF32": 1},
        dkdv.format(1): {"HMMA.1688.F32.TF32": 1},
        dkdv.format(2): {"HGMMA.64x32x16.F32.BF16": 1},
        "_ZN12_GLOBAL__N_122flash_bwd_delta_kernelEPKfS1_Pfiii": {},
        "_ZN12_GLOBAL__N_122flash_bwd_stage_kernelENS_8OperandsEPKfNS_10StagedBF16Ei": {},
    }
    assert kernels.sass_mma_counts("flash_attention_bwd") == {
        fn: sum(per.values()) for fn, per in kinds.items()}


def test_mma_kinds_by_form_reads_each_instances_instruction(monkeypatch):
    """Per kernel and form, the instructions of its instances: what
    chip_smoke.py's build phase holds (the flash backward's bf16 instances
    on wgmma alone, the flash forward's and the ACA kernels' on
    HMMA.16816.F32.BF16 alone, every other on HMMA.1688.F32.TF32 alone,
    kernels.mma_kind_faults); a kernel without a form (the pre-passes) is
    left out."""
    _fake_cuobjdump(monkeypatch, FAKE_SASS_KINDS)
    by_form = kernels.mma_kinds_by_form(kernels.sass_mma_kinds("flash_attention_bwd"))
    assert by_form == {
        "flash_bwd_dq_kernel": {
            "3xtf32": {"HMMA.1688.F32.TF32": 3},
            "1xtf32": {"HMMA.1688.F32.TF32": 1},
            "bf16": {"HGMMA.64x32x16.F32.BF16": 2},
        },
        "flash_bwd_dkdv_kernel": {
            "3xtf32": {"HMMA.1688.F32.TF32": 1},
            "1xtf32": {"HMMA.1688.F32.TF32": 1},
            "bf16": {"HGMMA.64x32x16.F32.BF16": 1},
        },
    }
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
                          (2, "HGMMA.64x32x16.F32.BF16"))
      for train in (0, 1)),
])


# the two ACA kernels' instances, forward (form, NT, head mean, training)
# and backward (form, NT), and the backward's chunk-sum pass (no product)
FAKE_SASS_ACA = "\n".join([
    "\tcode for sm_90a",
    *(f"\t\tFunction : _ZN49_GLOBAL__N__200b3f44_16_aca_attention_cu_b480851a20aca_attention_"
      f"kernelILi{form}ELi10ELb{hm}ELb{train}EEEvPKfS2_S2_S2_PfS3_iiiiifNS_9TrainArgsE\n"
      f"        /*0100*/                   {instr} R4, R8, R12, R4 ;"
      for form, instr in ((0, "HMMA.1688.F32.TF32"), (1, "HMMA.1688.F32.TF32"),
                          (2, "HMMA.16816.F32.BF16"))
      for hm in (0, 1) for train in (0, 1)),
    *(f"\t\tFunction : _ZN12_GLOBAL__N_124aca_attention_bwd_kernelILi{form}ELi10EEEvNS_8OperandsE\n"
      f"        /*0100*/                   {instr} R4, R8, R12, R4 ;\n"
      f"        /*0110*/                   {instr} R16, R8, R14, R16 ;"
      for form, instr in ((0, "HMMA.1688.F32.TF32"), (1, "HMMA.1688.F32.TF32"),
                          (2, "HMMA.16816.F32.BF16"))),
    "\t\tFunction : _ZN12_GLOBAL__N_131aca_attention_bwd_reduce_kernelENS_8OperandsE",
    "        /*0100*/                   FADD R1, R2, R3 ;",
])


def _flash_kinds(monkeypatch):
    """mma_kinds_by_form of the flash forward's six instances (fake SASS)
    beside the flash backward's (FAKE_SASS_KINDS) and the ACA kernels'
    (FAKE_SASS_ACA)."""
    by_form = {}
    for name, sass in (("flash_attention", FAKE_SASS_FLASH),
                       ("flash_attention_bwd", FAKE_SASS_KINDS),
                       ("aca_attention", FAKE_SASS_ACA)):
        _fake_cuobjdump(monkeypatch, sass)
        by_form.update(kernels.mma_kinds_by_form(kernels.sass_mma_kinds(name)))
    return by_form


# the kernels whose bf16 instances take mma.sync.m16n8k16 in the fake SASS,
# and those whose bf16 instances take wgmma (chip_smoke.py:BF16_MMA_KERNELS
# and WGMMA_KERNELS name the built libraries' five)
BF16_KERNELS = ("aca_attention_kernel", "aca_attention_bwd_kernel")
WGMMA = ("flash_attention_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkdv_kernel")


def test_mma_kind_faults_accept_the_flash_kernels_on_the_bf16_instruction(monkeypatch):
    """chip_smoke.py's rule holds on the layout of the built libraries: the
    flash forward's eval and training instances and the flash backward's dq
    and dk/dv kernels at bf16 on wgmma (HGMMA) alone, both ACA kernels' at
    bf16 on HMMA.16816.F32.BF16 alone, the 3xTF32 and 1xTF32 instances on
    HMMA.1688.F32.TF32 alone."""
    by_form = _flash_kinds(monkeypatch)
    assert by_form["flash_attention_kernel"] == {
        "3xtf32": {"HMMA.1688.F32.TF32": 4},
        "1xtf32": {"HMMA.1688.F32.TF32": 4},
        "bf16": {"HGMMA.64x32x16.F32.BF16": 4},
    }
    assert set(by_form) == {"flash_attention_kernel", "flash_bwd_dq_kernel",
                            "flash_bwd_dkdv_kernel", "aca_attention_kernel",
                            "aca_attention_bwd_kernel"}
    assert kernels.mma_kind_faults(by_form, BF16_KERNELS, WGMMA) == []
    # a kernel whose bf16 instances are on m16n8k16 but which the list
    # leaves out is a fault: the list names every such kernel
    faults = kernels.mma_kind_faults(by_form, (), WGMMA)
    assert sorted(f.split(" ")[0] for f in faults) == ["aca_attention_bwd_kernel",
                                                       "aca_attention_kernel"]
    # and so is one on wgmma that the wgmma list leaves out: the forward too
    faults = kernels.mma_kind_faults(by_form, BF16_KERNELS)
    assert sorted(f.split(" ")[:2] for f in faults) == [["flash_attention_kernel", "bf16:"],
                                                        ["flash_bwd_dkdv_kernel", "bf16:"],
                                                        ["flash_bwd_dq_kernel", "bf16:"]]


def test_mma_kind_faults_accept_the_aca_kernels_on_the_bf16_instruction(monkeypatch):
    """The ACA forward's four kinds of instance (eval and training, with and
    without the head mean) at each form are summed per form: bf16 on
    HMMA.16816.F32.BF16 alone, 3xTF32 and 1xTF32 on HMMA.1688.F32.TF32
    alone; the backward likewise, its chunk-sum pass (no product) left
    out; with both in the bf16 set there is no fault."""
    by_form = _flash_kinds(monkeypatch)
    assert by_form["aca_attention_kernel"] == {
        "3xtf32": {"HMMA.1688.F32.TF32": 4},
        "1xtf32": {"HMMA.1688.F32.TF32": 4},
        "bf16": {"HMMA.16816.F32.BF16": 4},
    }
    assert by_form["aca_attention_bwd_kernel"] == {
        "3xtf32": {"HMMA.1688.F32.TF32": 2},
        "1xtf32": {"HMMA.1688.F32.TF32": 2},
        "bf16": {"HMMA.16816.F32.BF16": 2},
    }
    aca_only = {fn: by_form[fn] for fn in ("aca_attention_kernel", "aca_attention_bwd_kernel")}
    assert kernels.mma_kind_faults(aca_only, ("aca_attention_kernel",
                                              "aca_attention_bwd_kernel")) == []
    assert kernels.mma_kind_faults(aca_only, BF16_KERNELS, WGMMA) == [
        f"{fn}: no such kernel with a product form" for fn in WGMMA]


@pytest.mark.parametrize("bad", ["tf32", "mixed", "other_form", "missing", "aca_tf32",
                                 "aca_bwd_tf32", "aca_mixed", "aca_other_form", "bwd_hmma",
                                 "bwd_mixed", "bwd_empty", "bwd_other_form", "bwd_missing",
                                 "fwd_hgmma", "aca_hgmma"])
def test_mma_kind_faults_name_each_instance_that_breaks_the_rule(monkeypatch, bad):
    """A bf16 instance left on the TF32 instruction, one that mixes the two,
    a 3xTF32 instance on the bf16 one, and a kernel of the list that the
    SASS lacks: each is one fault naming the kernel and the form; the same
    for the ACA forward's and backward's instances. The flash backward's
    bf16 instances on mma.sync.m16n8k16 alone, on wgmma and mma.sync both,
    or on none, its 3xTF32 instance on wgmma, its kernel missing: each a
    fault; the forward's bf16 instances on wgmma with mma.sync lines left
    beside it are one too, and so is an ACA kernel at bf16 on wgmma (they
    keep m16n8k16)."""
    by_form = _flash_kinds(monkeypatch)
    fwd = by_form["flash_attention_kernel"]
    aca_fwd = by_form["aca_attention_kernel"]
    hgmma = "HGMMA.64x32x16.F32.BF16"
    if bad == "tf32":
        fwd["bf16"] = {kernels.TF32_MMA: 64}
        want = "flash_attention_kernel bf16"
    elif bad == "mixed":
        fwd["bf16"] = {hgmma: 60, kernels.TF32_MMA: 4}
        want = "flash_attention_kernel bf16"
    elif bad == "other_form":
        fwd["3xtf32"] = {hgmma: 32}
        want = "flash_attention_kernel 3xtf32"
    elif bad == "missing":
        del by_form["flash_attention_kernel"]
        want = "flash_attention_kernel: no such kernel"
    elif bad == "aca_tf32":  # the bf16 instance on the TF32 instruction, as before
        aca_fwd["bf16"] = {kernels.TF32_MMA: 96}
        want = "aca_attention_kernel bf16"
    elif bad == "aca_bwd_tf32":
        by_form["aca_attention_bwd_kernel"]["bf16"] = {kernels.TF32_MMA: 80}
        want = "aca_attention_bwd_kernel bf16"
    elif bad == "aca_mixed":  # one of the four kinds of instance left behind
        aca_fwd["bf16"] = {kernels.BF16_MMA: 3, kernels.TF32_MMA: 1}
        want = "aca_attention_kernel bf16"
    elif bad == "aca_other_form":
        aca_fwd["1xtf32"] = {kernels.BF16_MMA: 4}
        want = "aca_attention_kernel 1xtf32"
    elif bad == "bwd_hmma":  # the backward's bf16 body back on mma.sync
        by_form["flash_bwd_dq_kernel"]["bf16"] = {kernels.BF16_MMA: 24}
        want = "flash_bwd_dq_kernel bf16"
    elif bad == "bwd_mixed":
        by_form["flash_bwd_dkdv_kernel"]["bf16"] = {hgmma: 8, kernels.BF16_MMA: 4}
        want = "flash_bwd_dkdv_kernel bf16"
    elif bad == "bwd_empty":
        by_form["flash_bwd_dkdv_kernel"]["bf16"] = {}
        want = "flash_bwd_dkdv_kernel bf16"
    elif bad == "bwd_other_form":  # the 3xTF32 instance keeps m16n8k8
        by_form["flash_bwd_dq_kernel"]["3xtf32"] = {hgmma: 6}
        want = "flash_bwd_dq_kernel 3xtf32"
    elif bad == "bwd_missing":
        del by_form["flash_bwd_dkdv_kernel"]
        want = "flash_bwd_dkdv_kernel: no such kernel"
    elif bad == "fwd_hgmma":  # wgmma with mma.sync lines of the old body beside it
        fwd["bf16"] = {"HGMMA.64x64x16.F32.BF16": 8, kernels.BF16_MMA: 4}
        want = "flash_attention_kernel bf16"
    else:
        by_form["aca_attention_bwd_kernel"]["bf16"] = {hgmma: 8}
        want = "aca_attention_bwd_kernel bf16"
    faults = kernels.mma_kind_faults(by_form, BF16_KERNELS, WGMMA)
    assert len(faults) == 1 and faults[0].startswith(want), faults
    # a kernel off the lists keeps its bf16 instance on the TF32 instruction
    if bad == "tf32":
        assert kernels.mma_kind_faults(by_form, BF16_KERNELS, WGMMA[1:]) == []


def test_hmma_by_form_sums_each_kernels_instances_per_form():
    """Every kernel with a product is a template whose first argument is its
    product form (ops/forms.py FORMS): the counts of its instances add up
    per form, and kernels without a form (no product) are left out."""
    # the ACA forward's bf16 instances on m16n8k16 take 4 NT products (2 NT
    # for S, 2 NT for p.v) against 3xTF32's 24 NT on m16n8k8
    counts = {
        "_ZN49_GLOBAL__N__200b3f44_16_aca_attention_cu_b480851a20aca_attention_kernelILi2ELi6"
        "ELb1ELb0EEEvPKfS2_S2_S2_PfS3_iiiiifNS_9TrainArgsE": 24,
        "_ZN49_GLOBAL__N__200b3f44_16_aca_attention_cu_b480851a20aca_attention_kernelILi2ELi8"
        "ELb0ELb1EEEvPKfS2_S2_S2_PfS3_iiiiifNS_9TrainArgsE": 32,
        "_ZN49_GLOBAL__N__200b3f44_16_aca_attention_cu_b480851a20aca_attention_kernelILi0ELi6"
        "ELb1ELb0EEEvPKfS2_S2_S2_PfS3_iiiiifNS_9TrainArgsE": 144,
        "_ZN12_GLOBAL__N_124aca_attention_bwd_kernelILi2ELi10EEEvNS_8OperandsE": 60,
        "_ZN12_GLOBAL__N_124aca_attention_bwd_kernelILi1ELi10EEEvNS_8OperandsE": 120,
        "_ZN12_GLOBAL__N_131aca_attention_bwd_reduce_kernelENS_8OperandsE": 0,
        "_ZN51_GLOBAL__N__e895d2d6_18_flash_attention_cu_bc10f23522flash_attention_kernelILi1"
        "ELb1EEEvPKfS2_S2_S2_PfiifS3_jjf": 64,
        "_ZN12_GLOBAL__N_122flash_bwd_delta_kernelEPKfS1_Pfiii": 0,
        # the flash backward's bf16 dq instance: its wgmma lines (HGMMA),
        # which sass_mma_counts counts beside HMMA's; the staging pre-pass
        # has no product
        "_ZN12_GLOBAL__N_119flash_bwd_dq_kernelILi2EEEvNS_8OperandsENS_8TileMapsE": 6,
        "_ZN12_GLOBAL__N_122flash_bwd_stage_kernelENS_8OperandsEPKfNS_10StagedBF16Ei": 0,
    }
    assert kernels.hmma_by_form(counts) == {
        "aca_attention_kernel": {"3xtf32": 144, "1xtf32": 0, "bf16": 56},
        "aca_attention_bwd_kernel": {"3xtf32": 0, "1xtf32": 120, "bf16": 60},
        "flash_attention_kernel": {"3xtf32": 0, "1xtf32": 64, "bf16": 0},
        "flash_bwd_dq_kernel": {"3xtf32": 0, "1xtf32": 0, "bf16": 6},
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


# --- tools/flash_bwd_time.py, the attention kernels' timing tool -------------

@pytest.mark.parametrize("mangled,want", [
    ("_ZN51_GLOBAL__N__e895d2d6_18_flash_attention_cu_bc10f23522flash_attention_kernelILi2"
     "ELb1EEEvPKfS2_S2_S2_PfiifS3_jjf", "flash_attention_kernel<2, 1>"),
    ("_ZN12_GLOBAL__N_119flash_bwd_dq_kernelILi2EEEvNS_8OperandsE", "flash_bwd_dq_kernel<2>"),
    ("_ZN49_GLOBAL__N__200b3f44_16_aca_attention_cu_b480851a20aca_attention_kernelILi2ELi10"
     "ELb1ELb0EEEvPKfS2_S2_S2_PfS3_iiiiifNS_9TrainArgsE", "aca_attention_kernel<2, 10, 1, 0>"),
    ("_ZN12_GLOBAL__N_124aca_attention_bwd_kernelILi0ELi16EEEvNS_8OperandsE",
     "aca_attention_bwd_kernel<0, 16>"),
])
def test_timing_tool_names_each_kernel_instance(mangled, want):
    """The tool names an instance by its kernel and template arguments (the
    form first), for the flash and the ACA kernels alike; the profiler's
    device records map to the kernel, the ACA backward apart from its
    chunk-sum pass."""
    from flashvtg_tpu_torch.tools import flash_bwd_time as tool

    assert tool.instance(mangled) == want
    demangled = f"void (anonymous namespace)::{want.split('<')[0]}<2, 10>(...)"
    assert tool.KERNEL_NAME.search(demangled).group(1) == want.split("<")[0]
    reduce = "void (anonymous namespace)::aca_attention_bwd_reduce_kernel((anonymous namespace)::Operands)"
    assert tool.KERNEL_NAME.search(reduce).group(1) == "aca_attention_bwd_reduce_kernel"


def test_timing_tool_reads_registers_and_spills_of_each_instance():
    """ptxas -v's report, by instance: registers and spill bytes of every
    attention kernel with a product; a kernel without one (the ACA
    backward's chunk-sum pass) is left out."""
    from flashvtg_tpu_torch.tools import flash_bwd_time as tool

    bwd = "_ZN12_GLOBAL__N_124aca_attention_bwd_kernelILi2ELi10EEEvNS_8OperandsE"
    red = "_ZN12_GLOBAL__N_131aca_attention_bwd_reduce_kernelENS_8OperandsE"
    log = "\n".join([
        f"ptxas info    : Compiling entry function '{bwd}' for 'sm_90a'",
        f"ptxas info    : Function properties for {bwd}",
        "    0 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads",
        "ptxas info    : Used 128 registers, used 1 barriers, 464 bytes cmem[0]",
        f"ptxas info    : Compiling entry function '{red}' for 'sm_90a'",
        f"ptxas info    : Function properties for {red}",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 24 registers, used 0 barriers, 464 bytes cmem[0]",
    ])
    assert tool.ptxas_report(log) == {
        "aca_attention_bwd_kernel<2, 10>": "128 registers, 8 bytes spill stores, "
                                           "12 bytes spill loads"}


@pytest.mark.parametrize("shape", ["flagship_train_aca", "flagship_eval_aca",
                                   "flagship_train_short42"])
def test_timing_tool_aca_cases_rehearse_on_the_cpu(monkeypatch, shape):
    """The tool's ACA and short-form cases, rehearsed on the CPU at their
    shapes with the plain versions in the launchers' place: the training
    shapes time the forward and the backward, the eval shapes the forward;
    each bound is chip_smoke.py:attention_bound's for that pass, on the
    case's own key mask, with the donor rows' pairs at the ACA train shapes
    (aca_pairs); sdpa's inputs only for the short form."""
    import chip_smoke
    import torch

    from flashvtg_tpu_torch.models import transformer
    from flashvtg_tpu_torch.ops import attn_dropout
    from flashvtg_tpu_torch.tools import flash_bwd_time as tool

    monkeypatch.setattr(torch.Tensor, "cuda", lambda self, *a, **k: self)
    donors = transformer.tiled_attn_donors
    monkeypatch.setattr(transformer, "tiled_attn_donors", lambda b, h, device=None: donors(b, h))
    monkeypatch.setattr(attn_dropout, "seed_tensor",
                        lambda seed, device: torch.tensor(int(seed), dtype=torch.int32))
    monkeypatch.setattr(aca, "_launch", aca.aca_attention_plain)
    monkeypatch.setattr(aca, "_launch_bwd", aca.aca_attention_bwd_plain)
    seen = []

    def bound(b, lv, lk, heads, nd, key_valid, want_head_mean, backward=False, pairs=None,
              form="3xtf32"):
        seen.append((b, lv, lk, nd, int(key_valid.sum().item()), want_head_mean, backward,
                     pairs, form))
        return (0.5 if backward else 0.25), "bytes"

    monkeypatch.setattr(chip_smoke, "attention_bound", bound)
    calls, bounds, lib, facts = tool.aca_cases(shape, "bf16", 0, 0.1)
    train, aca_shape = "train" in shape, shape.endswith("_aca")
    b, lv, lk, nd = facts["B"], facts["Lv"], facts["Lk"], facts["nd"]
    assert set(calls) == ({"fwd", "bwd"} if train else {"fwd"})
    assert bounds == ({"fwd": 0.25, "bwd": 0.5} if train else {"fwd": 0.25})
    assert (nd > 0) == aca_shape and facts["donor_rows"] == (train and aca_shape)
    assert facts["dropout"] == (0.1 if train else 0.0)
    for (sb, slv, slk, snd, keys, hm, backward, pairs, form), pas in zip(seen, bounds):
        assert (sb, slv, slk, snd, keys, hm, backward, form) == (
            b, lv, lk, nd, facts["valid_keys"], aca_shape, pas == "bwd", "bf16")
        if facts["donor_rows"]:  # the donor rows leave fewer pairs than the key mask
            assert pairs[1] <= pairs[0] < 8 * lv * keys
        else:
            assert pairs is None
    outs = {p: fn() for p, fn in calls.items()}
    assert outs["fwd"][0].shape == (b, lv, 8 * 32)
    if train:
        assert [tuple(x.shape) for x in outs["bwd"]] == [(b, lv, 256), (b, lk, 256), (b, lk, 256)]
    if aca_shape:
        assert lib is None
    else:  # q, k, v and the key mask for sdpa
        assert [tuple(x.shape) for x in lib] == [(b, lv, 256)] * 3 + [(b, lk)]


# --- the flash wrappers' scratch and arguments (ops/chunked_attn.py) ----------

class _RecordedEntries:
    """A built library's C entries on the CPU: each call's name and
    arguments, in order; every call returns 0 (launched) and writes nothing."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


def test_flash_prepass_plain_rounds_as_the_plain_versions():
    """stage_kv on the CPU (its plain version) rounds k and v to bf16 as the
    plain versions round their operands at the bf16 form (ops/forms.py), to
    nearest even, into one (2, B, L, H*Dh) tensor."""
    import torch

    from flashvtg_tpu_torch.ops import chunked_attn
    from flashvtg_tpu_torch.ops.forms import round_operand

    g = torch.Generator().manual_seed(5)
    k, v = (torch.randn((3, 77, 64), generator=g) for _ in range(2))
    kv = chunked_attn.stage_kv(k, v)
    assert kv.shape == (2, 3, 77, 64) and kv.dtype == torch.bfloat16
    assert torch.equal(kv[0].float(), round_operand(k, "bf16"))
    assert torch.equal(kv[1].float(), round_operand(v, "bf16"))


@pytest.mark.parametrize("form", ["3xtf32", "1xtf32", "bf16"])
def test_flash_wrappers_hand_the_bf16_copies_to_the_backward(monkeypatch, form):
    """The flash wrappers' scratch and arguments, rehearsed on the CPU with
    the library's entries recorded in the kernels' place. The plain route
    is unchanged: the plain versions' values, no entry called, no bf16
    tensor saved for the backward. On the kernels' route, at the bf16 form
    one (2, B, L, H*Dh) bf16 allocation is made a forward, its halves go to
    the forward entry (whose pre-pass fills them) and, saved by the autograd
    Function, to the backward's, which then stages only scale q, q and dO
    (stage_kv 0) in a (3, B, L, H*Dh) allocation; the eval forward keeps
    no copy. At the other forms no scratch and null pointers."""
    import torch

    from flashvtg_tpu_torch import kernels
    from flashvtg_tpu_torch.ops import chunked_attn

    b, length, heads = 2, 150, 2
    n = b * length * heads * 32
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn((b, length, heads * 32), generator=g).requires_grad_()
               for _ in range(3))
    valid = torch.ones((b, length))
    lib = _RecordedEntries()
    monkeypatch.setattr(kernels, "load", lambda name: lib)

    def run(dropout, seed):
        saved = []
        with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t) or t,
                                                      lambda t: t):
            out = chunked_attn._FlashFn.apply(q, k, v, valid, heads, dropout, seed, form)
        out.backward(torch.ones_like(out))
        return out, [t for t in saved if t.dtype == torch.bfloat16]

    out, saved_bf16 = run(0.0, None)
    ref = chunked_attn.flash_attention_plain(q.detach(), k.detach(), v.detach(), valid, heads,
                                             form=form)
    assert torch.equal(out.detach(), ref) and saved_bf16 == [] and lib.calls == []

    monkeypatch.setattr(chunked_attn, "_plain", lambda t: False)
    monkeypatch.setattr(chunked_attn, "_launching", lambda: True)
    monkeypatch.setattr(chunked_attn, "_stream", lambda t: 0)
    monkeypatch.setattr(chunked_attn, "_check_self",
                        lambda tag, q, k, v, key_valid, h: (q.shape[0], q.shape[1]))
    _, saved_bf16 = run(0.1, 7)
    names = [name for name, _ in lib.calls]
    fwd = dict(lib.calls)["flashvtg_flash_attention_train_f32"]
    bwd = dict(lib.calls)["flashvtg_flash_attention_bwd_f32"]
    assert names == ["flashvtg_flash_attention_train_f32", "flashvtg_flash_attention_bwd_f32"]
    assert fwd[:3] == (q.data_ptr(), k.data_ptr(), v.data_ptr())
    if form != "bf16":
        assert fwd[6:8] == (None, None) and bwd[11:17] == (None,) * 5 + (1,)
        assert saved_bf16 == []
    else:
        assert fwd[7] - fwd[6] == 2 * n  # the halves of one bf16 allocation
        (kv,) = saved_bf16
        assert kv.shape == (2, b, length, heads * 32) and kv.data_ptr() == fwd[6]
        qs, qb, kb, vb, dob, stage_kv = bwd[11:17]
        assert (kb, vb, stage_kv) == (fwd[6], fwd[7], 0)
        assert qb - qs == 2 * n and dob - qb == 2 * n  # its own three copies
    lib.calls.clear()
    chunked_attn._launch(q.detach(), k.detach(), v.detach(), valid, heads, form=form)
    ((name, args),) = lib.calls
    assert name == "flashvtg_flash_attention_f32"
    assert (args[6] - args[5] == 2 * n) if form == "bf16" else args[5:7] == (None, None)
