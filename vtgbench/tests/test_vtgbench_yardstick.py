"""The benchmark's frozen yardstick against today's port: the FLOP count,
the attention bound, the kernel classes and the calls of a step."""

from __future__ import annotations

import importlib.util
import os

import numpy as np
import pytest
import torch

from vtgbench.reference.attention import _masked
from vtgbench.tests.tiny_cells import load
from vtgbench.yardstick import bound, flops, kernels

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("name", ["tacos", "qvhighlights_slowclip"])
@pytest.mark.parametrize("train", [False, True])
def test_flops_equal_the_program_count_at_padded_shapes(name, train):
    from flashvtg_tpu_torch.train.config import from_preset
    from flashvtg_tpu_torch.utils.flops import model_flops

    cfg = load("configs", name)
    program = from_preset(cfg["preset"]).model_config()
    for b, lq, lv in [(32, 40, 2048), (8, 17, 301), (64, 32, 75), (1, 5, 7)]:
        ours = flops.model_flops(flops.model_config(cfg), b, lq, lv, train)
        theirs = model_flops(program, b, lq, lv, train)
        assert ours == theirs
    key = "fwd_bwd" if train else "fwd"
    padded = model_flops(program, 4, cfg["max_q_l"], cfg["max_v_l"], train)[key]
    rows = [(cfg["max_v_l"], cfg["max_q_l"])] * 4
    assert flops.rows_flops(cfg, rows, train) == pytest.approx(padded, rel=1e-12)


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("shape", [(8, 2048, 2048, 8, 0, False), (32, 2048, 75, 8, 35, True),
                                   (64, 75, 42, 8, 10, True), (64, 42, 42, 8, 0, False)])
def test_bound_equals_the_program_bound_at_float32(shape, backward):
    b, lv, lk, heads, nd, head_mean = shape
    g = torch.Generator().manual_seed(lv + lk)
    key_valid = (torch.rand(b, lk, generator=g) > 0.3).float()
    key_valid[:, :nd] = 1
    theirs, _ = chip_smoke().attention_bound(b, lv, lk, heads, nd, key_valid, head_mean,
                                             backward=backward, form="3xtf32")
    counts = (float(key_valid.sum()), float(key_valid[:, nd:].sum()))
    ours = bound.attention_bound(b, lv, lk, heads, nd, counts, head_mean, backward=backward,
                                 form="3xtf32")
    assert ours * 1e3 == pytest.approx(theirs, rel=1e-12)
    bf16 = bound.attention_bound(b, lv, lk, heads, nd, counts, head_mean, backward=backward,
                                 form="bf16")
    assert bf16 < ours


NAMES = [
    "void flash_attention_kernel<2, true>(float const*)",
    "flash_fwd_stage_kernel(float const*, __nv_bfloat16*)",
    "void flash_bwd_dq_kernel<2>(Params)", "void flash_bwd_dkdv_kernel<2>(Params)",
    "void flash_bwd_stage_kernel<false>(Params)", "flash_bwd_delta_kernel(Params)",
    "void aca_attention_kernel<0, 3, true, false>(Args)",
    "void aca_attention_kernel<2, 5, false, true>(Args)",
    "void aca_attention_bwd_kernel<2, 5, true>(Args)", "aca_attention_bwd_reduce_kernel(Args)",
    "nvjet_tst_128x64_64x4_1x2_h_bz_coopA_NTN", "ampere_sgemm_128x64_nn",
    "void cudnn::engines_precompiled::nchwToNhwcKernel", "Memcpy HtoD (Pinned -> Device)",
    "void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<float>>",
]


def test_kernel_classes_follow_the_program_but_file_the_flash_prepass_under_flash():
    from flashvtg_tpu_torch.tools.profile_eval import kernel_class

    for name in NAMES:
        if "flash_fwd_stage" in name:
            assert kernel_class(name) == "other"
            assert kernels.kernel_class(name) == "flash_attention"
        else:
            assert kernels.kernel_class(name) == kernel_class(name)
    fams = [kernels.family(n) for n in NAMES]
    assert fams[:6] == ["flash"] * 6 and fams[6:10] == ["aca"] * 4 and set(fams[10:]) == {None}
    mains = [kernels.main_call(n) for n in NAMES]
    assert mains[0] == ("flash", False) and mains[2] == ("flash", True)
    assert mains[6] == mains[7] == ("aca", False) and mains[8] == ("aca", True)
    assert [m for m in mains if m is not None].__len__() == 5


def _counts(calls):
    out = {}
    for fam, bwd, t in calls:
        out[fam, bwd] = out.get((fam, bwd), 0) + 1
        assert t > 0
    return out


def test_step_calls_are_the_program_launches():
    rng = np.random.default_rng(0)
    tacos, qvh = load("configs", "tacos"), load("configs", "qvhighlights_slowclip")
    vid = (np.arange(2048)[None] < rng.integers(64, 2049, 32)[:, None]).astype(float)
    txt = (np.arange(40)[None] < rng.integers(5, 41, 32)[:, None]).astype(float)
    # TACoS train: 3 short + 16 ACA and 6 flash a step, and as many backward
    assert _counts(bound.step_calls(tacos, vid, txt, True, "bfloat16")) == {
        ("aca", False): 19, ("aca", True): 19, ("flash", False): 6, ("flash", True): 6}
    assert _counts(bound.step_calls(tacos, vid[:8], txt[:8], False, "float32")) == {
        ("aca", False): 11, ("flash", False): 3}
    vid75, txt32 = np.ones((64, 75)), (np.arange(32)[None] < 9).astype(float).repeat(64, 0)
    # flagship train: 12 ACA and 8 short a step, no flash kernel
    assert _counts(bound.step_calls(qvh, vid75, txt32, True, "bfloat16")) == {
        ("aca", False): 20, ("aca", True): 20}


def test_donor_pairs_count_the_masked_logits_of_valid_query_rows():
    rng = np.random.default_rng(1)
    b, lv, nd, heads, lq = 6, 40, 3, 2, 7
    vid = (np.arange(lv)[None] < rng.integers(5, lv + 1, b)[:, None]).astype(float)
    txt = np.concatenate([np.ones((b, nd)), (np.arange(lq)[None] < rng.integers(1, lq + 1, b)[:, None])],
                         axis=1).astype(float)
    for donors in (bound._tiled_donors(b, heads), bound._neg_donors(np.array([1, 1, 0, 1, 0, 1]), heads)):
        q = torch.zeros(b, heads, lv, 1)
        k = torch.zeros(b, heads, lq + nd, 1)
        logits = _masked(q, k, 0, torch.tensor(txt), torch.tensor(vid), torch.tensor(donors),
                         torch.tensor(txt), lambda x: x)
        rows = torch.tensor(vid, dtype=torch.bool)[:, None, :, None]
        finite = torch.isfinite(logits) & rows
        valid, value = bound._donor_pairs(txt, vid, vid, txt, donors, nd)
        assert valid == float(finite.sum())
        assert value == float(finite[..., nd:].sum())
        # every query row valid: chip_smoke's count of every row's pairs
        every = np.ones_like(vid)
        valid, _ = bound._donor_pairs(txt, every, vid, txt, donors, nd)
        assert valid == float(torch.isfinite(logits).sum())


def test_padded_rows_need_no_time():
    """A step's least time counts each row's valid queries against its valid
    keys: padding rows and keys add nothing but the key mask read as
    stored, and with every row valid the count is chip_smoke's."""
    tacos = load("configs", "tacos")
    rng = np.random.default_rng(2)
    n = rng.integers(32, 256, 8)
    lens = rng.integers(5, 16, 8)
    vid = (np.arange(2048)[None] < n[:, None]).astype(float)
    txt = (np.arange(40)[None] < lens[:, None]).astype(float)
    short = (np.arange(256)[None] < n[:, None]).astype(float)
    for train in (False, True):
        long_calls = bound.step_calls(tacos, vid, txt, train, "float32")
        short_calls = bound.step_calls(tacos, short, txt, train, "float32")
        mask = 4 * 8 * (2048 - 256) / bound.HBM_RATE
        for (fam, bwd, t_long), (_, _, t_short) in zip(long_calls, short_calls):
            assert t_short - 1e-15 <= t_long <= t_short + mask + 1e-15
    every = np.ones((4, 300))
    txt4 = txt[:4]
    nd, heads = tacos["num_dummies"], tacos["nheads"]
    keys = np.concatenate([np.ones((4, nd)), txt4], axis=1)
    counts = (float(keys.sum()), float(keys[:, nd:].sum()))
    # the first ACA layer follows the dummy-token encoder's layers
    aca, _, t = bound.step_calls(tacos, every, txt4, False, "float32")[tacos["dummy_layers"]]
    assert aca == "aca"
    assert t == pytest.approx(bound.attention_bound(4, 300, nd + 40, heads, nd, counts, True,
                                                    form="3xtf32", k_rows=keys.sum()),
                              rel=1e-12)
