"""The port's FLOP count and utilisation (flashvtg_tpu_torch/utils/flops.py)
on the CPU.

  * model_flops equals the JAX package's (flashvtg_tpu/utils/flops.py) for
    every core preset, eval and train, group by group; pyramid_lengths too;
  * on a small forward and train step of the port, what
    torch.utils.flop_counter.FlopCounterMode counts (matmuls and
    convolutions, the plain attention's included) lies in the bands that
    tests/test_flops.py holds XLA's count to: analytic <= counted <= 1.5x
    for the eval forward (analytic without the saliency score's
    elementwise dot, which the counter does not see), 0.70x to 1.6x for
    the train step;
  * the matmul skeleton of tools/matmul_ceiling.py does model_flops's
    products, forward (B 2) and forward + backward, within 0.1 %;
  * the mfu arithmetic at the H100 peaks (989 TFLOP/s bf16, 495 TF32, 67
    f32), against the measured ceilings where the table has one.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from flashvtg_tpu.train.config import PRESETS as JAX_PRESETS
from flashvtg_tpu.train.config import from_preset as jax_preset
from flashvtg_tpu.utils.flops import model_flops as jax_model_flops
from flashvtg_tpu.utils.flops import pyramid_lengths as jax_pyramid_lengths
from flashvtg_tpu_torch.models import ModelConfig, build_model
from flashvtg_tpu_torch.tools.matmul_ceiling import skeleton, skeleton_weights
from flashvtg_tpu_torch.train.config import from_preset
from flashvtg_tpu_torch.utils import flops
from flashvtg_tpu_torch.utils.flops import (
    H100_PEAK_TFLOPS,
    MEASURED_SKELETON_TFLOPS,
    MEASURED_TRAIN_SKELETON_TFLOPS,
    PEAK_BF16_TFLOPS,
    mfu,
    model_flops,
    pyramid_lengths,
    step_mfu,
)

CORE_PRESETS = sorted(n for n in JAX_PRESETS if from_preset(n).variant == "core")

B, LQ, LV = 4, 12, 40
CFG = ModelConfig(vid_dim=66, txt_dim=48, hidden_dim=128, nheads=4, enc_layers=2,
                  t2v_layers=2, dummy_layers=1, num_dummies=6, dim_feedforward=256,
                  num_conv_layers=2, num_mlp_layers=3, max_q_l=LQ)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("name", CORE_PRESETS)
def test_model_flops_equal_jax(name, train):
    ours, ref = from_preset(name), jax_preset(name)
    lq, lv = ours.max_q_l, ours.max_v_l
    got = model_flops(ours.model_config(), ours.bsz, lq, lv, train=train)
    want = jax_model_flops(ref.model_config(), ref.bsz, lq, lv, train=train)
    assert got == want


@pytest.mark.parametrize("lv", [3, 40, 75, 1000, 2048])
def test_pyramid_lengths_equal_jax(lv):
    assert pyramid_lengths(lv, (1, 2, 4, 8)) == jax_pyramid_lengths(lv, (1, 2, 4, 8))


def _inputs():
    r = np.random.default_rng(0)
    return (torch.from_numpy(r.standard_normal((B, LQ, CFG.txt_dim), np.float32)),
            torch.ones(B, LQ),
            torch.from_numpy(r.standard_normal((B, LV, CFG.vid_dim), np.float32)),
            torch.ones(B, LV))


def test_eval_forward_flops_vs_flop_counter():
    model = build_model(CFG, "cpu", 0)
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        model(*_inputs())
    counted = fc.get_total_flops()
    # the counter counts products alone, and the saliency score's dot
    # product (2 B Lv d) is an elementwise product and a sum in the model:
    # the count it is held to is model_flops's without it (XLA, which counts
    # elementwise work too, sees all of it)
    analytic = model_flops(CFG, B, LQ, LV, train=False)["fwd"] - 2.0 * B * LV * CFG.hidden_dim
    assert analytic <= counted <= 1.5 * analytic, (analytic, counted)


def test_train_flops_vs_flop_counter():
    model = build_model(CFG, "cpu", 0).train()
    txt, tm, vid, vm = _inputs()
    with FlopCounterMode(display=False) as fc:
        out = model(txt, tm, vid, vm, real_neg_mask=torch.ones(B))
        loss = (out["out_class"].sum() + out["out_coord"].sum()
                + out["saliency_scores"].sum() + out["saliency_scores_neg"].sum())
        loss.backward()
    counted = fc.get_total_flops()
    est = model_flops(CFG, B, LQ, LV, train=True)
    assert 0.70 * est["fwd_bwd"] <= counted <= 1.6 * est["fwd_bwd"], (est["fwd_bwd"], counted)
    # the train forward runs the negative trunk pass
    assert est["fwd"] > model_flops(CFG, B, LQ, LV, train=False)["fwd"] * 1.4


@pytest.mark.parametrize("train", [False, True])
def test_matmul_skeleton_does_model_flops(train):
    cfg = from_preset("qvhighlights_slowclip")
    mcfg = cfg.model_config()
    w = skeleton_weights(cfg, "cpu")
    g = torch.Generator().manual_seed(0)
    vid = torch.randn(2, 75, mcfg.vid_dim, generator=g)
    txt = torch.randn(2, 32, mcfg.txt_dim, generator=g)
    fwd = model_flops(mcfg, 2, 32, 75, with_neg=False)["fwd"]
    with FlopCounterMode(display=False) as fc:
        if train:
            w = {k: v.requires_grad_() for k, v in w.items()}
            inputs = list(w.values()) + [vid.requires_grad_(), txt.requires_grad_()]
            torch.autograd.grad(skeleton(cfg, w, vid, txt), inputs)
        else:
            with torch.no_grad():
                skeleton(cfg, w, vid, txt)
    want = 3 * fwd if train else fwd
    assert abs(fc.get_total_flops() - want) <= 1e-3 * want, (fc.get_total_flops(), want)


def test_mfu_arithmetic():
    assert PEAK_BF16_TFLOPS == 989.0
    assert H100_PEAK_TFLOPS == {"float32": 67.0, "tensorfloat32": 495.0, "bfloat16": 989.0}
    out = mfu(flops=989e12, seconds=1.0, precision="bfloat16")
    assert out["achieved_tflops"] == pytest.approx(989.0)
    assert out["mfu"] == pytest.approx(1.0)
    for prec in H100_PEAK_TFLOPS:
        for table in (None, MEASURED_TRAIN_SKELETON_TFLOPS):
            got = mfu(flops=10e12, seconds=0.5, precision=prec, ceilings=table)
            ceiling = (table if table is not None else MEASURED_SKELETON_TFLOPS).get(
                prec, H100_PEAK_TFLOPS[prec])
            assert got["achieved_tflops"] == pytest.approx(20.0)
            assert got["mfu"] == pytest.approx(20.0 / 989.0)
            assert got["mfu_effective"] == pytest.approx(20.0 / ceiling)
    # a measured ceiling is physical: above 0, at most the dial's peak
    for table in (MEASURED_SKELETON_TFLOPS, MEASURED_TRAIN_SKELETON_TFLOPS):
        for prec, tflops in table.items():
            assert 0 < tflops <= H100_PEAK_TFLOPS[prec], (prec, tflops)
    with pytest.raises(KeyError, match="unknown precision"):
        mfu(1e12, 1.0, precision="tf32")


def test_step_mfu():
    cfg = from_preset("tacos")
    fl = model_flops(cfg.model_config(), 32, cfg.max_q_l, cfg.max_v_l, train=True)
    got = step_mfu(cfg, 32, 0.2, "bfloat16", train=True)
    assert got == flops.mfu(fl["fwd_bwd"], 0.2, "bfloat16",
                            ceilings=MEASURED_TRAIN_SKELETON_TFLOPS)
    assert step_mfu(dataclasses.replace(cfg, variant="ms"), 32, 0.2, "bfloat16", True) is None
