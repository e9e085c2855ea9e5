"""Analytic FLOP count of the FlashVTG forward and train step, and the
model-FLOPs utilisation on an NVIDIA H100.

Counterpart of flashvtg_tpu/utils/flops.py: the same counts (a
multiply-add is 2 FLOPs; matmuls and convolutions only, the elementwise,
softmax and norm work being O(B L d) beside the O(B L d^2) products), by
component group, for the eval forward and the train forward + backward
(3x the forward's products: each product's backward is two of its shape).
The core model only: the FlashVTG_ms variant is not counted, as on the JAX
side. tests/test_torch_flops.py holds the count equal to the JAX package's
for every core preset and, at a small shape, to what
torch.utils.flop_counter counts in a forward and a train step of the port.

Prices. The card's dense peaks, from the H100 SXM data sheet, are those at
which PERF.md prices the kernels' bounds (chip_smoke.py): 989 TFLOP/s on
bf16 operands, 495 on TF32 and 67 in float32 outside the tensor cores.
`mfu` is against the bf16 peak, the number comparable across frameworks;
`mfu_effective` is against the dial's measured matmul-skeleton ceiling
(MEASURED_SKELETON_TFLOPS for eval, MEASURED_TRAIN_SKELETON_TFLOPS for a
train step): how close a step is to the speed of its own products at the
model's shapes, on this card. A dial with no measured ceiling falls back to
its peak (H100_PEAK_TFLOPS).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

PEAK_BF16_TFLOPS = 989.0  # dense, bf16 operands on the tensor cores
# the peak each precision dial's products can reach (utils/runtime.py:
# matmul_precision): float32 keeps TF32 off, so its GEMMs run outside the
# tensor cores
H100_PEAK_TFLOPS = {"float32": 67.0, "tensorfloat32": 495.0, "bfloat16": PEAK_BF16_TFLOPS}

# MEASURED ceilings (TFLOP/s) of the flagship model's products alone (every
# matmul and convolution model_flops counts, chained with reshapes and adds
# only), at each dial, from `python -m flashvtg_tpu_torch.tools.matmul_ceiling`
# on NVIDIA H100 80GB HBM3, power limit 700.00 W (chip_smoke.py phase 16 (e)
# prints them again at every run). Eval: the forward at B 512, Lv 75, Lq 32.
MEASURED_SKELETON_TFLOPS = {
    "float32": 30.71,
    "tensorfloat32": 63.73,
    "bfloat16": 109.13,
}
# Train: the forward and the full backward (input and weight gradients) of
# the same chain at B 32: thinner products, a lower ceiling. Both tables: the
# tool's readings, rounded, square4k reading 52.0 / 398.1 / 566.2 in the same
# run (the products at these shapes reach 4-46 % of the dials' peaks).
MEASURED_TRAIN_SKELETON_TFLOPS = {
    "float32": 18.64,
    "tensorfloat32": 32.52,
    "bfloat16": 41.80,
}


def _dense(b, l, d_in, d_out):
    return 2.0 * b * l * d_in * d_out


def _conv1d(b, l_out, k, c_in, c_out):
    return 2.0 * b * l_out * k * c_in * c_out


def _encoder_layer(b, l, d, ff):
    """Post-norm self-attention layer: q / k / v / out projections, the
    logits and value products, and the two-layer FFN."""
    attn = (
        3 * _dense(b, l, d, d)      # q, k, v projections
        + 2.0 * b * l * l * d       # attention logits
        + 2.0 * b * l * l * d       # attention-weighted values
        + _dense(b, l, d, d)        # output projection
    )
    ffn = _dense(b, l, d, ff) + _dense(b, l, ff, d)
    return attn, ffn


def _confidence_scorer(b, n, d, k, num_conv_layers, num_mlp_layers):
    """ConfidenceScorer: its convolutions and its MLP to a scalar."""
    convs = num_conv_layers * _conv1d(b, n, k, d, d)
    half = d // 2
    if num_mlp_layers == 1:
        mlp = _dense(b, n, d, 1)
    else:
        mlp = _dense(b, n, d, half)
        mlp += (num_mlp_layers - 2) * _dense(b, n, half, half)
        mlp += _dense(b, n, half, 1)
    return convs, mlp


def pyramid_lengths(lv: int, strides) -> list:
    """Points per pyramid level: chained VALID (k=2, s=2) convolutions
    halve the length, floor((l - 2) / 2 + 1) = floor(l / 2); levels past
    Lv are dropped."""
    out = []
    for s in strides:
        if lv < s:
            continue
        l = lv
        for _ in range(int(math.log2(s))):
            l = (l - 2) // 2 + 1
        out.append(l)
    return out


def model_flops(cfg, batch: int, lq: int, lv: int, train: bool = False,
                with_neg: Optional[bool] = None) -> Dict[str, float]:
    """FLOPs of one forward of the core model (`fwd`) of ModelConfig `cfg`
    and, with `train`, of the forward and backward (`fwd_bwd`, 3x fwd),
    by group; `n_points` the pyramid's points. `with_neg` defaults to the
    mode's: the negative trunk pass runs in train (with use_neg), not in
    the eval decode path."""
    b, d, ff = batch, cfg.hidden_dim, cfg.dim_feedforward
    nd = cfg.num_dummies
    lk = nd + lq  # text keys with the dummy tokens
    if with_neg is None:
        with_neg = train and cfg.use_neg

    groups: Dict[str, float] = {}

    # input projections: the first layer from the raw dims, the rest d -> d
    proj = _dense(b, lv, cfg.vid_dim, d) + _dense(b, lq, cfg.txt_dim, d)
    proj += (cfg.n_input_proj - 1) * (_dense(b, lv, d, d) + _dense(b, lq, d, d))
    groups["input_proj"] = proj

    # the dummy-token text encoder over nd + lq tokens
    attn, ffn = _encoder_layer(b, lk, d, ff)
    groups["dummy_encoder_attn"] = cfg.dummy_layers * attn
    groups["dummy_encoder_ffn"] = cfg.dummy_layers * ffn

    def trunk():
        # ACA (no projections): logits over every key, values without the
        # dummies, out projection and FFN
        aca = (
            2.0 * b * lv * lk * d
            + 2.0 * b * lv * (lk - nd) * d
            + _dense(b, lv, d, d)
        )
        aca_ffn = _dense(b, lv, d, ff) + _dense(b, lv, ff, d)
        enc_attn, enc_ffn = _encoder_layer(b, lv, d, ff)
        sal = (
            _dense(b, lv, d, d)   # saliency_proj1
            + _dense(b, 1, d, d)  # saliency_proj2 (the global vector)
            + 2.0 * b * lv * d    # the dot product
        )
        return {
            "t2v_attn": cfg.t2v_layers * aca,
            "t2v_ffn": cfg.t2v_layers * aca_ffn,
            "encoder_attn": cfg.enc_layers * enc_attn,
            "encoder_ffn": cfg.enc_layers * enc_ffn,
            "saliency": sal,
        }

    passes = 2 if with_neg else 1
    for key, val in trunk().items():
        groups[key] = passes * val

    # the temporal pyramid: each level chains k=2 s=2 convolutions from the
    # full-resolution input
    pyr = 0.0
    for s in (s for s in cfg.strides if lv >= s):
        l = lv
        for _ in range(int(math.log2(s))):
            l_out = (l - 2) // 2 + 1
            pyr += _conv1d(b, l_out, 2, d, d)
            l = l_out
    groups["pyramid_convs"] = pyr

    # the heads over the N pyramid points
    n_points = sum(pyramid_lengths(lv, cfg.strides))
    cls_convs, cls_mlp = _confidence_scorer(b, n_points, d, cfg.kernel_size,
                                            cfg.num_conv_layers, cfg.num_mlp_layers)
    # the class head (per level) and the confidence head (concatenated)
    # see the same N points
    groups["score_head_convs"] = 2 * cls_convs
    groups["score_head_mlp"] = 2 * cls_mlp
    groups["coord_head"] = (_conv1d(b, n_points, cfg.coord_kernel_size, d, d)
                            + _conv1d(b, n_points, cfg.coord_kernel_size, d, 2))
    groups["pooling"] = _dense(b, lq, d, 1) + 2.0 * b * lq * d

    fwd = sum(groups.values())
    return {"groups": groups, "fwd": fwd, "fwd_bwd": 3.0 * fwd if train else None,
            "n_points": n_points}


def mfu(flops: float, seconds: float, precision: str = "float32",
        peak_tflops: float = PEAK_BF16_TFLOPS,
        ceilings: Optional[Dict[str, float]] = None) -> Dict[str, float]:
    """Achieved TFLOP/s and model-FLOPs utilisation of `flops` of model work
    done in `seconds` on one card at the dial `precision`: `mfu` against
    `peak_tflops` (the bf16 peak), `mfu_effective` against the dial's
    measured ceiling in `ceilings` (default the eval skeleton's; pass
    MEASURED_TRAIN_SKELETON_TFLOPS for a train step), or its peak where
    none is measured. An unknown precision raises KeyError."""
    if precision not in H100_PEAK_TFLOPS:
        raise KeyError(f"unknown precision {precision!r}; expected one of "
                       f"{sorted(H100_PEAK_TFLOPS)}")
    achieved = flops / seconds / 1e12
    table = MEASURED_SKELETON_TFLOPS if ceilings is None else ceilings
    ceiling = table.get(precision, H100_PEAK_TFLOPS[precision])
    return {"achieved_tflops": achieved, "mfu": achieved / peak_tflops,
            "mfu_effective": achieved / ceiling}


def step_mfu(cfg, bsz: int, seconds: float, precision: str,
             train: bool) -> Optional[Dict[str, float]]:
    """`mfu` of one eval forward (train: train step) of ExperimentConfig
    `cfg`'s model at bsz rows of its padded shapes (max_q_l, max_v_l) in
    `seconds`, against the eval (train) ceilings; None for the FlashVTG_ms
    variant, which model_flops does not count."""
    if cfg.variant != "core":
        return None
    fl = model_flops(cfg.model_config(), bsz, cfg.max_q_l, cfg.max_v_l, train=train)
    return mfu(fl["fwd_bwd"] if train else fl["fwd"], seconds, precision,
               ceilings=MEASURED_TRAIN_SKELETON_TFLOPS if train else None)
