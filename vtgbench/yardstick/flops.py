"""Analytic FLOP count of the FlashVTG forward and train step, and the
whole step's share of the card's peak.

A frozen copy of the count the program documents (matmuls and convolutions
only, a multiply-add 2 FLOPs; the train step 3x the forward's products:
each product's backward is two of its shape). `model_flops` takes a
ModelConfig-like object (attributes hidden_dim, dim_feedforward,
num_dummies, vid_dim, txt_dim, n_input_proj, dummy_layers, t2v_layers,
enc_layers, strides, kernel_size, num_conv_layers, num_mlp_layers,
coord_kernel_size, use_neg). `rows_flops` evaluates it one row at a time at
that row's valid clips and tokens and sums: the work these inputs need,
whatever the program does with padding.
"""

from __future__ import annotations

import math
from types import SimpleNamespace
from typing import Dict, Iterable, Optional

PEAK_TFLOPS = 989.0  # H100 SXM dense bf16, the peak of every dial here


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


def model_config(cfg: dict) -> SimpleNamespace:
    """The count's view of a configuration file (video_tef adds 2 channels)."""
    keys = ("hidden_dim", "dim_feedforward", "num_dummies", "n_input_proj", "dummy_layers",
            "t2v_layers", "enc_layers", "kernel_size", "num_conv_layers", "num_mlp_layers",
            "coord_kernel_size", "use_neg")
    ns = SimpleNamespace(**{k: cfg[k] for k in keys})
    ns.vid_dim = cfg["v_feat_dim"] + 2
    ns.txt_dim = cfg["t_feat_dim"]
    ns.strides = tuple(cfg["strides"])
    return ns


def rows_flops(cfg: dict, lengths: Iterable, train: bool) -> float:
    """FLOPs of the rows (valid clips, valid tokens): the train step's
    (forward and backward) or the eval forward's, summed row by row."""
    mc = model_config(cfg)
    key = "fwd_bwd" if train else "fwd"
    return sum(model_flops(mc, 1, int(lq), int(lv), train=train)[key] for lv, lq in lengths)
