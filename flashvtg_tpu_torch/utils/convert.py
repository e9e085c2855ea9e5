"""JAX parameter tree -> the port's state_dict.

The port's own copy of the inverse converter in
flashvtg_tpu/utils/torch_convert.py (`_inv_*`, `export_state_dict`). The
port's parameter names are the reference torch names, so the result loads
into FlashVTGModel with strict=True, as a reference `.ckpt`'s `model` dict
does. Flax Dense kernels are (in, out) and become (out, in); Conv kernels
(k, in, out) become (out, in, k), and (out, in, 1, k) for the Conv2d heads;
PReLU's scalar becomes a (1,) weight. Dead reference parameters that the
JAX tree has no counterpart for (txt_position_embed when use_txt_pos is off)
get their torch init values. Leaves keep their dtype until the end, where
the whole state_dict is cast to `dtype` (float32 by default; float64 for a
float64 parameter or gradient tree).
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch


def _leaf(a):
    """A leaf as a numpy array (its dtype kept; export_state_dict casts)."""
    return np.asarray(a)


def _inv_dense(out, prefix, p):
    out[f"{prefix}.weight"] = _leaf(p["kernel"]).T
    out[f"{prefix}.bias"] = _leaf(p["bias"])


def _inv_norm(out, prefix, p):
    out[f"{prefix}.weight"] = _leaf(p["scale"])
    out[f"{prefix}.bias"] = _leaf(p["bias"])


def _inv_ffn(out, prefix, p):
    _inv_dense(out, f"{prefix}.linear1", p["linear1"])
    _inv_dense(out, f"{prefix}.linear2", p["linear2"])
    out[f"{prefix}.activation.weight"] = _leaf(p["act"]["alpha"]).reshape(1)


def _inv_self_attention(out, prefix, p):
    """q/k/v/out Dense -> nn.MultiheadAttention's packed in_proj."""
    out[f"{prefix}.in_proj_weight"] = np.concatenate(
        [_leaf(p[x]["kernel"]).T for x in ("q_proj", "k_proj", "v_proj")], 0
    )
    out[f"{prefix}.in_proj_bias"] = np.concatenate(
        [_leaf(p[x]["bias"]) for x in ("q_proj", "k_proj", "v_proj")]
    )
    _inv_dense(out, f"{prefix}.out_proj", p["out_proj"])


def _inv_encoder_layer(out, prefix, p):
    _inv_self_attention(out, f"{prefix}.self_attn", p["attn"])
    _inv_ffn(out, prefix, p["ffn"])
    _inv_norm(out, f"{prefix}.norm1", p["norm1"])
    _inv_norm(out, f"{prefix}.norm2", p["norm2"])


def _inv_t2v_layer(out, prefix, p):
    # the ACA attention has only an out projection
    _inv_dense(out, f"{prefix}.self_attn.out_proj", p["attn"]["out_proj"])
    _inv_ffn(out, prefix, p["ffn"])
    _inv_norm(out, f"{prefix}.norm1", p["norm1"])
    _inv_norm(out, f"{prefix}.norm2", p["norm2"])


def _inv_encoder(out, prefix, p, num_layers, layer_fn=_inv_encoder_layer):
    for i in range(num_layers):
        layer_fn(out, f"{prefix}.layers.{i}", p[f"layer{i}"])


def _inv_input_proj(out, prefix, p, n_layers):
    for i in range(n_layers):
        _inv_norm(out, f"{prefix}.{i}.LayerNorm", p[f"layer{i}"]["norm"])
        _inv_dense(out, f"{prefix}.{i}.net.1", p[f"layer{i}"]["dense"])


def _inv_pyramid(out, p, strides):
    for j, s in enumerate(strides):
        pw = int(math.log2(s))
        if pw == 0:
            continue  # the stride-1 level is a parameterless ReLU
        level = p[f"level{s}"]
        for i in range(pw):
            base = 5 * i
            out[f"pyramid.blocks.{j}.{base + 1}.weight"] = _leaf(
                level[f"conv{i}"]["kernel"]
            ).transpose(2, 1, 0)
            out[f"pyramid.blocks.{j}.{base + 1}.bias"] = _leaf(level[f"conv{i}"]["bias"])
            _inv_norm(out, f"pyramid.blocks.{j}.{base + 3}", level[f"norm{i}"])


def _inv_confidence_scorer(out, prefix, p, num_conv_layers, num_mlp_layers):
    for i in range(num_conv_layers):
        out[f"{prefix}.convs.{i}.weight"] = _leaf(
            p[f"conv{i}"]["kernel"]
        ).transpose(2, 1, 0)[:, :, None, :]
        out[f"{prefix}.convs.{i}.bias"] = _leaf(p[f"conv{i}"]["bias"])
    for i in range(num_mlp_layers):
        _inv_dense(out, f"{prefix}.fc.layers.{i}", p["mlp"][f"layer{i}"])


def _inv_coord_head(out, p):
    for src, dst in (("conv1", "module.1"), ("conv2", "module.3")):
        out[f"coord_head.{dst}.weight"] = _leaf(p[src]["kernel"]).transpose(2, 1, 0)
        out[f"coord_head.{dst}.bias"] = _leaf(p[src]["bias"])


def _inv_txt_position_embed(out, p, cfg):
    if "txt_pos" in p:
        out["txt_position_embed.position_embeddings.weight"] = _leaf(
            p["txt_pos"]["positions"]["embedding"]
        )
        _inv_norm(out, "txt_position_embed.LayerNorm", p["txt_pos"]["norm"])
    else:
        d = cfg.hidden_dim
        out["txt_position_embed.position_embeddings.weight"] = np.zeros(
            (cfg.max_q_l, d), np.float32
        )
        out["txt_position_embed.LayerNorm.weight"] = np.ones(d, np.float32)
        out["txt_position_embed.LayerNorm.bias"] = np.zeros(d, np.float32)


def export_state_dict(params, cfg, dtype=np.float32) -> Dict[str, np.ndarray]:
    """JAX FlashVTG parameter tree (numpy leaves) -> reference-named numpy
    state_dict in `dtype`. `cfg` is the port's (or the JAX) ModelConfig."""
    p = params.get("params", params)
    out: Dict[str, np.ndarray] = {}
    out["dummy_rep_token"] = _leaf(p["dummy_token"])
    out["dummy_rep_pos"] = _leaf(p["dummy_pos"])
    out["coef"] = _leaf(p["coef"])
    out["x"] = _leaf(p["blend"]).reshape(())
    _inv_input_proj(out, "input_vid_proj", p["vid_proj"], cfg.n_input_proj)
    _inv_input_proj(out, "input_txt_proj", p["txt_proj"], cfg.n_input_proj)
    out["token_type_embeddings.weight"] = _leaf(p["token_type"]["embedding"])
    _inv_encoder(out, "txtproj_encoder", p["dummy_encoder"], cfg.dummy_layers)
    _inv_encoder(
        out, "transformer.t2v_encoder", p["t2v_encoder"], cfg.t2v_layers,
        layer_fn=_inv_t2v_layer,
    )
    _inv_encoder(out, "transformer.encoder", p["encoder"], cfg.enc_layers)
    _inv_dense(out, "saliency_proj1", p["saliency_proj1"])
    _inv_dense(out, "saliency_proj2", p["saliency_proj2"])
    _inv_pyramid(out, p.get("pyramid", {}), cfg.strides)
    out["pooling.att.weight"] = _leaf(p["pooling"]["att"]["kernel"]).T
    _inv_confidence_scorer(
        out, "class_head", p["class_head"], cfg.num_conv_layers, cfg.num_mlp_layers
    )
    _inv_confidence_scorer(
        out, "conf_head", p["conf_head"], cfg.num_conv_layers, cfg.num_mlp_layers
    )
    _inv_coord_head(out, p["coord_head"])
    _inv_txt_position_embed(out, p, cfg)
    return {k: np.asarray(v, dtype=dtype) for k, v in out.items()}


def state_dict_from_jax(params, cfg, dtype=np.float32) -> Dict[str, torch.Tensor]:
    """The port's state_dict (CPU tensors in `dtype`) from a JAX parameter
    tree whose leaves are numpy arrays; load it with
    load_state_dict(strict=True). A tree of gradients converts the same way:
    the mapping only transposes, slices and reshapes."""
    return {
        k: torch.tensor(v) for k, v in export_state_dict(params, cfg, dtype).items()
    }
