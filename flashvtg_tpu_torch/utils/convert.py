"""JAX parameter tree -> the port's state_dict; the reference `.ckpt` file.

The port's own copy of the inverse converters in
flashvtg_tpu/utils/torch_convert.py (`_inv_*`, `export_state_dict`,
`export_state_dict_ms`). The port's parameter names are the reference torch
names, so the result loads into FlashVTGModel (FlashVTGMSModel for the _ms
variant) with strict=True, as a reference `.ckpt`'s `model` dict does. Flax Dense kernels are (in, out) and become (out, in); Conv kernels
(k, in, out) become (out, in, k), and (out, in, 1, k) for the Conv2d heads;
PReLU's scalar becomes a (1,) weight. Dead reference parameters that the
JAX tree has no counterpart for (txt_position_embed when use_txt_pos is off)
get their torch init values. Leaves keep their dtype until the end, where
the whole state_dict is cast to `dtype` (float32 by default; float64 for a
float64 parameter or gradient tree).

The reference `.ckpt` (a torch.save dict): `load_torch_checkpoint` reads the
model weights of any such file, the reference trainer's, the JAX package's
export or the port's own checkpoint (counterpart of
flashvtg_tpu/utils/torch_convert.py:_lenient_torch_load and
load_torch_checkpoint); `save_torch_checkpoint` writes the weights under
`model` and, with the `module.` prefix, `state_dict`, as the JAX export does,
so the reference's inference.py loads it on either of its branches.
"""

from __future__ import annotations

import math
import os
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


def _inv_mha(out, prefix, p):
    """lgi.MHACore {q, k, v, out} -> nn.MultiheadAttention's packed in_proj."""
    out[f"{prefix}.in_proj_weight"] = np.concatenate(
        [_leaf(p[x]["kernel"]).T for x in ("q", "k", "v")], 0
    )
    out[f"{prefix}.in_proj_bias"] = np.concatenate([_leaf(p[x]["bias"]) for x in ("q", "k", "v")])
    _inv_dense(out, f"{prefix}.out_proj", p["out"])


def _inv_cross_attention_block(out, prefix, p):
    _inv_dense(out, f"{prefix}.q_proj", p["q_proj"])
    _inv_dense(out, f"{prefix}.kv_proj", p["kv_proj"])
    _inv_mha(out, f"{prefix}.att", p["att"])
    _inv_norm(out, f"{prefix}.norm", p["norm"])
    _inv_dense(out, f"{prefix}.linear", p["linear"])
    _inv_norm(out, f"{prefix}.norm1", p["norm1"])


def _inv_self_attention_block(out, prefix, p):
    for name in ("q_proj", "k_proj", "v_proj"):
        _inv_dense(out, f"{prefix}.{name}", p[name])
    _inv_mha(out, f"{prefix}.att", p["att"])
    _inv_norm(out, f"{prefix}.norm", p["norm"])


def _inv_phrase_generate(out, prefix, p, num_layers):
    _inv_dense(out, f"{prefix}.word_proj", p["word_proj"])
    _inv_dense(out, f"{prefix}.video_proj", p["video_proj"])
    out[f"{prefix}.learnable_phrase"] = _leaf(p["learnable_phrase"])
    for i in range(num_layers):
        _inv_cross_attention_block(out, f"{prefix}.phrase_att.{i}", p[f"att{i}"])


def _inv_local_context(out, prefix, p):
    _inv_dense(out, f"{prefix}.phrase_proj.0", p["phrase_proj1"])
    _inv_dense(out, f"{prefix}.phrase_proj.2", p["phrase_proj2"])
    for k in (1, 3, 5):
        out[f"{prefix}.kernel_params.k{k}"] = _leaf(p[f"kernel_k{k}"])
    _inv_dense(out, f"{prefix}.linear_out", p["linear_out"])
    _inv_norm(out, f"{prefix}.norm", p["norm"])


def _inv_phrase_context(out, prefix, p, num_layers):
    for name in ("fc_1", "fc_2", "fc_3"):
        _inv_dense(out, f"{prefix}.product.{name}", p["product"][name])
    _inv_norm(out, f"{prefix}.product.norm", p["product"]["norm"])
    _inv_norm(out, f"{prefix}.product.norm1", p["product"]["norm1"])
    for i in range(num_layers):
        lay, pre = p[f"layer{i}"], f"{prefix}.layers.{i}"
        _inv_self_attention_block(out, f"{pre}.t_att", lay["t_att"])
        _inv_dense(out, f"{pre}.fc_t.0", lay["fc_t"])
        _inv_norm(out, f"{pre}.norm_t", lay["norm_t"])
    _inv_local_context(out, f"{prefix}.local_context", p["local_context"])


def _inv_tsa(out, prefix, p, num_layers, d):
    """TSA layers; each layer's unread reference `norm1` at its init values."""
    for i in range(num_layers):
        lay, pre = p[f"layer{i}"], f"{prefix}.layers.{i}"
        _inv_self_attention_block(out, f"{pre}.t_att", lay["t_att"])
        _inv_dense(out, f"{pre}.linear", lay["linear"])
        _inv_norm(out, f"{pre}.norm", lay["norm"])
        out[f"{pre}.norm1.weight"] = np.ones(d, np.float32)
        out[f"{pre}.norm1.bias"] = np.zeros(d, np.float32)


def export_state_dict_ms(params, cfg, dtype=np.float32) -> Dict[str, np.ndarray]:
    """JAX FlashVTG_ms parameter tree (numpy leaves) -> reference-named numpy
    state_dict in `dtype` (a copy of the JAX export_state_dict_ms, in its
    key order). `cfg` is an MSModelConfig of either package. The reference
    parameters no forward reads are synthesised at their init values
    (pooling.att, t_sa.layers.i.norm1, transformer.fuse_proj,
    txt_position_embed). Under use_eos the tree's `eos_query` comes last:
    the JAX export does not write it."""
    p = params.get("params", params)
    out: Dict[str, np.ndarray] = {}
    d = cfg.hidden_dim
    out["dummy_rep_token"] = _leaf(p["dummy_token"])
    out["dummy_rep_pos"] = _leaf(p["dummy_pos"])
    out["coef"] = _leaf(p["coef"])
    _inv_input_proj(out, "input_vid_proj", p["vid_proj"], cfg.n_input_proj)
    _inv_input_proj(out, "input_txt_proj", p["txt_proj"], cfg.n_input_proj)
    _inv_input_proj(out, "input_word_proj", p["word_proj"], cfg.n_input_proj)
    out["token_type_embeddings.weight"] = _leaf(p["token_type"]["embedding"])
    _inv_encoder(out, "txtproj_encoder", p["dummy_encoder"], cfg.dummy_layers)
    _inv_encoder(
        out, "transformer.t2v_encoder", p["t2v_encoder"], cfg.t2v_layers,
        layer_fn=_inv_t2v_layer,
    )
    _inv_encoder(out, "transformer.encoder", p["encoder"], cfg.enc_layers)
    _inv_pyramid(out, p.get("pyramid", {}), cfg.strides)
    out["pooling.att.weight"] = np.zeros((1, d), np.float32)
    _inv_confidence_scorer(
        out, "class_head", p["class_head"], cfg.num_conv_layers, cfg.num_mlp_layers
    )
    _inv_coord_head(out, p["coord_head"])
    _inv_dense(out, "saliency_proj.proj1", p["saliency_proj"]["proj1"])
    _inv_dense(out, "saliency_proj.proj2", p["saliency_proj"]["proj2"])
    _inv_phrase_generate(out, "phrase_generate", p["phrase_generate"], cfg.phrase_layers)
    _inv_phrase_context(out, "phrase_context", p["phrase_context"], cfg.context_layers)
    _inv_tsa(out, "t_sa", p["t_sa"], cfg.t_sa_layers, d)
    out["transformer.fuse_proj.0.weight"] = np.zeros((d, 2 * d), np.float32)
    out["transformer.fuse_proj.0.bias"] = np.zeros(d, np.float32)
    out["transformer.fuse_proj.1.weight"] = np.ones(d, np.float32)
    out["transformer.fuse_proj.1.bias"] = np.zeros(d, np.float32)
    _inv_txt_position_embed(out, p, cfg)
    if "eos_query" in p:
        out["eos_query"] = _leaf(p["eos_query"])
    return {k: np.asarray(v, dtype=dtype) for k, v in out.items()}


def state_dict_from_jax(params, cfg, dtype=np.float32) -> Dict[str, torch.Tensor]:
    """The port's state_dict (CPU tensors in `dtype`) from a JAX parameter
    tree whose leaves are numpy arrays; load it with
    load_state_dict(strict=True). A tree of gradients converts the same way:
    the mapping only transposes, slices and reshapes."""
    return {
        k: torch.tensor(v) for k, v in export_state_dict(params, cfg, dtype).items()
    }


def state_dict_from_jax_ms(params, cfg, dtype=np.float32) -> Dict[str, torch.Tensor]:
    """state_dict_from_jax for a JAX FlashVTG_ms tree: loads into
    FlashVTGMSModel with strict=True."""
    return {
        k: torch.tensor(v) for k, v in export_state_dict_ms(params, cfg, dtype).items()
    }


def checkpoint_variant(state_dict) -> str:
    """"ms" for FlashVTG_ms weights (the phrase-pipeline keys, as the JAX
    load_torch_checkpoint detects them), else "core"."""
    return "ms" if any(k.startswith("phrase_generate.") for k in state_dict) else "core"


def lenient_torch_load(path, map_location="cpu"):
    """torch.load that tolerates unimportable classes in a checkpoint's
    extras: the reference trainer pickles its whole opt Namespace (with an
    nncore Config) into every checkpoint, and only the tensors matter. A
    class the unpickler cannot import becomes a dummy dict subclass.
    Unpickling runs code: load only checkpoints from a trusted source."""
    import pickle
    import types

    try:
        return torch.load(path, map_location=map_location, weights_only=False)
    except (ModuleNotFoundError, AttributeError):
        pass

    class _LenientUnpickler(pickle.Unpickler):
        def find_class(self, mod_name, name):
            try:
                return super().find_class(mod_name, name)
            except (ModuleNotFoundError, AttributeError):
                return type(name, (dict,), {"__setstate__": lambda s, st: None})

    shim = types.ModuleType("flashvtg_tpu_torch_lenient_pickle")
    shim.Unpickler = _LenientUnpickler
    shim.load = pickle.load
    shim.dump = pickle.dump
    shim.dumps = pickle.dumps
    shim.HIGHEST_PROTOCOL = pickle.HIGHEST_PROTOCOL
    return torch.load(path, map_location=map_location, weights_only=False,
                      pickle_module=shim)


def model_state(ckpt: dict) -> Dict[str, torch.Tensor]:
    """The model weights of a loaded `.ckpt` dict (`model`, else
    `state_dict`, else the dict itself), `module.` prefixes stripped."""
    sd = ckpt.get("model", ckpt.get("state_dict", ckpt))
    return {k.removeprefix("module."): v for k, v in sd.items()}


def load_torch_checkpoint(path, map_location="cpu") -> Dict[str, torch.Tensor]:
    """The model weights of a reference-format `.ckpt` file on
    `map_location`, ready for load_state_dict(strict=True)."""
    return model_state(lenient_torch_load(path, map_location))


def save_torch_checkpoint(path, state_dict: Dict[str, torch.Tensor], epoch: int = -1,
                          **extra) -> None:
    """Write a reference-format `.ckpt`: the weights (on the CPU) under
    `model` and under `state_dict` with the `module.` prefix, `epoch`, and
    `extra` entries (the train loop's optimizer, lr_scheduler, opt). The file
    is written beside its target and renamed, so a reader never sees half of
    it."""
    tensors = {k: v.detach().cpu() for k, v in state_dict.items()}
    payload = {
        "model": tensors,
        "state_dict": {f"module.{k}": v for k, v in tensors.items()},
        "epoch": epoch,
        **extra,
    }
    tmp = f"{path}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
