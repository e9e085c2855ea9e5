"""Every preset's fields in the port equal the JAX package's, but the
defaults the port states in PORT_DEFAULTS (none since the precision dials
were ported: train_precision defaults to bfloat16 on both sides); the
FlashVTG_ms presets' model and loss configs equal the JAX ones; and
check_ported raises for an unknown value of a field with a fixed set (a
precision, the variant) and for no ported feature (debug_nans and
profile_dir among them)."""

import dataclasses

import pytest

from flashvtg_tpu.train.config import PRESETS as JAX_PRESETS
from flashvtg_tpu.train.config import from_preset as jax_preset
from flashvtg_tpu_torch.losses import LossConfig
from flashvtg_tpu_torch.models import ModelConfig
from flashvtg_tpu_torch.train.config import PRESETS, ExperimentConfig, from_preset

# fields whose default differs from the JAX package's: none
PORT_DEFAULTS = {}


def test_preset_table_is_a_copy():
    assert PRESETS == JAX_PRESETS


@pytest.mark.parametrize("name", sorted(JAX_PRESETS))
def test_preset_fields_match_jax(name):
    ours, ref = from_preset(name), jax_preset(name)
    for f in dataclasses.fields(ExperimentConfig):
        want = PORT_DEFAULTS.get(f.name, getattr(ref, f.name))
        assert getattr(ours, f.name) == want, f.name
    assert ours.total_v_feat_dim == ref.total_v_feat_dim
    # the architecture the JAX build_model builds for the preset's variant
    want = ref.ms_model_config() if ref.variant == "ms" else ref.model_config()
    assert dataclasses.asdict(ours.model_config()) == dataclasses.asdict(want)


def test_flagship_shapes():
    cfg = from_preset("qvhighlights_slowclip")
    m = cfg.model_config()
    assert (m.vid_dim, m.txt_dim, m.hidden_dim, m.nheads) == (2818, 512, 256, 8)
    assert (m.num_dummies, m.dummy_layers, m.t2v_layers, m.enc_layers) == (10, 2, 6, 3)
    assert (cfg.max_v_l, cfg.max_q_l, m.strides, m.kernel_size) == (75, 32, (1, 2, 4, 8), 5)
    assert cfg.eval_bsz == 256 and m.hidden_dim // m.nheads == 32


def test_overrides_and_unknown_keys():
    assert from_preset("qvhighlights_slowclip", eval_bsz=8).eval_bsz == 8
    assert from_preset("qvhighlights_slowclip", lr=1e-3).lr == 1e-3  # a train-step field
    assert from_preset("qvhighlights_slowclip", max_es_cnt=5).max_es_cnt == 5  # early stop
    with pytest.raises(TypeError):
        from_preset("qvhighlights_slowclip", no_such_field=5)
    with pytest.raises(KeyError):
        from_preset("no_such_preset")


@pytest.mark.parametrize("name", ["tvsum_ms", "youtube_uni_ms"])
def test_ms_presets_match_jax(name):
    ours, ref = from_preset(name, use_dfl=True, use_eos=True), jax_preset(
        name, use_dfl=True, use_eos=True)
    assert ours.variant == "ms"
    assert dataclasses.asdict(ours.model_config()) == dataclasses.asdict(
        ref.ms_model_config())
    assert dataclasses.asdict(ours.loss_config()) == dataclasses.asdict(
        ref.ms_loss_config())
    # the core preset of the same set keeps the core model and criterion
    core, ref_core = from_preset(name.removesuffix("_ms")), jax_preset(name.removesuffix("_ms"))
    assert type(core.model_config()) is ModelConfig and type(core.loss_config()) is LossConfig
    assert dataclasses.asdict(core.model_config()) == dataclasses.asdict(ref_core.model_config())
    assert dataclasses.asdict(core.loss_config()) == dataclasses.asdict(ref_core.loss_config())


CHECK_CASES = {
    "ms": (dict(variant="ms"), None),
    "ms_dfl_eos": (dict(variant="ms", use_dfl=True, use_eos=True), None),
    "eos_first": (dict(eos_first=True), None),
    "eval_bfloat16": (dict(eval_precision="bfloat16"), None),
    "train_tf32_bf16_wire": (dict(train_precision="tensorfloat32", transfer_dtype="bfloat16",
                                  serving=True), None),
    "unknown_eval_precision": (dict(eval_precision="float16"), "unknown eval_precision"),
    "unknown_train_precision": (dict(train_precision="highest"), "unknown train_precision"),
    "unknown_transfer_dtype": (dict(transfer_dtype="float16"), "unknown transfer_dtype"),
    "device_feed_on": (dict(device_feed="on"), None),
    "profile_dir": (dict(profile_dir="prof"), None),
    "debug_nans": (dict(debug_nans=True), None),
    "unknown_variant": (dict(variant="xl"), "unknown variant"),
}


@pytest.mark.parametrize("case", list(CHECK_CASES))
def test_check_ported(case):
    fields, raises = CHECK_CASES[case]
    cfg = from_preset("tvsum_ms", **fields)
    if raises is None:
        cfg.check_ported(train=True)
    else:
        with pytest.raises((NotImplementedError, ValueError), match=raises):
            cfg.check_ported(train=True)
