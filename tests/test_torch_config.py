"""Every preset's model and eval fields in the port equal the JAX package's."""

import dataclasses

import pytest

from flashvtg_tpu.train.config import PRESETS as JAX_PRESETS
from flashvtg_tpu.train.config import from_preset as jax_preset
from flashvtg_tpu_torch.train.config import PRESETS, ExperimentConfig, from_preset


def test_preset_table_is_a_copy():
    assert PRESETS == JAX_PRESETS


@pytest.mark.parametrize("name", sorted(JAX_PRESETS))
def test_preset_fields_match_jax(name):
    ours, ref = from_preset(name), jax_preset(name)
    for f in dataclasses.fields(ExperimentConfig):
        assert getattr(ours, f.name) == getattr(ref, f.name), f.name
    assert ours.total_v_feat_dim == ref.total_v_feat_dim
    assert dataclasses.asdict(ours.model_config()) == dataclasses.asdict(
        ref.model_config()
    )


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
    with pytest.raises(TypeError):
        from_preset("qvhighlights_slowclip", max_es_cnt=5)  # early stop: not ported
    with pytest.raises(KeyError):
        from_preset("no_such_preset")
