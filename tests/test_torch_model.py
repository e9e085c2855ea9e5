"""Port forward + decode vs the JAX FlashVTGModel, same weights, on the CPU.

Weights come from a jitted JAX init and cross over through
`flashvtg_tpu_torch.utils.convert.state_dict_from_jax`. Tolerances are the
ones the JAX package holds against the torch reference
(tests/test_model_parity.py): 2e-4 on saliency / attention channels, 3e-4 on
the per-point logits and coordinates, 2e-3 on decoded spans.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch_threads  # noqa: F401  (torch's share of the cores under xdist)
import torch

from flashvtg_tpu.models.flashvtg import FlashVTGModel as JaxModel
from flashvtg_tpu.models.flashvtg import decode_boundaries as jax_decode
from flashvtg_tpu.models.points import pyramid_masks_strict as jax_strict
from flashvtg_tpu.train.config import from_preset as jax_preset
from flashvtg_tpu.utils.torch_convert import export_state_dict
from flashvtg_tpu_torch.models.flashvtg import FlashVTGModel, decode_boundaries
from flashvtg_tpu_torch.models.points import pyramid_masks_strict
from flashvtg_tpu_torch.train.config import from_preset
from flashvtg_tpu_torch.utils.convert import state_dict_from_jax

# the `small` overrides of __graft_entry__._flagship
SMALL = dict(
    v_feat_dim=64, t_feat_dim=32, t2v_layers=2, enc_layers=2,
    dummy_layers=1, num_dummies=4, hidden_dim=64, dim_feedforward=128,
    num_mlp_layers=2, max_v_l=16, max_q_l=8,
)
B = 3


@pytest.fixture(scope="module")
def pair():
    jcfg = jax_preset("qvhighlights_slowclip", **SMALL)
    jmodel = JaxModel(jcfg.model_config())
    lv, lq = jcfg.max_v_l, jcfg.max_q_l
    params = jax.jit(jmodel.init, static_argnames="train")(
        {"params": jax.random.PRNGKey(0)},
        jnp.zeros((1, lq, jcfg.t_feat_dim)), jnp.ones((1, lq)),
        jnp.zeros((1, lv, jcfg.total_v_feat_dim)), jnp.ones((1, lv)),
        train=False,
    )
    params = jax.tree.map(np.asarray, params)
    apply = jax.jit(lambda p, *a: jmodel.apply(p, *a[:4], point_valid=a[4], train=False))

    cfg = from_preset("qvhighlights_slowclip", **SMALL)
    model = FlashVTGModel(cfg.model_config()).eval()
    model.load_state_dict(state_dict_from_jax(params, cfg.model_config()), strict=True)
    return jcfg, jmodel, params, apply, cfg, model


def _inputs(cfg, v_lens, q_lens, seed=0):
    rng = np.random.default_rng(seed)
    lv, lq = cfg.max_v_l, cfg.max_q_l
    src_txt = rng.standard_normal((B, lq, cfg.t_feat_dim), dtype=np.float32)
    src_vid = rng.standard_normal((B, lv, cfg.total_v_feat_dim), dtype=np.float32)
    txt_mask = (np.arange(lq)[None] < np.asarray(q_lens)[:, None]).astype(np.float32)
    vid_mask = (np.arange(lv)[None] < np.asarray(v_lens)[:, None]).astype(np.float32)
    # padded positions hold zeros, as the collator writes them
    return src_txt * txt_mask[..., None], txt_mask, src_vid * vid_mask[..., None], vid_mask


def test_state_dict_matches_export(pair):
    jcfg, _, params, _, cfg, model = pair
    ours = state_dict_from_jax(params, cfg.model_config())
    ref = export_state_dict(params, jcfg.model_config())
    assert list(ours) == list(ref)
    for k, v in ref.items():
        assert ours[k].dtype == torch.float32
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)
    assert set(model.state_dict()) == set(ref)


CASES = {
    "full_no_point_valid": ((16, 16, 16), (8, 8, 8), False),
    "full_point_valid": ((16, 16, 16), (8, 8, 8), True),
    "short_point_valid": ((16, 11, 5), (8, 5, 3), True),
    "short_no_point_valid": ((16, 11, 5), (8, 5, 3), False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_forward_parity(pair, case):
    jcfg, _, params, apply, cfg, model = pair
    v_lens, q_lens, use_pv = CASES[case]
    arrs = _inputs(cfg, v_lens, q_lens)
    strict = pyramid_masks_strict(np.asarray(v_lens), cfg.max_v_l, cfg.strides)[0]
    pv = strict if use_pv else None
    jout = apply(params, *map(jnp.asarray, arrs), None if pv is None else jnp.asarray(pv))
    with torch.no_grad():
        tout = model(*map(torch.from_numpy, arrs),
                     point_valid=None if pv is None else torch.from_numpy(pv))
    vm = arrs[3] > 0
    for key, atol in (("saliency_scores", 2e-4), ("t2vattnvalues", 2e-4)):
        np.testing.assert_allclose(
            tout[key].numpy()[vm], np.asarray(jout[key])[vm], atol=atol, err_msg=key
        )
    np.testing.assert_allclose(
        tout["attn_weights"].numpy(), np.asarray(jout["attn_weights"]), atol=2e-4
    )
    # every point's logit and coordinate, padded ones included: they are a
    # function of the same zeroed inputs on both sides
    for key in ("out_class", "out_coord"):
        np.testing.assert_allclose(
            tout[key].numpy(), np.asarray(jout[key]), atol=3e-4, rtol=1e-5,
            err_msg=key,
        )
    np.testing.assert_array_equal(tout["point"].numpy(), np.asarray(jout["point"]))


def test_strict_masks_match(pair):
    _, _, _, _, cfg, _ = pair
    lens = np.asarray([16, 11, 5, 1, 2, 8])
    ours = pyramid_masks_strict(lens, cfg.max_v_l, cfg.strides)
    ref = jax_strict(lens, cfg.max_v_l, cfg.strides)
    np.testing.assert_array_equal(ours[0], ref[0])
    np.testing.assert_array_equal(ours[1], ref[1])


def test_decode_boundaries_parity(pair):
    """Same head outputs into both decoders, with strict masks: every invalid
    point scores -1, so the ranking's tie order is exercised."""
    jcfg, _, params, apply, cfg, model = pair
    v_lens = (16, 11, 5)
    arrs = _inputs(cfg, v_lens, (8, 5, 3), seed=1)
    strict = pyramid_masks_strict(np.asarray(v_lens), cfg.max_v_l, cfg.strides)[0]
    jout = apply(params, *map(jnp.asarray, arrs), jnp.asarray(strict))
    oc, co, pt = (np.array(jout[k]) for k in ("out_class", "out_coord", "point"))
    js, jsc = jax_decode(jnp.asarray(oc), jnp.asarray(co), jnp.asarray(pt),
                         cfg.clip_length, point_valid=jnp.asarray(strict), top_k=50)
    ts, tsc = decode_boundaries(*map(torch.from_numpy, (oc, co, pt)), cfg.clip_length,
                                point_valid=torch.from_numpy(strict), top_k=50)
    assert ts.shape == js.shape and tsc.shape == jsc.shape
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=2e-3)
    np.testing.assert_allclose(tsc.numpy(), np.asarray(jsc), atol=2e-4)
    assert (tsc.numpy() == -1).sum() > 0  # the tie case was reached

    # and on each side's own forward
    with torch.no_grad():
        tout = model(*map(torch.from_numpy, arrs), point_valid=torch.from_numpy(strict))
    ts2, tsc2 = decode_boundaries(tout["out_class"], tout["out_coord"], tout["point"],
                                  cfg.clip_length, torch.from_numpy(strict), 50)
    np.testing.assert_allclose(ts2.numpy(), np.asarray(js), atol=2e-3)
    np.testing.assert_allclose(tsc2.numpy(), np.asarray(jsc), atol=2e-4)


def test_model_config_fields_mirror_jax():
    from flashvtg_tpu.models.flashvtg import ModelConfig as JaxModelConfig
    from flashvtg_tpu_torch.models.flashvtg import ModelConfig

    assert dataclasses.asdict(ModelConfig()) == dataclasses.asdict(JaxModelConfig())


def test_eval_forward_refuses_train_mode(pair):
    *_, cfg, model = pair
    arrs = _inputs(cfg, (16, 16, 16), (8, 8, 8))
    model.train()
    try:
        # train mode runs the train branch (negative pass included), never
        # the eval forward
        out = model(*map(torch.from_numpy, arrs))
        assert ("saliency_scores_neg" in out) == cfg.use_neg
    finally:
        model.eval()
    with torch.no_grad():
        assert "saliency_scores_neg" not in model(*map(torch.from_numpy, arrs))
