"""The port's FlashVTG_ms variant vs the JAX package, on the CPU.

Weights come from a JAX init and cross over through
`utils.convert.state_dict_from_jax_ms` with strict=True; inputs from a numpy
seed, with padded text and video rows. At small widths (one layer of each
stack, 2 phrases of rank 2):
  * the state_dict equals the JAX export_state_dict_ms, key for key (under
    use_eos the port adds `eos_query`, which the JAX export does not write);
  * the eval forward with the negative pass (`force_neg`), for use_dfl x
    use_eos on the flagship's strides (1, 2, 4, 8): every output within
    2e-4 (saliency, attention, similarity, phrase outputs) / 3e-4 (logits,
    coordinates), the tolerances of tests/test_torch_model.py;
  * decode_boundaries_dfl on the same head outputs: spans within 2e-3;
  * the train-mode outputs with every dropout at 0, negative pass included;
  * compute_losses_ms in float64 on the same random outputs, each key
    within 1e-9 relative, distribution_focal_loss and quality_focal_loss
    included;
  * one float64 train step of tvsum_ms (Lv 150 > 128: the JAX encoder's
    chunked branch against the port's flash Function) and of the flagship
    with variant=ms, use_dfl and use_eos: losses within 1e-9 relative,
    gradients and updated parameters within 1e-8 of each leaf's largest
    value, as tests/test_torch_train.py holds the core model (both sides
    read float64 position embeddings: XLA's and torch's f32 sin / cos
    differ by an ulp);
  * run_hl_inference of tvsum_ms and youtube_uni_ms: saliency within 3e-4,
    mAP within 2e-4; run_mr_inference of the flagship with use_dfl:
    submissions within 2e-3, brief metrics within 0.02 points
    (`__graft_entry__.py:172-197`), eval losses within rtol 1e-5;
  * the eos_first text layout: the same arrays as the JAX dataset's;
  * train() of tvsum_ms from one exported JAX init against JAX train():
    step losses within rtol 1e-4.
"""

import dataclasses
import functools
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch_threads  # noqa: F401  (torch's share of the cores under xdist)
import torch

from flashvtg_tpu.data.dataset import DataConfig as JaxDataConfig
from flashvtg_tpu.data.dataset import VTGDataset as JaxDataset
from flashvtg_tpu.eval import hl as jax_hl
from flashvtg_tpu.eval.metrics import eval_submission as jax_eval
from flashvtg_tpu.losses import basic as jax_basic
from flashvtg_tpu.losses.criterion_ms import compute_losses_ms as jax_compute_losses_ms
from flashvtg_tpu.losses.criterion_ms import weighted_total_ms as jax_weighted_total_ms
from flashvtg_tpu.models import flashvtg_ms as jax_ms
from flashvtg_tpu.models import lgi as jax_lgi
from flashvtg_tpu.models.points import generate_points
from flashvtg_tpu.parallel.mesh import make_mesh
from flashvtg_tpu.train import config as jax_config
from flashvtg_tpu.train import infer as jax_infer
from flashvtg_tpu.train.config import from_preset as jax_preset
from flashvtg_tpu.train.loop import _dataset_cfg
from flashvtg_tpu.train.loop import make_optimizer as jax_make_optimizer
from flashvtg_tpu.train.loop import train as jax_train
from flashvtg_tpu.utils.torch_convert import export_state_dict_ms
from flashvtg_tpu.utils.torch_convert import save_torch_checkpoint as jax_save_torch
from flashvtg_tpu_torch.data.collate import Collator
from flashvtg_tpu_torch.data.dataset import DataConfig, VTGDataset
from flashvtg_tpu_torch.eval.metrics import eval_submission
from flashvtg_tpu_torch.losses import basic, declared_loss_keys
from flashvtg_tpu_torch.losses.criterion_ms import compute_losses_ms, weighted_total_ms
from flashvtg_tpu_torch.models import flashvtg_ms as port_ms
from flashvtg_tpu_torch.models import lgi as port_lgi
from flashvtg_tpu_torch.entry import entry
from flashvtg_tpu_torch.models.flashvtg import FlashVTGModel
from flashvtg_tpu_torch.models.flashvtg_ms import FlashVTGMSModel, decode_boundaries_dfl
from flashvtg_tpu_torch.models.points import pyramid_masks_strict
from flashvtg_tpu_torch.train import config as port_config
from flashvtg_tpu_torch.train.config import from_preset
from flashvtg_tpu_torch.train.infer import eval_data_config, run_hl_inference, run_mr_inference
from flashvtg_tpu_torch.train.loop import (
    make_optimizer,
    make_train_step,
    place_batch,
    train,
    train_data_config,
)
from flashvtg_tpu_torch.utils.convert import state_dict_from_jax_ms
from flashvtg_tpu_torch.utils.synthetic import (
    make_synthetic_qvh,
    make_synthetic_tvsum,
    make_synthetic_youtube,
)

MS = dict(
    hidden_dim=32, nheads=4, dim_feedforward=48, num_dummies=2, t2v_layers=1, enc_layers=1,
    dummy_layers=1, num_conv_layers=1, num_mlp_layers=2, num_phrase=2, phrase_layers=1,
    context_layers=1, rank=2, t_sa=1,
)
# the flagship's strides and heads at small widths, and tvsum_ms at Lv 150
MR = dict(MS, v_feat_dim=40, t_feat_dim=24, max_v_l=24, max_q_l=8, variant="ms")
HD = dict(MS, v_feat_dim=48, t_feat_dim=32, max_v_l=150, max_q_l=10, attn_chunk=128)
DOMAIN = {"tvsum_ms": "BK", "youtube_uni_ms": "dog"}
NO_DROPOUT = dict(dropout=0.0, input_dropout=0.0)
B = 3
V_LENS, Q_LENS = (24, 17, 6), (8, 5, 3)
# reference parameters that no forward reads (no JAX counterpart)
DEAD = ("txt_position_embed.", "transformer.fuse_proj.", "pooling.")


def _dead(name):
    return name.startswith(DEAD) or (name.startswith("t_sa.layers.") and ".norm1." in name)


def _jax_init(jcfg, key=0):
    jmodel = jcfg.build_model()
    lv, lq = jcfg.max_v_l, jcfg.max_q_l
    params = jax.jit(jmodel.init, static_argnames="train")(
        {"params": jax.random.PRNGKey(key)},
        jnp.zeros((1, lq, jcfg.t_feat_dim)), jnp.ones((1, lq)),
        jnp.zeros((1, lv, jcfg.total_v_feat_dim)), jnp.ones((1, lv)), train=False,
    )
    return jmodel, jax.tree.map(np.asarray, params)


def _port_model(cfg, params, dtype=np.float32):
    mcfg = cfg.model_config()
    model = FlashVTGMSModel(mcfg)
    if dtype == np.float64:
        model = model.double()
    model.load_state_dict(state_dict_from_jax_ms(params, mcfg, dtype), strict=True)
    return model.eval()


def _inputs(cfg, seed=0):
    rng = np.random.default_rng(seed)
    lv, lq = cfg.max_v_l, cfg.max_q_l
    txt_mask = (np.arange(lq)[None] < np.asarray(Q_LENS)[:, None]).astype(np.float32)
    vid_mask = (np.arange(lv)[None] < np.asarray(V_LENS)[:, None]).astype(np.float32)
    src_txt = rng.standard_normal((B, lq, cfg.t_feat_dim), dtype=np.float32) * txt_mask[..., None]
    src_vid = (rng.standard_normal((B, lv, cfg.total_v_feat_dim), dtype=np.float32)
               * vid_mask[..., None])
    strict = pyramid_masks_strict(np.asarray(V_LENS), lv, cfg.strides)[0]
    return (src_txt, txt_mask, src_vid, vid_mask), strict


FLAGS = {"l1": dict(use_dfl=False, use_eos=False), "l1_eos": dict(use_dfl=False, use_eos=True),
         "dfl": dict(use_dfl=True, use_eos=False), "dfl_eos": dict(use_dfl=True, use_eos=True)}


@functools.lru_cache(maxsize=None)
def _pair(name):
    flags = FLAGS[name]
    jcfg = jax_preset("qvhighlights_slowclip", **MR, **flags)
    cfg = from_preset("qvhighlights_slowclip", **MR, **flags)
    jmodel, params = _jax_init(jcfg, key=2)
    return dict(flags=flags, jcfg=jcfg, jmodel=jmodel, params=params, cfg=cfg,
                model=_port_model(cfg, params))


@pytest.fixture(scope="module", params=sorted(FLAGS))
def pair(request):
    return _pair(request.param)


def test_state_dict_matches_export(pair):
    params, cfg, jcfg = pair["params"], pair["cfg"], pair["jcfg"]
    ours = state_dict_from_jax_ms(params, cfg.model_config())
    ref = export_state_dict_ms(params, jcfg.ms_model_config())
    extra = ["eos_query"] if pair["flags"]["use_eos"] else []
    assert list(ours) == list(ref) + extra
    for k, v in ref.items():
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)
    assert set(pair["model"].state_dict()) == set(ref) | set(extra)
    assert dataclasses.asdict(cfg.model_config()) == dataclasses.asdict(
        jcfg.ms_model_config())


def _compare_outputs(tout, jout, vid_mask, keys):
    vm = vid_mask > 0
    for key in keys:
        t, j = tout[key], jout[key]
        if isinstance(t, (list, tuple)):
            assert len(t) == len(j), key
            for a, b in zip(t, j):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=key)
            continue
        t, j = t.numpy(), np.asarray(j)
        assert t.shape == j.shape, key
        if key in ("saliency_scores", "sim_score"):
            t, j = t[vm], j[vm]  # padded clips are not read
        atol, rtol = (3e-4, 1e-5) if key in ("out_class", "out_coord") else (2e-4, 0)
        np.testing.assert_allclose(t, j, atol=atol, rtol=rtol, err_msg=key)


OUT_KEYS = ("saliency_scores", "t2vattnvalues", "attn_weights", "sim_score", "pymid_msk",
            "out_class", "out_coord", "point", "word_video_attn", "slot_att", "gate",
            "context_agg", "context_emb", "context_refine", "vid_emb", "dummy_tokens",
            "saliency_scores_neg", "t2vattnvalues_neg", "real_neg_mask")


def test_eval_forward_matches_jax(pair):
    cfg, jmodel, params, model = pair["cfg"], pair["jmodel"], pair["params"], pair["model"]
    arrs, strict = _inputs(cfg)
    jout = jax.jit(lambda p, *a: jmodel.apply(p, *a[:4], point_valid=a[4], train=False,
                                              force_neg=True))(
        params, *map(jnp.asarray, arrs), jnp.asarray(strict))
    with torch.no_grad():
        tout = model(*map(torch.from_numpy, arrs), point_valid=torch.from_numpy(strict),
                     force_neg=True)
    keys = OUT_KEYS + (("eos_slot", "eos_emb") if cfg.use_eos else ())
    assert set(tout) == set(jout)
    assert tout["out_coord"].shape[-1] == (2 * cfg.num_bins if cfg.use_dfl else 2)
    _compare_outputs(tout, jout, arrs[3], keys)


@pytest.mark.parametrize("name", ["dfl", "dfl_eos"])
def test_decode_boundaries_dfl_matches_jax(name):
    """The same head outputs into both decoders, strict masks: invalid
    points score -1, so the ranking's tie order is exercised."""
    pair = _pair(name)
    cfg, jmodel, params, model = pair["cfg"], pair["jmodel"], pair["params"], pair["model"]
    arrs, strict = _inputs(cfg, seed=1)
    jout = jmodel.apply(params, *map(jnp.asarray, arrs), point_valid=jnp.asarray(strict),
                        train=False)
    oc, co, pt = (np.array(jout[k]) for k in ("out_class", "out_coord", "point"))
    js, jsc = jax_ms.decode_boundaries_dfl(
        jnp.asarray(oc), jnp.asarray(co), jnp.asarray(pt), cfg.clip_length, cfg.num_bins,
        cfg.sample_radius, point_valid=jnp.asarray(strict), top_k=50)
    ts, tsc = decode_boundaries_dfl(*map(torch.from_numpy, (oc, co, pt)), cfg.clip_length,
                                    cfg.num_bins, cfg.sample_radius,
                                    point_valid=torch.from_numpy(strict), top_k=50)
    assert ts.shape == js.shape and tsc.shape == jsc.shape
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=2e-3)
    np.testing.assert_allclose(tsc.numpy(), np.asarray(jsc), atol=2e-4)
    assert (tsc.numpy() == -1).sum() > 0  # the tie case was reached
    with torch.no_grad():
        tout = model(*map(torch.from_numpy, arrs), point_valid=torch.from_numpy(strict))
    ts2, _ = decode_boundaries_dfl(tout["out_class"], tout["out_coord"], tout["point"],
                                   cfg.clip_length, cfg.num_bins, cfg.sample_radius,
                                   torch.from_numpy(strict), 50)
    np.testing.assert_allclose(ts2.numpy(), np.asarray(js), atol=2e-3)


def test_train_outputs_match_jax(pair):
    """Train mode with every dropout at 0: the unmasked saliency mean, the
    un-zeroed pyramid input and the negative pass with real_neg_mask."""
    flags = pair["flags"]
    jcfg = jax_preset("qvhighlights_slowclip", **MR, **flags, **NO_DROPOUT)
    cfg = from_preset("qvhighlights_slowclip", **MR, **flags, **NO_DROPOUT)
    jmodel = jax_ms.FlashVTGMSModel(dataclasses.replace(jcfg.ms_model_config(),
                                                        dummy_dropout=0.0))
    mcfg = dataclasses.replace(cfg.model_config(), dummy_dropout=0.0)
    model = FlashVTGMSModel(mcfg)
    model.load_state_dict(state_dict_from_jax_ms(pair["params"], mcfg), strict=True)
    arrs, _ = _inputs(cfg, seed=2)
    rnm = np.asarray([1, 0, 1], np.float32)
    jout = jmodel.apply(pair["params"], *map(jnp.asarray, arrs), jnp.asarray(rnm), train=True,
                        rngs={"dropout": jax.random.PRNGKey(0)})
    with torch.no_grad():
        tout = model.train()(*map(torch.from_numpy, arrs), real_neg_mask=torch.from_numpy(rnm))
    keys = OUT_KEYS + (("eos_slot", "eos_emb") if cfg.use_eos else ())
    _compare_outputs(tout, jout, arrs[3], keys)


def _random_ms_outputs(rng, cfg, lv, n_words):
    points = generate_points(lv, cfg.strides)
    n, b, d = len(points), B, 8
    sal_valid = (np.arange(lv)[None] < np.asarray(V_LENS)[:, None]).astype(np.float64)
    out = {
        "saliency_scores": rng.standard_normal((b, lv)),
        "saliency_scores_neg": rng.standard_normal((b, lv)),
        "t2vattnvalues": rng.uniform(0.01, 0.99, (b, lv)),
        "t2vattnvalues_neg": rng.uniform(0.01, 0.99, (b, lv)),
        "sim_score": rng.uniform(-1, 1, (b, lv)),
        "out_class": rng.standard_normal((b, n, 1)),
        "out_coord": (rng.standard_normal((b, n, 2 * cfg.num_bins)) if cfg.use_dfl
                      else np.exp(rng.standard_normal((b, n, 2)) * 0.5)),
        "slot_att": rng.dirichlet(np.ones(n_words), (b, cfg.num_phrase)),
        "real_neg_mask": np.asarray([1.0, 0.0, 1.0]),
        "video_msk": sal_valid,
        "eos_slot": rng.standard_normal((b, 1, d)),
        "eos_emb": rng.standard_normal((b, 1, d)),
        "context_agg": rng.standard_normal((b, lv, d)),
    }
    pymid = [np.ones((b, len(generate_points(lv, (s,)))), np.float64) for s in cfg.strides]
    pymid[0] = sal_valid
    return out, points, pymid


def _random_targets(rng, lv, clip_length):
    sal = np.zeros((B, lv))
    pos, neg = np.zeros((B, 2), np.int64), np.zeros((B, 2), np.int64)
    gt = np.full((B, 5, 2), np.inf)
    for i, n in enumerate(V_LENS):
        s = int(rng.integers(0, n - 3))
        e = int(rng.integers(s + 2, n))
        sal[i, s:e] = rng.integers(1, 5, e - s)
        pos[i] = rng.integers(s, e, 2)
        neg[i] = [int(x) for x in rng.choice(np.r_[0:s, e:n], 2)]
        gt[i, 0] = (s * clip_length, e * clip_length)
        if i == 1:  # a second window
            gt[i, 1] = (0.0, clip_length)
    return dict(saliency_all_labels=sal, saliency_pos_labels=pos, saliency_neg_labels=neg,
                gt_windows=gt)


@pytest.mark.parametrize("case", sorted(FLAGS))
def test_compute_losses_ms_match_jax_float64(case):
    cfg = from_preset("qvhighlights_slowclip", **MR, **FLAGS[case])
    jcfg = jax_preset("qvhighlights_slowclip", **MR, **FLAGS[case])
    rng = np.random.default_rng(7)
    lv = cfg.max_v_l
    outs, points, pymid = _random_ms_outputs(rng, cfg, lv, n_words=cfg.max_q_l - 1)
    targets = _random_targets(rng, lv, cfg.clip_length)
    t_out = {k: torch.from_numpy(v) for k, v in outs.items()}
    t_out.update(point=torch.from_numpy(points), pymid_msk=[torch.from_numpy(m) for m in pymid])
    loss_cfg, jloss_cfg = cfg.loss_config(), jcfg.ms_loss_config()
    got = compute_losses_ms(t_out, {k: torch.from_numpy(v) for k, v in targets.items()},
                            loss_cfg)
    with jax.enable_x64():
        j_out = {k: jnp.asarray(v) for k, v in outs.items()}
        j_out.update(point=jnp.asarray(points), pymid_msk=[jnp.asarray(m) for m in pymid])
        want = jax_compute_losses_ms(j_out, {k: jnp.asarray(v) for k, v in targets.items()},
                                     jloss_cfg)
        want_total = float(jax_weighted_total_ms(want, jloss_cfg))
        want = {k: float(v) for k, v in want.items()}
    assert sorted(got) == sorted(want) == list(declared_loss_keys(loss_cfg))[:-1]
    for key, v in want.items():
        assert got[key].dtype == torch.float64
        np.testing.assert_allclose(got[key].item(), v, rtol=1e-9, err_msg=key)
    np.testing.assert_allclose(weighted_total_ms(got, loss_cfg).item(), want_total, rtol=1e-9)
    assert got["loss_reg"].item() > 0 and got["loss_qfl"].item() > 0


def test_focal_losses_match_jax_float64():
    """distribution_focal_loss at labels on and between the bins (the last
    bin's edge included) and quality_focal_loss, weighted and averaged."""
    rng = np.random.default_rng(9)
    pred = rng.standard_normal((2, 7, 16))
    label = np.concatenate([rng.uniform(0, 15, (2, 4)), [[0.0, 1.0, 14.999], [3.0, 7.5, 0.5]]],
                           axis=1)
    w = rng.uniform(0, 1, (2, 7))
    logits, score = rng.standard_normal((2, 7)), rng.uniform(0, 1, (2, 7))
    cls = (rng.uniform(0, 1, (2, 7)) > 0.5).astype(np.float64)
    with jax.enable_x64():
        want = (float(jax_basic.distribution_focal_loss(jnp.asarray(pred), jnp.asarray(label),
                                                        jnp.asarray(w), 3.0)),
                float(jax_basic.quality_focal_loss(jnp.asarray(logits), jnp.asarray(cls),
                                                   jnp.asarray(score), jnp.asarray(w), 2.5)))
    t = {k: torch.from_numpy(v) for k, v in dict(pred=pred, label=label, w=w, logits=logits,
                                                 score=score, cls=cls).items()}
    got = (basic.distribution_focal_loss(t["pred"], t["label"], t["w"], 3.0).item(),
           basic.quality_focal_loss(t["logits"], t["cls"], t["score"], t["w"], 2.5).item())
    np.testing.assert_allclose(got, want, rtol=1e-9)


def _jax_pe64(mask, num_pos_feats, temperature=10000.0, normalize=True, scale=2 * math.pi):
    x = jnp.cumsum(mask.astype(jnp.float64), axis=1)
    if normalize:
        x = x / (x[:, -1:] + 1e-6) * scale
    dim = np.arange(num_pos_feats, dtype=np.float64)
    pos = x[:, :, None] / jnp.asarray(temperature ** (2 * (dim // 2) / num_pos_feats))
    pos = jnp.stack([jnp.sin(pos[:, :, 0::2]), jnp.cos(pos[:, :, 1::2])], axis=3)
    return pos.reshape(pos.shape[0], pos.shape[1], -1)


def _port_pe64(mask, num_pos_feats, temperature=10000.0, normalize=True, scale=2 * math.pi):
    x = torch.cumsum(mask.double(), dim=1)
    if normalize:
        x = x / (x[:, -1:] + 1e-6) * scale
    dim = np.arange(num_pos_feats, dtype=np.float64)
    pos = x[:, :, None] / torch.from_numpy(temperature ** (2 * (dim // 2) / num_pos_feats))
    pos = torch.stack([torch.sin(pos[:, :, 0::2]), torch.cos(pos[:, :, 1::2])], dim=3)
    return pos.reshape(pos.shape[0], pos.shape[1], -1)


def _write_split(root, preset, split, n, seed):
    if preset in DOMAIN:
        writer = make_synthetic_tvsum if preset == "tvsum_ms" else make_synthetic_youtube
        return writer(root, n_queries=n, domain=DOMAIN[preset], v_dim=HD["v_feat_dim"],
                      t_dim=HD["t_feat_dim"], min_clips=20, max_clips=HD["max_v_l"], seed=seed,
                      max_q_tokens=HD["max_q_l"] + 1, split=split)
    return make_synthetic_qvh(root, n_queries=n, v_dim=MR["v_feat_dim"], t_dim=MR["t_feat_dim"],
                              n_clips=MR["max_v_l"], seed=seed, min_clips=10,
                              max_q_tokens=MR["max_q_l"] + 1, split=split)


STEP_CASES = {
    "tvsum_ms": ("tvsum_ms", dict(HD, dset_domain="BK")),
    "flagship_ms_dfl_eos": ("qvhighlights_slowclip", dict(MR, use_dfl=True, use_eos=True)),
}


def _rel_err(got, want):
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-6)


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_float64_train_step_matches_jax(tmp_path, case, monkeypatch):
    preset, kw = STEP_CASES[case]
    ann, vdir, qdir = _write_split(str(tmp_path), preset, "train", 4, seed=4)
    data = dict(train_path=ann, v_feat_dirs=(vdir,), t_feat_dir=qdir, **NO_DROPOUT)
    cfg = from_preset(preset, **kw, **data)
    jcfg = jax_preset(preset, **kw, **data, device_feed="off")
    batch = Collator(cfg.max_q_l, cfg.v_buckets, cfg.max_v_l, max_windows=cfg.max_windows,
                     dset_name=cfg.dset_name)(
        [VTGDataset(train_data_config(cfg, ann))[i] for i in range(4)])
    batch["real_neg_mask"] = np.asarray([1, 0, 1, 0], np.float32)
    assert batch["valid_v_lens"].min() < cfg.max_v_l  # padded rows are in

    mcfg = dataclasses.replace(cfg.model_config(), dummy_dropout=0.0)
    jmodel = jax_ms.FlashVTGMSModel(dataclasses.replace(jcfg.ms_model_config(),
                                                        dummy_dropout=0.0))
    # every leaf moved off its init by N(0, 0.02): a leaf left at 0 (the
    # biases), whose gradient is 0 up to rounding (the key projections'
    # biases: softmax is shift invariant), would have Adam's first step
    # turn that rounding into lr g / eps, noise of no meaning at the scale
    # of a zero leaf
    _, params = _jax_init(jcfg, key=5)
    shift = np.random.default_rng(5)
    params = jax.tree.map(
        lambda x: np.asarray(x, np.float64) + shift.normal(0.0, 0.02, np.shape(x)), params)
    for mod in (jax_ms, jax_lgi):
        monkeypatch.setattr(mod, "sine_position_embedding", _jax_pe64)
    for mod in (port_ms, port_lgi):
        monkeypatch.setattr(mod, "sine_position_embedding", _port_pe64)
    keys = ("src_txt", "src_txt_mask", "src_vid", "src_vid_mask", "real_neg_mask",
            "saliency_all_labels", "saliency_pos_labels", "saliency_neg_labels", "gt_windows")
    host = {k: (batch[k].astype(np.float64) if batch[k].dtype == np.float32 else batch[k])
            for k in keys}
    loss_cfg, jloss_cfg = cfg.loss_config(), jcfg.ms_loss_config()

    with jax.enable_x64():
        jb = {k: jnp.asarray(v) for k, v in host.items()}

        def loss_fn(p):
            out = jmodel.apply(p, jb["src_txt"], jb["src_txt_mask"], jb["src_vid"],
                               jb["src_vid_mask"], jb["real_neg_mask"], train=True,
                               rngs={"dropout": jax.random.PRNGKey(6)})
            losses = jax_compute_losses_ms(out, jb, jloss_cfg)
            total = jax_weighted_total_ms(losses, jloss_cfg)
            return total, dict(losses, weighted_loss_overall=total)

        p64 = jax.tree.map(jnp.asarray, params)
        (_, jlosses), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(p64)
        tx, _ = jax_make_optimizer(jcfg, steps_per_epoch=1)
        updates, _ = tx.update(jgrads, tx.init(p64), p64)
        new_params = optax.apply_updates(p64, updates)
        jlosses = {k: float(v) for k, v in jlosses.items()}
        jgrads, new_params = (jax.tree.map(np.asarray, t) for t in (jgrads, new_params))

    def fresh_model():
        model = FlashVTGMSModel(mcfg).double()
        model.load_state_dict(state_dict_from_jax_ms(params, mcfg, np.float64), strict=True)
        return model.train()

    tb = place_batch(host, "cpu", torch.float64)
    model = fresh_model()
    out = model(tb["src_txt"], tb["src_txt_mask"], tb["src_vid"], tb["src_vid_mask"],
                real_neg_mask=tb["real_neg_mask"])
    losses = compute_losses_ms(out, tb, loss_cfg)
    total = weighted_total_ms(losses, loss_cfg)
    total.backward()
    losses["weighted_loss_overall"] = total
    assert sorted(losses) == sorted(jlosses)
    for key, want in jlosses.items():
        np.testing.assert_allclose(losses[key].item(), want, rtol=1e-9, err_msg=key)
    want_grads = state_dict_from_jax_ms(jgrads, mcfg, np.float64)
    for name, p in model.named_parameters():
        if _dead(name):
            continue
        grad = p.grad if p.grad is not None else torch.zeros_like(p)
        err = _rel_err(grad.numpy(), want_grads[name].numpy())
        assert err < 1e-8, (name, err)

    model = fresh_model()
    optimizer, scheduler = make_optimizer(cfg, model.parameters(), steps_per_epoch=1)
    step = make_train_step(model, loss_cfg, optimizer, scheduler, cfg.grad_clip,
                           precision="float32")
    step_losses = step(tb)
    assert list(step_losses) == list(step.loss_keys) == sorted(jlosses)
    for key, want in jlosses.items():
        np.testing.assert_allclose(step_losses[key].item(), want, rtol=1e-9, err_msg=key)
    want_params = state_dict_from_jax_ms(new_params, mcfg, np.float64)
    for name, p in model.named_parameters():
        if _dead(name):
            continue
        err = _rel_err(p.detach().numpy(), want_params[name].numpy())
        assert err < 1e-8, (name, err)


@pytest.fixture(scope="module", params=sorted(DOMAIN))
def hl_runs(request, tmp_path_factory):
    """Both packages' run_hl_inference on one synthetic domain of 7 videos
    (batches of 4, 2 and 1), the same weights; the JAX side's scored
    saliency rows are caught at its compute_hl_map."""
    preset = request.param
    root = str(tmp_path_factory.mktemp(preset))
    ann, vdir, qdir = _write_split(root, preset, None, 7, seed=3)
    data = dict(eval_path=ann, v_feat_dirs=(vdir,), t_feat_dir=qdir, dset_domain=DOMAIN[preset],
                eval_bsz=4)
    cfg = from_preset(preset, **HD, **data)
    jcfg = jax_preset(preset, **HD, **data, device_feed="off")
    jmodel, params = _jax_init(jcfg, key=4)
    caught = {}

    def catch(name, preds, labels):
        caught["preds"] = [np.asarray(p) for p in preds]
        return jax_hl.compute_hl_map(name, preds, labels)

    mp = pytest.MonkeyPatch()
    mp.setattr(jax_infer, "compute_hl_map", catch)
    try:
        want = jax_infer.run_hl_inference(
            jcfg, jmodel, params, JaxDataset(_dataset_cfg(jcfg, ann, load_labels=False)))
    finally:
        mp.undo()
    ds = VTGDataset(eval_data_config(cfg, ann))
    got = run_hl_inference(cfg, _port_model(cfg, params), ds)
    return dict(cfg=cfg, ds=ds, got=got, want=want, jax_preds=caught["preds"])


def test_run_hl_inference_matches_jax(hl_runs):
    got, want, ds = hl_runs["got"], hl_runs["want"], hl_runs["ds"]
    assert list(got["saliency"]) == [r["qid"] for r in ds.data]
    assert len(hl_runs["jax_preds"]) == len(ds) == 7
    lens = []
    for (qid, sal), jrow in zip(got["saliency"].items(), hl_runs["jax_preds"]):
        lens.append(len(sal))
        np.testing.assert_allclose(sal, jrow[: len(sal)], atol=3e-4, rtol=0, err_msg=qid)
    assert min(lens) < hl_runs["cfg"].max_v_l  # padded videos are in
    assert list(got["brief"]) == list(want["brief"]) == ["mAP"]
    assert 0 <= got["brief"]["mAP"] <= 1
    assert abs(got["brief"]["mAP"] - want["brief"]["mAP"]) <= 2e-4


@pytest.fixture(scope="module")
def mr_runs(tmp_path_factory):
    """Both packages' run_mr_inference of the flagship with variant=ms and
    use_dfl on 14 synthetic queries (batches of 8, then 4 + 2), eval losses
    on a labelled copy."""
    root = str(tmp_path_factory.mktemp("mr_ms"))
    ann, vdir, qdir = make_synthetic_qvh(root, n_queries=14, v_dim=MR["v_feat_dim"],
                                         t_dim=MR["t_feat_dim"], n_clips=MR["max_v_l"],
                                         min_clips=6, seed=3)
    data = dict(eval_path=ann, v_feat_dirs=(vdir,), t_feat_dir=qdir, eval_bsz=8, use_dfl=True)
    cfg = from_preset("qvhighlights_slowclip", **MR, **data)
    jcfg = jax_preset("qvhighlights_slowclip", **MR, **data, device_feed="off")
    jmodel, params = _jax_init(jcfg, key=6)
    model = _port_model(cfg, params)
    jds = JaxDataset(_dataset_cfg(jcfg, ann, load_labels=True))
    ds = VTGDataset(eval_data_config(cfg, ann, load_labels=True))
    want = jax_infer.run_mr_inference(jcfg, jmodel, params, jds, loss_cfg=jcfg.ms_loss_config())
    got = run_mr_inference(cfg, model, ds, loss_cfg=cfg.loss_config())
    return dict(got=got, want=want, gt=ds.data)


@pytest.mark.parametrize("which", ["plain", "nms"])
def test_run_mr_inference_dfl_matches_jax(mr_runs, which):
    k = 0 if which == "plain" else 1
    ours, ref = mr_runs["got"][k], mr_runs["want"][k]
    assert len(ours) == len(ref) == 14
    for a, b in zip(ours, ref):
        assert (a["qid"], a["vid"]) == (b["qid"], b["vid"])
        for fld in ("pred_relevant_windows", "pred_saliency_scores"):
            pa, pb = np.asarray(a[fld], np.float64), np.asarray(b[fld], np.float64)
            assert pa.shape == pb.shape, (a["qid"], fld)
            np.testing.assert_allclose(pa, pb, atol=2e-3, rtol=0, err_msg=fld)
    m_ours = eval_submission(ours, mr_runs["gt"])["brief"]
    m_ref = jax_eval(ref, mr_runs["gt"], verbose=False)["brief"]
    assert list(m_ours) == list(m_ref)
    for key, v in m_ref.items():
        assert abs(m_ours[key] - v) <= 0.02, (key, m_ours[key], v)


def test_eval_losses_ms_match_jax(mr_runs):
    got, want = mr_runs["got"][2], mr_runs["want"][2]
    assert set(got) == set(want) and "loss_phrase_slot" in got
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("normalize_t", [True, False])
@pytest.mark.parametrize("max_q_l", [5, 32])
def test_eos_first_text_layout_matches_jax(tmp_path, normalize_t, max_q_l):
    """`{qid}.npy` text with eos_first: the last row first, then rows 4..-1,
    cut to max_q_l, l2-normalised on request; a qid with an `.npz` file
    takes the usual path."""
    ann, vdir, qdir = make_synthetic_qvh(str(tmp_path), n_queries=4, v_dim=8, t_dim=6,
                                         n_clips=10, seed=1)
    npy_dir = tmp_path / "npy_text"
    npy_dir.mkdir()
    rng = np.random.default_rng(2)
    for qid in range(3):  # the 4th query keeps its .npz only
        np.save(npy_dir / f"{qid}.npy", rng.standard_normal((9 + qid, 6), dtype=np.float32))
    np.savez(npy_dir / "qid3.npz",
             last_hidden_state=rng.standard_normal((7, 6), dtype=np.float32))
    kw = dict(dset_name="hl", data_path=ann, v_feat_dirs=(vdir,), q_feat_dir=str(npy_dir),
              max_q_l=max_q_l, max_v_l=10, normalize_t=normalize_t, eos_first=True)
    ds, jds = VTGDataset(DataConfig(**kw)), JaxDataset(JaxDataConfig(**kw))
    for i in range(3):
        np.testing.assert_array_equal(ds[i][1]["query_feat"], jds[i][1]["query_feat"])
    # the .npz row: the JAX package's native loader l2-normalises in its own
    # order (1 ulp)
    np.testing.assert_allclose(ds[3][1]["query_feat"], jds[3][1]["query_feat"], rtol=1e-6,
                               atol=1e-7)
    raw = np.load(npy_dir / "0.npy")
    want0 = np.concatenate([raw[-1:], raw[4:-1]])[:max_q_l]
    if not normalize_t:
        np.testing.assert_array_equal(ds[0][1]["query_feat"], want0)
    assert len(ds[0][1]["query_feat"]) == min(max_q_l, 5)


def _losses(run_dir):
    with open(os.path.join(run_dir, "tensorboard_log", "scalars.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return [{k[6:]: v for k, v in r.items() if k.startswith("train/")}
            for r in rows if any(k.startswith("train/") for k in r)]


def test_train_tvsum_ms_matches_jax(tmp_path, monkeypatch):
    """JAX train() and port train() of tvsum_ms from one exported JAX init
    (--resume_adapter), 2 epochs of 2 steps at B 2, an eval each, every
    dropout at 0, float32 both sides: step losses within rtol 1e-4, the
    same files but the checkpoints' form, and finite mAP in [0, 1]."""
    for cls in (jax_config.ExperimentConfig, port_config.ExperimentConfig):
        orig = cls.model_config
        monkeypatch.setattr(cls, "model_config",
                            lambda self, orig=orig: dataclasses.replace(orig(self),
                                                                        dummy_dropout=0.0))
    root = str(tmp_path)
    ann, vdir, qdir = _write_split(root, "tvsum_ms", "train", 4, seed=5)
    val, _, _ = _write_split(root, "tvsum_ms", "val", 2, seed=6)
    kw = dict(HD, **NO_DROPOUT, train_path=ann, eval_path=val, v_feat_dirs=(vdir,),
              t_feat_dir=qdir, dset_domain="BK", bsz=2, eval_bsz=2, n_epoch=2, eval_epoch=1,
              use_tensorboard=False, train_precision="float32", results_root=root,
              exp_id="ms")
    jcfg = jax_preset("tvsum_ms", **kw, device_feed="off")
    _, params = _jax_init(jcfg, key=8)
    adapter = str(tmp_path / "init.ckpt")
    jax_save_torch(adapter, params, jcfg.ms_model_config(), variant="ms")
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_train(jax_preset("tvsum_ms", **kw, device_feed="off", resume_adapter=adapter),
              results_dir=jdir, mesh=make_mesh(jax.devices()[:1], data=1, model=1))
    model, _, _ = train(from_preset("tvsum_ms", **kw, resume_adapter=adapter), results_dir=pdir,
                        device="cpu")
    assert isinstance(model, FlashVTGMSModel) and not model.training
    j_train, p_train = _losses(jdir), _losses(pdir)
    assert len(p_train) == len(j_train) == 4
    for js, ps in zip(j_train, p_train):
        assert list(ps) == sorted(js)
        for k, v in js.items():
            np.testing.assert_allclose(ps[k], v, rtol=1e-4, err_msg=k)
    with open(os.path.join(pdir, "latest_metric.jsonl")) as f:
        (metrics,) = [json.loads(line) for line in f]
    assert 0 <= metrics["brief"]["mAP"] <= 1
    renamed = {"model_best": "model_best.ckpt", "model_latest": "model_latest.ckpt"}
    assert sorted(os.listdir(pdir)) == sorted(renamed.get(f, f) for f in os.listdir(jdir))


@pytest.mark.parametrize("variant", ["core", "ms"])
def test_entry_builds_the_variant(variant):
    """entry() builds the configured variant's model (the ms one with its
    DFL bins), and its example batch runs through the forward and the
    model's decode."""
    kw = dict(MR, variant=variant, use_dfl=True)
    model, args = entry(device="cpu", bsz=2, **kw)
    assert type(model) is {"core": FlashVTGModel, "ms": FlashVTGMSModel}[variant]
    assert not model.training
    with torch.no_grad():
        out = model(*args)
        spans, scores = model.decode(out, args[4], top_k=5)
    bins = 2 * from_preset("qvhighlights_slowclip", **kw).num_bins if variant == "ms" else 2
    assert out["out_coord"].shape[-1] == bins
    assert spans.shape == (2, 5, 2) and scores.shape == (2, 5)
    for t in (out["saliency_scores"], out["out_coord"], spans, scores):
        assert torch.isfinite(t).all()

