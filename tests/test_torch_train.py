"""The port's train path vs the JAX package, on the CPU.

  * labels (data/labels.py) and the train batch (dataset with labels drawn
    per access, Collator with its label and real_neg_mask keys) against
    flashvtg_tpu.data with the same seed: equal (features within 1 ulp);
  * compute_losses on the same outputs and targets against the JAX
    criterion, every key (f32, rtol 1e-5);
  * one float64 train step with every dropout at 0 (dummy_dropout and
    input_dropout included), as tests/test_grad_parity.py holds the JAX
    package against the torch reference: the loss dict (rtol 1e-9), every
    parameter's gradient leaf by leaf through state_dict_from_jax (1e-8 of
    the leaf's largest value), and the parameters after one AdamW step with
    global-norm clipping (1e-8 of the leaf's largest value), for
    `qvhighlights_slowclip` and for `tacos`, `tvsum` and `youtube_uni` (the
    HD losses: dynamic BCE, no loss_reg, row-only NCE) at small widths with
    Lv 150 > 128 and JAX attn_chunk 128, so the JAX encoder runs its
    rematerialised chunked branch and the port's its flash Function. On the CPU the
    attention Functions run their plain forward and backward. Both sides
    read one precomputed float32 position embedding (see the test);
  * a 3-step train(max_steps=3) run on the CPU, with its eval (losses read
    back from the run's scalars.jsonl, metrics from its _metrics.json).
"""

import dataclasses
import random

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch_threads  # noqa: F401  (torch's share of the cores under xdist)
import torch

from flashvtg_tpu.data import labels as jax_labels
from flashvtg_tpu.data.collate import Collator as JaxCollator
from flashvtg_tpu.data.dataset import VTGDataset as JaxDataset
from flashvtg_tpu.losses.criterion import compute_losses as jax_compute_losses
from flashvtg_tpu.losses.criterion import weighted_total as jax_weighted_total
from flashvtg_tpu.models.components import sine_position_embedding as jax_sine_pe
from flashvtg_tpu.models import flashvtg as jax_flashvtg
from flashvtg_tpu.models.flashvtg import FlashVTGModel as JaxModel
from flashvtg_tpu.models.points import generate_points
from flashvtg_tpu.train.config import from_preset as jax_preset
from flashvtg_tpu.train.loop import _dataset_cfg
from flashvtg_tpu.train.loop import make_optimizer as jax_make_optimizer
from flashvtg_tpu_torch.data import labels
from flashvtg_tpu_torch.data.collate import Collator
from flashvtg_tpu_torch.data.dataset import VTGDataset
from flashvtg_tpu_torch.losses import compute_losses, declared_loss_keys, weighted_total
from flashvtg_tpu_torch.models import flashvtg as port_flashvtg
from flashvtg_tpu_torch.models.flashvtg import FlashVTGModel
from flashvtg_tpu_torch.train.config import from_preset
from flashvtg_tpu_torch.train.loop import (
    make_optimizer,
    make_train_step,
    place_batch,
    train,
    train_data_config,
)
from flashvtg_tpu_torch.utils.convert import state_dict_from_jax
from flashvtg_tpu_torch.utils.synthetic import (
    make_synthetic_qvh,
    make_synthetic_tacos,
    make_synthetic_tvsum,
    make_synthetic_youtube,
)

SMALL = dict(
    v_feat_dim=40, t_feat_dim=24, hidden_dim=64, nheads=2, dim_feedforward=96,
    t2v_layers=2, enc_layers=2, dummy_layers=1, num_mlp_layers=2, max_q_l=8,
)
CASES = {
    "qvhighlights_slowclip": dict(SMALL, num_dummies=4, max_v_l=24),
    "tacos": dict(SMALL, num_dummies=5, max_v_l=150, attn_chunk=128),
    "tvsum": dict(SMALL, num_dummies=3, max_v_l=150, attn_chunk=128, dset_domain="BK"),
    "youtube_uni": dict(SMALL, num_dummies=3, max_v_l=150, attn_chunk=128, dset_domain="dog"),
}
NO_DROPOUT = dict(dropout=0.0, input_dropout=0.0)
B = 4


def _write_split(root, preset, split, n, seed):
    o = CASES[preset]
    if preset in ("tvsum", "youtube_uni"):
        writer = make_synthetic_tvsum if preset == "tvsum" else make_synthetic_youtube
        return writer(root, n_queries=n, domain=o["dset_domain"], v_dim=o["v_feat_dim"],
                      t_dim=o["t_feat_dim"], min_clips=20, max_clips=o["max_v_l"], seed=seed,
                      max_q_tokens=o["max_q_l"] + 1, split=split)
    if preset == "tacos":
        return make_synthetic_tacos(
            root, n_queries=n, v_dim=o["v_feat_dim"], t_dim=o["t_feat_dim"],
            max_clips=o["max_v_l"], min_clips=20, seed=seed, max_q_tokens=o["max_q_l"],
            split=split,
        )
    return make_synthetic_qvh(
        root, n_queries=n, v_dim=o["v_feat_dim"], t_dim=o["t_feat_dim"],
        n_clips=o["max_v_l"], seed=seed, min_clips=10, max_q_tokens=o["max_q_l"] + 1,
        split=split,
    )


def _configs(preset, ann, vdir, qdir, **extra):
    data = dict(train_path=ann, v_feat_dirs=(vdir,), t_feat_dir=qdir, **extra)
    return (from_preset(preset, **CASES[preset], **data),
            jax_preset(preset, **CASES[preset], **data, device_feed="off"))


def test_labels_match_jax():
    for seed in range(5):
        a, b = random.Random(seed), random.Random(seed)
        got = labels.saliency_sub_as_query([3.0, 17.5], 60.0, 30, a)
        want = jax_labels.saliency_sub_as_query([3.0, 17.5], 60.0, 30, b)
        assert got[:2] == want[:2] and np.array_equal(got[2], want[2])
        got = labels.saliency_all([2, 3, 4, 9], [[1, 2, 3], [4, 4, 4], [0, 1, 0], [2, 2, 2]],
                                  10, a)
        want = jax_labels.saliency_all([2, 3, 4, 9], [[1, 2, 3], [4, 4, 4], [0, 1, 0], [2, 2, 2]],
                                       10, b)
        assert got[:2] == want[:2] and np.array_equal(got[2], want[2])
        windows = [[2.0 * i, 2.0 * i + 3] for i in range(8)]
        assert np.array_equal(labels.span_windows(windows, 40, 2.0, 5, a),
                              jax_labels.span_windows(windows, 40, 2.0, 5, b))


@pytest.mark.parametrize("preset", sorted(CASES))
def test_train_batches_match_jax(tmp_path, preset):
    """Two epochs' worth of label draws (the labels are re-drawn on every
    access) and txt_drop, through both datasets and collators."""
    ann, vdir, qdir = _write_split(str(tmp_path), preset, "train", 6, seed=1)
    cfg, jcfg = _configs(preset, ann, vdir, qdir, txt_drop_ratio=0.2)
    ds = VTGDataset(train_data_config(cfg, ann))
    jds = JaxDataset(_dataset_cfg(jcfg, ann, train=True))
    collate = Collator(cfg.max_q_l, cfg.v_buckets, cfg.max_v_l, max_windows=cfg.max_windows,
                       dset_name=cfg.dset_name)
    jcollate = JaxCollator(max_q_l=jcfg.max_q_l, v_buckets=jcfg.v_buckets,
                           max_windows=jcfg.max_windows, dset_name=jcfg.dset_name,
                           fixed_v_len=jcfg.max_v_l)
    for order in ([0, 1, 2, 3, 4, 5], [5, 3, 1, 0, 2, 4]):
        got = collate([ds[i] for i in order])
        want = jcollate([jds[i] for i in order])
        for key in ("src_txt_mask", "src_vid_mask", "saliency_all_labels",
                    "saliency_pos_labels", "saliency_neg_labels", "gt_windows",
                    "real_neg_mask", "valid_v_lens"):
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        # features: the JAX package's native loader l2-normalises in its own
        # order (1 ulp)
        for key in ("src_txt", "src_vid"):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-6, atol=1e-7, err_msg=key)
        assert got["vid"] == want["vid"] and got["qid"] == want["qid"]
    assert (got["src_vid_mask"].sum(1) < cfg.max_v_l).any()  # short videos are in


def _random_outputs(rng, b, lv, d, strides, with_neg):
    points = generate_points(lv, strides)
    n = len(points)
    out = {
        "saliency_scores": rng.standard_normal((b, lv)),
        "t2vattnvalues": rng.uniform(0.01, 0.99, (b, lv)),
        "video_emb": rng.standard_normal((b, lv, d)),
        "query_emb": rng.standard_normal((b, 1, d)),
        "out_class": rng.standard_normal((b, n, 1)),
        "out_coord": np.exp(rng.standard_normal((b, n, 2)) * 0.5),
    }
    if with_neg:
        out["saliency_scores_neg"] = rng.standard_normal((b, lv))
        out["t2vattnvalues_neg"] = rng.uniform(0.01, 0.99, (b, lv))
        out["real_neg_mask"] = np.asarray([1, 0, 1, 0], np.float64)
    return {k: v.astype(np.float32) for k, v in out.items()}, points


@pytest.mark.parametrize("with_neg", [True, False])
@pytest.mark.parametrize(
    "loss_kw",
    [{}, dict(loss_qfl=True, nce_direction=("row",)),
     dict(loss_reg=None, loss_cls="dynamic_bce", nce_direction=("row",))],
    ids=["mr", "qfl", "hd"],
)
def test_compute_losses_match_jax(tmp_path, with_neg, loss_kw):
    ann, vdir, qdir = _write_split(str(tmp_path), "qvhighlights_slowclip", "train", B, seed=2)
    cfg, jcfg = _configs("qvhighlights_slowclip", ann, vdir, qdir, **loss_kw)
    batch = Collator(cfg.max_q_l, cfg.v_buckets, cfg.max_v_l)(
        [VTGDataset(train_data_config(cfg, ann))[i] for i in range(B)]
    )
    rng = np.random.default_rng(3)
    outs, points = _random_outputs(rng, B, cfg.max_v_l, 16, cfg.strides, with_neg)
    pymid = [np.ones((B, (cfg.max_v_l - s) // s + 1), np.float32) for s in cfg.strides]
    pymid[0] = batch["src_vid_mask"]
    targets = {k: batch[k] for k in ("saliency_all_labels", "saliency_pos_labels",
                                     "saliency_neg_labels", "gt_windows")}
    t_out = {k: torch.from_numpy(v) for k, v in outs.items()}
    t_out.update(point=torch.from_numpy(points), video_msk=torch.from_numpy(batch["src_vid_mask"]),
                 pymid_msk=[torch.from_numpy(m) for m in pymid])
    j_out = {k: jnp.asarray(v) for k, v in outs.items()}
    j_out.update(point=jnp.asarray(points), video_msk=jnp.asarray(batch["src_vid_mask"]),
                 pymid_msk=[jnp.asarray(m) for m in pymid])
    got = compute_losses(t_out, {k: torch.from_numpy(v) for k, v in targets.items()},
                         cfg.loss_config())
    want = jax_compute_losses(j_out, {k: jnp.asarray(v) for k, v in targets.items()},
                              jcfg.loss_config())
    assert sorted(got) == sorted(want) == list(declared_loss_keys(cfg.loss_config()))[:-1]
    for key in want:
        np.testing.assert_allclose(got[key].item(), float(want[key]), rtol=1e-5, err_msg=key)
    np.testing.assert_allclose(weighted_total(got, cfg.loss_config()).item(),
                               float(jax_weighted_total(want, jcfg.loss_config())), rtol=1e-5)


def _rel_err(got, want):
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-6)


@pytest.mark.parametrize("preset", sorted(CASES))
def test_float64_train_step_matches_jax(tmp_path, preset, monkeypatch):
    # Both packages compute the sine position embedding in float32 by design
    # (the reference does), and f32 sin / cos differ by 1 ulp between XLA
    # (eager or fused under jit) and torch on ~3 % of its entries: a ~4e-7
    # floor on every gradient. Both forwards are handed one precomputed
    # embedding of this batch's mask here, so what is compared is the
    # float64 train step itself.
    position_embedding = None

    def fixed_embedding(wrap):
        return lambda mask, d: wrap(position_embedding)

    monkeypatch.setattr(jax_flashvtg, "sine_position_embedding", fixed_embedding(jnp.asarray))
    monkeypatch.setattr(port_flashvtg, "sine_position_embedding",
                        fixed_embedding(lambda a: torch.from_numpy(a.copy())))
    ann, vdir, qdir = _write_split(str(tmp_path), preset, "train", B, seed=4)
    cfg, jcfg = _configs(preset, ann, vdir, qdir, **NO_DROPOUT)
    batch = Collator(cfg.max_q_l, cfg.v_buckets, cfg.max_v_l, max_windows=cfg.max_windows,
                     dset_name=cfg.dset_name)(
        [VTGDataset(train_data_config(cfg, ann))[i] for i in range(B)]
    )
    batch["real_neg_mask"] = np.asarray([1, 0, 1, 0], np.float32)  # two false negatives
    assert batch["valid_v_lens"].min() < cfg.max_v_l  # padded rows are in
    position_embedding = np.asarray(jax_sine_pe(jnp.asarray(batch["src_vid_mask"]),
                                                cfg.hidden_dim))

    mcfg = dataclasses.replace(cfg.model_config(), dummy_dropout=0.0)
    jmodel = JaxModel(dataclasses.replace(jcfg.model_config(), dummy_dropout=0.0))
    lv, lq = cfg.max_v_l, cfg.max_q_l
    params = jax.jit(jmodel.init, static_argnames="train")(
        {"params": jax.random.PRNGKey(5)},
        jnp.zeros((1, lq, cfg.t_feat_dim)), jnp.ones((1, lq)),
        jnp.zeros((1, lv, cfg.total_v_feat_dim)), jnp.ones((1, lv)), train=False,
    )
    params = jax.tree.map(lambda x: np.asarray(x, np.float64), params)
    keys = ("src_txt", "src_txt_mask", "src_vid", "src_vid_mask", "real_neg_mask",
            "saliency_all_labels", "saliency_pos_labels", "saliency_neg_labels", "gt_windows")
    host = {k: (batch[k].astype(np.float64) if batch[k].dtype == np.float32 else batch[k])
            for k in keys}

    with jax.enable_x64():
        jb = {k: jnp.asarray(v) for k, v in host.items()}
        loss_cfg = jcfg.loss_config()

        def loss_fn(p):
            out = jmodel.apply(p, jb["src_txt"], jb["src_txt_mask"], jb["src_vid"],
                               jb["src_vid_mask"], jb["real_neg_mask"], train=True,
                               rngs={"dropout": jax.random.PRNGKey(6)})
            losses = jax_compute_losses(out, jb, loss_cfg)
            total = jax_weighted_total(losses, loss_cfg)
            return total, dict(losses, weighted_loss_overall=total)

        p64 = jax.tree.map(jnp.asarray, params)
        (_, jlosses), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(p64)
        tx, _ = jax_make_optimizer(jcfg, steps_per_epoch=1)
        updates, _ = tx.update(jgrads, tx.init(p64), p64)
        new_params = optax.apply_updates(p64, updates)
        jlosses = {k: float(v) for k, v in jlosses.items()}
        jgrads, new_params = (jax.tree.map(np.asarray, t) for t in (jgrads, new_params))

    def fresh_model():
        model = FlashVTGModel(mcfg).double()
        model.load_state_dict(state_dict_from_jax(params, mcfg, np.float64), strict=True)
        return model.train()

    dead = ("txt_position_embed.",)  # no JAX counterpart without use_txt_pos
    tb = place_batch(host, "cpu", torch.float64)
    model = fresh_model()
    out = model(tb["src_txt"], tb["src_txt_mask"], tb["src_vid"], tb["src_vid_mask"],
                real_neg_mask=tb["real_neg_mask"])
    losses = compute_losses(out, tb, cfg.loss_config())
    total = weighted_total(losses, cfg.loss_config())
    total.backward()
    losses["weighted_loss_overall"] = total
    assert sorted(losses) == sorted(jlosses)
    for key, want in jlosses.items():
        np.testing.assert_allclose(losses[key].item(), want, rtol=1e-9, err_msg=key)
    want_grads = state_dict_from_jax(jgrads, mcfg, np.float64)
    for name, p in model.named_parameters():
        if name.startswith(dead):
            continue
        # no gradient reaches the coord head and coef without loss_reg (HD)
        grad = p.grad if p.grad is not None else torch.zeros_like(p)
        err = _rel_err(grad.numpy(), want_grads[name].numpy())
        assert err < 1e-8, (name, err)

    model = fresh_model()
    optimizer, scheduler = make_optimizer(cfg, model.parameters(), steps_per_epoch=1)
    step = make_train_step(model, cfg.loss_config(), optimizer, scheduler, cfg.grad_clip,
                           precision="float32")
    step_losses = step(tb)
    assert list(step_losses) == list(step.loss_keys) == sorted(jlosses)
    for key, want in jlosses.items():
        np.testing.assert_allclose(step_losses[key].item(), want, rtol=1e-9, err_msg=key)
    want_params = state_dict_from_jax(new_params, mcfg, np.float64)
    for name, p in model.named_parameters():
        if name.startswith(dead):
            continue
        err = _rel_err(p.detach().numpy(), want_params[name].numpy())
        assert err < 1e-8, (name, err)


def test_train_three_steps_on_cpu(tmp_path):
    """train(max_steps=3) on the CPU with every dropout at its preset value:
    finite losses in the step's key order, then one eval."""
    import json
    import os

    root = str(tmp_path)
    ann, vdir, qdir = _write_split(root, "tacos", "train", 6, seed=7)
    val, _, _ = _write_split(root, "tacos", "val", 3, seed=8)
    cfg = from_preset("tacos", **CASES["tacos"], train_path=ann, eval_path=val,
                      v_feat_dirs=(vdir,), t_feat_dir=qdir, bsz=2, eval_bsz=2, n_epoch=5,
                      eval_epoch=1, use_tensorboard=False)
    model, _, run_dir = train(cfg, str(tmp_path / "run"), device="cpu", max_steps=3)
    assert not model.training
    with open(os.path.join(run_dir, "tensorboard_log", "scalars.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    losses = [{k[6:]: v for k, v in r.items() if k.startswith("train/")}
              for r in rows if any(k.startswith("train/") for k in r)]
    assert len(losses) == 3
    assert list(losses[0]) == list(declared_loss_keys(cfg.loss_config()))
    assert all(np.isfinite(v) for h in losses for v in h.values())
    with open(os.path.join(run_dir, "latest_tacos_val_preds.jsonl")) as f:
        assert len(f.read().splitlines()) == 3
    with open(os.path.join(run_dir, "latest_tacos_val_preds_metrics.json")) as f:
        assert np.isfinite(json.load(f)["brief"]["MR-full-mIoU"])
