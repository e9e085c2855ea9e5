"""The port's highlight-detection (HD) path vs the JAX package, on the CPU.

  * eval/hl.py: tvsum_video_ap, youtube_video_ap and compute_hl_map on
    random predictions and labels, ties included, within 1e-12;
  * the TVSum (rgb + opt halves, l2-normed after the concatenation, cut to
    the label rows; the one-file fallback) and YouTube-HL datasets: the
    same features bit for bit (against the JAX package's numpy path),
    the same labels from one seed, the same domain filter and error;
  * the `tvsum` preset's forward at strides (1,) and small widths, Lv 150
    over JAX attn_chunk 128 (the flash path), within 2e-4 / 3e-4;
  * run_hl_inference on both HD presets: per-video saliency within 3e-4 of
    the saliency the JAX run_hl_inference scores, the mAP within 0.02
    (the metric tolerance of __graft_entry__.py:172-197, here on mAP's
    0-1 scale);
  * train() on `tvsum` routes its final eval through run_hl_inference.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashvtg_tpu.data.dataset import DataConfig as JaxDataConfig
from flashvtg_tpu.data.dataset import VTGDataset as JaxDataset
from flashvtg_tpu.eval import hl as jax_hl
from flashvtg_tpu.models.flashvtg import FlashVTGModel as JaxModel
from flashvtg_tpu.train import infer as jax_infer
from flashvtg_tpu.train.config import from_preset as jax_preset
from flashvtg_tpu.train.loop import _dataset_cfg
from flashvtg_tpu_torch.data.dataset import DataConfig, VTGDataset
from flashvtg_tpu_torch.eval import hl
from flashvtg_tpu_torch.models.flashvtg import FlashVTGModel
from flashvtg_tpu_torch.models.points import pyramid_masks_strict
from flashvtg_tpu_torch.train.config import from_preset
from flashvtg_tpu_torch.train.infer import eval_data_config, run_hl_inference
from flashvtg_tpu_torch.train.loop import train, train_data_config
from flashvtg_tpu_torch.utils.convert import state_dict_from_jax
from flashvtg_tpu_torch.utils.io import load_jsonl, save_jsonl
from flashvtg_tpu_torch.utils.synthetic import make_synthetic_tvsum, make_synthetic_youtube

SMALL = dict(
    v_feat_dim=48, t_feat_dim=32, hidden_dim=64, nheads=2, dim_feedforward=128,
    t2v_layers=2, enc_layers=2, dummy_layers=1, num_mlp_layers=2, max_v_l=150,
    max_q_l=10, attn_chunk=128,
)
DOMAIN = {"tvsum": "BK", "youtube_uni": "dog"}
HD = sorted(DOMAIN)


def _write(preset, root, n, seed, **kw):
    if preset == "tvsum":
        return make_synthetic_tvsum(root, n_queries=n, v_dim=SMALL["v_feat_dim"],
                                    t_dim=SMALL["t_feat_dim"], min_clips=20,
                                    max_clips=SMALL["max_v_l"], seed=seed,
                                    max_q_tokens=SMALL["max_q_l"] + 3, **kw)
    return make_synthetic_youtube(root, n_queries=n, v_dim=SMALL["v_feat_dim"],
                                  t_dim=SMALL["t_feat_dim"], min_clips=20,
                                  max_clips=SMALL["max_v_l"] + 20, seed=seed,
                                  max_q_tokens=SMALL["max_q_l"] + 3, **kw)


def _configs(preset, ann, vdir, qdir, **extra):
    data = dict(eval_path=ann, v_feat_dirs=(vdir,), t_feat_dir=qdir,
                dset_domain=DOMAIN[preset], **extra)
    return (from_preset(preset, **SMALL, **data),
            jax_preset(preset, **SMALL, **data, device_feed="off"))


@pytest.mark.parametrize("seed", range(4))
def test_hl_metrics_match_jax(seed):
    """Predictions on a coarse grid, so the ranking has ties; TVSum labels
    1-5 (the median binarisation ties too), YouTube-HL binary labels, one
    video with no positive."""
    rng = np.random.default_rng(seed)
    preds, tv_labels, yt_labels = [], [], []
    for i in range(6):
        n = int(rng.integers(8, 60))
        preds.append(np.round(rng.standard_normal(n + int(rng.integers(0, 4))), 1)
                     .astype(np.float32))
        tv_labels.append(rng.integers(1, 6, (n, 20)).tolist())
        yt = (rng.random((n, 1)) < 0.3).astype(int)
        yt_labels.append(np.zeros_like(yt).tolist() if i == 0 else yt.tolist())
    for p, tv, yt in zip(preds, tv_labels, yt_labels):
        np.testing.assert_allclose(hl.tvsum_video_ap(p, np.asarray(tv)),
                                   jax_hl.tvsum_video_ap(p, np.asarray(tv)), rtol=0, atol=1e-12)
        np.testing.assert_allclose(hl.youtube_video_ap(p, np.asarray(yt)),
                                   jax_hl.youtube_video_ap(p, np.asarray(yt)), rtol=0, atol=1e-12)
    for name, labels in (("tvsum", tv_labels), ("youtube_uni", yt_labels)):
        got, want = hl.compute_hl_map(name, preds, labels), jax_hl.compute_hl_map(name, preds, labels)
        assert abs(got - want) <= 1e-12 and 0 <= got <= 1
    with pytest.raises(ValueError, match="not an HL dataset"):
        hl.compute_hl_map("hl", preds, tv_labels)


@pytest.mark.parametrize("load_labels", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("preset", HD)
def test_hd_dataset_matches_jax(tmp_path, preset, load_labels, monkeypatch):
    # the JAX package's native loader l2-normalises a single feature file in
    # its own order (1 ulp off numpy); the port has only the numpy path, so
    # it is held bit for bit against the JAX package's numpy path
    from flashvtg_tpu import runtime

    monkeypatch.setattr(runtime, "load_features", lambda *a, **kw: None)
    ann, vdir, qdir = _write(preset, str(tmp_path), 6, seed=1)
    cfg, jcfg = _configs(preset, ann, vdir, qdir)
    if load_labels:
        ds = VTGDataset(train_data_config(cfg, ann))
        jds = JaxDataset(_dataset_cfg(jcfg, ann, train=True))
    else:
        ds = VTGDataset(eval_data_config(cfg, ann))
        jds = JaxDataset(_dataset_cfg(jcfg, ann, load_labels=False))
    assert len(ds) == len(jds) == 6
    for _ in range(2):  # the labels are drawn on every access
        for i in range(len(ds)):
            (meta, got), (_, want) = ds[i], jds[i]
            assert sorted(got) == sorted(want)
            for key, value in want.items():
                if isinstance(value, np.ndarray):
                    assert got[key].dtype == value.dtype, key
                    np.testing.assert_array_equal(got[key], value, err_msg=key)
                else:
                    assert got[key] == value, key
            if preset == "tvsum":  # the clips past the label rows are cut
                assert len(got["video_feat"]) == len(meta["label"])
            # the HD text is read as it is: no l2-norm, no max_q_l cut
            raw = np.load(f"{qdir}/{meta['qid']}.npz")["last_hidden_state"]
            np.testing.assert_array_equal(got["query_feat"], raw)
    assert any(len(ds[i][1]["query_feat"]) > cfg.max_q_l for i in range(len(ds)))


def test_tvsum_single_file_fallback_matches_jax(tmp_path, monkeypatch):
    """A TVSum video without `_rgb.npy` is read from `{vid}.npy`, l2-normed
    per row as one file."""
    from flashvtg_tpu import runtime

    monkeypatch.setattr(runtime, "load_features", lambda *a, **kw: None)
    ann, vdir, qdir = _write("tvsum", str(tmp_path), 3, seed=9)
    for row in load_jsonl(ann):
        halves = [f"{vdir}/{row['vid']}_{h}.npy" for h in ("rgb", "opt")]
        np.save(f"{vdir}/{row['vid']}.npy", np.concatenate([np.load(h) for h in halves], -1))
        for h in halves:
            os.remove(h)
    cfg, jcfg = _configs("tvsum", ann, vdir, qdir)
    ds = VTGDataset(eval_data_config(cfg, ann))
    jds = JaxDataset(_dataset_cfg(jcfg, ann, load_labels=False))
    for i in range(len(ds)):
        np.testing.assert_array_equal(ds[i][1]["video_feat"], jds[i][1]["video_feat"])


@pytest.mark.parametrize("preset", HD)
def test_hd_domain_filter_matches_jax(tmp_path, preset):
    root = str(tmp_path)
    ann, vdir, qdir = _write(preset, root, 3, seed=2)
    other = "GA" if preset == "tvsum" else "surfing"
    rows = load_jsonl(ann)
    rows += [dict(r, domain=other) for r in rows[:2]]  # the same videos, another domain
    save_jsonl(rows, ann)
    kw = dict(dset_name=preset, data_path=ann, v_feat_dirs=(vdir,), q_feat_dir=qdir,
              max_v_l=SMALL["max_v_l"], max_q_l=SMALL["max_q_l"])
    for domain, n in ((DOMAIN[preset], 3), (other, 2)):
        ds = VTGDataset(DataConfig(**kw, dset_domain=domain))
        jds = JaxDataset(JaxDataConfig(**kw, dset_domain=domain, load_labels=False))
        assert ds.data == jds.data and len(ds) == n
        assert {r["domain"] for r in ds.data} == {domain}
    for bad in (None, "nope"):
        with pytest.raises(ValueError) as want:
            JaxDataset(JaxDataConfig(**kw, dset_domain=bad))
        with pytest.raises(ValueError) as got:
            VTGDataset(DataConfig(**kw, dset_domain=bad))
        assert str(got.value) == str(want.value)


@pytest.fixture(scope="module")
def tvsum_pair():
    jcfg = jax_preset("tvsum", **SMALL)
    jmodel = JaxModel(jcfg.model_config())
    lv, lq = jcfg.max_v_l, jcfg.max_q_l
    params = jax.jit(jmodel.init, static_argnames="train")(
        {"params": jax.random.PRNGKey(7)},
        jnp.zeros((1, lq, jcfg.t_feat_dim)), jnp.ones((1, lq)),
        jnp.zeros((1, lv, jcfg.total_v_feat_dim)), jnp.ones((1, lv)), train=False,
    )
    params = jax.tree.map(np.asarray, params)
    apply = jax.jit(lambda p, *a: jmodel.apply(p, *a[:4], point_valid=a[4], train=False))
    cfg = from_preset("tvsum", **SMALL)
    assert cfg.strides == (1,) and cfg.loss_reg is None
    model = FlashVTGModel(cfg.model_config()).eval()
    model.load_state_dict(state_dict_from_jax(params, cfg.model_config()), strict=True)
    return cfg, params, apply, model


@pytest.mark.parametrize("v_lens", [(150, 150, 150), (150, 97, 21)], ids=["full", "ragged"])
def test_hd_forward_matches_jax(tvsum_pair, v_lens):
    cfg, params, apply, model = tvsum_pair
    rng = np.random.default_rng(sum(v_lens))
    lv, lq, b = cfg.max_v_l, cfg.max_q_l, len(v_lens)
    txt_mask = (np.arange(lq)[None] < np.asarray([10, 6, 5])[:, None]).astype(np.float32)
    vid_mask = (np.arange(lv)[None] < np.asarray(v_lens)[:, None]).astype(np.float32)
    arrs = (rng.standard_normal((b, lq, cfg.t_feat_dim), dtype=np.float32) * txt_mask[..., None],
            txt_mask,
            rng.standard_normal((b, lv, cfg.total_v_feat_dim), dtype=np.float32)
            * vid_mask[..., None],
            vid_mask)
    strict = pyramid_masks_strict(np.asarray(v_lens), lv, cfg.strides)[0]
    jout = apply(params, *map(jnp.asarray, arrs), jnp.asarray(strict))
    with torch.no_grad():
        tout = model(*map(torch.from_numpy, arrs), point_valid=torch.from_numpy(strict))
    assert tout["out_class"].shape[1] == lv  # strides (1,): one point per clip
    vm = vid_mask > 0
    for key in ("saliency_scores", "t2vattnvalues"):
        np.testing.assert_allclose(tout[key].numpy()[vm], np.asarray(jout[key])[vm],
                                   atol=2e-4, err_msg=key)
    np.testing.assert_allclose(tout["attn_weights"].numpy(), np.asarray(jout["attn_weights"]),
                               atol=2e-4)
    for key in ("out_class", "out_coord"):
        np.testing.assert_allclose(tout[key].numpy(), np.asarray(jout[key]), atol=3e-4,
                                   rtol=1e-5, err_msg=key)


@pytest.fixture(scope="module", params=HD)
def hl_runs(request, tmp_path_factory):
    """Both packages' run_hl_inference on one synthetic domain of 7 videos
    (batches of 4, 2 and 1) with the same weights; the JAX side's scored
    saliency rows are caught at its compute_hl_map."""
    preset = request.param
    root = str(tmp_path_factory.mktemp(preset))
    ann, vdir, qdir = _write(preset, root, 7, seed=3)
    cfg, jcfg = _configs(preset, ann, vdir, qdir, eval_bsz=4)
    jmodel = jcfg.build_model()
    lv, lq = jcfg.max_v_l, jcfg.max_q_l
    params = jax.jit(jmodel.init, static_argnames="train")(
        {"params": jax.random.PRNGKey(4)},
        jnp.zeros((1, lq, jcfg.t_feat_dim)), jnp.ones((1, lq)),
        jnp.zeros((1, lv, jcfg.total_v_feat_dim)), jnp.ones((1, lv)), train=False,
    )
    caught = {}

    def catch(name, preds, labels):
        caught["preds"] = [np.asarray(p) for p in preds]
        return jax_hl.compute_hl_map(name, preds, labels)

    mp = pytest.MonkeyPatch()
    mp.setattr(jax_infer, "compute_hl_map", catch)
    try:
        jds = JaxDataset(_dataset_cfg(jcfg, ann, load_labels=False))
        want = jax_infer.run_hl_inference(jcfg, jmodel, params, jds)
    finally:
        mp.undo()
    model = FlashVTGModel(cfg.model_config()).eval()
    model.load_state_dict(
        state_dict_from_jax(jax.tree.map(np.asarray, params), cfg.model_config()), strict=True)
    ds = VTGDataset(eval_data_config(cfg, ann))
    got = run_hl_inference(cfg, model, ds)
    return dict(preset=preset, cfg=cfg, ds=ds, got=got, want=want, jax_preds=caught["preds"])


def test_run_hl_inference_matches_jax(hl_runs):
    got, want, ds = hl_runs["got"], hl_runs["want"], hl_runs["ds"]
    assert list(got["saliency"]) == [r["qid"] for r in ds.data]
    assert len(hl_runs["jax_preds"]) == len(ds) == 7
    lens = []
    for (qid, sal), jrow, (_, x) in zip(got["saliency"].items(), hl_runs["jax_preds"],
                                         (ds[i] for i in range(len(ds)))):
        n = len(x["video_feat"])
        lens.append(n)
        assert sal.shape == (min(n, hl_runs["cfg"].max_v_l),) and sal.dtype == np.float32
        np.testing.assert_allclose(sal, jrow[: len(sal)], atol=3e-4, rtol=0, err_msg=qid)
    assert min(lens) < hl_runs["cfg"].max_v_l  # padded videos are in
    assert list(got["brief"]) == list(want["brief"]) == ["mAP"]
    assert 0 <= got["brief"]["mAP"] <= 1
    # 0.02 points of mAP on the 0-100 scale of the metric tolerance
    assert abs(got["brief"]["mAP"] - want["brief"]["mAP"]) <= 2e-4


def test_hl_map_of_port_saliency_is_the_metric(hl_runs):
    """The mAP that run_hl_inference reports is compute_hl_map over its own
    saliency rows and the rows' labels, rounded to 5 places."""
    got, ds = hl_runs["got"], hl_runs["ds"]
    labels = [r["label"] for r in ds.data]
    mean_ap = hl.compute_hl_map(hl_runs["preset"], list(got["saliency"].values()), labels)
    assert got["brief"]["mAP"] == round(mean_ap, 5)


def test_hd_train_then_eval_on_cpu(tmp_path):
    """train(max_steps=2) on a TVSum domain of 4 train videos at B 2, every
    dropout at its preset value: finite losses, no loss_reg, then the
    epoch's eval through run_hl_inference on the val video (latest_metric.jsonl,
    no submission file)."""
    import glob
    import json
    import os

    root = str(tmp_path)
    ann, vdir, qdir = _write("tvsum", root, 4, seed=5, split="train")
    val, _, _ = _write("tvsum", root, 1, seed=6, split="val")
    cfg = from_preset("tvsum", **SMALL, train_path=ann, eval_path=val, v_feat_dirs=(vdir,),
                      t_feat_dir=qdir, dset_domain="BK", bsz=2, eval_bsz=1,
                      use_tensorboard=False)
    model, _, run_dir = train(cfg, str(tmp_path / "run"), device="cpu", max_steps=2)
    assert not model.training
    with open(os.path.join(run_dir, "tensorboard_log", "scalars.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    losses = [{k[6:]: v for k, v in r.items() if k.startswith("train/")}
              for r in rows if any(k.startswith("train/") for k in r)]
    assert len(losses) == 2
    assert "loss_reg" not in losses[0]
    assert all(np.isfinite(v) for h in losses for v in h.values())
    assert not glob.glob(os.path.join(run_dir, "*preds*.jsonl"))
    with open(os.path.join(run_dir, "latest_metric.jsonl")) as f:
        (metrics,) = [json.loads(line) for line in f]
    assert 0 <= metrics["brief"]["mAP"] <= 1
