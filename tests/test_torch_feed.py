"""The device-resident feed (data/feed.py), features_only, the collator's
pad_features, and the packed, pipelined eval (train/infer.py) of the port
against the JAX package and against the per-batch path, on the CPU.

The feed's rows are the JAX feed's: its loader reads the features within
1e-6 of the port's (tests/test_torch_infer.py), so the rows agree within
that in float32 and within one bf16 step where a feature rounds to bf16 on
either side of a tie. Eval with the feed is bit-equal to the streamed eval
(the same rows gathered by index), and within the cross-stack tolerances of
tests/test_torch_infer.py (windows and saliency 2e-3, brief metrics 0.02
points) of the JAX package's eval with its feed. The packed step's one
(B, C) tensor unpacks to the unpacked step's outputs bit for bit, and
run_mr_inference gives the rows and eval losses of a loop that fetches
every output of every batch on its own, as the eval did before.
"""

import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch_threads  # noqa: F401  (torch's share of the cores under xdist)
import torch

from flashvtg_tpu.data.collate import Collator as JaxCollator
from flashvtg_tpu.data.dataset import VTGDataset as JaxDataset
from flashvtg_tpu.data.feed import build_device_feed as jax_build_feed
from flashvtg_tpu.data.feed import estimate_feed_bytes as jax_estimate
from flashvtg_tpu.eval.metrics import eval_submission as jax_eval
from flashvtg_tpu.train.config import from_preset as jax_preset
from flashvtg_tpu.train.infer import run_mr_inference as jax_run
from flashvtg_tpu.train.loop import _dataset_cfg
from flashvtg_tpu_torch.data.collate import MODEL_KEYS, TRAIN_KEYS, Collator
from flashvtg_tpu_torch.data.dataset import VTGDataset
from flashvtg_tpu_torch.data.feed import (
    FEED_KEYS,
    build_device_feed,
    estimate_feed_bytes,
    resident_feed_bytes,
)
from flashvtg_tpu_torch.eval.metrics import eval_submission
from flashvtg_tpu_torch.models import build_model
from flashvtg_tpu_torch.models.points import pyramid_masks_strict
from flashvtg_tpu_torch.train import infer
from flashvtg_tpu_torch.train.config import from_preset
from flashvtg_tpu_torch.train.infer import (
    eval_data_config,
    make_eval_step,
    run_hl_inference,
    run_mr_inference,
)
from flashvtg_tpu_torch.utils.convert import state_dict_from_jax
from flashvtg_tpu_torch.utils.observability import counter
from flashvtg_tpu_torch.utils.synthetic import make_synthetic_qvh, make_synthetic_tvsum

SMALL = dict(
    v_feat_dim=48, t_feat_dim=32, t2v_layers=1, enc_layers=1, dummy_layers=1,
    num_dummies=4, hidden_dim=64, dim_feedforward=128, num_mlp_layers=2, max_v_l=24,
    max_q_l=10, eval_bsz=8, nms_thd=0.7,
)
MS = dict(
    hidden_dim=32, nheads=4, dim_feedforward=48, num_dummies=2, t2v_layers=1, enc_layers=1,
    dummy_layers=1, num_conv_layers=1, num_mlp_layers=2, num_phrase=2, phrase_layers=1,
    context_layers=1, rank=2, t_sa=1, v_feat_dim=48, t_feat_dim=32, max_v_l=24,
    max_q_l=10, eval_bsz=8, variant="ms", use_dfl=True,
)
N_QUERIES = 22  # batches of 8, 8, then the 4 + 2 binary tail


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("feed"))
    ann, vdir, qdir = make_synthetic_qvh(root, n_queries=N_QUERIES, v_dim=48, t_dim=32,
                                         n_clips=24, min_clips=6, seed=3)
    return dict(eval_path=ann, v_feat_dirs=(vdir,), t_feat_dir=qdir)


def _datasets(split, load_labels=False, **kw):
    cfg = from_preset("qvhighlights_slowclip", **SMALL, **split, **kw)
    jcfg = jax_preset("qvhighlights_slowclip", **SMALL, **split, **kw)
    ds = VTGDataset(eval_data_config(cfg, split["eval_path"], load_labels=load_labels))
    jds = JaxDataset(_dataset_cfg(jcfg, split["eval_path"], load_labels=load_labels))
    return cfg, jcfg, ds, jds


@pytest.mark.parametrize("args", [
    (7218, 75, 2818, 32, 512, 4),  # QVHighlights train at the flagship's widths
    (7218, 75, 2818, 32, 512, 2),  # the bf16 wire
    (9790, 2048, 770, 40, 4096, 4),  # a TACoS-scale split
    (22, 24, 50, 10, 32, 4),
])
def test_estimate_feed_bytes_equals_jax(args):
    assert estimate_feed_bytes(*args) == jax_estimate(*args)


def test_flagship_feed_sizes():
    """The sizes the configs' budget gates see: 911,364 B a flagship row in
    f32 (6.13 GiB for QVHighlights' 7,218 train queries), half on the bf16
    wire, and a TACoS row's 6.97 MB, so the default 8 GiB admits about 1,230
    TACoS rows."""
    assert estimate_feed_bytes(1, 75, 2818, 32, 512) == 911_364
    assert round(estimate_feed_bytes(7218, 75, 2818, 32, 512) / 2**30, 2) == 6.13
    assert estimate_feed_bytes(7218, 75, 2818, 32, 512, 2) * 2 == estimate_feed_bytes(
        7218, 75, 2818, 32, 512)
    tacos = from_preset("tacos")
    tacos_row = estimate_feed_bytes(1, tacos.max_v_l, tacos.total_v_feat_dim, tacos.max_q_l,
                                    tacos.t_feat_dim)
    assert tacos_row == 6_971_552
    assert 8 * 2**30 // tacos_row == 1232


@pytest.mark.parametrize("narrow", [None, "bfloat16"])
def test_feed_rows_match_jax(split, narrow):
    cfg, jcfg, ds, jds = _datasets(split)
    fixed = cfg.max_v_l
    coll = Collator(cfg.max_q_l, cfg.v_buckets, fixed, dset_name=cfg.dset_name)
    jcoll = JaxCollator(jcfg.max_q_l, jcfg.v_buckets, dset_name=jcfg.dset_name,
                        fixed_v_len=fixed)
    feed = build_device_feed(ds, coll, "cpu", dtype=None if narrow is None else torch.bfloat16,
                             chunk=7)
    jfeed = jax_build_feed(jds, jcoll, dtype=narrow, chunk=7)
    assert set(feed) == set(jfeed) == set(FEED_KEYS)
    whole = coll([ds[i] for i in range(len(ds))])
    for key in FEED_KEYS:
        ours, ref = feed[key].float().numpy(), np.asarray(jfeed[key]).astype(np.float32)
        assert ours.shape == ref.shape == (N_QUERIES,) + whole[key].shape[1:]
        narrowed = narrow is not None and key in ("src_vid", "src_txt")
        # one bf16 step of the value where the two loaders straddle a tie
        np.testing.assert_allclose(ours, ref, rtol=2**-8 if narrowed else 0, atol=1e-6,
                                   err_msg=key)
        own = torch.from_numpy(whole[key])
        own = own.to(torch.bfloat16).float() if narrowed else own
        assert torch.equal(feed[key].float(), own), key  # the collated rows, exactly
        assert feed[key].dtype == (torch.bfloat16 if narrowed else torch.float32)


def test_features_only_draws_no_labels(split):
    _, _, ds, jds = _datasets(split, load_labels=True)
    for d in (ds, jds):
        state = d.rng.getstate()
        for i in range(len(d)):
            meta, x = d.features_only(i)
            assert "saliency_all_labels" not in x and "gt_windows" not in x
        assert d.rng.getstate() == state
    _, full = ds[3]
    _, feats = ds.features_only(3)
    for key in ("video_feat", "query_feat"):
        assert np.array_equal(full[key], feats[key])


@pytest.mark.parametrize("pad", [True, False])
def test_pad_features_keys_match_jax(split, pad):
    cfg, jcfg, ds, jds = _datasets(split, load_labels=True)
    coll = Collator(cfg.max_q_l, cfg.v_buckets, cfg.max_v_l, dset_name=cfg.dset_name,
                    pad_features=pad)
    jcoll = JaxCollator(jcfg.max_q_l, jcfg.v_buckets, dset_name=jcfg.dset_name,
                        fixed_v_len=jcfg.max_v_l, pad_features=pad)
    batch = coll([ds[i] for i in range(4)])
    jbatch = jcoll([jds[i] for i in range(4)])
    assert set(batch) == set(jbatch)
    assert all((k in batch) == pad for k in MODEL_KEYS)
    for key in set(TRAIN_KEYS) - set(MODEL_KEYS):
        np.testing.assert_array_equal(batch[key], jbatch[key], err_msg=key)


def test_resident_feed_bytes_frees_a_deleted_feed(split):
    cfg, _, ds, _ = _datasets(split)
    gc.collect()
    before = resident_feed_bytes()
    coll = Collator(cfg.max_q_l, cfg.v_buckets, cfg.max_v_l, dset_name=cfg.dset_name)
    feed = build_device_feed(ds, coll, "cpu")
    size = sum(t.numel() * t.element_size() for t in feed.values())
    assert size == estimate_feed_bytes(N_QUERIES, cfg.max_v_l, cfg.total_v_feat_dim,
                                       cfg.max_q_l, cfg.t_feat_dim)
    assert resident_feed_bytes() == before + size
    del feed
    gc.collect()
    assert resident_feed_bytes() == before


def _jax_params(jcfg, key=1):
    jmodel = jcfg.build_model()
    lv, lq = jcfg.max_v_l, jcfg.max_q_l
    params = jax.jit(jmodel.init, static_argnames="train")(
        {"params": jax.random.PRNGKey(key)},
        jnp.zeros((1, lq, jcfg.t_feat_dim)), jnp.ones((1, lq)),
        jnp.zeros((1, lv, jcfg.total_v_feat_dim)), jnp.ones((1, lv)), train=False,
    )
    return jmodel, params


def _port_model(cfg, params=None, seed=0):
    model = build_model(cfg.model_config(), "cpu", seed)
    if params is not None:
        model.load_state_dict(
            state_dict_from_jax(jax.tree.map(np.asarray, params), cfg.model_config()),
            strict=True)
    return model.eval()


@pytest.fixture(scope="module")
def evals(split):
    """The same JAX init through the JAX eval with its feed and the port's
    eval with the feed, without it, and with labels and eval losses."""
    jcfg = jax_preset("qvhighlights_slowclip", **SMALL, **split, device_feed="on")
    jmodel, params = _jax_params(jcfg)
    jds = JaxDataset(_dataset_cfg(jcfg, split["eval_path"], load_labels=False))
    j_sub, j_nms, _ = jax_run(jcfg, jmodel, params, jds)
    out = {"jax": (j_sub, j_nms)}
    for mode in ("on", "off"):
        cfg = from_preset("qvhighlights_slowclip", **SMALL, **split, device_feed=mode)
        model = _port_model(cfg, params)
        ds = VTGDataset(eval_data_config(cfg, split["eval_path"]))
        out[mode] = run_mr_inference(cfg, model, ds)
        out[mode + "_fed"] = getattr(ds, "_device_feed_cache", None) is not None
        lds = VTGDataset(eval_data_config(cfg, split["eval_path"], load_labels=True))
        out[mode + "_losses"] = run_mr_inference(cfg, model, lds, loss_cfg=cfg.loss_config())
    out["gt"] = ds.data
    return out


def test_eval_with_feed_equals_streamed(evals):
    assert evals["on_fed"] and not evals["off_fed"]
    assert evals["on"] == evals["off"]
    assert evals["on_losses"] == evals["off_losses"]
    assert evals["on_losses"][2]  # the eval losses were computed


@pytest.mark.parametrize("which", [0, 1])
def test_eval_with_feed_matches_jax_feed(evals, which):
    ours, ref = evals["on"][which], evals["jax"][which]
    assert [r["qid"] for r in ours] == [r["qid"] for r in ref]
    for a, b in zip(ours, ref):
        for fld in ("pred_relevant_windows", "pred_saliency_scores"):
            np.testing.assert_allclose(np.asarray(a[fld], np.float64),
                                       np.asarray(b[fld], np.float64), atol=2e-3, rtol=0)
    ob = eval_submission(ours, evals["gt"])["brief"]
    rb = jax_eval(ref, evals["gt"], verbose=False)["brief"]
    for key, v in rb.items():
        assert abs(ob[key] - v) <= 0.02, (key, ob[key], v)


def _per_batch_mr(cfg, model, ds, loss_cfg):
    """run_mr_inference's rows before NMS and its eval losses, by the
    per-batch loop that fetched spans, scores, saliency and the losses one
    by one (the port's eval before the packed step)."""
    fixed, order = infer._eval_plan(cfg, ds)
    coll = Collator(cfg.max_q_l, cfg.v_buckets, fixed, cfg.max_windows, cfg.dset_name)
    step = make_eval_step(model, cfg.max_num_moment, cfg.eval_precision, loss_cfg=loss_cfg)
    rows, sums, n = [], {}, 0
    for real, _, batch in infer._batched(ds, coll, cfg.eval_bsz, order):
        lv = batch["src_vid"].shape[1]
        strict, counts = pyramid_masks_strict(batch["valid_v_lens"], lv, cfg.strides)
        strict = infer._strict_or_none(strict, batch["valid_v_lens"], lv)
        dev = {k: torch.from_numpy(batch[k]) for k in (TRAIN_KEYS if loss_cfg else MODEL_KEYS)}
        spans, scores, sal, losses = step(dev, None if strict is None else
                                          torch.from_numpy(strict))
        values = torch.stack(list(losses.values())).tolist() if losses else []
        for k, v in zip(losses, values):
            sums[k] = sums.get(k, 0.0) + v * real
        n += real
        sal_r = np.round(sal.numpy().astype(np.float64), 4)
        for j in range(real):
            m = min(cfg.max_num_moment, int(counts[j]))
            win = np.clip(spans.numpy()[j, :m], 0, batch["meta"][j].get("duration", 1e9))
            rows.append((batch["meta"][j]["qid"], np.round(np.concatenate(
                [win, scores.numpy()[j, :m, None]], axis=1).astype(np.float64), 4).tolist(),
                sal_r[j, : int(batch["valid_v_lens"][j])].tolist()))
    return rows, {k: v / n for k, v in sums.items()}


@pytest.mark.parametrize("variant", ["core", "ms"])
def test_packed_pipelined_mr_equals_per_batch(split, variant, monkeypatch):
    kw = SMALL if variant == "core" else MS
    cfg = from_preset("qvhighlights_slowclip", **kw, **split)
    model = _port_model(cfg, seed=4)
    loss_cfg = cfg.loss_config()
    want_rows, want_losses = _per_batch_mr(
        cfg, model, VTGDataset(eval_data_config(cfg, split["eval_path"], load_labels=True)),
        loss_cfg)
    monkeypatch.setattr(infer, "build_post_processor", lambda *a: lambda s: s)
    for mode in ("on", "off"):
        c = cfg.replace(device_feed=mode, nms_thd=-1)
        fetches = counter("eval.fetches")
        sub, _, losses = run_mr_inference(
            c, model, VTGDataset(eval_data_config(c, split["eval_path"], load_labels=True)),
            loss_cfg=loss_cfg)
        assert counter("eval.fetches") - fetches == 4  # one a batch: 8, 8, 4, 2
        assert [(r["qid"], r["pred_relevant_windows"], r["pred_saliency_scores"])
                for r in sub] == want_rows
        assert list(losses) == list(want_losses) and losses == want_losses


@pytest.mark.parametrize("variant", ["tvsum", "tvsum_ms"])
def test_packed_hl_step_equals_unpacked(tmp_path, variant):
    ann, vdir, qdir = make_synthetic_tvsum(str(tmp_path), n_queries=5, v_dim=24, t_dim=16,
                                           min_clips=20, max_clips=40, seed=2)
    kw = dict(MS if variant.endswith("ms") else SMALL, v_feat_dim=24, t_feat_dim=16,
              max_v_l=40, eval_bsz=4, eval_path=ann, v_feat_dirs=(vdir,), t_feat_dir=qdir,
              dset_domain="BK")
    kw.pop("variant", None)
    kw.pop("use_dfl", None)
    cfg = from_preset(variant, **kw)
    model = _port_model(cfg, seed=1)
    ds = VTGDataset(eval_data_config(cfg, ann))
    batch = Collator(cfg.max_q_l, cfg.v_buckets, cfg.max_v_l, dset_name=cfg.dset_name)(
        [ds[i] for i in range(4)])
    dev = {k: torch.from_numpy(batch[k]) for k in MODEL_KEYS}
    plain = make_eval_step(model, cfg.max_num_moment, saliency_only=True)
    packed = make_eval_step(model, cfg.max_num_moment, saliency_only=True, packed=True)
    _, _, sal, _ = plain(dev, None)
    spans, scores, psal, losses = packed.unpack(packed(dev, None).numpy(), cfg.max_v_l)
    assert spans is None and scores is None and losses == {}
    assert np.array_equal(psal, sal.numpy())
    on = run_hl_inference(cfg.replace(device_feed="on"), model, VTGDataset(
        eval_data_config(cfg, ann)))
    off = run_hl_inference(cfg.replace(device_feed="off"), model, VTGDataset(
        eval_data_config(cfg, ann)))
    assert on["brief"] == off["brief"]
    assert set(on["saliency"]) == set(off["saliency"])
    assert all(np.array_equal(on["saliency"][q], off["saliency"][q]) for q in on["saliency"])
