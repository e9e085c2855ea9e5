"""The Charades-STA presets through the port's MR path vs the JAX package.

`charades` (Lv 256 at full size, conf kernel 5), `charades_internvideo2`
(conf kernel 7, 2 conv layers) and `charades_vgg` (VGG video, 300-d GloVe
text from a GloVe file this test writes, clip 1/6 s, the VGG
post-processor) at small widths, each with Lv 300 over JAX attn_chunk 128
(the flash path): the dataset's features (GloVe text bit for bit), then
run_mr_inference's submissions and NMS rows (windows within 2e-3) and
eval_submission's brief metrics (within 0.02 points), the tolerances of
__graft_entry__.py:172-197, as tests/test_torch_long.py holds `tacos`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch_threads  # noqa: F401  (torch's share of the cores under xdist)

from flashvtg_tpu.data.dataset import VTGDataset as JaxDataset
from flashvtg_tpu.eval.metrics import eval_submission as jax_eval
from flashvtg_tpu.train.config import from_preset as jax_preset
from flashvtg_tpu.train.infer import run_mr_inference as jax_run
from flashvtg_tpu.train.loop import _dataset_cfg
from flashvtg_tpu_torch.data.dataset import VTGDataset
from flashvtg_tpu_torch.data.glove import GloveEmbedder
from flashvtg_tpu_torch.eval.metrics import eval_submission
from flashvtg_tpu_torch.models.flashvtg import FlashVTGModel
from flashvtg_tpu_torch.train.config import from_preset
from flashvtg_tpu_torch.train.infer import eval_data_config, run_mr_inference
from flashvtg_tpu_torch.utils.convert import state_dict_from_jax
from flashvtg_tpu_torch.utils.synthetic import CHARADES_WORDS, make_synthetic_charades, write_glove

SMALL = dict(
    t_feat_dim=32, hidden_dim=64, nheads=2, dim_feedforward=128, t2v_layers=2,
    enc_layers=2, dummy_layers=1, num_dummies=6, num_mlp_layers=2, max_v_l=300,
    max_q_l=10, attn_chunk=128, eval_bsz=4, nms_thd=0.7,
)
# (video width, writer options); charades_vgg keeps its 4096-d video, which
# selects the VGG post-processor
PRESETS = {
    "charades": (48, dict(clip_len=1.0, min_duration=20.0, max_duration=320.0)),
    "charades_internvideo2": (48, dict(clip_len=1.0, min_duration=20.0, max_duration=320.0)),
    "charades_vgg": (4096, dict(clip_len=0.166666, max_duration=60.0, glove=True)),
}
QUERIES = 10  # batches of 4 and 4, then the 2 tail


def _setup(preset, root, monkeypatch):
    v_dim, opts = PRESETS[preset]
    ann, vdir, qdir = make_synthetic_charades(
        root, n_queries=QUERIES, v_dim=v_dim, t_dim=SMALL["t_feat_dim"], seed=5,
        max_clips=SMALL["max_v_l"] + 20, max_q_tokens=SMALL["max_q_l"] + 2, **opts)
    if opts.get("glove"):
        monkeypatch.setenv("FLASHVTG_GLOVE_PATH",
                           write_glove(f"{root}/glove.txt", dim=SMALL["t_feat_dim"], seed=6))
    data = dict(eval_path=ann, v_feat_dirs=(vdir,), t_feat_dir=qdir, v_feat_dim=v_dim)
    return (from_preset(preset, **SMALL, **data),
            jax_preset(preset, **SMALL, **data, device_feed="off"), ann)


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_charades_dataset_matches_jax(tmp_path, preset, monkeypatch):
    cfg, jcfg, ann = _setup(preset, str(tmp_path), monkeypatch)
    ds = VTGDataset(eval_data_config(cfg, ann))
    jds = JaxDataset(_dataset_cfg(jcfg, ann, load_labels=False))
    assert ds.use_glove == (preset == "charades_vgg") == jds.use_glove
    lens = []
    for i in range(len(ds)):
        (meta, got), (_, want) = ds[i], jds[i]
        assert sorted(got) == sorted(want)
        lens.append(len(got["video_feat"]))
        if ds.use_glove:  # GloVe text: bit for bit, OOV words zero
            np.testing.assert_array_equal(got["query_feat"], want["query_feat"])
            words = meta["query"].split()
            assert got["query_feat"].shape == (len(words), cfg.t_feat_dim)
            oov = [w == CHARADES_WORDS[-1] for w in words]
            assert not got["query_feat"][oov].any() and got["query_feat"][np.logical_not(oov)].all()
        else:  # the JAX native loader l2-normalises in its own order (1 ulp)
            np.testing.assert_allclose(got["query_feat"], want["query_feat"], rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(got["video_feat"], want["video_feat"], rtol=1e-6, atol=1e-7)
    assert max(lens) == cfg.max_v_l and min(lens) < cfg.max_v_l  # cut and padded videos


@pytest.fixture(scope="module", params=sorted(PRESETS))
def charades_runs(request, tmp_path_factory):
    preset = request.param
    mp = pytest.MonkeyPatch()
    try:
        cfg, jcfg, ann = _setup(preset, str(tmp_path_factory.mktemp(preset)), mp)
        jmodel = jcfg.build_model()
        lv, lq = jcfg.max_v_l, jcfg.max_q_l
        params = jax.jit(jmodel.init, static_argnames="train")(
            {"params": jax.random.PRNGKey(8)},
            jnp.zeros((1, lq, jcfg.t_feat_dim)), jnp.ones((1, lq)),
            jnp.zeros((1, lv, jcfg.total_v_feat_dim)), jnp.ones((1, lv)), train=False,
        )
        jds = JaxDataset(_dataset_cfg(jcfg, ann, load_labels=False))
        j_sub, j_nms, _ = jax_run(jcfg, jmodel, params, jds)
        model = FlashVTGModel(cfg.model_config()).eval()
        model.load_state_dict(
            state_dict_from_jax(jax.tree.map(np.asarray, params), cfg.model_config()),
            strict=True)
        ds = VTGDataset(eval_data_config(cfg, ann))
        t_sub, t_nms, _ = run_mr_inference(cfg, model, ds)
    finally:
        mp.undo()
    return dict(cfg=cfg, jax=(j_sub, j_nms), port=(t_sub, t_nms), gt=ds.data)


@pytest.mark.parametrize("which", ["plain", "nms"])
def test_charades_submissions_match_jax(charades_runs, which):
    k = 0 if which == "plain" else 1
    ours, ref = charades_runs["port"][k], charades_runs["jax"][k]
    assert len(ours) == len(ref) == QUERIES
    for a, b in zip(ours, ref):
        assert (a["qid"], a["vid"], a["query"]) == (b["qid"], b["vid"], b["query"])
        assert "pred_saliency_scores" not in a and "pred_saliency_scores" not in b
        pa = np.asarray(a["pred_relevant_windows"], np.float64)
        pb = np.asarray(b["pred_relevant_windows"], np.float64)
        assert pa.shape == pb.shape, a["qid"]
        np.testing.assert_allclose(pa, pb, atol=2e-3, rtol=0)
    if which == "plain":  # the post-processor's rounding to the clip grid
        clip = charades_runs["cfg"].clip_length
        wins = np.concatenate([np.asarray(a["pred_relevant_windows"])[:, :2] for a in ours])
        np.testing.assert_allclose(wins / clip, np.round(wins / clip), atol=1e-6)


@pytest.mark.parametrize("which", ["plain", "nms"])
def test_charades_brief_metrics_match_jax(charades_runs, which):
    k = 0 if which == "plain" else 1
    ours = eval_submission(charades_runs["port"][k], charades_runs["gt"])["brief"]
    ref = jax_eval(charades_runs["jax"][k], charades_runs["gt"], verbose=False)["brief"]
    assert list(ours) == list(ref) and "MR-full-R1@0.5" in ours
    for key, v in ref.items():
        assert np.isfinite(ours[key]) and abs(ours[key] - v) <= 0.02, (key, ours[key], v)


def test_glove_embedder_reads_the_written_file(tmp_path, monkeypatch):
    path = write_glove(str(tmp_path / "glove.txt"), dim=5, seed=1)
    monkeypatch.setenv("FLASHVTG_GLOVE_PATH", path)
    emb = GloveEmbedder.default()
    assert emb.dim == 5 and len(emb.stoi) == len(CHARADES_WORDS) - 1
    out = emb("Person opens THE zzunknown door")
    assert out.shape == (5, 5) and not out[3].any() and out[[0, 1, 2, 4]].all()
