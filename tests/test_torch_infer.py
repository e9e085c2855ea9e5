"""Port run_mr_inference + apply_nms + eval_submission vs the JAX pipeline on
one synthetic QVH-format set with the same weights, on the CPU.

Tolerances follow the cross-stack scheme of __graft_entry__.py:172-197:
equal row counts and qids, windows and saliency within 2e-3 (a float32
ulp can flip a 4th-decimal rounding), brief metrics within 0.02 points. The
port's metric suite must give exactly the JAX suite's dict on one
submission. With a loss_cfg on a labelled copy of the set, the eval losses
(means over the split, the 4 + 2 tail weighed by its rows) match the JAX
package's within rtol 1e-5 (f32 forwards, sums in other orders), and the
rows are the ones without it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch_threads  # noqa: F401  (torch's share of the cores under xdist)
import torch

from flashvtg_tpu.data.dataset import VTGDataset as JaxDataset
from flashvtg_tpu.eval.metrics import eval_submission as jax_eval
from flashvtg_tpu.train.config import from_preset as jax_preset
from flashvtg_tpu.train.infer import apply_nms as jax_apply_nms
from flashvtg_tpu.train.infer import run_mr_inference as jax_run
from flashvtg_tpu.train.loop import _dataset_cfg
from flashvtg_tpu_torch.data.dataset import VTGDataset
from flashvtg_tpu_torch.eval.metrics import eval_submission
from flashvtg_tpu_torch.models.flashvtg import FlashVTGModel
from flashvtg_tpu_torch.train.config import from_preset
from flashvtg_tpu_torch.train.infer import apply_nms, eval_data_config, run_mr_inference
from flashvtg_tpu_torch.utils.convert import state_dict_from_jax
from flashvtg_tpu_torch.utils.synthetic import make_synthetic_qvh

SMALL = dict(
    v_feat_dim=48, t_feat_dim=32, t2v_layers=2, enc_layers=2,
    dummy_layers=1, num_dummies=4, hidden_dim=64, dim_feedforward=128,
    num_mlp_layers=2, max_v_l=24, max_q_l=10, eval_bsz=8, nms_thd=0.7,
)
N_QUERIES = 22  # batches of 8, 8, then the 4 + 2 binary tail


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("synth"))
    ann, vdir, qdir = make_synthetic_qvh(
        root, n_queries=N_QUERIES, v_dim=48, t_dim=32, n_clips=24, min_clips=6,
        seed=3,
    )
    data = dict(eval_path=ann, v_feat_dirs=(vdir,), t_feat_dir=qdir)

    jcfg = jax_preset("qvhighlights_slowclip", **SMALL, **data, device_feed="off")
    jmodel = jcfg.build_model()
    lv, lq = jcfg.max_v_l, jcfg.max_q_l
    params = jax.jit(jmodel.init, static_argnames="train")(
        {"params": jax.random.PRNGKey(1)},
        jnp.zeros((1, lq, jcfg.t_feat_dim)), jnp.ones((1, lq)),
        jnp.zeros((1, lv, jcfg.total_v_feat_dim)), jnp.ones((1, lv)),
        train=False,
    )
    jds = JaxDataset(_dataset_cfg(jcfg, ann, load_labels=False))
    j_sub, j_nms, _ = jax_run(jcfg, jmodel, params, jds)

    cfg = from_preset("qvhighlights_slowclip", **SMALL, **data)
    model = FlashVTGModel(cfg.model_config()).eval()
    model.load_state_dict(
        state_dict_from_jax(jax.tree.map(np.asarray, params), cfg.model_config()),
        strict=True,
    )
    ds = VTGDataset(eval_data_config(cfg, ann))
    t_sub, t_nms, _ = run_mr_inference(cfg, model, ds)
    return dict(jax=(j_sub, j_nms), port=(t_sub, t_nms), gt=ds.data, jds=jds, ds=ds,
                jax_run=(jcfg, jmodel, params), port_run=(cfg, model, ann))


def test_features_match_jax_loader(runs):
    for i in (0, 3, len(runs["ds"]) - 1):
        (_, ours), (_, ref) = runs["ds"][i], runs["jds"][i]
        for key in ("query_feat", "video_feat"):  # both through the native loader
            np.testing.assert_array_equal(ours[key], ref[key])
    assert any(len(runs["ds"][i][1]["video_feat"]) < SMALL["max_v_l"]
               for i in range(N_QUERIES))  # short videos exercise point_valid


@pytest.mark.parametrize("which", ["plain", "nms"])
def test_submissions_match_jax(runs, which):
    k = 0 if which == "plain" else 1
    ours, ref = runs["port"][k], runs["jax"][k]
    assert len(ours) == len(ref) == N_QUERIES
    for a, b in zip(ours, ref):
        assert (a["qid"], a["vid"], a["query"]) == (b["qid"], b["vid"], b["query"])
        for fld in ("pred_relevant_windows", "pred_saliency_scores"):
            pa, pb = np.asarray(a[fld], np.float64), np.asarray(b[fld], np.float64)
            assert pa.shape == pb.shape, (a["qid"], fld)
            np.testing.assert_allclose(pa, pb, atol=2e-3, rtol=0, err_msg=fld)


@pytest.mark.parametrize("which", ["plain", "nms"])
def test_brief_metrics_match_jax(runs, which):
    k = 0 if which == "plain" else 1
    ours = eval_submission(runs["port"][k], runs["gt"])["brief"]
    ref = jax_eval(runs["jax"][k], runs["gt"], verbose=False)["brief"]
    assert list(ours) == list(ref)
    for key, v in ref.items():
        assert abs(ours[key] - v) <= 0.02, (key, ours[key], v)


def test_metric_suite_equals_jax_on_one_submission(runs):
    for sub in (runs["jax"][0], runs["jax"][1], runs["port"][1]):
        assert eval_submission(sub, runs["gt"]) == jax_eval(sub, runs["gt"], verbose=False)


def test_apply_nms_parks_ragged_rows_like_jax(runs):
    sub = [dict(s) for s in runs["jax"][0][:6]]
    for i, s in enumerate(sub):  # ragged candidate lists
        s["pred_relevant_windows"] = s["pred_relevant_windows"][: 50 - 7 * i]
    for nms_type in ("normal", "linear"):
        ours = apply_nms(sub, 0.5, nms_type, device="cpu")
        ref = jax_apply_nms(sub, 0.5, nms_type)
        assert ours == ref


def test_cuda_default_refuses_without_card(runs):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        apply_nms(runs["jax"][0][:2], 0.7, "normal")


def test_eval_losses_match_jax(runs):
    jcfg, jmodel, params = runs["jax_run"]
    cfg, model, ann = runs["port_run"]
    jds = JaxDataset(_dataset_cfg(jcfg, ann, load_labels=True))
    j_sub, _, j_losses = jax_run(jcfg, jmodel, params, jds, loss_cfg=jcfg.loss_config())
    ds = VTGDataset(eval_data_config(cfg, ann, load_labels=True))
    t_sub, t_nms, t_losses = run_mr_inference(cfg, model, ds, loss_cfg=cfg.loss_config())
    assert set(t_losses) == set(j_losses) and "weighted_loss_overall" in t_losses
    for k, v in j_losses.items():
        np.testing.assert_allclose(t_losses[k], v, rtol=1e-5, err_msg=k)
    assert (t_sub, t_nms) == runs["port"]  # the losses change no row
    assert run_mr_inference(cfg, model, runs["ds"], loss_cfg=cfg.loss_config())[2] == {}
