"""flashvtg_tpu_torch/tools/visualize.py against flashvtg_tpu/tools/visualize.py,
on the CPU.

One port checkpoint (a reference-format `.ckpt` with its opt.json), whose
weights come from a JAX init through utils/convert.py, is read by both
tools: `export_attention_maps` of the port (the eval forward, its ACA
layers through the kernels' plain versions here) against the JAX tool's on
the same query, every map within 3e-4 (the eval tolerance), for the core
model and FlashVTG_ms (the phrase maps). The plots (query, comparison,
attention, attention bundle, phrase bundle) and the CLI write their PNGs.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch_threads  # noqa: F401  (torch's share of the cores under xdist)
import torch

from flashvtg_tpu.tools import visualize as jax_visualize
from flashvtg_tpu.train.config import from_preset as jax_preset
from flashvtg_tpu_torch.tools import visualize
from flashvtg_tpu_torch.train.config import from_preset
from flashvtg_tpu_torch.utils.convert import (
    save_torch_checkpoint,
    state_dict_from_jax,
    state_dict_from_jax_ms,
)
from flashvtg_tpu_torch.utils.io import load_jsonl, save_jsonl
from flashvtg_tpu_torch.utils.synthetic import make_synthetic_qvh

CORE = dict(v_feat_dim=40, t_feat_dim=24, hidden_dim=64, nheads=2, dim_feedforward=96,
            t2v_layers=2, enc_layers=2, dummy_layers=1, num_mlp_layers=2, max_q_l=8,
            num_dummies=4, max_v_l=24)
MS = dict(CORE, hidden_dim=32, nheads=4, dim_feedforward=48, num_dummies=2, t2v_layers=1,
          enc_layers=1, num_conv_layers=1, variant="ms", num_phrase=2, phrase_layers=1,
          context_layers=1, rank=2, t_sa=1)
CASES = {"core": CORE, "ms": MS}
ATOL = 3e-4


def _checkpoint(root, name):
    """(ckpt path, gt jsonl, a qid): a JAX init's weights in a port `.ckpt`
    with the port's opt.json beside it."""
    kw = CASES[name]
    ann, vdir, qdir = make_synthetic_qvh(
        os.path.join(root, "data"), n_queries=3, v_dim=kw["v_feat_dim"],
        t_dim=kw["t_feat_dim"], n_clips=kw["max_v_l"], seed=9, min_clips=10,
        max_q_tokens=kw["max_q_l"] + 1, split="val")
    data = dict(eval_path=ann, v_feat_dirs=(vdir,), t_feat_dir=qdir)
    cfg = from_preset("qvhighlights_slowclip", **kw, **data)
    jcfg = jax_preset("qvhighlights_slowclip", **kw, **data)
    jmodel = jcfg.build_model()
    lv, lq = cfg.max_v_l, cfg.max_q_l
    params = jax.jit(jmodel.init, static_argnames="train")(
        {"params": jax.random.PRNGKey(4)},
        jnp.zeros((1, lq, cfg.t_feat_dim)), jnp.ones((1, lq)),
        jnp.zeros((1, lv, cfg.total_v_feat_dim)), jnp.ones((1, lv)), train=False,
    )
    params = jax.tree.map(np.asarray, params)
    to_sd = state_dict_from_jax_ms if name == "ms" else state_dict_from_jax
    run = os.path.join(root, name)
    os.makedirs(run)
    ckpt = os.path.join(run, "model_best.ckpt")
    save_torch_checkpoint(ckpt, to_sd(params, cfg.model_config(), np.float32))
    cfg.save(os.path.join(run, "opt.json"))
    return ckpt, ann, str(load_jsonl(ann)[1]["qid"])


@pytest.fixture(scope="module", params=sorted(CASES))
def exported(request, tmp_path_factory):
    root = str(tmp_path_factory.mktemp(f"vis_{request.param}"))
    ckpt, gt, qid = _checkpoint(root, request.param)
    maps, meta, lv = visualize.export_attention_maps(ckpt, gt, qid, "cpu")
    jmaps, jmeta, jlv = jax_visualize.export_attention_maps(ckpt, gt, qid)
    return dict(name=request.param, root=root, ckpt=ckpt, gt=gt, qid=qid, maps=maps,
                meta=meta, lv=lv, jmaps=jmaps, jmeta=jmeta, jlv=jlv)


def test_export_attention_maps_match_jax(exported):
    maps, jmaps = exported["maps"], exported["jmaps"]
    assert exported["lv"] == exported["jlv"] and exported["meta"] == exported["jmeta"]
    assert sorted(maps) == sorted(jmaps)
    if exported["name"] == "ms":
        assert {"gate", "slot_att", "word_video_attn", "context_emb"} <= set(maps)
    for key, want in jmaps.items():
        got = maps[key]
        assert got.shape == np.shape(want), key
        np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, err_msg=key)


def test_plots_write_pngs(exported, tmp_path):
    maps, meta = exported["maps"], exported["meta"]
    pred = {"qid": meta["qid"], "query": meta.get("query", ""),
            "pred_saliency_scores": maps["saliency"].tolist(),
            "pred_relevant_windows": [[2.0, 10.0, 0.9], [12.0, 20.0, 0.4]]}
    other = dict(pred, pred_relevant_windows=[[4.0, 8.0, 0.7]])
    outs = [
        visualize.plot_query(pred, meta, str(tmp_path / "q.png")),
        visualize.plot_query(pred, meta, str(tmp_path / "cmp.png"), other_row=other,
                             labels=("a", "b")),
        visualize.plot_attention(maps["token_attention"], str(tmp_path / "attn.png"),
                                 query_tokens=["w"] * maps["token_attention"].shape[1]),
        visualize.plot_attention_bundle(maps, meta, str(tmp_path / "bundle.png"), 2.0),
    ]
    if exported["name"] == "ms":
        outs.append(visualize.plot_phrase_bundle(maps, meta, str(tmp_path / "phr.png"), 2.0))
    for path in outs:
        assert os.path.getsize(path) > 1000, path


def test_cli_writes_figures(exported, tmp_path, capsys):
    preds = str(tmp_path / "preds.jsonl")
    meta = exported["meta"]
    save_jsonl([{"qid": meta["qid"], "query": meta.get("query", ""),
                 "pred_saliency_scores": exported["maps"]["saliency"].tolist(),
                 "pred_relevant_windows": [[0.0, 6.0, 0.8]]}], preds)
    out = str(tmp_path / "fig.png")
    argv = ["--preds", preds, "--compare", preds, "--gt", exported["gt"], "--qid",
            exported["qid"], "--out", out, "--attention", "--ckpt", exported["ckpt"],
            "--device", "cpu"]
    if exported["name"] == "ms":
        argv.append("--phrase")
    visualize.main(argv)
    printed = capsys.readouterr().out.split()
    want = [out, str(tmp_path / "fig_attn.png")]
    if exported["name"] == "ms":
        want.append(str(tmp_path / "fig_phrase.png"))
    assert printed == want
    for path in want:
        assert os.path.getsize(path) > 1000, path


def test_export_refuses_unknown_qid(exported):
    with pytest.raises(SystemExit, match="not found"):
        visualize.export_attention_maps(exported["ckpt"], exported["gt"], "no-such-qid", "cpu")


def test_cli_on_the_card_needs_cuda(exported):
    """The default device is the card: without one the export raises, and
    never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        visualize.export_attention_maps(exported["ckpt"], exported["gt"], exported["qid"])


def test_maps_are_the_eval_forward(exported):
    """The token attention is the eval forward's layer-averaged ACA map over
    the valid text tokens: rows of probabilities over every key, so each row
    of the real-token slice sums to at most 1."""
    tok = exported["maps"]["token_attention"]
    assert tok.ndim == 2 and tok.shape[0] == exported["lv"]
    assert np.all(tok >= 0) and np.all(tok.sum(axis=1) <= 1 + 1e-5)
