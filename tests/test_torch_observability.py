"""The port's profile trace and NaN tripwire (utils/observability.py) through
train(), on the CPU.

  * profile_dir: train() of 2 epochs writes one torch.profiler trace into
    profile_dir, of the first epoch only (its AdamW steps are the first
    epoch's), which json.load reads;
  * debug_nans: on a split with one NaN feature row, train() raises
    FloatingPointError naming the first module whose output holds a NaN;
    without debug_nans the same run trains on and its losses are not
    finite (the JAX train() with debug_nans does not raise on this split:
    its second step's losses read NaN);
  * debug_nans on a clean split gives the losses and weights of the run
    without it, bit for bit, and leaves no hook and no anomaly mode behind;
  * nan_tripwire names the innermost module first; check_finite_tree names
    each non-finite parameter.
"""

import glob
import json
import logging
import os

import numpy as np
import pytest
import torch

from flashvtg_tpu_torch.train.config import from_preset
from flashvtg_tpu_torch.train.loop import train
from flashvtg_tpu_torch.utils.observability import check_finite_tree, nan_tripwire
from flashvtg_tpu_torch.utils.synthetic import make_synthetic_qvh

SMALL = dict(
    v_feat_dim=40, t_feat_dim=24, hidden_dim=32, nheads=2, dim_feedforward=48,
    t2v_layers=1, enc_layers=1, dummy_layers=1, num_dummies=3, num_mlp_layers=2,
    max_q_l=8, max_v_l=24, bsz=4, use_tensorboard=False, train_precision="float32",
    device_feed="off", exp_id="obs",
)


def _split(root, nan_row=False):
    ann, vdir, qdir = make_synthetic_qvh(root, n_queries=8, v_dim=40, t_dim=24, n_clips=24,
                                         seed=4, split="train", min_clips=10)
    if nan_row:  # one clip of the first video's features
        with open(ann) as f:
            vid = json.loads(f.readline())["vid"]
        path = os.path.join(vdir, f"{vid}.npz")
        feats = np.load(path)["features"]
        feats[3] = np.nan
        np.savez(path, features=feats)
    return dict(train_path=ann, eval_path="", v_feat_dirs=(vdir,), t_feat_dir=qdir)


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    return _split(str(tmp_path_factory.mktemp("obs_split")))


@pytest.fixture(scope="module")
def nan_split(tmp_path_factory):
    return _split(str(tmp_path_factory.mktemp("obs_nan_split")), nan_row=True)


def _run(tmp_path, split, name, **kw):
    cfg = from_preset("qvhighlights_slowclip", **{**SMALL, **split,
                                                  "results_root": str(tmp_path), **kw})
    model, _, run = train(cfg, results_dir=str(tmp_path / name), device="cpu")
    with open(os.path.join(run, "tensorboard_log", "scalars.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    losses = [{k: v for k, v in r.items() if k.startswith("train/")} for r in rows
              if any(k.startswith("train/") for k in r)]
    return model, losses


def test_profile_dir_traces_the_first_epoch(tmp_path, split):
    prof = tmp_path / "prof"
    _, losses = _run(tmp_path, split, "run", n_epoch=2, profile_dir=str(prof))
    assert len(losses) == 4  # 2 epochs of 2 steps
    (trace,) = glob.glob(str(prof / "*.pt.trace.json"))
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    names = [e.get("name", "") for e in events]
    assert sum(n == "Optimizer.step#AdamW.step" for n in names) == 2
    assert any(n.startswith("aten::") for n in names)


def test_debug_nans_raises_on_a_nan_row(tmp_path, nan_split):
    with pytest.raises(FloatingPointError, match="NaN in the output of module"):
        _run(tmp_path, nan_split, "nans", n_epoch=1, debug_nans=True)
    assert not torch.is_anomaly_enabled()
    # without the tripwire the run trains on, its losses not finite
    _, losses = _run(tmp_path, nan_split, "plain", n_epoch=1)
    assert not all(np.isfinite(list(r.values())).all() for r in losses)


def test_debug_nans_on_a_clean_split_changes_nothing(tmp_path, split):
    plain, plain_losses = _run(tmp_path, split, "plain", n_epoch=1)
    checked, checked_losses = _run(tmp_path, split, "checked", n_epoch=1, debug_nans=True)
    assert checked_losses == plain_losses
    want = plain.state_dict()
    assert all(torch.equal(v, want[k]) for k, v in checked.state_dict().items())
    assert not torch.is_anomaly_enabled()
    assert not any(m._forward_hooks for m in checked.modules())


def test_nan_tripwire_names_the_innermost_module():
    model = torch.nn.Sequential(torch.nn.Sequential(torch.nn.Linear(3, 4)), torch.nn.ReLU())
    x = torch.ones(2, 3)
    x[1, 0] = float("nan")
    with pytest.raises(FloatingPointError, match=r"module 0\.0 \(Linear\)"):
        with nan_tripwire(model):
            model(x)
    assert not any(m._forward_hooks for m in model.modules())
    assert not torch.is_anomaly_enabled()
    model(x)  # no tripwire outside


def test_check_finite_tree_names_each_leaf(caplog):
    named = [("a", torch.ones(2)), ("b", torch.tensor([1.0, float("inf")])),
             ("c", torch.tensor([float("nan")]))]
    with caplog.at_level(logging.WARNING):
        assert not check_finite_tree(named, "params")
    assert "params:b" in caplog.text and "params:c" in caplog.text
    assert "params:a" not in caplog.text
    assert check_finite_tree(named[:1], "params")
