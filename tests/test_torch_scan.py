"""The port's train epochs with the device feed, on the CPU: the chunked
(scan) epoch, the prefetch thread, the tensor learning-rate schedule, and
train() with the feed against the JAX package's.

  * scan_steps 4 runs the epoch in chunks (one upload a chunk, the steps
    eager on the CPU; CUDA-graph replays on the card): at the preset's
    dropout, with the same generators, its losses and parameters equal the
    per-step feed epoch's bit for bit, and the streamed epoch's;
  * _prefetched yields in order from one worker, so the dataset's label
    draws are the inline loop's, and re-raises a worker's exception;
  * StepLR sets the optimizer's tensor learning rate to lr * factor(step)
    at every step, and its state_dict is LambdaLR's;
  * port train(device_feed="on", scan_steps=0) and JAX train(device_feed=
    "on", scan_steps=0) from one exported init, dropout 0, float32: step
    losses within rtol 2.2e-6;
  * the forward's host-made constants (models/components.py:
    device_constant) are made and copied once per key and device.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch_threads  # noqa: F401  (torch's share of the cores under xdist)
import torch

from flashvtg_tpu.models.flashvtg import FlashVTGModel as JaxModel
from flashvtg_tpu.parallel.mesh import make_mesh
from flashvtg_tpu.train import config as jax_config
from flashvtg_tpu.train.config import from_preset as jax_preset
from flashvtg_tpu.train.loop import train as jax_train
from flashvtg_tpu.utils.torch_convert import save_torch_checkpoint as jax_save_torch
from flashvtg_tpu_torch.data.collate import Collator
from flashvtg_tpu_torch.data.dataset import VTGDataset
from flashvtg_tpu_torch.models import build_model
from flashvtg_tpu_torch.models.components import device_constant
from flashvtg_tpu_torch.train import config as port_config
from flashvtg_tpu_torch.train.config import from_preset
from flashvtg_tpu_torch.train.loop import (
    _prefetched,
    make_optimizer,
    train,
    train_data_config,
)
from flashvtg_tpu_torch.utils.synthetic import make_synthetic_qvh

SMALL = dict(
    v_feat_dim=40, t_feat_dim=24, hidden_dim=32, nheads=2, dim_feedforward=48,
    t2v_layers=1, enc_layers=1, dummy_layers=1, num_dummies=3, num_mlp_layers=2,
    max_q_l=8, max_v_l=24, bsz=4, use_tensorboard=False, train_precision="float32",
    exp_id="scan",
)
LOSS_RTOL = 2.2e-6


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("scan_split"))
    ann, vdir, qdir = make_synthetic_qvh(root, n_queries=22, v_dim=40, t_dim=24, n_clips=24,
                                         seed=5, split="train", min_clips=10)
    return dict(train_path=ann, eval_path="", v_feat_dirs=(vdir,), t_feat_dir=qdir)


def _losses(run_dir):
    with open(os.path.join(run_dir, "tensorboard_log", "scalars.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return [{k[6:]: v for k, v in r.items() if k.startswith("train/")}
            for r in rows if any(k.startswith("train/") for k in r)]


def _run(tmp_path, split, name, **kw):
    cfg = from_preset("qvhighlights_slowclip", **{**SMALL, **split,
                                                  "results_root": str(tmp_path), **kw})
    model, _, run = train(cfg, results_dir=str(tmp_path / name), device="cpu")
    return {k: v.clone() for k, v in model.state_dict().items()}, _losses(run)


def test_chunked_epoch_equals_per_step(tmp_path, split):
    """2 epochs of 5 steps at the preset's dropout: chunks of 4 (4 + 1 an
    epoch) against one step at a time, and against the streamed epoch."""
    runs = {
        name: _run(tmp_path, split, name, n_epoch=2, **kw)
        for name, kw in (("scan", dict(device_feed="on", scan_steps=4)),
                         ("per_step", dict(device_feed="on", scan_steps=0)),
                         ("streamed", dict(device_feed="off")))
    }
    params, losses = runs["scan"]
    assert len(losses) == 10
    assert SMALL.get("dropout") is None and from_preset("qvhighlights_slowclip").dropout > 0
    for other in ("per_step", "streamed"):
        o_params, o_losses = runs[other]
        assert losses == o_losses, other
        for k, v in params.items():
            assert torch.equal(v, o_params[k]), (other, k)


def test_prefetched_keeps_the_label_stream(split):
    cfg = from_preset("qvhighlights_slowclip", **SMALL, **split)
    coll = Collator(cfg.max_q_l, cfg.v_buckets, cfg.max_v_l, dset_name=cfg.dset_name,
                    pad_features=False)

    def labels(ds, i):
        return coll([ds[j] for j in range(4 * i, 4 * i + 4)])["saliency_pos_labels"]

    inline_ds, fetched_ds = (VTGDataset(train_data_config(cfg, split["train_path"]))
                             for _ in range(2))
    inline = [labels(inline_ds, i) for i in range(5)]
    fetched = list(_prefetched(lambda i: labels(fetched_ds, i), 5))
    assert [i for i, _ in fetched] == list(range(5))
    for a, (_, b) in zip(inline, fetched):
        np.testing.assert_array_equal(a, b)

    def failing(i):
        if i == 2:
            raise KeyError("row 2")
        return i

    got = []
    with pytest.raises(KeyError, match="row 2"):
        for i, item in _prefetched(failing, 5):
            got.append(item)
    assert got == [0, 1]


def test_step_lr_sets_the_tensor_rate():
    cfg = from_preset("qvhighlights_slowclip", **SMALL, lr_drop=1, lr_gamma=0.5)
    model = build_model(cfg.model_config(), "cpu", 0)
    optimizer, scheduler = make_optimizer(cfg, model.parameters(), steps_per_epoch=2)
    lr = optimizer.param_groups[0]["lr"]
    assert isinstance(lr, torch.Tensor) and all(g["lr"] is lr for g in optimizer.param_groups)
    for n in range(110):  # past the 49th drop (step 98)
        assert lr.item() == cfg.lr * scheduler.factor(n), n
        assert scheduler.factor(n) == 0.5 ** min(n // 2, 49)
        assert scheduler.get_last_lr() == [cfg.lr * scheduler.factor(n)]
        scheduler.step()
    state = scheduler.state_dict()
    assert state["last_epoch"] == 110 and state["_last_lr"] == [cfg.lr * 0.5 ** 49]
    _, fresh = make_optimizer(cfg, model.parameters(), steps_per_epoch=2)
    fresh.load_state_dict({**state, "last_epoch": 7})
    assert fresh.lr.item() == cfg.lr * 0.5 ** 3 and int(fresh.count) == 7


@pytest.fixture(scope="module")
def adapter(tmp_path_factory):
    jcfg = jax_preset("qvhighlights_slowclip", **SMALL)
    lv, lq = jcfg.max_v_l, jcfg.max_q_l
    params = jax.jit(JaxModel(jcfg.model_config()).init, static_argnames="train")(
        {"params": jax.random.PRNGKey(17)},
        jnp.zeros((1, lq, jcfg.t_feat_dim)), jnp.ones((1, lq)),
        jnp.zeros((1, lv, jcfg.total_v_feat_dim)), jnp.ones((1, lv)), train=False,
    )
    path = str(tmp_path_factory.mktemp("scan_adapter") / "init.ckpt")
    jax_save_torch(path, jax.tree.map(np.asarray, params), jcfg.model_config())
    return path


def test_feed_train_matches_jax_feed_train(tmp_path, monkeypatch, split, adapter):
    for cls in (jax_config.ExperimentConfig, port_config.ExperimentConfig):
        orig = cls.model_config
        monkeypatch.setattr(cls, "model_config", lambda self, orig=orig: dataclasses.replace(
            orig(self), dummy_dropout=0.0))
    kw = dict(SMALL, **split, n_epoch=1, dropout=0.0, input_dropout=0.0, device_feed="on",
              scan_steps=0, resume_adapter=adapter, results_root=str(tmp_path))
    jdir = str(tmp_path / "jax")
    jax_train(jax_preset("qvhighlights_slowclip", **kw), results_dir=jdir,
              mesh=make_mesh(jax.devices()[:1], data=1, model=1))
    _, port = _run(tmp_path, split, "port", **{k: v for k, v in kw.items()
                                               if k not in SMALL and k not in split})
    want = _losses(jdir)
    assert len(port) == len(want) == 5
    for js, ps in zip(want, port):
        assert list(ps) == sorted(js)
        for k, v in js.items():
            np.testing.assert_allclose(ps[k], v, rtol=LOSS_RTOL, err_msg=k)


def test_device_constant_is_made_once():
    made = []

    def make():
        made.append(1)
        return np.arange(5, dtype=np.float32)

    first = device_constant(("test_constant", 5), "cpu", make)
    again = device_constant(("test_constant", 5), torch.device("cpu"), make)
    assert again is first and len(made) == 1
    assert torch.equal(first, torch.arange(5, dtype=torch.float32))
