"""The port's train loop vs the JAX package's, and its own cases, on the CPU.

  * JAX train() and port train() from the same starting weights (a JAX init
    exported to a reference `.ckpt` and preloaded on both sides through
    --resume_adapter), 2 epochs of 2 steps, an eval every epoch, every
    dropout at 0 (dummy_dropout included), float32 both sides, the JAX loop
    on one device with the streamed feed: per-step losses within rtol 1e-4
    (f32 sums in other orders, compounded over the updates; measured 2e-6),
    eval losses within rtol 1e-4, the same best epoch and early-stop
    decision, the same set of files (orbax directories where the port
    writes `.ckpt` files), and every eval.log.txt brief metric within 0.02
    points (`__graft_entry__.py:172-197`);
  * the port's own cases: --resume_all continues at epoch + 1 with AdamW and
    StepLR restored (the first resumed step's learning rate is the
    uninterrupted run's); max_es_cnt stops; eval_untrained writes epoch -1;
    the --test_path finals; an unknown dial raises, profile_dir traces;
    --debug runs one epoch of 2 steps; the scalar writer without its
    optional sinks.
"""

import dataclasses
import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch_threads  # noqa: F401  (torch's share of the cores under xdist)

from flashvtg_tpu.models.flashvtg import FlashVTGModel as JaxModel
from flashvtg_tpu.parallel.mesh import make_mesh
from flashvtg_tpu.train import config as jax_config
from flashvtg_tpu.train.config import from_preset as jax_preset
from flashvtg_tpu.train.loop import load_checkpoint as jax_load_checkpoint
from flashvtg_tpu.train.loop import train as jax_train
from flashvtg_tpu.utils.torch_convert import save_torch_checkpoint as jax_save_torch
from flashvtg_tpu_torch.models import build_model
from flashvtg_tpu_torch.train import config as port_config
from flashvtg_tpu_torch.train.config import from_preset
from flashvtg_tpu_torch.train.loop import (
    load_checkpoint,
    make_optimizer,
    stop_metric,
    train,
)
from flashvtg_tpu_torch.utils.synthetic import make_synthetic_qvh

SMALL = dict(
    v_feat_dim=40, t_feat_dim=24, hidden_dim=32, nheads=2, dim_feedforward=48,
    t2v_layers=1, enc_layers=1, dummy_layers=1, num_dummies=3, num_mlp_layers=2,
    max_q_l=8, max_v_l=24, bsz=4, eval_bsz=4, eval_epoch=1, dropout=0.0,
    input_dropout=0.0, use_tensorboard=False, device_feed="off",
    train_precision="float32", exp_id="loop",
)
LOSS_RTOL = 1e-4
METRIC_ATOL = 0.02


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("loop_split"))
    ann, vdir, qdir = make_synthetic_qvh(root, n_queries=8, v_dim=40, t_dim=24, n_clips=24,
                                         seed=1, split="train", min_clips=10)
    val, _, _ = make_synthetic_qvh(root, n_queries=8, v_dim=40, t_dim=24, n_clips=24,
                                   seed=2, split="val", min_clips=10)
    return dict(train_path=ann, eval_path=val, v_feat_dirs=(vdir,), t_feat_dir=qdir)


def _no_dummy_dropout(monkeypatch, cls):
    """Both packages hard-code the dummy encoder's dropout (0.1) in their
    ModelConfig; zero it for a deterministic run."""
    orig = cls.model_config
    monkeypatch.setattr(cls, "model_config",
                        lambda self: dataclasses.replace(orig(self), dummy_dropout=0.0))


def _losses(run_dir):
    with open(os.path.join(run_dir, "tensorboard_log", "scalars.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    train = [{k[6:]: v for k, v in r.items() if k.startswith("train/")}
             for r in rows if any(k.startswith("train/") for k in r)]
    evals = [{k[5:]: v for k, v in r.items() if k.startswith("eval/")}
             for r in rows if any(k.startswith("eval/") for k in r)]
    return train, evals


def _eval_log(run_dir):
    """[(epoch, metrics)] of eval.log.txt."""
    path = os.path.join(run_dir, "eval.log.txt")
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [(int(line.split("[Epoch] ")[1].split()[0]),
                 json.loads(line.split("[Metrics] ", 1)[1])) for line in f]


def _train_epochs(run_dir):
    with open(os.path.join(run_dir, "train.log.txt")) as f:
        return [int(line.split("[Epoch] ")[1].split()[0]) for line in f]


@pytest.fixture(scope="module")
def adapter(tmp_path_factory):
    """A JAX init of the SMALL flagship, exported as a reference .ckpt."""
    jcfg = jax_preset("qvhighlights_slowclip", **SMALL)
    lv, lq = jcfg.max_v_l, jcfg.max_q_l
    params = jax.jit(JaxModel(jcfg.model_config()).init, static_argnames="train")(
        {"params": jax.random.PRNGKey(11)},
        jnp.zeros((1, lq, jcfg.t_feat_dim)), jnp.ones((1, lq)),
        jnp.zeros((1, lv, jcfg.total_v_feat_dim)), jnp.ones((1, lv)), train=False,
    )
    path = str(tmp_path_factory.mktemp("adapter") / "init.ckpt")
    jax_save_torch(path, jax.tree.map(np.asarray, params), jcfg.model_config())
    return path


ES_CASES = {"no_early_stop": -1, "early_stop_after_one": 0}


@pytest.mark.parametrize("case", list(ES_CASES))
def test_train_matches_jax(tmp_path, monkeypatch, split, adapter, case):
    _no_dummy_dropout(monkeypatch, jax_config.ExperimentConfig)
    _no_dummy_dropout(monkeypatch, port_config.ExperimentConfig)
    kw = dict(SMALL, **split, n_epoch=2, max_es_cnt=ES_CASES[case], resume_adapter=adapter,
              results_root=str(tmp_path))
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    _, j_best, _ = jax_train(jax_preset("qvhighlights_slowclip", **kw), results_dir=jdir,
                             mesh=make_mesh(jax.devices()[:1], data=1, model=1))
    model, p_best, _ = train(from_preset("qvhighlights_slowclip", **kw), results_dir=pdir,
                             device="cpu")
    assert not model.training

    (j_train, j_eval), (p_train, p_eval) = _losses(jdir), _losses(pdir)
    assert len(p_train) == len(j_train) >= 2
    for js, ps in zip(j_train, p_train):
        assert list(ps) == sorted(js)
        for k, v in js.items():
            np.testing.assert_allclose(ps[k], v, rtol=LOSS_RTOL, err_msg=k)
    assert len(p_eval) == len(j_eval) > 0
    for js, ps in zip(j_eval, p_eval):
        assert set(ps) == set(js)
        for k, v in js.items():
            np.testing.assert_allclose(ps[k], v, rtol=LOSS_RTOL, err_msg=f"eval {k}")

    j_log, p_log = _eval_log(jdir), _eval_log(pdir)
    assert [e for e, _ in p_log] == [e for e, _ in j_log]
    for (_, jm), (_, pm) in zip(j_log, p_log):
        assert set(pm["brief"]) == set(jm["brief"])
        for k, v in jm["brief"].items():
            assert abs(pm["brief"][k] - v) <= METRIC_ATOL, (k, pm["brief"][k], v)
    np.testing.assert_allclose(p_best, j_best, atol=METRIC_ATOL)
    assert _train_epochs(pdir) == _train_epochs(jdir)  # the same early-stop decision
    if p_best > 0:  # the same best epoch
        assert load_checkpoint(os.path.join(pdir, "model_best.ckpt"))["epoch"] == int(
            np.asarray(jax_load_checkpoint(os.path.join(jdir, "model_best"))["epoch"]))
    assert load_checkpoint(os.path.join(pdir, "model_latest.ckpt"))["epoch"] == int(
        np.asarray(jax_load_checkpoint(os.path.join(jdir, "model_latest"))["epoch"]))

    renamed = {"model_best": "model_best.ckpt", "model_latest": "model_latest.ckpt"}
    assert sorted(os.listdir(pdir)) == sorted(renamed.get(f, f) for f in os.listdir(jdir))


def _port_run(tmp_path, split, name, **kw):
    cfg = from_preset("qvhighlights_slowclip", **{**SMALL, **split, "lr_drop": 1,
                                                  "results_root": str(tmp_path), **kw})
    return train(cfg, results_dir=str(tmp_path / name), device="cpu")


def test_resume_all_continues_with_optimizer_and_scheduler(tmp_path, split):
    """A 2-epoch run, then --resume_all of its model_latest to 3 epochs: the
    resumed run trains epoch 3 alone; AdamW's state and the StepLR step
    come back as saved, so the first resumed step's learning rate is the
    uninterrupted run's, and the steps count on from the saved ones."""
    _, _, first = _port_run(tmp_path, split, "first", n_epoch=2)
    latest = load_checkpoint(os.path.join(first, "model_latest.ckpt"))
    assert latest["epoch"] == 1

    cfg = from_preset("qvhighlights_slowclip", **{**SMALL, **split, "lr_drop": 1})
    model = build_model(cfg.model_config(), "cpu", cfg.seed)
    optimizer, scheduler = make_optimizer(cfg, model.parameters(), steps_per_epoch=2)
    optimizer.load_state_dict(latest["optimizer"])
    scheduler.load_state_dict(latest["lr_scheduler"])
    # an uninterrupted schedule after 4 steps: lr_drop 1 epoch of 2 steps
    want_lr = cfg.lr * cfg.lr_gamma ** 2
    assert optimizer.param_groups[0]["lr"] == pytest.approx(want_lr, rel=1e-12)
    state = optimizer.state_dict()["state"]
    assert all(int(s["step"]) == 4 for s in state.values())

    _, _, resumed = _port_run(tmp_path, split, "resumed", n_epoch=3,
                              resume=os.path.join(first, "model_latest.ckpt"),
                              resume_all=True)
    assert _train_epochs(resumed) == [3]
    assert [e for e, _ in _eval_log(resumed)] == [2]
    after = load_checkpoint(os.path.join(resumed, "model_latest.ckpt"))
    assert after["epoch"] == 2
    assert after["lr_scheduler"]["last_epoch"] == 6
    assert all(int(s["step"]) == 6 for s in after["optimizer"]["state"].values())
    assert after["lr_scheduler"]["_last_lr"] == pytest.approx([cfg.lr * cfg.lr_gamma ** 3])

    # without --resume_all: the weights only, from epoch 0, a fresh AdamW
    _, _, weights_only = _port_run(tmp_path, split, "weights_only", n_epoch=1,
                                   resume=os.path.join(first, "model_latest.ckpt"))
    fresh = load_checkpoint(os.path.join(weights_only, "model_latest.ckpt"))
    assert fresh["epoch"] == 0
    assert all(int(s["step"]) == 2 for s in fresh["optimizer"]["state"].values())


ES_STOPS = {"es_0": (0, [1, 2]), "es_1": (1, [1, 2, 3]), "es_off": (-1, [1, 2, 3, 4])}


@pytest.mark.parametrize("case", list(ES_STOPS))
def test_max_es_cnt_stops(tmp_path, split, case):
    """lr 0: the model never changes, so no eval after the first improves,
    and the run stops after max_es_cnt + 1 evals without a gain."""
    es, epochs = ES_STOPS[case]
    _, best, run = _port_run(tmp_path, split, "run", n_epoch=4, lr=0.0, max_es_cnt=es)
    assert best > 0
    assert _train_epochs(run) == epochs
    assert load_checkpoint(os.path.join(run, "model_best.ckpt"))["epoch"] == 0
    # the epoch that stops the run writes no model_latest
    want_latest = epochs[-1] - 1 if es == -1 else epochs[-1] - 2
    assert load_checkpoint(os.path.join(run, "model_latest.ckpt"))["epoch"] == want_latest


def test_eval_untrained_writes_epoch_minus_one(tmp_path, split):
    cfg_kw = dict(n_epoch=1, eval_untrained=True)
    _, best, run = _port_run(tmp_path, split, "run", **cfg_kw)
    log = _eval_log(run)
    assert [e for e, _ in log] == [-1, 0]
    with open(os.path.join(run, "eval.log.txt")) as f:
        assert "[Epoch] -01 [Loss]" in f.readline()
    cfg = from_preset("qvhighlights_slowclip", **SMALL)
    assert best == max(stop_metric(cfg, m["brief"]) for _, m in log)


def test_test_path_finals(tmp_path, split):
    """--test_path: the latest and the best model on the val and the test
    split; a test split without windows gets predictions, no metrics."""
    rows = [json.loads(line) for line in open(split["eval_path"])]
    test_path = str(tmp_path / "test.jsonl")
    with open(test_path, "w") as f:
        for r in rows[:4]:
            r = {k: v for k, v in r.items() if k not in ("relevant_windows",
                                                           "relevant_clip_ids",
                                                           "saliency_scores")}
            f.write(json.dumps(r) + "\n")
    _, best, run = _port_run(tmp_path, split, "run", n_epoch=1, test_path=test_path)
    files = set(os.listdir(run))
    for which in ("latest", "best") if best > 0 else ("latest",):
        assert f"val_{which}_hl_val_preds_metrics.json" in files
        assert f"test_{which}_hl_test_preds.jsonl" in files
        assert f"test_{which}_hl_test_preds_nms_thd_0.7.jsonl" in files
        assert f"test_{which}_hl_test_preds_metrics.json" not in files
    with open(os.path.join(run, "test_latest_hl_test_preds.jsonl")) as f:
        assert len(f.read().splitlines()) == 4


def test_other_train_precision_raises(tmp_path, split):
    """Every dial is ported: an unknown train_precision or transfer_dtype
    raises, bfloat16 (the JAX default) trains, with the bf16 wire too; the
    device feed trains as streamed does; profile_dir writes its trace."""
    with pytest.raises(ValueError, match="unknown train_precision"):
        _port_run(tmp_path, split, "run", n_epoch=1, train_precision="float16")
    with pytest.raises(ValueError, match="unknown transfer_dtype"):
        _port_run(tmp_path, split, "run", n_epoch=1, transfer_dtype="float16")
    _, _, run = _port_run(tmp_path, split, "bf16", n_epoch=1, train_precision="bfloat16",
                          transfer_dtype="bfloat16")
    assert _train_epochs(run) == [1]
    # the device feed is ported: "on" trains, and its losses are the
    # streamed run's
    _, _, fed = _port_run(tmp_path, split, "fed", n_epoch=1, device_feed="on")
    _, _, streamed = _port_run(tmp_path, split, "streamed", n_epoch=1, device_feed="off")
    assert _train_epochs(fed) == [1]
    assert _losses(fed) == _losses(streamed)
    # profile_dir is ported: the run writes its first epoch's trace there
    _port_run(tmp_path, split, "prof", n_epoch=1, profile_dir=str(tmp_path / "prof_trace"))
    assert glob.glob(str(tmp_path / "prof_trace" / "*.pt.trace.json"))


def test_debug_runs_one_short_epoch(tmp_path, split):
    """--debug: one epoch of at most 2 steps (reference config.py:32-33)."""
    _, _, run = _port_run(tmp_path, split, "run", n_epoch=3, bsz=2, debug=True)
    assert _train_epochs(run) == [1]
    assert len(_losses(run)[0]) == 2


def test_scalar_writer_without_optional_sinks(tmp_path, monkeypatch, caplog):
    """scalars.jsonl always; --use_wandb with no wandb package costs one
    warning, not the run."""
    import sys

    from flashvtg_tpu_torch.utils.observability import ScalarWriter

    monkeypatch.setitem(sys.modules, "wandb", None)  # `import wandb` fails
    writer = ScalarWriter(str(tmp_path / "log"), use_tensorboard=False,
                          wandb_run=dict(project="p", name="n"))
    writer.write(0, {"a": 1.5}, prefix="train/")
    writer.write(1, {"b": np.float32(2.0)})
    writer.write_text("hyperparameters", "{}")
    writer.close()
    with open(tmp_path / "log" / "scalars.jsonl") as f:
        rows = [json.loads(line) for line in f]
    assert [(r["step"], r.get("train/a"), r.get("b")) for r in rows] == [(0, 1.5, None),
                                                                          (1, None, 2.0)]
    assert "--use_wandb set but wandb is unavailable" in caplog.text
