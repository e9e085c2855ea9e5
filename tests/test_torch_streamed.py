"""The streamed train epoch (train/loop.py:run_streamed_epoch), its staged
batch (data/feed.py:stage_batch / copy_ahead) and the epoch's mode
(train/loop.py:epoch_mode), on the CPU.

  * the staged placement, widened as the step widens it, equals
    place_batch key by key, in dtype and values, at each transfer_dtype;
    the staged tensors cross in their wire dtypes (bf16 features on the
    bf16 wire); the packed buffer the card's staging fills, converting each
    tensor in its one copy, gives the same tensors back bit for bit;
  * epoch_mode's choice in each case: fixed or bucketed max_v_l, debug,
    debug_nans, scan_steps <= 1, txt_drop_ratio, device_feed off, a split
    over the budget, a CPU or CUDA device (object or name), with nothing
    launched;
  * train()'s streamed loss vectors and final weights bit-equal to the
    per-step loop's it replaces (the batch placed by place_batch after the
    prefetch thread's collation, the eager step), at each transfer_dtype,
    every dropout at its preset value;
  * a graph step refuses an input of another shape.
"""

import json
import os

import numpy as np
import pytest
import torch

from flashvtg_tpu_torch.data.collate import TRAIN_KEYS, Collator
from flashvtg_tpu_torch.data.dataset import VTGDataset
from flashvtg_tpu_torch.data.feed import (
    NARROWED_KEYS,
    _pack,
    _unpack,
    copy_ahead,
    stage_batch,
    widen_features,
    wire_dtypes,
)
from flashvtg_tpu_torch.train import loop
from flashvtg_tpu_torch.train.config import from_preset
from flashvtg_tpu_torch.train.graph import GraphSteps
from flashvtg_tpu_torch.train.loop import EpochMode, epoch_mode, place_batch, train
from flashvtg_tpu_torch.utils.synthetic import make_synthetic_qvh

SMALL = dict(
    v_feat_dim=40, t_feat_dim=24, hidden_dim=32, nheads=2, dim_feedforward=48,
    t2v_layers=1, enc_layers=1, dummy_layers=1, num_dummies=3, num_mlp_layers=2,
    max_q_l=8, max_v_l=24, bsz=4, use_tensorboard=False, train_precision="float32",
    device_feed="off", exp_id="streamed",
)


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("streamed_split"))
    ann, vdir, qdir = make_synthetic_qvh(root, n_queries=12, v_dim=40, t_dim=24, n_clips=24,
                                         seed=3, split="train", min_clips=10)
    return dict(train_path=ann, eval_path="", v_feat_dirs=(vdir,), t_feat_dir=qdir)


def _batch(split):
    cfg = from_preset("qvhighlights_slowclip", **SMALL, **split)
    ds = VTGDataset(loop.train_data_config(cfg, cfg.train_path))
    collate = Collator(cfg.max_q_l, cfg.v_buckets, cfg.max_v_l, dset_name=cfg.dset_name)
    return collate([ds[i] for i in range(4)])


@pytest.mark.parametrize("wire", ["float32", "bfloat16"])
def test_staged_placement_equals_place_batch(split, wire):
    batch = _batch(split)
    want = place_batch(batch, "cpu", transfer_dtype=wire)
    staged = stage_batch(batch, TRAIN_KEYS, "cpu", transfer_dtype=wire)
    placed = copy_ahead(staged, "cpu")
    assert placed.ready is None
    wire_tensors = placed.wait()
    for key, t in wire_tensors.items():
        narrowed = wire == "bfloat16" and key in NARROWED_KEYS
        assert t.dtype == (torch.bfloat16 if narrowed else want[key].dtype), key
    got = widen_features(wire_tensors)
    assert list(got) == list(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        assert torch.equal(got[key], want[key]), key


@pytest.mark.parametrize("wire", ["float32", "bfloat16"])
def test_packed_layout_round_trip(split, wire):
    """The card's staging: each tensor converted to its wire dtype in its
    one copy into the (here unpinned) buffer, read back as the CPU's
    staged tensors."""
    batch = _batch(split)
    want = stage_batch(batch, TRAIN_KEYS, "cpu", transfer_dtype=wire).tensors
    host, layout = _pack(*wire_dtypes(batch, TRAIN_KEYS, transfer_dtype=wire), pin=False)
    assert all(o % 16 == 0 for *_, o in layout)
    back = _unpack(host, layout)
    assert list(back) == list(want)
    for key, t in want.items():
        assert back[key].dtype == t.dtype and torch.equal(back[key], t), key


# (fields, device, rows) -> (feed, graph, chunk)
MODE_CASES = {
    "fixed_cuda": (dict(), torch.device("cuda"), 64, (True, True, 128)),
    "fixed_cuda_name": (dict(), "cuda", 64, (True, True, 128)),
    "fixed_cpu": (dict(), torch.device("cpu"), 64, (True, False, 128)),
    "feed_off_cuda": (dict(device_feed="off"), torch.device("cuda"), 64, (False, True, 1)),
    "feed_off_cpu": (dict(device_feed="off"), "cpu", 64, (False, False, 1)),
    "over_budget": (dict(device_feed_budget_gb=0.001), torch.device("cuda"), 64,
                    (False, True, 1)),
    "bucketed": (dict(max_v_l=-1), torch.device("cuda"), 64, (False, False, 1)),
    "debug": (dict(debug=True), torch.device("cuda"), 64, (True, False, 1)),
    "debug_nans": (dict(debug_nans=True), torch.device("cuda"), 64, (True, False, 1)),
    "debug_nans_streamed": (dict(debug_nans=True, device_feed="off"), "cuda", 64,
                            (False, False, 1)),
    "scan_1": (dict(scan_steps=1), torch.device("cuda"), 64, (True, False, 1)),
    "scan_0_streamed": (dict(scan_steps=0, device_feed="off"), "cuda", 64, (False, False, 1)),
    "txt_drop": (dict(txt_drop_ratio=0.1), torch.device("cuda"), 64, (False, True, 1)),
    "feed_on_over_budget": (dict(device_feed="on", device_feed_budget_gb=0.001), "cuda", 64,
                            (True, True, 128)),
}


@pytest.mark.parametrize("case", list(MODE_CASES))
def test_epoch_mode(case):
    fields, device, rows, (feed, graph, chunk) = MODE_CASES[case]
    cfg = from_preset("qvhighlights_slowclip", **fields)
    assert epoch_mode(cfg, device, rows) == EpochMode(feed=feed, graph=graph, chunk=chunk)
    # a TACoS-size split streams under the default budget, as a graph on the card
    if not fields:
        tacos = from_preset("tacos")
        assert epoch_mode(tacos, device, 9790) == EpochMode(
            feed=False, graph=torch.device(device).type == "cuda", chunk=1)
    assert not torch.cuda.is_initialized()


def _old_streamed_epoch(streamed_steps, host_batch, n_steps, loss_buf, device,
                        transfer_dtype="float32"):
    """The per-step streamed loop that run_streamed_epoch replaced."""
    done = 0
    for _, made in loop._prefetched(host_batch, max(n_steps, 0)):
        if made is None:
            continue
        vec = streamed_steps.step.vector(place_batch(made[1], device,
                                                     transfer_dtype=transfer_dtype))
        loss_buf[done].copy_(vec)
        done += 1
    return done


def _run(tmp_path, split, name, **kw):
    cfg = from_preset("qvhighlights_slowclip", **{**SMALL, **split,
                                                  "results_root": str(tmp_path), **kw})
    model, _, run = train(cfg, results_dir=str(tmp_path / name), device="cpu")
    with open(os.path.join(run, "tensorboard_log", "scalars.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    losses = [{k: v for k, v in r.items() if k.startswith("train/")} for r in rows
              if any(k.startswith("train/") for k in r)]
    return {k: v.clone() for k, v in model.state_dict().items()}, losses


@pytest.mark.parametrize("wire", ["float32", "bfloat16"])
def test_streamed_train_equals_the_per_step_loop(tmp_path, split, monkeypatch, wire):
    new_params, new_losses = _run(tmp_path, split, "new", n_epoch=2, transfer_dtype=wire)
    assert len(new_losses) == 6 and all(np.isfinite(list(r.values())).all()
                                        for r in new_losses)
    monkeypatch.setattr(loop, "run_streamed_epoch", _old_streamed_epoch)
    old_params, old_losses = _run(tmp_path, split, "old", n_epoch=2, transfer_dtype=wire)
    assert new_losses == old_losses
    assert all(torch.equal(new_params[k], old_params[k]) for k in old_params)


def test_graph_steps_refuse_another_shape():
    steps = GraphSteps(lambda inputs: inputs["x"].sum(), None, None, graph=True)
    steps.static = {"x": torch.zeros(2, 3)}
    with pytest.raises(ValueError, match="fixed max_v_l"):
        steps({"x": torch.zeros(2, 4)})
    with pytest.raises(ValueError, match="fixed max_v_l"):
        steps({"x": torch.zeros(2, 3, dtype=torch.float64)})
