"""The plain reference against today's port at CPU size, and the inputs
the harness makes.

At the float32 dial on the CPU the port runs its plain versions, so the
reference follows its train steps (same weights, inputs and dropout draws)
to rounding, and matches its eval rows to the 4-decimal rounding of the
scores."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from vtgbench.harness import check_eval, check_train, data
from vtgbench.harness.trace import Trace
from vtgbench.tests.tiny_cells import tiny_cell


def _train(workload, precision, seed):
    from vtgbench.drivers.train import TrainDriver

    cell = tiny_cell(workload, train_precision=precision)
    driver = TrainDriver(cell, seed, "cpu", Trace(False))
    driver.setup()
    driver.window(0.5)
    driver.release()
    return driver


@pytest.mark.parametrize("workload", ["tacos-train-bf16", "qvh-train-bf16"])
def test_reference_follows_the_train_steps_at_float32(workload):
    driver = _train(workload, "float32", 2**31 + 11)
    losses, grads, after = check_train.run_reference(driver)
    gaps = check_train.gaps(check_train.program_side(driver), losses, grads, after,
                            driver.weights)
    assert gaps["loss_gap"] < 1e-5
    assert gaps["grad_gap"] < 1e-4 and gaps["grad_dist"] < 1e-4
    assert gaps["change_gap"] < 1e-3


def test_reference_follows_the_bfloat16_step_loosely():
    driver = _train("tacos-train-bf16", "bfloat16", 5)
    losses, grads, after = check_train.run_reference(driver)
    gaps = check_train.gaps(check_train.program_side(driver), losses, grads, after,
                            driver.weights)
    assert 0 < gaps["loss_gap"] < 3e-2


def test_reference_matches_the_eval_rows():
    from vtgbench.drivers.eval import EvalDriver

    driver = EvalDriver(tiny_cell("tacos-eval-f32"), 77, "cpu", Trace(False))
    driver.setup()
    driver.window(0.1)
    driver.release()
    values = check_eval.passes_gaps(driver, check_eval.reference_candidates(driver))
    assert values["score_gap"] <= 5.01e-5
    assert values["nms_mismatch"] == 0
    assert values["metric_gap"] == 0


def test_split_is_one_pool_in_a_seeded_order():
    cell = tiny_cell("tacos-eval-f32")
    a, vdir, tdir = data.split(cell.traffic, cell.config, 1)
    b, vdir2, _ = data.split(cell.traffic, cell.config, 2**33)
    rows_a, rows_b = open(a).read().splitlines(), open(b).read().splitlines()
    assert vdir == vdir2 and rows_a != rows_b and sorted(rows_a) == sorted(rows_b)
    assert open(data.split(cell.traffic, cell.config, 1)[0]).read().splitlines() == rows_a


def test_device_feed_layout():
    cell = tiny_cell("qvh-train-bf16")
    feed = data.device_feed(cell.traffic, cell.config, 3, "cpu")
    n, lv, dv = cell.traffic["rows"], cell.config["max_v_l"], cell.config["v_feat_dim"]
    assert feed["src_vid"].shape == (n, lv, dv + 2)
    norms = torch.linalg.vector_norm(feed["src_vid"][..., :dv], dim=-1)
    assert torch.allclose(norms, torch.ones_like(norms), atol=1e-4)
    assert torch.equal(feed["src_vid"][0, :, dv], torch.arange(lv) / lv)
    lens = feed["src_txt_mask"].sum(1)
    lo, hi = cell.traffic["tokens"]
    assert int(lens.min()) >= lo and int(lens.max()) <= hi
    assert torch.equal(data.device_feed(cell.traffic, cell.config, 3, "cpu")["src_txt"],
                       feed["src_txt"])
    labels = data.row_labels(cell.traffic, cell.config, 3)
    assert labels["saliency_pos_labels"].max() < lv and labels["saliency_neg_labels"].min() >= 0
    inside = labels["saliency_all_labels"][np.arange(n)[:, None], labels["saliency_pos_labels"]]
    assert (inside >= 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["tacos-train-bf16", "qvh-train-bf16"])
@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_reference_follows_the_train_steps_on_the_card(workload, precision):
    """On the card the kernels, the CUDA graph and torch's CUDA dropout run:
    at float32 (3xTF32 kernels, TF32 off) the reference follows the first
    step to f32 rounding, so its replayed draws are the program's (the
    later steps part by AdamW's sign of gradients within rounding of 0); at
    bfloat16 it follows them loosely."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from vtgbench.drivers.train import TrainDriver

    cell = tiny_cell(workload, widths=True, train_precision=precision)
    driver = TrainDriver(cell, 2**31 + 3, "cuda", Trace(False))
    driver.setup()
    driver.release()
    losses, grads, after = check_train.run_reference(driver)
    program = check_train.program_side(driver)
    gaps = check_train.gaps(program, losses, grads, after, driver.weights)
    first = gaps["loss_gap"]
    print(workload, precision, first, gaps)
    if precision == "float32":
        assert first < 1e-5 and gaps["grad_dist"] < 5e-3, gaps
    else:
        assert first < 2e-2 and gaps["grad_dist"] < 0.15, gaps
