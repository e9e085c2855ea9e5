"""The output check fails what it must: the control (the reference one
precision below the configuration's, in the program's place) and a run
driven with its timed path broken underneath, at CPU size, against each
cell's own limits.

The faults: a train step that leaves the parameters unchanged; a train
step whose loss leaves half of the batch out (the mean over the rest); an
eval answer altered where it is produced (one score of the decode)."""

from __future__ import annotations

import contextlib

import pytest
import torch

from vtgbench.harness import check_eval, check_train
from vtgbench.harness.trace import Trace
from vtgbench.run import run
from vtgbench.tests.tiny_cells import tiny_cell


def _exceeds(values, limits):
    return [k for k, limit in limits.items() if values[k] > limit]


@pytest.mark.parametrize("workload", ["tacos-train-bf16"])
def test_train_control_fails(workload):
    """The fp8 control (e4m3 operands, e5m2 gradients) in the program's
    place, at the configuration's widths and depths."""
    from vtgbench.drivers.train import TrainDriver

    cell = tiny_cell(workload, widths=True)
    driver = TrainDriver(cell, 31, "cpu", Trace(False))
    driver.setup()
    driver.release()
    exact = check_train.run_reference(driver)
    losses, grads, after = check_train.run_reference(driver, form="fp8")
    values = check_train.gaps({"losses": losses, "grads": grads, "after": after}, *exact,
                              driver.weights)
    assert _exceeds(values, cell.limits())


def test_eval_control_fails():
    """The tensorfloat32 control, emulated: the reference with its products'
    operands rounded to TF32 against the exact reference, at the
    configuration's widths (the rounding's error grows with them), read as
    the score gap reads a submission's scores."""
    from vtgbench.drivers.eval import EvalDriver

    cell = tiny_cell("tacos-eval-f32", widths=True, rows=8)
    driver = EvalDriver(cell, 8, "cpu", Trace(False))
    driver.setup()
    driver.release()
    exact = check_eval.reference_candidates(driver)
    tf32 = check_eval.reference_candidates(driver, form="tf32")
    gap = max(float(abs(tf32[q][1] - exact[q][1]).max()) for q in exact)
    assert gap > cell.limits()["score_gap"]


@contextlib.contextmanager
def frozen_parameters(monkeypatch):
    """AdamW's step runs (its state moves), then every parameter is put
    back: the step returns its state unchanged."""
    real = torch.optim.AdamW.step

    def step(self, *a, **kw):
        saved = [p.detach().clone() for g in self.param_groups for p in g["params"]]
        out = real(self, *a, **kw)
        with torch.no_grad():
            for p, s in zip((p for g in self.param_groups for p in g["params"]), saved):
                p.copy_(s)
        return out

    monkeypatch.setattr(torch.optim.AdamW, "step", step)
    yield


@contextlib.contextmanager
def half_batch(monkeypatch):
    from flashvtg_tpu_torch.train import loop

    real = loop.criterion

    def criterion(loss_cfg, outputs, targets):
        h = targets["saliency_all_labels"].shape[0] // 2

        def cut(v):
            if isinstance(v, (list, tuple)):
                return type(v)(cut(x) for x in v)
            return v[:h] if torch.is_tensor(v) and v.dim() and v.shape[0] == 2 * h else v

        outs = {k: v if k == "point" else cut(v) for k, v in outputs.items()}
        return real(loss_cfg, outs, {k: cut(v) for k, v in targets.items()})

    monkeypatch.setattr(loop, "criterion", criterion)
    yield


@contextlib.contextmanager
def altered_answer(monkeypatch):
    from flashvtg_tpu_torch.models import flashvtg

    real = flashvtg.FlashVTGModel.decode

    def decode(self, out, point_valid=None, top_k=50):
        spans, scores = real(self, out, point_valid, top_k)
        return spans, scores + (torch.arange(scores.numel()).view_as(scores) == 0) * 0.01

    monkeypatch.setattr(flashvtg.FlashVTGModel, "decode", decode)
    yield


FAULTS = [("tacos-train-bf16", "frozen"), ("tacos-train-bf16", "half_batch"),
          ("tacos-eval-f32", "altered_answer")]


@pytest.mark.parametrize("workload,fault", FAULTS)
def test_a_broken_timed_path_is_not_correct(workload, fault, monkeypatch):
    cell = tiny_cell(workload, train_precision="float32") if "train" in workload else \
        tiny_cell(workload)
    sound = run(cell, 21, 0.2, False, torch.device("cpu"))
    assert sound["correct"], sound["checks"]
    broken = {"frozen": frozen_parameters, "half_batch": half_batch,
              "altered_answer": altered_answer}[fault]
    with broken(monkeypatch):
        result = run(cell, 21, 0.2, False, torch.device("cpu"))
    assert not result["correct"], result["checks"]
