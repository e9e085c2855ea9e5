"""The benchmark as data: every cell resolves to its files, names and units
keep to their characters, every per-layer metric's end-to-end metric is
reported where it is, a cell added as files is found without an edit, and
neither the run path nor the reference loads JAX or the JAX package."""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from vtgbench.harness.cell import PACKAGE, Cell

ROOT = os.path.dirname(PACKAGE)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_every_cell_resolves_to_its_files():
    b = bench()
    assert b["paths"] == ["vtgbench"]
    for w in b["workloads"]:
        cell = Cell(ROOT, w["name"])
        assert cell.config["name"] == w["config"] and cell.traffic["name"] == w["traffic"]
        assert cell.traffic["mode"] in ("train", "eval")
        assert os.path.exists(os.path.join(PACKAGE, "limits", w["name"] + ".json"))
        for m in cell.per_layer():
            assert callable(cell.reader(m["name"]))
        assert any(m["name"] == "setup_s" for m in cell.end_to_end())
        assert len(cell.end_to_end()) >= 2 and cell.per_layer()
    for c in b["configs"]:
        assert c["file"].startswith("vtgbench/configs/")
        with open(os.path.join(ROOT, c["file"])) as f:
            assert json.load(f)["source"] == c["source"]


def test_names_and_units_keep_to_their_characters():
    b = bench()
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in b[k]]
    names += [w[k] for w in b["workloads"] for k in ("config", "traffic")]
    names += [r for c in b["configs"] for r in c["reduced"]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({x["name"] for x in b[k]}) == len(b[k])
    assert all(UNIT.match(m["unit"]) for k in ("end_to_end", "per_layer") for m in b[k])
    assert len(json.dumps(b)) < 64 * 1024


def test_each_per_layer_metric_moves_a_metric_its_cells_report():
    b = bench()
    e2e = {m["name"]: m for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        for w in m["workloads"]:
            cell = Cell(ROOT, w)
            assert any(x["name"] == m["moves"] for x in cell.end_to_end())
    layers = {m["layer"] for m in b["per_layer"]}
    assert all("\n" not in layer and 0 < len(layer) <= 200 for layer in layers)


def test_a_cell_added_as_files_is_found(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(PACKAGE, root / "vtgbench", ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root / "BENCHMARK.json")
    before = {p: p.read_bytes() for p in (root / "vtgbench").rglob("*") if p.is_file()}
    traffic = json.loads((root / "vtgbench/traffic/eval-feed-f32.json").read_text())
    traffic.update(name="eval-feed-f32-b16", eval_bsz=16)
    (root / "vtgbench/traffic/eval-feed-f32-b16.json").write_text(json.dumps(traffic))
    (root / "vtgbench/metrics/batches.eval.py").write_text(
        "def read(trace):\n    return float(trace.steps) or None\n")
    shutil.copy(root / "vtgbench/limits/tacos-eval-f32.json",
                root / "vtgbench/limits/tacos-eval-b16.json")
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["workloads"].append({"name": "tacos-eval-b16", "config": "tacos",
                           "traffic": "eval-feed-f32-b16", "chips": 1, "why": "B 16"})
    b["end_to_end"][1]["workloads"].append("tacos-eval-b16")
    b["per_layer"].append({"name": "batches.eval", "unit": "batches", "better": "higher",
                           "source": "program_counter", "layer": "eval pipeline",
                           "moves": "eval_qps", "workloads": ["tacos-eval-b16"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    cell = Cell(str(root), "tacos-eval-b16")
    assert cell.traffic["eval_bsz"] == 16 and cell.limits()
    assert [m["name"] for m in cell.per_layer()] == ["batches.eval"]
    assert cell.reader("batches.eval")(type("T", (), {"steps": 3})()) == 3.0
    assert {m["name"] for m in cell.end_to_end()} == {"eval_qps", "setup_s"}
    after = {p: p.read_bytes() for p in before}
    assert after == before  # nothing that was there was edited


RUN_PATH = """
import sys, json
sys.path.insert(0, {root!r})
import vtgbench.run, vtgbench.controls, vtgbench.drivers.train, vtgbench.drivers.eval
import vtgbench.harness.check_train, vtgbench.harness.check_eval, vtgbench.harness.readers
from vtgbench.tests.tiny_cells import tiny_cell
import torch
for w in ("tacos-train-bf16", "tacos-eval-f32"):
    vtgbench.run.run(tiny_cell(w), 5, 0.2, False, torch.device("cpu"))
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REFERENCE = """
import sys, json
sys.path.insert(0, {root!r})
import vtgbench.reference.model, vtgbench.reference.attention, vtgbench.reference.criterion
import vtgbench.reference.host, vtgbench.reference.metrics, vtgbench.reference.optim
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level(code: str):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code.format(root=ROOT)], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


@pytest.mark.parametrize("code", [RUN_PATH, REFERENCE], ids=["run_path", "reference"])
def test_no_jax_and_no_jax_package_loaded(code):
    loaded = _top_level(code)
    assert not loaded & {"jax", "jaxlib", "flax", "flashvtg_tpu"}
    if code is REFERENCE:
        assert "flashvtg_tpu_torch" not in loaded
    else:
        assert "flashvtg_tpu_torch" in loaded
