"""A cell as files: BENCHMARK.json's entry, its configuration file, its
traffic file, its limits and its per-layer metric readers, found by name.

A configuration file holds the model's sizes and the training and loss
settings as they are run: every key that is a field of the program's
ExperimentConfig goes to it, and the reference reads the same file. A
traffic file names the driver that runs it (`mode`: train or eval) and its
parameters. A per-layer metric is `metrics/<name>.py` with
`read(trace) -> float or None`. Limits of the output check are
`limits/<workload>.json`.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))
PACKAGE = os.path.dirname(HERE)


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


class Cell:
    """One workload of BENCHMARK.json (`root` the checkout's root)."""

    def __init__(self, root: str, name: str):
        self.root = root
        self.package = os.path.join(root, "vtgbench")
        self.bench = load_json(os.path.join(root, "BENCHMARK.json"))
        found = [w for w in self.bench["workloads"] if w["name"] == name]
        if not found:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.workload = found[0]
        self.name = name
        (config,) = [c for c in self.bench["configs"] if c["name"] == self.workload["config"]]
        self.config = load_json(os.path.join(root, config["file"]))
        self.traffic = load_json(os.path.join(self.package, "traffic",
                                              self.workload["traffic"] + ".json"))
        self.chips = int(self.workload["chips"])

    def reports(self, metric: dict) -> bool:
        """Whether this cell reports `metric` (an end_to_end or per_layer
        entry): the cells its `workloads` lists; without the key, every
        cell that reports its `moves` (per-layer) or every cell."""
        if "workloads" in metric:
            return self.name in metric["workloads"]
        if "moves" in metric:
            moved = [m for m in self.bench["end_to_end"] if m["name"] == metric["moves"]]
            return bool(moved) and self.reports(moved[0])
        return True

    def end_to_end(self) -> List[dict]:
        return [m for m in self.bench["end_to_end"] if self.reports(m)]

    def per_layer(self) -> List[dict]:
        return [m for m in self.bench["per_layer"] if self.reports(m)]

    def limits(self) -> Dict[str, float]:
        path = os.path.join(self.package, "limits", self.name + ".json")
        return load_json(path)["limits"] if os.path.exists(path) else {}

    def reader(self, name: str):
        """The `read` function of metrics/<name>.py."""
        path = os.path.join(self.package, "metrics", name + ".py")
        spec = importlib.util.spec_from_file_location(
            "vtgbench_metric_" + name.replace(".", "_"), path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read


def experiment_config(config: dict, traffic: dict, **extra):
    """The program's ExperimentConfig of a configuration and a traffic mix:
    the preset, then every key of either file that is one of its fields,
    then `extra` (paths, seed)."""
    from flashvtg_tpu_torch.train.config import ExperimentConfig, from_preset

    fields = {f.name for f in dataclasses.fields(ExperimentConfig)}
    kw = {k: v for src in (config, traffic) for k, v in src.items() if k in fields}
    for k in ("strides", "nce_direction", "v_feat_dirs"):
        if k in kw:
            kw[k] = tuple(kw[k])
    kw.update(extra)
    return from_preset(config["preset"], **kw)
