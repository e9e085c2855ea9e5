"""The readings the output check's limits are set from, on the chip.

    python3 -m vtgbench.controls --workload <name> --seeds <n> [<n> ...]

For each seed, in one process: the cell's set-up as a run makes it (for a
training cell the one train object through its first three steps; for an
eval cell its first pass), then each compared number read
  sound    the program against the reference;
  control  for a training cell (bfloat16) the reference computed in fp8 put
           in the program's place: every product's operands in e4m3 and the
           gradients entering it in e5m2, each tensor scaled to its type's
           range (reference/forms.py); for an eval cell (float32) the program at its
           own tensorfloat32 dial (TF32 products, 1xTF32 kernels);
  half_batch  (training) the reference with half of each batch left out of
           the loss, the mean taken over the rest, in the program's place;
  witness_bf16  (training) the reference with bf16 products in the
           program's place: a second witness of what bf16 rounding alone
           reads, beside the program;
a step that leaves the state unchanged reads 1 by change_gap's measure and
needs no run. One JSON line a seed on standard output; no window is timed.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import torch

from vtgbench.run import cache_dirs


def train_readings(driver) -> dict:
    from vtgbench.harness import check_train as ct

    program = ct.program_side(driver)
    exact = ct.run_reference(driver)
    diagnostics = {}
    out = {"sound": ct.gaps(program, *exact, driver.weights, diagnostics),
           "sound_diagnostics": diagnostics}
    for name, kw in (("control", dict(form="fp8")), ("half_batch", dict(fault="half_batch")),
                     ("witness_bf16", dict(form="bf16"))):
        losses, grads, after = ct.run_reference(driver, **kw)
        planted = {"losses": losses, "grads": grads, "after": after}
        out[name] = ct.gaps(planted, *exact, driver.weights)
    out["losses"] = {"program": program["losses"], "reference": exact[0]}
    return out


def eval_readings(driver) -> dict:
    from vtgbench.harness import check_eval as ce

    sound = (driver.outputs, driver.last)
    driver.cfg = dataclasses.replace(driver.cfg, eval_precision="tensorfloat32")
    driver.outputs = []
    driver.keep(driver.one_pass())
    control = (driver.outputs, driver.last)
    driver.release()
    cands = ce.reference_candidates(driver)
    out = {}
    for name, (driver.outputs, driver.last) in (("sound", sound), ("control", control)):
        out[name] = ce.passes_gaps(driver, cands)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    cache_dirs(os.getcwd())
    from vtgbench.harness.cell import Cell
    from vtgbench.harness.trace import Trace

    cell = Cell(os.getcwd(), args.workload)
    if not torch.cuda.is_available():
        print("vtgbench.controls: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    for seed in args.seeds:
        if cell.traffic["mode"] == "train":
            from vtgbench.drivers.train import TrainDriver

            driver = TrainDriver(cell, seed, device, Trace(False))
            driver.setup()
            driver.release()
            readings = train_readings(driver)
        else:
            from vtgbench.drivers.eval import EvalDriver

            driver = EvalDriver(cell, seed, device, Trace(False))
            driver.setup()
            readings = eval_readings(driver)
        print(json.dumps({"workload": cell.name, "seed": seed, **readings}), flush=True)
        del driver
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
