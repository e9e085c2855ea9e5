"""Run one cell of the benchmark and print its result line.

    python3 -m vtgbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout (BENCHMARK.json beside vtgbench/). The cell's
configuration, traffic mix and per-layer metrics are files that
BENCHMARK.json names (vtgbench/harness/cell.py); the traffic's `mode`
picks the driver (vtgbench/drivers/). A run: set-up (everything up to the
first timed step, `setup_s` from the process's start), the window, the
peak memory, then the program's state freed and the output check against
the plain reference, the numbers compared printed beside their limits as
the last lines of standard error and under "checks" in the result line,
which is the last line of standard output. With --trace 1 the window runs
under the profiler and the result carries the per-layer metrics, the
device's busy and window seconds and the breakdown. A run exits with 2 and
prints no result without the card(s) the cell needs, and with 3 if the
JAX package, JAX or Flax was loaded.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

FORBIDDEN = ("jax", "jaxlib", "flax", "flashvtg_tpu")


def process_start() -> float:
    """The process's start on the wall clock (from /proc), or now."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


START = process_start()


def cache_dirs(root: str) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths."""
    base = os.path.join(root, "vtgbench", "_cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(base, sub)
    os.environ["USE_FLAX"] = "0"


def loaded_forbidden():
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(FORBIDDEN))


def fmt(v) -> str:
    return "inf" if isinstance(v, float) and math.isinf(v) else f"{v:.6g}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = os.getcwd()
    cache_dirs(root)

    import torch

    from vtgbench.harness.cell import Cell

    cell = Cell(root, args.workload)
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell.chips:
        print(f"vtgbench: {cell.chips} CUDA device(s) needed, {found} found", file=sys.stderr)
        return 2
    result = run(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0))
    forbidden = loaded_forbidden()
    if forbidden:
        print(f"vtgbench: loaded {', '.join(forbidden)}: the run may not load them",
              file=sys.stderr)
        return 3
    print(json.dumps(result, allow_nan=False))
    return 0


def run(cell, seed: int, seconds: float, traced: bool, device) -> dict:
    """One run of `cell` on `device`: its result line as a dict; the
    numbers compared are printed on standard error, last."""
    import torch

    from vtgbench.harness.trace import Trace

    if cell.traffic["mode"] == "train":
        from vtgbench.drivers.train import TrainDriver as Driver
    else:
        from vtgbench.drivers.eval import EvalDriver as Driver
    cuda = device.type == "cuda"
    trace = Trace(traced)
    if cuda:
        torch.cuda.set_device(device)
        torch.empty(1, device=device)  # the context, before its memory statistics
        torch.cuda.reset_peak_memory_stats(device)
    driver = Driver(cell, seed, device, trace)
    driver.setup()
    if cuda:
        torch.cuda.synchronize(device)
    setup_s = time.time() - START
    print(f"vtgbench: set-up {setup_s:.2f} s", file=sys.stderr)
    if traced:  # a mix whose every kernel record would take too long to read traces less
        seconds = min(seconds, cell.traffic.get("trace_seconds", seconds))
    e2e = driver.window(seconds)
    print(f"vtgbench: window {trace.window_s:.2f} s, {e2e}", file=sys.stderr)
    result = {
        "correct": False, "attempted": driver.attempted, "failed": driver.failed,
        "device": {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(device) if cuda else "cpu", "count": 1,
                   "memory_peak_bytes": torch.cuda.max_memory_allocated(device) if cuda else 0},
    }
    if traced:
        metrics = {}
        for m in cell.per_layer():
            value = cell.reader(m["name"])(trace)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result["device"].update(busy_s=trace.busy_s(), window_s=trace.window_s)
        result["breakdown"] = {"device_ops": trace.device_ops(), "idle_gaps": trace.idle_gaps()}
        for line in trace.extra.get("notes", []):
            print(f"vtgbench: {line}", file=sys.stderr)
    else:
        units = {m["name"]: m["unit"] for m in cell.end_to_end()}
        metrics = {k: {"value": v, "unit": units[k]} for k, v in e2e.items()}
        metrics["setup_s"] = {"value": setup_s, "unit": units["setup_s"]}
    result["metrics"] = metrics
    driver.release()
    t0 = time.time()
    checks = driver.check()
    print(f"vtgbench: output check {time.time() - t0:.2f} s", file=sys.stderr)
    ok = all(limit is not None and value <= limit for _, value, limit in checks)
    result["correct"] = bool(ok and driver.failed == 0)
    for name, value, limit in checks:
        print(f"check {name} {fmt(value)} limit {fmt(limit) if limit is not None else 'none'}",
              file=sys.stderr)
    result["checks"] = {name: {"value": value if math.isfinite(value) else None,
                               "limit": limit} for name, value, limit in checks}
    return result


if __name__ == "__main__":
    sys.exit(main())
