"""Imported by every tests/test_torch_*.py: under pytest-xdist, torch's CPU
thread pool takes its share of the machine's cores, not all of them.

Each xdist worker otherwise starts one intra-op thread a core, so six
workers on eight cores run 48 threads beside JAX's own pools: one
`tests/test_torch_cli.py` fixture took 246 s in each of six concurrent
processes at torch's default and 8.6 s at one thread. Every worker imports
every test module while it collects, so the setting holds for the JAX
package's tests in that worker too (they do not use torch). A run in one
process keeps torch's default.
"""

import os

import torch


def share_cores() -> None:
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0"))
    if workers > 1:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))


share_cores()
