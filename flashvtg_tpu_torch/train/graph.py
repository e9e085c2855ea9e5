"""Feed-mode train steps as replays of one captured CUDA graph.

The card's counterpart of the JAX loop's scan epoch (`epoch_scan_feed`,
K steps of lax.scan in one dispatch): the whole train step, the gather from
the device feed, forward, criterion, backward, clip, AdamW and the
learning-rate schedule, is captured once, and each later step is a copy of
its labels and row indices into the graph's static inputs and one replay:
the same math as an eager step, without its hundreds of launches and their
host time.

What makes the step capturable (each is device work without a host sync
or a pageable copy): the attention-dropout seeds are drawn on the card
from a generator registered with the graph (ops/attn_dropout.py) and read
by the kernels from device memory; feature dropout and DropPath draw from
the default CUDA generator, which every graph tracks; AdamW is capturable
(and fused) with a tensor learning rate that train/loop.py:StepLR sets from
a device step count; autocast runs without its cast cache; the forward's
host-made constants are copied to the card once, from pinned memory
without a sync (models/components.py:device_constant).
Warm-up steps (WARMUP_STEPS, real steps of the epoch) run eagerly on a
side stream, as torch's whole-network capture recipe asks, under
`torch.cuda.set_sync_debug_mode("error")`, so a step that would sync
raises there. A capture or replay that fails raises: nothing falls back to
the eager step.

The kernels' launch counters (ops/aca.py, ops/chunked_attn.py:
FORM_LAUNCHES) count the eager warm-up steps' launches; the capture
launches nothing and counts nothing, and a replay launches the graph's
kernels without a Python call, so the replays' launches are read from the
device, in the profiler's kernel records (chip_smoke.py phase 15).
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import torch

WARMUP_STEPS = 2


class FeedSteps:
    """feed_steps(labels, idx) -> the step's loss vector on the device:
    one feed-mode train step (make_train_step's `feed_vector`) on a placed
    label batch and its row indices `idx` (int64). Eager with graph=False;
    with graph=True (CUDA) the first `warmup` steps run eagerly on a side
    stream, the next call captures the step and every call from then on is
    a replay (the vector returned is the graph's static output, overwritten
    by the next replay). `capture_s` is the capture's wall time and
    `replays` the count of replays."""

    def __init__(self, step, feed: Dict[str, torch.Tensor], graph: bool,
                 warmup: int = WARMUP_STEPS):
        self.step, self.feed, self.use_graph, self.warmup = step, feed, graph, warmup
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.static: Optional[Dict[str, torch.Tensor]] = None
        self.static_idx = self.static_out = None
        self.capture_s: Optional[float] = None
        self.warm = self.replays = 0
        self._side = None

    def __call__(self, labels: Dict[str, torch.Tensor], idx: torch.Tensor) -> torch.Tensor:
        if not self.use_graph:
            return self.step.feed_vector(labels, idx, self.feed)
        if self.static is None:
            self.static = {k: torch.empty_like(v) for k, v in labels.items()}
            self.static_idx = torch.empty_like(idx)
        for k, v in labels.items():
            self.static[k].copy_(v)
        self.static_idx.copy_(idx)
        if self.graph is None:
            if self.warm < self.warmup:
                self.warm += 1
                return self._warm_step()
            self._capture()
        self.graph.replay()
        self.replays += 1
        return self.static_out

    def _warm_step(self) -> torch.Tensor:
        if self._side is None:
            self._side = torch.cuda.Stream(self.static_idx.device)
        main = torch.cuda.current_stream(self.static_idx.device)
        self._side.wait_stream(main)
        with torch.cuda.stream(self._side):
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                out = self.step.feed_vector(self.static, self.static_idx, self.feed)
            finally:
                torch.cuda.set_sync_debug_mode(mode)
        main.wait_stream(self._side)
        return out

    def _capture(self) -> None:
        t0 = time.perf_counter()
        device = self.static_idx.device
        torch.cuda.synchronize(device)
        graph = torch.cuda.CUDAGraph()
        gen = self.step.generator
        if gen is not None and gen.device.type == "cuda" and all(
                gen is not d for d in torch.cuda.default_generators):
            graph.register_generator_state(gen)
        self.step.optimizer.zero_grad(set_to_none=True)
        with torch.cuda.graph(graph):
            self.static_out = self.step.feed_vector(self.static, self.static_idx, self.feed)
        torch.cuda.synchronize(device)
        self.graph = graph
        self.capture_s = time.perf_counter() - t0
