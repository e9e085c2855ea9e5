"""Train steps as replays of one captured CUDA graph.

The card's counterpart of the JAX loop's one dispatch a step: the whole
train step (forward, criterion, backward, clip, AdamW and the
learning-rate schedule) is captured once, and each later step is a copy of
its inputs into the graph's static inputs and one replay: the same math as
an eager step, without its thousands of launches and their host time.
  FeedSteps      the feed-mode step (the scan epoch, `epoch_scan_feed`):
                 labels and row indices in, the features gathered from
                 the device-resident feed inside the graph;
  StreamedSteps  the streamed step (`epoch_step`): the whole placed batch
                 in, features included (in their wire dtype: the bf16
                 wire's features are widened inside the graph).
Both copy their inputs into the static ones on the compute stream, after
the previous replay in stream order: a streamed batch copied ahead on its
own stream (data/feed.py:copy_ahead) lands in its own buffer while the
replay before it still reads the static inputs.

What makes the step capturable (each is device work without a host sync
or a pageable copy): the attention-dropout seeds are drawn on the card
from a generator registered with the graph (ops/attn_dropout.py) and read
by the kernels from device memory; feature dropout and DropPath draw from
the default CUDA generator, which every graph tracks; AdamW is capturable
(and fused) with a tensor learning rate that train/loop.py:StepLR sets from
a device step count; autocast runs without its cast cache; the forward's
host-made constants are copied to the card once, from pinned memory
without a sync (models/components.py:device_constant).
Under a NCCL process group (data parallel, parallel/mesh.py) the step holds
the gradient all-reduce, which NCCL supports under stream capture (its
communicator is made in the warm-up steps); that a replay sums the ranks'
gradients across cards is unverified (at world 1 NCCL launches no kernel
for it). gloo's collectives are host work and cannot be captured, and
train/loop.py:epoch_mode runs eager steps under gloo.
Warm-up steps (WARMUP_STEPS, real steps of the epoch) run eagerly on a
side stream, as torch's whole-network capture recipe asks, under
`torch.cuda.set_sync_debug_mode("error")`, so a step that would sync or
copy from pageable memory raises there. A capture or replay that fails
raises, and so does an input whose keys, shapes or dtypes differ from the
captured ones: nothing falls back to the eager step.

The kernels' launch counters (ops/aca.py, ops/chunked_attn.py:
FORM_LAUNCHES) count the eager warm-up steps' launches; the capture
launches nothing and counts nothing, and a replay launches the graph's
kernels without a Python call, so the replays' launches are read from the
device, in the profiler's kernel records (chip_smoke.py phases 15, 16).
Each capture counts one `graph.captures` (utils/observability.py).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import torch

from flashvtg_tpu_torch.utils import observability as obs

WARMUP_STEPS = 2


class GraphSteps:
    """steps(inputs) -> the step's loss vector on the device: `run(inputs)`
    on a dict of device tensors. Eager with graph=False; with graph=True
    (CUDA) the first `warmup` steps run eagerly on a side stream, the next
    call captures the step and every call from then on is a replay (the
    vector returned is the graph's static output, overwritten by the next
    replay). `generator` is the step's attention-dropout generator (the
    graph registers it) and `optimizer` its optimizer (its gradients are
    set to None before the capture). `capture_s` is the capture's wall
    time and `replays` the count of replays."""

    def __init__(self, run: Callable[[Dict[str, torch.Tensor]], torch.Tensor], generator,
                 optimizer, graph: bool, warmup: int = WARMUP_STEPS):
        self.run, self.generator, self.optimizer = run, generator, optimizer
        self.use_graph, self.warmup = graph, warmup
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.static: Optional[Dict[str, torch.Tensor]] = None
        self.static_out = None
        self.capture_s: Optional[float] = None
        self.warm = self.replays = 0
        self._side = None

    def __call__(self, inputs: Dict[str, torch.Tensor]) -> torch.Tensor:
        if not self.use_graph:
            return self.run(inputs)
        if self.static is None:
            self.static = {k: torch.empty_like(v, memory_format=torch.contiguous_format)
                           for k, v in inputs.items()}
        if {k: (v.shape, v.dtype) for k, v in inputs.items()} != {
                k: (v.shape, v.dtype) for k, v in self.static.items()}:
            raise ValueError("a graph step's inputs must keep the captured keys, shapes and "
                             "dtypes (a fixed max_v_l)")
        for k, v in inputs.items():
            self.static[k].copy_(v)
        if self.graph is None:
            if self.warm < self.warmup:
                self.warm += 1
                return self._warm_step()
            self._capture()
        self.graph.replay()
        self.replays += 1
        return self.static_out

    @property
    def device(self) -> torch.device:
        return next(iter(self.static.values())).device

    def _warm_step(self) -> torch.Tensor:
        if self._side is None:
            self._side = torch.cuda.Stream(self.device)
        main = torch.cuda.current_stream(self.device)
        self._side.wait_stream(main)
        with torch.cuda.stream(self._side):
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                out = self.run(self.static)
            finally:
                torch.cuda.set_sync_debug_mode(mode)
        main.wait_stream(self._side)
        return out

    def _capture(self) -> None:
        obs.count("graph.captures")
        t0 = time.perf_counter()
        device = self.device
        torch.cuda.synchronize(device)
        graph = torch.cuda.CUDAGraph()
        gen = self.generator
        if gen is not None and gen.device.type == "cuda" and all(
                gen is not d for d in torch.cuda.default_generators):
            graph.register_generator_state(gen)
        self.optimizer.zero_grad(set_to_none=True)
        with torch.cuda.graph(graph):
            self.static_out = self.run(self.static)
        torch.cuda.synchronize(device)
        self.graph = graph
        self.capture_s = time.perf_counter() - t0


class FeedSteps(GraphSteps):
    """feed_steps(labels, idx) -> the step's loss vector: one feed-mode
    train step (make_train_step's `feed_vector`) on a placed label batch
    and its row indices `idx` (int64) into the device-resident `feed`."""

    def __init__(self, step, feed: Dict[str, torch.Tensor], graph: bool,
                 warmup: int = WARMUP_STEPS):
        self.step, self.feed = step, feed

        def run(inputs):
            labels = {k: v for k, v in inputs.items() if k != "idx"}
            return step.feed_vector(labels, inputs["idx"], feed)

        super().__init__(run, step.generator, step.optimizer, graph, warmup)

    def __call__(self, labels: Dict[str, torch.Tensor], idx: torch.Tensor) -> torch.Tensor:
        return super().__call__({**labels, "idx": idx})


class StreamedSteps(GraphSteps):
    """streamed_steps(batch) -> the step's loss vector: one streamed train
    step (make_train_step's `vector`) on a placed batch, features included
    (bf16 features of the bf16 wire are widened inside the step)."""

    def __init__(self, step, graph: bool, warmup: int = WARMUP_STEPS):
        self.step = step
        super().__init__(step.vector, step.generator, step.optimizer, graph, warmup)
