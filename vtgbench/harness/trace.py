"""The traced window: the profiler's device records, and the host spans the
harness records around its calls into the program.

`Trace` runs the window under torch.profiler (device activity only) and
reads the raw kernel and copy records (name, start, duration), as the
program's profile tool does: building the profiler's op tree would take
minutes. `busy_s` is the union of the records' intervals (an operation ran
on the device), `window_s` the traced window's wall time. The host spans
(`span`) name what the host was doing; an idle gap of the device is named
by the span that holds its middle. With --trace 0 nothing is profiled and
the spans alone are kept.
"""

from __future__ import annotations

import collections
import contextlib
import time
from typing import Dict, List, Optional, Tuple

import torch


class Trace:
    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.spans: List[Tuple[str, int, int]] = []  # (name, start ns, end ns), host clock
        self.records: List[Tuple[str, int, int]] = []  # (name, start ns, duration ns)
        self.window_s: Optional[float] = None
        self.steps = 0
        self.meta: List[dict] = []  # per traced step or batch: what the readers need
        self.extra: Dict[str, object] = {}
        self._offset_ns = 0

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.spans.append((name, t0, time.time_ns()))

    def span_seconds(self, name: str) -> List[float]:
        return [(b - a) / 1e9 for n, a, b in self.spans if n == name]

    @contextlib.contextmanager
    def window(self):
        """The measured window; under the profiler when enabled."""
        if not self.enabled:
            t0 = time.perf_counter()
            yield
            self.window_s = time.perf_counter() - t0
            return
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        prof.__enter__()
        host0 = time.time_ns()
        t0 = time.perf_counter()
        try:
            yield
            torch.cuda.synchronize()
        finally:
            self.window_s = time.perf_counter() - t0
            prof.__exit__(None, None, None)
        results = prof.profiler.kineto_results
        self._offset_ns = results.trace_start_ns() - host0
        for e in results.events():
            if e.device_type() == torch.autograd.DeviceType.CUDA and not e.is_user_annotation():
                self.records.append((e.name(), e.start_ns(), e.duration_ns()))

    def per_name(self) -> Dict[str, List[float]]:
        """{device operation: [seconds, calls]}."""
        out = collections.defaultdict(lambda: [0.0, 0])
        for name, _, dur in self.records:
            out[name][0] += dur / 1e9
            out[name][1] += 1
        return dict(out)

    def _intervals(self):
        return sorted((s, s + d) for _, s, d in self.records)

    def busy_s(self) -> float:
        busy, end = 0, None
        for s, e in self._intervals():
            if end is None or s > end:
                busy += e - s
                end = e
            elif e > end:
                busy += e - end
                end = e
        return busy / 1e9

    def idle_gaps(self, top: int = 10):
        """The longest gaps between device operations, each named by the
        host span around its middle: [[name, seconds], ...]."""
        gaps, end = [], None
        for s, e in self._intervals():
            if end is not None and s > end:
                gaps.append((s - end, end, s))
            end = e if end is None else max(end, e)
        gaps.sort(reverse=True)
        out = []
        for length, a, b in gaps[:top]:
            mid = (a + b) // 2 - self._offset_ns
            inside = [n for n, t0, t1 in self.spans if t0 <= mid <= t1]
            out.append([inside[-1] if inside else "unattributed", length / 1e9])
        return out

    def device_ops(self, top: int = 10):
        ops = sorted(self.per_name().items(), key=lambda kv: -kv[1][0])
        return [[name, secs] for name, (secs, _) in ops[:top]]
