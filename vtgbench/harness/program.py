"""What the per-layer metric files read of the program's own spans and
counters (flashvtg_tpu_torch/utils/observability.py): the spans the program
recorded while the traced window ran under the profiler, the counter deltas
its roots kept (`eval.infer` a pass, `train.epoch` an epoch), and the
device's idle time put down to the span the program's main thread had open.

Spans and the profiler's device records are stamped on one clock,
`time.time_ns()`, so they are compared as they are, with no offset (the
harness's own `Trace._offset_ns` is not applied). Each function returns
None where there is nothing to read, never 0: a window of the other mode,
no root recorded, no span of the kind, or a program without the recorder
(an older tree).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

ROOTS = {"eval": "eval.infer", "train": "train.epoch"}
# the harness's own span around each root's call (harness/drivers)
HARNESS_SPANS = {"eval": "infer", "train": "epoch"}


def program_spans() -> Optional[list]:
    """The spans the program recorded in this process, or None where it has
    no recorder."""
    try:
        from flashvtg_tpu_torch.utils.observability import RECORDER
    except ImportError:
        return None
    return list(RECORDER.spans)


def _roots(trace, mode: str, spans) -> list:
    if trace.extra.get("mode") != mode or not spans:
        return []
    return [s for s in spans if s.name == ROOTS[mode] and s.counters is not None]


def _counted(roots, name: str) -> int:
    return sum(r.counters.get(name, 0) for r in roots)


def _seconds(spans, names: Sequence[str]) -> Tuple[float, int]:
    """(total seconds, count) of the spans named one of `names`."""
    mine = [s for s in spans if s.name in names]
    return sum(s.end_ns - s.start_ns for s in mine) / 1e9, len(mine)


def ms_per(trace, mode: str, stage: str, unit: str) -> Optional[float]:
    """ms of the `stage` spans over the roots' count of `unit` (a counter:
    train.steps, eval.batches)."""
    spans = program_spans()
    roots = _roots(trace, mode, spans)
    n = _counted(roots, unit)
    total, found = _seconds(spans or [], (stage,))
    if not n or not found:
        return None
    return total * 1e3 / n


def seconds_per_root(trace, mode: str, stages: Sequence[str]) -> Optional[float]:
    """Seconds of the `stages` spans over the roots (a pass, an epoch)."""
    spans = program_spans()
    roots = _roots(trace, mode, spans)
    total, found = _seconds(spans or [], stages)
    if not roots or not found:
        return None
    return total / len(roots)


def share(trace, mode: str, part: str, whole: str) -> Optional[float]:
    """100 x the roots' count of `part` over their count of `whole`."""
    roots = _roots(trace, mode, program_spans())
    n = _counted(roots, whole)
    return 100.0 * _counted(roots, part) / n if n else None


def _union(intervals) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def _overlap(xs, ys) -> int:
    """ns that two sorted lists of disjoint intervals share."""
    i = j = total = 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            total += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_intervals(trace) -> List[Tuple[int, int]]:
    """The device's idle intervals between the window's first and last
    device record (ns on the shared clock)."""
    busy = _union((s, s + d) for _, s, d in trace.records)
    return [(a[1], b[0]) for a, b in zip(busy, busy[1:])]


def idle_named_share(trace, mode: str) -> Optional[float]:
    """100 x the device-idle time during which the innermost program span
    open on the main thread (the roots' thread) is a stage span (any span
    but a root of the mode), over the device-idle time. Also notes the
    program's accounting beside the harness's (`note_accounting`)."""
    spans = program_spans()
    roots = _roots(trace, mode, spans)
    if not roots or not trace.records:
        return None
    idle = idle_intervals(trace)
    total = sum(b - a for a, b in idle)
    if not total:
        return None
    note_accounting(trace, mode, spans, roots)
    return 100.0 * _overlap(idle, _stages(spans, roots)) / total


def _stages(spans, roots) -> List[Tuple[int, int]]:
    """The union of the stage spans on the roots' thread."""
    thread = roots[0].thread
    return _union((s.start_ns, s.end_ns) for s in spans
                  if s.thread == thread and s.name not in ROOTS.values())


def note_accounting(trace, mode: str, spans, roots) -> None:
    """A note (printed by the run) of the program's spans and counters
    against the harness's: the roots' seconds beside the harness's spans
    around the same calls, the share of the roots' time the main thread's
    stage spans cover, the counters beside the harness's step count, and
    the spans dropped past the recorder's bound."""
    from flashvtg_tpu_torch.utils.observability import RECORDER

    root_s = sum(r.end_ns - r.start_ns for r in roots) / 1e9
    harness_s = sum(trace.span_seconds(HARNESS_SPANS[mode]))
    root_iv = _union((r.start_ns, r.end_ns) for r in roots)
    cover = _overlap(root_iv, _stages(spans, roots)) / max(sum(b - a for a, b in root_iv), 1)
    names = (("eval.batches", "eval.fetches") if mode == "eval" else
             ("train.steps", "graph.captures", "data.video_rows", "data.valid_video_rows"))
    counts = ", ".join(f"{n} {_counted(roots, n)}" for n in names)
    trace.extra.setdefault("notes", []).append(
        f"program spans ({mode}): {ROOTS[mode]} {root_s:.4f} s over {len(roots)} roots, the "
        f"harness's {HARNESS_SPANS[mode]} {harness_s:.4f} s; stage spans cover "
        f"{100 * cover:.2f} % of it on {roots[0].thread}; {counts}; trace.steps "
        f"{trace.steps}; spans kept {len(spans)}, dropped {RECORDER.dropped}")
