"""Scalar logging, the profile trace and the NaN tripwire of a training run.

Counterpart of flashvtg_tpu/utils/observability.py:
  * `ScalarWriter`: scalars.jsonl always; TensorBoard events through
    torch.utils.tensorboard when it imports; a wandb run when asked for and
    wandb imports. A sink that is missing costs one warning, never the run.
    `NullWriter` writes nothing (the data-parallel ranks other than 0).
  * `profile_trace(log_dir)`: a torch.profiler trace (host ops, and the
    card's kernels and copies where CUDA is present) around a block,
    written into log_dir as `<worker>.<time>.pt.trace.json`, which
    TensorBoard's profiler plugin and Perfetto open (JAX: jax.profiler's
    trace).
  * `nan_tripwire(model)`: the counterpart of jax_debug_nans, scoped to the
    block (JAX sets its flag for the whole process): every module's
    forward output is checked, and the first one that holds a NaN raises
    FloatingPointError naming the module, as jax_debug_nans raises at the
    op (NaNs only, as jax_debug_nans: an infinity is a legitimate output,
    such as the model's padded pyramid points); autograd's anomaly mode
    (the reference's `torch.autograd.detect_anomaly`) checks the backward
    for NaNs. Each check reads the value on the host: a sync per module
    output on the card.
  * `check_finite_tree(named, name)`: the post-epoch finite check over the
    parameters, naming each non-finite leaf.
  * Spans and counters (`RECORDER`, `root`, `span`, `count`): the program's
    own record of where its host time goes, at the boundaries of the eval
    pipeline, the train epoch and data load. A span keeps its name, an id
    (the batch number in the eval, the step number in training; a span
    given none takes its parent's), its parent, its thread's name, and its
    start and end on `time.time_ns()`, the clock torch.profiler stamps its
    records with. Spans are recorded exactly while a torch profiler
    records: a root (`root`: eval.infer, eval.metrics, train.epoch) reads
    the profiler's flag once, on the thread that calls it, and while it is
    open every thread's spans are kept (the flag is thread-local, and the
    train loop's batch-prefetch thread makes its batches inside the root).
    With no profiler a root costs that one read and a span one branch.
    Counters are process-wide and cumulative, always counted; each root
    keeps their deltas over its own interval. Spans are kept in memory, at
    most `SPAN_BOUND`; those past it are dropped and counted
    (`RECORDER.dropped`). `profile_trace` writes the spans recorded under
    it into log_dir as `spans.jsonl`.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import json
import logging
import os
import threading
import time
from typing import Dict, Iterable, List, NamedTuple, Optional, Tuple

import torch

logger = logging.getLogger(__name__)


class ScalarWriter:
    """Per-step scalar sink: `write(step, {name: value}, prefix)`."""

    def __init__(self, log_dir: str, use_tensorboard: bool = True,
                 wandb_run: Optional[Dict] = None):
        """`wandb_run`, when set, is the keyword dict for wandb.init
        (project, name, config), as the reference `_ms` trainer calls it."""
        os.makedirs(log_dir, exist_ok=True)
        self._f = open(os.path.join(log_dir, "scalars.jsonl"), "a")
        self._tb = None
        self._wb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(log_dir)
            except Exception as e:  # optional: a missing or broken package
                logger.warning("TensorBoard unavailable (%r); scalars go to "
                               "scalars.jsonl", e)
        if wandb_run:
            # wandb must never take training down: a missing package, key or
            # network all leave the jsonl (+ TensorBoard) sinks
            try:
                import wandb

                self._wb = wandb.init(**wandb_run)
            except Exception as e:
                logger.warning("--use_wandb set but wandb is unavailable (%r); "
                               "scalars still go to scalars.jsonl", e)

    def write(self, step: int, scalars: Dict[str, float], prefix: str = "") -> None:
        row = {"step": step, "time": time.time()}
        for k, v in scalars.items():
            name = f"{prefix}{k}"
            row[name] = float(v)
            if self._tb is not None:
                self._tb.add_scalar(name, float(v), step)
        self._f.write(json.dumps(row) + "\n")
        self._f.flush()
        if self._wb is not None:
            try:
                self._wb.log({k: v for k, v in row.items() if k not in ("step", "time")},
                             step=step)
            except Exception as e:  # drop the mirror, keep training
                logger.warning("wandb.log failed (%r); disabling the wandb mirror", e)
                self._wb = None

    def write_text(self, tag: str, text: str) -> None:
        """One text record (the reference's hyperparameters dump)."""
        if self._tb is not None:
            self._tb.add_text(tag, text)

    def close(self) -> None:
        self._f.close()
        if self._tb is not None:
            self._tb.close()
        if self._wb is not None:
            self._wb.finish()


class NullWriter:
    """A ScalarWriter that writes nothing: the data-parallel ranks other than
    rank 0, whose scalars rank 0 writes."""

    def write(self, step: int, scalars: Dict[str, float], prefix: str = "") -> None:
        pass

    def write_text(self, tag: str, text: str) -> None:
        pass

    def close(self) -> None:
        pass


SPAN_BOUND = 200_000  # spans kept in memory; later ones are dropped and counted


class Span(NamedTuple):
    """One recorded span (see the module's doc). `seq` numbers the spans of
    the process in the order they opened; `parent` is the seq of the span
    that holds it (on its own thread, else the root open at the time);
    `counters` holds a root's counter deltas, None on other spans."""

    seq: int
    name: str
    id: Optional[int]
    parent: Optional[int]
    thread: str
    start_ns: int
    end_ns: int
    counters: Optional[Dict[str, int]] = None

    def row(self) -> dict:
        """The span as one spans.jsonl row."""
        out = {"name": self.name, "id": self.id, "seq": self.seq, "parent": self.parent,
               "thread": self.thread, "start_ns": self.start_ns, "end_ns": self.end_ns}
        if self.counters is not None:
            out["counters"] = self.counters
        return out


class _Open:
    """A span while it is open."""

    __slots__ = ("rec", "name", "id", "seq", "parent", "t0", "before", "stack")

    def __init__(self, rec: "Recorder", name: str, id: Optional[int], is_root: bool = False):
        self.rec, self.name, self.id = rec, name, id
        self.before = {} if is_root else None  # a root's counters at its start

    def __enter__(self):
        rec = self.rec
        stack = self.stack = rec._stack()
        holder = None if self.before is not None else stack[-1] if stack else rec.active
        self.parent = None if holder is None else holder.seq
        if self.id is None and holder is not None:
            self.id = holder.id
        self.seq = next(rec._seq)
        stack.append(self)
        if self.before is not None:
            with rec._lock:
                self.before = dict(rec.counters)
            rec.active = self
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        rec = self.rec
        self.stack.pop()
        deltas = None
        if self.before is not None:  # a root: its counters' deltas, then recording ends
            rec.active = None
            with rec._lock:
                deltas = {k: v - self.before.get(k, 0) for k, v in rec.counters.items()
                          if v != self.before.get(k, 0)}
        rec._keep(Span(self.seq, self.name, self.id, self.parent,
                       threading.current_thread().name, self.t0, t1, deltas))
        return False


class Recorder:
    """The spans and counters of a process (module doc); `RECORDER` is the
    one the program records into."""

    def __init__(self, bound: int = SPAN_BOUND):
        self.bound = bound
        self.spans: List[Span] = []
        self.counters: Dict[str, int] = {}
        self.dropped = 0
        self.active: Optional[_Open] = None  # the root being recorded
        self._lock = threading.Lock()
        self._seq = itertools.count()
        self._local = threading.local()

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _keep(self, span: Span) -> None:
        if len(self.spans) < self.bound:  # a list's append is atomic
            self.spans.append(span)
        else:
            with self._lock:
                self.dropped += 1

    def span(self, name: str, id: Optional[int] = None):
        """A span of the block, kept while a root is recorded; else nothing."""
        if self.active is None:
            return _OFF
        return _Open(self, name, id)

    def root(self, name: str, id: Optional[int] = None):
        """The root span of the block: recorded, and every thread's spans
        with it, when a torch profiler records on the calling thread; a
        plain span inside a root already open; else nothing."""
        if self.active is not None:
            return self.span(name, id)
        if not torch._C._autograd._profiler_enabled():
            return _OFF
        return _Open(self, name, id, is_root=True)

    def count(self, name: str, n: int = 1) -> None:
        """Add n to the process-wide counter `name`."""
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def counter(self, name: str) -> int:
        return self.counters.get(name, 0)

    def clear(self) -> None:
        """Forget the kept spans and the dropped count (counters stay)."""
        with self._lock:
            self.spans = []
            self.dropped = 0


_OFF = contextlib.nullcontext()
RECORDER = Recorder()
span = RECORDER.span
count = RECORDER.count
counter = RECORDER.counter


def root(name: str):
    """Decorator: the function's every call is the root span `name`
    (Recorder.root)."""

    def wrap(fn):
        @functools.wraps(fn)
        def rooted(*args, **kwargs):
            with RECORDER.root(name):
                return fn(*args, **kwargs)
        return rooted
    return wrap


def write_spans(path: str, spans: Iterable[Span]) -> None:
    """Append `spans` to the jsonl file `path`, one row a span."""
    with open(path, "a") as f:
        for s in spans:
            f.write(json.dumps(s.row()) + "\n")


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]):
    """torch.profiler trace of the block into `log_dir` (see the module's
    doc), and the spans recorded under it appended to log_dir/spans.jsonl;
    no trace with no `log_dir`. The card is synchronized before the trace
    stops, so every kernel of the block is in it."""
    if not log_dir:
        yield
        return
    import torch.profiler as tp

    os.makedirs(log_dir, exist_ok=True)
    cuda = torch.cuda.is_available()
    activities = [tp.ProfilerActivity.CPU] + ([tp.ProfilerActivity.CUDA] if cuda else [])
    first = len(RECORDER.spans)
    with tp.profile(activities=activities, on_trace_ready=tp.tensorboard_trace_handler(log_dir)):
        try:
            yield
        finally:
            if cuda and torch.cuda.is_initialized():
                torch.cuda.synchronize()
    write_spans(os.path.join(log_dir, "spans.jsonl"), RECORDER.spans[first:])
    logger.info("profile trace and spans written to %s", log_dir)


def _floats(out):
    """The floating tensors of a module's output (tensors, or lists,
    tuples and dicts of them)."""
    if isinstance(out, torch.Tensor):
        if out.is_floating_point():
            yield out
    elif isinstance(out, dict):
        for v in out.values():
            yield from _floats(v)
    elif isinstance(out, (list, tuple)):
        for v in out:
            yield from _floats(v)


@contextlib.contextmanager
def nan_tripwire(model: torch.nn.Module):
    """The NaN tripwire inside the block (see the module's doc): a forward
    hook on every module of `model` and autograd's anomaly mode with its
    NaN check; hooks removed and the anomaly mode restored on exit, also
    after an exception."""

    def hook_for(name):
        def hook(module, args, out):
            for t in _floats(out):
                if bool(torch.isnan(t).any()):
                    raise FloatingPointError(
                        f"debug_nans: NaN in the output of module "
                        f"{name or '<model>'} ({type(module).__name__})")
        return hook

    handles = [m.register_forward_hook(hook_for(n)) for n, m in model.named_modules()]
    try:
        with torch.autograd.detect_anomaly(check_nan=True):
            yield
    finally:
        for h in handles:
            h.remove()


def check_finite_tree(named: Iterable[Tuple[str, torch.Tensor]], name: str = "tree") -> bool:
    """Whether every tensor of (name, tensor) pairs is finite; each that is
    not is logged by name (the JAX loop's post-epoch guard)."""
    ok = True
    for key, t in named:
        if not bool(torch.isfinite(t.detach()).all()):
            logger.warning("[numerics] non-finite values in %s:%s", name, key)
            ok = False
    return ok
