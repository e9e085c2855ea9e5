"""Scalar logging, the profile trace and the NaN tripwire of a training run.

Counterpart of flashvtg_tpu/utils/observability.py:
  * `ScalarWriter`: scalars.jsonl always; TensorBoard events through
    torch.utils.tensorboard when it imports; a wandb run when asked for and
    wandb imports. A sink that is missing costs one warning, never the run.
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
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import time
from typing import Dict, Iterable, Optional, Tuple

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


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]):
    """torch.profiler trace of the block into `log_dir` (see the module's
    doc); no trace with no `log_dir`. The card is synchronized before the
    trace stops, so every kernel of the block is in it."""
    if not log_dir:
        yield
        return
    import torch.profiler as tp

    os.makedirs(log_dir, exist_ok=True)
    cuda = torch.cuda.is_available()
    activities = [tp.ProfilerActivity.CPU] + ([tp.ProfilerActivity.CUDA] if cuda else [])
    with tp.profile(activities=activities, on_trace_ready=tp.tensorboard_trace_handler(log_dir)):
        try:
            yield
        finally:
            if cuda and torch.cuda.is_initialized():
                torch.cuda.synchronize()
    logger.info("profile trace written to %s", log_dir)


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
