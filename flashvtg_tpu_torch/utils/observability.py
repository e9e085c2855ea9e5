"""Scalar logging of a training run.

Counterpart of flashvtg_tpu/utils/observability.py (`ScalarWriter`):
scalars.jsonl always; TensorBoard events through torch.utils.tensorboard
when it imports; a wandb run when asked for and wandb imports. A sink that
is missing costs one warning, never the run. The profile trace and the
finite checks are ROADMAP Queue A 8.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict, Optional

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
