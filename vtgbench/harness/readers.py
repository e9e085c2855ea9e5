"""What the per-layer metric files read from a traced window (harness/
trace.py): device time a step, by kernel class, the idle share, the
attention families' share of their least time, and the whole step's share
of the card's peak. Each returns None where the window holds nothing to
read (no launch of the family, no span), never 0 for a share.

`trace.meta` holds, per step (train) or batch (eval) of the window, the
rows' valid clip counts, valid token counts and the negative-pass mask;
`trace.extra` the mode, the dial and the configuration.
"""

from __future__ import annotations

import collections
from functools import lru_cache
from typing import Optional

import numpy as np

from vtgbench.yardstick.bound import step_calls
from vtgbench.yardstick.flops import PEAK_TFLOPS, model_config, model_flops
from vtgbench.yardstick.kernels import family, kernel_class, main_call


def in_mode(trace, mode: str) -> bool:
    return trace.extra.get("mode") == mode and trace.steps > 0 and bool(trace.records)


def busy_ms_per_step(trace, mode: str) -> Optional[float]:
    if not in_mode(trace, mode):
        return None
    return trace.busy_s() * 1e3 / trace.steps


def class_ms_per_step(trace, mode: str, cls: str) -> Optional[float]:
    if not in_mode(trace, mode):
        return None
    ns = sum(d for name, _, d in trace.records if kernel_class(name) == cls)
    return ns / 1e6 / trace.steps


def idle_share(trace, mode: str) -> Optional[float]:
    if not in_mode(trace, mode):
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)


def _masks(meta, lv: int, lq: int):
    clips, tokens, real_neg = meta
    vid = (np.arange(lv)[None, :] < np.asarray(clips)[:, None]).astype(np.float64)
    txt = (np.arange(lq)[None, :] < np.asarray(tokens)[:, None]).astype(np.float64)
    return vid, txt, real_neg


def roofline(trace, mode: str, fam: str) -> Optional[float]:
    """100 x the family's least seconds over its device seconds in the
    window; where the launches seen of a kind of call differ from the calls
    the steps made (the profiler drops records now and then), a note says so
    and the least time counts the launches seen."""
    if not in_mode(trace, mode):
        return None
    device_s = sum(d for name, _, d in trace.records if family(name) == fam) / 1e9
    if device_s == 0:
        return None
    cfg = trace.extra["config"]
    least = collections.defaultdict(float)
    calls = collections.Counter()
    for meta in trace.meta:
        vid, txt, real_neg = _masks(meta, cfg["max_v_l"], cfg["max_q_l"])
        for f, bwd, t in step_calls(cfg, vid, txt, mode == "train", trace.extra["precision"],
                                    real_neg):
            if f == fam:
                least[bwd] += t
                calls[bwd] += 1
    seen = collections.Counter()
    for name, _, _ in trace.records:
        key = main_call(name)
        if key is not None and key[0] == fam:
            seen[key[1]] += 1
    total = 0.0
    for bwd, n in calls.items():
        if seen[bwd] != n:
            trace.extra.setdefault("notes", []).append(
                f"{fam} {'backward' if bwd else 'forward'}: {seen[bwd]} launches seen in the "
                f"trace, {n} calls made; the roofline counts the launches seen")
        total += least[bwd] / n * seen[bwd]
    return 100.0 * total / device_s


@lru_cache(maxsize=None)
def _row_flops(cfg_items, lv: int, lq: int, train: bool) -> float:
    mc = model_config(dict(cfg_items))
    return model_flops(mc, 1, lq, lv, train=train)["fwd_bwd" if train else "fwd"]


def mfu(trace, mode: str) -> Optional[float]:
    """100 x the window's counted FLOPs (each row at its valid clips and
    tokens) over the window's seconds, against the bf16 dense peak."""
    if not in_mode(trace, mode):
        return None
    cfg = trace.extra["config"]
    items = tuple(sorted((k, tuple(v) if isinstance(v, list) else v) for k, v in cfg.items()
                         if not isinstance(v, dict)))
    flops = sum(_row_flops(items, int(lv), int(lq), mode == "train")
                for clips, tokens, _ in trace.meta for lv, lq in zip(clips, tokens))
    return 100.0 * flops / trace.window_s / (PEAK_TFLOPS * 1e12)


def mean_span(trace, mode: str, key: str) -> Optional[float]:
    values = trace.extra.get(key) if trace.extra.get("mode") == mode else None
    return float(np.mean(values)) if values else None
