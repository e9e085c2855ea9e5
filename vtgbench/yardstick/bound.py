"""The least time of each attention kernel call, and the calls of a step.

`attention_bound` is a frozen copy of the program's documented bound
(chip_smoke.py:attention_bound) with two corrections: q, k, v, O and their
gradients count at the dial's operand width (2 bytes at bfloat16, 4
otherwise), masks and log-sum-exps as stored (4 bytes); and only valid
rows count: the pairs are each row's valid queries times its valid keys,
and the bytes of q, O, their gradients and the log-sum-exps are counted
at the valid query rows, those of k, v and theirs at the valid key rows
(`q_rows`, `k_rows`; by default every row, which is chip_smoke's count).
Each input is read once and each output written once over the memory
rate, against the operations the valid (b, h, i, j) pairs need: dot
products at the tensor-core rate of the dial's form, the rest at the
float32 rate; the least time is the larger of the two.

`step_calls` lists the attention calls of one FlashVTG step from its masks
(the dummy-token encoder's self-attention, the ACA layers, the video
self-attention; in training both passes, the negative pass on the rolled
text, and the ACA's donor-row mask), each as (family, backward, least
seconds):
family "flash" (self-attention past 128 keys, the memory-linear kernels)
or "aca" (the ACA and the short self-attention kernels).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

F32_PEAK = 67e12  # H100 SXM float32 outside the tensor cores, FLOP/s
DOT_PEAK = {"3xtf32": 495e12 / 3, "1xtf32": 495e12, "bf16": 989e12}
HBM_RATE = 3.35e12  # H100 SXM device memory, bytes/s
FORMS = {"float32": "3xtf32", "tensorfloat32": "1xtf32", "bfloat16": "bf16"}
MAX_SHORT_KEYS = 128  # self-attention past this many keys takes the flash kernels


def attention_bound(b, lv, lk, heads, nd, n_valid_keys, want_head_mean, backward=False,
                    pairs=None, form="3xtf32", q_rows=None, k_rows=None):
    """Least seconds of one attention call: (b, lv) queries against (b, lk)
    keys of which n_valid_keys are valid in all, nd dummy keys leading;
    `pairs` = (valid pairs, value pairs past the dummies) over batch and
    heads where a mask beyond the key mask removes pairs or a query row is
    padding; q_rows and k_rows the valid query and key rows over the batch
    (default b * lv and b * lk)."""
    d = heads * 32
    w = 2 if form == "bf16" else 4
    q_rows = b * lv if q_rows is None else q_rows
    k_rows = b * lk if k_rows is None else k_rows
    if pairs is None:
        pairs = (heads * lv * float(n_valid_keys[0]), heads * lv * float(n_valid_keys[1]))
    valid_pairs, value_pairs = pairs
    if backward:
        nbytes = w * (3 * q_rows * d + 4 * k_rows * d) + 4 * (b * lk + heads * q_rows)
        if want_head_mean:
            nbytes += 4 * q_rows * lk
        elif lv > MAX_SHORT_KEYS:  # the flash backward also reads O
            nbytes += w * q_rows * d
        dots = 3 * 2 * 32 * valid_pairs + 2 * 2 * 32 * value_pairs
        other = 6 * valid_pairs
    else:
        nbytes = w * (2 * q_rows * d + 2 * k_rows * d) + 4 * b * lk
        if want_head_mean:
            nbytes += 4 * q_rows * lk
        dots = 2 * 32 * valid_pairs + 2 * 32 * value_pairs
        other = (6 if want_head_mean else 5) * valid_pairs
    return max(nbytes / HBM_RATE, max(dots / DOT_PEAK[form], other / F32_PEAK))


def _tiled_donors(b, heads):
    return (np.arange(b)[:, None] * heads + np.arange(heads)[None, :]) % b


def _neg_donors(real_neg, heads):
    m = real_neg > 0
    order = np.argsort(~m, kind="stable")
    r = max(int(m.sum()), 1)
    fidx = np.maximum(np.cumsum(m) - 1, 0)
    return order[(fidx[:, None] * heads + np.arange(heads)[None, :]) % r]


def _donor_pairs(key_valid, q_valid, q_valid_table, k_valid_table, donors, nd):
    """(valid pairs, value pairs) of the ACA with donor rows over the valid
    query rows `q_valid` (B, Lv): key j of row b is masked for query i also
    where the donor's query i and key j are both padding."""
    kv = key_valid > 0  # (B, Lk)
    qv = q_valid > 0  # (B, Lv)
    # valid queries of row b that are padding in the donor's row
    qpad = (qv[:, None, :] & (q_valid_table[donors] <= 0)).sum(axis=2)  # (B, H)
    kpad = k_valid_table <= 0  # (G, Lk)
    both = kv[:, None, :] & kpad[donors]  # (B, H, Lk)
    nq = qv.sum(axis=1)[:, None]
    valid = nq * kv.sum(axis=1)[:, None] - qpad * both.sum(axis=2)
    value = nq * kv[:, nd:].sum(axis=1)[:, None] - qpad * both[..., nd:].sum(axis=2)
    return float(valid.sum()), float(value.sum())


def _self_pairs(valid, heads):
    """(valid pairs, value pairs) of a self-attention over masks (B, L):
    each row's valid queries against its valid keys."""
    n = valid.sum(axis=1)
    p = heads * float((n * n).sum())
    return p, p


def step_calls(cfg: dict, vid_valid: np.ndarray, txt_valid: np.ndarray, train: bool,
               precision: str, real_neg=None) -> List[Tuple[str, bool, float]]:
    """(family, backward, least seconds) of every attention call of one step on masks
    vid_valid (B, Lv) and txt_valid (B, Lq), forward and, in training,
    backward; the negative pass in training with use_neg."""
    form = FORMS[precision]
    b, lv = vid_valid.shape
    nd, heads = cfg["num_dummies"], cfg["nheads"]
    dheads = cfg["dummy_nheads"]
    txt_d = np.concatenate([np.ones((b, nd)), txt_valid], axis=1)
    lk = txt_d.shape[1]
    passes = [False, True] if train else [False]
    calls = []

    def add(family, *args, **kw):
        for bwd in passes:
            calls.append((family, bwd, attention_bound(*args, backward=bwd, form=form, **kw)))

    short = lambda length: "aca" if length <= MAX_SHORT_KEYS else "flash"
    n_txt, n_vid = txt_d.sum(), vid_valid.sum()
    for _ in range(cfg["dummy_layers"]):  # the dummy-token encoder, once
        add(short(lk), b, lk, lk, dheads, 0, None, False, pairs=_self_pairs(txt_d, dheads),
            q_rows=n_txt, k_rows=n_txt)
    trunks = [(txt_d, _tiled_donors(b, heads) if train else None, txt_d)]
    if train and cfg["use_neg"]:
        rolled = np.roll(txt_d, -1, axis=0)
        rn = np.ones(b) if real_neg is None else np.asarray(real_neg)
        trunks.append((rolled, _neg_donors(rn, heads), rolled))
    nv = vid_valid.sum(axis=1)
    for keys, donors, table in trunks:
        if donors is not None:
            pairs = _donor_pairs(keys, vid_valid, vid_valid, table, donors, nd)
        else:
            pairs = (heads * float((nv * keys.sum(axis=1)).sum()),
                     heads * float((nv * keys[:, nd:].sum(axis=1)).sum()))
        for _ in range(cfg["t2v_layers"]):
            add("aca", b, lv, lk, heads, nd, None, True, pairs=pairs, q_rows=n_vid,
                k_rows=keys.sum())
        for _ in range(cfg["enc_layers"]):
            add(short(lv), b, lv, lv, heads, 0, None, False,
                pairs=_self_pairs(vid_valid, heads), q_rows=n_vid, k_rows=n_vid)
    return calls
