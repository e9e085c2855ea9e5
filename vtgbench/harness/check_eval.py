"""The output check of an eval cell: every pass's answers against the
reference.

The reference (reference/: the model in float32 with TF32 off, its decode,
the post-processing, NMS and the numpy metric suite) reads the split's raw
files itself and computes every valid point's window and score for a
sample of SAMPLE queries drawn from the seed; the driver keeps that
sample's rows of every pass and the last pass whole. Three numbers:
  score_gap      over every row of the sampled queries in every pass's plain
                 submission, the gap between
                 its score and the score of the reference's candidate with
                 the same window (rounded to the clip length, one clip of
                 room for a rounding that falls the other way; no such
                 candidate: infinite), and between each rank's score and the
                 reference's score at that rank;
  nms_mismatch   queries whose NMS'd rows differ from the reference's NMS of
                 the program's own plain rows, the sample in every pass and
                 every query in the last (exact);
  metric_gap     the largest difference between a metric of the last pass's
                 and the reference's numpy metrics of the same submission,
                 plain and NMS'd (exact).
"""

from __future__ import annotations

import json
from typing import Dict, List

import numpy as np
import torch

from vtgbench.reference import host
from vtgbench.reference.metrics import eval_submission
from vtgbench.reference.forms import Form
from vtgbench.reference.model import Ref, decode, strict_point_mask

BATCH = 16
SAMPLE = 256


def candidates(config: dict, weights, rows, vdir, tdir, device, dtype=torch.float32,
               form="exact") -> Dict[str, tuple]:
    """{qid: (windows (N, 2) rounded to the clip length, scores (N,))} over
    each query's valid points."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    P = {k: w.detach().to(dev, dtype) for k, w in weights.items()}
    ref = Ref(config, P, Form(form))
    lv, lq, clip = config["max_v_l"], config["max_q_l"], float(config["clip_length"])
    out = {}
    with torch.no_grad():
        for s in range(0, len(rows), BATCH):
            part = rows[s:s + BATCH]
            vids = [host.video_features(f"{vdir}/{r['vid']}.npz", lv) for r in part]
            txts = [host.text_features(f"{tdir}/qid{r['qid']}.npz", lq) for r in part]
            src_vid, vmask = host.pad(vids, lv)
            src_txt, tmask = host.pad(txts, lq)
            pv, _ = strict_point_mask([len(v) for v in vids], lv, config["strides"])
            t = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)
            o = ref.forward(t(src_txt), t(tmask), t(src_vid), t(vmask), train=False,
                            point_valid=t(pv))
            st, ed, sc = decode(o["out_class"], o["out_coord"], o["point"], clip,
                                point_valid=t(pv))
            st, ed, sc = (x.cpu().numpy() for x in (st, ed, sc))
            for i, r in enumerate(part):
                keep = pv[i] > 0
                dur = r["duration"]
                win = np.stack([st[i][keep], ed[i][keep]], axis=1).clip(0, dur)
                out[r["qid"]] = (host.round_windows(win, clip), sc[i][keep])
    return out


def rows_of(submission):
    """[(qid, rows (N, 3))] of a submission."""
    return [(e["qid"], np.asarray(e["pred_relevant_windows"], np.float64)) for e in submission]


def sample_rows(rows, seed: int):
    """The seed's sample of SAMPLE rows of the split, in split order."""
    pick = np.random.default_rng(seed).permutation(len(rows))[:SAMPLE]
    return [rows[i] for i in sorted(pick)]


def score_gap(rows_by_qid, cands, clip: float) -> float:
    worst = 0.0
    for qid, rows in rows_by_qid:
        if qid not in cands:
            continue
        win, sc = cands[qid]
        ranked = np.sort(sc)[::-1][:len(rows)]
        worst = max(worst, float(np.abs(rows[:, 2] - ranked).max()))
        for st, ed, s in rows:
            near = (np.abs(win[:, 0] - st) <= clip + 1e-6) & (np.abs(win[:, 1] - ed) <= clip + 1e-6)
            gap = float(np.abs(sc[near] - s).min()) if near.any() else float("inf")
            worst = max(worst, gap)
    return worst


def nms_mismatch(plain_rows, nms_rows, thd: float) -> int:
    bad = 0
    for (qid, plain), (qid_nms, nms) in zip(plain_rows, nms_rows):
        rows = plain.astype(np.float32)
        new = host.nms_scores(rows[:, :2], rows[:, 2], thd)
        order = np.argsort(-new, kind="stable")
        want = np.concatenate([rows[order, :2], new[order, None]], axis=1)
        got = nms.astype(np.float32)
        bad += int(qid != qid_nms or got.shape != want.shape or not np.array_equal(got, want))
    return bad + abs(len(plain_rows) - len(nms_rows))


def _leaves(d, prefix=""):
    for k, v in d.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", float(v)


def metric_gap(program: dict, reference: dict) -> float:
    a, b = dict(_leaves(program)), dict(_leaves(reference))
    if a.keys() != b.keys():
        return float("inf")
    return max(abs(a[k] - b[k]) for k in a)


def passes_gaps(driver, cands) -> Dict[str, float]:
    with open(driver.path) as f:
        gt = [json.loads(line) for line in f]
    clip = float(driver.config["clip_length"])
    thd = driver.cfg.nms_thd
    values = {"score_gap": 0.0, "nms_mismatch": 0}
    for plain, nms, _, _ in driver.outputs:
        values["score_gap"] = max(values["score_gap"], score_gap(plain, cands, clip))
        values["nms_mismatch"] = max(values["nms_mismatch"], nms_mismatch(plain, nms, thd))
    sub, sub_nms, m, m_nms = driver.last
    values["nms_mismatch"] = max(values["nms_mismatch"],
                                 nms_mismatch(rows_of(sub), rows_of(sub_nms), thd))
    values["metric_gap"] = max(metric_gap(m, eval_submission(sub, gt)),
                               metric_gap(m_nms, eval_submission(sub_nms, gt)))
    return values


def reference_candidates(driver, form="exact", dtype=torch.float32):
    """The reference's candidates of the seed's sample of queries."""
    with open(driver.path) as f:
        rows = [json.loads(line) for line in f]
    return candidates(driver.config, driver.weights, sample_rows(rows, driver.seed),
                      driver.vdir, driver.tdir, driver.device, dtype, form)


def compare(driver) -> List[tuple]:
    values = passes_gaps(driver, reference_candidates(driver))
    limits = driver.cell.limits()
    return [(k, v, limits.get(k)) for k, v in values.items()]
