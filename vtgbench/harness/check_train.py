"""The output check of a training cell: the reference follows the program's
first three steps from the same weights, inputs and random draws.

The reference (reference/: the model, attention, criterion and AdamW in
plain PyTorch, float32 with TF32 off) reads the split's raw files itself
(or takes the rows of the feed the harness made), draws the per-access
labels again from the seed, and replays the step's random draws from the
generators' states before step 1. The numbers, each by its
worst case or a steady stand-in where the look at the worst case found its
cause in the number itself (PERF.md gives both readings):
  loss_gap    |loss - ref| / |ref| of the first step's total loss (the later
              steps' part by AdamW moving each weight by about lr whatever
              the sign of a gradient within rounding of 0, in float32 too);
  grad_gap    the median over leaves of | |g| - |g_ref| | / max(|g_ref|,
              median leaf's |g_ref|), g the first step's clipped gradient as
              AdamW holds it after one step (exp_avg / (1 - beta1)); the
              median, because the worst leaf is a PReLU slope, one number
              summing tens of millions of cancelling products, which bf16's
              rounding alone moves by 3-16 %;
  grad_dist   the median over leaves of |g - g_ref| / max(|g_ref|, median
              leaf's |g_ref|): the rounding itself, which a gap of norms
              mostly cancels (the fp8 control reads 2-3x bf16 by the gap of
              norms);
  change_gap  over leaves, the gap of the norms of the parameters' change
              after the three steps, worst leaf, over the leaves whose
              reference gradient is at least 1e-3 of the median leaf's (the
              others move by round-off alone).
A cell compares the numbers its limits file names; the others are printed
as readings.
Leaves are the model's: a packed q / k / v projection counts as three.
`follow` also runs the reference at a lower precision or with a planted
fault, for the controls (vtgbench/controls.py).
"""

from __future__ import annotations

import json
import random
import sys
from typing import Dict, List

import numpy as np
import torch

from vtgbench.reference import host
from vtgbench.reference.criterion import LossConfig, criterion
from vtgbench.reference.forms import Form
from vtgbench.reference.model import Draws, Ref
from vtgbench.reference.optim import AdamW, clip_global

LOSS_KEYS = ("label_loss_coef", "lw_saliency", "lw_reg", "lw_cls", "lw_sal", "lw_wattn",
             "saliency_margin", "sample_radius", "loss_cls", "loss_reg", "loss_sal",
             "nce_direction", "clip_length")


def loss_config(config: dict, dset_name: str) -> LossConfig:
    kw = {k: config[k] for k in LOSS_KEYS}
    kw["nce_direction"] = tuple(kw["nce_direction"])
    return LossConfig(**kw, dset_name=dset_name)


def file_batches(path: str, vdir: str, tdir: str, rows: np.ndarray, config: dict, seed: int,
                 bsz: int, dtype) -> List[Dict[str, torch.Tensor]]:
    """The batches of `rows` (in steps of bsz), made from the raw files, the
    labels drawn per access from the seed in access order."""
    with open(path) as f:
        meta = [json.loads(line) for line in f]
    rng = random.Random(seed)
    lv, lq, mw = config["max_v_l"], config["max_q_l"], config["max_windows"]
    out = []
    for s in range(0, len(rows), bsz):
        vids, txts, sal, pos, neg, win, names = [], [], [], [], [], [], []
        for j in rows[s:s + bsz]:
            m = meta[int(j)]
            v = host.video_features(f"{vdir}/{m['vid']}.npz", lv)
            vids.append(v)
            txts.append(host.text_features(f"{tdir}/qid{m['qid']}.npz", lq))
            w = host.span_windows(m["relevant_windows"], mw, rng)
            p, n, sc = host.saliency_sub_as_query(m["relevant_windows"][0], m["duration"],
                                                  len(v), rng)
            win.append(w)
            pos.append(p)
            neg.append(n)
            sal.append(sc)
            names.append(m["vid"])
        src_vid, vid_mask = host.pad(vids, lv)
        src_txt, txt_mask = host.pad(txts, lq)
        gt = np.full((len(win), mw, 2), np.inf, np.float32)
        for i, w in enumerate(win):
            gt[i, :len(w)] = w[:mw]
        batch = dict(src_vid=src_vid, src_vid_mask=vid_mask, src_txt=src_txt,
                     src_txt_mask=txt_mask, saliency_all_labels=host.pad(sal, lv)[0],
                     saliency_pos_labels=np.asarray(pos), saliency_neg_labels=np.asarray(neg),
                     gt_windows=gt, real_neg_mask=host.rolled_neg_mask(names))
        out.append(batch)
    return [to_tensors(b, dtype) for b in out]


def to_tensors(batch, dtype):
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(np.asarray(v))
        out[k] = t.to(dtype if t.is_floating_point() else torch.int64)
    return out


def follow(cfg: dict, weights, batches, rng_state, gen_state, device, dial: str, loss_cfg,
           lr: float, wd: float, grad_clip: float, form: str = "exact", fault: str = None):
    """(losses of each step, the first step's clipped gradients, the
    parameters after the steps) of the reference from `weights`. `form`
    rounds every product's operands; `fault` plants "half_batch" (the
    loss of the first half of each batch alone)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.set_rng_state(rng_state, dev)
    else:
        torch.set_rng_state(rng_state)
    gen = torch.Generator(device=dev)
    gen.set_state(gen_state)
    draws = Draws(dev, gen, dial)
    P = {k: w.detach().clone().float() for k, w in weights.items()}
    opt = AdamW(P, lr, wd)
    losses, first = [], None
    for batch in batches:
        b = {k: v.to(dev) for k, v in batch.items()}
        leaves = {k: p.requires_grad_() for k, p in P.items()}
        out = Ref(cfg, leaves, Form(form)).forward(b["src_txt"], b["src_txt_mask"], b["src_vid"],
                                            b["src_vid_mask"], train=True, draws=draws,
                                            real_neg_mask=b["real_neg_mask"])
        if fault == "half_batch":
            h = b["src_vid"].shape[0] // 2
            out = {k: (v[:h] if torch.is_tensor(v) and v.dim() and v.shape[0] == 2 * h
                       and k != "point" else v) for k, v in out.items()}
            out["pymid_msk"] = tuple(m[:h] for m in out["pymid_msk"])
            b = {k: v[:h] for k, v in b.items()}
        total = criterion(loss_cfg, out, b)["weighted_loss_overall"]
        grads = torch.autograd.grad(total, list(leaves.values()), allow_unused=True)
        grads = {k: (g if g is not None else torch.zeros_like(leaves[k])).detach()
                 for k, g in zip(leaves, grads)}
        grads = clip_global(grads, grad_clip)
        losses.append(float(total.detach()))
        if first is None:
            first = grads
        P = opt.step({k: p.detach() for k, p in leaves.items()}, grads)
        del out, total
    return losses, first, P


def logical_leaves(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The leaves as the model's math has them: a packed q / k / v
    projection (in_proj_weight, in_proj_bias) as its three parts, whose
    gradients differ in kind (the key bias's is nought under softmax)."""
    out = {}
    for k, t in tensors.items():
        if k.rsplit(".", 1)[-1].startswith("in_proj") and t.shape[0] % 3 == 0:
            for name, part in zip("qkv", t.chunk(3)):
                out[f"{k}[{name}]"] = part
        else:
            out[k] = t
    return out


def gaps(program: dict, ref_losses, ref_grads, ref_after, weights, diagnostics=None):
    """The numbers of the module's doc; `diagnostics` (a dict) receives the
    readings they stand in for (each step's loss gap, the worst leaf's
    gradient gap and its leaf) and the leaves the change leaves out."""
    norm = lambda t: float(torch.linalg.vector_norm(t.float()))
    steps = [abs(a - b) / abs(b) for a, b in zip(program["losses"], ref_losses)]
    g_ref, g_prog = logical_leaves(ref_grads), logical_leaves(program["grads"])
    gn = {k: norm(g) for k, g in g_ref.items()}
    med_g = float(np.median(list(gn.values())))
    by_leaf = {k: abs(norm(g_prog[k]) - gn[k]) / max(gn[k], med_g) for k in gn}
    dist = {k: norm(g_prog[k].float() - g_ref[k].float()) / max(gn[k], med_g) for k in gn}
    kept = [k for k in gn if gn[k] >= 1e-3 * med_g]
    w0 = logical_leaves(weights)
    ref_d = {k: v - w0[k] for k, v in logical_leaves(ref_after).items()}
    prog_d = {k: v - w0[k] for k, v in logical_leaves(program["after"]).items()}
    dn = {k: norm(ref_d[k]) for k in kept}
    med_d = float(np.median(list(dn.values())))
    change = {k: abs(norm(prog_d[k]) - dn[k]) / max(dn[k], med_d) for k in kept}
    if diagnostics is not None:
        worst = max(by_leaf, key=by_leaf.get)
        diagnostics.update(loss_steps=steps, grad_worst=by_leaf[worst], grad_worst_leaf=worst,
                           change_worst_leaf=max(change, key=change.get),
                           excluded=sorted(set(gn) - set(kept)))
    return {"loss_gap": steps[0], "grad_gap": float(np.median(list(by_leaf.values()))),
            "grad_dist": float(np.median(list(dist.values()))),
            "change_gap": max(change.values())}


def reference_inputs(driver):
    """The batches of the checked steps, made by the reference's side."""
    ch, tr, cfg = driver.checked, driver.traffic, driver.config
    bsz = driver.cfg.bsz
    if tr["data"] == "files":
        c = driver.cfg
        return file_batches(c.train_path, c.v_feat_dirs[0], c.t_feat_dir, ch["order"], cfg,
                            driver.seed, bsz, torch.float32)
    out = []
    for s in range(0, len(ch["order"]), bsz):
        rows = ch["order"][s:s + bsz]
        b = {k: ch["features"][k][s:s + bsz].float().cpu() for k in ch["features"]}
        b.update({k: torch.as_tensor(v[rows]) for k, v in driver.labels.items()})
        b["real_neg_mask"] = torch.ones(bsz)
        out.append(b)
    return out


def program_side(driver) -> dict:
    ch = driver.checked
    keys = list(driver.keys)
    total = keys.index("weighted_loss_overall")
    return {"losses": [float(x) for x in ch["losses"][:, total]], "grads": ch["grads"],
            "after": ch["after"]}


def run_reference(driver, form="exact", fault=None):
    c = driver.cfg
    loss_cfg = loss_config(driver.config, c.dset_name)
    return follow(driver.config, driver.weights, reference_inputs(driver),
                  driver.checked["rng_state"], driver.checked["gen_state"], driver.device,
                  c.train_precision, loss_cfg, c.lr, c.wd, c.grad_clip, form, fault)


def compare(driver) -> List[tuple]:
    """[(name, value, limit)] of the numbers the cell compares; the others
    are printed as readings."""
    losses, grads, after = run_reference(driver)
    values = gaps(program_side(driver), losses, grads, after, driver.weights)
    limits = driver.cell.limits()
    for k, v in values.items():
        if k not in limits:
            print(f"reading {k} {v:.6g} (not compared)", file=sys.stderr)
    return [(k, v, limits[k]) for k, v in values.items() if k in limits]
