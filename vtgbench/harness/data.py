"""The traffic's inputs: a split of feature files, or a feed made on the card.

Files (`"data": "files"`): a TACoS-format pool of `videos` video files
(clips drawn uniformly in `clips`) and one text file a row (tokens drawn in
`tokens`), with one relevant window a row, written once into
`vtgbench/_cache/` under a name made of its parameters (a fixed path, so
every later run of the checkout reads the same files, warm) from the
pool's own seed: every --seed sees the same set of rows and sizes. A run's
split is that pool in an order drawn from --seed, written as a jsonl under
TMPDIR.

Device (`"data": "device"`): the split's features made on the card in the
layout of the program's device feed (data/feed.py: src_vid with its two
TEF channels, src_vid_mask, src_txt, src_txt_mask, float32), l2-normalised
rows drawn from a generator on the card seeded by --seed; text lengths
drawn in `tokens`; and each row's labels (one relevant span, worker
saliency scores over it, the sampled positive and negative clips) drawn on
the host from --seed.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
from typing import Dict, Tuple

import numpy as np
import torch

from vtgbench.harness.cell import PACKAGE

POOL_SEED = 0


def _pool_key(traffic: dict, config: dict) -> str:
    params = {k: traffic[k] for k in ("rows", "videos", "clips", "tokens")}
    params.update(v_feat_dim=config["v_feat_dim"], t_feat_dim=config["t_feat_dim"],
                  clip_length=config["clip_length"], seed=POOL_SEED)
    digest = hashlib.sha256(json.dumps(params, sort_keys=True).encode()).hexdigest()[:12]
    return f"{traffic['name']}-{digest}"


def pool(traffic: dict, config: dict) -> str:
    """The pool's directory (written at the first call in this checkout):
    rows.json (each row with its text's token count), vid/<vid>.npz,
    txt/qid<qid>.npz."""
    root = os.path.join(PACKAGE, "_cache", _pool_key(traffic, config))
    if os.path.exists(os.path.join(root, "rows.json")):
        return root
    os.makedirs(os.path.dirname(root), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=".pool-", dir=os.path.dirname(root))
    rng = np.random.default_rng(POOL_SEED)
    clip = float(config["clip_length"])
    lo, hi = traffic["clips"]
    os.makedirs(os.path.join(tmp, "vid"))
    os.makedirs(os.path.join(tmp, "txt"))
    clips = [hi] + [int(c) for c in rng.integers(lo, hi + 1, traffic["videos"] - 1)]
    for i, n in enumerate(clips):
        np.savez(os.path.join(tmp, "vid", f"v{i:03d}.npz"),
                 features=rng.standard_normal((n, config["v_feat_dim"]), dtype=np.float32))
    rows = []
    tlo, thi = traffic["tokens"]
    for q in range(traffic["rows"]):
        i = q % traffic["videos"]
        n = clips[i]
        s = int(rng.integers(0, n - 2))
        e = int(rng.integers(s + 1, min(n, s + 64)))
        qid = f"q{q:05d}"
        lq = int(rng.integers(tlo, thi + 1))
        rows.append(dict(qid=qid, query=f"query {q}", vid=f"v{i:03d}", duration=n * clip,
                         relevant_windows=[[s * clip, e * clip]], tokens=lq))
        np.savez(os.path.join(tmp, "txt", f"qid{qid}.npz"),
                 last_hidden_state=rng.standard_normal((lq, config["t_feat_dim"]),
                                                       dtype=np.float32))
    with open(os.path.join(tmp, "rows.json"), "w") as f:
        json.dump(rows, f)
    try:
        os.rename(tmp, root)
    except OSError:  # written meanwhile by another run
        shutil.rmtree(tmp, ignore_errors=True)
    return root


def split(traffic: dict, config: dict, seed: int) -> Tuple[str, str, str]:
    """(jsonl path, video dir, text dir): the pool's rows in an order drawn
    from `seed`, the jsonl under TMPDIR."""
    root = pool(traffic, config)
    with open(os.path.join(root, "rows.json")) as f:
        rows = json.load(f)
    order = np.random.default_rng(seed).permutation(len(rows))
    out_dir = tempfile.mkdtemp(prefix="vtgbench-")
    path = os.path.join(out_dir, "split.jsonl")
    with open(path, "w") as f:
        for i in order:
            f.write(json.dumps(rows[i]) + "\n")
    return path, os.path.join(root, "vid"), os.path.join(root, "txt")


def device_feed(traffic: dict, config: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """{src_vid, src_vid_mask, src_txt, src_txt_mask} of `rows` rows at the
    configuration's max_v_l and max_q_l, made on `device` from `seed`."""
    n, lv, lq = traffic["rows"], config["max_v_l"], config["max_q_l"]
    dv, dt = config["v_feat_dim"], config["t_feat_dim"]
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    vid = torch.empty((n, lv, dv + 2), device=device)
    feats = vid[..., :dv]
    feats.normal_(generator=g)
    feats.div_(torch.linalg.vector_norm(feats, dim=-1, keepdim=True) + 1e-5)
    st = torch.arange(lv, device=device, dtype=torch.float32) / lv
    vid[..., dv] = st
    vid[..., dv + 1] = st + 1.0 / lv
    tlo, thi = traffic["tokens"]
    lens = torch.randint(tlo, thi + 1, (n,), generator=g, device=device)
    txt_mask = (torch.arange(lq, device=device)[None, :] < lens[:, None]).float()
    txt = torch.empty((n, lq, dt), device=device).normal_(generator=g)
    txt.div_(torch.linalg.vector_norm(txt, dim=-1, keepdim=True) + 1e-5)
    txt.mul_(txt_mask[..., None])
    return {"src_vid": vid, "src_vid_mask": torch.ones((n, lv), device=device),
            "src_txt": txt, "src_txt_mask": txt_mask}


def row_labels(traffic: dict, config: dict, seed: int) -> Dict[str, np.ndarray]:
    """Each row's training labels, QVHighlights-style: one relevant span of
    clips, three workers' scores (0-4) over it summed into the saliency
    row, the GT window in seconds, one hard and one easy positive and
    negative clip."""
    rng = np.random.default_rng(seed + 1)
    n, lv = traffic["rows"], config["max_v_l"]
    clip = float(config["clip_length"])
    s = rng.integers(0, lv - 2, n)
    e = np.minimum(s + 1 + rng.integers(0, lv // 2, n), lv)
    clips = np.arange(lv)[None, :]
    inside = (clips >= s[:, None]) & (clips < e[:, None])
    scores = rng.integers(0, 5, (n, lv, 3)).sum(-1) * inside
    sal = scores.astype(np.float32)
    pos = np.stack([s + rng.integers(0, e - s), s + rng.integers(0, e - s)], axis=1)
    out_clip = lambda: np.where(rng.random(n) < s / np.maximum(s + lv - e, 1),
                                rng.integers(0, np.maximum(s, 1)),
                                e + rng.integers(0, np.maximum(lv - e, 1)))
    neg = np.stack([out_clip(), out_clip()], axis=1).clip(0, lv - 1)
    windows = np.full((n, config.get("max_windows", 5), 2), np.inf, np.float32)
    windows[:, 0, 0], windows[:, 0, 1] = s * clip, e * clip
    return {"saliency_all_labels": sal, "saliency_pos_labels": pos.astype(np.int64),
            "saliency_neg_labels": neg.astype(np.int64), "gt_windows": windows}
