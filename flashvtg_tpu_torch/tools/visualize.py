"""Offline visualization of predictions vs ground truth, on the port.

Counterpart of flashvtg_tpu/tools/visualize.py (the reference's tools/
scripts, visualize.py and visualize_keyword.py, as a small CLI over the
framework's own artifacts): a prediction jsonl and the GT jsonl are enough
to plot per-query saliency curves and ranked moment timelines, and with a
checkpoint the model's own attention maps are exported and plotted.
`export_attention_maps` loads a port `.ckpt` (a reference-format one: the
port's model_best / model_latest, a JAX `cli export`, a reference
trainer's) and the opt.json beside it and runs the eval forward on the
card (device "cuda", the default), so the ACA layers run through the ACA
kernel (ops/aca.py); device "cpu" runs the kernels' plain versions. The
plots are the JAX tool's, figure for figure.

Usage:
  python -m flashvtg_tpu_torch.tools.visualize --preds preds.jsonl \
      --gt data/highlight_val_release.jsonl --qid 2579 --out fig.png
  python -m flashvtg_tpu_torch.tools.visualize --gt val.jsonl --qid 2579 \
      --out fig.png --attention --ckpt results/run/model_best.ckpt
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from flashvtg_tpu_torch.utils.io import load_jsonl


def plot_query(pred_row, gt_row, out_path, clip_length: float = 2.0,
               max_windows: int = 10, other_row=None,
               labels=("pred", "other")):
    """Saliency curves + moment timelines for one query. With `other_row`
    (a second submission's row for the same qid) the figure becomes a
    side-by-side model comparison — the re-design of the reference's
    tools/visualize_qd.py, which contrasts FlashVTG with QD-DETR
    predictions from hard-coded author paths."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    duration = gt_row.get("duration", 150)
    fig, axes = plt.subplots(
        2, 1, figsize=(12, 5), sharex=True,
        gridspec_kw={"height_ratios": [2, 1]},
    )

    # saliency curves
    ax = axes[0]
    sal = pred_row.get("pred_saliency_scores")
    if sal:
        t = np.arange(len(sal)) * clip_length
        ax.plot(t, sal, label=f"{labels[0]} saliency", lw=1.5)
    other_sal = (other_row or {}).get("pred_saliency_scores")
    if other_sal:
        t = np.arange(len(other_sal)) * clip_length
        ax.plot(t, other_sal, label=f"{labels[1]} saliency", lw=1.5,
                color="tab:red", alpha=0.8)
    if gt_row.get("relevant_clip_ids") and gt_row.get("saliency_scores"):
        n_clips = int(duration / clip_length)
        gt_sal = np.zeros(n_clips)
        ids = np.asarray(gt_row["relevant_clip_ids"])
        gt_sal[ids] = np.asarray(gt_row["saliency_scores"]).mean(1)
        ax2 = ax.twinx()
        ax2.plot(
            np.arange(n_clips) * clip_length, gt_sal,
            color="tab:orange", alpha=0.6, label="GT saliency",
        )
        ax2.set_ylabel("GT saliency")
    ax.set_ylabel("pred saliency")
    ax.set_title(f"qid {pred_row['qid']}: {pred_row.get('query', '')[:90]}")
    ax.legend(loc="upper right")

    # moment timelines: GT on top, each submission in its own band
    ax = axes[1]
    for w in gt_row.get("relevant_windows") or []:
        ax.axvspan(w[0], w[1], ymin=0.70, ymax=0.95, color="tab:green",
                   alpha=0.4)
    bands = [(pred_row, "tab:blue", (0.37, 0.62))]
    ticks, names = [0.82], ["GT"]
    if other_row is not None:
        bands.append((other_row, "tab:red", (0.05, 0.30)))
        ticks += [0.50, 0.18]
        names += list(labels)
    else:
        ticks += [0.50]
        names += [labels[0]]
    for row, color, (lo, hi) in bands:
        for st, ed, score in row.get("pred_relevant_windows", [])[:max_windows]:
            ax.axvspan(st, ed, ymin=lo, ymax=hi, color=color,
                       alpha=max(0.15, min(1.0, float(score))))
    ax.set_yticks(ticks)
    ax.set_yticklabels(names)
    ax.set_xlabel("time (s)")
    ax.set_xlim(0, duration)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def plot_attention(attn: np.ndarray, out_path, query_tokens=None):
    """Text->video attention heatmap (attn: (Lv, Lq))."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(10, 4))
    im = ax.imshow(np.asarray(attn).T, aspect="auto", cmap="viridis")
    ax.set_xlabel("video clip")
    ax.set_ylabel("text token")
    if query_tokens:
        ax.set_yticks(range(len(query_tokens)))
        ax.set_yticklabels(query_tokens, fontsize=7)
    fig.colorbar(im, ax=ax, fraction=0.025)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def export_attention_maps(ckpt: str, gt_path: str, qid, device=None):
    """Run the checkpointed model on one query and return its attention
    exports (replaces the reference's tools/visualize_keyword.py, which
    hard-codes author paths + external models: here the model's own
    `attn_weights` / `gate` / `word_video_attn` / `slot_att` outputs are
    used; reference map source: transformer.py:197-206 attention averaging).
    The checkpoint is a reference-format `.ckpt` with its opt.json beside
    it; the eval forward runs on `device` (None: the card) at the config's
    eval_precision, its outputs in float32.

    Returns (maps dict of np arrays, meta row, valid video length).
    """
    import torch

    from flashvtg_tpu_torch.data.collate import Collator
    from flashvtg_tpu_torch.data.dataset import VTGDataset
    from flashvtg_tpu_torch.models import build_model
    from flashvtg_tpu_torch.train.config import ExperimentConfig
    from flashvtg_tpu_torch.train.infer import eval_data_config
    from flashvtg_tpu_torch.train.loop import load_checkpoint, load_model_weights
    from flashvtg_tpu_torch.utils.convert import model_state
    from flashvtg_tpu_torch.utils.runtime import (
        float32_outputs,
        matmul_precision,
        resolve_device,
    )

    device = resolve_device(device)
    cfg = ExperimentConfig.load(os.path.join(os.path.dirname(ckpt) or ".", "opt.json"))
    model = build_model(cfg.model_config(), device, cfg.seed)
    load_model_weights(model, model_state(load_checkpoint(ckpt, device)))

    dataset = VTGDataset(eval_data_config(cfg, gt_path, load_labels=False))
    idx = next(
        (i for i, r in enumerate(dataset.data) if str(r["qid"]) == str(qid)),
        None,
    )
    if idx is None:
        raise SystemExit(f"qid {qid} not found in {gt_path}")
    collator = Collator(
        max_q_l=cfg.max_q_l, v_buckets=cfg.v_buckets, dset_name=cfg.dset_name,
        fixed_v_len=cfg.max_v_l if cfg.max_v_l > 0 else None,
    )
    batch = collator([dataset[idx]])
    inputs = [torch.from_numpy(np.asarray(batch[k], np.float32)).to(device)
              for k in ("src_txt", "src_txt_mask", "src_vid", "src_vid_mask")]
    with torch.no_grad(), matmul_precision(cfg.eval_precision, device):
        out = model(*inputs)
    out = {k: v.cpu().numpy() for k, v in float32_outputs(out).items()
           if isinstance(v, torch.Tensor)}
    lv = int(batch["valid_v_lens"][0])
    lq = int(batch["src_txt_mask"][0].sum())
    nd = cfg.num_dummies
    maps = {
        # per-token ACA attention over real text tokens: (Lv, Lq)
        "token_attention": np.asarray(out["attn_weights"])[0, :lv, nd : nd + lq],
        "t2vattnvalues": np.asarray(out["t2vattnvalues"])[0, :lv],
        "saliency": np.asarray(out["saliency_scores"])[0, :lv],
    }
    lw = max(lq - 1, 1)  # _ms word stream = text tokens minus the EOS slot
    ms_slices = {
        "gate": (np.s_[0, :lw]),  # (Lw,) word entropy gate
        "slot_att": (np.s_[0, :, :lw]),  # (N, Lw) phrase-slot word attention
        "word_video_attn": (np.s_[0, :lw, :lv]),  # (Lw, Lv)
        "context_emb": (np.s_[0, :, :lv]),  # (N, Lv, C) Hadamard maps
        "context_refine": (np.s_[0, :, :lv]),  # (N, Lv, C) post-SA maps
        "context_agg": (np.s_[0, :lv]),  # (Lv, C) dynamic-conv aggregate
        "vid_emb": (np.s_[0, :lv]),  # (Lv, C) transformer video embedding
    }
    for k, sl in ms_slices.items():  # _ms-only exports
        if k in out:
            maps[k] = np.asarray(out[k])[sl]
    return maps, dataset.data[idx], lv


def plot_attention_bundle(maps, meta, out_path, clip_length: float):
    """One figure: token->video heatmap + attention/saliency curves
    (+ _ms phrase maps when present)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    extra = [k for k in ("word_video_attn", "slot_att") if k in maps]
    n_rows = 2 + len(extra)
    fig, axes = plt.subplots(
        n_rows, 1, figsize=(12, 3 * n_rows), sharex=False
    )
    axes = np.atleast_1d(axes)

    ax = axes[0]
    im = ax.imshow(maps["token_attention"].T, aspect="auto", cmap="viridis")
    ax.set_title(
        f"qid {meta['qid']} ACA text-token attention: "
        f"{meta.get('query', '')[:80]}"
    )
    ax.set_ylabel("text token")
    fig.colorbar(im, ax=ax, fraction=0.025)

    ax = axes[1]
    t = np.arange(len(maps["t2vattnvalues"])) * clip_length
    ax.plot(t, maps["t2vattnvalues"], label="t2v attention value", lw=1.5)
    ax.plot(t, maps["saliency"], label="saliency", lw=1.5, alpha=0.8)
    ax.legend(loc="upper right")
    ax.set_xlabel("time (s)")

    for ax, k in zip(axes[2:], extra):
        m = maps[k]
        im = ax.imshow(
            m if m.ndim == 2 else m[None], aspect="auto", cmap="magma"
        )
        ax.set_title(k)
        fig.colorbar(im, ax=ax, fraction=0.025)

    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def plot_phrase_bundle(maps, meta, out_path, clip_length: float):
    """Phrase-pipeline figure for the _ms variant (replaces the reference's
    tools/visualize_phrase.py + vis_utils.visualize_phrase_and_context
    without their hard-coded author paths / LLaMA tokenizer): phrase-slot
    word attention, the entropy word gate, per-phrase context activation
    before and after the temporal self-attention, and the aggregated
    context vs the transformer video embedding with GT windows."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(5, 1, figsize=(12, 14))

    ax = axes[0]
    im = ax.imshow(maps["slot_att"], aspect="auto", cmap="viridis")
    ax.set_title(
        f"qid {meta['qid']} phrase-slot word attention: "
        f"{meta.get('query', '')[:80]}"
    )
    ax.set_ylabel("phrase")
    ax.set_xlabel("word token")
    fig.colorbar(im, ax=ax, fraction=0.025)

    ax = axes[1]
    ax.bar(np.arange(len(maps["gate"])), maps["gate"], color="tab:blue")
    ax.set_title("entropy word gate (1 - normalized word->video entropy)")
    ax.set_xlabel("word token")
    ax.set_ylim(0, 1)

    # per-phrase context activation over time: mean |channel| per clip
    t = np.arange(maps["context_emb"].shape[1]) * clip_length
    for ax, key, title in (
        (axes[2], "context_emb", "per-phrase context activation (Hadamard maps)"),
        (axes[3], "context_refine", "per-phrase context activation (refined)"),
    ):
        act = np.abs(maps[key]).mean(-1)  # (N, Lv)
        im = ax.imshow(
            act, aspect="auto", cmap="magma",
            extent=[t[0], t[-1] + clip_length, act.shape[0] - 0.5, -0.5],
        )
        ax.set_title(title)
        ax.set_ylabel("phrase")
        fig.colorbar(im, ax=ax, fraction=0.025)

    ax = axes[4]
    ax.plot(t, np.abs(maps["context_agg"]).mean(-1), label="context_agg", lw=1.5)
    ax.plot(t, np.abs(maps["vid_emb"]).mean(-1), label="vid_emb", lw=1.5)
    for w in meta.get("relevant_windows") or []:
        ax.axvspan(w[0], w[1], color="tab:green", alpha=0.25)
    ax.legend(loc="upper right")
    ax.set_xlabel("time (s)")
    ax.set_title("aggregated context vs video embedding (GT windows shaded)")

    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--preds")
    parser.add_argument("--gt", required=True)
    parser.add_argument("--qid", required=True)
    parser.add_argument("--out", required=True)
    parser.add_argument("--clip_length", type=float, default=2.0)
    parser.add_argument(
        "--attention", action="store_true",
        help="also render the model's attention maps (needs --ckpt)",
    )
    parser.add_argument(
        "--phrase", action="store_true",
        help="render the _ms phrase-pipeline maps (needs an _ms --ckpt)",
    )
    parser.add_argument("--ckpt", help="reference-format .ckpt, opt.json beside it")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu (the kernels' plain versions)")
    parser.add_argument(
        "--compare",
        help="second submission jsonl to overlay (model-vs-model figure, "
        "replaces tools/visualize_qd.py)",
    )
    parser.add_argument(
        "--labels", nargs=2, default=("pred", "other"),
        metavar=("NAME1", "NAME2"), help="legend names for --compare",
    )
    args = parser.parse_args(argv)

    qid = str(args.qid)
    if args.compare and not args.preds:
        parser.error("--compare requires --preds")
    if args.preds:
        preds = {str(r["qid"]): r for r in load_jsonl(args.preds)}
        gts = {str(r["qid"]): r for r in load_jsonl(args.gt)}
        if qid not in preds:
            raise SystemExit(f"qid {qid} not in predictions")
        other = None
        if args.compare:
            others = {str(r["qid"]): r for r in load_jsonl(args.compare)}
            if qid not in others:
                raise SystemExit(f"qid {qid} not in --compare predictions")
            other = others[qid]
        plot_query(preds[qid], gts.get(qid, {}), args.out, args.clip_length,
                   other_row=other, labels=tuple(args.labels))
        print(args.out)

    if args.attention or args.phrase:
        if not args.ckpt:
            raise SystemExit("--attention/--phrase require --ckpt")
        maps, meta, _ = export_attention_maps(args.ckpt, args.gt, qid, args.device)
        root, ext = os.path.splitext(args.out)
        if args.attention:
            attn_out = f"{root}_attn{ext or '.png'}"
            plot_attention_bundle(maps, meta, attn_out, args.clip_length)
            print(attn_out)
        if args.phrase:
            if "context_emb" not in maps:
                raise SystemExit(
                    "--phrase needs an _ms checkpoint (no phrase exports found)"
                )
            phrase_out = f"{root}_phrase{ext or '.png'}"
            plot_phrase_bundle(maps, meta, phrase_out, args.clip_length)
            print(phrase_out)


if __name__ == "__main__":
    main()
