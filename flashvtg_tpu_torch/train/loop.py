"""Train step and a minimal training loop.

Counterpart of flashvtg_tpu/train/loop.py (`make_optimizer`,
`make_train_step`, `train`), reference FlashVTG/train.py:
  * AdamW with StepLR (gamma every lr_drop epochs, stepped per train step
    as the JAX schedule is) and global-norm clipping with optax's formula,
    g * min(1, c / |g|) (torch's clip_grad_norm_ divides by |g| + 1e-6);
  * one step = train forward (negative pass included), every loss, the
    weighted total, backward through the attention kernels' autograd
    Functions, clipping, update; it returns the losses in the JAX step's
    key order (`declared_loss_keys`);
  * `train` runs shuffled, drop-last epochs from a seeded generator and one
    eval at the end: train/infer.py:run_hl_inference for the HD sets
    (tvsum, youtube_uni), run_mr_inference for the others.
Not ported yet (ROADMAP): checkpoints, early stop, per-epoch eval, the scan
epoch, the device-resident feed, the data-parallel mesh and the
bf16 / tf32 train precision (the step runs in true f32 on the card).
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional

import numpy as np
import torch

from flashvtg_tpu_torch.data.collate import TRAIN_KEYS, Collator
from flashvtg_tpu_torch.data.dataset import HD_SETS, DataConfig, VTGDataset
from flashvtg_tpu_torch.losses import compute_losses, declared_loss_keys, weighted_total
from flashvtg_tpu_torch.train.infer import (
    eval_data_config,
    run_hl_inference,
    run_mr_inference,
)


def train_data_config(cfg, path: str) -> DataConfig:
    """The train split's DataConfig: labels drawn per access from the
    config's seed, txt_drop_ratio on (the JAX loop's _dataset_cfg with
    train=True)."""
    return DataConfig(
        dset_name=cfg.dset_name,
        data_path=path,
        v_feat_dirs=tuple(cfg.v_feat_dirs),
        q_feat_dir=cfg.t_feat_dir,
        q_feat_type=cfg.q_feat_type,
        max_q_l=cfg.max_q_l,
        max_v_l=cfg.max_v_l,
        data_ratio=cfg.data_ratio,
        ctx_mode=cfg.ctx_mode,
        normalize_v=not cfg.no_norm_vfeat,
        normalize_t=not cfg.no_norm_tfeat,
        dset_domain=cfg.dset_domain,
        load_labels=True,
        clip_len=cfg.clip_length,
        max_windows=cfg.max_windows,
        txt_drop_ratio=cfg.txt_drop_ratio,
        seed=cfg.seed,
    )


def place_batch(batch: Dict, device, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """The train step's tensors of a collated batch on `device`: floating
    arrays in `dtype`, integer labels as int64."""
    out = {}
    for key in TRAIN_KEYS:
        if key in batch:
            t = torch.from_numpy(np.asarray(batch[key]))
            out[key] = t.to(device, dtype if t.is_floating_point() else torch.int64)
    return out


def make_optimizer(cfg, params: Iterable[torch.nn.Parameter], steps_per_epoch: int):
    """(AdamW, StepLR): lr * gamma^floor(step / (lr_drop * steps_per_epoch)),
    at most 49 drops as the JAX schedule's boundaries. AdamW's betas and eps
    are optax's defaults, and its decay is decoupled as optax.adamw's."""
    optimizer = torch.optim.AdamW(params, lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8,
                                  weight_decay=cfg.wd)
    drop = cfg.lr_drop * steps_per_epoch

    def factor(step: int) -> float:
        return cfg.lr_gamma ** min(step // drop, 49) if drop > 0 else 1.0

    return optimizer, torch.optim.lr_scheduler.LambdaLR(optimizer, factor)


def clip_by_global_norm_(params, max_norm: float) -> None:
    """optax.clip_by_global_norm in place: every gradient times
    min(1, max_norm / |g|), |g| the norm over all of them."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    factor = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for g in grads:
        g.mul_(factor)


def make_train_step(model, loss_cfg, optimizer, scheduler, grad_clip: float,
                    generator: Optional[torch.Generator] = None):
    """step(batch) -> {loss key: 0-d tensor}: one update of `model` on a
    placed batch (`place_batch`), losses detached, in `step.loss_keys`
    order. Attention-dropout seeds come from `generator`."""
    keys = declared_loss_keys(loss_cfg)
    params = [p for p in model.parameters() if p.requires_grad]

    def step(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        model.train()
        out = model(
            batch["src_txt"], batch["src_txt_mask"], batch["src_vid"],
            batch["src_vid_mask"], real_neg_mask=batch.get("real_neg_mask"),
            generator=generator,
        )
        losses = compute_losses(out, batch, loss_cfg)
        total = weighted_total(losses, loss_cfg)
        losses["weighted_loss_overall"] = total
        optimizer.zero_grad(set_to_none=True)
        total.backward()
        # optax updates every leaf: a parameter the losses do not reach (the
        # HD sets' coord head and coef, with no loss_reg) still decays
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if grad_clip > 0:
            clip_by_global_norm_(params, grad_clip)
        optimizer.step()
        scheduler.step()
        return {k: losses[k].detach() for k in keys}

    step.loss_keys = keys
    return step


def train(cfg, device=None, max_steps: Optional[int] = None):
    """Train a randomly initialised model (weights from cfg.seed) on
    cfg.train_path, then evaluate it once on cfg.eval_path (if set).

    Epochs shuffle the rows with a generator seeded from cfg.seed and drop
    the last partial batch; the video length is pinned to max_v_l as the
    JAX loop's Collator(fixed_v_len=max_v_l). Stops after cfg.n_epoch epochs
    or `max_steps` steps. Returns (model in eval mode, result) where result
    holds the steps run, the per-step losses, their means and, with an eval
    set, its metrics and, for an MR set, the submission. `device` None
    means the card."""
    from flashvtg_tpu_torch.eval.metrics import eval_submission
    from flashvtg_tpu_torch.models.flashvtg import build_model
    from flashvtg_tpu_torch.utils.runtime import resolve_device

    device = resolve_device(device)
    torch.manual_seed(cfg.seed)  # feature dropout and DropPath draw from it
    train_ds = VTGDataset(train_data_config(cfg, cfg.train_path))
    steps_per_epoch = len(train_ds) // cfg.bsz
    if steps_per_epoch == 0:
        raise ValueError(f"{len(train_ds)} train rows < one batch of {cfg.bsz}")
    model = build_model(cfg.model_config(), device, cfg.seed).train()
    optimizer, scheduler = make_optimizer(cfg, model.parameters(), steps_per_epoch)
    step = make_train_step(model, cfg.loss_config(), optimizer, scheduler, cfg.grad_clip,
                           torch.Generator().manual_seed(cfg.seed))
    collator = Collator(
        cfg.max_q_l, cfg.v_buckets, cfg.max_v_l if cfg.max_v_l > 0 else None,
        max_windows=cfg.max_windows, dset_name=cfg.dset_name,
    )
    shuffler = np.random.default_rng(cfg.seed)
    rows = np.arange(len(train_ds))
    history = []
    for _ in range(cfg.n_epoch):
        shuffler.shuffle(rows)
        for i in range(steps_per_epoch):
            if max_steps is not None and len(history) >= max_steps:
                break
            batch = collator([train_ds[j] for j in rows[i * cfg.bsz : (i + 1) * cfg.bsz]])
            losses = step(place_batch(batch, device))
            values = torch.stack(list(losses.values())).cpu().tolist()
            history.append(dict(zip(losses, values)))
        if max_steps is not None and len(history) >= max_steps:
            break
    model.eval()
    result = {
        "steps": len(history),
        "losses": history,
        "loss_means": {k: float(np.mean([h[k] for h in history])) for k in step.loss_keys},
    }
    if cfg.eval_path:
        eval_ds = VTGDataset(eval_data_config(cfg, cfg.eval_path))
        if cfg.dset_name in HD_SETS:
            result["metrics"] = run_hl_inference(cfg, model, eval_ds)
        else:
            submission, _ = run_mr_inference(cfg, model, eval_ds)
            result["submission"] = submission
            result["metrics"] = eval_submission(submission, eval_ds.data)
    return model, result
