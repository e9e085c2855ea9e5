"""Train step and training loop: AdamW + StepLR, per-epoch eval, best
model, early stop, checkpoints, resume.

Counterpart of flashvtg_tpu/train/loop.py, reference FlashVTG/train.py:
  * AdamW with StepLR (gamma every lr_drop epochs, stepped per train step
    as the JAX schedule is) and global-norm clipping with optax's formula,
    g * min(1, c / |g|) (torch's clip_grad_norm_ divides by |g| + 1e-6);
  * one step = train forward (negative pass included), every loss, the
    weighted total, backward through the attention kernels' autograd
    Functions, clipping, update; it returns the losses in the JAX step's
    key order (`declared_loss_keys`); the FlashVTG_ms variant (cfg.variant
    "ms") trains its own model with its own criterion (losses/criterion_ms.py)
    through the same step and loop;
  * `train`: shuffled epochs from a generator seeded at loop start (the
    short tail batch dropped), an eval every eval_epoch epochs with the eval
    losses (`evaluate`: run_hl_inference for the HD sets, tvsum and
    youtube_uni, run_mr_inference for the others), the best model by
    `stop_metric` (strictly above the best so far, which starts at 0),
    early stop after max_es_cnt evals without a gain, model_latest every
    epoch, --resume / --resume_all / --resume auto / --resume_adapter,
    eval_untrained, the --test_path finals, the reference's train.log.txt /
    eval.log.txt lines and scalars through utils/observability.py.
Checkpoints are reference-format `.ckpt` files (utils/convert.py), the
reference trainer's layout (train.py:200-233): model, state_dict, optimizer,
lr_scheduler, epoch and opt (a plain dict), with a `<name>.state.json`
best-score sidecar and opt.json beside them. The JAX package writes orbax
directories, which the port does not read; its `cli export` `.ckpt` is what
the two packages share, and the JAX `cli infer --resume` /
`--resume_adapter` read the port's files.
The step runs at the config's train_precision (default bfloat16, as the
JAX package's): the forward and the backward inside the dial
(utils/runtime.py:matmul_precision), the criterion, the clip and AdamW in
float32 on float32 weights (no GradScaler: bf16 keeps f32's range).
transfer_dtype bfloat16 narrows the features to bf16 on the host before the
copy to the card and widens them there (`place_batch`; in the streamed
epoch on the card, inside the step).

The device-resident feed (data/feed.py; device_feed "auto" within
device_feed_budget_gb, or "on", with a fixed max_v_l and no txt_drop, the
JAX loop's gate): the train split's features go on the device once, in
transfer_dtype, and a step uploads its labels and row indices alone and
gathers its features there (`make_train_step`'s `feed_vector`). With the
feed the epoch runs in chunks of scan_steps steps (of one step at
scan_steps <= 1 and under debug): a chunk's stacked labels and indices are
collated on a worker thread (`_prefetched`) and uploaded in one pinned
copy. With scan_steps > 1 and not debug, each step on the card is a replay
of one captured CUDA graph of the whole step (train/graph.py), the
counterpart of the JAX loop's lax.scan epoch; on the CPU the same chunks
run eagerly. Every epoch writes its loss vectors into one device tensor,
fetched once at its end. AdamW is capturable (and fused) on the card and
its learning rate a device tensor that `StepLR` sets from a device step
count, so a replay takes the schedule's step.

Without the feed (a split over the budget, such as a TACoS-size one,
bucketed lengths, txt_drop, device_feed off) the epoch streams
(`run_streamed_epoch`), as the JAX loop's `epoch_step` does: the prefetch
thread collates step i + 1's batch and stages it in one pinned buffer, and
its copy to the card is issued on a copy stream while step i runs
(data/feed.py:copy_ahead); at a fixed max_v_l with scan_steps > 1 each
step on the card is one replay of the captured step (train/graph.py:
StreamedSteps), the counterpart of JAX's one jitted dispatch a step; on
the CPU the batch is placed by `place_batch`. `epoch_mode` picks the
epoch's mode: feed or streamed, graph or eager (eager under debug and
debug_nans, as the JAX loop runs no scan there).

debug_nans (utils/observability.py:nan_tripwire) checks every module's
forward output and runs autograd's anomaly mode, for this call of train()
alone; after an epoch whose mean losses are not all finite it names the
non-finite parameters. profile_dir traces the run's first epoch
(utils/observability.py:profile_trace), its spans in spans.jsonl.

Spans and counters (utils/observability.py): each epoch is the root span
`train.epoch`; on the prefetch thread `data.make_batch` (id the step, or
a chunk's first step) holds the batch's collation and staging; on the
main thread `train.batch_wait` (blocked on the prefetch queue),
`train.issue` (the copy ahead, the static-input copy, the replay and the
loss copy; a chunk's upload and steps) and `train.step_wait` (blocked on
the step before). Each step counts one `train.steps`.

Data parallel (parallel/mesh.py; the JAX loop's mesh and multi-host
rows): under a torch.distributed process group (`cli train` under
torchrun) each rank takes bsz / world rows of every GLOBAL batch (a world
that does not divide bsz raises). The epoch's one shuffle comes from
cfg.seed on every rank; global batch i is the host-contiguous
concatenation of the ranks' strided shards (mesh.assembled_order), whose
rows every rank reads in that order (the per-access label draws are one
process's), keeping its own; real_neg_mask is the global batch's
(data/collate.py:global_real_neg_mask); steps_per_epoch and the learning
rate schedule count global batches. Weights come from cfg.seed and are
broadcast from rank 0; dropout (feature dropout, DropPath, the attention
dropout's generator) draws from cfg.seed + rank, so the ranks draw
different masks. The step runs the forward and the criterion inside
mesh.split_batch() (the global batch's negative roll, donor rows and
losses), backpropagates its share of the global loss and sums the
gradients over the ranks before the clip, so every rank holds the global
loss's gradient and takes the same update. Under NCCL the graph modes
capture the step with that all-reduce in it (NCCL supports stream
capture; a replay's sum across cards is unverified: at world 1 NCCL
launches no kernel for it, and no run on several cards has been made);
under gloo, whose collectives cannot be captured, every epoch runs eager
steps (`epoch_mode`). Each rank
holds the whole split's feed. Files, checkpoints and logs are rank 0's,
with a barrier after each save; the evals deal whole batches to the ranks
and gather the rows back (train/infer.py), so every rank reaches the same
metrics and the same best-model and early-stop decisions.
"""

from __future__ import annotations

import contextlib
import dataclasses
import glob
import json
import logging
import os
import time
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from flashvtg_tpu_torch.data.collate import (
    TRAIN_KEYS,
    Collator,
    global_real_neg_mask,
    neg_pair_base,
)
from flashvtg_tpu_torch.data.dataset import HD_SETS, DataConfig, VTGDataset
from flashvtg_tpu_torch.data.feed import (
    FEED_KEYS,
    NARROWED_KEYS,
    PlacedBatch,
    build_device_feed,
    copy_ahead,
    estimate_feed_bytes,
    gather_rows,
    resident_feed_bytes,
    stage_batch,
    upload,
    widen_features,
)
from flashvtg_tpu_torch.losses import criterion, declared_loss_keys
from flashvtg_tpu_torch.parallel import mesh
from flashvtg_tpu_torch.train.infer import (
    eval_data_config,
    run_hl_inference,
    run_mr_inference,
)
from flashvtg_tpu_torch.utils.convert import (
    checkpoint_variant,
    lenient_torch_load,
    load_torch_checkpoint,
    model_state,
    save_torch_checkpoint,
)
from flashvtg_tpu_torch.utils import observability as obs
from flashvtg_tpu_torch.utils.io import AverageMeter, save_json, save_jsonl
from flashvtg_tpu_torch.utils.runtime import (
    TRANSFER_DTYPES,
    check_precision,
    float32_outputs,
    matmul_precision,
)

logger = logging.getLogger(__name__)


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
        eos_first=cfg.eos_first,
        seed=cfg.seed,
    )


def place_batch(batch: Dict, device, dtype=torch.float32,
                transfer_dtype: str = "float32") -> Dict[str, torch.Tensor]:
    """The train step's tensors of a collated batch on `device`: floating
    arrays in `dtype`, integer labels as int64. With transfer_dtype
    "bfloat16" the features (NARROWED_KEYS) cross to the device in bf16,
    rounded on the host to nearest even (the JAX loop's astype(bfloat16)),
    half the bytes, and are widened to `dtype` there."""
    if transfer_dtype not in TRANSFER_DTYPES:
        raise ValueError(f"unknown transfer_dtype {transfer_dtype!r}; expected one of "
                         f"{TRANSFER_DTYPES}")
    out = {}
    for key in TRAIN_KEYS:
        if key in batch:
            t = torch.from_numpy(np.asarray(batch[key]))
            if not t.is_floating_point():
                out[key] = t.to(device, torch.int64)
            elif transfer_dtype == "bfloat16" and key in NARROWED_KEYS:
                out[key] = t.to(torch.bfloat16).to(device).to(dtype)
            else:
                out[key] = t.to(device, dtype)
    return out


def make_optimizer(cfg, params: Iterable[torch.nn.Parameter], steps_per_epoch: int):
    """(AdamW, StepLR): lr * gamma^floor(step / (lr_drop * steps_per_epoch)),
    at most 49 drops as the JAX schedule's boundaries. AdamW's betas and eps
    are optax's defaults, and its decay is decoupled as optax.adamw's. The
    learning rate is a 0-d tensor on the parameters' device (float32 on the
    card, where AdamW is capturable and fused; float64 on the CPU, which
    gives the float's arithmetic), set by the StepLR. Fused: one kernel
    updates every parameter, where the capturable foreach form with a
    tensor rate takes hundreds of per-parameter kernels a step, which an
    eager step pays in host time."""
    params = list(params)
    device = params[0].device
    cuda = device.type == "cuda"
    lr = torch.tensor(cfg.lr, dtype=torch.float32 if cuda else torch.float64).to(device)
    optimizer = torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                  weight_decay=cfg.wd, capturable=cuda, fused=cuda or None)
    return optimizer, StepLR(optimizer, cfg.lr, cfg.lr_gamma, cfg.lr_drop * steps_per_epoch)


class StepLR:
    """The step schedule on the optimizer's tensor learning rate: after n
    steps lr = base_lr * factor(n), factor(n) = gamma^min(n // drop, 49)
    (1 with drop 0). The step count is a device tensor and `step()` is
    device work alone (the count + 1, the rate looked up in a table of the
    50 values), so a captured CUDA graph that holds it advances the
    schedule at every replay, in or out of the graph alike. state_dict /
    load_state_dict speak LambdaLR's format (last_epoch = n), the
    reference-format checkpoints' `lr_scheduler`; load_state_dict also puts
    the tensor rate back in the optimizer's groups, which the optimizer's
    own load_state_dict replaced."""

    def __init__(self, optimizer, base_lr: float, gamma: float, drop: int):
        self.optimizer = optimizer
        self.lr = optimizer.param_groups[0]["lr"]
        self.gamma, self.drop = gamma, drop
        self.count = torch.zeros((), dtype=torch.int64, device=self.lr.device)
        self._set_base(base_lr)
        self.bind()

    def _set_base(self, base_lr: float) -> None:
        self.base_lr = base_lr
        table = torch.tensor([base_lr * self.gamma ** e for e in range(50)], dtype=self.lr.dtype)
        self._table = table.to(self.lr.device)

    def factor(self, step: int) -> float:
        return self.gamma ** min(step // self.drop, 49) if self.drop > 0 else 1.0

    def step(self) -> None:
        self.count.add_(1)
        if self.drop > 0:
            e = torch.div(self.count, self.drop, rounding_mode="floor").clamp_max(49)
            self.lr.copy_(self._table.index_select(0, e.view(1)).view(()))

    def bind(self) -> None:
        """The groups' rate is this tensor, AdamW capturable and fused on the
        card, and its step counts on the parameters' device there (as a
        checkpoint made on the other device left them)."""
        cuda = self.lr.device.type == "cuda"
        for group in self.optimizer.param_groups:
            group["lr"] = self.lr
            group["capturable"] = cuda
            group["fused"] = cuda or None
        for p, state in self.optimizer.state.items():
            if "step" in state:
                step = state["step"]
                state["step"] = (step.to(p.device, torch.float32) if cuda
                                 else step.to("cpu", torch.float32))

    def get_last_lr(self):
        return [self.base_lr * self.factor(int(self.count))]

    def state_dict(self) -> dict:
        n = int(self.count)
        return {"base_lrs": [self.base_lr], "last_epoch": n, "_step_count": n + 1,
                "_get_lr_called_within_step": False,
                "_last_lr": [self.base_lr * self.factor(n)], "lr_lambdas": [None]}

    def load_state_dict(self, state: dict) -> None:
        n = int(state["last_epoch"])
        self._set_base(float(state.get("base_lrs", [self.base_lr])[0]))
        self.count.fill_(n)
        self.lr.fill_(self.base_lr * self.factor(n))
        self.bind()


def clip_by_global_norm_(params, max_norm: float) -> None:
    """optax.clip_by_global_norm in place: every gradient times
    min(1, max_norm / |g|), |g| the norm over all of them."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    factor = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for g in grads:
        g.mul_(factor)


def make_train_step(model, loss_cfg, optimizer, scheduler, grad_clip: float,
                    generator: Optional[torch.Generator] = None,
                    precision: str = "bfloat16"):
    """step(batch) -> {loss key: 0-d tensor}: one update of `model` on a
    placed batch (`place_batch`), losses detached, in `step.loss_keys`
    order; `loss_cfg` is a LossConfig or, for the _ms model, an
    MSLossConfig. Attention-dropout seeds come from `generator` (drawn on
    its device). `precision` is the dial of the forward and the backward
    (the JAX function's default, bfloat16; float32 for parity); the model's
    outputs leave the dial in float32, and the criterion runs outside it,
    in f32.

    The batch's bf16 tensors (the features of the bf16 wire, placed
    unwidened by the streamed epoch on the card) are widened to float32
    first, inside the step.

    `step.vector(batch)` is the same update returning the losses as one
    float32 vector, and `step.feed_vector(labels, idx, feed)` the
    feed-mode update: the features are rows `idx` (int64) of the
    device-resident `feed` (data/feed.py), widened to float32 where the feed
    is bf16 (the streamed bf16 wire's rounding), the labels a placed batch
    without features. Each is device work alone, with no host sync, so a
    CUDA graph can capture it (train/graph.py).

    Under a process group (parallel/mesh.py) the batch is this rank's rows
    of the global batch: the forward and the criterion run inside
    mesh.split_batch() (the global batch's couplings and losses), the
    backward takes this rank's share of the global total (total / world),
    and the gradients are summed over the ranks (one flat all-reduce) after
    the zero-fill and before the clip, optax's order on the global
    gradient; the losses returned are the global batch's, the same on
    every rank."""
    check_precision(precision)
    keys = declared_loss_keys(loss_cfg)
    params = [p for p in model.parameters() if p.requires_grad]
    device = params[0].device
    world = mesh.world()
    split = mesh.split_batch if world > 1 else contextlib.nullcontext

    def update(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        model.train()
        batch = widen_features(batch)
        # no autocast cast cache: a graph capture of the step refuses it,
        # and an eager step must keep the graph's arithmetic (with the cache
        # on for the eager steps alone, eager and graph losses part at
        # bfloat16)
        with split():
            with matmul_precision(precision, device, autocast_cache=False):
                out = model(
                    batch["src_txt"], batch["src_txt_mask"], batch["src_vid"],
                    batch["src_vid_mask"], real_neg_mask=batch.get("real_neg_mask"),
                    generator=generator,
                )
            losses = criterion(loss_cfg, float32_outputs(out), batch)
        total = losses["weighted_loss_overall"]
        optimizer.zero_grad(set_to_none=True)
        # the backward under the dial's TF32 flags (the attention Functions
        # keep their forward's form), autocast off as torch advises: each
        # op's backward takes the dtypes its forward saved
        with matmul_precision(precision, device, autocast_cache=False), \
                torch.autocast(device.type, enabled=False):
            (total / world if world > 1 else total).backward()
        # optax updates every leaf: a parameter the losses do not reach (the
        # HD sets' coord head and coef, with no loss_reg) still decays
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        mesh.all_reduce_grads_(params)
        if grad_clip > 0:
            clip_by_global_norm_(params, grad_clip)
        optimizer.step()
        scheduler.step()
        return {k: losses[k].detach() for k in keys}

    def vector(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        losses = update(batch)
        return torch.stack([losses[k] for k in keys]).float()

    def feed_vector(labels: Dict[str, torch.Tensor], idx: torch.Tensor,
                    feed: Dict[str, torch.Tensor]) -> torch.Tensor:
        return vector({**labels, **gather_rows(feed, idx)})

    update.loss_keys = keys
    update.vector = vector
    update.feed_vector = feed_vector
    update.optimizer = optimizer
    update.generator = generator
    return update


def label_arrays(batch: Dict) -> Dict[str, np.ndarray]:
    """The train step's tensors of a collated batch other than the
    features, as host arrays in their placed dtypes (float32, int64)."""
    out = {}
    for key in TRAIN_KEYS:
        if key in batch and key not in FEED_KEYS:
            v = np.asarray(batch[key])
            out[key] = v.astype(np.float32 if v.dtype.kind == "f" else np.int64, copy=False)
    return out


def _prefetched(fn, n: int, depth: int = 2):
    """(i, fn(i)) for i in range(n), fn run by one worker thread up to
    `depth` items ahead of the consumer: one worker in order keeps any RNG
    stream inside fn (the dataset's label draws) the inline loop's; an
    exception in fn re-raises at the consumer. Stopping early stops the
    worker after the item it is making."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def worker():
        for i in range(n):
            if stop.is_set():
                return
            try:
                item = (i, fn(i), None)
            except BaseException as e:  # raised again in the consumer
                q.put((i, None, e))
                return
            q.put(item)
        q.put((None, None, None))

    thread = threading.Thread(target=worker, daemon=True, name="batch-prefetch")
    thread.start()
    try:
        while True:
            i, item, err = q.get()
            if err is not None:
                raise err
            if i is None:
                return
            yield i, item
    finally:
        stop.set()
        while thread.is_alive():  # unblock a worker parked on a full queue
            try:
                q.get(timeout=0.05)
            except queue.Empty:
                pass
        thread.join()


def stop_metric(cfg, brief: Dict[str, float]) -> float:
    """Model-selection metric per dataset (reference train.py:186-194): mAP
    for the HD sets, MR-full-mAP for the literal 'hl', MR-full-R1@0.3 for
    tacos, else the mean of MR-full-R1@0.7 and @0.5."""
    if cfg.dset_name in HD_SETS:
        return brief["mAP"]
    if cfg.dset_name == "hl":
        return brief["MR-full-mAP"]
    if cfg.dset_name == "tacos":
        return brief["MR-full-R1@0.3"]
    return (brief["MR-full-R1@0.7"] + brief["MR-full-R1@0.5"]) / 2


def evaluate(cfg, model, eval_dataset, results_dir, tag="latest", loss_cfg=None,
             compute_metrics=None, split_name=None):
    """One eval pass of `model` (put in eval mode); returns (metrics,
    metrics_nms, eval_losses). MR sets write `{tag}_{dset}_{split}_preds.jsonl`,
    its `_nms_thd_{t}` pair when NMS ran, and, with compute_metrics (default:
    the split is "val"), the `_metrics.json` of each; HD sets score mAP and
    write `{tag}_metric.jsonl`. `loss_cfg` adds the eval losses. Under a
    process group the inference is sharded (train/infer.py), every rank
    returns the same results, and rank 0 alone writes the files."""
    from flashvtg_tpu_torch.eval.metrics import eval_submission

    split_name = split_name or cfg.eval_split_name
    if compute_metrics is None:
        compute_metrics = cfg.eval_split_name == "val"
    writes = mesh.rank() == 0
    model.eval()
    if cfg.dset_name in HD_SETS:
        metrics = {"brief": run_hl_inference(cfg, model, eval_dataset)["brief"]}
        if writes:
            save_jsonl([metrics], os.path.join(results_dir, f"{tag}_metric.jsonl"))
        return metrics, None, {}
    t0 = time.time()
    submission, submission_nms, eval_losses = run_mr_inference(
        cfg, model, eval_dataset, loss_cfg=loss_cfg
    )
    infer_s = time.time() - t0
    sub_path = os.path.join(results_dir, f"{tag}_{cfg.dset_name}_{split_name}_preds.jsonl")
    nms_path = sub_path.replace(".jsonl", f"_nms_thd_{cfg.nms_thd}.jsonl")
    if writes:
        save_jsonl(submission, sub_path)
        if submission_nms is not None:
            save_jsonl(submission_nms, nms_path)
    metrics = metrics_nms = None
    if compute_metrics:
        t0 = time.time()
        metrics = eval_submission(submission, eval_dataset.data)
        logger.info("eval timing: infer %.2fs, metrics %.2fs (%d queries)",
                    infer_s, time.time() - t0, len(submission))
        if submission_nms is not None:
            metrics_nms = eval_submission(submission_nms, eval_dataset.data)
        if writes:
            save_json(metrics, sub_path.replace(".jsonl", "_metrics.json"), pretty=True)
            if metrics_nms is not None:
                save_json(metrics_nms, nms_path.replace(".jsonl", "_metrics.json"),
                          pretty=True)
    return metrics, metrics_nms, eval_losses


def state_sidecar(path: str) -> str:
    """`<name>.state.json` beside checkpoint `<name>.ckpt`: its best score."""
    return os.path.splitext(os.path.abspath(path))[0] + ".state.json"


def save_checkpoint(path: str, model, optimizer, scheduler, epoch: int, cfg,
                    best_score: Optional[float] = None) -> None:
    """The full train state as a reference-format `.ckpt` (model,
    state_dict, optimizer, lr_scheduler, epoch, opt as a plain dict; the
    reference trainer's train.py:200-233), opt.json beside it and, with
    `best_score`, the `<name>.state.json` sidecar that `--resume auto` reads
    to restore the best-so-far bar."""
    opt_state = optimizer.state_dict()
    # the rate as a float, as a float-rate optimizer writes it
    opt_state["param_groups"] = [{**g, "lr": float(g["lr"])} for g in opt_state["param_groups"]]
    save_torch_checkpoint(
        path, model.state_dict(), epoch=epoch, optimizer=opt_state,
        lr_scheduler=scheduler.state_dict(), opt=dataclasses.asdict(cfg),
    )
    cfg.save(os.path.join(os.path.dirname(os.path.abspath(path)), "opt.json"))
    if best_score is not None:
        with open(state_sidecar(path), "w") as f:
            json.dump({"best_score": float(best_score)}, f)


def load_checkpoint(path: str, map_location="cpu") -> dict:
    """A `.ckpt` dict with its tensors on `map_location`. The JAX package's
    orbax directories are not read: export them first (`python -m
    flashvtg_tpu.cli export ... --export_path x.ckpt`)."""
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory (a JAX orbax checkpoint?): the port reads "
            "reference-format .ckpt files; export it with `python -m "
            "flashvtg_tpu.cli export <config> --resume {path} --export_path x.ckpt`"
        )
    return lenient_torch_load(path, map_location)


def _fitted(src: torch.Tensor, dst: torch.Tensor) -> Optional[torch.Tensor]:
    """`src` shaped as `dst`, or None when it does not fit. A (1,) entry fits
    a 0-d parameter, as torch's load_state_dict allows: the JAX package's
    export writes the 0-d `x` so."""
    if tuple(src.shape) == tuple(dst.shape):
        return src
    if dst.dim() == 0 and tuple(src.shape) == (1,):
        return src.reshape(())
    return None


def load_model_weights(model, sd: Dict[str, torch.Tensor]) -> None:
    """load_state_dict(strict=True) that checks every name and shape first,
    so a mismatched checkpoint leaves the model as it was; weights of the
    other variant (FlashVTG_ms against the core model, told apart by the
    phrase-pipeline keys) are refused by name."""
    own = model.state_dict()
    have, want = checkpoint_variant(sd), checkpoint_variant(own)
    if have != want:
        raise ValueError(f"checkpoint holds {have!r} weights; the model is variant "
                         f"{want!r} (set --variant {have})")
    missing = sorted(set(own) - set(sd))
    unexpected = sorted(set(sd) - set(own))
    shapes = [k for k in own if k in sd and _fitted(sd[k], own[k]) is None]
    if missing or unexpected or shapes:
        raise ValueError(
            f"checkpoint does not fit the model: missing {missing[:5]}, "
            f"unexpected {unexpected[:5]}, other shapes {shapes[:5]}"
        )
    model.load_state_dict({k: _fitted(v, own[k]) for k, v in sd.items()})


def merge_partial_params(params: Dict[str, torch.Tensor], loaded: Dict[str, torch.Tensor]):
    """Non-strict preload (--resume_adapter, the reference's
    load_state_dict(strict=False)): take each entry of `loaded` whose name
    and shape match one of `params`; keep the others of `params`; drop
    names `params` lacks. Returns the merged state_dict."""
    merged, copied, skipped = {}, 0, 0
    for name, dst in params.items():
        src = loaded.get(name)
        fitted = None if src is None else _fitted(src, dst)
        if fitted is not None:
            merged[name] = fitted.to(device=dst.device, dtype=dst.dtype)
            copied += 1
        else:
            merged[name] = dst
            skipped += src is not None
    logger.info("resume_adapter: copied %d leaves, skipped %d", copied, skipped)
    return merged


def load_adapter(cfg, model) -> None:
    """Apply --resume_adapter to `model`: a partial, non-strict preload from
    a reference-format `.ckpt` (the port's, the JAX export's, the
    reference's)."""
    device = next(model.parameters()).device
    loaded = model_state(load_checkpoint(cfg.resume_adapter, device))
    model.load_state_dict(merge_partial_params(model.state_dict(), loaded))


# opt.json fields that fix the parameter shapes (the JAX loop's list)
_SHAPE_KEYS = (
    "variant", "hidden_dim", "nheads", "enc_layers", "t2v_layers", "dummy_layers",
    "num_dummies", "dim_feedforward", "strides", "v_feat_dim", "t_feat_dim", "max_v_l",
    "max_q_l", "kernel_size", "num_conv_layers", "num_mlp_layers", "n_input_proj",
    "num_phrase", "phrase_layers", "context_layers", "rank", "t_sa",
)


def find_auto_resume(cfg) -> Optional[str]:
    """`--resume auto`: the newest `model_latest.ckpt` under
    cfg.results_root whose run dir's opt.json has this experiment's
    dset_name, ctx_mode and exp_id and the same parameter shapes, else None.
    A checkpoint is written beside its name and renamed, so the newest is
    whole."""

    def norm(v):
        return list(v) if isinstance(v, (list, tuple)) else v

    def same_experiment(ckpt_path):
        try:
            with open(os.path.join(os.path.dirname(ckpt_path), "opt.json")) as f:
                saved = json.load(f)
        except (OSError, ValueError):
            return False
        if not all(saved.get(k) == getattr(cfg, k) for k in ("dset_name", "ctx_mode", "exp_id")):
            return False
        mismatched = [k for k in _SHAPE_KEYS
                      if k in saved and norm(saved[k]) != norm(getattr(cfg, k, None))]
        if mismatched:
            logger.info("--resume auto: skipping %s (same exp_id but different model "
                        "shape: %s)", ckpt_path, ", ".join(mismatched))
            return False
        return True

    candidates = sorted(
        (c for c in glob.glob(os.path.join(cfg.results_root, "*", "model_latest.ckpt"))
         if same_experiment(c)),
        key=os.path.getmtime,
    )
    return candidates[-1] if candidates else None


@dataclasses.dataclass(frozen=True)
class EpochMode:
    """How train() runs its epochs: `feed` (the split's features resident
    on the device, labels and row indices per step) or streamed; `graph`
    (each step on the card a replay of one captured CUDA graph) or eager;
    `chunk`, the feed's steps a chunk (1 when streamed)."""

    feed: bool
    graph: bool
    chunk: int


def feed_fits(cfg, n_rows: int) -> bool:
    """The JAX loop's feed gate: not with device_feed off, no fixed
    max_v_l, or txt_drop on (the text then changes at every access); under
    "auto" not past what is left of device_feed_budget_gb beside the feeds
    already resident (n_rows rows in transfer_dtype)."""
    if cfg.device_feed == "off" or cfg.max_v_l <= 0 or cfg.txt_drop_ratio > 0:
        return False
    est = estimate_feed_bytes(n_rows, cfg.max_v_l, cfg.total_v_feat_dim, cfg.max_q_l,
                              cfg.t_feat_dim, 2 if cfg.transfer_dtype == "bfloat16" else 4)
    remaining = cfg.device_feed_budget_gb * 2**30 - resident_feed_bytes()
    if cfg.device_feed != "on" and est > remaining:
        logger.info("device feed off: %.2f GB exceeds the %.2f GB left of the budget",
                    est / 2**30, remaining / 2**30)
        return False
    return True


def epoch_mode(cfg, device, n_rows: int) -> EpochMode:
    """The epoch's mode for a train split of n_rows rows on `device` (a
    device object or name; nothing is launched): the feed where it fits
    (`feed_fits`); a graph on CUDA at a fixed max_v_l (every batch of one
    shape) with scan_steps > 1, not under debug or debug_nans (per-step
    eager steps for inspection, as the JAX loop runs no scan there); the
    feed's chunks of scan_steps steps, of one under debug and debug_nans.
    Under a gloo process group every step is eager: gloo's collectives (the
    step's gradient all-reduce) cannot be captured in a CUDA graph; NCCL
    supports stream capture."""
    feed = feed_fits(cfg, n_rows)
    per_step = cfg.debug or cfg.debug_nans
    graph = (torch.device(device).type == "cuda" and not per_step and cfg.scan_steps > 1
             and cfg.max_v_l > 0)
    if graph and mesh.backend() == "gloo":
        logger.info("data parallel over gloo: eager steps (gloo collectives cannot be "
                    "captured in a CUDA graph)")
        graph = False
    chunk = max(cfg.scan_steps, 1) if feed and not per_step else 1
    return EpochMode(feed=feed, graph=graph, chunk=chunk)


def train_feed(cfg, dataset: VTGDataset, collator: Collator, device,
               mode: Optional[EpochMode] = None):
    """The train split's device feed, or None where `mode` (default:
    epoch_mode's) streams."""
    mode = mode or epoch_mode(cfg, device, len(dataset))
    if not mode.feed:
        return None
    narrow = torch.bfloat16 if cfg.transfer_dtype == "bfloat16" else None
    return build_device_feed(dataset, collator, device, narrow)


@obs.root("train.epoch")
def run_chunked_epoch(feed_steps, host_batch, n_steps: int, k: int, loss_buf,
                      device) -> int:
    """n_steps feed-mode steps in chunks of k: each chunk's labels and row
    indices are collated and stacked, (k, B, ...) and (k, B), on the
    prefetch thread (`stack_chunk`), then run by `run_chunk`. Returns the
    steps run."""

    def chunk(ci):
        with obs.span("data.make_batch", ci * k):
            made = [host_batch(i) for i in range(ci * k, min((ci + 1) * k, n_steps))]
            made = [m for m in made if m is not None]
            return stack_chunk(made) if made else None

    done = 0
    with contextlib.closing(_prefetched(chunk, -(-max(n_steps, 0) // k))) as chunks:
        while True:
            with obs.span("train.batch_wait", done):
                item = next(chunks, None)
            if item is None:
                return done
            if item[1] is not None:
                with obs.span("train.issue", done):
                    ran = run_chunk(feed_steps, item[1], loss_buf, done, device)
                obs.count("train.steps", ran - done)
                done = ran


def stack_chunk(made) -> Dict[str, np.ndarray]:
    """The label arrays of a chunk's (row indices, collated batch) pairs,
    stacked to (k, B, ...), and the indices as "idx" (k, B) int64."""
    labels = [label_arrays(batch) for _, batch in made]
    arrays = {key: np.stack([lab[key] for lab in labels]) for key in labels[0]}
    arrays["idx"] = np.stack([np.asarray(idx, np.int64) for idx, _ in made])
    return arrays


def run_chunk(feed_steps, arrays: Dict[str, np.ndarray], loss_buf, row: int,
              device) -> int:
    """One chunk: the stacked arrays uploaded in one pinned copy, then each
    step through `feed_steps` (a graph replay on the card), its loss vector
    written to `loss_buf` from row `row` on. Returns the next free row."""
    dev = upload(arrays, device)
    idx = dev.pop("idx")
    for j in range(len(idx)):
        loss_buf[row].copy_(feed_steps({key: v[j] for key, v in dev.items()}, idx[j]))
        row += 1
    return row


@obs.root("train.epoch")
def run_streamed_epoch(streamed_steps, host_batch, n_steps: int, loss_buf, device,
                       transfer_dtype: str = "float32") -> int:
    """n_steps streamed steps through `streamed_steps` (train/graph.py:
    StreamedSteps), their loss vectors into `loss_buf`; returns the steps
    run. Step i's row indices and collated batch come from host_batch(i)
    (None for a short batch) on the prefetch thread, which on the card also
    stages the batch in one pinned buffer (data/feed.py:stage_batch). On
    the card the main thread issues step i, then step i + 1's copy on the
    copy stream (`copy_ahead`), so the copy overlaps step i, and the step
    waits for its copy's event alone; before it allocates that copy's
    device buffer it waits for step i - 1 to end, so at most one batch is
    in flight beside the one being computed. On the CPU each batch is
    placed by `place_batch`."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    copy_stream = torch.cuda.Stream(device) if cuda else None

    def made(i):
        with obs.span("data.make_batch", i):
            m = host_batch(i)
            if m is None or not cuda:
                return m and m[1]
            return stage_batch(m[1], TRAIN_KEYS, device, transfer_dtype=transfer_dtype)

    def place(item) -> PlacedBatch:
        if cuda:
            return copy_ahead(item, device, copy_stream)
        return PlacedBatch(place_batch(item, device, transfer_dtype=transfer_dtype))

    done = 0
    with contextlib.closing(_prefetched(made, max(n_steps, 0))) as items:
        items = (item for _, item in items if item is not None)
        with obs.span("train.batch_wait", 0):
            first = next(items, None)
        with obs.span("train.issue", 0):
            pending = None if first is None else place(first)
        before = None  # the end of the previous step, on the compute stream
        while pending is not None:
            with obs.span("train.issue", done):
                loss_buf[done].copy_(streamed_steps(pending.wait()))
            done += 1
            obs.count("train.steps")
            ended = None
            if cuda:
                ended = torch.cuda.Event()
                ended.record()
            with obs.span("train.batch_wait", done):
                nxt = next(items, None)
            if before is not None:
                with obs.span("train.step_wait", done - 2):
                    before.synchronize()
            with obs.span("train.issue", done):
                pending = None if nxt is None else place(nxt)
            before = ended
    return done


def train(cfg, results_dir: Optional[str] = None, device=None,
          max_steps: Optional[int] = None):
    """Full training run; returns (model, best_score, results_dir): the model
    in eval mode with the best epoch's weights (the last epoch's where no
    eval improved), on `device` (None: the card).

    Weights come from cfg.seed (then --resume_adapter, --resume); the rows
    are shuffled each epoch by a generator seeded from cfg.seed at loop
    start, steps_per_epoch = max(1, rows // bsz) with a short batch skipped;
    the video length is pinned to max_v_l. `max_steps` caps the steps of
    this run: the epoch that reaches it ends there and is the last, its eval
    and checkpoint made as for any epoch. The epoch's mode
    (`epoch_mode`: the device feed or streamed, graph or eager) follows
    device_feed / scan_steps / debug / debug_nans and the split's size (the
    module's doc); a run captures its step's CUDA graph once, after every
    load (--resume, --resume_adapter, the optimizer's state), and the
    in-training evals and checkpoint saves read the graph's parameter and
    optimizer tensors in place; a capture that fails raises. debug_nans
    and profile_dir as the module's doc says; both end with this call.
    Under a process group every rank calls train() alike (the module's
    doc: data parallel); `results_dir` is rank 0's."""
    with contextlib.ExitStack() as scope:
        return _train(cfg, results_dir, device, max_steps, scope)


def _train(cfg, results_dir, device, max_steps, scope: contextlib.ExitStack):
    from flashvtg_tpu_torch.models import build_model
    from flashvtg_tpu_torch.train.graph import FeedSteps, StreamedSteps
    from flashvtg_tpu_torch.utils.observability import (
        NullWriter,
        ScalarWriter,
        check_finite_tree,
        nan_tripwire,
        profile_trace,
    )
    from flashvtg_tpu_torch.utils.runtime import resolve_device
    from flashvtg_tpu_torch.utils.snapshot import snapshot_code

    cfg.check_ported(train=True)
    device = resolve_device(device)
    world, rank = mesh.world(), mesh.rank()
    local_bsz = mesh.build_group_for(cfg.bsz)
    writes = rank == 0  # files, checkpoints and logs are rank 0's
    results_dir = mesh.broadcast_object(results_dir or os.path.join(
        cfg.results_root,
        f"{cfg.dset_name}-{cfg.ctx_mode}-{cfg.exp_id}-{time.strftime('%Y-%m-%d-%H-%M-%S')}",
    ))
    if writes:
        os.makedirs(results_dir, exist_ok=True)
        cfg.save(os.path.join(results_dir, "opt.json"))
        try:
            snapshot_code(results_dir)
        except Exception as e:  # a snapshot failure must never stop training
            logger.warning("code snapshot failed: %s", e)
    if world > 1:
        logger.info("data parallel: rank %d of %d (%s), %d rows of each global batch of %d",
                    rank, world, mesh.backend(), local_bsz, cfg.bsz)

    # feature dropout and DropPath draw from it: each rank its own stream
    torch.manual_seed(cfg.seed + rank)
    train_dataset = VTGDataset(train_data_config(cfg, cfg.train_path))
    eval_dataset = VTGDataset(eval_data_config(
        cfg, cfg.eval_path, load_labels=cfg.eval_split_name == "val"
    )) if cfg.eval_path else None
    # the JAX loop collates the first two rows for its parameter init, which
    # draws their labels; drawing them here too keeps the two label streams
    # the same
    for i in range(min(2, len(train_dataset))):
        train_dataset[i]
    model = build_model(cfg.model_config(), device, cfg.seed).train()
    if cfg.debug_nans:
        scope.enter_context(nan_tripwire(model))
    loss_cfg = cfg.loss_config()
    collator = Collator(
        cfg.max_q_l, cfg.v_buckets, cfg.max_v_l if cfg.max_v_l > 0 else None,
        max_windows=cfg.max_windows, dset_name=cfg.dset_name,
    )
    if cfg.resume_adapter:
        load_adapter(cfg, model)
    steps_per_epoch = max(1, len(train_dataset) // cfg.bsz)
    n_epoch = cfg.n_epoch
    if cfg.debug:  # fast loop (reference config.py:32-33)
        steps_per_epoch, n_epoch = min(2, steps_per_epoch), min(1, n_epoch)
    optimizer, scheduler = make_optimizer(cfg, model.parameters(), steps_per_epoch)

    start_epoch_override = resumed_best_score = prior_best_ckpt = None
    auto_resumed = False
    if cfg.resume == "auto":
        cfg = cfg.replace(resume=find_auto_resume(cfg), resume_all=True)
        auto_resumed = cfg.resume is not None
        if auto_resumed:
            logger.info("auto-resume from %s", cfg.resume)
    if cfg.resume:
        try:
            ckpt = load_checkpoint(cfg.resume, device)
            load_model_weights(model, model_state(ckpt))
            if cfg.resume_all:
                if "optimizer" in ckpt:
                    optimizer.load_state_dict(ckpt["optimizer"])
                if "lr_scheduler" in ckpt:
                    scheduler.load_state_dict(ckpt["lr_scheduler"])
                scheduler.bind()
        except Exception:
            # an auto-found checkpoint that does not restore starts the run
            # afresh; an explicit --resume stays an error
            if not auto_resumed:
                raise
            logger.warning("--resume auto: %s did not restore; starting fresh",
                           cfg.resume, exc_info=True)
            ckpt = None
        if ckpt is not None and cfg.resume_all:
            start_epoch_override = int(ckpt.get("epoch", -1)) + 1
            try:
                with open(state_sidecar(cfg.resume)) as f:
                    resumed_best_score = float(json.load(f)["best_score"])
            except (OSError, ValueError, KeyError):
                resumed_best_score = None
            cand = os.path.join(os.path.dirname(os.path.abspath(cfg.resume)),
                                "model_best.ckpt")
            if os.path.isfile(cand):
                prior_best_ckpt = cand
    mesh.replicate_params(model)  # every rank starts from rank 0's weights
    step = make_train_step(model, loss_cfg, optimizer, scheduler, cfg.grad_clip,
                           torch.Generator(device=device).manual_seed(cfg.seed + rank),
                           cfg.train_precision)
    keys = step.loss_keys
    mode = epoch_mode(cfg, device, len(train_dataset))
    feed = train_feed(cfg, train_dataset, collator, device, mode)
    # feed-mode batches carry labels alone, run in chunks of mode.chunk;
    # streamed batches carry their features; in a graph mode each step on
    # the card is a replay of one captured graph
    step_collator = (dataclasses.replace(collator, pad_features=False) if feed is not None
                     else collator)
    if feed is not None:
        train_steps = FeedSteps(step, feed, graph=mode.graph)
    else:
        train_steps = StreamedSteps(step, graph=mode.graph)

    writer = ScalarWriter(
        os.path.join(results_dir, "tensorboard_log"), use_tensorboard=cfg.use_tensorboard,
        wandb_run=dict(project=cfg.wandb_project, name=os.path.basename(results_dir),
                       config=dataclasses.asdict(cfg)) if cfg.use_wandb else None,
    ) if writes else NullWriter()
    writer.write_text("hyperparameters",
                      json.dumps(dataclasses.asdict(cfg), indent=2, default=list))
    n_params = sum(p.numel() for p in model.parameters())
    logger.info("Learnable Parameters: %.3fM (100.0%%)", n_params / 1024 / 1024)

    best_path = os.path.join(results_dir, "model_best.ckpt")
    best_score, have_best, es_cnt = 0.0, False, 0
    if resumed_best_score is not None:
        best_score = resumed_best_score
        logger.info("resume: best-so-far bar restored to %.4f (prior model_best: %s)",
                    best_score, prior_best_ckpt)
    if cfg.start_epoch is not None:
        start_epoch = cfg.start_epoch
    elif start_epoch_override is not None:
        start_epoch = start_epoch_override
    else:
        start_epoch = 0

    def run_eval_and_select(epoch: int, at_step: int) -> Optional[bool]:
        """One in-training eval: eval/* scalars, the eval.log.txt line (raw
        0-based epoch, -1 for eval_untrained, as the reference writes it),
        model_best on a strict gain. None when no metrics were computed,
        else whether the model improved."""
        nonlocal best_score, have_best
        label = "untrained" if epoch < 0 else f"epoch {epoch + 1}"
        metrics, _, eval_losses = evaluate(cfg, model, eval_dataset, results_dir,
                                           tag="latest", loss_cfg=loss_cfg)
        if eval_losses:
            writer.write(at_step, eval_losses, prefix="eval/")
            logger.info("[%s] eval losses %s", label,
                        " ".join(f"{k} {v:.4f}" for k, v in eval_losses.items()))
        if metrics is None:
            return None
        score = stop_metric(cfg, metrics["brief"])
        logger.info("[%s] eval %s", label, dict(metrics["brief"]))
        if writes:
            with open(os.path.join(results_dir, "eval.log.txt"), "a") as f:
                f.write("{} [Epoch] {:03d} [Loss] {} [Metrics] {}\n".format(
                    time.strftime("%Y_%m_%d_%H_%M_%S"), epoch,
                    " ".join(f"{k} {v:.4f}" for k, v in eval_losses.items()),
                    json.dumps(metrics),
                ))
        # every rank holds the same metrics, so every rank takes this branch
        improved = score > best_score
        if improved:
            best_score, have_best = score, True
            save(best_path, epoch, score)
        return improved

    def save(path, epoch, score):
        if writes:
            save_checkpoint(path, model, optimizer, scheduler, epoch, cfg, best_score=score)
        mesh.barrier()

    if cfg.eval_untrained and eval_dataset is not None and start_epoch == 0:
        run_eval_and_select(-1, 0)

    shuffler = np.random.default_rng(cfg.seed)
    all_rows = np.arange(len(train_dataset))
    global_vids = neg_pair_base([r["vid"] for r in train_dataset.data], cfg.dset_name)
    own = slice(rank * local_bsz, (rank + 1) * local_bsz)
    global_step = steps_run = 0
    for epoch in range(start_epoch, n_epoch):
        shuffler.shuffle(all_rows)
        order = mesh.assembled_order(all_rows, world, local_bsz)
        epoch_t0 = time.time()
        n_steps = steps_per_epoch if max_steps is None else min(steps_per_epoch,
                                                                 max_steps - steps_run)
        # the epoch's loss vectors, one row a step, fetched once at its end
        loss_buf = torch.zeros((max(n_steps, 0), len(keys)), dtype=torch.float32,
                               device=device)

        def host_batch(i):
            """Step i's row indices and collated batch, this rank's rows of
            global batch i (None for a short batch): host work, made on the
            prefetch thread. Every row of the global batch is read in its
            order, so the label draws are one process's."""
            rows = order[i * cfg.bsz : (i + 1) * cfg.bsz]
            if len(rows) < cfg.bsz:
                return None
            samples = [train_dataset[j] for j in rows]
            batch = step_collator(samples[own])
            if world > 1:
                batch["real_neg_mask"] = global_real_neg_mask(global_vids, all_rows, i,
                                                              local_bsz, world, rank)
            return rows[own], batch

        # the run's first epoch traced into profile_dir (the JAX loop's)
        with (profile_trace(cfg.profile_dir) if epoch == start_epoch
              else contextlib.nullcontext()):
            if feed is not None:
                done = run_chunked_epoch(train_steps, host_batch, n_steps, mode.chunk,
                                         loss_buf, device)
            else:
                done = run_streamed_epoch(train_steps, host_batch, n_steps, loss_buf, device,
                                          cfg.transfer_dtype)
        steps_run += done
        host = loss_buf[:done].cpu().tolist()
        meters: Dict[str, AverageMeter] = {}
        for s, vec in enumerate(host):
            values = dict(zip(keys, vec))
            for k, v in values.items():
                meters.setdefault(k, AverageMeter()).update(v)
            writer.write(global_step + s, values, prefix="train/")
        global_step += len(host)
        if cfg.debug_nans and meters and not all(np.isfinite(m.avg) for m in meters.values()):
            check_finite_tree(model.named_parameters(), "params")
        dt = time.time() - epoch_t0
        writer.write(global_step, {"epoch_seconds": dt,
                                   "steps_per_sec": max(len(host), 1) / max(dt, 1e-9)},
                     prefix="perf/")
        loss_str = " ".join(f"{k} {m.avg:.4f}" for k, m in meters.items())
        logger.info("[epoch %d] (%.1fs) %s", epoch + 1, dt, loss_str)
        if writes:  # the reference's epoch line (train.py:93-103)
            with open(os.path.join(results_dir, "train.log.txt"), "a") as f:
                f.write("{} [Epoch] {:03d} [Loss] {}\n".format(
                    time.strftime("%Y_%m_%d_%H_%M_%S"), epoch + 1, loss_str))

        if eval_dataset is not None and (epoch + 1) % cfg.eval_epoch == 0:
            improved = run_eval_and_select(epoch, global_step)
            if improved:
                es_cnt = 0
            elif improved is False:
                es_cnt += 1
                if cfg.max_es_cnt != -1 and es_cnt > cfg.max_es_cnt:
                    logger.info("early stop at epoch %d", epoch)
                    break
        save(os.path.join(results_dir, "model_latest.ckpt"), epoch, best_score)
        if max_steps is not None and steps_run >= max_steps:
            break
    writer.close()
    if train_steps.graph is not None:
        logger.info("train steps: %d CUDA-graph replays of one capture (%.2f s)%s",
                    train_steps.replays, train_steps.capture_s,
                    f", under a {mesh.backend()} group of world {world}" if mesh.active() else "")

    finals = bool(cfg.test_path) and eval_dataset is not None
    if finals:  # the latest model first, as the JAX loop evaluates them
        test_dataset = VTGDataset(eval_data_config(
            cfg, cfg.test_path, load_labels=cfg.dset_name in HD_SETS))
        run_finals(cfg, model, eval_dataset, test_dataset, results_dir, "latest")
    if have_best:
        load_model_weights(model, load_torch_checkpoint(best_path, device))
    elif prior_best_ckpt is not None and best_score > 0.0:
        # a resumed run that never beat the bar: the best weights are the
        # prior run's model_best
        load_model_weights(model, load_torch_checkpoint(prior_best_ckpt, device))
        have_best = True
    if finals and have_best:
        run_finals(cfg, model, eval_dataset, test_dataset, results_dir, "best")
    return model.eval(), best_score, results_dir


def run_finals(cfg, model, eval_dataset, test_dataset, results_dir, which: str) -> None:
    """The --test_path finals of one model (FlashVTG_ms/train.py:243-286):
    the val split and the test split, tags `val_{which}` / `test_{which}`.
    MR metrics on the test split only when every row carries its windows."""
    n_rows = len(test_dataset.data)
    n_gt = sum(1 for r in test_dataset.data if "relevant_windows" in r)
    has_gt = n_rows > 0 and (n_gt == n_rows or cfg.dset_name in HD_SETS)
    if not has_gt:
        logger.info("[final] test split: %d/%d rows carry relevant_windows -> writing "
                    "predictions only, skipping MR metrics", n_gt, n_rows)
    m_val, _, _ = evaluate(cfg, model, eval_dataset, results_dir, tag=f"val_{which}")
    m_test, _, _ = evaluate(cfg, model, test_dataset, results_dir, tag=f"test_{which}",
                            compute_metrics=has_gt, split_name="test")
    for split, m in (("val", m_val), ("test", m_test)):
        if m is not None:
            logger.info("[final] %s model on %s: %s", which, split, dict(m["brief"]))
