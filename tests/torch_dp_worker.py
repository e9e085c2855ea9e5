"""What each rank runs in tests/test_torch_parallel.py, and the ranks.

Imports torch and the port only. `run_ranks(jobs, world)` spawns `world`
processes (torch.multiprocessing), each a rank of a gloo process group on
the CPU that runs every job of {name: (function name, args)} in order
(`run_jobs`); it returns each rank's {name: result} (numpy arrays and plain
values only), in rank order.
"""

import contextlib
import dataclasses
import math
import os
import pickle
import socket
import tempfile
import time
from datetime import timedelta

import numpy as np
import torch

from flashvtg_tpu_torch.parallel import mesh


def _pe64(mask, num_pos_feats, temperature=10000.0, normalize=True, scale=2 * math.pi):
    """The sine position embedding in float64 (both packages compute it in
    float32, where XLA's and torch's sin / cos differ by one ulp)."""
    x = torch.cumsum(mask.double(), dim=1)
    if normalize:
        x = x / (x[:, -1:] + 1e-6) * scale
    dim = np.arange(num_pos_feats, dtype=np.float64)
    pos = x[:, :, None] / torch.from_numpy(temperature ** (2 * (dim // 2) / num_pos_feats))
    pos = torch.stack([torch.sin(pos[:, :, 0::2]), torch.cos(pos[:, :, 1::2])], dim=3)
    return pos.reshape(pos.shape[0], pos.shape[1], -1)


@contextlib.contextmanager
def _pe64_used():
    from flashvtg_tpu_torch.models import flashvtg, flashvtg_ms, lgi

    mods = (flashvtg, flashvtg_ms, lgi)
    real = [mod.sine_position_embedding for mod in mods]
    for mod in mods:
        mod.sine_position_embedding = _pe64
    try:
        yield
    finally:
        for mod, fn in zip(mods, real):
            mod.sine_position_embedding = fn


@contextlib.contextmanager
def _no_dummy_dropout():
    """The dummy encoder's hard-coded dropout at 0 (ExperimentConfig's
    model_config), so a train() run draws no dropout at all."""
    from flashvtg_tpu_torch.train.config import ExperimentConfig

    orig = ExperimentConfig.model_config
    ExperimentConfig.model_config = lambda self: dataclasses.replace(orig(self),
                                                                     dummy_dropout=0.0)
    try:
        yield
    finally:
        ExperimentConfig.model_config = orig


def step_f64(cfg, state, host):
    """One float64 train step of the global batch `host` (numpy, every row),
    this rank holding its rows: the losses and the summed gradients of the
    forward / criterion / backward, then make_train_step's update from the
    same weights (losses, summed gradients before the clip, parameters
    after)."""
    with _pe64_used():
        return _step_f64(cfg, state, host)


def _step_f64(cfg, state, host):
    from flashvtg_tpu_torch.losses import criterion
    from flashvtg_tpu_torch.models import FlashVTGModel, FlashVTGMSModel, MSModelConfig
    from flashvtg_tpu_torch.train import loop
    from flashvtg_tpu_torch.train.loop import make_optimizer, make_train_step, place_batch

    world, n = mesh.world(), len(host["src_vid"]) // mesh.world()
    own = slice(mesh.rank() * n, (mesh.rank() + 1) * n)
    tb = place_batch({k: v[own] for k, v in host.items()}, "cpu", torch.float64)
    mcfg = dataclasses.replace(cfg.model_config(), dummy_dropout=0.0)
    loss_cfg = cfg.loss_config()

    def fresh():
        model = (FlashVTGMSModel if isinstance(mcfg, MSModelConfig) else FlashVTGModel)(mcfg)
        model = model.double()
        model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()}, strict=True)
        return model.train()

    model = fresh()
    with mesh.split_batch():
        out = model(tb["src_txt"], tb["src_txt_mask"], tb["src_vid"], tb["src_vid_mask"],
                    real_neg_mask=tb["real_neg_mask"])
        losses = criterion(loss_cfg, out, tb)
    (losses["weighted_loss_overall"] / world).backward()
    params = list(model.parameters())
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    mesh.all_reduce_grads_(params)
    result = {"losses": {k: v.item() for k, v in losses.items()},
              "grads": {k: p.grad.numpy().copy() for k, p in model.named_parameters()}}

    model = fresh()
    optimizer, scheduler = make_optimizer(cfg, model.parameters(), steps_per_epoch=1)
    step = make_train_step(model, loss_cfg, optimizer, scheduler, cfg.grad_clip,
                           precision="float32")
    real_clip = loop.clip_by_global_norm_

    def clip(params, max_norm):  # the step's summed gradient, before the clip
        result["step_grads"] = {k: p.grad.numpy().copy() for k, p in model.named_parameters()}
        real_clip(params, max_norm)

    loop.clip_by_global_norm_ = clip
    try:
        result["step_losses"] = {k: v.item() for k, v in step(tb).items()}
    finally:
        loop.clip_by_global_norm_ = real_clip
    result["params"] = {k: p.detach().numpy().copy() for k, p in model.named_parameters()}
    return result


def inference(mr_cfg, hl_cfg, seed):
    """run_mr_inference (with the eval losses) and run_hl_inference of a
    model drawn from `seed`, sharded over the group."""
    from flashvtg_tpu_torch.data.dataset import VTGDataset
    from flashvtg_tpu_torch.models import build_model
    from flashvtg_tpu_torch.train.infer import (
        eval_data_config,
        run_hl_inference,
        run_mr_inference,
    )

    out = {}
    model = build_model(mr_cfg.model_config(), "cpu", seed)
    ds = VTGDataset(eval_data_config(mr_cfg, mr_cfg.eval_path, load_labels=True))
    out["mr"] = run_mr_inference(mr_cfg, model, ds, loss_cfg=mr_cfg.loss_config())
    model = build_model(hl_cfg.model_config(), "cpu", seed)
    ds = VTGDataset(eval_data_config(hl_cfg, hl_cfg.eval_path))
    hl = run_hl_inference(hl_cfg, model, ds)
    out["hl"] = (hl["brief"], {k: v.copy() for k, v in hl["saliency"].items()})
    return out


def train_run(cfg, results_dir, no_dropout):
    """train() under the group; returns the paths this rank opened for
    writing under the run's root, and the final weights."""
    import builtins

    from flashvtg_tpu_torch.train.loop import train

    root = os.path.dirname(os.path.abspath(results_dir))
    written = []
    real_open = builtins.open

    def spying_open(file, mode="r", *args, **kwargs):
        if any(c in mode for c in "wax+") and isinstance(file, (str, os.PathLike)) and \
                os.path.abspath(file).startswith(root):
            written.append(os.path.relpath(os.path.abspath(file), root))
        return real_open(file, mode, *args, **kwargs)

    builtins.open = spying_open
    try:
        with _no_dummy_dropout() if no_dropout else contextlib.nullcontext():
            model, best, run_dir = train(cfg, results_dir, device="cpu")
    finally:
        builtins.open = real_open
    return {"written": written, "best": best, "run_dir": run_dir,
            "state": {k: v.numpy().copy() for k, v in model.state_dict().items()}}


def dropout_draws(cfg, results_dir):
    """One train() step with every dropout at its preset value; the
    attention-dropout seeds and the feature-dropout masks it drew."""
    import torch.nn.functional as F

    from flashvtg_tpu_torch.ops import aca
    from flashvtg_tpu_torch.train.loop import train

    seeds, masks = [], []
    real_draw, real_dropout = aca.draw_seed, F.dropout

    def draw(generator, device):
        s = real_draw(generator, device)
        seeds.append(int(s))
        return s

    def dropout(x, p=0.5, training=True, inplace=False):
        y = real_dropout(x, p, training, inplace)
        if training and p > 0:
            masks.append((y != 0).numpy().copy())
        return y

    aca.draw_seed, F.dropout = draw, dropout
    try:
        model, _, _ = train(cfg, results_dir, device="cpu", max_steps=1)
    finally:
        aca.draw_seed, F.dropout = real_draw, real_dropout
    return {"seeds": seeds, "masks": masks,
            "state": {k: v.numpy().copy() for k, v in model.state_dict().items()}}


def epoch_graph(cfg):
    """Whether epoch_mode would capture graphs on the card under this group."""
    from flashvtg_tpu_torch.train.loop import epoch_mode

    return epoch_mode(cfg, "cuda", 8).graph


def run_jobs(jobs):
    torch.set_num_threads(1)
    return {name: globals()[fn](*args) for name, (fn, args) in jobs.items()}


def _rank(r, world, port, jobs, out_dir):
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=r,
                            world_size=world, timeout=timedelta(minutes=10))
    try:
        result = run_jobs(jobs)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{r}.pkl"), "wb") as f:
        pickle.dump(result, f)


def run_ranks(jobs, world, timeout=900.0):
    """run_jobs(jobs) on `world` spawned gloo ranks; their results in rank
    order. A rank that raises raises here (the others are terminated), and
    ranks that outlive `timeout` seconds are killed."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    with tempfile.TemporaryDirectory(prefix="ranks-") as tmp:
        ctx = torch.multiprocessing.spawn(_rank, args=(world, port, jobs, tmp), nprocs=world,
                                          join=False)
        deadline = time.monotonic() + timeout
        while not ctx.join(timeout=1):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                raise TimeoutError(f"ranks outlived {timeout:.0f} s")
        results = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results

