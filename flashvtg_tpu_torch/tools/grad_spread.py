"""How far a train step's gradients at the reduced-precision dials lie from
the float32 step's, leaf by leaf, and from another tree's steps.

    python -m flashvtg_tpu_torch.tools.grad_spread [--preset tacos] [--seed 0]
        [--precision float32 tensorfloat32 bfloat16] --save grads.pt
    python -m flashvtg_tpu_torch.tools.grad_spread --compare a.pt [b.pt]

--save builds the preset's model at full width and depth (random weights
from --seed) and one synthetic batch of its train shapes
(tools/step_time.py:synthetic_batch), then takes one train step at each
--precision from the same weights, with every dropout at 0 and no clipping
(as chip_smoke.py's phase 14 does), and saves each step's total loss and
gradients with the leaves' names. --compare prints, for each file, each
dial's |g - g32| / |g32| over every parameter and the leaves that hold most
of |g - g32|^2; with two files (say the parent tree's and this one's, each
saved by its own tree: PYTHONPATH=<tree> python3 <this file> --save ...),
also each dial's |g_a - g_b| / |g32_a|. The loss's discrete choices can
flip on rounding, so two steps whose arithmetic differs by rounding alone
may lie as far apart as a dial lies from float32.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import torch


def step_grads(preset: str, precision: str, seed: int, device) -> dict:
    """One train step at `precision`, every dropout at 0, unclipped: its
    total loss and every parameter's gradient, in float32 on the CPU."""
    from flashvtg_tpu_torch.models import build_model
    from flashvtg_tpu_torch.tools.step_time import synthetic_batch
    from flashvtg_tpu_torch.train.config import from_preset
    from flashvtg_tpu_torch.train.loop import make_optimizer, make_train_step, place_batch

    cfg = from_preset(preset, use_tensorboard=False, dropout=0.0, input_dropout=0.0)
    model = build_model(dataclasses.replace(cfg.model_config(), dummy_dropout=0.0), device,
                        seed).train()
    optimizer, scheduler = make_optimizer(cfg, model.parameters(), 1)
    step = make_train_step(model, cfg.loss_config(), optimizer, scheduler, 0.0,
                           precision=precision)
    loss = step(place_batch(synthetic_batch(cfg, seed), device))
    return {"loss": loss["weighted_loss_overall"].item(),
            "grads": {n: p.grad.detach().float().cpu() for n, p in model.named_parameters()}}


def _flat(grads: dict) -> torch.Tensor:
    return torch.cat([g.flatten().double() for g in grads.values()])


def compare(paths, top: int = 8) -> None:
    runs = [torch.load(p) for p in paths]
    for path, run in zip(paths, runs):
        g32 = run["float32"]["grads"]
        for mode, r in run.items():
            if mode == "float32":
                continue
            share = {n: (r["grads"][n].double() - g.double()).pow(2).sum().item()
                     for n, g in g32.items()}
            total = sum(share.values())
            print(json.dumps({
                "file": path, "precision": mode, "loss": r["loss"],
                "loss_float32": run["float32"]["loss"],
                "grad_rel_err": ((_flat(r["grads"]) - _flat(g32)).norm()
                                 / _flat(g32).norm()).item(),
                "top_leaves": [(n, v / total) for n, v in
                               sorted(share.items(), key=lambda kv: -kv[1])[:top]],
            }))
    if len(runs) == 2:
        a, b = runs
        norm = _flat(a["float32"]["grads"]).norm()
        print(json.dumps({mode: ((_flat(a[mode]["grads"]) - _flat(b[mode]["grads"])).norm()
                                 / norm).item() for mode in a if mode in b}))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--preset", default="tacos")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--precision", nargs="+", default=["float32", "tensorfloat32", "bfloat16"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--save", metavar="PATH")
    ap.add_argument("--compare", nargs="+", metavar="PATH")
    args = ap.parse_args(argv)
    if args.save:
        if "float32" not in args.precision:
            ap.error("--save needs float32 among --precision: the others are held to it")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.save({mode: step_grads(args.preset, mode, args.seed, torch.device(args.device))
                    for mode in args.precision}, args.save)
    if args.compare:
        compare(args.compare)
    if not (args.save or args.compare):
        ap.error("nothing to do: give --save or --compare")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
