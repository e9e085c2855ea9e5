"""Command-line entry points of the port (train / infer / export).

    python -m flashvtg_tpu_torch.cli train  <data/MR.py|preset> --dset_name hl ...
    python -m flashvtg_tpu_torch.cli infer  <data/MR.py|preset> --resume x.ckpt ...
    python -m flashvtg_tpu_torch.cli export <data/MR.py|preset> --resume x.ckpt \
        --export_path model.ckpt

Counterpart of flashvtg_tpu/cli.py. The positional config is a reference-
style python model-config file (data/MR*.py, data/HD.py) or a preset name;
every ExperimentConfig field is also a --flag. One flag is the port's own:
--device (default cuda; cpu runs the kernels' plain PyTorch versions).
`infer --serving` evaluates at tensorfloat32 unless --eval_precision is
given; the other modes ignore it with a warning, and it never persists.
Checkpoints are reference-format `.ckpt` files: the port's model_best /
model_latest, a JAX `cli export`, or a reference trainer's. infer and export
restore the training-time flags from the opt.json beside --resume, as the
reference's TestOptions does, but for its keep-list and this invocation's
flags.

Data parallel: `train` and `infer` run under torchrun as they are, one
process per card (the JAX CLI likewise finds its processes from the
environment and has no flag for them):

    torchrun --nproc_per_node 8 -m flashvtg_tpu_torch.cli train <config> ...
    torchrun --nproc_per_node 2 -m flashvtg_tpu_torch.cli train <config> ... --device cpu

The process group comes from torchrun's environment (parallel/mesh.py:
init_group): NCCL on the cards, each process on the card LOCAL_RANK names;
gloo with --device cpu. train/loop.py and train/infer.py say what each rank
does; rank 0 alone writes files and prints.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import sys

from flashvtg_tpu_torch.parallel import mesh
from flashvtg_tpu_torch.train.config import (
    PRESETS,
    ExperimentConfig,
    apply_model_cfg,
    emit_model_cfg,
    from_preset,
    load_model_cfg_file,
)

# TestOptions keep-list (reference config.py:196-199): eval-time knobs that
# keep this invocation's values over the opt.json's; plus eval_bsz, whose
# opt.json value is the reference's forced 1 (the JAX CLI's deviation)
KEEP_ON_RELOAD = ("results_root", "nms_thd", "debug", "max_pred_l", "min_pred_l", "resume",
                  "resume_all", "no_sort_results", "eval_bsz")
# opt.json fields that fix the parameter shapes: export refuses a directory
# whose opt.json records other values
_EXPORT_SHAPE_KEYS = ("variant", "hidden_dim", "enc_layers", "t2v_layers", "dummy_layers",
                      "num_dummies", "dim_feedforward", "v_feat_dim", "t_feat_dim",
                      "kernel_size", "num_conv_layers", "num_mlp_layers", "n_input_proj")


def _bool_literal(s: str) -> bool:
    v = s.lower()
    if v in ("1", "true", "yes"):
        return True
    if v in ("0", "false", "no"):
        return False
    # a bare bool flag before the positional config swallows the config name
    raise argparse.ArgumentTypeError(
        f"expected a boolean literal (true/false/1/0/yes/no), got {s!r}. "
        "If this is your config name, put bare bool flags AFTER the "
        "positional config (e.g. `cli train mypreset --debug`)."
    )


def _add_config_flags(parser: argparse.ArgumentParser) -> None:
    for f in dataclasses.fields(ExperimentConfig):
        name, t = f"--{f.name}", str(f.type)
        if f.name in ("v_feat_dirs", "v_buckets", "strides", "nce_direction"):
            parser.add_argument(name, nargs="+", default=None)
        elif t.startswith("bool"):
            # bare `--debug` (the reference's store_true) and `--debug false`
            parser.add_argument(name, nargs="?", const=True, default=None,
                                type=_bool_literal)
        elif "int" in t:
            parser.add_argument(name, type=int, default=None)
        elif "float" in t:
            parser.add_argument(name, type=float, default=None)
        else:
            parser.add_argument(name, type=str, default=None)


def parse_config(argv):
    """(config, explicit overrides, device) of a flag list."""
    # the reference's one store_false spelling (config.py:135)
    argv = [x for a in argv
            for x in (("--aux_loss", "false") if a == "--no_aux_loss" else (a,))]
    parser = argparse.ArgumentParser()
    parser.add_argument("config", help="preset name or data/MR*.py-style file")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu (the kernels' plain versions)")
    _add_config_flags(parser)
    ns = parser.parse_args(argv)

    if ns.config in PRESETS:
        cfg = from_preset(ns.config)
    elif os.path.exists(ns.config):
        cfg = apply_model_cfg(ExperimentConfig(), load_model_cfg_file(ns.config))
    else:
        raise SystemExit(f"unknown config {ns.config!r}")

    overrides = {}
    for f in dataclasses.fields(ExperimentConfig):
        v = getattr(ns, f.name, None)
        if v is None:
            continue
        if f.name in ("strides", "v_buckets"):
            v = tuple(int(x) for x in v)
        elif f.name == "nce_direction":
            v = tuple(v)
        overrides[f.name] = v
    return cfg.replace(**overrides), overrides, ns.device


def _pop_export_path(rest):
    for i, a in enumerate(rest):
        if a == "--export_path":
            if i + 1 >= len(rest):
                raise SystemExit("--export_path requires a value")
            return rest[i + 1], rest[:i] + rest[i + 2:]
        if a.startswith("--export_path="):
            return a.split("=", 1)[1], rest[:i] + rest[i + 1:]
    return None, rest


def _require_file(flag: str, path, what: str) -> None:
    if path is None:
        raise SystemExit(f"{flag} <{what}> is required")
    if not os.path.exists(path):
        raise SystemExit(f"{flag}: no such {what}: {path}")


def run_train(cfg, device) -> int:
    from flashvtg_tpu_torch.train.loop import train

    _, best_score, results_dir = train(cfg, device=device)
    if mesh.rank() == 0:
        print(f"best score {best_score:.4f}; results in {results_dir}")
    return 0


def run_infer(cfg, device) -> int:
    from flashvtg_tpu_torch.data.dataset import VTGDataset
    from flashvtg_tpu_torch.models import build_model
    from flashvtg_tpu_torch.train.infer import eval_data_config
    from flashvtg_tpu_torch.train.loop import (
        evaluate,
        load_adapter,
        load_checkpoint,
        load_model_weights,
    )
    from flashvtg_tpu_torch.utils.convert import model_state
    from flashvtg_tpu_torch.utils.runtime import resolve_device

    _require_file("--resume", cfg.resume, "checkpoint")
    _require_file("--eval_path", cfg.eval_path or None, "annotations file")
    cfg.check_ported(train=False)
    device = resolve_device(device)
    model = build_model(cfg.model_config(), device, cfg.seed)
    load_model_weights(model, model_state(load_checkpoint(cfg.resume, device)))
    if cfg.resume_adapter:  # partial preload (inference.py:447-451)
        load_adapter(cfg, model)
    dataset = VTGDataset(eval_data_config(cfg, cfg.eval_path,
                                          load_labels=cfg.eval_split_name == "val"))
    results_dir = cfg.eval_results_dir or os.path.dirname(cfg.resume) or "."
    os.makedirs(results_dir, exist_ok=True)
    metrics, metrics_nms, eval_losses = evaluate(
        cfg, model, dataset, results_dir, tag="infer", loss_cfg=cfg.loss_config()
    )
    if mesh.rank() != 0:
        return 0
    if eval_losses:
        print("eval losses:", {k: round(v, 4) for k, v in eval_losses.items()})
    if metrics is not None:
        print(dict(metrics["brief"]))
    if metrics_nms is not None:
        print("nms:", dict(metrics_nms["brief"]))
    return 0


def run_export(cfg, export_path) -> int:
    """Weights of --resume as a reference-format .ckpt at --export_path, with
    opt.json (eval_bsz=1) and model_cfg.py beside it unless an opt.json is
    there already; a directory whose opt.json records another architecture
    is refused before anything is written."""
    from flashvtg_tpu_torch.train.loop import load_checkpoint
    from flashvtg_tpu_torch.utils.convert import model_state, save_torch_checkpoint

    if cfg.resume is None or export_path is None:
        raise SystemExit("export requires --resume <checkpoint> and --export_path <out.ckpt>")
    _require_file("--resume", cfg.resume, "checkpoint")
    export_dir = os.path.dirname(os.path.abspath(export_path))
    os.makedirs(export_dir, exist_ok=True)
    opt_sidecar = os.path.join(export_dir, "opt.json")
    existing_opt = None
    if os.path.exists(opt_sidecar):
        with open(opt_sidecar) as f:
            existing_opt = json.load(f)
        mismatched = [k for k in _EXPORT_SHAPE_KEYS
                      if k in existing_opt and existing_opt[k] != getattr(cfg, k, None)]
        if mismatched:
            raise SystemExit(
                "--export_path points into a directory whose opt.json records a "
                f"different architecture ({', '.join(mismatched)} differ); export to a "
                "fresh directory instead"
            )
    ckpt = load_checkpoint(cfg.resume)
    save_torch_checkpoint(export_path, model_state(ckpt), epoch=int(ckpt.get("epoch", -1)))
    if existing_opt is None:
        cfg.save(opt_sidecar)
    else:
        with open(os.path.join(export_dir, "model_cfg.py"), "w") as f:
            f.write(emit_model_cfg(cfg))
    print(f"exported reference-format checkpoint to {export_path}")
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s.%(msecs)03d:%(levelname)s:%(name)s - %(message)s",
        datefmt="%Y-%m-%d %H:%M:%S",
    )
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    mode, rest = argv[0], argv[1:]
    if mode not in ("train", "infer", "export"):
        raise SystemExit(f"unknown mode {mode!r} (use train|infer|export)")
    export_path = None
    if mode == "export":
        export_path, rest = _pop_export_path(rest)
    cfg, overrides, device = parse_config(rest)
    if mode != "infer" and cfg.serving:
        logging.getLogger(__name__).warning(
            "--serving only affects `infer`; it is ignored for %s and is never persisted "
            "to opt.json", mode,
        )
    if mode in ("infer", "export") and cfg.resume:
        # TestOptions (config.py:189-203): the opt.json beside the checkpoint
        # restores the training-time flags, but for the keep-list; this
        # invocation's flags win over both
        opt_json = os.path.join(os.path.dirname(cfg.resume) or ".", "opt.json")
        if os.path.exists(opt_json):
            keep = {k: getattr(cfg, k) for k in KEEP_ON_RELOAD if hasattr(cfg, k)}
            cfg = ExperimentConfig.load(opt_json).replace(**{**keep, **overrides})
    if mode == "export":
        return run_export(cfg, export_path)
    if mode == "infer" and cfg.serving and "eval_precision" not in overrides:
        # the serving profile; an explicit --eval_precision wins
        cfg = cfg.replace(eval_precision="tensorfloat32")
    # under torchrun: the process group from its environment
    mesh.init_group(device=device)
    try:
        return run_train(cfg, device) if mode == "train" else run_infer(cfg, device)
    finally:
        mesh.close_group()


if __name__ == "__main__":
    sys.exit(main())
