"""The port's CLI (flashvtg_tpu_torch/cli.py, eval/cli.py) on the CPU.

  * parsing, as tests/test_cli_surface.py holds the JAX CLI: preset and
    overrides, a model-config file, bare bools, an unknown literal,
    --no_aux_loss, clean errors; --device (default cuda, which raises
    without CUDA: no fallback); `infer --serving` evaluates at
    tensorfloat32, an explicit --eval_precision wins, the other modes warn
    and ignore it, and it never reaches opt.json; `train` and `infer` at
    each precision dial;
  * `train` -> `infer --resume model_best.ckpt` prints the best epoch's
    brief metrics exactly; `export` -> `infer` from the export gives the
    same metrics; the JAX CLI's `infer` of the port's model_best.ckpt gives
    them within 0.02 points (`__graft_entry__.py:172-197`);
  * a checkpoint whose opt.json records train_precision bfloat16 (a JAX
    run's) infers, and `train --resume` of it takes this invocation's
    flags, as the JAX CLI does (the default bfloat16, or
    --train_precision float32);
  * the metric CLI: the reference's golden case (scripts/eval_sample.sh,
    when the reference checkout is present) and, on a synthetic submission,
    the same metrics file as the JAX package's metric CLI;
  * the FlashVTG_ms variant: `train tvsum_ms` at tiny widths on a synthetic
    TVSum domain, then `infer` of its model_best.ckpt prints the best
    epoch's mAP exactly, `export` -> `infer` the same, and the JAX CLI's
    `infer --resume` of the port's model_best.ckpt within 2e-4 of it.
"""

import ast
import glob
import json
import os
import pathlib

import numpy as np
import pytest
import torch

from conftest import REFERENCE_ROOT as REF
from flashvtg_tpu import cli as jax_cli
from flashvtg_tpu.eval.cli import main as jax_eval_main
from flashvtg_tpu_torch import cli
from flashvtg_tpu_torch.eval.cli import main as eval_main
from flashvtg_tpu_torch.utils.io import save_jsonl
from flashvtg_tpu_torch.utils.synthetic import make_synthetic_qvh, make_synthetic_tvsum

FIXTURES = pathlib.Path(__file__).parent / "fixtures"
SMALL = dict(v_feat_dim=40, t_feat_dim=24, hidden_dim=32, nheads=2, dim_feedforward=48,
             t2v_layers=1, enc_layers=1, dummy_layers=1, num_dummies=3, num_mlp_layers=2,
             max_q_l=8, max_v_l=24, bsz=4, eval_bsz=4)
METRIC_ATOL = 0.02


def _flags(kw):
    return [x for k, v in kw.items() for x in (f"--{k}", str(v))]


def test_parse_config_preset_and_overrides():
    cfg, overrides, device = cli.parse_config(
        ["qvhighlights_slowclip", "--bsz", "16", "--bucket_eval", "true", "--strides", "1", "2",
         "--max_es_cnt", "3", "--resume", "auto"])
    assert cfg.bsz == 16 and cfg.bucket_eval and cfg.strides == (1, 2)
    assert cfg.max_es_cnt == 3 and cfg.resume == "auto"
    assert set(overrides) == {"bsz", "bucket_eval", "strides", "max_es_cnt", "resume"}
    assert cfg.t2v_layers == 6 and cfg.dset_name == "hl"  # the preset's, where not overridden
    assert device == "cuda"
    assert cli.parse_config(["tacos", "--device", "cpu"])[2] == "cpu"


def test_parse_config_file():
    cfg, _, _ = cli.parse_config(["configs/HD.py", "--dset_name", "tvsum"])
    assert cfg.strides == (1,) and cfg.loss_cls == "dynamic_bce"
    assert cfg.dset_name == "tvsum"


def test_bare_bool_flags_parse_like_store_true():
    cfg = cli.parse_config(["qvhighlights_slowclip", "--debug"])[0]
    assert cfg.debug is True
    assert cli.parse_config(["qvhighlights_slowclip", "--debug", "false"])[0].debug is False
    cfg = cli.parse_config(["qvhighlights_slowclip", "--eval_untrained", "--bsz", "4"])[0]
    assert cfg.eval_untrained is True and cfg.bsz == 4
    assert cli.parse_config(["qvhighlights_slowclip", "--no_aux_loss"])[0].aux_loss is False


@pytest.mark.parametrize("argv", [["--debug", "qvhighlights_slowclip"],
                                  ["qvhighlights_slowclip", "--debug", "banana"],
                                  ["no_such_preset"]])
def test_bad_arguments_exit_cleanly(argv):
    with pytest.raises(SystemExit):
        cli.parse_config(argv)


def test_infer_and_export_clean_errors(tmp_path, monkeypatch, caplog):
    absent = str(tmp_path / "absent.ckpt")
    with pytest.raises(SystemExit, match="--resume"):
        cli.main(["infer", "qvhighlights_slowclip", "--device", "cpu"])
    with pytest.raises(SystemExit, match="no such checkpoint"):
        cli.main(["infer", "qvhighlights_slowclip", "--resume", absent])
    with pytest.raises(SystemExit, match="--export_path"):
        cli.main(["export", "qvhighlights_slowclip", "--resume", absent])
    with pytest.raises(SystemExit, match="requires a value"):
        cli.main(["export", "qvhighlights_slowclip", "--export_path"])
    with pytest.raises(SystemExit, match="no such checkpoint"):
        cli.main(["export", "qvhighlights_slowclip", "--resume", absent,
                  f"--export_path={tmp_path}/out.ckpt"])
    with pytest.raises(SystemExit, match="unknown mode"):
        cli.main(["serve", "qvhighlights_slowclip"])
    # --serving is no error: the tensorfloat32 eval profile, unless
    # --eval_precision is given; train and export warn and ignore it
    seen = []
    monkeypatch.setattr(cli, "run_infer", lambda cfg, device: seen.append(cfg) or 0)
    monkeypatch.setattr(cli, "run_train", lambda cfg, device: seen.append(cfg) or 0)
    for argv in (["--serving"], ["--serving", "--eval_precision", "bfloat16"], []):
        assert cli.main(["infer", "qvhighlights_slowclip", *argv]) == 0
    with caplog.at_level("WARNING"):
        assert cli.main(["train", "qvhighlights_slowclip", "--serving"]) == 0
    assert "--serving only affects `infer`" in caplog.text
    assert [c.eval_precision for c in seen] == ["tensorfloat32", "bfloat16", "float32",
                                                "float32"]
    seen[0].save(str(tmp_path / "opt.json"), reference_sidecar=False)
    with open(tmp_path / "opt.json") as f:
        assert "serving" not in json.load(f)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """`cli train` of the SMALL flagship on the CPU, 3 epochs, an eval each."""
    root = tmp_path_factory.mktemp("cli")
    ann, vdir, qdir = make_synthetic_qvh(str(root), n_queries=16, v_dim=40, t_dim=24,
                                         n_clips=24, seed=1, split="train")
    val, _, _ = make_synthetic_qvh(str(root), n_queries=8, v_dim=40, t_dim=24, n_clips=24,
                                   seed=2, split="val", min_clips=10)
    flags = _flags(dict(SMALL, v_feat_dirs=vdir, t_feat_dir=qdir, train_path=ann,
                        eval_path=val, results_root=root / "results", exp_id="cli",
                        use_tensorboard="false", device="cpu"))
    assert cli.main(["train", "qvhighlights_slowclip", *flags, "--n_epoch", "3",
                     "--eval_epoch", "1"]) == 0
    (run_dir,) = glob.glob(str(root / "results" / "*"))
    return root, flags, run_dir


def _printed_brief(out):
    """The brief dict infer prints (the line without a label)."""
    (line,) = [x for x in out.splitlines() if x.startswith("{'MR-")]
    return ast.literal_eval(line)


def _best_brief(run_dir):
    """The brief metrics of the eval that made model_best."""
    with open(os.path.join(run_dir, "model_best.state.json")) as f:
        best = json.load(f)["best_score"]
    with open(os.path.join(run_dir, "eval.log.txt")) as f:
        briefs = [json.loads(line.split("[Metrics] ", 1)[1])["brief"] for line in f]
    assert len(briefs) == 3
    (first,) = [b for b in briefs if b["MR-full-mAP"] == best][:1]
    return first


def test_train_then_infer_prints_best_epoch_metrics(run, capsys):
    root, flags, run_dir = run
    for name in ("model_best.ckpt", "model_latest.ckpt", "opt.json", "eval.log.txt",
                 "train.log.txt", "model_cfg.py", "code.zip"):
        assert os.path.isfile(os.path.join(run_dir, name)), name
    capsys.readouterr()
    assert cli.main(["infer", "qvhighlights_slowclip", *flags, "--resume",
                     os.path.join(run_dir, "model_best.ckpt")]) == 0
    assert _printed_brief(capsys.readouterr().out) == _best_brief(run_dir)


def test_export_then_infer_gives_the_same_metrics(run, capsys):
    root, flags, run_dir = run
    best = os.path.join(run_dir, "model_best.ckpt")
    exported = str(root / "export" / "model.ckpt")
    assert cli.main(["export", "qvhighlights_slowclip", *flags, "--resume", best,
                     "--export_path", exported]) == 0
    ckpt = torch.load(exported, map_location="cpu", weights_only=False)
    assert set(ckpt) == {"model", "state_dict", "epoch"}  # weights only
    assert os.path.isfile(str(root / "export" / "opt.json"))
    with open(root / "export" / "opt.json") as f:
        assert json.load(f)["eval_bsz"] == 1  # the reference's batch
    capsys.readouterr()
    assert cli.main(["infer", "qvhighlights_slowclip", *flags, "--resume", best]) == 0
    direct = _printed_brief(capsys.readouterr().out)
    assert cli.main(["infer", "qvhighlights_slowclip", *flags, "--resume", exported]) == 0
    assert _printed_brief(capsys.readouterr().out) == direct
    # a directory whose opt.json records another architecture is refused
    with pytest.raises(SystemExit, match="different architecture"):
        cli.main(["export", "qvhighlights_slowclip", *flags, "--hidden_dim", "64",
                  "--resume", best, "--export_path", exported])


def test_jax_cli_infers_the_port_checkpoint(run, capsys, tmp_path):
    root, flags, run_dir = run
    best = os.path.join(run_dir, "model_best.ckpt")
    jax_flags = [f for f in flags if f not in ("--device", "cpu")]
    capsys.readouterr()
    assert jax_cli.main(["infer", "qvhighlights_slowclip", *jax_flags, "--resume", best,
                         "--eval_results_dir", str(tmp_path)]) == 0
    got = _printed_brief(capsys.readouterr().out)
    want = _best_brief(run_dir)
    assert set(got) == set(want)
    for k, v in want.items():
        assert abs(got[k] - v) <= METRIC_ATOL, (k, got[k], v)


def test_train_resume_of_a_bfloat16_run_raises(run, capsys, tmp_path):
    """A run whose opt.json says train_precision bfloat16 (the JAX default):
    infer reads no train precision; train --resume no longer raises: it
    takes this invocation's flags, as the JAX CLI does (the preset's
    default, bfloat16, or --train_precision float32), and records them."""
    root, flags, run_dir = run
    jax_dir = tmp_path / "jax_run"
    jax_dir.mkdir()
    ckpt = str(jax_dir / "model_best.ckpt")
    with open(os.path.join(run_dir, "model_best.ckpt"), "rb") as src, open(ckpt, "wb") as dst:
        dst.write(src.read())
    with open(os.path.join(run_dir, "opt.json")) as f:
        opt = json.load(f)
    opt["train_precision"] = "bfloat16"
    with open(jax_dir / "opt.json", "w") as f:
        json.dump(opt, f)
    assert cli.main(["infer", "qvhighlights_slowclip", *flags, "--resume", ckpt]) == 0
    for root, extra, want in ((tmp_path / "bf16", [], "bfloat16"),
                              (tmp_path / "f32", ["--train_precision", "float32"], "float32")):
        assert cli.main(["train", "qvhighlights_slowclip", *flags, "--resume", ckpt,
                         "--n_epoch", "1", "--results_root", str(root), *extra]) == 0
        (resumed,) = glob.glob(str(root / "*"))
        with open(os.path.join(resumed, "opt.json")) as f:
            assert json.load(f)["train_precision"] == want


@pytest.mark.parametrize("mode", ["float32", "tensorfloat32", "bfloat16"])
def test_train_and_infer_at_each_precision(run, tmp_path, capsys, mode):
    """`cli train` for one epoch at train_precision = eval_precision = `mode`
    (bfloat16 with the bf16 wire) records the dials in opt.json, and `cli
    infer --eval_precision <mode>` of its model_latest.ckpt prints finite
    brief metrics."""
    _, flags, _ = run
    wire = "bfloat16" if mode == "bfloat16" else "float32"
    dials = ["--train_precision", mode, "--eval_precision", mode, "--transfer_dtype", wire]
    assert cli.main(["train", "qvhighlights_slowclip", *flags, "--n_epoch", "1",
                     "--results_root", str(tmp_path), *dials]) == 0
    (run_dir,) = glob.glob(str(tmp_path / "*"))
    with open(os.path.join(run_dir, "opt.json")) as f:
        opt = json.load(f)
    assert (opt["train_precision"], opt["eval_precision"], opt["transfer_dtype"]) == (
        mode, mode, wire)
    capsys.readouterr()
    assert cli.main(["infer", "qvhighlights_slowclip", *flags, "--eval_precision", mode,
                     "--resume", os.path.join(run_dir, "model_latest.ckpt")]) == 0
    brief = _printed_brief(capsys.readouterr().out)
    assert brief and all(np.isfinite(v) for v in brief.values())


def test_default_device_is_the_card(run):
    """--device defaults to cuda: without CUDA the CLI raises, it does not
    move to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    root, flags, run_dir = run
    no_device = [f for f in flags if f not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["infer", "qvhighlights_slowclip", *no_device, "--resume",
                  os.path.join(run_dir, "model_best.ckpt")])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["train", "qvhighlights_slowclip", *no_device, "--n_epoch", "1"])


@pytest.mark.skipif(not (REF / "standalone_eval/sample_val_preds.jsonl").exists(),
                    reason="reference fixtures absent")
def test_eval_cli_golden(tmp_path):
    out = tmp_path / "metrics.json"
    eval_main(["--submission_path", str(REF / "standalone_eval/sample_val_preds.jsonl"),
               "--gt_path", str(REF / "data/highlight_val_release.jsonl"),
               "--save_path", str(out), "--not_verbose"])
    with open(FIXTURES / "sample_val_preds_metrics_expected.json") as f:
        assert json.load(open(out))["brief"] == json.load(f)["brief"]


def test_eval_cli_matches_jax_on_a_synthetic_submission(tmp_path):
    ann, _, _ = make_synthetic_qvh(str(tmp_path), n_queries=24, v_dim=4, t_dim=4,
                                   n_clips=30, seed=3)
    rows = [json.loads(line) for line in open(ann)]
    rng = np.random.default_rng(0)
    sub = []
    for r in rows:
        starts = rng.uniform(0, r["duration"] - 4, 10)
        wins = [[round(s, 2), round(s + rng.uniform(2, 20), 2), round(rng.uniform(), 4)]
                for s in starts]
        sal = [round(float(x), 4) for x in rng.standard_normal(int(r["duration"] // 2))]
        sub.append(dict(qid=r["qid"], query=r["query"], vid=r["vid"],
                        pred_relevant_windows=wins, pred_saliency_scores=sal))
    sub_path = str(tmp_path / "sub.jsonl")
    save_jsonl(sub, sub_path)
    ours, ref = tmp_path / "ours.json", tmp_path / "ref.json"
    eval_main(["--submission_path", sub_path, "--gt_path", ann, "--save_path", str(ours),
               "--not_verbose"])
    jax_eval_main(["--submission_path", sub_path, "--gt_path", ann, "--save_path", str(ref),
                   "--not_verbose"])
    assert ours.read_text() == ref.read_text()
    assert json.loads(ours.read_text())["brief"]["MR-full-mAP"] > 0


def test_eval_cli_missing_file_clean_error(tmp_path):
    with pytest.raises(SystemExit, match="no such file"):
        eval_main(["--submission_path", str(tmp_path / "absent.jsonl"),
                   "--gt_path", str(tmp_path / "absent_gt.jsonl"),
                   "--save_path", str(tmp_path / "out.json")])


MS_SMALL = dict(v_feat_dim=24, t_feat_dim=16, hidden_dim=32, nheads=4, dim_feedforward=48,
                num_dummies=2, t2v_layers=1, enc_layers=1, dummy_layers=1, num_conv_layers=1,
                num_mlp_layers=2, num_phrase=2, phrase_layers=1, context_layers=1, rank=2,
                t_sa=1, max_q_l=8, max_v_l=40, bsz=2, eval_bsz=2, dset_domain="BK")


@pytest.fixture(scope="module")
def ms_run(tmp_path_factory):
    """`cli train tvsum_ms` on the CPU at tiny widths: 4 train and 2 val
    videos of one domain, 2 epochs, an eval each."""
    root = tmp_path_factory.mktemp("cli_ms")
    kw = dict(v_dim=24, t_dim=16, min_clips=20, max_clips=40, max_q_tokens=9)
    ann, vdir, qdir = make_synthetic_tvsum(str(root), n_queries=4, seed=1, split="train", **kw)
    val, _, _ = make_synthetic_tvsum(str(root), n_queries=2, seed=2, split="val", **kw)
    flags = _flags(dict(MS_SMALL, v_feat_dirs=vdir, t_feat_dir=qdir, train_path=ann,
                        eval_path=val, results_root=root / "results", exp_id="ms",
                        use_tensorboard="false", device="cpu"))
    assert cli.main(["train", "tvsum_ms", *flags, "--n_epoch", "2"]) == 0
    (run_dir,) = glob.glob(str(root / "results" / "*"))
    return root, flags, run_dir


def _printed_map(out):
    (line,) = [x for x in out.splitlines() if x.startswith("{'mAP'")]
    return ast.literal_eval(line)["mAP"]


def _best_map(run_dir):
    with open(os.path.join(run_dir, "model_best.state.json")) as f:
        best = json.load(f)["best_score"]
    with open(os.path.join(run_dir, "eval.log.txt")) as f:
        maps = [json.loads(line.split("[Metrics] ", 1)[1])["brief"]["mAP"] for line in f]
    assert len(maps) == 2 and best in maps and 0 < best <= 1
    return best


def test_ms_train_infer_export(ms_run, capsys, tmp_path):
    root, flags, run_dir = ms_run
    with open(os.path.join(run_dir, "opt.json")) as f:
        opt = json.load(f)
    assert (opt["variant"], opt["num_phrase"], opt["rank"]) == ("ms", 2, 2)
    best = os.path.join(run_dir, "model_best.ckpt")
    sd = torch.load(best, map_location="cpu", weights_only=False)["model"]
    assert "phrase_generate.learnable_phrase" in sd and "conf_head.fc.layers.0.weight" not in sd
    capsys.readouterr()
    assert cli.main(["infer", "tvsum_ms", *flags, "--resume", best]) == 0
    assert _printed_map(capsys.readouterr().out) == _best_map(run_dir)
    exported = str(root / "export" / "model.ckpt")
    assert cli.main(["export", "tvsum_ms", *flags, "--resume", best,
                     "--export_path", exported]) == 0
    capsys.readouterr()
    assert cli.main(["infer", "tvsum_ms", *flags, "--resume", exported]) == 0
    assert _printed_map(capsys.readouterr().out) == _best_map(run_dir)
    # a core-variant infer of the ms checkpoint is refused by name
    with pytest.raises(ValueError, match="'ms' weights"):
        cli.main(["infer", "tvsum_ms", *flags, "--variant", "core", "--resume", best])
    jax_flags = [f for f in flags if f not in ("--device", "cpu")]
    assert jax_cli.main(["infer", "tvsum_ms", *jax_flags, "--resume", best,
                         "--eval_results_dir", str(tmp_path)]) == 0
    assert abs(_printed_map(capsys.readouterr().out) - _best_map(run_dir)) <= 2e-4
