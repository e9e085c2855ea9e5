"""The port's checkpoints and opt.json vs the JAX package, on the CPU.

  * save_checkpoint / load_checkpoint round trip of the model, AdamW's
    state, the StepLR scheduler, the epoch, opt (a plain dict) and the
    `<name>.state.json` best score: equal;
  * merge_partial_params / load_adapter: entries whose name and shape match
    are copied, mismatched ones kept, unknown ones dropped, and counted;
  * find_auto_resume: scoped to the experiment and the parameter shapes,
    the newest checkpoint wins (as tests/test_resume_auto.py for JAX);
  * interchange both ways through the reference `.ckpt`: a JAX `cli export`
    file loads into the port, and a port model_best.ckpt through the JAX
    package's load_torch_checkpoint, each giving the other's forward within
    2e-4 (saliency) / 3e-4 (logits, coordinates), the tolerances of
    tests/test_torch_model.py;
  * opt.json: both packages' `save` give the same keys and values and the
    same model_cfg.py for the same flags (train_precision included, whose
    default is bfloat16 in both since the precision dials were ported), and
    each `load`s the other's file;
  * the FlashVTG_ms variant: a JAX `cli export` of a tvsum_ms checkpoint
    loads into the port's FlashVTGMSModel with strict=True and gives the
    JAX forward; a port ms checkpoint goes through the JAX package's
    load_torch_checkpoint (its phrase-key variant detection) to the port's
    forward; the core model refuses ms weights by name; an ms opt.json
    (variant, num_phrase, use_dfl, use_eos) round-trips both ways.
"""

import dataclasses
import json
import logging
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch_threads  # noqa: F401  (torch's share of the cores under xdist)
import torch

from flashvtg_tpu import cli as jax_cli
from flashvtg_tpu.models.flashvtg import FlashVTGModel as JaxModel
from flashvtg_tpu.models.flashvtg_ms import FlashVTGMSModel as JaxMSModel
from flashvtg_tpu.train.config import ExperimentConfig as JaxConfig
from flashvtg_tpu.train.config import from_preset as jax_preset
from flashvtg_tpu.train.loop import save_checkpoint as jax_save_checkpoint
from flashvtg_tpu.utils.torch_convert import load_torch_checkpoint as jax_load_ckpt
from flashvtg_tpu_torch.models import build_model
from flashvtg_tpu_torch.models.points import pyramid_masks_strict
from flashvtg_tpu_torch.train.config import ExperimentConfig, from_preset
from flashvtg_tpu_torch.train.loop import (
    find_auto_resume,
    load_adapter,
    load_checkpoint,
    load_model_weights,
    make_optimizer,
    merge_partial_params,
    save_checkpoint,
    state_sidecar,
)
from flashvtg_tpu_torch.utils.convert import load_torch_checkpoint

SMALL = dict(
    v_feat_dim=40, t_feat_dim=24, t2v_layers=2, enc_layers=2, dummy_layers=1,
    num_dummies=4, hidden_dim=64, dim_feedforward=96, num_mlp_layers=2, max_v_l=16,
    max_q_l=8,
)
B = 3
V_LENS, Q_LENS = (16, 11, 5), (8, 5, 3)


def _inputs(cfg, seed=0):
    rng = np.random.default_rng(seed)
    lv, lq = cfg.max_v_l, cfg.max_q_l
    txt_mask = (np.arange(lq)[None] < np.asarray(Q_LENS)[:, None]).astype(np.float32)
    vid_mask = (np.arange(lv)[None] < np.asarray(V_LENS)[:, None]).astype(np.float32)
    src_txt = rng.standard_normal((B, lq, cfg.t_feat_dim), dtype=np.float32) * txt_mask[..., None]
    src_vid = (rng.standard_normal((B, lv, cfg.total_v_feat_dim), dtype=np.float32)
               * vid_mask[..., None])
    strict = pyramid_masks_strict(np.asarray(V_LENS), lv, cfg.strides)[0]
    return (src_txt, txt_mask, src_vid, vid_mask), strict


def _jax_forward(jcfg, params, arrs, strict):
    model = JaxModel(jcfg.model_config())
    return model.apply(params, *map(jnp.asarray, arrs), point_valid=jnp.asarray(strict),
                       train=False)


def _port_forward(model, arrs, strict):
    with torch.no_grad():
        return model(*map(torch.from_numpy, arrs), point_valid=torch.from_numpy(strict))


def _assert_forward_close(tout, jout, vid_mask):
    vm = vid_mask > 0
    np.testing.assert_allclose(tout["saliency_scores"].numpy()[vm],
                               np.asarray(jout["saliency_scores"])[vm], atol=2e-4)
    for key in ("out_class", "out_coord"):
        np.testing.assert_allclose(tout[key].numpy(), np.asarray(jout[key]), atol=3e-4,
                                   rtol=1e-5, err_msg=key)


def _stepped(cfg, steps=3, seed=0):
    """A model, AdamW and StepLR after `steps` updates on random gradients."""
    model = build_model(cfg.model_config(), "cpu", seed).train()
    optimizer, scheduler = make_optimizer(cfg, model.parameters(), steps_per_epoch=1)
    g = torch.Generator().manual_seed(seed)
    for _ in range(steps):
        for p in model.parameters():
            p.grad = torch.randn(p.shape, generator=g)
        optimizer.step()
        scheduler.step()
    return model, optimizer, scheduler


def _assert_nested_equal(a, b, path="state"):
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and torch.equal(a, b), path
    elif isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _assert_nested_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_nested_equal(x, y, f"{path}[{i}]")
    else:
        assert a == b, (path, a, b)


def test_checkpoint_round_trip(tmp_path):
    cfg = from_preset("qvhighlights_slowclip", **SMALL, lr_drop=2)
    model, optimizer, scheduler = _stepped(cfg)
    path = str(tmp_path / "model_best.ckpt")
    save_checkpoint(path, model, optimizer, scheduler, 7, cfg, best_score=12.5)

    assert sorted(os.listdir(tmp_path)) == ["model_best.ckpt", "model_best.state.json",
                                            "model_cfg.py", "opt.json"]
    with open(state_sidecar(path)) as f:
        assert json.load(f) == {"best_score": 12.5}
    ckpt = load_checkpoint(path)
    assert ckpt["epoch"] == 7
    assert ckpt["opt"] == dataclasses.asdict(cfg)  # a plain dict, not a pickled object
    assert ExperimentConfig.load(str(tmp_path / "opt.json")) == cfg.replace(
        v_buckets=list(cfg.v_buckets), strides=list(cfg.strides),
        nce_direction=list(cfg.nce_direction), v_feat_dirs=list(cfg.v_feat_dirs),
        eval_bsz=1,
    )

    fresh, opt2, sched2 = _stepped(cfg, steps=0, seed=1)
    load_model_weights(fresh, load_torch_checkpoint(path))
    opt2.load_state_dict(ckpt["optimizer"])
    sched2.load_state_dict(ckpt["lr_scheduler"])
    _assert_nested_equal(model.state_dict(), fresh.state_dict())
    _assert_nested_equal(optimizer.state_dict(), opt2.state_dict())
    assert sched2.state_dict() == scheduler.state_dict()
    assert sched2.get_last_lr() == scheduler.get_last_lr() == [cfg.lr * cfg.lr_gamma]
    # the reference's `module.`-prefixed pretrain branch reads the same weights
    assert {f"module.{k}" for k in ckpt["model"]} == set(ckpt["state_dict"])


def test_mismatched_checkpoint_leaves_model_as_it_was(tmp_path):
    cfg = from_preset("qvhighlights_slowclip", **SMALL)
    other = build_model(cfg.replace(num_mlp_layers=3).model_config(), "cpu", 1)
    path = str(tmp_path / "x.ckpt")
    torch.save({"model": other.state_dict()}, path)
    model = build_model(cfg.model_config(), "cpu", 0)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with pytest.raises(ValueError, match="does not fit"):
        load_model_weights(model, load_torch_checkpoint(path))
    _assert_nested_equal(before, model.state_dict())
    with pytest.raises(ValueError, match="orbax"):
        load_checkpoint(str(tmp_path))


def test_merge_partial_params_matching_and_mismatched(caplog):
    params = {"a": torch.zeros(2, 2), "b.w": torch.zeros(3), "b.extra": torch.zeros(4)}
    loaded = {
        "a": torch.ones(2, 2, dtype=torch.float64),  # name + shape match -> copied
        "b.w": torch.ones(5),  # shape mismatch -> kept
        "unknown": torch.ones(7),  # absent from params -> dropped
    }
    with caplog.at_level(logging.INFO):
        merged = merge_partial_params(params, loaded)
    assert set(merged) == set(params)
    assert torch.equal(merged["a"], torch.ones(2, 2)) and merged["a"].dtype == torch.float32
    assert torch.equal(merged["b.w"], torch.zeros(3))
    assert torch.equal(merged["b.extra"], torch.zeros(4))
    assert "copied 1 leaves, skipped 1" in caplog.text


def test_load_adapter_takes_matching_entries(tmp_path):
    cfg = from_preset("qvhighlights_slowclip", **SMALL)
    src = build_model(cfg.replace(num_mlp_layers=3).model_config(), "cpu", 1)
    path = str(tmp_path / "adapter.ckpt")
    torch.save({"model": src.state_dict()}, path)
    model = build_model(cfg.model_config(), "cpu", 0)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    load_adapter(cfg.replace(resume_adapter=path), model)
    src_sd = src.state_dict()
    n_copied = 0
    for k, v in model.state_dict().items():
        if k in src_sd and src_sd[k].shape == v.shape:
            assert torch.equal(v, src_sd[k]), k
            n_copied += 1
        else:
            assert torch.equal(v, before[k]), k
    assert 0 < n_copied < len(before)


def _fake_run(root, name, age_s=0.0, **opt):
    d = root / name
    d.mkdir(parents=True)
    ckpt = d / "model_latest.ckpt"
    ckpt.write_bytes(b"")
    cfg = ExperimentConfig(**opt)
    cfg.save(str(d / "opt.json"))
    t = time.time() + age_s
    os.utime(ckpt, (t, t))
    return str(ckpt)


AUTO_CASES = {
    # name: (runs as (dir, age s, opt fields), the config, the expected dir)
    "other_exp_id_ignored": ([("other", 100, dict(exp_id="other")),
                              ("mine", 0, dict(exp_id="mine"))],
                             dict(exp_id="mine"), "mine"),
    "newest_wins": ([("mine-old", -100, dict(exp_id="mine")),
                     ("mine-new", 0, dict(exp_id="mine"))],
                    dict(exp_id="mine"), "mine-new"),
    "changed_hidden_dim_skipped": ([("stale", 0, dict(exp_id="mine", hidden_dim=128))],
                                   dict(exp_id="mine", hidden_dim=256), None),
    "changed_head_flag_skipped": ([("stale", 0, dict(exp_id="mine", kernel_size=5))],
                                  dict(exp_id="mine", kernel_size=3), None),
    "other_dset_ignored": ([("tacos", 0, dict(exp_id="mine", dset_name="tacos"))],
                           dict(exp_id="mine"), None),
}


@pytest.mark.parametrize("case", list(AUTO_CASES))
def test_find_auto_resume_scoping(tmp_path, case):
    runs, mine, want = AUTO_CASES[case]
    root = tmp_path / "results"
    for name, age, opt in runs:
        _fake_run(root, name, age, **opt)
    (root / "no-opt").mkdir()
    (root / "no-opt" / "model_latest.ckpt").write_bytes(b"")  # skipped, not crashed on
    got = find_auto_resume(ExperimentConfig(results_root=str(root), **mine))
    assert got == (None if want is None else str(root / want / "model_latest.ckpt"))


@pytest.fixture(scope="module")
def jax_params():
    jcfg = jax_preset("qvhighlights_slowclip", **SMALL)
    lv, lq = jcfg.max_v_l, jcfg.max_q_l
    params = jax.jit(JaxModel(jcfg.model_config()).init, static_argnames="train")(
        {"params": jax.random.PRNGKey(3)},
        jnp.zeros((1, lq, jcfg.t_feat_dim)), jnp.ones((1, lq)),
        jnp.zeros((1, lv, jcfg.total_v_feat_dim)), jnp.ones((1, lv)), train=False,
    )
    return jcfg, jax.tree.map(np.asarray, params)


def test_jax_export_loads_into_the_port(tmp_path, jax_params):
    """The JAX CLI's export of a JAX checkpoint -> the port's strict load:
    the port's forward gives the JAX model's."""
    jcfg, params = jax_params
    ckpt_dir = str(tmp_path / "run" / "model_best")
    jax_save_checkpoint(ckpt_dir, params, {}, 2, jcfg)
    exported = str(tmp_path / "export" / "model.ckpt")
    assert jax_cli.main(["export", "qvhighlights_slowclip", *_flags(SMALL), "--resume", ckpt_dir,
                         "--export_path", exported]) == 0
    cfg = from_preset("qvhighlights_slowclip", **SMALL)
    model = build_model(cfg.model_config(), "cpu", 0)
    load_model_weights(model, model_state_of(exported))
    arrs, strict = _inputs(cfg)
    _assert_forward_close(_port_forward(model, arrs, strict),
                          _jax_forward(jcfg, params, arrs, strict), arrs[3])


def model_state_of(path):
    ckpt = load_checkpoint(path)
    assert ckpt["epoch"] == 2
    return load_torch_checkpoint(path)


def _flags(kw):
    return [x for k, v in kw.items() for x in (f"--{k}", str(v))]


def test_port_checkpoint_loads_into_jax(tmp_path):
    """A port model_best.ckpt (optimizer state and all) through the JAX
    package's load_torch_checkpoint: the JAX forward gives the port's."""
    cfg = from_preset("qvhighlights_slowclip", **SMALL)
    model, optimizer, scheduler = _stepped(cfg, steps=2, seed=5)
    model.eval()
    path = str(tmp_path / "model_best.ckpt")
    save_checkpoint(path, model, optimizer, scheduler, 1, cfg, best_score=3.0)
    jcfg = jax_preset("qvhighlights_slowclip", **SMALL)
    params = jax_load_ckpt(path, jcfg.model_config())
    arrs, strict = _inputs(cfg, seed=1)
    _assert_forward_close(_port_forward(model, arrs, strict),
                          _jax_forward(jcfg, params, arrs, strict), arrs[3])


OPT_CASES = {
    "flagship_defaults": ("qvhighlights_slowclip", {}),
    "tacos_f32_train": ("tacos", dict(train_precision="float32", exp_id="t", bsz=8,
                                      v_feat_dirs=("a", "b"), resume="x.ckpt")),
    "tvsum_hd": ("tvsum", dict(dset_domain="BK", nce_direction=("row",), eval_untrained=True)),
    "qfl_loss": ("qvhighlights", dict(loss_qfl=True, strides=(1, 2))),
    "tvsum_ms_dfl_eos": ("tvsum_ms", dict(dset_domain="BK", num_phrase=4, use_dfl=True,
                                          use_eos=True, eos_first=True)),
}


def _normalised(d):
    return {k: list(v) if isinstance(v, tuple) else v for k, v in d.items()}


@pytest.mark.parametrize("case", list(OPT_CASES))
def test_opt_json_interchange(tmp_path, case):
    preset, flags = OPT_CASES[case]
    ours, ref = from_preset(preset, **flags), jax_preset(preset, **flags)
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    ours.save(str(tmp_path / "port" / "opt.json"))
    ref.save(str(tmp_path / "jax" / "opt.json"))
    with open(tmp_path / "port" / "opt.json") as f:
        port_json = json.load(f)
    with open(tmp_path / "jax" / "opt.json") as f:
        jax_json = json.load(f)
    assert list(port_json) == list(jax_json)  # same keys, same order
    differ = {k for k in port_json if port_json[k] != jax_json[k]}
    # results_dir and config name each file's own directory
    assert differ - {"results_dir", "config"} == set()
    assert (tmp_path / "port" / "model_cfg.py").read_text() == (
        tmp_path / "jax" / "model_cfg.py").read_text()

    # each package loads the other's file, field for field
    port_from_jax = ExperimentConfig.load(str(tmp_path / "jax" / "opt.json"))
    jax_from_port = JaxConfig.load(str(tmp_path / "port" / "opt.json"))
    assert _normalised(dataclasses.asdict(port_from_jax)) == _normalised(
        {**dataclasses.asdict(ref), "eval_bsz": 1})
    assert _normalised(dataclasses.asdict(jax_from_port)) == _normalised(
        {**dataclasses.asdict(ours), "eval_bsz": 1})


MS_SMALL = dict(v_feat_dim=24, t_feat_dim=16, hidden_dim=32, nheads=4, dim_feedforward=48,
                num_dummies=2, t2v_layers=1, enc_layers=1, dummy_layers=1, num_conv_layers=1,
                num_mlp_layers=2, num_phrase=2, phrase_layers=1, context_layers=1, rank=2,
                t_sa=1, max_q_l=8, max_v_l=40)
MS_V_LENS = (40, 23, 9)


def _ms_forward_pair(jcfg, params, model, seed):
    """(port, JAX) eval outputs of one ragged tvsum_ms batch."""
    rng = np.random.default_rng(seed)
    lv, lq = jcfg.max_v_l, jcfg.max_q_l
    vid_mask = (np.arange(lv)[None] < np.asarray(MS_V_LENS)[:, None]).astype(np.float32)
    txt_mask = (np.arange(lq)[None] < np.asarray(Q_LENS)[:, None]).astype(np.float32)
    arrs = (rng.standard_normal((B, lq, jcfg.t_feat_dim), dtype=np.float32) * txt_mask[..., None],
            txt_mask,
            rng.standard_normal((B, lv, jcfg.total_v_feat_dim), dtype=np.float32)
            * vid_mask[..., None],
            vid_mask)
    jout = JaxMSModel(jcfg.ms_model_config()).apply(params, *map(jnp.asarray, arrs),
                                                     train=False)
    with torch.no_grad():
        tout = model(*map(torch.from_numpy, arrs))
    return tout, jout, vid_mask


def test_jax_ms_export_loads_into_the_port(tmp_path):
    """The JAX CLI's export of a JAX tvsum_ms checkpoint -> the port's
    strict load: the port's forward gives the JAX model's; the core model
    refuses the file by name."""
    jcfg = jax_preset("tvsum_ms", **MS_SMALL)
    lv, lq = jcfg.max_v_l, jcfg.max_q_l
    params = jax.tree.map(np.asarray, jax.jit(jcfg.build_model().init, static_argnames="train")(
        {"params": jax.random.PRNGKey(4)},
        jnp.zeros((1, lq, jcfg.t_feat_dim)), jnp.ones((1, lq)),
        jnp.zeros((1, lv, jcfg.total_v_feat_dim)), jnp.ones((1, lv)), train=False,
    ))
    ckpt_dir = str(tmp_path / "run" / "model_best")
    jax_save_checkpoint(ckpt_dir, params, {}, 2, jcfg)
    exported = str(tmp_path / "export" / "model.ckpt")
    assert jax_cli.main(["export", "tvsum_ms", *_flags(MS_SMALL), "--resume", ckpt_dir,
                         "--export_path", exported]) == 0
    cfg = from_preset("tvsum_ms", **MS_SMALL)
    model = build_model(cfg.model_config(), "cpu", 0)
    load_model_weights(model, model_state_of(exported))
    tout, jout, vid_mask = _ms_forward_pair(jcfg, params, model, seed=2)
    _assert_forward_close(tout, jout, vid_mask)
    core = build_model(cfg.replace(variant="core").model_config(), "cpu", 0)
    with pytest.raises(ValueError, match="'ms' weights"):
        load_model_weights(core, load_torch_checkpoint(exported))


def test_port_ms_checkpoint_loads_into_jax(tmp_path):
    """A port ms model_best.ckpt (optimizer state and all) through the JAX
    package's load_torch_checkpoint, which takes the ms branch by the
    phrase keys: the JAX forward gives the port's."""
    cfg = from_preset("tvsum_ms", **MS_SMALL)
    model = build_model(cfg.model_config(), "cpu", 5).train()
    optimizer, scheduler = make_optimizer(cfg, model.parameters(), steps_per_epoch=1)
    g = torch.Generator().manual_seed(5)
    for p in model.parameters():
        p.grad = torch.randn(p.shape, generator=g) * 1e-2
    optimizer.step()
    scheduler.step()
    model.eval()
    path = str(tmp_path / "model_best.ckpt")
    save_checkpoint(path, model, optimizer, scheduler, 1, cfg, best_score=0.5)
    jcfg = jax_preset("tvsum_ms", **MS_SMALL)
    params = jax_load_ckpt(path, jcfg.ms_model_config())
    assert "phrase_generate" in params["params"]
    tout, jout, vid_mask = _ms_forward_pair(jcfg, params, model, seed=3)
    _assert_forward_close(tout, jout, vid_mask)
