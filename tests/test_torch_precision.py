"""The precision dials (eval_precision, train_precision, --serving,
transfer_dtype) on the CPU, against the JAX package.

JAX's CPU runs every matmul-precision mode in f32 (tests/test_eval_precision.py
says so); the port's CPU runs each mode's arithmetic: bf16 autocast for the
GEMMs and convs at bfloat16, and the attention kernels' plain versions
rounding their operands as the kernel forms do (TF32 at tensorfloat32, bf16 at
bfloat16; the CPU has no TF32 GEMM). So each mode of the port is held against
the JAX float32 run with the mode's own tolerance:
  * forward outputs (saliency, t2vattnvalues, attn_weights, out_class,
    out_coord), each max |port - JAX| over max(max |JAX|, 0.1): FWD_RTOL;
  * run_mr_inference: saliency rows within FWD_RTOL of the largest saliency,
    MR metrics within 0.1 points (tests/test_eval_precision.py's gate) at
    float32 and tensorfloat32; at bfloat16 within 0.5 points: the port's
    CPU run is bf16 where JAX's is f32, and one decoded window's rank
    changes on this set (0.15 points of MR-full-mAP, measured);
    run_hl_inference on both HD presets: the mAP within HD_MAP_ATOL;
  * one train step (make_train_step, every dropout 0, unclipped) from the
    JAX init against JAX value_and_grad in float32: the total loss within
    STEP_LOSS_RTOL, the gradients (|g - g_jax| / |g_jax| over every
    parameter) within STEP_GRAD_RTOL;
  * train() and the eval step at each mode end to end;
  * matmul_precision restores the TF32 flags, the kernel form and autocast,
    also after an exception; an unknown mode raises;
  * transfer_dtype bfloat16 narrows the features bit for bit as the JAX
    loop's astype(bfloat16) (ml_dtypes, through JAX; the port uses torch);
  * the LGI attention's softmax stays float32 and finite under bf16
    autocast, the -inf mask included.
The measured figures are in ROADMAP.md ("Known differences").
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch_threads  # noqa: F401  (torch's share of the cores under xdist)
import torch

from flashvtg_tpu.data.dataset import VTGDataset as JaxDataset
from flashvtg_tpu.eval.metrics import eval_submission as jax_eval
from flashvtg_tpu.losses.criterion import compute_losses as jax_compute_losses
from flashvtg_tpu.losses.criterion import weighted_total as jax_weighted_total
from flashvtg_tpu.models.flashvtg import FlashVTGModel as JaxModel
from flashvtg_tpu.train import infer as jax_infer
from flashvtg_tpu.train.config import from_preset as jax_preset
from flashvtg_tpu.train.loop import _dataset_cfg
from flashvtg_tpu_torch.data.collate import MODEL_KEYS, Collator
from flashvtg_tpu_torch.data.dataset import VTGDataset
from flashvtg_tpu_torch.eval.metrics import eval_submission
from flashvtg_tpu_torch.models.flashvtg import FlashVTGModel
from flashvtg_tpu_torch.models.lgi import MHACore
from flashvtg_tpu_torch.models.points import pyramid_masks_strict
from flashvtg_tpu_torch.train.config import from_preset
from flashvtg_tpu_torch.train.infer import (
    eval_data_config,
    make_eval_step,
    run_hl_inference,
    run_mr_inference,
)
from flashvtg_tpu_torch.train.loop import (
    make_optimizer,
    make_train_step,
    place_batch,
    train,
    train_data_config,
)
from flashvtg_tpu_torch.utils.convert import state_dict_from_jax
from flashvtg_tpu_torch.utils.runtime import (
    PRECISIONS,
    float32_outputs,
    kernel_form,
    matmul_precision,
)
from flashvtg_tpu_torch.utils.synthetic import make_synthetic_qvh, make_synthetic_tvsum

SMALL = dict(
    v_feat_dim=48, t_feat_dim=32, t2v_layers=2, enc_layers=2,
    dummy_layers=1, num_dummies=4, hidden_dim=64, dim_feedforward=128,
    num_mlp_layers=2, max_v_l=24, max_q_l=10, eval_bsz=8, nms_thd=0.7,
)
N_QUERIES = 22
FWD_RTOL = {"float32": 1e-4, "tensorfloat32": 2e-3, "bfloat16": 3e-2}
METRIC_ATOL = {"float32": 0.1, "tensorfloat32": 0.1, "bfloat16": 0.5}
HD_MAP_ATOL = {"float32": 2e-4, "tensorfloat32": 1e-3, "bfloat16": 2e-2}
STEP_LOSS_RTOL = {"float32": 1e-5, "tensorfloat32": 1e-4, "bfloat16": 1e-2}
STEP_GRAD_RTOL = {"float32": 1e-4, "tensorfloat32": 2e-3, "bfloat16": 5e-2}
FORWARD_KEYS = ("saliency_scores", "t2vattnvalues", "attn_weights", "out_class", "out_coord")


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 0.1)


def _jax_init(jcfg, key=1):
    jmodel = jcfg.build_model()
    lv, lq = jcfg.max_v_l, jcfg.max_q_l
    params = jax.jit(jmodel.init, static_argnames="train")(
        {"params": jax.random.PRNGKey(key)},
        jnp.zeros((1, lq, jcfg.t_feat_dim)), jnp.ones((1, lq)),
        jnp.zeros((1, lv, jcfg.total_v_feat_dim)), jnp.ones((1, lv)), train=False,
    )
    return jmodel, params


def _port_model(cfg, params, model_cfg=None):
    model_cfg = model_cfg or cfg.model_config()
    model = FlashVTGModel(model_cfg).eval()
    model.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, params), model_cfg),
                          strict=True)
    return model


@pytest.fixture(scope="module")
def mr(tmp_path_factory):
    """One synthetic QVH-format set, the JAX init and the port model with
    its weights, and the JAX run_mr_inference at each mode."""
    root = str(tmp_path_factory.mktemp("mr"))
    ann, vdir, qdir = make_synthetic_qvh(root, n_queries=N_QUERIES, v_dim=48, t_dim=32,
                                         n_clips=24, min_clips=6, seed=3)
    data = dict(eval_path=ann, train_path=ann, v_feat_dirs=(vdir,), t_feat_dir=qdir)
    jcfg = jax_preset("qvhighlights_slowclip", **SMALL, **data, device_feed="off")
    jmodel, params = _jax_init(jcfg)
    jds = JaxDataset(_dataset_cfg(jcfg, ann, load_labels=False))
    jax_runs = {mode: jax_infer.run_mr_inference(jcfg.replace(eval_precision=mode), jmodel,
                                                 params, jds)
                for mode in PRECISIONS}
    cfg = from_preset("qvhighlights_slowclip", **SMALL, **data)
    return dict(cfg=cfg, jcfg=jcfg, jmodel=jmodel, params=params, model=_port_model(cfg, params),
                ds=VTGDataset(eval_data_config(cfg, ann)), jax_runs=jax_runs, ann=ann)


@pytest.mark.parametrize("mode", PRECISIONS)
def test_forward_at_each_precision_matches_jax(mr, mode):
    cfg, ds = mr["cfg"], mr["ds"]
    batch = Collator(cfg.max_q_l, cfg.v_buckets, cfg.max_v_l)([ds[i] for i in range(8)])
    strict = pyramid_masks_strict(batch["valid_v_lens"], cfg.max_v_l, cfg.strides)[0]
    assert batch["valid_v_lens"].min() < cfg.max_v_l  # padded rows are in
    with torch.no_grad(), matmul_precision(mode, "cpu"):
        out = mr["model"](*(torch.from_numpy(batch[k]) for k in MODEL_KEYS),
                          point_valid=torch.from_numpy(strict))
    out = float32_outputs(out)
    with jax.default_matmul_precision(mode):
        ref = mr["jmodel"].apply(mr["params"], *(jnp.asarray(batch[k]) for k in MODEL_KEYS),
                                 point_valid=jnp.asarray(strict), train=False)
    for key in FORWARD_KEYS:
        assert out[key].dtype == torch.float32, key
        err = _rel(out[key].numpy(), ref[key])
        assert err <= FWD_RTOL[mode], (key, err)


@pytest.mark.parametrize("mode", PRECISIONS)
def test_run_mr_inference_at_each_precision_matches_jax(mr, mode):
    cfg = mr["cfg"].replace(eval_precision=mode)
    sub, sub_nms, _ = run_mr_inference(cfg, mr["model"], mr["ds"])
    j_sub, j_nms, _ = mr["jax_runs"][mode]
    assert [r["qid"] for r in sub] == [r["qid"] for r in j_sub]
    top = max(np.abs(r["pred_saliency_scores"]).max() for r in j_sub)
    for a, b in zip(sub, j_sub):
        sal, ref = np.asarray(a["pred_saliency_scores"]), np.asarray(b["pred_saliency_scores"])
        assert sal.shape == ref.shape
        assert np.abs(sal - ref).max() <= FWD_RTOL[mode] * max(top, 0.1) + 1e-4, a["qid"]
    for ours, ref in ((sub, j_sub), (sub_nms, j_nms)):
        got = eval_submission(ours, mr["ds"].data)["brief"]
        want = jax_eval(ref, mr["ds"].data, verbose=False)["brief"]
        for key in ("MR-full-R1@0.5", "MR-full-R1@0.7", "MR-full-mAP"):
            assert abs(got[key] - want[key]) <= METRIC_ATOL[mode], (key, got[key], want[key])


@pytest.mark.parametrize("mode", PRECISIONS)
def test_run_hl_inference_at_each_precision_matches_jax(tmp_path, mode):
    hd = dict(SMALL, max_v_l=150, nheads=2, attn_chunk=128, eval_bsz=4)
    del hd["nms_thd"]
    ann, vdir, qdir = make_synthetic_tvsum(str(tmp_path), n_queries=7, v_dim=48, t_dim=32,
                                           min_clips=20, max_clips=150, seed=3,
                                           max_q_tokens=13)
    data = dict(eval_path=ann, v_feat_dirs=(vdir,), t_feat_dir=qdir, dset_domain="BK",
                eval_precision=mode)
    jcfg = jax_preset("tvsum", **hd, **data, device_feed="off")
    jmodel, params = _jax_init(jcfg, key=4)
    want = jax_infer.run_hl_inference(
        jcfg, jmodel, params, JaxDataset(_dataset_cfg(jcfg, ann, load_labels=False)))
    cfg = from_preset("tvsum", **hd, **data)
    got = run_hl_inference(cfg, _port_model(cfg, params), VTGDataset(eval_data_config(cfg, ann)))
    assert len(got["saliency"]) == 7
    assert all(s.dtype == np.float32 and np.isfinite(s).all() for s in got["saliency"].values())
    assert abs(got["brief"]["mAP"] - want["brief"]["mAP"]) <= HD_MAP_ATOL[mode]


def _train_batch(cfg, ann, n=4):
    rows = VTGDataset(train_data_config(cfg, ann))
    batch = Collator(cfg.max_q_l, cfg.v_buckets, cfg.max_v_l, max_windows=cfg.max_windows,
                     dset_name=cfg.dset_name)([rows[i] for i in range(n)])
    batch["real_neg_mask"] = np.asarray([1, 0, 1, 1], np.float32)
    return batch


@pytest.mark.parametrize("mode", PRECISIONS)
def test_train_step_at_each_precision_matches_jax_float32(mr, mode):
    """make_train_step at `mode` (every dropout 0, no clip) from the JAX
    init against JAX value_and_grad in float32: total loss and gradients."""
    cfg = mr["cfg"].replace(dropout=0.0, input_dropout=0.0, grad_clip=0.0)
    jcfg = mr["jcfg"].replace(dropout=0.0, input_dropout=0.0)
    batch = _train_batch(cfg, mr["ann"])
    keys = ("src_txt", "src_txt_mask", "src_vid", "src_vid_mask", "real_neg_mask",
            "saliency_all_labels", "saliency_pos_labels", "saliency_neg_labels", "gt_windows")
    jmodel = JaxModel(dataclasses.replace(jcfg.model_config(), dummy_dropout=0.0))
    jb = {k: jnp.asarray(batch[k]) for k in keys}

    def loss_fn(p):
        out = jmodel.apply(p, jb["src_txt"], jb["src_txt_mask"], jb["src_vid"],
                           jb["src_vid_mask"], jb["real_neg_mask"], train=True,
                           rngs={"dropout": jax.random.PRNGKey(6)})
        return jax_weighted_total(jax_compute_losses(out, jb, jcfg.loss_config()),
                                  jcfg.loss_config())

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(mr["params"])
    mcfg = dataclasses.replace(cfg.model_config(), dummy_dropout=0.0)
    model = _port_model(cfg, mr["params"], mcfg).train()
    optimizer, scheduler = make_optimizer(cfg, model.parameters(), steps_per_epoch=1)
    step = make_train_step(model, cfg.loss_config(), optimizer, scheduler, 0.0,
                           precision=mode)
    losses = step(place_batch({k: batch[k] for k in keys}, "cpu"))
    assert all(v.dtype == torch.float32 and torch.isfinite(v) for v in losses.values())
    loss_err = abs(losses["weighted_loss_overall"].item() - float(jloss)) / abs(float(jloss))
    assert loss_err <= STEP_LOSS_RTOL[mode], loss_err
    want = state_dict_from_jax(jax.tree.map(np.asarray, jgrads), mcfg)
    names = [n for n, _ in model.named_parameters() if not n.startswith("txt_position_embed.")]
    got = torch.cat([dict(model.named_parameters())[n].grad.flatten() for n in names]).double()
    ref = torch.cat([want[n].flatten() for n in names]).double()
    assert ((got - ref).norm() / ref.norm()).item() <= STEP_GRAD_RTOL[mode]
    # the weights stay float32: AdamW updates the f32 masters
    assert all(p.dtype == torch.float32 for p in model.parameters())


@pytest.mark.parametrize("mode", PRECISIONS)
def test_train_runs_at_each_precision(mr, tmp_path, mode):
    """train() end to end at train_precision = eval_precision = `mode`
    (bfloat16 with the bf16 wire): finite losses, one eval."""
    cfg = mr["cfg"].replace(train_precision=mode, eval_precision=mode, bsz=8, n_epoch=1,
                            eval_epoch=1, use_tensorboard=False,
                            transfer_dtype="bfloat16" if mode == "bfloat16" else "float32")
    model, _, run_dir = train(cfg, str(tmp_path / "run"), device="cpu", max_steps=2)
    with open(f"{run_dir}/eval.log.txt") as f:
        assert len(f.read().splitlines()) == 1
    with open(f"{run_dir}/tensorboard_log/scalars.jsonl") as f:
        import json

        rows = [json.loads(line) for line in f]
    losses = [v for r in rows for k, v in r.items() if k.startswith("train/")]
    assert losses and np.isfinite(losses).all()
    assert all(p.dtype == torch.float32 for p in model.parameters())


@pytest.mark.parametrize("mode", PRECISIONS)
def test_eval_step_leaves_the_dial_in_float32(mr, mode):
    cfg, ds = mr["cfg"], mr["ds"]
    batch = Collator(cfg.max_q_l, cfg.v_buckets, cfg.max_v_l)([ds[i] for i in range(4)])
    step = make_eval_step(mr["model"], cfg.max_num_moment, mode)
    spans, scores, sal, losses = step({k: torch.from_numpy(batch[k]) for k in MODEL_KEYS}, None)
    assert spans.dtype == scores.dtype == sal.dtype == torch.float32 and losses == {}
    assert torch.isfinite(spans).all() and torch.isfinite(sal).all()
    assert kernel_form() == "3xtf32" and not torch.is_autocast_enabled("cpu")


def test_matmul_precision_restores_flags_and_form():
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    try:
        for outside in ((False, False), (False, True), (True, True)):
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = outside
            for mode, form in (("float32", "3xtf32"), ("tensorfloat32", "1xtf32"),
                               ("bfloat16", "bf16")):
                with matmul_precision(mode, "cpu"):
                    assert kernel_form() == form
                    tf32 = mode == "tensorfloat32"
                    assert torch.backends.cuda.matmul.allow_tf32 is tf32
                    assert torch.backends.cudnn.allow_tf32 is tf32
                    assert torch.is_autocast_enabled("cpu") is (mode == "bfloat16")
                    if mode == "bfloat16":
                        assert torch.mm(torch.ones(2, 2), torch.ones(2, 2)).dtype == torch.bfloat16
                with pytest.raises(RuntimeError, match="inside"):
                    with matmul_precision(mode, "cpu"):
                        raise RuntimeError("inside")
                assert (torch.backends.cuda.matmul.allow_tf32,
                        torch.backends.cudnn.allow_tf32) == outside
                assert kernel_form() == "3xtf32" and not torch.is_autocast_enabled("cpu")
            # nested dials restore the outer one
            with matmul_precision("tensorfloat32", "cpu"):
                with matmul_precision("bfloat16", "cpu"):
                    assert kernel_form() == "bf16"
                assert kernel_form() == "1xtf32" and torch.backends.cuda.matmul.allow_tf32
                assert not torch.is_autocast_enabled("cpu")
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


def test_unknown_precision_raises(mr):
    with pytest.raises(ValueError, match="unknown precision"):
        with matmul_precision("float16", "cpu"):
            pass
    assert kernel_form() == "3xtf32"
    with pytest.raises(ValueError, match="unknown precision"):
        make_eval_step(mr["model"], 10, "highest")
    model = FlashVTGModel(mr["cfg"].model_config())
    optimizer, scheduler = make_optimizer(mr["cfg"], model.parameters(), 1)
    with pytest.raises(ValueError, match="unknown precision"):
        make_train_step(model, mr["cfg"].loss_config(), optimizer, scheduler, 0.1,
                        precision="bf16")
    with pytest.raises(ValueError, match="unknown transfer_dtype"):
        place_batch({"src_vid": np.zeros((1, 2, 3), np.float32)}, "cpu",
                    transfer_dtype="float16")
    with pytest.raises(ValueError, match="unknown precision"):
        run_mr_inference(mr["cfg"].replace(eval_precision="float16"), mr["model"], mr["ds"])


def test_transfer_dtype_narrowing_is_jax_astype_bfloat16():
    """place_batch(transfer_dtype="bfloat16") narrows src_vid and src_txt as
    the JAX loop's host_batch[k].astype(bfloat16) does (round to nearest
    even), bit for bit, and leaves masks and labels alone."""
    rng = np.random.default_rng(0)
    vid = (rng.standard_normal((3, 40, 17)) * 10.0 ** rng.integers(-20, 20, (3, 40, 17)))
    vid = vid.astype(np.float32)
    # ties of the 16 dropped bits: to the even neighbour, both ways
    ties = np.asarray([0x3F808000, 0x3F818000, 0xBF808000, 0x7F7FFFFF, 0x00008000],
                      np.uint32).view(np.float32)
    vid[0, 0, : len(ties)] = ties
    vid[0, 1, :3] = [np.inf, -np.inf, 0.0]
    batch = {"src_vid": vid, "src_txt": rng.standard_normal((3, 5, 9)).astype(np.float32),
             "src_vid_mask": np.ones((3, 40), np.float32),
             "saliency_pos_labels": np.arange(6).reshape(3, 2)}
    placed = place_batch(batch, "cpu", transfer_dtype="bfloat16")
    bf16 = np.dtype("bfloat16")  # ml_dtypes, registered by JAX
    for key in ("src_vid", "src_txt"):
        want = batch[key].astype(bf16).astype(np.float32)
        got = placed[key].numpy()
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32), err_msg=key)
        np.testing.assert_array_equal(got, np.asarray(jnp.asarray(batch[key]).astype(
            jnp.bfloat16).astype(jnp.float32)))
    assert not np.array_equal(placed["src_vid"].numpy(), vid)  # it did narrow
    np.testing.assert_array_equal(placed["src_vid_mask"].numpy(), batch["src_vid_mask"])
    assert placed["saliency_pos_labels"].dtype == torch.int64
    wide = place_batch(batch, "cpu")
    np.testing.assert_array_equal(wide["src_vid"].numpy(), vid)


def test_lgi_softmax_stays_float32_under_bfloat16():
    """The LGI attention's einsums follow autocast; its -inf key mask, the
    softmax and the head mean stay float32 and finite, and a masked key gets
    no weight."""
    torch.manual_seed(0)
    att = MHACore(32, 4, dropout=0.0).eval()
    q, kv = torch.randn(2, 5, 32), torch.randn(2, 7, 32)
    valid = torch.ones(2, 7)
    valid[0, 3:] = 0
    with torch.no_grad():
        with matmul_precision("bfloat16", "cpu"):
            out, head_mean = att(q, kv, kv, valid, need_weights=True)
        ref_out, ref_mean = att(q, kv, kv, valid, need_weights=True)
    assert head_mean.dtype == torch.float32 and torch.isfinite(head_mean).all()
    assert torch.isfinite(out).all() and out.dtype == torch.bfloat16
    assert (head_mean[0, :, 3:] == 0).all()
    torch.testing.assert_close(head_mean.sum(-1), torch.ones(2, 5))
    assert _rel(head_mean.numpy(), ref_mean.numpy()) <= FWD_RTOL["bfloat16"]
    assert _rel(out.float().numpy(), ref_out.numpy()) <= FWD_RTOL["bfloat16"]
