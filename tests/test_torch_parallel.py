"""The port's data parallelism (parallel/mesh.py) against the JAX package and
against one process, on the CPU (2 gloo ranks).

The JAX package runs one GLOBAL batch as SPMD over its mesh: the sharded
step is the single-device step (tests/test_multichip.py). Its global batch
is the host-contiguous concatenation of the hosts' strided shards, a
permutation of one process's batch; the negative roll pairs adjacent rows,
so "the same as one process" means one process fed that assembled order
(tests/test_multihost.py says the same). Here:

  * `shard_rows_for_host` and `global_real_neg_mask` equal the JAX ones;
    `assembled_order`'s global batches are what they index;
  * the ACA plain version with donor tables of G > B rows, each rank's
    rows, equals the JAX ACA layer on the global batch (1e-6);
  * one float64 train step of 2 ranks of 2 rows equals the JAX
    single-device step on the global batch of 4, for the core model and
    for TACoS's shapes past 128 clips (the flash Functions) and for
    FlashVTG_ms with use_eos and use_dfl: the losses (rtol 1e-9), the
    summed gradients (1e-8 of each leaf's largest value: those of the
    forward and backward alone, and make_train_step's before its clip) and
    the parameters after the update (1e-8), on both ranks, which end
    equal. The
    global real_neg_mask [1, 1, 0, 0] makes rank 0's last row a real
    negative rolled onto rank 1's text, the negative pass's donors rank 0's
    rows for rank 1's, the tiled donors cross the boundary too, and rank 1
    holds both false negatives (the criterion's `false_neg.sum() > 1`
    branch is on globally and off on rank 0); the rows' text lengths differ,
    so the donors' padded keys mask what a rank's own rows would not;
  * train() on 2 ranks against one process fed the assembled order: the
    step losses of 2 epochs (rtol 1e-6), the submissions byte for byte,
    rank 1 writing no file, the two ranks' final weights equal;
  * sharded run_mr_inference / run_hl_inference rows byte for byte one
    process's, eval losses included;
  * epoch_mode's gloo rule (eager steps), and different dropout draws on
    the two ranks with equal weights after the step.

The ranks run once for the module (`ranks`), spawned by
tests/torch_dp_worker.py:run_ranks; what each runs is in that file.
"""

import contextlib
import dataclasses
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch_threads  # noqa: F401  (torch's share of the cores under xdist)
import torch

from flashvtg_tpu.data.collate import rolled_neg_mask as jax_rolled_neg_mask
from flashvtg_tpu.losses.criterion import compute_losses as jax_compute_losses
from flashvtg_tpu.losses.criterion import weighted_total as jax_weighted_total
from flashvtg_tpu.losses.criterion_ms import compute_losses_ms as jax_compute_losses_ms
from flashvtg_tpu.losses.criterion_ms import weighted_total_ms as jax_weighted_total_ms
from flashvtg_tpu.models import flashvtg as jax_flashvtg
from flashvtg_tpu.models import flashvtg_ms as jax_ms
from flashvtg_tpu.models import lgi as jax_lgi
from flashvtg_tpu.models.transformer import AdaptiveCrossAttention as JaxACA
from flashvtg_tpu.models.transformer import tiled_attn_donors as jax_tiled_donors
from flashvtg_tpu.parallel.mesh import shard_rows_for_host as jax_shard_rows
from flashvtg_tpu.train.config import from_preset as jax_preset
from flashvtg_tpu.train.loop import global_real_neg_mask as jax_global_real_neg_mask
from flashvtg_tpu.train.loop import make_optimizer as jax_make_optimizer
from flashvtg_tpu_torch.data.collate import Collator, global_real_neg_mask, rolled_neg_mask
from flashvtg_tpu_torch import losses as port_losses
from flashvtg_tpu_torch.data.dataset import VTGDataset
from flashvtg_tpu_torch.models import build_model
from flashvtg_tpu_torch.models.transformer import tiled_attn_donors
from flashvtg_tpu_torch.ops.aca import aca_attention_plain
from flashvtg_tpu_torch.parallel import mesh
from flashvtg_tpu_torch.train import config as port_config
from flashvtg_tpu_torch.train.config import from_preset
from flashvtg_tpu_torch.train.infer import eval_data_config, run_hl_inference, run_mr_inference
from flashvtg_tpu_torch.train.loop import epoch_mode, place_batch, train, train_data_config
from flashvtg_tpu_torch.utils.convert import state_dict_from_jax, state_dict_from_jax_ms
from flashvtg_tpu_torch.utils.synthetic import (
    make_synthetic_qvh,
    make_synthetic_tacos,
    make_synthetic_tvsum,
)
from torch_dp_worker import run_ranks

WORLD = 2
SMALL = dict(v_feat_dim=40, t_feat_dim=24, hidden_dim=64, nheads=2, dim_feedforward=96,
             t2v_layers=2, enc_layers=2, dummy_layers=1, num_mlp_layers=2, max_q_l=8,
             num_dummies=4, max_v_l=24)
MS = dict(v_feat_dim=40, t_feat_dim=24, max_v_l=24, max_q_l=8, variant="ms", hidden_dim=32,
          nheads=4, dim_feedforward=48, num_dummies=2, t2v_layers=1, enc_layers=1,
          dummy_layers=1, num_conv_layers=1, num_mlp_layers=2, num_phrase=2, phrase_layers=1,
          context_layers=1, rank=2, t_sa=1, use_dfl=True, use_eos=True)
NO_DROPOUT = dict(dropout=0.0, input_dropout=0.0)
# preset and widths of each step case: the flagship's shapes, TACoS's past
# 128 clips (the flash kernels' Functions in the encoder), FlashVTG_ms
STEP_CASES = {"core": ("qvhighlights_slowclip", SMALL),
              "tacos": ("tacos", dict(SMALL, num_dummies=5, max_v_l=150, attn_chunk=128)),
              "ms_dfl_eos": ("qvhighlights_slowclip", MS)}
GLOBAL_NEG = np.asarray([1, 1, 0, 0], np.float32)  # global real_neg_mask of the step
TEXT_LENS = (8, 3, 6, 2)  # valid text tokens of the step's rows
B = len(GLOBAL_NEG)
BSZ = 4  # train()'s global batch
MODEL_SEED = 3


@contextlib.contextmanager
def _one_thread():
    """torch on one CPU thread for the block: the tiny one-process
    references run ~10x slower on 8 threads beside JAX's pools."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _jax_pe64(mask, num_pos_feats, temperature=10000.0, normalize=True, scale=2 * math.pi):
    x = jnp.cumsum(mask.astype(jnp.float64), axis=1)
    if normalize:
        x = x / (x[:, -1:] + 1e-6) * scale
    dim = np.arange(num_pos_feats, dtype=np.float64)
    pos = x[:, :, None] / jnp.asarray(temperature ** (2 * (dim // 2) / num_pos_feats))
    pos = jnp.stack([jnp.sin(pos[:, :, 0::2]), jnp.cos(pos[:, :, 1::2])], axis=3)
    return pos.reshape(pos.shape[0], pos.shape[1], -1)


def _qvh(root, split, n, seed, o=SMALL):
    return make_synthetic_qvh(root, n_queries=n, v_dim=o["v_feat_dim"], t_dim=o["t_feat_dim"],
                              n_clips=o["max_v_l"], seed=seed, min_clips=10,
                              max_q_tokens=o["max_q_l"] + 1, split=split)


def _step_case(root, name):
    """(port cfg, JAX cfg, JAX params in float64, global host batch)."""
    preset, kw = STEP_CASES[name]
    if preset == "tacos":
        ann, vdir, qdir = make_synthetic_tacos(
            os.path.join(root, name), n_queries=B, v_dim=kw["v_feat_dim"],
            t_dim=kw["t_feat_dim"], max_clips=kw["max_v_l"], min_clips=20, seed=4,
            max_q_tokens=kw["max_q_l"], split="train")
    else:
        ann, vdir, qdir = _qvh(os.path.join(root, name), "train", B, seed=4, o=kw)
    data = dict(train_path=ann, v_feat_dirs=(vdir,), t_feat_dir=qdir, **NO_DROPOUT)
    cfg = from_preset(preset, **kw, **data)
    jcfg = jax_preset(preset, **kw, **data, device_feed="off")
    batch = Collator(cfg.max_q_l, cfg.v_buckets, cfg.max_v_l, max_windows=cfg.max_windows,
                     dset_name=cfg.dset_name)(
        [VTGDataset(train_data_config(cfg, ann))[i] for i in range(B)])
    batch["real_neg_mask"] = GLOBAL_NEG
    # ragged text, so that a donor row's padded keys mask something
    for row, n in enumerate(TEXT_LENS):
        batch["src_txt_mask"][row, n:] = 0.0
        batch["src_txt"][row, n:] = 0.0
    assert batch["valid_v_lens"].min() < cfg.max_v_l  # padded rows are in
    jmodel = jcfg.build_model()
    lv, lq = cfg.max_v_l, cfg.max_q_l
    params = jax.jit(jmodel.init, static_argnames="train")(
        {"params": jax.random.PRNGKey(5)},
        jnp.zeros((1, lq, cfg.t_feat_dim)), jnp.ones((1, lq)),
        jnp.zeros((1, lv, cfg.total_v_feat_dim)), jnp.ones((1, lv)), train=False,
    )
    # every leaf moved off its init (a zero leaf's gradient of rounding size
    # would make Adam's first step noise), as tests/test_torch_ms.py does
    shift = np.random.default_rng(5)
    params = jax.tree.map(
        lambda x: np.asarray(x, np.float64) + shift.normal(0.0, 0.02, np.shape(x)), params)
    keys = ("src_txt", "src_txt_mask", "src_vid", "src_vid_mask", "real_neg_mask",
            "saliency_all_labels", "saliency_pos_labels", "saliency_neg_labels", "gt_windows")
    host = {k: (batch[k].astype(np.float64) if batch[k].dtype == np.float32 else batch[k])
            for k in keys}
    return cfg, jcfg, params, host


def _state(cfg, params):
    mcfg = dataclasses.replace(cfg.model_config(), dummy_dropout=0.0)
    to_sd = state_dict_from_jax_ms if cfg.variant == "ms" else state_dict_from_jax
    return {k: v.numpy() for k, v in to_sd(params, mcfg, np.float64).items()}


def _train_cfg(root, **extra):
    ann, vdir, qdir = _qvh(root, "train", 9, seed=7)
    val, _, _ = _qvh(root, "val", 5, seed=8)
    return from_preset("qvhighlights_slowclip", **SMALL, train_path=ann, eval_path=val,
                       v_feat_dirs=(vdir,), t_feat_dir=qdir, bsz=BSZ, eval_bsz=2, n_epoch=2,
                       eval_epoch=1, use_tensorboard=False, train_precision="float32",
                       results_root=root, **extra)


def _infer_cfgs(root):
    ann, vdir, qdir = _qvh(os.path.join(root, "mr"), "val", 7, seed=11)
    mr = from_preset("qvhighlights_slowclip", **SMALL, eval_path=ann, v_feat_dirs=(vdir,),
                     t_feat_dir=qdir, eval_bsz=2)
    hann, hvdir, hqdir = make_synthetic_tvsum(
        os.path.join(root, "hl"), n_queries=5, domain="BK", v_dim=48, t_dim=32, min_clips=20,
        max_clips=40, seed=12, max_q_tokens=9, split="val")
    hl = from_preset("tvsum", **dict(SMALL, v_feat_dim=48, t_feat_dim=32, max_v_l=40),
                     eval_path=hann, v_feat_dirs=(hvdir,), t_feat_dir=hqdir, eval_bsz=2,
                     dset_domain="BK")
    return mr, hl


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank job of the module in one run of 2 gloo ranks, with the
    inputs they were given."""
    root = str(tmp_path_factory.mktemp("dp"))
    steps = {name: _step_case(root, name) for name in STEP_CASES}
    train_cfg = _train_cfg(os.path.join(root, "train"), **NO_DROPOUT)
    drop_root = os.path.join(root, "dropout")
    drop_cfg = dataclasses.replace(_train_cfg(drop_root), eval_path="", n_epoch=1)
    mr_cfg, hl_cfg = _infer_cfgs(root)
    jobs = {f"step_{name}": ("step_f64", (cfg, _state(cfg, params), host))
            for name, (cfg, _, params, host) in steps.items()}
    jobs.update(
        train=("train_run", (train_cfg, os.path.join(root, "train", "dp"), True)),
        dropout=("dropout_draws", (drop_cfg, os.path.join(drop_root, "dp"))),
        inference=("inference", (mr_cfg, hl_cfg, MODEL_SEED)),
        epoch_graph=("epoch_graph", (train_cfg.replace(scan_steps=4),)),
    )
    results = run_ranks(jobs, WORLD)
    return dict(root=root, steps=steps, train_cfg=train_cfg, mr_cfg=mr_cfg, hl_cfg=hl_cfg,
                results=results)


def test_shard_rows_for_host_matches_jax():
    rows = np.random.default_rng(0).permutation(37)
    for pc in (1, 2, 3, 4):
        for pi in range(pc):
            np.testing.assert_array_equal(mesh.shard_rows_for_host(rows, pi, pc),
                                          jax_shard_rows(rows, pi, pc))
    np.testing.assert_array_equal(mesh.shard_rows_for_host(rows), rows)  # no group


def test_global_real_neg_mask_matches_jax():
    """The copy against the JAX function, and both against the rolled mask
    of assembled_order's global batch, cut to each rank's rows."""
    rng = np.random.default_rng(1)
    vids = [f"v{int(i)}" for i in rng.integers(0, 6, 29)]  # repeats: false negatives
    rows = rng.permutation(len(vids))
    for pc, local in ((1, 4), (2, 3), (3, 2), (4, 1)):
        order = mesh.assembled_order(rows, pc, local)
        for step in range(len(vids) // (pc * local)):
            g = order[step * pc * local:(step + 1) * pc * local]
            assert sorted(g.tolist()) == sorted(
                np.concatenate([jax_shard_rows(rows, p, pc)[step * local:(step + 1) * local]
                                for p in range(pc)]).tolist())
            whole = rolled_neg_mask([vids[j] for j in g])
            np.testing.assert_array_equal(whole, jax_rolled_neg_mask([vids[j] for j in g]))
            for me in range(pc):
                got = global_real_neg_mask(vids, rows, step, local, pc, me)
                np.testing.assert_array_equal(
                    got, jax_global_real_neg_mask(vids, rows, step, local, pc, me))
                np.testing.assert_array_equal(got, whole[me * local:(me + 1) * local])


def test_build_group_for(monkeypatch):
    assert mesh.build_group_for(6) == 6  # no group: one process
    monkeypatch.setattr(mesh, "world", lambda: 4)
    assert mesh.build_group_for(64) == 16
    with pytest.raises(ValueError, match="divisible"):
        mesh.build_group_for(30)


@pytest.mark.parametrize("name", ["core", "ms_dfl_eos"])
def test_criterion_gathers_no_clip_embedding(tmp_path, monkeypatch, name):
    """Under a split batch the criterion gathers per-row and per-clip
    values only: its row reductions (the sampled NCE's logits, the EOS
    positive clip) stand in for the forward's (B, Lv, D) embeddings, and
    leave the losses exactly as compute_losses gives them. A split over
    one process whose gather is the identity records what is gathered."""
    cfg, _, _, host = _step_case(str(tmp_path), name)
    mcfg = dataclasses.replace(cfg.model_config(), dummy_dropout=0.0)
    loss_cfg = cfg.loss_config()
    tb = place_batch(host, "cpu")
    with _one_thread():
        out = build_model(mcfg, "cpu", MODEL_SEED).train()(
            tb["src_txt"], tb["src_txt_mask"], tb["src_vid"], tb["src_vid_mask"],
            real_neg_mask=tb["real_neg_mask"])
        compute = (port_losses.compute_losses_ms if cfg.variant == "ms"
                   else port_losses.compute_losses)
        want = compute(out, tb, loss_cfg)
        gathered = []
        monkeypatch.setattr(port_losses, "batch_world", lambda: WORLD)
        monkeypatch.setattr(port_losses, "gather_rows", lambda x: gathered.append(x) or x)
        got = port_losses.criterion(loss_cfg, out, tb)
    wide = {k for k, v in out.items() if torch.is_tensor(v) and v.dim() == 3
            and v.shape[1] == cfg.max_v_l and v.shape[2] == mcfg.hidden_dim}
    assert wide and gathered
    assert not [k for k in wide if any(out[k] is g for g in gathered)]
    for key, value in want.items():
        assert got[key].item() == value.item(), key


def test_aca_donor_tables_match_jax_on_global_batch():
    """Each rank's rows of the ACA plain version, its donor rows those of
    the global batch and its donor tables the global batch's masks (G = 4 >
    B = 2, donors on the other rank), against the JAX ACA layer on the
    global batch (transformer.py:95-127): out and head mean within 1e-6."""
    rng = np.random.default_rng(2)
    g, lv, nd, lt, heads = 4, 19, 3, 7, 2
    d, lk = heads * 32, nd + lt
    q = rng.standard_normal((g, lv, d), dtype=np.float32)
    k = rng.standard_normal((g, lk, d), dtype=np.float32)
    v = rng.standard_normal((g, lk, d), dtype=np.float32)
    kvalid = (np.arange(lk)[None] < np.asarray([[lk], [nd + 2], [nd + 5], [nd + 1]])).astype(
        np.float32)
    vvalid = (np.arange(lv)[None] < np.asarray([[lv], [7], [12], [3]])).astype(np.float32)
    donors = np.asarray(jax_tiled_donors(g, heads))
    jmod = JaxACA(heads, nd, dropout=0.0)
    params = jmod.init(jax.random.PRNGKey(0), q, k, v, kvalid)
    jout, jhm = jmod.apply(params, *map(jnp.asarray, (q, k, v, kvalid)),
                           query_valid=jnp.asarray(vvalid), donor_rows=jnp.asarray(donors))
    dense = params["params"]["out_proj"]
    w, bias = np.asarray(dense["kernel"]), np.asarray(dense["bias"])
    n = g // WORLD
    port_donors = tiled_attn_donors(g, heads)
    crossing = 0
    for r in range(WORLD):
        own = slice(r * n, (r + 1) * n)
        rows = port_donors[own]
        crossing += int(((rows < r * n) | (rows >= (r + 1) * n)).sum())
        out, hm = aca_attention_plain(
            *(torch.from_numpy(x[own]) for x in (q, k, v, kvalid)), heads, nd,
            donor_query_valid=torch.from_numpy(vvalid), donor_rows=rows,
            donor_key_valid=torch.from_numpy(kvalid))
        np.testing.assert_allclose(out.numpy() @ w + bias, np.asarray(jout)[own], atol=1e-6)
        np.testing.assert_allclose(hm.numpy(), np.asarray(jhm)[own], atol=1e-6)
    assert crossing > 0  # some donors are the other rank's rows
    np.testing.assert_array_equal(port_donors.numpy(), donors)


def _rel_err(got, want):
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-6)


def _jax_step(name, jcfg, params, host):
    """(losses, gradients, parameters after one AdamW step) of the JAX
    single-device float64 step on the global batch."""
    ms = name.startswith("ms")
    mcfg = jcfg.ms_model_config() if ms else jcfg.model_config()
    jmodel = (jax_ms.FlashVTGMSModel if ms else jax_flashvtg.FlashVTGModel)(
        dataclasses.replace(mcfg, dummy_dropout=0.0))
    loss_cfg = jcfg.ms_loss_config() if ms else jcfg.loss_config()
    compute = jax_compute_losses_ms if ms else jax_compute_losses
    weighted = jax_weighted_total_ms if ms else jax_weighted_total
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64():
        for mod in (jax_flashvtg, jax_ms, jax_lgi):
            mp.setattr(mod, "sine_position_embedding", _jax_pe64)
        jb = {k: jnp.asarray(v) for k, v in host.items()}

        def loss_fn(p):
            out = jmodel.apply(p, jb["src_txt"], jb["src_txt_mask"], jb["src_vid"],
                               jb["src_vid_mask"], jb["real_neg_mask"], train=True,
                               rngs={"dropout": jax.random.PRNGKey(6)})
            losses = compute(out, jb, loss_cfg)
            total = weighted(losses, loss_cfg)
            return total, dict(losses, weighted_loss_overall=total)

        p64 = jax.tree.map(jnp.asarray, params)
        (_, losses), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(p64)
        tx, _ = jax_make_optimizer(jcfg, steps_per_epoch=1)
        updates, _ = tx.update(grads, tx.init(p64), p64)
        new_params = optax.apply_updates(p64, updates)
        return ({k: float(v) for k, v in losses.items()},
                jax.tree.map(np.asarray, grads), jax.tree.map(np.asarray, new_params))


def _dead(name):
    """Reference parameters that no forward reads (no JAX counterpart)."""
    return name.startswith(("txt_position_embed.", "transformer.fuse_proj.", "pooling.")) or (
        name.startswith("t_sa.layers.") and ".norm1." in name)


@pytest.mark.parametrize("name", sorted(STEP_CASES))
def test_dp_step_matches_jax_global_batch(ranks, name):
    cfg, jcfg, params, host = ranks["steps"][name]
    jlosses, jgrads, jnew = _jax_step(name, jcfg, params, host)
    want_grads, want_params = _state(cfg, jgrads), _state(cfg, jnew)
    per_rank = [res[f"step_{name}"] for res in ranks["results"]]
    for res in per_rank:
        for which in ("losses", "step_losses"):
            assert sorted(res[which]) == sorted(jlosses), which
            for key, want in jlosses.items():
                np.testing.assert_allclose(res[which][key], want, rtol=1e-9,
                                           err_msg=f"{which} {key}")
        for which in ("grads", "step_grads"):
            for key, grad in res[which].items():
                if not _dead(key):
                    assert _rel_err(grad, want_grads[key]) < 1e-8, (key, which)
        for key, p in res["params"].items():
            if not _dead(key):
                assert _rel_err(p, want_params[key]) < 1e-8, (key, "param")
    for key in per_rank[0]["params"]:  # the ranks' updates are one update
        np.testing.assert_array_equal(per_rank[0]["params"][key], per_rank[1]["params"][key])


def _train_losses(run_dir):
    with open(os.path.join(run_dir, "tensorboard_log", "scalars.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return [{k: v for k, v in r.items() if k.startswith("train/")}
            for r in rows if any(k.startswith("train/") for k in r)]


def test_dp_train_matches_one_process_in_assembled_order(ranks, monkeypatch):
    """train() on 2 ranks and train() in one process whose epochs run the
    2-rank assembled order, every dropout at 0, float32."""
    cfg = ranks["train_cfg"]
    dp, rank1 = ranks["results"][0]["train"], ranks["results"][1]["train"]
    orig_cfg = port_config.ExperimentConfig.model_config
    monkeypatch.setattr(port_config.ExperimentConfig, "model_config",
                        lambda self: dataclasses.replace(orig_cfg(self), dummy_dropout=0.0))
    assembled = mesh.assembled_order
    monkeypatch.setattr(mesh, "assembled_order",
                        lambda rows, world, local: assembled(rows, WORLD, BSZ // WORLD))
    one_dir = os.path.join(os.path.dirname(dp["run_dir"]), "one")
    with _one_thread():
        train(cfg, one_dir, device="cpu")

    want, got = _train_losses(one_dir), _train_losses(dp["run_dir"])
    assert len(got) == len(want) == 2 * (9 // BSZ)
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for key, value in w.items():
            np.testing.assert_allclose(g[key], value, rtol=1e-6, err_msg=key)
    name = "latest_hl_val_preds.jsonl"
    with open(os.path.join(one_dir, name)) as f, open(os.path.join(dp["run_dir"], name)) as g:
        assert g.read() == f.read()
    assert sorted(os.listdir(dp["run_dir"])) == sorted(os.listdir(one_dir))
    assert rank1["written"] == [] and dp["written"]  # rank 0 alone writes
    assert rank1["run_dir"] == dp["run_dir"] and rank1["best"] == dp["best"]
    for key, value in dp["state"].items():
        np.testing.assert_array_equal(rank1["state"][key], value)


def test_sharded_inference_matches_one_process(ranks):
    """Batches dealt to 2 ranks and gathered back: the MR submission (NMS'd
    too) and eval losses, and the HD saliency and mAP, byte for byte one
    process's (7 queries at eval_bsz 2: 4 batches, the tail one 1 row)."""
    mr_cfg, hl_cfg = ranks["mr_cfg"], ranks["hl_cfg"]
    with _one_thread():
        model = build_model(mr_cfg.model_config(), "cpu", MODEL_SEED)
        ds = VTGDataset(eval_data_config(mr_cfg, mr_cfg.eval_path, load_labels=True))
        sub, sub_nms, losses = run_mr_inference(mr_cfg, model, ds,
                                                loss_cfg=mr_cfg.loss_config())
        model = build_model(hl_cfg.model_config(), "cpu", MODEL_SEED)
        hl = run_hl_inference(hl_cfg, model,
                              VTGDataset(eval_data_config(hl_cfg, hl_cfg.eval_path)))
    assert losses and sub_nms is not None
    for res in ranks["results"]:
        got_sub, got_nms, got_losses = res["inference"]["mr"]
        assert json.dumps(got_sub) == json.dumps(sub)
        assert json.dumps(got_nms) == json.dumps(sub_nms)
        assert got_losses == losses
        brief, saliency = res["inference"]["hl"]
        assert brief == hl["brief"] and list(saliency) == list(hl["saliency"])
        for qid, row in hl["saliency"].items():
            assert saliency[qid].tobytes() == row.tobytes()


def test_gloo_group_runs_eager_steps(ranks):
    """Under gloo the graph modes step eagerly (its collectives cannot be
    captured); without a group the same config captures on the card."""
    cfg = ranks["train_cfg"].replace(scan_steps=4)
    assert epoch_mode(cfg, "cuda", 8).graph
    assert [res["epoch_graph"] for res in ranks["results"]] == [False, False]


def test_dropout_draws_differ_across_ranks(ranks):
    """One train() step with the preset's dropout: the ranks draw different
    attention-dropout seeds and feature-dropout masks, and end with the same
    weights."""
    a, b = (res["dropout"] for res in ranks["results"])
    assert a["seeds"] and len(a["seeds"]) == len(b["seeds"])
    assert a["seeds"] != b["seeds"]
    assert a["masks"] and len(a["masks"]) == len(b["masks"])
    assert any(not np.array_equal(x, y) for x, y in zip(a["masks"], b["masks"]))
    for key, value in a["state"].items():
        np.testing.assert_array_equal(b["state"][key], value)
