"""The port's long-video path vs the JAX package, on the CPU.

Self-attention over more than 128 keys goes to ops/chunked_attn.py: on the
CPU its plain versions run, held here against the JAX package's
query-chunked attention (flashvtg_tpu/ops/chunked_attn.py) at atol 1e-6,
rtol 1e-5 (the tolerance of tests/test_chunked_attn.py), an Encoder at
L > 128 against the JAX Encoder running its chunked branch within 1e-5, and
the `tacos` preset at small widths (forward within 2e-4 / 3e-4, decode spans
within 2e-3, as tests/test_model_parity.py) and through run_mr_inference on
a TACoS-format set with string qids (the __graft_entry__.py:172-197
tolerances). The CUDA kernel itself runs only on the card:
tests/test_torch_kernels.py and chip_smoke.py hold it against the plain
version there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch_threads  # noqa: F401  (torch's share of the cores under xdist)
import torch

from flashvtg_tpu.data.dataset import VTGDataset as JaxDataset
from flashvtg_tpu.eval.metrics import eval_submission as jax_eval
from flashvtg_tpu.models.flashvtg import FlashVTGModel as JaxModel
from flashvtg_tpu.models.flashvtg import decode_boundaries as jax_decode
from flashvtg_tpu.models.transformer import Encoder as JaxEncoder
from flashvtg_tpu.ops.chunked_attn import chunked_attention
from flashvtg_tpu.train.config import from_preset as jax_preset
from flashvtg_tpu.train.infer import run_mr_inference as jax_run
from flashvtg_tpu.train.loop import _dataset_cfg
from flashvtg_tpu_torch.data.dataset import VTGDataset
from flashvtg_tpu_torch.eval.metrics import eval_submission
from flashvtg_tpu_torch.models.flashvtg import FlashVTGModel, decode_boundaries
from flashvtg_tpu_torch.models.points import pyramid_masks_strict
from flashvtg_tpu_torch.models.transformer import Encoder
from flashvtg_tpu_torch.ops import aca, chunked_attn
from flashvtg_tpu_torch.train.config import from_preset
from flashvtg_tpu_torch.train.infer import eval_data_config, run_mr_inference
from flashvtg_tpu_torch.utils.convert import _inv_encoder, state_dict_from_jax
from flashvtg_tpu_torch.utils.synthetic import make_synthetic_tacos

RTOL, ATOL = 1e-5, 1e-6


def _valid(b, length, rng):
    """Ragged key masks: a valid prefix per row, and one row with holes."""
    lens = rng.integers(1, length + 1, b)
    lens[0] = length
    valid = (np.arange(length)[None] < lens[:, None]).astype(np.float32)
    valid[-1] = (rng.random(length) < 0.4).astype(np.float32)
    valid[-1, 3] = 1.0
    return valid


def _heads_inputs(b, h, length, dh, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, h, length, dh), dtype=np.float32) for _ in range(3))
    return q * dh ** -0.5, k, v, _valid(b, length, rng)


@pytest.mark.parametrize("chunk", [16, 128])
@pytest.mark.parametrize("length", [129, 300])
def test_chunked_plain_matches_jax(length, chunk):
    q, k, v, valid = _heads_inputs(3, 2, length, 32, seed=length + chunk)
    ref = jax.jit(lambda *a: chunked_attention(*a, chunk_size=chunk))(
        *map(jnp.asarray, (q, k, v, valid))
    )
    got = chunked_attn.chunked_attention_plain(
        *map(torch.from_numpy, (q, k, v, valid)), chunk
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("chunk", [16, 128])
@pytest.mark.parametrize("length", [129, 300])
def test_flash_plain_matches_jax(length, chunk):
    """The merged-head plain version (and the CPU wrapper, which takes it)
    against the JAX function in its own layout."""
    b, h, dh = 3, 2, 32
    rng = np.random.default_rng(length * chunk)
    q, k, v = (rng.standard_normal((b, length, h * dh), dtype=np.float32) for _ in range(3))
    valid = _valid(b, length, rng)

    def split(x):
        return x.reshape(b, length, h, dh).transpose(0, 2, 1, 3)

    ref = chunked_attention(
        jnp.asarray(split(q * dh ** -0.5)), jnp.asarray(split(k)), jnp.asarray(split(v)),
        jnp.asarray(valid), chunk_size=chunk,
    )
    ref = np.asarray(ref).transpose(0, 2, 1, 3).reshape(b, length, h * dh)
    t = tuple(map(torch.from_numpy, (q, k, v, valid)))
    chunked_attn.reset_launch_counts()
    got = chunked_attn.flash_attention(*t, num_heads=h)
    # the CPU launches nothing
    assert chunked_attn.launch_counts() == {"flash_attention": 0, "flash_attention_bwd": 0}
    assert torch.equal(got, chunked_attn.flash_attention_plain(*t, h))
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)


def test_flash_wrapper_refuses_other_devices():
    q = torch.empty((1, 200, 32), device="meta")
    with pytest.raises(ValueError, match="expected CPU or CUDA"):
        chunked_attn.flash_attention(q, q, q, torch.empty((1, 200), device="meta"), 1)


def test_long_self_attention_routes_to_flash(monkeypatch):
    """Past aca.MAX_KEYS keys the encoder calls flash_attention, up to it
    masked_attention."""
    calls = []
    from flashvtg_tpu_torch.models import transformer

    def spy(name, fn):
        def wrapped(*a, **kw):
            calls.append((name, a[0].shape[1]))
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(transformer, "flash_attention", spy("flash", chunked_attn.flash_attention))
    monkeypatch.setattr(transformer, "masked_attention", spy("masked", aca.masked_attention))
    enc = Encoder(1, 64, 2, 96).eval()
    with torch.no_grad():
        for length in (aca.MAX_KEYS, aca.MAX_KEYS + 1):
            enc(torch.randn(2, length, 64), None, torch.ones(2, length))
    assert calls == [("masked", aca.MAX_KEYS), ("flash", aca.MAX_KEYS + 1)]


def test_encoder_matches_jax_chunked_branch():
    """L = 300 > attn_chunk = 128: the JAX Encoder runs chunked_attention,
    the port's runs flash_attention (its plain version on the CPU)."""
    b, length, d, heads = 3, 300, 64, 2
    rng = np.random.default_rng(5)
    x = rng.standard_normal((b, length, d), dtype=np.float32)
    pos = rng.standard_normal((b, length, d), dtype=np.float32)
    valid = _valid(b, length, rng)
    jenc = JaxEncoder(2, heads, 2 * d, dropout=0.0, attn_chunk=128)
    args = tuple(map(jnp.asarray, (x, pos, valid)))
    params = jax.jit(jenc.init)(jax.random.PRNGKey(0), *args)
    ref = jax.jit(jenc.apply)(params, *args)
    sd = {}
    _inv_encoder(sd, "E", jax.tree.map(np.asarray, params["params"]), 2)
    enc = Encoder(2, d, heads, 2 * d).eval()
    enc.load_state_dict({k[2:]: torch.tensor(v) for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        got = enc(*map(torch.from_numpy, (x, pos, valid)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


# the `tacos` preset at small widths; attn_chunk 128 < max_v_l sends the JAX
# encoder down its chunked branch
SMALL = dict(
    v_feat_dim=48, t_feat_dim=32, hidden_dim=64, nheads=2, dim_feedforward=128,
    t2v_layers=2, enc_layers=2, dummy_layers=1, num_dummies=5,
    num_mlp_layers=2, max_v_l=300, max_q_l=10, attn_chunk=128,
)
B = 3


@pytest.fixture(scope="module")
def pair():
    jcfg = jax_preset("tacos", **SMALL)
    jmodel = JaxModel(jcfg.model_config())
    lv, lq = jcfg.max_v_l, jcfg.max_q_l
    params = jax.jit(jmodel.init, static_argnames="train")(
        {"params": jax.random.PRNGKey(2)},
        jnp.zeros((1, lq, jcfg.t_feat_dim)), jnp.ones((1, lq)),
        jnp.zeros((1, lv, jcfg.total_v_feat_dim)), jnp.ones((1, lv)),
        train=False,
    )
    params = jax.tree.map(np.asarray, params)
    apply = jax.jit(lambda p, *a: jmodel.apply(p, *a[:4], point_valid=a[4], train=False))
    cfg = from_preset("tacos", **SMALL)
    model = FlashVTGModel(cfg.model_config()).eval()
    model.load_state_dict(state_dict_from_jax(params, cfg.model_config()), strict=True)
    return cfg, params, apply, model


def test_tacos_preset_shapes_load_strict():
    """The full-size tacos model (35 dummies, 8 ACA, 3 dummy-encoder layers,
    2 conv layers) has the parameter names state_dict_from_jax writes."""
    from flashvtg_tpu.utils.torch_convert import export_state_dict

    cfg = from_preset("tacos")
    jmodel = JaxModel(jax_preset("tacos").model_config())
    shapes = jax.eval_shape(
        lambda: jmodel.init(
            {"params": jax.random.PRNGKey(0)},
            jnp.zeros((1, cfg.max_q_l, cfg.t_feat_dim)), jnp.ones((1, cfg.max_q_l)),
            jnp.zeros((1, 16, cfg.total_v_feat_dim)), jnp.ones((1, 16)),
            train=False,
        )
    )
    params = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    sd = state_dict_from_jax(params, cfg.model_config())
    assert list(sd) == list(export_state_dict(params, jax_preset("tacos").model_config()))
    model = FlashVTGModel(cfg.model_config())
    model.load_state_dict(sd, strict=True)
    assert len(model.transformer.t2v_encoder.layers) == 8
    assert len(model.txtproj_encoder.layers) == 3
    assert model.dummy_rep_token.shape == (35, 256)
    assert len(model.class_head.convs) == 2


def _inputs(cfg, v_lens, q_lens, seed):
    rng = np.random.default_rng(seed)
    lv, lq = cfg.max_v_l, cfg.max_q_l
    txt_mask = (np.arange(lq)[None] < np.asarray(q_lens)[:, None]).astype(np.float32)
    vid_mask = (np.arange(lv)[None] < np.asarray(v_lens)[:, None]).astype(np.float32)
    src_txt = rng.standard_normal((B, lq, cfg.t_feat_dim), dtype=np.float32)
    src_vid = rng.standard_normal((B, lv, cfg.total_v_feat_dim), dtype=np.float32)
    return src_txt * txt_mask[..., None], txt_mask, src_vid * vid_mask[..., None], vid_mask


@pytest.mark.parametrize("v_lens", [(300, 300, 300), (300, 201, 37)], ids=["full", "ragged"])
def test_tacos_forward_and_decode_match_jax(pair, v_lens):
    cfg, params, apply, model = pair
    arrs = _inputs(cfg, v_lens, (10, 6, 5), seed=sum(v_lens))
    strict = pyramid_masks_strict(np.asarray(v_lens), cfg.max_v_l, cfg.strides)[0]
    jout = apply(params, *map(jnp.asarray, arrs), jnp.asarray(strict))
    with torch.no_grad():
        tout = model(*map(torch.from_numpy, arrs), point_valid=torch.from_numpy(strict))
    vm = arrs[3] > 0
    for key in ("saliency_scores", "t2vattnvalues"):
        np.testing.assert_allclose(
            tout[key].numpy()[vm], np.asarray(jout[key])[vm], atol=2e-4, err_msg=key
        )
    np.testing.assert_allclose(
        tout["attn_weights"].numpy(), np.asarray(jout["attn_weights"]), atol=2e-4
    )
    for key in ("out_class", "out_coord"):
        np.testing.assert_allclose(
            tout[key].numpy(), np.asarray(jout[key]), atol=3e-4, rtol=1e-5, err_msg=key
        )
    js, jsc = jax_decode(jout["out_class"], jout["out_coord"], jout["point"],
                         cfg.clip_length, point_valid=jnp.asarray(strict), top_k=50)
    ts, tsc = decode_boundaries(tout["out_class"], tout["out_coord"], tout["point"],
                                cfg.clip_length, torch.from_numpy(strict), 50)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=2e-3)
    np.testing.assert_allclose(tsc.numpy(), np.asarray(jsc), atol=2e-4)


TACOS_QUERIES = 10  # batches of 4 and 4, then the 2 tail


@pytest.fixture(scope="module")
def tacos_runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tacos"))
    ann, vdir, qdir = make_synthetic_tacos(
        root, n_queries=TACOS_QUERIES, v_dim=48, t_dim=32, max_clips=300,
        min_clips=20, seed=4, max_q_tokens=10,
    )
    data = dict(eval_path=ann, v_feat_dirs=(vdir,), t_feat_dir=qdir, eval_bsz=4,
                nms_thd=0.7)
    jcfg = jax_preset("tacos", **SMALL, **data, device_feed="off")
    jmodel = jcfg.build_model()
    lv, lq = jcfg.max_v_l, jcfg.max_q_l
    params = jax.jit(jmodel.init, static_argnames="train")(
        {"params": jax.random.PRNGKey(3)},
        jnp.zeros((1, lq, jcfg.t_feat_dim)), jnp.ones((1, lq)),
        jnp.zeros((1, lv, jcfg.total_v_feat_dim)), jnp.ones((1, lv)),
        train=False,
    )
    jds = JaxDataset(_dataset_cfg(jcfg, ann, load_labels=False))
    j_sub, j_nms, _ = jax_run(jcfg, jmodel, params, jds)

    cfg = from_preset("tacos", **SMALL, **data)
    model = FlashVTGModel(cfg.model_config()).eval()
    model.load_state_dict(
        state_dict_from_jax(jax.tree.map(np.asarray, params), cfg.model_config()),
        strict=True,
    )
    ds = VTGDataset(eval_data_config(cfg, ann))
    t_sub, t_nms, _ = run_mr_inference(cfg, model, ds)
    return dict(jax=(j_sub, j_nms), port=(t_sub, t_nms), gt=ds.data, ds=ds)


def test_tacos_writer_rows(tacos_runs):
    rows = tacos_runs["gt"]
    assert len(rows) == TACOS_QUERIES
    assert all(isinstance(r["qid"], str) for r in rows)
    assert all("saliency_scores" not in r and "relevant_clip_ids" not in r for r in rows)
    lens = [len(tacos_runs["ds"][i][1]["video_feat"]) for i in range(TACOS_QUERIES)]
    assert lens[0] == 300 and min(lens) < 300 and all(20 <= n <= 300 for n in lens)
    for r, n in zip(rows, lens):
        (s, e), = r["relevant_windows"]
        assert 0 <= s < e <= r["duration"] == n * 2.0


@pytest.mark.parametrize("which", ["plain", "nms"])
def test_tacos_submissions_match_jax(tacos_runs, which):
    k = 0 if which == "plain" else 1
    ours, ref = tacos_runs["port"][k], tacos_runs["jax"][k]
    assert len(ours) == len(ref) == TACOS_QUERIES
    for a, b in zip(ours, ref):
        assert (a["qid"], a["vid"], a["query"]) == (b["qid"], b["vid"], b["query"])
        assert isinstance(a["qid"], str)
        assert "pred_saliency_scores" not in a and "pred_saliency_scores" not in b
        pa = np.asarray(a["pred_relevant_windows"], np.float64)
        pb = np.asarray(b["pred_relevant_windows"], np.float64)
        assert pa.shape == pb.shape, a["qid"]
        np.testing.assert_allclose(pa, pb, atol=2e-3, rtol=0)


@pytest.mark.parametrize("which", ["plain", "nms"])
def test_tacos_brief_metrics_match_jax(tacos_runs, which):
    k = 0 if which == "plain" else 1
    ours = eval_submission(tacos_runs["port"][k], tacos_runs["gt"])["brief"]
    ref = jax_eval(tacos_runs["jax"][k], tacos_runs["gt"], verbose=False)["brief"]
    assert list(ours) == list(ref) and "MR-full-mIoU" in ours
    assert not any(key.startswith("HL-") for key in ours)
    for key, v in ref.items():
        assert np.isfinite(ours[key]) and abs(ours[key] - v) <= 0.02, (key, ours[key], v)
