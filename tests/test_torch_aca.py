"""The port's attention core (ops/aca.py) vs the JAX side, on the CPU.

The plain twin is held against the Pallas ACA kernel of scripts/bench_aca.py
in interpret mode, and the port's T2VEncoderLayer / EncoderLayer (weights
carried over) against the JAX layers, with padded text and video rows, at
atol 1e-5 on out and on the head mean. The CUDA kernel itself runs only on
the card: tests/test_torch_kernels.py and chip_smoke.py hold it against the
twin there.
"""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch_threads  # noqa: F401  (torch's share of the cores under xdist)
import torch

from flashvtg_tpu.models.transformer import EncoderLayer as JaxEncoderLayer
from flashvtg_tpu.models.transformer import T2VEncoderLayer as JaxT2VLayer
from flashvtg_tpu_torch.models.transformer import EncoderLayer, T2VEncoderLayer
from flashvtg_tpu_torch.ops import aca
from flashvtg_tpu_torch.utils.convert import _inv_encoder_layer, _inv_t2v_layer

REPO = pathlib.Path(__file__).resolve().parent.parent
ATOL = 1e-5


@pytest.fixture(scope="module")
def bench_aca():
    spec = importlib.util.spec_from_file_location(
        "bench_aca_script", REPO / "scripts" / "bench_aca.py"
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _qkv(b, h, lv, lk, dh, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, lv, h * dh), dtype=np.float32)
    k = rng.standard_normal((b, lk, h * dh), dtype=np.float32)
    v = rng.standard_normal((b, lk, h * dh), dtype=np.float32)
    return q, k, v


def _split(x, h):
    b, l, d = x.shape
    return x.reshape(b, l, h, d // h).transpose(0, 2, 1, 3)


def test_plain_aca_matches_pallas_interpret(bench_aca):
    b, h, lv, lk, dh, nd = 2, 8, 75, 42, 32, 10
    q, k, v = _qkv(b, h, lv, lk, dh)
    valid = np.ones((b, lk), np.float32)
    valid[1, -1] = 0.0  # one padded key row
    # the Pallas kernel takes q pre-scaled, in (B, H, L, Dh)
    q_scaled = (torch.from_numpy(q) * dh ** -0.5).numpy()
    out_p, probs_p = bench_aca.aca_attention(
        jnp.asarray(_split(q_scaled, h)), jnp.asarray(_split(k, h)),
        jnp.asarray(_split(v, h)), jnp.asarray(valid), num_dummies=nd,
        interpret=True,
    )
    out, head_mean = aca.aca_attention(
        *map(torch.from_numpy, (q, k, v, valid)), num_heads=h, num_dummies=nd
    )
    out_p = np.asarray(out_p).transpose(0, 2, 1, 3).reshape(b, lv, h * dh)
    np.testing.assert_allclose(out.numpy(), out_p, atol=ATOL)
    np.testing.assert_allclose(
        head_mean.numpy(), np.asarray(probs_p).sum(1) / h, atol=ATOL
    )
    assert head_mean[1, :, -1].abs().max() == 0  # masked key gets no weight


def _layer_inputs(b, lv, lq, d, nd, seed):
    rng = np.random.default_rng(seed)
    vid = rng.standard_normal((b, lv, d), dtype=np.float32)
    pos_vid = rng.standard_normal((b, lv, d), dtype=np.float32)
    txt = rng.standard_normal((b, nd + lq, d), dtype=np.float32)
    pos_txt = rng.standard_normal((b, nd + lq, d), dtype=np.float32)
    txt_valid = np.ones((b, nd + lq), np.float32)
    txt_valid[1, nd + 3 :] = 0  # padded text row
    vid_valid = np.ones((b, lv), np.float32)
    vid_valid[1, 7:] = 0  # padded video row
    return vid, pos_vid, txt, pos_txt, txt_valid, vid_valid


def _load(module, inv_fn, params):
    sd = {}
    inv_fn(sd, "L", jax.tree.map(np.asarray, params["params"]))
    module.load_state_dict(
        {k[2:]: torch.tensor(v) for k, v in sd.items()}, strict=True
    )
    return module.eval()


@pytest.mark.parametrize("d,heads,nd", [(64, 2, 3), (256, 8, 10)])
def test_t2v_layer_matches_jax(d, heads, nd):
    b, lv, lq = 2, 12, 6
    vid, pos_vid, txt, pos_txt, txt_valid, _ = _layer_inputs(b, lv, lq, d, nd, 1)
    jl = JaxT2VLayer(heads, nd, 2 * d, 0.0)
    args = tuple(map(jnp.asarray, (vid, txt, pos_vid, pos_txt, txt_valid)))
    params = jax.jit(jl.init)(jax.random.PRNGKey(0), *args)
    jx, jw = jax.jit(jl.apply)(params, *args)
    layer = _load(T2VEncoderLayer(d, heads, nd, 2 * d), _inv_t2v_layer, params)
    with torch.no_grad():
        tx, tw = layer(*map(torch.from_numpy, (vid, txt, pos_vid, pos_txt, txt_valid)))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=ATOL)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=ATOL)


@pytest.mark.parametrize("d,heads", [(64, 2), (256, 8)])
def test_encoder_layer_matches_jax(d, heads):
    b, lv = 2, 12
    x, pos, _, _, _, valid = _layer_inputs(b, lv, 1, d, 0, 2)
    jl = JaxEncoderLayer(heads, 2 * d, 0.0)
    args = tuple(map(jnp.asarray, (x, pos, valid)))
    params = jax.jit(jl.init)(jax.random.PRNGKey(0), *args)
    jx = jax.jit(jl.apply)(params, *args)
    layer = _load(EncoderLayer(d, heads, 2 * d), _inv_encoder_layer, params)
    with torch.no_grad():
        tx = layer(*map(torch.from_numpy, (x, pos, valid)))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=ATOL)


def test_cpu_tensors_take_the_twin_and_count_nothing():
    q, k, v = _qkv(2, 8, 20, 14, 32, seed=3)
    valid = np.ones((2, 14), np.float32)
    t = tuple(map(torch.from_numpy, (q, k, v, valid)))
    aca.reset_launch_counts()
    out, hm = aca.aca_attention(*t, num_heads=8, num_dummies=4)
    ref_out, ref_hm = aca.aca_attention_plain(*t, 8, 4)
    assert torch.equal(out, ref_out) and torch.equal(hm, ref_hm)
    sa = aca.masked_attention(*t, num_heads=8)
    assert torch.equal(sa, aca.masked_attention_plain(*t, 8))
    assert aca.aca_attention(*t, num_heads=8, num_dummies=4, want_head_mean=False)[1] is None
    assert aca.launch_counts() == {"aca_attention": 0, "masked_attention": 0,
                                   "aca_attention_bwd": 0, "masked_attention_bwd": 0}


def test_masked_attention_is_aca_with_no_dummies():
    q, k, v = _qkv(2, 2, 9, 9, 32, seed=4)
    valid = np.ones((2, 9), np.float32)
    valid[0, 5:] = 0
    t = tuple(map(torch.from_numpy, (q, k, v, valid)))
    sa = aca.masked_attention(*t, num_heads=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", *(x.view(2, 9, 2, 32) for x in t[:2]))
    logits = logits / 32 ** 0.5
    logits = logits.masked_fill(t[3][:, None, None, :] == 0, float("-inf"))
    ref = torch.einsum("bhqk,bkhd->bqhd", logits.softmax(-1), t[2].view(2, 9, 2, 32))
    np.testing.assert_allclose(sa.numpy(), ref.reshape(2, 9, 64).numpy(), atol=ATOL)


def test_wrapper_refuses_other_devices():
    q = torch.empty((1, 4, 32), device="meta")
    with pytest.raises(ValueError, match="expected CPU or CUDA"):
        aca.aca_attention(q, q, q, torch.empty((1, 4), device="meta"), 1, 0)

