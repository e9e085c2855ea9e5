"""The attention backward of the port vs autograd and vs the JAX package, on
the CPU.

On the CPU every attention Function (ops/aca.py, ops/chunked_attn.py) runs
its plain forward and its explicit plain backward (`aca_attention_bwd_plain`,
`flash_attention_bwd_plain`), the formulas the CUDA backward kernels use.
Held here:
  * the plain backward functions against torch.autograd of the plain
    forwards (float64, 1e-12), with dropout on and off;
  * flash_attention_bwd_plain against jax.vjp of the JAX package's
    chunked_attention (flashvtg_tpu/ops/chunked_attn.py) at L 129 and 300
    with ragged and holed masks (f32, atol 1e-5: the two sum in other
    orders);
  * the JAX AdaptiveCrossAttention and T2VEncoderLayer with donor rows and
    dummies, on dq, dk, dv through the output and the head-mean map, and the
    layer's parameter gradients (f32, atol 1e-5, and rtol 1e-5 for the
    parameters, whose gradients sum over every element);
  * torch.autograd.gradcheck (fast mode) in float64 on each Function with
    dropout on;
  * the dropout hash: the same mask for the same seed, a keep rate within
    3 sigma of 1 - p, and a mask that follows the seed.
The CUDA kernels run only on the card: tests/test_torch_kernels.py and
chip_smoke.py hold them against these plain versions there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashvtg_tpu.models.transformer import AdaptiveCrossAttention as JaxACA
from flashvtg_tpu.models.transformer import T2VEncoderLayer as JaxT2VLayer
from flashvtg_tpu.models.transformer import neg_pass_donors as jax_neg_donors
from flashvtg_tpu.models.transformer import tiled_attn_donors as jax_tiled_donors
from flashvtg_tpu.ops.chunked_attn import chunked_attention
from flashvtg_tpu_torch.models.transformer import (
    AdaptiveCrossAttention,
    T2VEncoderLayer,
    neg_pass_donors,
    tiled_attn_donors,
)
from flashvtg_tpu_torch.ops import aca, chunked_attn
from flashvtg_tpu_torch.ops.attn_dropout import keep_scale
from flashvtg_tpu_torch.utils.convert import _inv_t2v_layer

ATOL = 1e-5


def _valid(b, length, rng, always=0):
    """Ragged key masks: a valid prefix per row, and one row with holes."""
    lens = rng.integers(max(1, always), length + 1, b)
    lens[0] = length
    valid = (np.arange(length)[None] < lens[:, None]).astype(np.float32)
    valid[-1] = (rng.random(length) < 0.4).astype(np.float32)
    valid[-1, : max(always, 4)] = 1.0
    return valid


def _leaves(*arrays, dtype=torch.float64):
    return [torch.from_numpy(a).to(dtype).requires_grad_() for a in arrays]


@pytest.mark.parametrize("p", [0.0, 0.3])
def test_aca_bwd_plain_matches_autograd(p):
    rng = np.random.default_rng(1)
    b, lq, lk, heads, nd = 3, 11, 17, 2, 4
    q, k, v = (rng.standard_normal((b, n, heads * 32)) for n in (lq, lk, lk))
    valid = _valid(b, lk, rng, always=nd).astype(np.float64)
    query_valid = torch.from_numpy(_valid(b, lq, rng).astype(np.float64))
    donors = tiled_attn_donors(b, heads)
    tq, tk, tv = _leaves(q, k, v)
    kv = torch.from_numpy(valid)
    out, hm, lse = aca.aca_attention_plain(tq, tk, tv, kv, heads, nd, True, p, 9,
                                           query_valid, donors, want_lse=True)
    d_out, d_hm = torch.randn_like(out), torch.randn_like(hm)
    want = torch.autograd.grad((out * d_out).sum() + (hm * d_hm).sum(), (tq, tk, tv))
    got = aca.aca_attention_bwd_plain(tq.detach(), tk.detach(), tv.detach(), kv,
                                      lse.detach(), d_out, d_hm, heads, nd, p, 9,
                                      query_valid, donors)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-12)


@pytest.mark.parametrize("p", [0.0, 0.2])
def test_flash_bwd_plain_matches_autograd(p, monkeypatch):
    monkeypatch.setattr(chunked_attn, "PLAIN_CHUNK", 16)  # several query chunks
    rng = np.random.default_rng(2)
    b, length, heads = 3, 45, 2
    q, k, v = (rng.standard_normal((b, length, heads * 32)) for _ in range(3))
    kv = torch.from_numpy(_valid(b, length, rng).astype(np.float64))
    tq, tk, tv = _leaves(q, k, v)
    out, lse = chunked_attn.flash_attention_plain(tq, tk, tv, kv, heads, p, 3, want_lse=True)
    d_out = torch.randn_like(out)
    want = torch.autograd.grad((out * d_out).sum(), (tq, tk, tv))
    got = chunked_attn.flash_attention_bwd_plain(tq.detach(), tk.detach(), tv.detach(), kv,
                                                 out.detach(), lse.detach(), d_out, heads,
                                                 p, 3)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-12)


@pytest.mark.parametrize("chunk", [16, 128])
@pytest.mark.parametrize("length", [129, 300])
def test_flash_bwd_plain_matches_jax_vjp(length, chunk):
    """The port's backward (its Function on the CPU: plain forward + plain
    backward) against jax.vjp of the JAX chunked attention, whose backward
    rematerialises each query chunk."""
    b, h, dh = 3, 2, 32
    rng = np.random.default_rng(length + chunk)
    q, k, v = (rng.standard_normal((b, length, h * dh), dtype=np.float32) for _ in range(3))
    valid = _valid(b, length, rng)
    d_out = rng.standard_normal((b, length, h * dh), dtype=np.float32)

    def split(x):
        return x.reshape(b, length, h, dh).transpose(0, 2, 1, 3)

    def merge(x):
        return x.transpose(0, 2, 1, 3).reshape(b, length, h * dh)

    def jax_fn(q, k, v):
        out = chunked_attention(split(q) * dh ** -0.5, split(k), split(v), jnp.asarray(valid),
                                chunk_size=chunk)
        return merge(out)

    _, vjp = jax.vjp(jax_fn, *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(d_out))
    tq, tk, tv = _leaves(q, k, v, dtype=torch.float32)
    out = chunked_attn.flash_attention(tq, tk, tv, torch.from_numpy(valid), h)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(d_out))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, err_msg=name)


def test_donor_tables_match_jax():
    for b, h in ((1, 8), (4, 8), (5, 3)):
        np.testing.assert_array_equal(tiled_attn_donors(b, h).numpy(),
                                      np.asarray(jax_tiled_donors(b, h)))
    for rnm in ([1, 1, 1, 1], [1, 0, 1, 0, 1], [0, 0, 0], [0, 1, 1, 0, 0, 1]):
        m = np.asarray(rnm, np.float32)
        np.testing.assert_array_equal(neg_pass_donors(torch.from_numpy(m), 4).numpy(),
                                      np.asarray(jax_neg_donors(jnp.asarray(m), 4)))


def _aca_case(seed):
    """An ACA call with dummies, ragged text, short videos and donor rows."""
    rng = np.random.default_rng(seed)
    b, lv, nd, lt, heads = 4, 23, 3, 9, 2
    d = heads * 32
    lk = nd + lt
    q = rng.standard_normal((b, lv, d), dtype=np.float32)
    k = rng.standard_normal((b, lk, d), dtype=np.float32)
    v = rng.standard_normal((b, lk, d), dtype=np.float32)
    key_valid = _valid(b, lk, rng, always=nd + 1)
    vid_valid = _valid(b, lv, rng)
    donors = np.asarray(jax_tiled_donors(b, heads))
    d_out = rng.standard_normal((b, lv, d), dtype=np.float32)
    d_hm = rng.standard_normal((b, lv, lk), dtype=np.float32)
    return (b, lv, nd, heads, d), (q, k, v, key_valid, vid_valid, donors, d_out, d_hm)


def test_aca_layer_grads_match_jax():
    """dq, dk, dv of the JAX ACA layer (out_proj included) under cotangents on
    its output and on its head-mean map, with donor rows: the port's layer
    runs its Function (plain forward + plain backward) on the CPU."""
    (b, lv, nd, heads, d), (q, k, v, kvalid, vvalid, donors, d_out, d_hm) = _aca_case(3)
    jmod = JaxACA(heads, nd, dropout=0.0)
    params = jmod.init(jax.random.PRNGKey(0), q, k, v, kvalid)

    def fn(q, k, v):
        return jmod.apply(params, q, k, v, jnp.asarray(kvalid), query_valid=jnp.asarray(vvalid),
                          donor_rows=jnp.asarray(donors))

    (jout, jhm), vjp = jax.vjp(fn, *map(jnp.asarray, (q, k, v)))
    want = vjp((jnp.asarray(d_out), jnp.asarray(d_hm)))

    layer = AdaptiveCrossAttention(d, heads, nd, dropout=0.0)
    dense = params["params"]["out_proj"]
    layer.out_proj.load_state_dict({"weight": torch.tensor(np.asarray(dense["kernel"]).T),
                                    "bias": torch.tensor(np.asarray(dense["bias"]))})
    tq, tk, tv = _leaves(q, k, v, dtype=torch.float32)
    out, hm = layer(tq, tk, tv, torch.from_numpy(kvalid), torch.from_numpy(vvalid),
                    torch.from_numpy(donors))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), atol=ATOL)
    np.testing.assert_allclose(hm.detach().numpy(), np.asarray(jhm), atol=ATOL)
    got = torch.autograd.grad((out, hm), (tq, tk, tv),
                              (torch.from_numpy(d_out), torch.from_numpy(d_hm)))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, err_msg=name)
    # the dummies' values never reach the output
    assert torch.equal(got[2][:, :nd], torch.zeros_like(got[2][:, :nd]))


def test_t2v_layer_grads_match_jax():
    """A whole ACA layer (attention, FFN, both LayerNorms) with donor rows:
    input gradients of the video, text and both position tensors, and every
    parameter's gradient through utils/convert.py's mapping."""
    (b, lv, nd, heads, d), (vid, txt, _, kvalid, vvalid, donors, d_out, d_hm) = _aca_case(4)
    rng = np.random.default_rng(5)
    pos_vid = rng.standard_normal(vid.shape, dtype=np.float32)
    pos_txt = rng.standard_normal(txt.shape, dtype=np.float32)
    jlayer = JaxT2VLayer(heads, nd, 96, dropout=0.0)
    args = tuple(map(jnp.asarray, (vid, txt, pos_vid, pos_txt)))
    params = jlayer.init(jax.random.PRNGKey(1), *args, jnp.asarray(kvalid))

    def fn(p, vid, txt, pos_vid, pos_txt):
        return jlayer.apply(p, vid, txt, pos_vid, pos_txt, jnp.asarray(kvalid),
                            vid_valid=jnp.asarray(vvalid), donor_rows=jnp.asarray(donors))

    (jx, jw), vjp = jax.vjp(fn, params, *args)
    jgrads = vjp((jnp.asarray(d_out), jnp.asarray(d_hm)))

    layer = T2VEncoderLayer(d, heads, nd, 96, dropout=0.0)
    sd, gsd = {}, {}
    _inv_t2v_layer(sd, "L", jax.tree.map(np.asarray, params["params"]))
    _inv_t2v_layer(gsd, "L", jax.tree.map(np.asarray, jgrads[0]["params"]))
    layer.load_state_dict({k[2:]: torch.tensor(v) for k, v in sd.items()}, strict=True)
    leaves = _leaves(vid, txt, pos_vid, pos_txt, dtype=torch.float32)
    x, w = layer(*leaves, torch.from_numpy(kvalid), torch.from_numpy(vvalid),
                 torch.from_numpy(donors))
    np.testing.assert_allclose(x.detach().numpy(), np.asarray(jx), atol=ATOL)
    ((x * torch.from_numpy(d_out)).sum() + (w * torch.from_numpy(d_hm)).sum()).backward()
    for name, leaf, want in zip(("vid", "txt", "pos_vid", "pos_txt"), leaves, jgrads[1:]):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(want), atol=ATOL, err_msg=name)
    for name, param in layer.named_parameters():
        # rtol too: PReLU's slope sums its gradient over every element
        np.testing.assert_allclose(param.grad.numpy(), gsd["L." + name].reshape(param.shape),
                                   rtol=1e-5, atol=ATOL, err_msg=name)


def test_aca_function_gradcheck_with_dropout():
    rng = np.random.default_rng(6)
    b, lq, lk, heads, nd = 2, 5, 7, 2, 2
    q, k, v = _leaves(*(rng.standard_normal((b, n, heads * 32)) for n in (lq, lk, lk)))
    kv = torch.from_numpy(_valid(b, lk, rng, always=nd + 1).astype(np.float64))
    qv = torch.from_numpy(_valid(b, lq, rng).astype(np.float64))
    donors = tiled_attn_donors(b, heads)

    def fn(q, k, v):
        return aca._AttentionFn.apply(q, k, v, kv, qv, donors, heads, nd, True, 0.4, 77,
                                      "aca_attention", "3xtf32")

    assert torch.autograd.gradcheck(fn, (q, k, v), fast_mode=True)

    def masked(q, k, v):
        return aca._AttentionFn.apply(q, k, v, kv, None, None, heads, 0, False, 0.4, 78,
                                      "masked_attention", "3xtf32")

    assert torch.autograd.gradcheck(masked, (q[:, :lk].detach().requires_grad_(), k, v),
                                    fast_mode=True)


def test_flash_function_gradcheck_with_dropout(monkeypatch):
    monkeypatch.setattr(chunked_attn, "PLAIN_CHUNK", 4)
    rng = np.random.default_rng(7)
    b, length, heads = 2, 9, 2
    q, k, v = _leaves(*(rng.standard_normal((b, length, heads * 32)) for _ in range(3)))
    kv = torch.from_numpy(_valid(b, length, rng).astype(np.float64))

    def fn(q, k, v):
        return chunked_attn._FlashFn.apply(q, k, v, kv, heads, 0.4, 79, "3xtf32")

    assert torch.autograd.gradcheck(fn, (q, k, v), fast_mode=True)


def test_dropout_hash_is_deterministic_and_keeps_one_minus_p():
    rows = torch.arange(256)
    for p in (0.1, 0.5):
        z = keep_scale(11, p, 4, 8, rows, 300)
        assert torch.equal(z, keep_scale(11, p, 4, 8, rows, 300))
        kept = (z > 0).double().mean().item()
        n = z.numel()
        assert abs(kept - (1 - p)) <= 3 * np.sqrt(p * (1 - p) / n), (p, kept)
        assert torch.allclose(z[z > 0], torch.full_like(z[z > 0], 1 / (1 - p)))
        # another seed, another mask; a row range is a slice of the whole
        assert not torch.equal(z, keep_scale(12, p, 4, 8, rows, 300))
        assert torch.equal(z[:, :, 100:140], keep_scale(11, p, 4, 8, rows[100:140], 300))
