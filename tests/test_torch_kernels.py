"""The CUDA attention kernels (csrc/aca_attention.cu, csrc/flash_attention.cu,
their training forms, and the backward kernels csrc/aca_attention_bwd.cu and
csrc/flash_attention_bwd.cu) and the LayerNorm kernels (csrc/layer_norm.cu)
vs their plain versions, on the card. Every
test here needs CUDA and skips without it: the kernels have no CPU mode.
The file imports torch and the port only, so it also runs on a machine
without JAX:

    python -m pytest --noconftest -q -m cuda tests/test_torch_kernels.py

Tolerance: atol 1e-5 on out and head_mean; both sides are f32-accurate
(every kernel's products on the tensor cores in 3xTF32, never 1xTF32), and
differ in the order of their sums (the flash kernel's online softmax adds a
rescale per key chunk).
Gradients: see GRAD_RTOL below.
"""

import re

import numpy as np
import pytest
import torch_threads  # noqa: F401  (torch's share of the cores under xdist)
import torch

from flashvtg_tpu_torch.ops import aca, chunked_attn
from flashvtg_tpu_torch.utils.runtime import matmul_precision

pytestmark = pytest.mark.cuda

ATOL = 1e-5
# the precision dial of each product form the tests run
DIALS = {"3xtf32": "float32", "bf16": "bfloat16"}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(b, lv, lk, heads, seed, pad_from=None):
    g = torch.Generator().manual_seed(seed)
    d = heads * 32
    q, k, v = (torch.randn((b, n, d), generator=g) for n in (lv, lk, lk))
    valid = torch.ones((b, lk))
    if pad_from is not None:
        for i in range(b):
            valid[i, max(1, pad_from - i) :] = 0
    return q, k, v, valid


@pytest.mark.parametrize(
    "b,lv,lk,heads,nd,pad_from",
    [
        (256, 75, 42, 8, 10, 30),  # flagship ACA
        (7, 33, 128, 8, 10, 100),  # most keys the kernel takes
        (3, 16, 1, 2, 1, None),  # one key: the dummy only
        (5, 1, 20, 1, 0, 12),
        (2, 130, 75, 8, 10, 50),  # three uneven row tiles
        (8, 2048, 75, 8, 35, 60),  # TACoS ACA: 26 row tiles, 35 dummies
        # the mma tiling's edges: 8-key n-tiles, 16-row warp tiles
        (4, 9, 7, 2, 2, 5),  # Lk 7: one n-tile, one key short
        (4, 16, 8, 2, 3, 6),  # Lk 8: one whole n-tile, Lv one warp tile
        (4, 17, 9, 2, 3, 7),  # Lk 9: one key past it, Lv one row past a warp tile
        (3, 80, 127, 4, 10, 100),  # Lk 127, Lv 80: five warp tiles
        (3, 15, 128, 4, 10, None),  # Lk 128, Lv one row short of a warp tile
        (6, 1, 42, 8, 10, 30),  # Lv 1
    ],
)
@pytest.mark.parametrize("form", ["3xtf32", "bf16"])
def test_aca_kernel_matches_twin(cuda, form, b, lv, lk, heads, nd, pad_from):
    """The eval forward through the wrapper at the dial of `form` against the
    plain version at the same form: 3xTF32 within 1e-5, bf16 (its own body
    on mma.sync.m16n8k16) within FORM_RTOL."""
    t = tuple(x.to(cuda) for x in _inputs(b, lv, lk, heads, 0, pad_from))
    before = aca.FORM_LAUNCHES[form]["aca_attention"]
    with matmul_precision(DIALS[form], cuda):
        out, hm = aca.aca_attention(*t, num_heads=heads, num_dummies=nd)
        again = aca.aca_attention(*t, num_heads=heads, num_dummies=nd)
    assert aca.FORM_LAUNCHES[form]["aca_attention"] == before + 2
    ref_out, ref_hm = aca.aca_attention_plain(*t, heads, nd, form=form)
    _assert_forward(out, ref_out, form)
    _assert_forward(hm, ref_hm, form)
    # the head mean is summed in a fixed order: launches agree bit for bit
    assert torch.equal(again[0], out) and torch.equal(again[1], hm)


@pytest.mark.parametrize(
    "b,l,pad_from",
    [(256, 42, 30), (256, 75, 60), (9, 128, 70),
     # the mma tiling's edges
     (3, 1, None), (4, 7, 5), (4, 8, 6), (4, 9, 7), (4, 17, 12), (3, 127, 90)],
)
@pytest.mark.parametrize("form", ["3xtf32", "bf16"])
def test_masked_attention_kernel_matches_twin(cuda, form, b, l, pad_from):
    t = tuple(x.to(cuda) for x in _inputs(b, l, l, 8, 1, pad_from))
    before = aca.FORM_LAUNCHES[form]["masked_attention"]
    with matmul_precision(DIALS[form], cuda):
        out = aca.masked_attention(*t, num_heads=8)
    assert aca.FORM_LAUNCHES[form]["masked_attention"] == before + 1
    _assert_forward(out, aca.masked_attention_plain(*t, 8, form), form)


def test_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    q, k, v, valid = (x.to(cuda) for x in _inputs(2, 8, 8, 2, 2))
    with pytest.raises(TypeError):
        aca.aca_attention(q.double(), k, v, valid, 2, 0)
    with pytest.raises(ValueError, match="contiguous"):
        aca.aca_attention(q.transpose(0, 1).contiguous().transpose(0, 1), k, v, valid, 2, 0)
    with pytest.raises(ValueError, match="aligned"):
        shifted = torch.zeros(q.numel() + 1, device=cuda)[1:].view(q.shape)
        aca.aca_attention(shifted, k, v, valid, 2, 0)
    with pytest.raises(ValueError, match="head dim"):
        aca.aca_attention(q, k, v, valid, 4, 0)
    big = torch.zeros((2, 129, 64), device=cuda)
    with pytest.raises(ValueError, match="keys"):
        aca.aca_attention(q, big, big, torch.ones((2, 129), device=cuda), 2, 0)


def test_model_forward_on_card_matches_cpu(cuda):
    """A small model (head dim 32) on the card vs the same weights on the
    CPU (plain twins): every attention core runs the kernel."""
    from flashvtg_tpu_torch.models import ModelConfig, build_model
    from flashvtg_tpu_torch.models.points import pyramid_masks_strict

    cfg = ModelConfig(vid_dim=40, txt_dim=24, hidden_dim=64, nheads=2, dummy_nheads=2,
                      num_dummies=3, dim_feedforward=96, t2v_layers=2, enc_layers=2,
                      dummy_layers=1, kernel_size=5, num_conv_layers=1)
    cpu_model = build_model(cfg, "cpu", seed=0)
    gpu_model = build_model(cfg, cuda, seed=0)
    rng = np.random.default_rng(0)
    lens = np.asarray([20, 13, 7])
    arrs = (
        rng.standard_normal((3, 8, 24), dtype=np.float32),
        (np.arange(8)[None] < np.asarray([8, 5, 2])[:, None]).astype(np.float32),
        rng.standard_normal((3, 20, 40), dtype=np.float32),
        (np.arange(20)[None] < lens[:, None]).astype(np.float32),
        pyramid_masks_strict(lens, 20, cfg.strides)[0],
    )
    aca.reset_launch_counts()
    with torch.no_grad():
        ref = cpu_model(*map(torch.from_numpy, arrs))
        out = gpu_model(*(torch.from_numpy(a).to(cuda) for a in arrs))
    assert aca.launch_counts() == {"aca_attention": 2, "masked_attention": 3,
                                   "aca_attention_bwd": 0, "masked_attention_bwd": 0}
    for key in ("saliency_scores", "t2vattnvalues", "out_class", "out_coord"):
        np.testing.assert_allclose(out[key].cpu().numpy(), ref[key].numpy(), atol=3e-4)



def _assert_forward(out, ref, form):
    """out against the plain version at its form: 3xTF32 within ATOL, the
    rounded forms within FORM_RTOL of max(max |ref|, 0.1)."""
    torch.cuda.synchronize()
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    if form == "3xtf32":
        assert (out - ref).abs().max().item() <= ATOL
    else:
        assert _rel_err(out, ref) <= FORM_RTOL[form]


def _ragged(b, length, seed):
    """Valid prefixes drawn from [1, length], the first row full."""
    lens = np.random.default_rng(seed).integers(1, length + 1, b)
    lens[0] = length
    return torch.from_numpy((np.arange(length)[None] < lens[:, None]).astype(np.float32))


@pytest.mark.parametrize(
    "b,length",
    [
        (3, 129),  # one key past the short kernel; a tile of one key
        (16, 256),  # charades
        (4, 1000),  # tvsum, youtube_uni: not a multiple of the 128-key tile
        (8, 2048),  # TACoS encoder
        (2, 77),  # shorter than one tile
        (2, 1),  # one clip
        (1, chunked_attn.MAX_LEN),  # the largest v_bucket: 32 key tiles
        (3, 15),  # the mma tile edges: one short of a 16-row warp tile
        (3, 17),  # one past it
        (2, 2047),  # one short of the last 128-key tile
    ],
)
@pytest.mark.parametrize("form", ["3xtf32", "bf16"])
def test_flash_kernel_matches_plain(cuda, form, b, length):
    """The eval forward through the wrapper at the dial of `form`, against
    the plain version at the same form: at 3xTF32 within 1e-5, at bf16
    (its own body on mma.sync.m16n8k16) within FORM_RTOL; two launches
    bit-equal."""
    q, k, v, _ = _inputs(b, length, length, 8, 3)
    t = tuple(x.to(cuda) for x in (q, k, v, _ragged(b, length, length)))
    before = chunked_attn.FORM_LAUNCHES[form]["flash_attention"]
    with matmul_precision(DIALS[form], cuda):
        out = chunked_attn.flash_attention(*t, num_heads=8)
        # fixed summation order: launches agree bit for bit
        again = chunked_attn.flash_attention(*t, num_heads=8)
    assert chunked_attn.FORM_LAUNCHES[form]["flash_attention"] == before + 2
    _assert_forward(out, chunked_attn.flash_attention_plain(*t, 8, form=form), form)
    assert torch.equal(again, out)


@pytest.mark.parametrize("form", ["3xtf32", "bf16"])
@pytest.mark.parametrize("case", ["one_key", "holes", "last_key", "all_masked_tiles"])
def test_flash_kernel_any_mask(cuda, case, form):
    b, length = 3, 700
    q, k, v, _ = _inputs(b, length, length, 8, 4)
    rng = np.random.default_rng(5)
    valid = np.zeros((b, length), np.float32)
    if case == "one_key":
        valid[np.arange(b), rng.integers(0, length, b)] = 1.0
    elif case == "holes":  # not a prefix: random keys, every row has some
        valid = (rng.random((b, length)) < 0.3).astype(np.float32)
    elif case == "last_key":
        valid[:, -1] = 1.0
    else:  # valid keys only in the second and last 128-key tiles
        valid[:, 130:140] = 1.0
        valid[:, 650:] = 1.0
    t = tuple(x.to(cuda) for x in (q, k, v, torch.from_numpy(valid)))
    out = chunked_attn._launch(*t, 8, form=form)
    _assert_forward(out, chunked_attn.flash_attention_plain(*t, 8, form=form), form)
    assert torch.equal(chunked_attn._launch(*t, 8, form=form), out)


@pytest.mark.parametrize("form", ["3xtf32", "bf16"])
def test_flash_kernel_row_without_valid_key_is_zero(cuda, form):
    q, k, v, _ = _inputs(2, 300, 300, 8, 6)
    valid = torch.ones((2, 300))
    valid[1] = 0
    t = tuple(x.to(cuda) for x in (q, k, v, valid))
    out = chunked_attn._launch(*t, 8, form=form)
    ref = chunked_attn.flash_attention_plain(*t, 8, form=form)
    torch.cuda.synchronize()
    assert torch.equal(out[1], torch.zeros_like(out[1]))
    _assert_forward(out[0], ref[0], form)
    assert torch.equal(chunked_attn._launch(*t, 8, form=form), out)


@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("form", ["3xtf32", "bf16"])
def test_flash_one_key_row_is_exact(cuda, form, p):
    """A batch row with one valid key j: the training forward's lse is
    exactly its logit, so the backward recomputes P = 1 exactly there. At
    p = 0, dS' = P (dP - D') then cancels to exactly 0 and dk is exactly 0
    over the row, at 3xTF32 and, since the forward takes S on the
    backward's dot_bf16, at bf16; and at bf16 every query row's out is
    bf16(v_j) bit for bit (P = 1 rounds to 1; the other keys' P are 0).
    Dropout leaves the forward's softmax statistics alone: lse at p = 0.1 is
    the p = 0 lse bit for bit. There dS' = P (z dP - D') keeps the rounding
    of z dP (the backward's fused multiply-add takes z dP unrounded, D' it
    rounded), at every form: dk is rounding, within 1e-6 of max |dv|."""
    b, length = 3, 700
    q, k, v, _ = _inputs(b, length, length, 8, 27)
    keys = np.random.default_rng(28).integers(0, length, b)
    keys[1] = length - 1  # the last key of the last, partial tile
    valid = torch.zeros((b, length))
    valid[torch.arange(b), torch.from_numpy(keys)] = 1.0
    t = [x.to(cuda) for x in (q, k, v, valid)]
    out, lse = chunked_attn._launch(*t, 8, p, 99, want_lse=True, form=form)
    d_out = torch.randn(q.shape, generator=torch.Generator().manual_seed(29)).to(cuda)
    dq, dk, dv = chunked_attn._launch_bwd(*t, out, lse, d_out, 8, p, 99, form=form)
    torch.cuda.synchronize()
    assert all(torch.isfinite(x).all() for x in (out, lse, dq, dk, dv))
    if p == 0.0:
        assert torch.equal(dk, torch.zeros_like(dk))
        if form == "bf16":
            vj = t[2][torch.arange(b, device=cuda), torch.from_numpy(keys).to(cuda)]
            assert torch.equal(out, vj.to(torch.bfloat16).float()[:, None, :].expand_as(out))
    else:
        lse0 = chunked_attn._launch(*t, 8, 0.0, 99, want_lse=True, form=form)[1]
        assert torch.equal(lse, lse0)
        assert dk.abs().max().item() <= 1e-6 * dv.abs().max().item()


def test_flash_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    q, k, v, valid = (x.to(cuda) for x in _inputs(2, 200, 200, 2, 7))
    with pytest.raises(TypeError):
        chunked_attn.flash_attention(q.double(), k, v, valid, 2)
    with pytest.raises(TypeError):
        chunked_attn.flash_attention(q, k, v, valid.bool(), 2)
    with pytest.raises(ValueError, match="contiguous"):
        chunked_attn.flash_attention(q.transpose(0, 1).contiguous().transpose(0, 1),
                                     k, v, valid, 2)
    with pytest.raises(ValueError, match="aligned"):
        shifted = torch.zeros(q.numel() + 1, device=cuda)[1:].view(q.shape)
        chunked_attn.flash_attention(shifted, k, v, valid, 2)
    with pytest.raises(ValueError, match="head dim"):
        chunked_attn.flash_attention(q, k, v, valid, 4)
    with pytest.raises(ValueError, match="shapes"):
        chunked_attn.flash_attention(q, k[:, :100].contiguous(), v, valid, 2)
    with pytest.raises(ValueError, match="length"):
        big = torch.zeros((1, chunked_attn.MAX_LEN + 1, 64), device=cuda)
        chunked_attn.flash_attention(big, big, big, torch.ones(big.shape[:2], device=cuda), 2)


def test_tacos_forward_on_card_matches_cpu(cuda):
    """Preset tacos at full width (depth cut to 2 ACA, 2 encoder and 1
    dummy-encoder layers), two videos padded to the 2048-clip bucket, one of
    them short: the encoder runs the flash kernel, the dummy encoder and the
    ACA layers the short one; the CPU runs the plain versions."""
    from flashvtg_tpu_torch.models import build_model
    from flashvtg_tpu_torch.models.points import pyramid_masks_strict
    from flashvtg_tpu_torch.train.config import from_preset

    cfg = from_preset("tacos", t2v_layers=2, enc_layers=2, dummy_layers=1)
    cpu_model = build_model(cfg.model_config(), "cpu", seed=0)
    gpu_model = build_model(cfg.model_config(), cuda, seed=0)
    rng = np.random.default_rng(0)
    lv, lq = cfg.max_v_l, cfg.max_q_l
    v_lens, q_lens = np.asarray([lv, 517]), np.asarray([lq, 9])
    txt_mask = (np.arange(lq)[None] < q_lens[:, None]).astype(np.float32)
    vid_mask = (np.arange(lv)[None] < v_lens[:, None]).astype(np.float32)
    arrs = (
        rng.standard_normal((2, lq, cfg.t_feat_dim), dtype=np.float32) * txt_mask[..., None],
        txt_mask,
        rng.standard_normal((2, lv, cfg.total_v_feat_dim), dtype=np.float32) * vid_mask[..., None],
        vid_mask,
        pyramid_masks_strict(v_lens, lv, cfg.strides)[0],
    )
    aca.reset_launch_counts()
    chunked_attn.reset_launch_counts()
    with torch.no_grad():
        ref = cpu_model(*map(torch.from_numpy, arrs))
        out = gpu_model(*(torch.from_numpy(a).to(cuda) for a in arrs))
    assert aca.launch_counts() == {"aca_attention": 2, "masked_attention": 1,
                                   "aca_attention_bwd": 0, "masked_attention_bwd": 0}
    assert chunked_attn.launch_counts() == {"flash_attention": 2, "flash_attention_bwd": 0}
    for key in ("saliency_scores", "t2vattnvalues", "attn_weights", "out_class", "out_coord"):
        np.testing.assert_allclose(out[key].cpu().numpy(), ref[key].numpy(), atol=3e-4,
                                   err_msg=key)


# --- training forms and backward kernels -----------------------------------
#
# Gradients are held at a relative tolerance: max |kernel - plain| <= 1e-4 x
# max(max |plain|, 0.1) (both f32; the sums over up to 2048 query rows run
# in another order; the floor holds gradients that are 0 up to rounding,
# such as dq of a row with one valid key, where P = 1 and dS = 0 up to
# |dO . v| x eps ~ 1e-6, at 1e-5 absolute). Forwards with dropout on use the same seed on both sides: the keep
# mask is the same hash (ops/attn_dropout.py), so they agree at atol 1e-5.

GRAD_RTOL = 1e-4


def _rel_err(got, ref):
    return ((got - ref).abs().max() / ref.abs().max().clamp_min(0.1)).item()


def _holes(b, n, seed, always=0):
    """(b, n) masks with random holes past `always` leading ones; every row
    keeps at least one key past them."""
    rng = np.random.default_rng(seed)
    m = (rng.random((b, n)) < 0.5).astype(np.float32)
    m[:, :always] = 1.0
    m[:, min(always, n - 1)] = 1.0
    return torch.from_numpy(m)


@pytest.mark.parametrize(
    "b,lv,lk,heads,nd,keys,p,donors,dhm",
    [
        (32, 2048, 75, 8, 35, "ragged", 0.1, True, True),  # TACoS ACA, train: 7 row chunks
        (64, 75, 42, 8, 10, "ragged", 0.1, True, True),  # flagship ACA, train: one 80-row tile
        (32, 75, 75, 8, 0, "ragged", 0.1, False, False),  # TACoS dummy encoder
        (64, 42, 42, 8, 0, "holes", 0.1, False, False),  # flagship dummy encoder, holes
        (5, 130, 128, 8, 10, "holes", 0.3, True, True),  # most keys the kernel takes
        (3, 16, 1, 2, 1, "ragged", 0.0, False, True),  # one key: the dummy only
        (2, 1, 20, 1, 0, "ragged", 0.2, False, False),  # one query row
        # the tiling's edges: 8-key n-tiles, 16-row warp tiles, row chunks
        (3, 33, 1, 2, 0, "ragged", 0.1, False, False),  # Lk 1, short form: one valid key
        (4, 15, 7, 2, 2, "ragged", 0.1, True, True),  # Lk 7, Lv 15
        (4, 16, 8, 2, 3, "holes", 0.1, True, False),  # Lk 8, Lv 16, head mean without gradient
        (4, 17, 9, 2, 3, "ragged", 0.0, False, True),  # Lk 9, Lv 17
        (2, 80, 127, 4, 5, "holes", 0.1, True, True),  # Lk 127, Lv 80
        (2, 80, 128, 4, 0, "ragged", 0.0, False, False),  # Lk 128, short form
        (4, 700, 42, 8, 10, "ragged", 0.1, True, True),  # 3 chunks of 240 rows, the last short
        (2, 2047, 75, 8, 35, "holes", 0.1, True, False),  # 7 chunks, Lv not a multiple
        (4, 300, 75, 2, 0, "one_key", 0.0, False, False),  # short form, one valid key a row
        (4, 300, 75, 2, 0, "one_key", 0.1, False, False),
        (3, 15, 9, 2, 0, "one_key", 0.1, False, False),
    ],
)
@pytest.mark.parametrize("form", ["3xtf32", "bf16"])
def test_aca_train_kernels_match_plain(cuda, form, b, lv, lk, heads, nd, keys, p, donors, dhm):
    """The training forward and the backward against their plain versions:
    at 3xTF32 within 1e-5 (forward) and against float64 (GRAD_RTOL); at
    bf16, whose forward and backward have their own bodies on
    mma.sync.m16n8k16, against the plain versions at the bf16 form, the
    backward's on the kernel forward's log-sum-exp (FORM_RTOL). Two launches
    of the backward bit-equal."""
    from flashvtg_tpu_torch.models.transformer import tiled_attn_donors

    q, k, v, valid = _inputs(b, lv, lk, heads, 11, pad_from=max(nd + 1, lk - 12))
    if keys == "holes":
        valid = _holes(b, lk, 12, always=nd)
    elif keys == "one_key":
        valid = torch.zeros((b, lk))
        valid[torch.arange(b), torch.from_numpy(np.random.default_rng(14).integers(0, lk, b))] = 1.0
    g = torch.Generator().manual_seed(13)
    d_out = torch.randn(q.shape, generator=g)
    d_hm = torch.randn((b, lv, lk), generator=g) if dhm else None
    query_valid = donor_rows = None
    if donors:
        query_valid = (torch.arange(lv)[None] < torch.randint(1, lv + 1, (b, 1), generator=g)).float()
        donor_rows = tiled_attn_donors(b, heads)
    t = [x.to(cuda) for x in (q, k, v, valid)]
    dn = [None if x is None else x.to(cuda) for x in (query_valid, donor_rows)]
    seed = 1234
    out, hm, lse = aca._launch(*t, heads, nd, nd > 0, p, seed, *dn, want_lse=True, form=form)
    ref_out, ref_hm, ref_lse = aca.aca_attention_plain(*t, heads, nd, nd > 0, p, seed, *dn,
                                                       want_lse=True, form=form)
    torch.cuda.synchronize()
    pairs = [(out, ref_out), (lse, ref_lse)] + ([(hm, ref_hm)] if nd else [])
    for got, want in pairs:
        assert torch.isfinite(got).all()
        if form == "3xtf32":
            assert (got - want).abs().max().item() <= ATOL
        else:
            assert _rel_err(got, want) <= FORM_RTOL[form]
    dh = None if d_hm is None else d_hm.to(cuda)
    grads = aca._launch_bwd(*t, lse, d_out.to(cuda), dh, heads, nd, p, seed, *dn, form=form)
    if form == "3xtf32":
        # the plain backward in float64 on the same inputs: at a row with one
        # valid key dS is 0 up to rounding and dk sums that rounding over
        # every query row, so the f32 plain's own dk lies near the 1e-5 floor
        # there
        t64 = [x.double() for x in t[:3]] + [t[3]]
        lse64 = aca.aca_attention_plain(*t64, heads, nd, nd > 0, p, seed, *dn,
                                        want_lse=True)[2]
        ref = aca.aca_attention_bwd_plain(*t64, lse64, d_out.to(cuda).double(),
                                          None if dh is None else dh.double(), heads, nd, p,
                                          seed, *dn)
        limit = GRAD_RTOL
    else:
        ref = aca.aca_attention_bwd_plain(*t, lse, d_out.to(cuda), dh, heads, nd, p, seed, *dn,
                                          form=form)
        limit = FORM_RTOL[form]
    torch.cuda.synchronize()
    for name, got, want in zip(("dq", "dk", "dv"), grads, ref):
        assert torch.isfinite(got).all(), name
        assert _rel_err(got.double(), want.double()) <= limit, name
    # no float atomics, the chunks' partial sums added in a fixed order:
    # launches agree bit for bit
    again = aca._launch_bwd(*t, lse, d_out.to(cuda), dh, heads, nd, p, seed, *dn, form=form)
    assert all(torch.equal(x, y) for x, y in zip(grads, again))


@pytest.mark.parametrize("form", ["3xtf32", "bf16"])
def test_aca_one_key_row_is_exact(cuda, form):
    """At dropout 0, a short-form batch row with one valid key j (the row's
    S is the backward's, bit for bit, so the forward's lse is exactly s_j
    and the backward's P exactly 1): dS = P (dP - D) cancels to exactly 0,
    so dq and dk are exactly 0; at bf16 every query row's out is bf16(v_j)
    bit for bit (P = 1 rounds to 1, the other keys' P are 0), at 3xTF32
    within 1e-5 of v_j. And the ACA with every key a dummy (Lk = nd = 1)
    gives out exactly 0 (no probability reaches p.v) and a head mean of
    exactly 1."""
    b, lv, lk, heads = 4, 300, 75, 8
    q, k, v, _ = _inputs(b, lv, lk, heads, 51)
    keys = np.random.default_rng(52).integers(0, lk, b)
    keys[1] = lk - 1  # the last key, in the last, partial n-tile
    valid = torch.zeros((b, lk))
    valid[torch.arange(b), torch.from_numpy(keys)] = 1.0
    t = [x.to(cuda) for x in (q, k, v, valid)]
    out, _, lse = aca._launch(*t, heads, 0, False, 0.0, 0, want_lse=True, form=form)
    d_out = torch.randn(q.shape, generator=torch.Generator().manual_seed(53)).to(cuda)
    dq, dk, dv = aca._launch_bwd(*t, lse, d_out, None, heads, 0, 0.0, 0, form=form)
    torch.cuda.synchronize()
    assert all(torch.isfinite(x).all() for x in (out, lse, dq, dk, dv))
    assert torch.equal(dk, torch.zeros_like(dk))
    assert torch.equal(dq, torch.zeros_like(dq))
    vj = t[2][torch.arange(b, device=cuda), torch.from_numpy(keys).to(cuda)][:, None, :]
    if form == "bf16":
        assert torch.equal(out, vj.to(torch.bfloat16).float().expand_as(out))
    else:
        assert (out - vj).abs().max().item() <= ATOL

    t = [x.to(cuda) for x in _inputs(3, 40, 1, heads, 54)]
    for want_lse in (False, True):
        res = aca._launch(*t, heads, 1, True, 0.0, 0, want_lse=want_lse, form=form)
        torch.cuda.synchronize()
        assert torch.equal(res[0], torch.zeros_like(res[0]))
        assert torch.equal(res[1], torch.ones_like(res[1]))


@pytest.mark.parametrize(
    "b,length,case,p",
    [
        (32, 2048, "ragged", 0.1),  # TACoS encoder, train
        (3, 129, "ragged", 0.1),  # one key past the short kernel
        (2, 77, "ragged", 0.0),  # shorter than one tile
        (2, 1, "ragged", 0.0),  # one clip
        (1, chunked_attn.MAX_LEN, "ragged", 0.1),  # the largest v_bucket
        (3, 700, "holes", 0.1),
        (3, 700, "one_key", 0.1),
        (3, 700, "all_masked_tiles", 0.1),
        # the mma tile edges (16-row warp tiles, 8-key n-tiles, 64-key
        # chunks, 128-key stages), each at dropout 0 and 0.1
        (2, 1, "ragged", 0.1),
        (3, 15, "ragged", 0.0),
        (3, 15, "ragged", 0.1),
        (3, 17, "ragged", 0.0),
        (3, 17, "ragged", 0.1),
        (3, 129, "ragged", 0.0),
        (2, 2047, "ragged", 0.0),
        (2, 2047, "ragged", 0.1),
        (1, chunked_attn.MAX_LEN, "ragged", 0.0),
        (3, 700, "last_tile_key", 0.0),  # one valid key, in the last tile
        (3, 700, "last_tile_key", 0.1),
        (2, 2047, "last_tile_key", 0.1),
        (3, 300, "empty_row", 0.0),  # a batch row with no valid key
        (3, 300, "empty_row", 0.1),
        # the bf16 body's TMA boxes (64 rows) past the end of the rows: a
        # batch row whose only valid keys lie in the last, partial 128-key
        # tile, at kMaxLen and at lengths that are not a multiple of 64
        (2, chunked_attn.MAX_LEN, "last_tile_only", 0.1),
        (3, 4000, "last_tile_only", 0.1),
        (3, 1000, "last_tile_only", 0.0),
    ],
)
@pytest.mark.parametrize("form", ["3xtf32", "bf16"])
def test_flash_train_kernels_match_plain(cuda, form, b, length, case, p):
    """The training forward and the backward against their plain versions:
    at 3xTF32 against float64 (GRAD_RTOL); at bf16, whose forward and
    backward have their own bodies on mma.sync.m16n8k16, against the plain
    versions at the bf16 form on the kernel forward's out and log-sum-exp
    (FORM_RTOL). At both,
    exact zeros at a batch row with no valid key, and two launches of the
    backward bit-equal."""
    q, k, v, _ = _inputs(b, length, length, 8, 21)
    rng = np.random.default_rng(22)
    if case in ("ragged", "empty_row", "last_tile_only"):
        valid = _ragged(b, length, 23)
        if case == "empty_row":
            valid[1] = 0.0
        elif case == "last_tile_only":
            valid[1] = 0.0
            valid[1, (length - 1) // 128 * 128 + 3 :: 5] = 1.0
    elif case == "holes":
        valid = _holes(b, length, 24)
    else:
        valid_np = np.zeros((b, length), np.float32)
        if case == "one_key":
            valid_np[np.arange(b), rng.integers(0, length, b)] = 1.0
        elif case == "last_tile_key":
            valid_np[np.arange(b), length - 1 - rng.integers(0, (length - 1) % 128 + 1, b)] = 1.0
        else:  # valid keys only in the second and last 128-key tiles
            valid_np[:, 130:140] = 1.0
            valid_np[:, 650:] = 1.0
        valid = torch.from_numpy(valid_np)
    # the plain forward gives NaN at a batch row with no valid key, the
    # kernel zeros: forwards are compared on the other rows
    live = valid.sum(dim=1) > 0
    d_out = torch.randn(q.shape, generator=torch.Generator().manual_seed(25))
    t = [x.to(cuda) for x in (q, k, v, valid)]
    seed = 4321
    out, lse = chunked_attn._launch(*t, 8, p, seed, want_lse=True, form=form)
    ref_out, ref_lse = chunked_attn.flash_attention_plain(*t, 8, p, seed, want_lse=True,
                                                          form=form)
    torch.cuda.synchronize()
    if form == "3xtf32":
        assert (out - ref_out)[live].abs().max().item() <= ATOL
        assert (lse - ref_lse)[live].abs().max().item() <= ATOL
    else:
        assert _rel_err(out[live], ref_out[live]) <= FORM_RTOL[form]
        assert _rel_err(lse[live], ref_lse[live]) <= FORM_RTOL[form]
    assert torch.equal(out[~live], torch.zeros_like(out[~live]))
    d_out = d_out.to(cuda)
    grads = chunked_attn._launch_bwd(*t, out, lse, d_out, 8, p, seed, form=form)
    if form == "3xtf32":
        # the plain backward in float64 on the same inputs: where one key is
        # valid, dS = P (z dP - D) is 0 up to rounding and dk sums that
        # rounding over every query row, so the f32 plain's own dk lies near
        # the 1e-5 floor there, and the kernel's f32 sums round in another
        # order (3xTF32 on the tensor cores)
        t64 = [x.double() for x in t[:3]] + [t[3]]
        out64, lse64 = chunked_attn.flash_attention_plain(*t64, 8, p, seed, want_lse=True)
        ref = chunked_attn.flash_attention_bwd_plain(*t64, out64, lse64, d_out.double(), 8, p,
                                                     seed)
        limit = GRAD_RTOL
    else:
        ref = chunked_attn.flash_attention_bwd_plain(*t, out, lse, d_out, 8, p, seed, form=form)
        limit = FORM_RTOL[form]
    torch.cuda.synchronize()
    for name, got, want in zip(("dq", "dk", "dv"), grads, ref):
        assert torch.isfinite(got).all(), name
        assert _rel_err(got.double(), want.double()) <= limit, name
        assert torch.equal(got[~live], torch.zeros_like(got[~live])), name
    again = chunked_attn._launch_bwd(*t, out, lse, d_out, 8, p, seed, form=form)
    assert all(torch.equal(x, y) for x, y in zip(grads, again))


@pytest.mark.parametrize("form", ["3xtf32", "bf16"])
def test_flash_backward_launches_are_bit_equal(cuda, form):
    """Three launches of the backward on the same inputs, at the TACoS train
    shape with dropout, give the same dq, dk and dv bit for bit: every sum
    in one block in a fixed order, no float atomics (the bf16 body's wgmma
    accumulators and TMA ring included)."""
    b, length = 4, 2048
    q, k, v, _ = _inputs(b, length, length, 8, 31)
    t = [x.to(cuda) for x in (q, k, v, _ragged(b, length, 32))]
    out, lse = chunked_attn._launch(*t, 8, 0.1, 77, want_lse=True, form=form)
    d_out = torch.randn(q.shape, generator=torch.Generator().manual_seed(33)).to(cuda)
    first = chunked_attn._launch_bwd(*t, out, lse, d_out, 8, 0.1, 77, form=form)
    for _ in range(2):
        again = chunked_attn._launch_bwd(*t, out, lse, d_out, 8, 0.1, 77, form=form)
        assert all(torch.equal(x, y) for x, y in zip(first, again))
    assert all(torch.isfinite(x).all() for x in first)


def test_flash_prepass_matches_plain(cuda):
    """The bf16 form's pre-pass (stage_kv: flash_fwd_stage_kernel) rounds k
    and v as torch's bf16 cast does, to nearest even, bit for bit, at the
    TACoS train shape and at one row."""
    for b, length in ((32, 2048), (1, 1)):
        _, k, v, _ = _inputs(b, length, length, 8, 41)
        k, v = k.to(cuda), v.to(cuda)
        kv = chunked_attn.stage_kv(k, v)
        torch.cuda.synchronize()
        assert kv.shape == (2, b, length, 256) and kv.dtype == torch.bfloat16
        assert torch.equal(kv, chunked_attn.stage_kv_plain(k, v))


@pytest.mark.parametrize("p", [0.0, 0.1])
def test_flash_backward_takes_the_forward_copies_bit_equal(cuda, p):
    """The bf16 backward with the training forward's bf16 k and v (the
    pre-pass's copies, handed over) gives the same dq, dk and dv, bit for
    bit, as with its own pre-pass rounding k and v: the copies are the same
    function of the same inputs. Through the autograd Function too."""
    b, length = 4, 2048
    q, k, v, _ = _inputs(b, length, length, 8, 43)
    t = [x.to(cuda) for x in (q, k, v, _ragged(b, length, 44))]
    out, lse, kv = chunked_attn._launch(*t, 8, p, 45, want_lse=True, form="bf16",
                                        keep_kv=True)
    d_out = torch.randn(q.shape, generator=torch.Generator().manual_seed(46)).to(cuda)
    own = chunked_attn._launch_bwd(*t, out, lse, d_out, 8, p, 45, form="bf16")
    handed = chunked_attn._launch_bwd(*t, out, lse, d_out, 8, p, 45, form="bf16", kv=kv)
    torch.cuda.synchronize()
    assert all(torch.isfinite(x).all() for x in own)
    assert all(torch.equal(x, y) for x, y in zip(own, handed))
    qg, kg, vg = (x.clone().requires_grad_() for x in t[:3])
    seed = torch.tensor(45, dtype=torch.int32, device=cuda)
    fn_out = chunked_attn._FlashFn.apply(qg, kg, vg, t[3], 8, p, seed if p else None, "bf16")
    fn_out.backward(d_out)
    assert torch.equal(fn_out.detach(), out)
    assert all(torch.equal(g, x) for g, x in zip((qg.grad, kg.grad, vg.grad), own))


@pytest.mark.parametrize("case", ["partial_tile", "one_tile_row", "one_clip", "two_tiles"])
@pytest.mark.parametrize("train", [False, True])
def test_flash_bf16_tma_edges(cuda, case, train):
    """The bf16 forward's TMA boxes at the edges of the rows, against the
    plain version at the bf16 form: L not a multiple of 128 with a last,
    partial tile whose boxes run past the rows; a batch row whose only
    valid keys lie in one tile (the walk copies that tile alone); L = 1;
    and exactly two whole tiles, one 64-key chunk holding a whole mask word
    of masked keys beside a word of valid ones."""
    b, length = {"partial_tile": (3, 333), "one_tile_row": (3, 700), "one_clip": (2, 1),
                 "two_tiles": (2, 256)}[case]
    q, k, v, _ = _inputs(b, length, length, 8, 47)
    valid = _ragged(b, length, 48)
    if case == "one_tile_row":
        valid[1] = 0.0
        valid[1, 260:300] = 1.0  # inside the third tile
    elif case == "two_tiles":
        valid[:, 32:64] = 0.0
    t = [x.to(cuda) for x in (q, k, v, valid)]
    p = 0.1 if train else 0.0
    if train:
        out, lse = chunked_attn._launch(*t, 8, p, 49, want_lse=True, form="bf16")
        ref, ref_lse = chunked_attn.flash_attention_plain(*t, 8, p, 49, want_lse=True,
                                                          form="bf16")
        _assert_forward(lse, ref_lse, "bf16")
    else:
        out = chunked_attn._launch(*t, 8, form="bf16")
        ref = chunked_attn.flash_attention_plain(*t, 8, form="bf16")
    _assert_forward(out, ref, "bf16")
    again = chunked_attn._launch(*t, 8, p, 49, want_lse=train, form="bf16")
    assert torch.equal(again[0] if train else again, out)


def test_flash_backward_row_without_valid_key_is_zero(cuda):
    q, k, v, _ = _inputs(2, 300, 300, 8, 26)
    valid = torch.ones((2, 300))
    valid[1] = 0
    t = [x.to(cuda) for x in (q, k, v, valid)]
    out, lse = chunked_attn._launch(*t, 8, 0.1, 5, want_lse=True)
    grads = chunked_attn._launch_bwd(*t, out, lse, torch.randn_like(out), 8, 0.1, 5)
    for g in grads:
        assert torch.equal(g[1], torch.zeros_like(g[1]))
        assert torch.isfinite(g).all()


@pytest.mark.parametrize("form", ["3xtf32", "bf16"])
@pytest.mark.parametrize("rank", [0, 1])
def test_aca_train_kernels_donor_tables_match_plain(cuda, rank, form):
    """The training forward and the backward with donor tables of G = 8 >
    B = 4 rows (a rank's rows of a data-parallel global batch, its donors
    on the other rank too) against the plain versions on the same tables
    (at bf16 at the bf16 form, the backward's on the kernel forward's
    log-sum-exp, within FORM_RTOL); and at G = B with the batch's own masks,
    the same results as without donor_key_valid (today's arithmetic, bit for
    bit)."""
    from flashvtg_tpu_torch.models.transformer import tiled_attn_donors

    b, g_rows, lv, lk, heads, nd, p, seed = 4, 8, 75, 42, 8, 10, 0.1, 99
    q, k, v, valid = _inputs(b, lv, lk, heads, 41, pad_from=20)
    gen = torch.Generator().manual_seed(42)
    key_table = _holes(g_rows, lk, 12, always=nd)
    query_table = (torch.arange(lv)[None]
                   < torch.randint(1, lv + 1, (g_rows, 1), generator=gen)).float()
    own = slice(rank * b, (rank + 1) * b)
    key_table[own] = valid
    donors = tiled_attn_donors(g_rows, heads)[own]
    d_out, d_hm = torch.randn(q.shape, generator=gen), torch.randn((b, lv, lk), generator=gen)
    t = [x.to(cuda) for x in (q, k, v, valid)]
    tables = dict(donor_key_valid=key_table.to(cuda))
    dn = (query_table.to(cuda), donors.to(cuda))
    out, hm, lse = aca._launch(*t, heads, nd, True, p, seed, *dn, want_lse=True, form=form,
                               **tables)
    ref = aca.aca_attention_plain(*t, heads, nd, True, p, seed, *dn, want_lse=True, form=form,
                                  **tables)
    torch.cuda.synchronize()
    for got, want in zip((out, hm, lse), ref):
        if form == "3xtf32":
            assert (got - want).abs().max().item() <= ATOL
        else:
            assert _rel_err(got, want) <= FORM_RTOL[form]
    grads = aca._launch_bwd(*t, lse, d_out.to(cuda), d_hm.to(cuda), heads, nd, p, seed, *dn,
                            form=form, **tables)
    ref_grads = aca.aca_attention_bwd_plain(*t, ref[2] if form == "3xtf32" else lse,
                                            d_out.to(cuda), d_hm.to(cuda), heads, nd, p, seed,
                                            *dn, form=form, **tables)
    for got, want in zip(grads, ref_grads):
        assert _rel_err(got, want) <= FORM_RTOL[form]
    # G = B: the batch's own tables, bit for bit the call without them
    own_dn = (query_table[own].to(cuda), tiled_attn_donors(b, heads).to(cuda))
    with_tables = aca._launch(*t, heads, nd, True, p, seed, *own_dn, want_lse=True,
                              donor_key_valid=t[3], form=form)
    without = aca._launch(*t, heads, nd, True, p, seed, *own_dn, want_lse=True, form=form)
    assert all(torch.equal(x, y) for x, y in zip(with_tables, without))


def test_attention_functions_count_and_match_cpu(cuda):
    """The autograd Functions through the wrappers: each forward and
    backward launch is counted; with dropout off, card gradients match the
    CPU's plain forward + backward."""
    from flashvtg_tpu_torch.models.transformer import tiled_attn_donors

    b, lv, lk, heads, nd = 4, 300, 50, 2, 5
    q, k, v, valid = _inputs(b, lv, lk, heads, 27, pad_from=40)
    qs, ks, vs, _ = _inputs(b, lv, lv, heads, 28)
    vmask = _ragged(b, lv, 29)
    donors = tiled_attn_donors(b, heads)
    grads = {}
    for dev in ("cpu", cuda):
        leaves = [x.detach().to(dev).requires_grad_() for x in (q, k, v, qs, ks, vs)]
        out, hm = aca.aca_attention(*leaves[:3], valid.to(dev), heads, nd,
                                    donor_query_valid=vmask.to(dev), donor_rows=donors.to(dev))
        sa = chunked_attn.flash_attention(*leaves[3:], vmask.to(dev), heads)
        sm = aca.masked_attention(leaves[3][:, :lk].contiguous(), leaves[4][:, :lk].contiguous(),
                                  leaves[5][:, :lk].contiguous(), valid.to(dev), heads)
        aca.reset_launch_counts()
        chunked_attn.reset_launch_counts()
        ((out ** 2).sum() + (hm * 3).sum() + (sa ** 2).sum() + sm.sum()).backward()
        grads[str(dev)] = [x.grad.cpu() for x in leaves]
    assert aca.launch_counts() == {"aca_attention": 0, "masked_attention": 0,
                                   "aca_attention_bwd": 1, "masked_attention_bwd": 1}
    assert chunked_attn.launch_counts() == {"flash_attention": 0, "flash_attention_bwd": 1}
    for got, want in zip(grads["cuda"], grads["cpu"]):
        assert _rel_err(got, want) <= GRAD_RTOL


# --- the product forms -------------------------------------------------------
#
# At each product form (ops/forms.py) each kernel is held against its plain
# version at the same form, which rounds the same product operands:
# max |kernel - plain| <= FORM_RTOL x max(max |plain|, 0.1) (3xTF32 at
# GRAD_RTOL; at the others about 2-3 times the widest gap chip_smoke.py's
# phase 14 read at the model's shapes, 4.2e-4 at 1xTF32 and 2.6e-3 at bf16).
# And the kernel at a form reads that form's own error: its relative RMS
# distance (rms(kernel - plain) / rms(plain)) to the f32-accurate plain
# version lies in a band per form (the card read at most 1.0e-6 at 3xTF32,
# 4.0e-4 - 5.9e-4 at 1xTF32, 3.2e-3 - 4.8e-3 at bf16); the bands do not
# meet, so they tell the forms apart (the SASS count cannot tell 1xTF32 from
# bf16). The plain version at its own form is the nearest of the three.

FORM_RTOL = {"3xtf32": GRAD_RTOL, "1xtf32": 1e-3, "bf16": 6e-3}
FORM_F32_BAND = {"3xtf32": (0.0, 1e-5), "1xtf32": (1e-4, 1.2e-3), "bf16": (1.5e-3, 1.2e-2)}
FORMS = ("3xtf32", "1xtf32", "bf16")


def _form_case(kernel, cuda):
    """(launcher, plain version, arguments) of `kernel` on seeded inputs:
    the ACA at the flagship's widths (B 8, Lv 75, 10 dummies, ragged text;
    the backward with donor rows and a head-mean gradient), the short
    self-attention at L 75, the flash kernel at L 700; backwards at dropout
    0.1, from the 3xTF32 plain forward's log-sum-exp."""
    from flashvtg_tpu_torch.models.transformer import tiled_attn_donors

    b, lv, nd, lk, heads, p, seed = 8, 75, 10, 42, 8, 0.1, 77
    g = torch.Generator().manual_seed(31)
    if kernel.startswith("aca"):
        q, k, v, valid = (x.to(cuda) for x in _inputs(b, lv, lk, heads, 32, pad_from=30))
        if kernel == "aca_attention":
            return aca._launch, aca.aca_attention_plain, (q, k, v, valid, heads, nd)
        vmask = _ragged(b, lv, 33).to(cuda)
        donors = tiled_attn_donors(b, heads, cuda)
        train = (q, k, v, valid, heads, nd, True, p, seed, vmask, donors)
        lse = aca.aca_attention_plain(*train, want_lse=True)[2]
        d_out, d_hm = (torch.randn(shape, generator=g).to(cuda)
                       for shape in ((b, lv, heads * 32), (b, lv, lk)))
        return aca._launch_bwd, aca.aca_attention_bwd_plain, (
            q, k, v, valid, lse, d_out, d_hm, heads, nd, p, seed, vmask, donors)
    length = 700 if kernel.startswith("flash") else lv
    q, k, v, _ = (x.to(cuda) for x in _inputs(b, length, length, heads, 34))
    valid = _ragged(b, length, 35).to(cuda)
    d_out = torch.randn(q.shape, generator=g).to(cuda)
    if kernel == "masked_attention":
        return aca._launch, aca.aca_attention_plain, (q, k, v, valid, heads, 0, False)
    if kernel == "masked_attention_bwd":
        lse = aca.aca_attention_plain(q, k, v, valid, heads, 0, False, p, seed,
                                      want_lse=True)[2]
        return aca._launch_bwd, aca.aca_attention_bwd_plain, (
            q, k, v, valid, lse, d_out, None, heads, 0, p, seed)
    if kernel == "flash_attention":
        return chunked_attn._launch, chunked_attn.flash_attention_plain, (q, k, v, valid, heads)
    out, lse = chunked_attn.flash_attention_plain(q, k, v, valid, heads, p, seed, want_lse=True)
    return chunked_attn._launch_bwd, chunked_attn.flash_attention_bwd_plain, (
        q, k, v, valid, out, lse, d_out, heads, p, seed)


def _outputs(res):
    return [t for t in (res if isinstance(res, tuple) else (res,)) if t is not None]


def _rms_distance(got, ref):
    return max(((x - y).double().pow(2).mean().sqrt()
                / y.double().pow(2).mean().sqrt()).item() for x, y in zip(got, ref))


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("kernel", ["aca_attention", "masked_attention", "flash_attention",
                                    "aca_attention_bwd", "masked_attention_bwd",
                                    "flash_attention_bwd"])
def test_kernel_at_each_form_matches_its_plain_version(cuda, kernel, form):
    launch, plain, args = _form_case(kernel, cuda)
    got = _outputs(launch(*args, form=form))
    plains = {f: _outputs(plain(*args, form=f)) for f in FORMS}
    torch.cuda.synchronize()
    for x, y in zip(got, plains[form]):
        assert torch.isfinite(x).all()
        assert _rel_err(x, y) <= FORM_RTOL[form]
    dist = {f: _rms_distance(got, ref) for f, ref in plains.items()}
    print(kernel, form, dist)
    floor, limit = FORM_F32_BAND[form]
    assert floor <= dist["3xtf32"] <= limit, dist
    assert dist[form] == min(dist.values()), dist


# --- the accuracy of the 3xTF32 sums ---------------------------------------

_DOTS_SOURCE = r"""
#include "attn_common.cuh"

// C = A B^T for 16 x 8 tiles of A (16 x kDh) and B (8 x kDh): way 0 an f32
// FMA loop, way 1 dot_form (3xTF32), way 2 the twelve products chained into one
// accumulator
__global__ void dots(const float* A, const float* B, float* C, int way) {
  const int tile = blockIdx.x * 4 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* a = A + (size_t)tile * 16 * kDh;
  const float* b = B + (size_t)tile * 8 * kDh;
  float c[4] = {0.f, 0.f, 0.f, 0.f};
  FragA fa[kDh / 8];
  for (int ks = 0; ks < kDh / 8; ++ks) {
    const float* a0 = a + g * kDh + 8 * ks + t;
    fa[ks] = frag_a(a0[0], a0[8 * kDh], a0[4], a0[8 * kDh + 4]);
  }
  if (way == 0) {
    for (int e = 0; e < 4; ++e) {
      const float* ar = a + (g + 8 * (e >> 1)) * kDh;
      const float* br = b + (2 * t + (e & 1)) * kDh;
      for (int k = 0; k < kDh; ++k) c[e] = fmaf(ar[k], br[k], c[e]);
    }
  } else if (way == 1) {
    dot_form(c, fa, b + g * kDh + t, 1.f);
  } else {
    for (int ks = 0; ks < kDh / 8; ++ks) {
      const float* br = b + g * kDh + 8 * ks + t;
      mma_form(c, fa[ks], frag_b(br[0], br[4]));
    }
  }
  float* o = C + (size_t)tile * 16 * 8;
  for (int e = 0; e < 4; ++e) o[(g + 8 * (e >> 1)) * 8 + 2 * t + (e & 1)] = c[e];
}

extern "C" int run(const float* A, const float* B, float* C, int tiles, int way) {
  dots<<<tiles / 4, 128>>>(A, B, C, way);
  return (int)cudaGetLastError();
}
"""


def test_dot_3xtf32_as_accurate_as_an_fma_loop(cuda, tmp_path):
    """The tensor core's f32 accumulation truncates, so the flash kernels'
    dot_form (3xTF32) takes each k-step's big product in a fresh accumulator. On
    524,288 dot products of 32 standard-normal terms (dP = dO V^T's shape),
    its error against float64 is no larger than an f32 FMA loop's, at the
    largest and in rms. Prints each way's errors (-s shows them); the
    twelve products chained into one accumulator are printed for
    comparison."""
    import ctypes
    import json
    import subprocess

    from flashvtg_tpu_torch import kernels

    src, lib = tmp_path / "dots.cu", tmp_path / "libdots.so"
    src.write_text(_DOTS_SOURCE)
    flags = [f for f in kernels.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    subprocess.run([kernels._nvcc(), *flags, "-I", kernels.CSRC, "-o", str(lib), str(src)],
                   check=True)
    dll = ctypes.CDLL(str(lib))
    dll.run.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
    dll.run.restype = ctypes.c_int
    tiles = 4096
    g = torch.Generator().manual_seed(0)
    a = torch.randn((tiles, 16, 32), generator=g).to(cuda)
    b = torch.randn((tiles, 8, 32), generator=g).to(cuda)
    ref = torch.einsum("tik,tnk->tin", a.double(), b.double())
    errs = {}
    for way, name in enumerate(("f32_fma", "dot_3xtf32", "3xtf32_chained")):
        c = torch.empty((tiles, 16, 8), device=cuda)
        assert dll.run(a.data_ptr(), b.data_ptr(), c.data_ptr(), tiles, way) == 0, name
        torch.cuda.synchronize()
        err = c.double() - ref
        errs[name] = (err.abs().max().item(), err.pow(2).mean().sqrt().item())
        print(json.dumps(dict(way=name, dots=c.numel(), max_abs_err=errs[name][0],
                              rms_err=errs[name][1], mean_err=err.mean().item())))
    assert errs["dot_3xtf32"][0] <= errs["f32_fma"][0]
    assert errs["dot_3xtf32"][1] <= errs["f32_fma"][1]


# The dropout seed in device memory (ops/attn_dropout.py): the kernels read a
# 0-d int32 tensor drawn on the card, so a CUDA graph that captures a call
# draws a new seed, and a new mask, at every replay.
SEED_CASES = {
    # kind: (B, Lq, Lk, heads, nd)
    "aca": (3, 40, 32, 2, 0),
    "aca_dummies": (2, 75, 42, 8, 10),
    "flash": (2, 32, 32, 2, 0),
    "flash_long": (1, 300, 300, 2, 0),
}


def _seed_forward(kind, q, k, v, valid, heads, nd, p, seed):
    """(kernel out, plain out, kernel lse, plain lse) of the training form."""
    if kind.startswith("aca"):
        out, _, lse = aca._launch(q, k, v, valid, heads, nd, False, p, seed, want_lse=True)
        ref, _, ref_lse = aca.aca_attention_plain(q, k, v, valid, heads, nd, False, p, seed,
                                                  want_lse=True)
    else:
        out, lse = chunked_attn._launch(q, k, v, valid, heads, p, seed, want_lse=True)
        ref, ref_lse = chunked_attn.flash_attention_plain(q, k, v, valid, heads, p, seed,
                                                          want_lse=True)
    return out, ref, lse, ref_lse


@pytest.mark.parametrize("kind", list(SEED_CASES))
def test_kernels_read_the_seed_tensor(cuda, kind):
    """Forward and backward kernels with a 0-d seed tensor on the card
    against their plain versions with the same tensor; and the forward's
    mask itself (q = 0: every valid key has p = 1 / Lk; v one-hot per key)
    equal to keep_scale's with that tensor."""
    from flashvtg_tpu_torch.ops.attn_dropout import keep_scale

    b, lq, lk, heads, nd = SEED_CASES[kind]
    p = 0.3
    seed = torch.tensor(987654321, dtype=torch.int32, device=cuda)
    q, k, v, valid = (t.to(cuda) for t in _inputs(b, lq, lk, heads, 41))
    out, ref, lse, ref_lse = _seed_forward(kind, q, k, v, valid, heads, nd, p, seed)
    torch.testing.assert_close(out, ref, atol=ATOL, rtol=0)
    torch.testing.assert_close(lse, ref_lse, atol=ATOL, rtol=0)
    d_out = torch.randn(q.shape, generator=torch.Generator().manual_seed(3)).to(cuda)
    if kind.startswith("aca"):
        got = aca._launch_bwd(q, k, v, valid, lse, d_out, None, heads, nd, p, seed)
        want = aca.aca_attention_bwd_plain(q, k, v, valid, ref_lse, d_out, None, heads, nd, p,
                                           seed)
    else:
        got = chunked_attn._launch_bwd(q, k, v, valid, out, lse, d_out, heads, p, seed)
        want = chunked_attn.flash_attention_bwd_plain(q, k, v, valid, ref, ref_lse, d_out,
                                                      heads, p, seed)
    for g_, w in zip(got, want):
        scale = max(w.abs().max().item(), 1.0)
        assert (g_ - w).abs().max().item() <= 1e-4 * scale

    if lk <= 32 and nd == 0:  # the mask, read off the output
        zq = torch.zeros((b, lq, heads * 32), device=cuda)
        zk = torch.zeros((b, lk, heads * 32), device=cuda)
        onehot = torch.zeros((b, lk, heads * 32), device=cuda)
        keys = torch.arange(lk, device=cuda)
        for h in range(heads):
            onehot[:, keys, h * 32 + keys] = float(lk)
        ones = torch.ones((b, lk), device=cuda)
        out, _, _, _ = _seed_forward(kind, zq, zk, onehot, ones, heads, 0, p, seed)
        got_mask = out.view(b, lq, heads, 32)[..., :lk].permute(0, 2, 1, 3) > 0
        want_mask = keep_scale(seed, p, b, heads, torch.arange(lq, device=cuda), lk) > 0
        assert torch.equal(got_mask, want_mask)
        assert 0.5 < want_mask.float().mean().item() < 0.9


def _graph_fn(kind, heads, nd, p, g):
    if kind.startswith("aca"):
        return lambda q, k, v, valid: aca.aca_attention(q, k, v, valid, heads, nd, False,
                                                        dropout=p, generator=g)[0]
    return lambda q, k, v, valid: chunked_attn.flash_attention(q, k, v, valid, heads,
                                                               dropout=p, generator=g)


@pytest.mark.parametrize("kind", list(SEED_CASES))
def test_graph_replays_draw_new_masks(cuda, kind):
    """The forward and backward of a dropout call captured in a CUDA graph
    with its generator registered: each replay draws a new seed (outputs
    and gradients differ between replays), and the replays give exactly
    the eager calls' sequence from the same generator state; neither the
    capture nor a replay adds to the launch counts."""
    b, lq, lk, heads, nd = SEED_CASES[kind]
    q0, k0, v0, valid = (t.to(cuda) for t in _inputs(b, lq, lk, heads, 43))
    d_out = torch.randn(q0.shape, generator=torch.Generator().manual_seed(4)).to(cuda)
    g = torch.Generator(device=cuda)
    fn = _graph_fn(kind, heads, nd, 0.3, g)
    q, k, v = (t.clone().requires_grad_() for t in (q0, k0, v0))

    def step():
        for t in (q, k, v):
            t.grad = None
        out = fn(q, k, v, valid)
        out.backward(d_out)
        return out.detach(), q.grad, v.grad

    g.manual_seed(11)
    eager = [tuple(t.clone() for t in step()) for _ in range(4)]
    g.manual_seed(11)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        warm = tuple(t.clone() for t in step())
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(g)
    aca.reset_launch_counts()
    chunked_attn.reset_launch_counts()
    with torch.cuda.graph(graph):
        static = step()
    replays = []
    for _ in range(3):
        graph.replay()
        replays.append(tuple(t.clone() for t in static))
    torch.cuda.synchronize()
    # the capture launches nothing and the replays make no Python call: the
    # wrappers count neither
    assert not any({**aca.launch_counts(), **chunked_attn.launch_counts()}.values())
    for a, b_ in zip(warm, eager[0]):
        assert torch.equal(a, b_)
    for i, rep in enumerate(replays):
        for a, b_ in zip(rep, eager[i + 1]):
            assert torch.equal(a, b_), i
    for i in range(2):
        assert not torch.equal(replays[i][0], replays[i + 1][0])
        assert not torch.equal(replays[i][2], replays[i + 1][2])


# --- LayerNorm (csrc/layer_norm.cu) -------------------------------------------
#
# The forward and the fused backward against their plain twins
# (ops/layer_norm.py), x float32 and bfloat16 (under autocast, as the bf16
# dial hands it on), at the widths the presets build. Tolerances: f32 sums
# in another order (warp butterflies, the blocks' partials in block order,
# against torch's reductions): LN_RTOL of max |plain| on y, the statistics,
# a float32 dx, dgamma and dbeta (summed over up to 65,536 rows); a
# bfloat16 dx is rounded once from f32 values that differ by that much, so
# a pair may round to neighbouring bf16 values: one bf16 step (2^-7 |plain|)
# apart, plus LN_RTOL.

LN_RTOL = 1e-4
LN_SHAPES = [(65536, 256), (2400, 256), (1023, 770), (1280, 4096), (333, 2818)]


def _ln_inputs(shape, dtype, seed, dev):
    g = torch.Generator().manual_seed(seed)
    d = shape[-1]
    x = torch.randn(shape, generator=g) * 3 + torch.randn(d, generator=g)
    w = torch.randn(d, generator=g) * 0.5 + 1
    b = torch.randn(d, generator=g) * 0.1
    dy = torch.randn(shape, generator=g)
    return x.to(dev, dtype), w.to(dev), b.to(dev), dy.to(dev)


def _ln_rel(got, want):
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


def _ln_autocast(dtype):
    return torch.autocast("cuda", dtype=torch.bfloat16, enabled=dtype == torch.bfloat16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", LN_SHAPES)
def test_layer_norm_kernels_match_plain(cuda, shape, dtype):
    from flashvtg_tpu_torch.ops import layer_norm

    dt = getattr(torch, dtype)
    x, w, b, dy = _ln_inputs(shape, dt, 5, cuda)
    with _ln_autocast(dt):
        _, y, stats = layer_norm._forward(x, w, b, 1e-5, True)
        y_ref, stats_ref = layer_norm.layer_norm_plain(x, w, b)
        y_eval = layer_norm.layer_norm(x, w, b)  # no gradient wanted: no statistics
    dx, dw, db = layer_norm._backward(dy, x, stats, w, True)
    dx_ref, dw_ref, db_ref = layer_norm.layer_norm_bwd_plain(dy, x, stats, w)
    no_dx, dw2, db2 = layer_norm._backward(dy, x, stats, w, False)
    torch.cuda.synchronize()
    assert y.dtype == torch.float32 and dx.dtype == dt and torch.equal(y_eval, y)
    for what, got, want in (("y", y, y_ref), ("stats", stats, stats_ref),
                            ("dgamma", dw, dw_ref), ("dbeta", db, db_ref)):
        assert _ln_rel(got, want) <= LN_RTOL, what
    if dt == torch.float32:
        assert _ln_rel(dx, dx_ref) <= LN_RTOL
    else:
        want = dx_ref.float()
        gap = (dx.float() - want).abs()
        assert bool((gap <= 2.0 ** -7 * want.abs() + LN_RTOL * want.abs().max()).all())
    # without the input gradient: the same weight gradients, no dx
    assert no_dx is None and torch.equal(dw2, dw) and torch.equal(db2, db)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_graph_replays_are_bit_equal(cuda, dtype):
    """The op's forward and backward captured in a CUDA graph at the TACoS
    train shape: two replays give the same bits, and the eager call's (no
    atomics; the backward's grid is fixed); the capture launches nothing
    the wrappers count, and the program counter counts the captured call."""
    from flashvtg_tpu_torch.ops import layer_norm
    from flashvtg_tpu_torch.utils import observability as obs

    dt = getattr(torch, dtype)
    x0, w0, b0, dy = _ln_inputs((65536, 256), dt, 6, cuda)
    x, w, b = (t.clone().requires_grad_() for t in (x0, w0, b0))

    def step():
        for t in (x, w, b):
            t.grad = None
        with _ln_autocast(dt):
            y = layer_norm.layer_norm(x, w, b)
        y.backward(dy)
        return y.detach(), x.grad, w.grad, b.grad

    eager = tuple(t.clone() for t in step())
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    layer_norm.reset_launch_counts()
    before = obs.counter("ops.layer_norm")
    with torch.cuda.graph(graph):
        static = step()
    assert layer_norm.launch_counts() == {"layer_norm": 0, "layer_norm_bwd": 0}
    assert obs.counter("ops.layer_norm") - before == 1
    replays = []
    for _ in range(2):
        graph.replay()
        replays.append(tuple(t.clone() for t in static))
    torch.cuda.synchronize()
    for first, second, ref in zip(replays[0], replays[1], eager):
        assert torch.equal(first, second) and torch.equal(first, ref)


def test_layer_norm_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    from flashvtg_tpu_torch.ops import layer_norm

    x, w, b, _ = _ln_inputs((8, 64), torch.float32, 7, cuda)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        layer_norm.layer_norm(x.half(), w, b)
    with pytest.raises(TypeError, match="outside autocast"):
        layer_norm.layer_norm(x.bfloat16(), w, b)
    with pytest.raises(ValueError, match="weight"):
        layer_norm.layer_norm(x, w[:32], b)
    with pytest.raises(ValueError, match="bias"):
        layer_norm.layer_norm(x, w, b.bfloat16())
    with pytest.raises(ValueError, match="width"):
        wide = torch.zeros((2, layer_norm.MAX_WIDTH + 1), device=cuda)
        layer_norm.layer_norm(wide, torch.ones(wide.shape[1], device=cuda),
                              torch.zeros(wide.shape[1], device=cuda))


def test_tacos_train_layer_norms_run_on_the_kernels(cuda):
    """A TACoS train forward and backward (full width; depth cut to 2 ACA,
    2 encoder and 1 dummy-encoder layers; train mode at the bfloat16 dial):
    every LayerNorm call launches the forward kernel once (the launch count,
    the program counter and the module calls agree, and so do the card's
    kernel records), the backward launches the fused backward, and no
    PyTorch LayerNorm kernel runs."""
    from flashvtg_tpu_torch.models import build_model
    from flashvtg_tpu_torch.models.points import pyramid_masks_strict
    from flashvtg_tpu_torch.ops import layer_norm
    from flashvtg_tpu_torch.tools.profile_eval import profiled
    from flashvtg_tpu_torch.train.config import from_preset
    from flashvtg_tpu_torch.utils import observability as obs

    cfg = from_preset("tacos", t2v_layers=2, enc_layers=2, dummy_layers=1)
    model = build_model(cfg.model_config(), cuda, seed=0).train()
    calls = []
    for m in model.modules():
        if isinstance(m, layer_norm.LayerNorm):
            m.register_forward_hook(lambda *a: calls.append(1))
    rng = np.random.default_rng(1)
    b, lv, lq = 2, cfg.max_v_l, cfg.max_q_l
    v_lens, q_lens = np.asarray([lv, 517]), np.asarray([lq, 9])
    txt_mask = (np.arange(lq)[None] < q_lens[:, None]).astype(np.float32)
    vid_mask = (np.arange(lv)[None] < v_lens[:, None]).astype(np.float32)
    arrs = (
        rng.standard_normal((b, lq, cfg.t_feat_dim), dtype=np.float32) * txt_mask[..., None],
        txt_mask,
        rng.standard_normal((b, lv, cfg.total_v_feat_dim), dtype=np.float32)
        * vid_mask[..., None],
        vid_mask,
        pyramid_masks_strict(v_lens, lv, cfg.strides)[0],
    )
    inputs = [torch.from_numpy(a).to(cuda) for a in arrs]

    def run():
        with matmul_precision("bfloat16", cuda):
            out = model(*inputs)
            loss = sum(torch.where(torch.isfinite(t), t, 0).sum() for t in (
                out[k].float() for k in ("saliency_scores", "out_class", "out_coord")))
        loss.backward()

    layer_norm.reset_launch_counts()
    before = obs.counter("ops.layer_norm")
    _, per_name = profiled(run)
    n = len(calls)
    counts = layer_norm.launch_counts()
    assert n > 0 and counts["layer_norm"] == n == obs.counter("ops.layer_norm") - before
    assert 0 < counts["layer_norm_bwd"] <= n
    device = {name: c for name, (_, c) in per_name.items()}
    assert sum(c for name, c in device.items() if "vtg_layer_norm_fwd" in name) == n
    assert sum(c for name, c in device.items()
               if re.search(r"vtg_layer_norm_bwd(_wide)?_kernel", name)) == counts["layer_norm_bwd"]
    torch_ln = [name for name in device
                if re.search(r"layer_?norm|gammabeta|rowwisemoments", name.lower())
                and "vtg_layer_norm" not in name]
    assert not torch_ln, torch_ln
