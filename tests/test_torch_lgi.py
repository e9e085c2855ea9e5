"""The port's LGI modules (flashvtg_tpu_torch/models/lgi.py) vs their flax
counterparts (flashvtg_tpu/models/lgi.py), on the CPU.

Each module is initialised in JAX, its parameters carried across by the
port's converter helpers (utils/convert.py, the pieces of
state_dict_from_jax_ms) and loaded with strict=True; the same inputs from a
numpy seed, with padded text and video rows, go through both in eval mode
(dropout off). Every output within atol 1e-5 (f32 both sides, sums in other
orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch_threads  # noqa: F401  (torch's share of the cores under xdist)
import torch

from flashvtg_tpu.models import lgi as jlgi
from flashvtg_tpu_torch.models import lgi
from flashvtg_tpu_torch.utils.convert import (
    _inv_cross_attention_block,
    _inv_dense,
    _inv_local_context,
    _inv_mha,
    _inv_norm,
    _inv_phrase_context,
    _inv_phrase_generate,
    _inv_self_attention_block,
    _inv_tsa,
)

ATOL = 1e-5
B, D, H, T, LQ, N, RANK = 2, 32, 4, 12, 7, 3, 4


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    txt = rng.standard_normal((B, LQ, D), dtype=np.float32)
    txt_mask = np.ones((B, LQ), np.float32)
    txt_mask[1, 4:] = 0  # a padded text row
    vid = rng.standard_normal((B, T, D), dtype=np.float32)
    vid_mask = np.ones((B, T), np.float32)
    vid_mask[1, 7:] = 0  # a padded video row
    phrase = rng.standard_normal((B, N, D), dtype=np.float32)
    ctx = rng.standard_normal((B, T, N, D), dtype=np.float32)
    return dict(txt=txt, txt_mask=txt_mask, vid=vid, vid_mask=vid_mask, phrase=phrase,
                ctx=ctx, words=txt[:, 1:], word_mask=txt_mask[:, 1:])


def _phrase_context_layer(sd, prefix, p):
    _inv_self_attention_block(sd, f"{prefix}.t_att", p["t_att"])
    _inv_dense(sd, f"{prefix}.fc_t.0", p["fc_t"])
    _inv_norm(sd, f"{prefix}.norm_t", p["norm_t"])


def _hadamard(sd, prefix, p):
    for k in ("fc_1", "fc_2", "fc_3"):
        _inv_dense(sd, f"{prefix}.{k}", p[k])
    _inv_norm(sd, f"{prefix}.norm", p["norm"])
    _inv_norm(sd, f"{prefix}.norm1", p["norm1"])


def _tsa_layer(sd, prefix, p):
    _inv_tsa(sd, prefix, {"layer0": p}, 1, D)
    for k in list(sd):  # one layer, not a stack
        sd[k.replace(f"{prefix}.layers.0", prefix)] = sd.pop(k)


# name -> (flax module, port module, converter, input names, number of outputs)
CASES = {
    "MHACore": (jlgi.MHACore(H, 0.0), lgi.MHACore(D, H, 0.0), _inv_mha,
                ("phrase", "words", "words", "word_mask"), 2),
    "CrossAttentionBlock": (jlgi.CrossAttentionBlock(H, 0.0), lgi.CrossAttentionBlock(D, H, 0.0),
                            _inv_cross_attention_block, ("phrase", "words", "word_mask"), 2),
    "SelfAttentionBlock": (jlgi.SelfAttentionBlock(H, 0.0), lgi.SelfAttentionBlock(D, H, 0.0),
                           _inv_self_attention_block, ("vid", "vid_mask"), 1),
    "PhraseGenerate": (jlgi.PhraseGenerate(N, H, 0.0, 2), lgi.PhraseGenerate(D, N, H, 0.0, 2),
                       lambda sd, pre, p: _inv_phrase_generate(sd, pre, p, 2),
                       ("txt", "txt_mask", "vid", "vid_mask"), 4),
    "HadamardProduct": (jlgi.HadamardProduct(), lgi.HadamardProduct(D),
                        _hadamard, ("phrase", "vid"), 1),
    "LowRankDynamicConv": (jlgi.LowRankDynamicConv(N, RANK, (1, 3, 5), 0.0),
                           lgi.LowRankDynamicConv(D, RANK, (1, 3, 5), 0.0), _inv_local_context,
                           ("ctx", "phrase"), 1),
    "PhraseContextLayer": (jlgi.PhraseContextLayer(H, 0.0), lgi.PhraseContextLayer(D, H, 0.0),
                           _phrase_context_layer, ("vid", "vid_mask"), 1),
    "PhraseContext": (jlgi.PhraseContext(2, H, 0.0, N, RANK), lgi.PhraseContext(D, 2, H, 0.0, RANK),
                      lambda sd, pre, p: _inv_phrase_context(sd, pre, p, 2),
                      ("phrase", "vid", "vid_mask"), 3),
    "TSALayer": (jlgi.TSALayer(H, 0.0), lgi.TSALayer(D, H, 0.0), _tsa_layer,
                 ("vid", "vid_mask"), 1),
    "TSA": (jlgi.TSA(H, 0.0, 2), lgi.TSA(D, H, 0.0, 2),
            lambda sd, pre, p: _inv_tsa(sd, pre, p, 2, D), ("vid", "vid_mask"), 1),
    "SaliencyProj_masked": (jlgi.SaliencyProj(), lgi.SaliencyProj(D),
                            lambda sd, pre, p: [_inv_dense(sd, f"{pre}.{k}", p[k])
                                                for k in ("proj1", "proj2")],
                            ("vid", "vid_mask"), 1),
    "SaliencyProj_unmasked": (jlgi.SaliencyProj(), lgi.SaliencyProj(D),
                              lambda sd, pre, p: [_inv_dense(sd, f"{pre}.{k}", p[k])
                                                  for k in ("proj1", "proj2")],
                              ("vid",), 1),
}
# the port's MHACore returns its head-mean map on request only
CALL_KW = {"MHACore": dict(need_weights=True)}


@pytest.mark.parametrize("name", sorted(CASES))
def test_lgi_module_matches_flax(name):
    jmod, module, convert, names, n_out = CASES[name]
    arrs = _inputs()
    args = [arrs[k] for k in names]
    jargs = [jnp.asarray(a) for a in args]
    params = jax.jit(jmod.init)(jax.random.PRNGKey(3), *jargs)
    jout = jax.jit(jmod.apply)(params, *jargs)
    sd = {}
    convert(sd, "L", jax.tree.map(np.asarray, params["params"]))
    module.load_state_dict({k[2:]: torch.tensor(v) for k, v in sd.items()}, strict=True)
    module.eval()
    with torch.no_grad():
        tout = module(*map(torch.from_numpy, args), **CALL_KW.get(name, {}))
    touts = tout if isinstance(tout, tuple) else (tout,)
    # the flax SelfAttentionBlock also returns its head-mean map, which no
    # caller reads; the port's does not compute it
    jouts = (jout if isinstance(jout, tuple) else (jout,))[:n_out]
    assert len(touts) == len(jouts) == n_out
    for i, (t, j) in enumerate(zip(touts, jouts)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL, err_msg=f"{name}[{i}]")


def test_lgi_modules_train_mode_dropout():
    """Train mode draws dropout (the outputs move), eval mode does not; with
    rate 0 train and eval agree."""
    arrs = _inputs(1)
    args = [torch.from_numpy(arrs[k]) for k in ("vid", "vid_mask")]
    torch.manual_seed(0)
    block = lgi.TSA(D, H, 0.5, 2)
    with torch.no_grad():
        ref = block.eval()(*args)
        assert not torch.allclose(block.train()(*args), ref)
        block.eval()
        for m in block.modules():
            if hasattr(m, "dropout") and isinstance(m.dropout, float):
                m.dropout = 0.0
            if isinstance(m, torch.nn.Dropout):
                m.p = 0.0
        torch.testing.assert_close(block.train()(*args), ref)
