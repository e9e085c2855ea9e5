"""The port's LayerNorm (flashvtg_tpu_torch/ops/layer_norm.py), on the CPU:
the module is bit for bit nn.LayerNorm there; every preset's state-dict
keys are those of the same model built with nn.LayerNorm; the plain twins
of the kernels' arithmetic agree with torch's LayerNorm and its autograd;
the launchers' C calls, emulated here by a fake library that runs the twins
on the memory the pointers name, take the arguments csrc/layer_norm.cu
documents, and each launch and each call is counted once; the kernels'
names fall in "other" in both kernel_class functions. The kernels
themselves run in tests/test_torch_kernels.py, on the card.

Tolerances of the twins against torch: f32 sums in another order, rtol
1e-5 of max |torch| (d up to 4096: about sqrt(d) f32 roundings of the
row sums, and the weight gradient over up to 512 rows); a bf16 dx is
rounded once from those f32 values, so a pair may round to neighbouring
bf16 values: at most one bf16 step (2^-7 |v|) apart.
"""

import ctypes
import re

import numpy as np
import pytest
import torch_threads  # noqa: F401  (torch's share of the cores under xdist)
import torch
import torch.nn.functional as F
from torch import nn

from flashvtg_tpu_torch import kernels
from flashvtg_tpu_torch.models import build_model, components, flashvtg_ms, lgi, transformer
from flashvtg_tpu_torch.ops import layer_norm as ln
from flashvtg_tpu_torch.train.config import PRESETS, from_preset
from flashvtg_tpu_torch.utils import observability as obs

RTOL = 1e-5
BF16_STEP = 2.0 ** -7


def _inputs(shape, seed, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    d = shape[-1]
    x = (torch.randn(shape, generator=g) * 3 + torch.randn(d, generator=g)).to(dtype)
    w = torch.randn(d, generator=g) * 0.5 + 1
    b = torch.randn(d, generator=g) * 0.1
    return x, w, b


def _rel(got, want):
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16_autocast"])
@pytest.mark.parametrize("shape", [(2, 7, 256), (5, 770), (3, 2818)])
def test_module_matches_nn_layer_norm_bit_for_bit(dtype, shape):
    """Forward and gradients of LayerNorm(d) and nn.LayerNorm(d) with the
    same parameters, on the CPU: equal bits, in float32 and with a bf16
    input under the CPU's bf16 autocast (the port's bfloat16 dial)."""
    x, w, b = _inputs(shape, 0)
    mine, ref = ln.LayerNorm(shape[-1]), nn.LayerNorm(shape[-1], eps=1e-5)
    for m in (mine, ref):
        with torch.no_grad():
            m.weight.copy_(w)
            m.bias.copy_(b)
    outs, grads = [], []
    for m in (mine, ref):
        xi = (x.to(torch.bfloat16) if dtype != "float32" else x).detach().requires_grad_()
        with torch.autocast("cpu", dtype=torch.bfloat16, enabled=dtype != "float32"):
            y = m(xi)
        (y.float() * torch.linspace(-1, 1, y.numel()).view(y.shape)).sum().backward()
        outs.append(y)
        grads.append((xi.grad, m.weight.grad, m.bias.grad))
    assert outs[0].dtype == outs[1].dtype
    assert torch.equal(outs[0], outs[1])
    for a, r in zip(*grads):
        assert torch.equal(a, r)


def _swap_layer_norm(monkeypatch, cls):
    for mod in (components, transformer, lgi, flashvtg_ms):
        monkeypatch.setattr(mod, "LayerNorm", cls)


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_preset_state_dict_keys_unchanged(preset, monkeypatch):
    """Every preset's model holds only the port's LayerNorm (no plain
    nn.LayerNorm left), and its state-dict keys, shapes and dtypes are those
    of the same model built with nn.LayerNorm (reference checkpoints load
    as before; tests/test_torch_checkpoint.py loads them)."""
    cfg = from_preset(preset).model_config()
    model = build_model(cfg, "cpu", seed=0)
    norms = [m for m in model.modules() if isinstance(m, nn.LayerNorm)]
    assert norms and all(type(m) is ln.LayerNorm for m in norms)
    _swap_layer_norm(monkeypatch, lambda d, eps=1e-5: nn.LayerNorm(d, eps=eps))
    plain = build_model(cfg, "cpu", seed=0)
    assert not any(isinstance(m, ln.LayerNorm) for m in plain.modules())
    want = {k: (tuple(v.shape), v.dtype) for k, v in plain.state_dict().items()}
    assert {k: (tuple(v.shape), v.dtype) for k, v in model.state_dict().items()} == want
    model.load_state_dict(plain.state_dict())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(512, 256), (3, 11, 770), (64, 4096), (9, 33)])
def test_twins_match_torch_layer_norm(dtype, shape):
    """layer_norm_plain against F.layer_norm of x widened to f32, and
    layer_norm_bwd_plain against its autograd (dx rounded to x's dtype as
    autograd's cast back rounds it), rows with an offset mean."""
    x, w, b = _inputs(shape, 1, dtype)
    y, stats = ln.layer_norm_plain(x, w, b)
    xf = x.float().detach().requires_grad_()
    wf, bf = w.clone().requires_grad_(), b.clone().requires_grad_()
    ref = F.layer_norm(xf, shape[-1:], wf, bf, 1e-5)
    assert y.dtype == torch.float32 and stats.shape == (2, x.numel() // shape[-1])
    assert _rel(y, ref) <= RTOL
    d = shape[-1]
    assert _rel(stats[0], x.float().reshape(-1, d).mean(-1)) <= RTOL
    dy = torch.randn(shape, generator=torch.Generator().manual_seed(2))
    ref.backward(dy)
    dx, dw, db = ln.layer_norm_bwd_plain(dy, x, stats, w)
    assert dx.dtype == dtype and dx.shape == x.shape
    assert _rel(dw, wf.grad) <= RTOL and _rel(db, bf.grad) <= RTOL
    want = xf.grad.to(dtype).float()
    if dtype == torch.float32:
        assert _rel(dx, want) <= RTOL
    else:
        gap = (dx.float() - want).abs()
        assert bool((gap <= BF16_STEP * want.abs() + RTOL * want.abs().max()).all())
    assert ln.layer_norm_bwd_plain(dy, x, stats, w, want_dx=False)[0] is None


# --- the launchers against a fake library ------------------------------------


def _view(ptr, shape, dtype):
    """A CPU tensor over the memory at `ptr` (what the C entry would read or
    write there)."""
    n = int(np.prod(shape))
    if dtype == torch.bfloat16:
        raw = np.ctypeslib.as_array(ctypes.cast(ptr, ctypes.POINTER(ctypes.c_int16)), (n,))
        return torch.from_numpy(raw).view(torch.bfloat16).view(shape)
    raw = np.ctypeslib.as_array(ctypes.cast(ptr, ctypes.POINTER(ctypes.c_float)), (n,))
    return torch.from_numpy(raw).view(shape)


class _FakeLibrary:
    """The C entries of csrc/layer_norm.cu, by their documented arguments,
    computed by the plain twins on the memory the pointers name."""

    def __init__(self):
        self.calls = []

    def flashvtg_layer_norm_fwd(self, x, gamma, beta, y, stats, rows, d, x_bf16, eps, stream):
        self.calls.append(("fwd", stats is not None))
        dt = torch.bfloat16 if x_bf16 else torch.float32
        out, st = ln.layer_norm_plain(_view(x, (rows, d), dt), _view(gamma, (d,), torch.float32),
                                      _view(beta, (d,), torch.float32), eps)
        _view(y, (rows, d), torch.float32).copy_(out)
        if stats is not None:
            _view(stats, (2, rows), torch.float32).copy_(st)
        return 0

    def flashvtg_layer_norm_bwd(self, x, dy, stats, gamma, dx, part, dgamma, dbeta, rows, d,
                                x_bf16, blocks, stream):
        self.calls.append(("bwd", dx is not None, blocks))
        dt = torch.bfloat16 if x_bf16 else torch.float32
        gx, gw, gb = ln.layer_norm_bwd_plain(
            _view(dy, (rows, d), torch.float32), _view(x, (rows, d), dt),
            _view(stats, (2, rows), torch.float32), _view(gamma, (d,), torch.float32),
            want_dx=dx is not None)
        _view(part, (2, blocks, d), torch.float32).zero_()
        if dx is not None:
            _view(dx, (rows, d), dt).copy_(gx)
        _view(dgamma, (d,), torch.float32).copy_(gw)
        _view(dbeta, (d,), torch.float32).copy_(gb)
        return 0


@pytest.fixture
def fake_card(monkeypatch):
    """The launchers on CPU tensors: the fake library, no device checks, no
    stream, no capture."""
    lib = _FakeLibrary()
    monkeypatch.setattr(ln, "_lib", lambda: lib)
    monkeypatch.setattr(ln, "_check", lambda x, w, b: None)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda device: 0, raising=False)
    monkeypatch.setattr(ln, "bwd_blocks", lambda rows, d, bf16, device: 3)
    monkeypatch.setattr(torch._C, "_cuda_isCurrentStreamCapturing", lambda: False,
                        raising=False)
    ln.reset_launch_counts()
    return lib


@pytest.mark.parametrize("x_grad", [True, False])
def test_launchers_count_once_a_launch(fake_card, x_grad):
    """The autograd Function through the launchers: one forward launch with
    the statistics, one backward launch (dx only where x wants a gradient),
    each counted once; the results are the twins' and autograd's shapes and
    dtypes. The forward launcher without a gradient writes no statistics."""
    x, w, b = _inputs((4, 6, 40), 3)
    x = x.requires_grad_(x_grad)
    w, b = w.requires_grad_(), b.requires_grad_()
    y = ln._LayerNormFn.apply(x, w, b, 1e-5)
    assert ln.launch_counts() == {"layer_norm": 1, "layer_norm_bwd": 0}
    dy = torch.randn(y.shape, generator=torch.Generator().manual_seed(4))
    y.backward(dy)
    assert ln.launch_counts() == {"layer_norm": 1, "layer_norm_bwd": 1}
    assert fake_card.calls == [("fwd", True), ("bwd", x_grad, 3)]
    want, stats = ln.layer_norm_plain(x.detach(), w.detach(), b.detach())
    assert torch.equal(y.detach(), want)
    dx, dw, db = ln.layer_norm_bwd_plain(dy, x.detach(), stats, w.detach())
    assert torch.equal(w.grad, dw) and torch.equal(b.grad, db)
    assert (x.grad is not None) == x_grad
    if x_grad:
        assert torch.equal(x.grad, dx)
    with torch.no_grad():
        out = ln._forward(x, w, b, 1e-5, False)[1]
    assert torch.equal(out, want)
    assert fake_card.calls[-1] == ("fwd", False)
    assert ln.launch_counts() == {"layer_norm": 2, "layer_norm_bwd": 1}


def test_launcher_reads_strided_input_as_contiguous(fake_card):
    """A transposed input (the pyramid's LayerNorm over a convolution's
    output) is read as its contiguous copy, and a bf16 one keeps dx bf16."""
    x, w, b = _inputs((2, 9, 32), 5)
    xt = x.transpose(1, 2).contiguous().transpose(1, 2).to(torch.bfloat16).requires_grad_()
    assert not xt.is_contiguous()
    y = ln._LayerNormFn.apply(xt, w, b, 1e-5)
    assert y.dtype == torch.float32 and y.shape == xt.shape
    assert torch.equal(y, ln.layer_norm_plain(xt.detach().contiguous(), w, b)[0])
    y.sum().backward()
    assert xt.grad.dtype == torch.bfloat16 and xt.grad.shape == xt.shape


@pytest.mark.parametrize("training", [True, False])
def test_layer_norm_counter_counts_each_call(training):
    """`ops.layer_norm` counts each call of the op: once a LayerNorm module
    call, as many as the model's LayerNorm calls in a forward."""
    m = ln.LayerNorm(16).train(training)
    x = torch.randn(3, 16)
    before = obs.counter("ops.layer_norm")
    for _ in range(3):
        m(x)
    assert obs.counter("ops.layer_norm") - before == 3
    cfg = from_preset("tacos", t2v_layers=1, enc_layers=1, dummy_layers=1).model_config()
    model = build_model(cfg, "cpu", seed=0).train(training)
    calls = []
    for mod in model.modules():
        if isinstance(mod, ln.LayerNorm):
            mod.register_forward_hook(lambda *a: calls.append(1))
    b, lq, lv = 2, 5, 64
    txt_mask = torch.ones(b, lq)
    vid_mask = torch.ones(b, lv)
    before = obs.counter("ops.layer_norm")
    with torch.no_grad():
        model(torch.randn(b, lq, cfg.txt_dim), txt_mask, torch.randn(b, lv, cfg.vid_dim),
              vid_mask)
    assert calls and obs.counter("ops.layer_norm") - before == len(calls)


def test_kernel_names_classify_as_other():
    """Every kernel of csrc/layer_norm.cu, by the profiler's demangled name
    at each instance type, is "other" in tools/profile_eval.py:kernel_class
    and in the benchmark's frozen copy (vtgbench/yardstick/kernels.py), and
    of no attention family: its time stays in other_ms_per_step.train."""
    from flashvtg_tpu_torch.tools import profile_eval
    from vtgbench.yardstick import kernels as yardstick

    with open(f"{kernels.CSRC}/{kernels.SOURCES['layer_norm']}") as f:
        names = set(re.findall(r"\b(vtg_\w+_kernel)\b", f.read()))
    assert names == {"vtg_layer_norm_fwd_kernel", "vtg_layer_norm_fwd_wide_kernel",
                     "vtg_layer_norm_bwd_kernel", "vtg_layer_norm_bwd_wide_kernel",
                     "vtg_layer_norm_bwd_sum_kernel"}
    for name in sorted(names):
        for t in ("float", "__nv_bfloat16"):
            full = (f"void (anonymous namespace)::{name}<{t}, 4, 2>({t} const*, float const*, "
                    f"float const*, float*, float*, int, int, float)")
            assert profile_eval.kernel_class(full) == "other", full
            assert yardstick.kernel_class(full) == "other", full
            assert yardstick.family(full) is None, full
