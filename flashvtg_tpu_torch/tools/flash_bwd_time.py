"""Times the attention kernels on the card at the model's shapes, beside
their bounds and PyTorch's scaled_dot_product_attention (sdpa): the flash
kernels (csrc/flash_attention.cu, forward; csrc/flash_attention_bwd.cu,
backward), the ACA kernel (csrc/aca_attention.cu) and its backward
(csrc/aca_attention_bwd.cu), and the same two kernels in their short form
(the masked self-attention over up to 128 keys: no dummies, no head mean).

    python -m flashvtg_tpu_torch.tools.flash_bwd_time [--forms bf16 3xtf32 1xtf32]
        [--shapes tacos_eval tacos_train ... tacos_train_aca ... flagship_train_short42]
        [--passes fwd bwd] [--blocks 3] [--iters 20] [--seed 0] [--dropout 0.1]
        [--no-library] [--sass-mix]

Flash shapes, an encoder self-attention (B, L, 8 heads of 32, a ragged
valid prefix of clips a video drawn from --seed): TACoS eval (B 8, L 2048,
64-2048 clips), TACoS train (B 32, L 2048, 64-2048) and TVSum train (B 4,
L 1000, 60-330). ACA shapes, Lv video queries over nd dummies and a ragged
text (chip_smoke.py phase 7's draws: 5 to lq text tokens valid, 64-2048 or
20-75 clips; the train shapes with the core model's donor-row mask and a
head-mean gradient): TACoS train (B 32, Lv 2048, 35 dummies + 40 text
tokens), flagship train (B 64, Lv 75, 10 + 32) and flagship eval (B 256,
the eval instance with the head mean). Short-form shapes: the flagship
train's encoder (B 64, L 75, 20-75 clips) and dummy encoder (B 64, L 42,
10 dummies + 5-32 text tokens), TACoS train's dummy encoder (B 32, L 75,
35 + 5-40) and the flagship eval's encoder (B 256, L 75).
The forward pass (`fwd`) times the kernel's eval instance at an eval shape
and its training instance (log-sum-exp and dropout --dropout) at a train
shape; the backward pass (`bwd`, train shapes only) runs the training
forward once for its outputs and log-sum-exp, then times the backward.
Each is timed as --blocks blocks of --iters launches with CUDA events,
beside the same blocks of sdpa on the same inputs, for the flash and the
short shapes only (no single PyTorch call computes the ACA: its dummies
leave p.v, its head mean): the boolean key mask, no dropout; bf16
operands at the bf16 form, the TF32 flag at 1xtf32; the forward under
no_grad, the backward as fwd + bwd - fwd through autograd.grad;
--no-library leaves it out. Each kernel's device time a launch is read
from torch.profiler's records. The bound: the flash shapes' is
chip_smoke.py:attention_bound's, written out here (the training forward
also writes the log-sum-exp); the ACA and short shapes take
chip_smoke.py:attention_bound itself (with aca_pairs' count of the pairs
the donor rows leave), so the tool runs from a checkout's root: the bytes
each input and output needs once at 3.35 TB/s against the valid pairs'
dot products at the form's tensor-core rate (bf16: 989 TFLOP/s) and the
other operations a pair at 67. Prints the card's name and power limit,
the registers and spills ptxas reported for every attention kernel with
a product (the build logs beside the libraries), with --sass-mix each of
their instances' SASS opcodes (cuobjdump, counted once where they stand,
not as they run: HMMA for mma.sync, HGMMA for wgmma, UTMALDG for a TMA
copy), then one JSON line a (shape, pass, form). At the bf16 form each
flash forward line is followed by one of its pre-pass alone (`pass`
"fwd_prepass": the device function flash_fwd_stage_kernel, which rounds k
and v to the bf16 copies that the kernel's TMA copies read), and each flash
backward line by one of its own pre-pass (`pass` "bwd_prepass": the device
function flash_bwd_stage_kernel, which at the bf16 form also writes the
bf16 copies of scale q, q and dO, and of k and v unless the training
forward handed its copies over, as the autograd Function does and this tool
does where the tree's launchers take them; or flash_bwd_delta_kernel, D
alone), each with its bound, the bytes it moves once at 3.35 TB/s
(prepass_bound_ms); the forward's `ms` holds its pre-pass.

It uses only ops/chunked_attn.py's and ops/aca.py's launchers, so it also
times another tree of the package: put that tree first on PYTHONPATH and
run this file by its path; one call can then read parent / change /
change / parent.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import re
import shutil
import subprocess

import numpy as np
import torch

HBM_RATE = 3.35e12
F32_PEAK = 67e12
DOT_PEAK = {"3xtf32": 495e12 / 3, "1xtf32": 495e12, "bf16": 989e12}
# the flash kernels: (B, L, fewest and most valid clips a video, training)
SHAPES = {"tacos_eval": (8, 2048, 64, 2048, False), "tacos_train": (32, 2048, 64, 2048, True),
          "tvsum_train": (4, 1000, 60, 330, True)}
# the ACA: (B, Lv, dummies, text tokens, fewest and most valid clips, training)
ACA_SHAPES = {"tacos_train_aca": (32, 2048, 35, 40, 64, 2048, True),
              "flagship_train_aca": (64, 75, 10, 32, 20, 75, True),
              "flagship_eval_aca": (256, 75, 10, 32, 20, 75, False)}
# the short form: (B, L, leading keys always valid, fewest and most valid
# keys past them, training)
SHORT_SHAPES = {"flagship_train_short75": (64, 75, 0, 20, 75, True),
                "flagship_train_short42": (64, 42, 10, 5, 32, True),
                "tacos_train_short75": (32, 75, 35, 5, 40, True),
                "flagship_eval_short75": (256, 75, 0, 20, 75, False)}
HEADS, DROPOUT = 8, 0.1
# the attention kernels' device functions, by the names their template
# instances carry
KERNEL_NAME = re.compile(r"(flash_attention_kernel|flash_fwd_stage_kernel"
                         r"|flash_bwd_\w+?_kernel"
                         r"|aca_attention_bwd_reduce_kernel|aca_attention_bwd_kernel"
                         r"|aca_attention_kernel)")
PRODUCT_KERNEL = re.compile(r"(flash_attention_kernel|flash_bwd_(?:dq|dkdv)_kernel"
                            r"|aca_attention_kernel|aca_attention_bwd_kernel)ILi(\d)E"
                            r"((?:L[ib]\d+E)*)")
LIBRARIES = ("flash_attention", "flash_attention_bwd", "aca_attention", "aca_attention_bwd")


def time_blocks(fn, blocks: int, iters: int):
    """ms a call of fn in each of `blocks` blocks of `iters` calls."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(blocks):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / iters)
    return out


def kernel_ms(fn, iters: int):
    """{device function: ms a call} of `iters` calls of fn, from the
    profiler's raw device records (the flash kernels, by the name their
    template instance carries)."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    per = {}
    for e in prof.profiler.kineto_results.events():
        m = KERNEL_NAME.search(e.name())
        if m and e.device_type() == torch.autograd.DeviceType.CUDA:
            per[m.group(1)] = per.get(m.group(1), 0.0) + e.duration_ns() / 1e6 / iters
    return per


def bound_ms(b, length, valid_pairs, form, backward, train):
    """chip_smoke.py:attention_bound for the flash kernels (self-attention,
    every query row against every valid key); the training forward also
    writes the log-sum-exp."""
    d = HEADS * 32
    if backward:
        nbytes = 4 * (3 * b * length * d + 4 * b * length * d + b * length
                      + b * HEADS * length + b * length * d)
        dots, other = 320 * valid_pairs, 6 * valid_pairs
    else:
        nbytes = 4 * (4 * b * length * d + b * length + (b * HEADS * length if train else 0))
        dots, other = 128 * valid_pairs, 5 * valid_pairs
    t_ops = max(dots / DOT_PEAK[form], other / F32_PEAK)
    return max(nbytes / HBM_RATE, t_ops) * 1e3


def prepass_bound_ms(b, length, form, kv_staged=False):
    """The flash backward pre-pass's bound: it reads O and dO (and at bf16 q,
    k, v too, or q alone when the forward's k and v copies are handed over,
    `kv_staged`) in f32 and writes D, and at bf16 five bf16 copies (scale q,
    q, k, v, dO; three when handed over), each once, at the memory rate."""
    n = b * length * HEADS * 32
    nbytes = 4 * 2 * n + 4 * b * HEADS * length
    if form == "bf16":
        nbytes += (4 * n + 2 * 3 * n) if kv_staged else (4 * 3 * n + 2 * 5 * n)
    return nbytes / HBM_RATE * 1e3


def fwd_prepass_bound_ms(b, length):
    """The flash forward's bf16 pre-pass's bound: k and v read in f32 and
    written as bf16, each once, at the memory rate."""
    n = b * length * HEADS * 32
    return (4 * 2 * n + 2 * 2 * n) / HBM_RATE * 1e3


def ptxas_report(log: str):
    """{kernel function: 'N registers, S bytes spill stores, L bytes spill
    loads'} of the flash kernels with a product in a ptxas -v log."""
    regs, spills, fn, props = {}, {}, None, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn = m.group(1)
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            props = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            regs[fn] = int(m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and props:
            spills[props] = (int(m.group(1)), int(m.group(2)))
    return {instance(fn): f"{n} registers, {spills.get(fn, ('?', '?'))[0]} bytes spill "
                          f"stores, {spills.get(fn, ('?', '?'))[1]} bytes spill loads"
            for fn, n in regs.items() if PRODUCT_KERNEL.search(fn)}


def instance(fn: str) -> str:
    """kernel<form, template arguments...> of a mangled attention kernel
    with a product (the flash forward's training flag, the ACA forward's
    NT, head mean and training flags, the ACA backward's NT)."""
    m = PRODUCT_KERNEL.search(fn)
    rest = re.findall(r"L[ib](\d+)E", m.group(3))
    return f"{m.group(1)}<{', '.join([m.group(2), *rest])}>"


def sass_mix(library: str):
    """{attention kernel instance: {opcode: SASS lines}}, the opcode without
    its modifiers (HMMA.16816.F32.BF16 counts as HMMA); an instance is
    named as `instance` names it."""
    out, fn = {}, None
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    sass = subprocess.run([tool, "--dump-sass", library], capture_output=True, text=True,
                          check=True).stdout
    for line in sass.splitlines():
        if "Function :" in line:
            fn = instance(line) if PRODUCT_KERNEL.search(line) else None
            if fn:
                out[fn] = {}
            continue
        m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
        if fn and m:
            out[fn][m.group(1)] = out[fn].get(m.group(1), 0) + 1
    return {fn: dict(sorted(per.items(), key=lambda kv: -kv[1])) for fn, per in out.items()}


def ragged(rng, b, n, lo, hi, always=0):
    """(b, n) float32 mask on the card: `always` leading ones, then a valid
    prefix of [lo, hi] more keys a row (chip_smoke.py:ragged_mask's draw)."""
    lens = always + rng.integers(lo, hi + 1, b)
    return torch.from_numpy((np.arange(n)[None] < lens[:, None]).astype(np.float32)).cuda()


def aca_cases(shape, form, seed, dropout):
    """(calls {pass: fn}, bounds {pass: ms}, library inputs (q, k, v, key
    mask) or None, facts) of an ACA or short-form shape at `form`: the
    launchers of ops/aca.py on inputs drawn from `seed`, the bounds from
    chip_smoke.py:attention_bound."""
    from chip_smoke import aca_pairs, attention_bound

    from flashvtg_tpu_torch.models.transformer import tiled_attn_donors
    from flashvtg_tpu_torch.ops import aca
    from flashvtg_tpu_torch.ops.attn_dropout import seed_tensor

    rng = np.random.default_rng(seed)
    g = torch.Generator().manual_seed(seed)
    if shape in ACA_SHAPES:
        b, lv, nd, lq, lo, hi, train = ACA_SHAPES[shape]
        lk = nd + lq
        valid = ragged(rng, b, lk, 5, lq, always=nd)
        vmask = ragged(rng, b, lv, lo, hi)
        # the train path's donor-row mask (the eval path has none)
        donors = tiled_attn_donors(b, HEADS, torch.device("cuda")) if train else None
        hm = True
    else:
        b, lv, nd_always, lo, hi, train = SHORT_SHAPES[shape]
        lk, nd, vmask, donors, hm = lv, 0, None, None, False
        valid = ragged(rng, b, lk, lo, hi, always=nd_always)
    q, k, v = (torch.randn((b, n, HEADS * 32), generator=g).cuda() for n in (lv, lk, lk))
    d_out = torch.randn((b, lv, HEADS * 32), generator=g).cuda()
    d_hm = torch.randn((b, lv, lk), generator=g).cuda() if hm else None
    p = dropout if train else 0.0
    drop_seed = seed_tensor(seed, "cuda")  # on the card, as the model's calls take it
    pairs = None if donors is None else aca_pairs(valid, vmask, donors, nd)
    calls, bounds = {}, {}
    if train:
        args = (q, k, v, valid, HEADS, nd, hm, p, drop_seed, vmask, donors)
        calls["fwd"] = lambda: aca._launch(*args, want_lse=True, form=form)
        lse = calls["fwd"]()[2]
        calls["bwd"] = lambda: aca._launch_bwd(q, k, v, valid, lse, d_out, d_hm, HEADS, nd, p,
                                               drop_seed, vmask, donors, form=form)
    else:
        calls["fwd"] = lambda: aca._launch(q, k, v, valid, HEADS, nd, hm, form=form)
    for pas in calls:
        bounds[pas] = attention_bound(b, lv, lk, HEADS, nd, valid, hm, backward=pas == "bwd",
                                      pairs=pairs, form=form)[0]
    facts = dict(B=b, Lv=lv, Lk=lk, nd=nd, heads=HEADS, dropout=p,
                 valid_keys=int(valid.sum().item()), donor_rows=donors is not None)
    return calls, bounds, None if shape in ACA_SHAPES else (q, k, v, valid), facts


def sdpa_calls(q, k, v, valid, form):
    """(forward, forward + backward) of sdpa on q, k, v in (B, H, L, Dh),
    bf16 at the bf16 form, with the boolean key mask."""
    import torch.nn.functional as F

    b = q.shape[0]
    dtype = torch.bfloat16 if form == "bf16" else q.dtype
    qh, kh, vh = (x.view(b, -1, HEADS, 32).transpose(1, 2).contiguous().to(dtype)
                  .requires_grad_() for x in (q, k, v))
    d_oh = torch.randn_like(qh)
    mask = (valid > 0)[:, None, None, :]

    def fwd():
        return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)

    def fwd_eval():
        with torch.no_grad():
            return fwd()

    return fwd_eval, fwd, lambda: torch.autograd.grad(fwd(), (qh, kh, vh), d_oh)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--forms", nargs="+", default=["bf16"], choices=list(DOT_PEAK))
    every = [*SHAPES, *ACA_SHAPES, *SHORT_SHAPES]
    ap.add_argument("--shapes", nargs="+", default=every, choices=every)
    ap.add_argument("--passes", nargs="+", default=["fwd", "bwd"], choices=["fwd", "bwd"])
    ap.add_argument("--blocks", type=int, default=3)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dropout", type=float, default=DROPOUT)
    ap.add_argument("--no-library", action="store_true", help="leave sdpa out")
    ap.add_argument("--sass-mix", action="store_true", help="print the kernels' opcodes")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("flash_bwd_time: needs a CUDA card")

    from flashvtg_tpu_torch import kernels
    from flashvtg_tpu_torch.ops import chunked_attn
    from flashvtg_tpu_torch.utils.runtime import matmul_precision

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0], flush=True)
    ptxas = {}
    for name in LIBRARIES:
        kernels.load(name)
        log_path = kernels.library_path(name) + ".log"
        ptxas.update(ptxas_report(open(log_path).read() if os.path.exists(log_path) else ""))
    print(json.dumps({"tree": os.path.dirname(os.path.dirname(kernels.__file__)),
                      "ptxas": ptxas}), flush=True)
    if args.sass_mix:
        mix = {}
        for name in LIBRARIES:
            mix.update(sass_mix(kernels.library_path(name)))
        print(json.dumps({"sass_mix": mix}), flush=True)
    dev = torch.device("cuda")
    mode = {"3xtf32": "float32", "1xtf32": "tensorfloat32", "bf16": "bfloat16"}

    def report(shape, pas, form, fn, bound, lib_inputs, facts, prepass_bound=None,
               prepass="bwd_prepass"):
        ms = time_blocks(fn, args.blocks, args.iters)
        sdpa = None
        if lib_inputs is not None and not args.no_library:
            fwd_eval, fwd, both = sdpa_calls(*lib_inputs, form)
            # the dial's TF32 flag only: sdpa's operands carry the dtype
            with matmul_precision("tensorfloat32" if form == "1xtf32" else "float32", "cuda"):
                if pas == "fwd":
                    sdpa = time_blocks(fwd_eval, args.blocks, args.iters)
                else:
                    sdpa = [x - y for x, y in zip(
                        time_blocks(both, args.blocks, args.iters),
                        time_blocks(fwd, args.blocks, args.iters))]
        per_kernel = kernel_ms(fn, args.iters)
        print(json.dumps({"shape": shape, "pass": pas, **dict(
            form=form, dial=mode[form], **facts,
            ms=float(np.mean(ms)), ms_blocks=ms, kernel_ms=per_kernel,
            bound_ms=bound, library_ms=None if sdpa is None else float(np.mean(sdpa)),
            library_ms_blocks=sdpa,
        )}), flush=True)
        if prepass_bound is not None:
            names = (("flash_fwd_stage_kernel",) if prepass == "fwd_prepass"
                     else ("flash_bwd_stage_kernel", "flash_bwd_delta_kernel"))
            print(json.dumps({"shape": shape, "pass": prepass, "form": form, **facts,
                              "kernel_ms": {k: v for k, v in per_kernel.items() if k in names},
                              "prepass_bound_ms": prepass_bound}), flush=True)

    for shape in args.shapes:
        if shape not in SHAPES:
            for form in args.forms:
                calls, bounds, lib_inputs, facts = aca_cases(shape, form, args.seed,
                                                             args.dropout)
                for pas in args.passes:
                    if pas in calls:
                        report(shape, pas, form, calls[pas], bounds[pas], lib_inputs, facts)
            continue
        b, length, lo, hi, train = SHAPES[shape]
        rng = np.random.default_rng(args.seed)
        lens = rng.integers(lo, hi + 1, b)
        valid = torch.from_numpy((np.arange(length)[None] < lens[:, None]).astype(np.float32))
        g = torch.Generator().manual_seed(args.seed)
        q, k, v, d_out = (torch.randn((b, length, HEADS * 32), generator=g) for _ in range(4))
        q, k, v, d_out, valid = (x.to(dev) for x in (q, k, v, d_out, valid))
        valid_pairs = HEADS * length * float(valid.sum().item())
        p = args.dropout if train else 0.0
        facts = dict(B=b, L=length, heads=HEADS, dropout=p, valid_keys=int(valid.sum().item()))
        # the training forward hands its bf16 k and v copies to the backward
        # where this tree's launchers take them (as its autograd Function does)
        hands_kv = "kv" in inspect.signature(chunked_attn._launch_bwd).parameters
        for form in args.forms:
            calls = {}
            if "fwd" in args.passes:
                if train:
                    calls["fwd"] = lambda form=form: chunked_attn._launch(
                        q, k, v, valid, HEADS, p, args.seed, want_lse=True, form=form)
                else:
                    calls["fwd"] = lambda form=form: chunked_attn._launch(
                        q, k, v, valid, HEADS, form=form)
            kv_staged = hands_kv and form == "bf16"
            if "bwd" in args.passes and train:
                out, lse, *kv = chunked_attn._launch(q, k, v, valid, HEADS, p, args.seed,
                                                     want_lse=True, form=form,
                                                     **({"keep_kv": True} if hands_kv else {}))
                extra = {"kv": kv[0]} if kv_staged else {}
                calls["bwd"] = lambda form=form, out=out, lse=lse, extra=extra: (
                    chunked_attn._launch_bwd(q, k, v, valid, out, lse, d_out, HEADS, p,
                                             args.seed, form=form, **extra))
            for pas, fn in calls.items():
                prepass = None
                if pas == "bwd":
                    prepass = prepass_bound_ms(b, length, form, kv_staged)
                elif form == "bf16" and hasattr(chunked_attn, "stage_kv"):
                    prepass = fwd_prepass_bound_ms(b, length)
                report(shape, pas, form, fn,
                       bound_ms(b, length, valid_pairs, form, pas == "bwd", train),
                       (q, k, v, valid), facts, prepass, pas + "_prepass")


if __name__ == "__main__":
    main()
