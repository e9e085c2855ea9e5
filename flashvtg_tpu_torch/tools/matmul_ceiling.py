"""The measured ceilings of the flagship model's products on the card, at
each precision dial (counterpart of scripts/bench_matmul_ceiling.py).

    python -m flashvtg_tpu_torch.tools.matmul_ceiling [--eval-bsz 512]
        [--train-bsz 32] [--reps 20]

Rows, each at float32, tensorfloat32 and bfloat16 (utils/runtime.py:
matmul_precision, as the model's steps run them; autocast without its
cache, so the bf16 casts of the weights are in the time, as in a train
step):
  square4k            one 4096^3 matmul: the card's own rate at the dial;
  skeleton            the flagship eval forward's products alone (B 512,
                      Lv 75, Lq 32, hidden 256): every matmul and
                      convolution that utils/flops.py:model_flops counts, of
                      the same shapes and number, chained with reshapes,
                      adds and ReLUs only (no softmax, mask or LayerNorm);
                      no eval step can beat its rate, which is
                      utils/flops.py:MEASURED_SKELETON_TFLOPS;
  skeleton_train      the same chain's forward and full backward (input and
                      weight gradients: 3x the forward's products) at the
                      train batch B 32, one trunk pass:
                      MEASURED_TRAIN_SKELETON_TFLOPS.
Each call is captured in a CUDA graph (so the host's launches are out of
the time) and replayed --reps times between CUDA events, best of 5
rounds. Prints the card's name and power limit, then one JSON object. The
FLOPs of each row are model_flops's (skeleton: its `fwd`, the elementwise
pooling and saliency dots aside, under 0.1 %).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from typing import Dict

import torch
import torch.nn.functional as F

LV, LQ = 75, 32
DIALS = ("float32", "tensorfloat32", "bfloat16")


def skeleton_weights(cfg, device, seed: int = 0) -> Dict[str, torch.Tensor]:
    """The chain's weights for ExperimentConfig `cfg` (its model's shapes),
    float32, scaled so activations stay O(1). Distinct weights where one
    could be reused, as the model's are."""
    mcfg = cfg.model_config()
    d, ff, k, kc = cfg.hidden_dim, cfg.dim_feedforward, cfg.kernel_size, mcfg.coord_kernel_size
    g = torch.Generator().manual_seed(seed)

    def w(*shape):
        return (torch.randn(*shape, generator=g) / shape[-2 if len(shape) == 2 else 1] ** 0.5
                ).to(device)

    return {
        "vp0": w(mcfg.vid_dim, d), "vp1": w(d, d), "tp0": w(mcfg.txt_dim, d), "tp1": w(d, d),
        "wq": w(d, d), "wk": w(d, d), "wv": w(d, d), "out": w(d, d),
        "ff1": w(d, ff), "ff2": w(ff, d), "sal1": w(d, d), "sal2": w(d, d),
        "pyr": w(d, d, 2),  # conv1d weights: (out, in, k)
        "cls_conv0": w(d, d, k), "cls_conv1": w(d, d, k),
        "mlp_in0": w(d, d // 2), "mlp_in1": w(d, d // 2),
        "mlp_mid0": w(d // 2, d // 2), "mlp_mid1": w(d // 2, d // 2),
        "mlp_out0": w(d // 2, 1), "mlp_out1": w(d // 2, 1),
        "crd_conv": w(d, d, kc), "crd_out": w(2, d, kc), "pool": w(d, 1),
    }


def skeleton(cfg, w: Dict[str, torch.Tensor], src_vid: torch.Tensor,
             src_txt: torch.Tensor) -> torch.Tensor:
    """The chain (see the module's doc) on (B, Lv, vid_dim) / (B, Lq,
    txt_dim) inputs; a scalar that keeps every product live."""
    d, h, nd = cfg.hidden_dim, cfg.nheads, cfg.num_dummies
    dh = d // h

    def split(x):  # (B, L, d) -> (B, h, L, dh)
        return x.unflatten(-1, (h, dh)).transpose(1, 2)

    def merge(x):  # (B, h, L, dh) -> (B, L, d)
        return x.transpose(1, 2).flatten(2)

    def ffn(x):
        return x + F.relu(x @ w["ff1"]) @ w["ff2"]

    def enc_layer(x):  # q / k / v / out projections, two products, the FFN
        q, k, v = split(x @ w["wq"]), split(x @ w["wk"]), split(x @ w["wv"])
        ctx = merge(((q @ k.transpose(-1, -2)) * 1e-3) @ v)
        return ffn(x + ctx @ w["out"])

    def aca_layer(vid, txt):  # logits over every key, values without the dummies
        logits = split(vid) @ split(txt).transpose(-1, -2)
        ctx = merge((logits[..., nd:] * 1e-3) @ split(txt[:, nd:]))
        return ffn(vid + ctx @ w["out"])

    def conv(x, kern, stride=1):  # (B, d, L) layout; SAME padding at stride 1
        return F.conv1d(x, kern, stride=stride,
                        padding=kern.shape[-1] // 2 if stride == 1 else 0)

    vid = F.relu(src_vid @ w["vp0"]) @ w["vp1"]
    txt0 = F.relu(src_txt @ w["tp0"]) @ w["tp1"]
    txt = torch.cat([txt0[:, :1].expand(-1, nd, -1), txt0], 1)
    for _ in range(cfg.dummy_layers):
        txt = enc_layer(txt)
    for _ in range(cfg.t2v_layers):
        vid = aca_layer(vid, txt)
    for _ in range(cfg.enc_layers):
        vid = enc_layer(vid)
    glob = vid.mean(1, keepdim=True)
    acc = ((vid @ w["sal1"]) * (glob @ w["sal2"])).sum(-1).mean()
    x = vid.transpose(1, 2)
    levels = [x]
    for s in (s for s in cfg.strides if vid.shape[1] >= s and s > 1):
        y = x
        while s > 1:
            y, s = conv(y, w["pyr"], stride=2), s // 2
        levels.append(y)
    cat = torch.cat(levels, -1)  # (B, d, N points)
    for j in range(2):  # the class and the confidence heads
        y = cat
        for _ in range(cfg.num_conv_layers):
            y = conv(y, w[f"cls_conv{j}"])
        y = F.relu(y.transpose(1, 2) @ w[f"mlp_in{j}"])
        for _ in range(cfg.num_mlp_layers - 2):
            y = F.relu(y @ w[f"mlp_mid{j}"])
        acc = acc + (y @ w[f"mlp_out{j}"]).mean()
    acc = acc + conv(conv(cat, w["crd_conv"]), w["crd_out"]).mean()
    return acc + (txt0 @ w["pool"]).mean() + cat.mean()


def graph_ms(fn, reps: int, rounds: int = 5) -> float:
    """ms of one call of fn, captured in a CUDA graph after 3 warm-up calls
    on a side stream and replayed `reps` times between CUDA events; the
    best of `rounds`."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    best = float("inf")
    for _ in range(rounds):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            graph.replay()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / reps)
    return best


def rate_row(flops: float, make_fn, device, reps: int) -> Dict:
    """{dial: {ms, tflops}} of make_fn()'s call at each dial, and its GFLOPs."""
    from flashvtg_tpu_torch.utils.runtime import matmul_precision

    row = {"gflops": flops / 1e9}
    for dial in DIALS:
        fn = make_fn()

        def call(fn=fn, dial=dial):
            with matmul_precision(dial, device, autocast_cache=False):
                return fn()

        ms = graph_ms(call, reps)
        row[dial] = {"ms": ms, "tflops": flops / (ms * 1e-3) / 1e12}
    return row


def measure(device, eval_bsz: int = 512, train_bsz: int = 32, reps: int = 20,
            seed: int = 0) -> Dict:
    """The three rows (see the module's doc) at the flagship's shapes."""
    from flashvtg_tpu_torch.train.config import from_preset
    from flashvtg_tpu_torch.utils.flops import model_flops

    cfg = from_preset("qvhighlights_slowclip")
    mcfg = cfg.model_config()
    g = torch.Generator().manual_seed(seed)
    out = {"lv": LV, "lq": LQ, "eval_bsz": eval_bsz, "train_bsz": train_bsz}

    n = 4096
    a, b = (torch.randn(n, n, generator=g).to(device) for _ in range(2))
    out["square4k"] = rate_row(2.0 * n**3, lambda: (lambda: a @ b), device, reps)

    w = skeleton_weights(cfg, device, seed)
    vid = torch.randn(eval_bsz, LV, mcfg.vid_dim, generator=g).to(device)
    txt = torch.randn(eval_bsz, LQ, mcfg.txt_dim, generator=g).to(device)
    fwd = model_flops(mcfg, eval_bsz, LQ, LV)["fwd"]
    with torch.no_grad():
        out["skeleton"] = rate_row(fwd, lambda: (lambda: skeleton(cfg, w, vid, txt)),
                                   device, reps)

    tw = {k: v.clone().requires_grad_() for k, v in w.items()}
    tvid = torch.randn(train_bsz, LV, mcfg.vid_dim, generator=g).to(device).requires_grad_()
    ttxt = torch.randn(train_bsz, LQ, mcfg.txt_dim, generator=g).to(device).requires_grad_()
    inputs = list(tw.values()) + [tvid, ttxt]
    t_fwd = model_flops(mcfg, train_bsz, LQ, LV, with_neg=False)["fwd"]

    def train_fn():
        return lambda: torch.autograd.grad(skeleton(cfg, tw, tvid, ttxt), inputs)

    out["skeleton_train"] = rate_row(3.0 * t_fwd, train_fn, device, reps)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--eval-bsz", type=int, default=512)
    ap.add_argument("--train-bsz", type=int, default=32)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("matmul_ceiling: CUDA is not available; this tool times the card",
              file=sys.stderr)
        return 2
    from flashvtg_tpu_torch.utils.runtime import resolve_device

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0], flush=True)
    print(json.dumps(measure(resolve_device("cuda"), args.eval_bsz, args.train_bsz,
                             args.reps)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
