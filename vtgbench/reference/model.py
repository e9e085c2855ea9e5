"""The FlashVTG network as plain PyTorch functions of a parameter dict: the
reference the benchmark holds the program against.

Written from the FlashVTG model (github.com/mspercieve/FlashVTG,
FlashVTG/model.py, transformer.py, blocks.py, position_encoding.py) and
keyed by its parameter names: input projections, the dummy-token text
encoder, the ACA layers, the video self-attention encoder, the saliency
projections, the temporal pyramid, the class / confidence / coordinate
heads, and the negative-pair pass in training. Attention is
reference/attention.py. Departures, kept because the program under test
keeps them and they change the function:
  * training: the mean over the padded length and the "donor" rows of the
    misaligned ACA mask (the original's attn_mask tiled head-major, read
    batch-major);
  * evaluation: padded clips zeroed before the pyramid and a strict point
    mask (the original runs one unpadded query at a time);
  * the confidence head convolves the valid points compacted to the front.

Every product (linear layers, convolutions, attention) goes through a
`Form`, which rounds its operands and the gradients that enter it: none
for the reference, bf16, TF32 or fp8 for a control computed below the
configuration's precision. The tensors' dtype is the caller's.

Random draws. A training forward draws, in forward order, one attention
seed a call from the attention generator and the feature dropout, FFN
dropout and DropPath masks from the device's default generator. `Draws`
makes the same draws from generators in the same state: the masks as
torch's dropout and rand make them for a tensor of the dtype the
configuration's dial gives at that site (under bfloat16 autocast a linear
layer's output is bf16, a LayerNorm's float32), applied to the reference's
own activations.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from vtgbench.reference.attention import attention
from vtgbench.reference.forms import Form


class Draws:
    """The random draws of one training forward. `generator` replays the
    attention seeds (its state set by the caller); masks come from the
    device's default generator, whose state the caller sets; `dial` is the
    program's precision dial, which fixes the dtype of the tensor each
    mask is drawn for."""

    def __init__(self, device, generator: torch.Generator, dial: str):
        self.device = torch.device(device)
        self.generator = generator
        self.sites = site_dtypes(dial, self.device)

    def seed(self):
        return torch.randint(0, 1 << 31, (), generator=self.generator, device=self.device,
                             dtype=torch.int32)

    def dropout(self, x, p: float, site: str):
        if p == 0:
            return x
        ones = torch.ones(x.shape, dtype=self.sites[site], device=self.device)
        keep = F.dropout(ones, p, True) != 0
        return x * keep.to(x.dtype) / (1.0 - p)

    def drop_path(self, x, rate: float, site: str):
        if rate == 0:
            return x
        keep = 1.0 - rate
        shape = (x.shape[0],) + (1,) * (x.ndim - 1)
        mask = torch.floor(keep + torch.rand(shape, dtype=self.sites[site], device=self.device))
        return x / keep * mask.to(x.dtype)


def site_dtypes(dial: str, device) -> Dict[str, torch.dtype]:
    """The dtype a dropout site sees under the dial: what autocast gives a
    linear layer's output ("linear"), a PReLU of one ("ffn") and a
    LayerNorm's output ("norm"); float32 everywhere outside bfloat16."""
    device = torch.device(device)
    if dial != "bfloat16":
        return dict.fromkeys(("linear", "ffn", "norm"), torch.float32)
    x = torch.ones(2, 2, device=device)
    with torch.autocast(device.type, dtype=torch.bfloat16):
        lin = F.linear(x, x)
        ffn = F.prelu(F.linear(x, x), torch.full((1,), 0.25, device=device))
        norm = F.layer_norm(x, (2,))
    return {"linear": lin.dtype, "ffn": ffn.dtype, "norm": norm.dtype}


class Ref:
    """The forward of one configuration (a dict of the model's sizes:
    hidden_dim, nheads, num_dummies, dummy layers...) on params `P`
    ({name: tensor}, the original's names), products in `form`."""

    def __init__(self, cfg: dict, P: Dict[str, torch.Tensor], form: Optional[Form] = None):
        self.cfg, self.P = cfg, P
        self.rnd = form or Form()

    # products
    def mm(self, x, w):
        return self.rnd.out(F.linear(self.rnd(x), self.rnd(w)))

    def lin(self, x, name, bias=True):
        y = self.mm(x, self.P[name + ".weight"])
        return y + self.P[name + ".bias"] if bias else y

    def ln(self, x, name):
        return F.layer_norm(x, (x.shape[-1],), self.P[name + ".weight"], self.P[name + ".bias"],
                            1e-5)

    def conv(self, x, w, b, stride=1, padding=0):
        """A Conv1d over L of a channels-last (B, L, C) tensor."""
        y = self.rnd.out(F.conv1d(self.rnd(x.transpose(1, 2)), self.rnd(w), None, stride,
                                  padding))
        return (y + b[:, None]).transpose(1, 2)

    # blocks
    def input_proj(self, x, name, draws):
        n = self.cfg["n_input_proj"]
        for i in range(n):
            x = self.ln(x, f"{name}.{i}.LayerNorm")
            if draws is not None:
                x = draws.dropout(x, self.cfg["input_dropout"], "norm")
            x = self.lin(x, f"{name}.{i}.net.1")
            if i != n - 1:
                x = F.relu(x)
        return x

    def ffn(self, x, name, p, draws):
        h = self.lin(x, f"{name}.linear1")
        h = F.prelu(h, self.P[f"{name}.activation.weight"])
        if draws is not None:
            h = draws.dropout(h, p, "ffn")
        return self.lin(h, f"{name}.linear2")

    def self_attention(self, x, pos, valid, name, heads, p, draws):
        d = x.shape[-1]
        w, b = self.P[f"{name}.in_proj_weight"], self.P[f"{name}.in_proj_bias"]
        qk_in = x + pos
        q = self.mm(qk_in, w[:d]) + b[:d]
        k = self.mm(qk_in, w[d:2 * d]) + b[d:2 * d]
        v = self.mm(x, w[2 * d:]) + b[2 * d:]
        seed = draws.seed() if draws is not None and p > 0 else None
        out, _ = attention(q, k, v, valid, heads, p=p if draws is not None else 0.0,
                           seed=seed, form=self.rnd)
        return self.lin(out, f"{name}.out_proj")

    def encoder(self, x, pos, valid, name, layers, heads, p, draws):
        for l in range(layers):
            n = f"{name}.layers.{l}"
            a = self.self_attention(x, pos, valid, f"{n}.self_attn", heads, p, draws)
            if draws is not None:
                a = draws.drop_path(a, p, "linear")
            x = self.ln(x + a, f"{n}.norm1")
            f = self.ffn(x, n, p, draws)
            if draws is not None:
                f = draws.drop_path(f, p, "linear")
            x = self.ln(x + f, f"{n}.norm2")
        return x

    def t2v(self, vid, txt, pos_vid, pos_txt, txt_valid, donors, vid_table, txt_table, draws):
        cfg = self.cfg
        p = cfg["dropout"]
        attn_sum = None
        for l in range(cfg["t2v_layers"]):
            n = f"transformer.t2v_encoder.layers.{l}"
            seed = draws.seed() if draws is not None and p > 0 else None
            out, mean = attention(vid + pos_vid, txt + pos_txt, txt, txt_valid, cfg["nheads"],
                                  nd=cfg["num_dummies"], head_mean=True,
                                  p=p if draws is not None else 0.0, seed=seed,
                                  donor_q=vid_table, donor_rows=donors, donor_k=txt_table,
                                  form=self.rnd)
            a = self.lin(out, f"{n}.self_attn.out_proj")
            if draws is not None:
                a = draws.drop_path(a, p, "linear")
            x = vid + a
            f = self.ffn(self.ln(x, f"{n}.norm1"), n, p, draws)
            if draws is not None:
                f = draws.drop_path(f, p, "linear")
            vid = self.ln(x + f, f"{n}.norm2")
            attn_sum = mean if attn_sum is None else attn_sum + mean
        return vid, attn_sum / cfg["t2v_layers"]

    def confidence(self, x, name, mask):
        k = self.cfg["kernel_size"]
        for i in range(self.cfg["num_conv_layers"]):
            w = self.P[f"{name}.convs.{i}.weight"][:, :, 0, :]
            x = self.conv(x, w, self.P[f"{name}.convs.{i}.bias"], padding=k // 2)
            if mask is not None:
                x = x * mask[..., None]
            x = F.relu(x)
        n = self.cfg["num_mlp_layers"]
        for j in range(n):
            x = self.lin(x, f"{name}.fc.layers.{j}")
            if j < n - 1:
                x = F.relu(x)
        return x

    def coord(self, x, mask):
        k = self.cfg["coord_kernel_size"]
        P = self.P
        x = self.conv(x, P["coord_head.module.1.weight"], P["coord_head.module.1.bias"],
                      padding=k // 2)
        if mask is not None:
            x = x * mask[..., None]
        x = F.relu(x)
        return self.conv(x, P["coord_head.module.3.weight"], P["coord_head.module.3.bias"],
                         padding=k // 2)

    def pyramid(self, x):
        outs = []
        for i, s in enumerate(self.cfg["strides"]):
            if x.shape[1] < s:
                continue
            if s == 1:  # the original's in-place ReLU: later levels see relu(x)
                x = F.relu(x)
                outs.append(x)
                continue
            y = x
            for j in range(int(math.log2(s))):
                n = f"pyramid.blocks.{i}.{5 * j + 1}"
                y = self.conv(y, self.P[n + ".weight"], self.P[n + ".bias"], stride=2)
                y = F.relu(self.ln(y, f"pyramid.blocks.{i}.{5 * j + 3}"))
            outs.append(y)
        return outs, x

    def forward(self, src_txt, src_txt_mask, src_vid, src_vid_mask, train: bool,
                draws: Optional[Draws] = None, point_valid=None, real_neg_mask=None):
        """The original's output dict (the keys its criterion and decode
        read). `draws` (training) makes the random draws; None runs no
        dropout."""
        cfg, P = self.cfg, self.P
        b, lv = src_vid.shape[:2]
        d, nd, heads = cfg["hidden_dim"], cfg["num_dummies"], cfg["nheads"]
        dr = draws if train else None
        vid = self.input_proj(src_vid, "input_vid_proj", dr) + P["token_type_embeddings.weight"][1]
        txt = self.input_proj(src_txt, "input_txt_proj", dr) + P["token_type_embeddings.weight"][0]
        pos_vid = sine_position_embedding(src_vid_mask, d)
        pos_txt = torch.zeros_like(txt)

        txt_d = torch.cat([P["dummy_rep_token"].expand(b, nd, d), txt], dim=1)
        pos_txt_d = torch.cat([P["dummy_rep_pos"].expand(b, nd, d), pos_txt], dim=1)
        txt_d_valid = torch.cat([src_txt_mask.new_ones((b, nd)), src_txt_mask], dim=1)
        refreshed = self.encoder(txt_d, pos_txt_d, txt_d_valid, "txtproj_encoder",
                                 cfg["dummy_layers"], cfg["dummy_nheads"], cfg["dummy_dropout"], dr)
        dummy = refreshed[:, :nd]
        txt_d = torch.cat([dummy, txt], dim=1)

        def trunk(tokens, valid, donors, txt_table):
            fused, attn = self.t2v(vid, tokens, pos_vid, pos_txt_d, valid, donors, vid_table,
                                   txt_table, dr)
            emb = self.encoder(fused, pos_vid, src_vid_mask, "transformer.encoder",
                               cfg["enc_layers"], heads, cfg["dropout"], dr)
            if train:
                g = emb.mean(dim=1)
            else:
                denom = src_vid_mask.sum(dim=1, keepdim=True).clamp_min(1.0)
                g = (emb * src_vid_mask[..., None]).sum(dim=1) / denom
            sal = (self.lin(emb, "saliency_proj1") * self.lin(g, "saliency_proj2")[:, None, :]
                   ).sum(-1) / math.sqrt(float(d))
            return emb, attn, sal

        donors = vid_table = txt_table = None
        if train:
            donors = tiled_donors(b, heads, src_vid.device)
            vid_table, txt_table = src_vid_mask, txt_d_valid
        emb, attn, sal = trunk(txt_d, txt_d_valid, donors, txt_table)
        if not train:
            emb = emb * src_vid_mask[..., None]
        pymid, emb = self.pyramid(emb)
        strides = cfg["strides"]
        pymid_msk = tuple(pool_mask(src_vid_mask, s) for s in strides if lv >= s)
        points = torch.from_numpy(generate_points(lv, strides)).to(src_vid.device)
        level_masks = [None] * len(pymid)
        if point_valid is not None:
            masked, level_masks, off = [], [], 0
            for e in pymid:
                n = e.shape[1]
                m = point_valid[:, off:off + n]
                masked.append(e * m[..., None])
                level_masks.append(m)
                off += n
            pymid = masked
        out_class = torch.cat([self.confidence(e, "class_head", m)
                               for e, m in zip(pymid, level_masks)], dim=1)
        cat = torch.cat(pymid, dim=1)
        if point_valid is not None:
            valid = point_valid > 0
            nv = valid.sum(dim=1, keepdim=True)
            inv = torch.where(valid, valid.cumsum(dim=1) - 1, nv + (~valid).cumsum(dim=1) - 1)
            comp = torch.zeros_like(cat).scatter_(1, inv[..., None].expand_as(cat), cat)
            comp_msk = (torch.arange(cat.shape[1], device=cat.device)[None, :] < nv
                        ).to(cat.dtype)
            out_conf = torch.gather(self.confidence(comp, "conf_head", comp_msk), 1,
                                    inv[..., None])
        else:
            out_conf = self.confidence(cat, "conf_head", None)
        out_class = P["x"] * out_class + (1.0 - P["x"]) * out_conf
        out_coord = torch.cat([torch.exp(self.coord(e, m)) * P["coef"][i]
                               for i, (e, m) in enumerate(zip(pymid, level_masks))], dim=1)
        a = self.mm(txt, P["pooling.att.weight"])
        a = torch.softmax(a.masked_fill(src_txt_mask[..., None] != 1, float("-inf")), dim=1)
        query_emb = torch.einsum("bld,blo->bod", txt, a)
        t2v = (attn[:, :, nd:] * src_txt_mask[:, None, :]).sum(2).clamp(0.0, 1.0)
        out = {"saliency_scores": sal, "t2vattnvalues": t2v, "video_emb": emb,
               "query_emb": query_emb, "video_msk": src_vid_mask, "pymid_msk": pymid_msk,
               "out_class": out_class, "out_coord": out_coord, "point": points}
        if train and cfg["use_neg"]:
            txt_neg = torch.roll(txt_d, -1, dims=0)
            valid_neg = torch.roll(txt_d_valid, -1, dims=0)
            rnm = real_neg_mask if real_neg_mask is not None else src_vid.new_ones((b,))
            donors_neg = neg_donors(rnm, heads)
            _, attn_neg, sal_neg = trunk(txt_neg, valid_neg, donors_neg,
                                         torch.roll(txt_table, -1, dims=0))
            out["saliency_scores_neg"] = sal_neg
            out["t2vattnvalues_neg"] = (attn_neg[:, :, nd:] * valid_neg[:, None, nd:]
                                        ).sum(2).clamp(0.0, 1.0)
            out["real_neg_mask"] = rnm
        return out


def sine_position_embedding(mask, num_pos_feats, temperature=10000.0, scale=2 * math.pi):
    """The original's 1-D sine PE over the cumulative valid count, (B, L, F)."""
    x = torch.cumsum(mask, dim=1)
    x = x / (x[:, -1:] + 1e-6) * scale
    dim_np = np.arange(num_pos_feats, dtype=np.float64)
    dim_t = torch.from_numpy(temperature ** (2 * (dim_np // 2) / num_pos_feats)).to(
        mask.device, mask.dtype)
    pos = x[:, :, None] / dim_t
    pos = torch.stack([torch.sin(pos[:, :, 0::2]), torch.cos(pos[:, :, 1::2])], dim=3)
    return pos.reshape(pos.shape[0], pos.shape[1], -1)


def tiled_donors(batch, heads, device):
    """(B, H) donor rows of the tiled mask: row (b * H + h) % B."""
    b = torch.arange(batch, device=device)[:, None]
    h = torch.arange(heads, device=device)[None, :]
    return (b * heads + h) % batch


def neg_donors(real_neg_mask, heads):
    """The negative pass's donor rows: the tiled rule over the real
    negatives' filtered indices, mapped back to batch rows."""
    m = real_neg_mask > 0
    order = torch.argsort((~m).to(torch.int8), stable=True)
    r = m.sum().clamp_min(1)
    fidx = (torch.cumsum(m.long(), dim=0) - 1).clamp_min(0)
    h = torch.arange(heads, device=real_neg_mask.device)[None, :]
    return order[(fidx[:, None] * heads + h) % r]


def pool_mask(mask, stride):
    if stride == 1:
        return mask
    b, l = mask.shape
    out_len = (l - stride) // stride + 1
    return mask[:, :out_len * stride].reshape(b, out_len, stride).amax(dim=2)


def level_sizes(length: int, strides: Sequence[int]):
    sizes = []
    for s in strides:
        if length < s:
            sizes.append(0)
            continue
        l = length
        for _ in range(int(np.log2(s))):
            l = (l - 2) // 2 + 1
        sizes.append(l)
    return sizes


def generate_points(length: int, strides: Sequence[int]) -> np.ndarray:
    """(N, 4) anchor rows (center, reg_min, reg_max, stride) of the present
    levels (the original's generator.py)."""
    ranges, last = [], 0.0
    for s in strides[1:]:
        ranges.append((last, float(s)))
        last = float(s)
    ranges.append((last, float("inf")))
    rows = []
    for s, rg, size in zip(strides, ranges, level_sizes(length, strides)):
        if size:
            rows.append(np.stack([np.arange(size, dtype=np.float32) * s,
                                  np.full(size, rg[0], np.float32),
                                  np.full(size, rg[1], np.float32),
                                  np.full(size, float(s), np.float32)], axis=1))
    return np.concatenate(rows, axis=0)


def strict_point_mask(valid_lengths, length: int, strides):
    """(B, N) validity of each point in an unpadded run, and (B,) counts."""
    valid_lengths = np.asarray(valid_lengths)
    parts = []
    for s, size in zip(strides, level_sizes(length, strides)):
        if size == 0:
            continue
        l = valid_lengths.copy()
        for _ in range(int(np.log2(s))):
            l = np.maximum((l - 2) // 2 + 1, 0)
        l = np.where(valid_lengths >= s, l, 0)
        parts.append((np.arange(size)[None, :] < l[:, None]).astype(np.float32))
    mask = np.concatenate(parts, axis=1)
    return mask, mask.sum(axis=1).astype(np.int64)


def decode(out_class, out_coord, points, clip_length, point_valid=None, top_k=50):
    """(spans (B, K, 2) seconds, scores (B, K)) and the full (B, N)
    candidate starts, ends and scores: start = (center - off0 stride)
    clip_length, end with + off1, score = sigmoid(logit), -1 at invalid
    points; ranked by a stable descending sort."""
    center, stride = points[None, :, 0], points[None, :, 3]
    start = (center - out_coord[..., 0] * stride) * clip_length
    end = (center + out_coord[..., 1] * stride) * clip_length
    scores = torch.sigmoid(out_class[..., 0])
    if point_valid is not None:
        scores = scores.masked_fill(point_valid <= 0, -1.0)
    return start, end, scores
