"""The FlashVTG network in PyTorch: eval and train forward, boundary decode.

Counterpart of flashvtg_tpu/models/flashvtg.py (`ModelConfig`,
`FlashVTGModel`, `decode_boundaries`). Module and parameter names are the
reference FlashVTG torch names (input_vid_proj.0.net.1,
transformer.t2v_encoder.layers.i.self_attn.out_proj, class_head.convs.i, x,
coef, ...), so `load_state_dict(strict=True)` takes both
`utils.convert.state_dict_from_jax` output and a reference `.ckpt`'s
`model` dict.

Train mode (model.train()) follows the JAX model's train=True branch: every
dropout and DropPath active (the dummy-token encoder at its hard-coded
`dummy_dropout`), the unmasked global mean over the padded length, no
zeroing of padded clips before the pyramid, the reference's misaligned ACA
mask through donor rows when `compat_attn_tile`, and the negative-pair pass
(text rolled by one row) with `real_neg_mask`, which adds
saliency_scores_neg, t2vattnvalues_neg and real_neg_mask to the outputs.

Under data parallelism, inside the train step's `split_batch()`
(parallel/mesh.py), the batch is this rank's rows of the global batch, and
the two couplings of its rows read the global batch, as the JAX model does
on its sharded global batch: the negative pass rolls the global batch
(`roll_rows`: a rank's last row takes the next rank's first text), and the
donor rows are computed over the global batch (its B, its real_neg_mask)
with the global batch's masks as the ACA layers' donor tables.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from flashvtg_tpu_torch.models.components import (
    AdaPooling,
    ConfidenceScorer,
    ConvHead,
    ConvPyramid,
    InputProj,
    TrainablePositionalEncoding,
    device_constant,
    sine_position_embedding,
)
from flashvtg_tpu_torch.models.points import generate_points, pyramid_masks_pool
from flashvtg_tpu_torch.models.transformer import (
    Encoder,
    T2VEncoder,
    neg_pass_donors,
    tiled_attn_donors,
)
from flashvtg_tpu_torch.parallel.mesh import batch_slice, batch_world, gather_rows, roll_rows


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Static architecture hyper-parameters (mirror of the JAX ModelConfig)."""

    vid_dim: int = 2818  # video feature dim incl. +2 TEF channels
    txt_dim: int = 512
    hidden_dim: int = 256
    nheads: int = 8
    enc_layers: int = 3
    t2v_layers: int = 2
    dummy_layers: int = 2
    num_dummies: int = 45
    dim_feedforward: int = 1024
    dropout: float = 0.1
    input_dropout: float = 0.5
    n_input_proj: int = 2
    use_txt_pos: bool = False
    max_q_l: int = 100
    strides: Tuple[int, ...] = (1, 2, 4, 8)
    kernel_size: int = 3
    coord_kernel_size: int = 3
    num_conv_layers: int = 3
    num_mlp_layers: int = 3
    # the reference hardcodes the dummy-token encoder's dropout (0.1) and
    # head count (8) independently of --dropout/--nheads
    dummy_dropout: float = 0.1
    dummy_nheads: int = 8
    compat_attn_tile: bool = True  # the donor-row mask; train only
    max_num_moment: int = 50
    clip_length: float = 2.0
    use_neg: bool = True
    merge_cls_sal: bool = True
    # mirrored from the JAX config, where self-attention is query-chunked
    # past this length; the port does not read it: its self-attention goes
    # to the memory-linear flash kernel past 128 keys (models/transformer.py)
    attn_chunk: int = 512


class Transformer(nn.Module):
    """Holder of the two trunk stacks, named as in the reference."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        d = cfg.hidden_dim
        self.t2v_encoder = T2VEncoder(
            cfg.t2v_layers, d, cfg.nheads, cfg.num_dummies, cfg.dim_feedforward,
            cfg.dropout,
        )
        self.encoder = Encoder(
            cfg.enc_layers, d, cfg.nheads, cfg.dim_feedforward, cfg.dropout
        )


class FlashVTGModel(nn.Module):
    """End-to-end FlashVTG forward.

    Inputs (masks use 1 = valid): src_txt (B, Lq, Dt), src_txt_mask (B, Lq),
    src_vid (B, Lv, Dv), src_vid_mask (B, Lv), point_valid optional (B, N);
    in train mode real_neg_mask optional (B,) ("the rolled video differs",
    all ones when None) and `generator`, the source of the attention-dropout
    seeds. `force_neg` runs the negative-pair pass in eval mode too (the
    eval losses read it).
    """

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        d, nd = cfg.hidden_dim, cfg.num_dummies
        self.input_vid_proj = InputProj(
            cfg.vid_dim, d, cfg.n_input_proj, cfg.input_dropout
        )
        self.input_txt_proj = InputProj(
            cfg.txt_dim, d, cfg.n_input_proj, cfg.input_dropout
        )
        self.token_type_embeddings = nn.Embedding(2, d)
        # always present in the reference state_dict; live under use_txt_pos
        self.txt_position_embed = TrainablePositionalEncoding(
            cfg.max_q_l, d, cfg.input_dropout
        )
        self.dummy_rep_token = nn.Parameter(torch.randn(nd, d))
        self.dummy_rep_pos = nn.Parameter(torch.randn(nd, d))
        self.txtproj_encoder = Encoder(
            cfg.dummy_layers, d, cfg.dummy_nheads, cfg.dim_feedforward,
            cfg.dummy_dropout,
        )
        self.transformer = Transformer(cfg)
        self.saliency_proj1 = nn.Linear(d, d)
        self.saliency_proj2 = nn.Linear(d, d)
        self.pyramid = ConvPyramid(d, cfg.strides)
        self.pooling = AdaPooling(d)
        self.class_head = ConfidenceScorer(
            d, cfg.kernel_size, cfg.num_conv_layers, cfg.num_mlp_layers
        )
        self.conf_head = ConfidenceScorer(
            d, cfg.kernel_size, cfg.num_conv_layers, cfg.num_mlp_layers
        )
        self.coord_head = ConvHead(d, 2, cfg.coord_kernel_size)
        self.coef = nn.Parameter(torch.ones(len(cfg.strides)))
        self.x = nn.Parameter(torch.tensor(0.5))

    def forward(
        self,
        src_txt: torch.Tensor,
        src_txt_mask: torch.Tensor,
        src_vid: torch.Tensor,
        src_vid_mask: torch.Tensor,
        point_valid: Optional[torch.Tensor] = None,
        real_neg_mask: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        force_neg: bool = False,
    ) -> Dict[str, Any]:
        cfg = self.cfg
        train = self.training
        b, lv = src_vid.shape[:2]
        d, nd = cfg.hidden_dim, cfg.num_dummies

        vid = self.input_vid_proj(src_vid) + self.token_type_embeddings.weight[1]
        txt = self.input_txt_proj(src_txt) + self.token_type_embeddings.weight[0]

        pos_vid = sine_position_embedding(src_vid_mask, d)
        if cfg.use_txt_pos:
            # quirk kept: the learned text PE returns LN(x + pos), a full
            # re-embedding of the text, used as the position tensor
            pos_txt = self.txt_position_embed(txt)
        else:
            pos_txt = torch.zeros_like(txt)

        # dummy tokens refreshed by a text self-attention encoder
        txt_d = torch.cat([self.dummy_rep_token.expand(b, nd, d), txt], dim=1)
        pos_txt_d = torch.cat([self.dummy_rep_pos.expand(b, nd, d), pos_txt], dim=1)
        txt_d_valid = torch.cat(
            [src_txt_mask.new_ones((b, nd)), src_txt_mask], dim=1
        )
        refreshed = self.txtproj_encoder(txt_d, pos_txt_d, txt_d_valid, generator)
        dummy_refreshed = refreshed[:, :nd]
        txt_d = torch.cat([dummy_refreshed, txt], dim=1)

        def trunk(txt_tokens, txt_valid, donor_rows=None, txt_valid_table=None):
            fused, attn = self.transformer.t2v_encoder(
                vid, txt_tokens, pos_vid, pos_txt_d, txt_valid,
                vid_valid_table, donor_rows, generator, txt_valid_table,
            )
            emb = self.transformer.encoder(fused, pos_vid, src_vid_mask, generator)
            if train:
                # the reference's unmasked mean over the padded length
                global_emb = emb.mean(dim=1)
            else:
                # eval: masked mean over the valid clips
                denom = src_vid_mask.sum(dim=1, keepdim=True).clamp_min(1.0)
                global_emb = (emb * src_vid_mask[..., None]).sum(dim=1) / denom
            sal = (
                self.saliency_proj1(emb) * self.saliency_proj2(global_emb)[:, None, :]
            ).sum(-1) / math.sqrt(float(d))
            return emb, attn, sal

        # the donor rows over the global batch (this rank's rows of them),
        # the donor tables its masks; in one process the batch's own
        compat_tile = train and cfg.compat_attn_tile
        own = batch_slice(b)
        donors = vid_valid_table = txt_valid_table = None
        if compat_tile:
            donors = tiled_attn_donors(b * batch_world(), cfg.nheads, src_vid.device)[own]
            vid_valid_table = gather_rows(src_vid_mask)
            txt_valid_table = gather_rows(txt_d_valid)
        video_emb, attn_weights, saliency = trunk(txt_d, txt_d_valid, donors, txt_valid_table)

        if not train:
            # eval zeroes padded clips: the reference runs bsz=1 unpadded, so
            # its convs see zeros past the true length; training keeps them
            video_emb = video_emb * src_vid_mask[..., None]
        pymid, video_emb = self.pyramid(video_emb)
        pymid_msk = pyramid_masks_pool(src_vid_mask, cfg.strides)
        points = device_constant(("points", lv, tuple(cfg.strides)), src_vid.device,
                                 lambda: generate_points(lv, cfg.strides))
        level_masks = [None] * len(pymid)
        if point_valid is not None:
            masked, level_masks, off = [], [], 0
            for e in pymid:
                n = e.shape[1]
                m = point_valid[:, off : off + n]
                masked.append(e * m[..., None])
                level_masks.append(m)
                off += n
            pymid = masked

        out_class = torch.cat(
            [self.class_head(e, m) for e, m in zip(pymid, level_masks)], dim=1
        )
        cat = torch.cat(pymid, dim=1)
        if point_valid is not None:
            # conf head convolves across the concatenated pyramid: compact
            # the valid rows to the front (level order kept), convolve,
            # scatter back, so level-boundary rows see what the reference's
            # unpadded run sees. Valid row i -> slot (#valid before i),
            # invalid row -> slot (#valid + #invalid before i).
            valid = point_valid > 0
            nv = valid.sum(dim=1, keepdim=True)
            inv = torch.where(
                valid, valid.cumsum(dim=1) - 1, nv + (~valid).cumsum(dim=1) - 1
            )
            comp = torch.zeros_like(cat).scatter_(
                1, inv[..., None].expand_as(cat), cat
            )
            comp_msk = (
                torch.arange(cat.shape[1], device=cat.device)[None, :] < nv
            ).to(point_valid.dtype)
            out_conf = torch.gather(self.conf_head(comp, comp_msk), 1, inv[..., None])
        else:
            out_conf = self.conf_head(cat, None)
        out_class = self.x * out_class + (1.0 - self.x) * out_conf  # (B, N, 1)

        out_coord = torch.cat(
            [
                torch.exp(self.coord_head(e, m)) * self.coef[i]
                for i, (e, m) in enumerate(zip(pymid, level_masks))
            ],
            dim=1,
        )  # (B, N, 2)

        query_emb = self.pooling(txt, src_txt_mask)

        t2vattn = (attn_weights[:, :, nd:] * src_txt_mask[:, None, :]).sum(2)
        t2vattn = t2vattn.clamp(0.0, 1.0)

        out = {
            "saliency_scores": saliency,
            "t2vattnvalues": t2vattn,
            "attn_weights": attn_weights,
            "video_emb": video_emb,
            "query_emb": query_emb,
            "video_msk": src_vid_mask,
            "pymid_msk": pymid_msk,
            "out_class": out_class,
            "out_coord": out_coord,
            "point": points,
            "dummy_tokens": dummy_refreshed,
        }

        if (train or force_neg) and cfg.use_neg:
            # negative-pair pass: each video against the next row's text (at
            # eval too with force_neg, for the eval losses: the reference's
            # use_neg branch is not train-gated)
            txt_d_neg = roll_rows(txt_d, -1)
            txt_d_valid_neg = roll_rows(txt_d_valid, -1)
            rnm = real_neg_mask if real_neg_mask is not None else src_vid.new_ones((b,))
            donors_neg = table_neg = None
            if compat_tile:
                donors_neg = neg_pass_donors(gather_rows(rnm), cfg.nheads)[own]
                table_neg = torch.roll(txt_valid_table, -1, dims=0)
            _, attn_neg, sal_neg = trunk(txt_d_neg, txt_d_valid_neg, donors_neg, table_neg)
            t2vattn_neg = (attn_neg[:, :, nd:] * txt_d_valid_neg[:, None, nd:]).sum(2)
            out["saliency_scores_neg"] = sal_neg
            out["t2vattnvalues_neg"] = t2vattn_neg.clamp(0.0, 1.0)
            out["real_neg_mask"] = rnm
        return out

    def decode(self, out, point_valid=None, top_k: int = 50):
        """(spans, scores) of an eval forward's `out`: decode_boundaries."""
        return decode_boundaries(out["out_class"], out["out_coord"], out["point"],
                                 self.cfg.clip_length, point_valid=point_valid, top_k=top_k)


def decode_boundaries(
    out_class: torch.Tensor,
    out_coord: torch.Tensor,
    points: torch.Tensor,
    clip_length: float,
    point_valid: Optional[torch.Tensor] = None,
    top_k: int = 50,
):
    """Boundary decode + confidence ranking (reference model.py:247-266).

    start = (center - off0 * stride) * clip_length, end likewise with +off1;
    score = sigmoid(logit), -1 at invalid points. Ranking is a stable
    descending sort, so ties (every invalid point scores -1) go to the lower
    index, as jax.lax.top_k breaks them.

    Returns spans (B, K, 2) seconds and scores (B, K).
    """
    center = points[None, :, 0]
    stride = points[None, :, 3]
    start = (center - out_coord[..., 0] * stride) * clip_length
    end = (center + out_coord[..., 1] * stride) * clip_length
    scores = torch.sigmoid(out_class[..., 0])
    if point_valid is not None:
        scores = scores.masked_fill(point_valid <= 0, -1.0)
    k = min(top_k, scores.shape[1])
    sorted_scores, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    top_scores, idx = sorted_scores[:, :k], idx[:, :k]
    both = torch.stack([start, end], dim=-1)
    spans = torch.gather(both, 1, idx[..., None].expand(-1, -1, 2))
    return spans, top_scores
