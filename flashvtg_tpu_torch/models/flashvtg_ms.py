"""FlashVTG_ms, the phrase-aware multi-scale variant, in PyTorch: eval and
train forward, the DFL boundary decode.

Counterpart of flashvtg_tpu/models/flashvtg_ms.py (`MSModelConfig`,
`FlashVTGMSModel`, `decode_boundaries_dfl`; reference FlashVTG_ms/model.py).
Deltas from the core model (models/flashvtg.py):
  * the text splits into the sentence token (token 0) and the words, each
    with its own projection;
  * the phrase pipeline (models/lgi.py: PhraseGenerate -> PhraseContext)
    gives a context aggregate that is added to the trunk's video embedding
    and fused by a temporal self-attention stack (TSA);
  * saliency comes from SaliencyProj over the fused embedding; a class head
    only (no conf head, no blend `x`); with use_dfl the coord head gives
    num_bins logits a side, decoded by `decode_boundaries_dfl`;
  * the dummy tokens attend over the sentence token only (nd + 1 keys, all
    valid), and the ACA layers see those nd + 1 keys with no video mask and
    no donor rows, in training too.
Reference quirks the JAX module documents and this one keeps: the sentence
token used by the dummy path and the similarity channel is taken before the
token-type embedding; in train mode SaliencyProj takes the unmasked mean and
the pyramid convolves the un-zeroed padded clips (eval: masked, zeroed); the
coordinates are exp(raw) * coef in DFL mode too (the decode's softmax runs
over them); the negative pass rolls the phrase slots and the refreshed
dummy + sentence tokens by one row and runs phrase_context, the ACA layers,
the encoder and TSA again, not the dummy encoder, and its SaliencyProj
takes the unmasked mean in eval too. Under use_eos a learned query
attention-pools the context aggregate into `eos_slot`, beside `eos_emb`,
the sentence token (the producer of the EOS loss, JAX MSModelConfig).

Parameter names are the reference FlashVTG_ms's; its parameters that no
forward reads are held so that a reference `.ckpt` loads with strict=True:
transformer.fuse_proj, t_sa.layers.i.norm1, pooling.att (an AdaPooling
whose query the model takes from the sentence token instead) and
txt_position_embed.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

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
from flashvtg_tpu_torch.models.flashvtg import ModelConfig, decode_boundaries
from flashvtg_tpu_torch.models.lgi import TSA, PhraseContext, PhraseGenerate, SaliencyProj
from flashvtg_tpu_torch.models.points import generate_points, pyramid_masks_pool
from flashvtg_tpu_torch.models.transformer import Encoder, T2VEncoder


@dataclasses.dataclass(frozen=True)
class MSModelConfig(ModelConfig):
    """ModelConfig + the _ms flags (mirror of the JAX MSModelConfig)."""

    num_phrase: int = 3
    phrase_layers: int = 2
    context_layers: int = 2
    use_dfl: bool = False
    num_bins: int = 16
    rank: int = 32
    t_sa_layers: int = 2
    sample_radius: float = 1.5
    use_eos: bool = False


class MSTransformer(nn.Module):
    """The trunk's two stacks, and the reference's `fuse_proj`, which no
    forward calls."""

    def __init__(self, cfg: MSModelConfig):
        super().__init__()
        d = cfg.hidden_dim
        self.t2v_encoder = T2VEncoder(
            cfg.t2v_layers, d, cfg.nheads, cfg.num_dummies, cfg.dim_feedforward,
            cfg.dropout,
        )
        self.encoder = Encoder(
            cfg.enc_layers, d, cfg.nheads, cfg.dim_feedforward, cfg.dropout
        )
        self.fuse_proj = nn.Sequential(nn.Linear(2 * d, d), nn.LayerNorm(d, eps=1e-5))


class FlashVTGMSModel(nn.Module):
    """End-to-end FlashVTG_ms forward; the same call as FlashVTGModel's:
    src_txt (B, Lq, Dt) whose token 0 is the sentence token, src_txt_mask
    (B, Lq), src_vid (B, Lv, Dv), src_vid_mask (B, Lv), point_valid
    optional (B, N); real_neg_mask (B,) and `generator` (the attention
    kernels' dropout seeds) in train mode; `force_neg` runs the negative
    pass in eval mode too (the eval losses read it)."""

    def __init__(self, cfg: MSModelConfig):
        super().__init__()
        self.cfg = cfg
        d, nd = cfg.hidden_dim, cfg.num_dummies
        self.input_vid_proj = InputProj(cfg.vid_dim, d, cfg.n_input_proj, cfg.input_dropout)
        self.input_txt_proj = InputProj(cfg.txt_dim, d, cfg.n_input_proj, cfg.input_dropout)
        self.input_word_proj = InputProj(cfg.txt_dim, d, cfg.n_input_proj, cfg.input_dropout)
        self.token_type_embeddings = nn.Embedding(2, d)
        self.txt_position_embed = TrainablePositionalEncoding(  # unread
            cfg.max_q_l, d, cfg.input_dropout
        )
        self.dummy_rep_token = nn.Parameter(torch.randn(nd, d))
        self.dummy_rep_pos = nn.Parameter(torch.randn(nd, d))
        self.txtproj_encoder = Encoder(
            cfg.dummy_layers, d, cfg.dummy_nheads, cfg.dim_feedforward, cfg.dummy_dropout
        )
        self.transformer = MSTransformer(cfg)
        self.phrase_generate = PhraseGenerate(
            d, cfg.num_phrase, cfg.nheads, cfg.dropout, cfg.phrase_layers
        )
        self.phrase_context = PhraseContext(
            d, cfg.context_layers, cfg.nheads, cfg.dropout, cfg.rank
        )
        self.t_sa = TSA(d, cfg.nheads, cfg.dropout, cfg.t_sa_layers)
        self.saliency_proj = SaliencyProj(d)
        self.pyramid = ConvPyramid(d, cfg.strides)
        self.pooling = AdaPooling(d)  # unread
        self.class_head = ConfidenceScorer(
            d, cfg.kernel_size, cfg.num_conv_layers, cfg.num_mlp_layers
        )
        self.coord_head = ConvHead(
            d, cfg.num_bins * 2 if cfg.use_dfl else 2, cfg.coord_kernel_size
        )
        self.coef = nn.Parameter(torch.ones(len(cfg.strides)))
        if cfg.use_eos:
            self.eos_query = nn.Parameter(torch.randn(d))

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

        # sentence / word streams, each with its projection
        vid = self.input_vid_proj(src_vid)
        glob = self.input_txt_proj(src_txt[:, :1])  # before the type embedding
        txt = torch.cat([glob, self.input_word_proj(src_txt[:, 1:])], dim=1)
        vid = vid + self.token_type_embeddings.weight[1]
        txt = txt + self.token_type_embeddings.weight[0]
        pos_vid = sine_position_embedding(src_vid_mask, d)

        # the phrase pipeline
        phrase_emb, word_video_attn, gate, slot_attn = self.phrase_generate(
            txt, src_txt_mask, vid, src_vid_mask
        )
        context_agg, context_emb, context_refine = self.phrase_context(
            phrase_emb, vid, src_vid_mask
        )

        # dummy tokens refreshed over the sentence token only, every key valid
        txt_d = torch.cat([self.dummy_rep_token.expand(b, nd, d), glob], dim=1)
        pos_txt_d = torch.cat(
            [self.dummy_rep_pos.expand(b, nd, d), torch.zeros_like(glob)], dim=1
        )
        txt_d_valid = src_txt_mask.new_ones((b, nd + 1))
        refreshed = self.txtproj_encoder(txt_d, pos_txt_d, txt_d_valid, generator)
        dummy_refreshed = refreshed[:, :nd]
        txt_d = torch.cat([dummy_refreshed, glob], dim=1)

        def trunk(txt_tokens):
            fused, attn = self.transformer.t2v_encoder(
                vid, txt_tokens, pos_vid, pos_txt_d, txt_d_valid, generator=generator
            )
            return self.transformer.encoder(fused, pos_vid, src_vid_mask, generator), attn

        vid_emb, attn_weights = trunk(txt_d)

        # phrase-context fusion and temporal consistency
        src_emb = self.t_sa(context_agg + vid_emb + pos_vid, src_vid_mask)
        saliency = self.saliency_proj(src_emb, None if train else src_vid_mask)

        # pyramid and heads on the fused embedding
        pymid, _ = self.pyramid(src_emb if train else src_emb * src_vid_mask[..., None])
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
        out_coord = torch.cat(
            [
                torch.exp(self.coord_head(e, m)) * self.coef[i]
                for i, (e, m) in enumerate(zip(pymid, level_masks))
            ],
            dim=1,
        )

        # the cosine channel of the NCE loss
        vn = vid_emb / torch.linalg.vector_norm(vid_emb, dim=-1, keepdim=True).clamp_min(1e-8)
        qn = glob / torch.linalg.vector_norm(glob, dim=-1, keepdim=True).clamp_min(1e-8)

        out: Dict[str, Any] = {
            "saliency_scores": saliency,
            "t2vattnvalues": attn_weights[:, :, nd].clamp(0.0, 1.0),
            "attn_weights": attn_weights,
            "sim_score": (vn * qn).sum(-1),
            "video_msk": src_vid_mask,
            "pymid_msk": pymid_msk,
            "out_class": out_class,
            "out_coord": out_coord,
            "point": points,
            "word_video_attn": word_video_attn,
            "slot_att": slot_attn,
            "gate": gate,
            "context_agg": context_agg,
            "context_emb": context_emb,
            "context_refine": context_refine,
            "vid_emb": vid_emb,
            "dummy_tokens": dummy_refreshed,
        }

        if cfg.use_eos:
            # the video-side EOS summary: the learned query attention-pools
            # the valid clips of the context aggregate
            att = torch.einsum("d,btd->bt", self.eos_query, context_agg) / math.sqrt(d)
            att = att.masked_fill(src_vid_mask <= 0, -1e30)
            w = torch.softmax(att, dim=-1)
            out["eos_slot"] = torch.einsum("bt,btd->bd", w, context_agg)[:, None]
            out["eos_emb"] = glob

        if (train or force_neg) and cfg.use_neg:
            # rolled phrase slots drive a negative context, the rolled dummy
            # + sentence tokens a negative trunk pass
            context_agg_neg, _, _ = self.phrase_context(
                torch.roll(phrase_emb, -1, dims=0), vid, src_vid_mask
            )
            memory_neg, attn_neg = trunk(torch.roll(txt_d, -1, dims=0))
            fused_neg = self.t_sa(context_agg_neg + memory_neg + pos_vid, src_vid_mask)
            out["saliency_scores_neg"] = self.saliency_proj(fused_neg, None)
            out["t2vattnvalues_neg"] = attn_neg[:, :, nd].clamp(0.0, 1.0)
            out["real_neg_mask"] = (
                real_neg_mask if real_neg_mask is not None else src_vid.new_ones((b,))
            )
        return out

    def decode(self, out, point_valid=None, top_k: int = 50):
        """(spans, scores) of an eval forward's `out`: its distance bins
        under use_dfl (decode_boundaries_dfl), else decode_boundaries."""
        cfg = self.cfg
        if cfg.use_dfl:
            return decode_boundaries_dfl(
                out["out_class"], out["out_coord"], out["point"], cfg.clip_length,
                cfg.num_bins, cfg.sample_radius, point_valid=point_valid, top_k=top_k)
        return decode_boundaries(out["out_class"], out["out_coord"], out["point"],
                                 cfg.clip_length, point_valid=point_valid, top_k=top_k)


def decode_boundaries_dfl(
    out_class: torch.Tensor,
    out_coord: torch.Tensor,
    points: torch.Tensor,
    clip_length: float,
    num_bins: int,
    sample_radius: float,
    point_valid: Optional[torch.Tensor] = None,
    top_k: int = 50,
):
    """DFL boundary decode (reference FlashVTG_ms/model.py:268-292): each
    side's softmax over num_bins distance bins, its expectation over the bin
    centres in [0, sample_radius], then the centre / stride mapping and the
    ranking of models/flashvtg.py:decode_boundaries (stable, ties to the
    lower index, -1 at invalid points). Returns spans (B, K, 2) seconds and
    scores (B, K)."""
    centers = torch.linspace(0.0, sample_radius, num_bins, dtype=out_coord.dtype,
                             device=out_coord.device)
    start_off = (torch.softmax(out_coord[..., :num_bins], dim=-1) * centers).sum(-1)
    end_off = (torch.softmax(out_coord[..., num_bins:], dim=-1) * centers).sum(-1)
    center = points[None, :, 0]
    stride = points[None, :, 3]
    start = (center - start_off * stride) * clip_length
    end = (center + end_off * stride) * clip_length
    scores = torch.sigmoid(out_class[..., 0])
    if point_valid is not None:
        scores = scores.masked_fill(point_valid <= 0, -1.0)
    k = min(top_k, scores.shape[1])
    sorted_scores, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    top_scores, idx = sorted_scores[:, :k], idx[:, :k]
    spans = torch.gather(torch.stack([start, end], dim=-1), 1, idx[..., None].expand(-1, -1, 2))
    return spans, top_scores
