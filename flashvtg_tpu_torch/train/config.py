"""Configuration: a slim ExperimentConfig + the per-dataset presets.

Counterpart of flashvtg_tpu/train/config.py. `ExperimentConfig` holds the
model, eval and train-step fields (data, optimizer, loss weights and
bundle); the preset table is copied whole, and `from_preset` keeps the keys
this config holds (checkpointing, early stop, the feed and the precision
dials are not ported yet).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

from flashvtg_tpu_torch.losses.criterion import LossConfig
from flashvtg_tpu_torch.models.flashvtg import ModelConfig


@dataclasses.dataclass
class ExperimentConfig:
    # dataset
    dset_name: str = "hl"
    dset_domain: Optional[str] = None
    seed: int = 2024
    train_path: str = ""
    eval_path: str = ""
    v_feat_dirs: Sequence[str] = ()
    t_feat_dir: str = ""
    v_feat_dim: int = 0
    t_feat_dim: int = 0
    q_feat_type: str = "last_hidden_state"
    ctx_mode: str = "video_tef"
    data_ratio: float = 1.0
    no_norm_vfeat: bool = False
    no_norm_tfeat: bool = False
    txt_drop_ratio: float = 0.0

    # lengths / batching
    max_q_l: int = 32
    max_v_l: int = 75
    clip_length: float = 2.0
    max_windows: int = 5
    bsz: int = 32
    eval_bsz: int = 32
    v_buckets: Sequence[int] = (75, 128, 256, 512, 1024, 2048, 4096)
    bucket_eval: bool = False

    # model architecture
    kernel_size: int = 3
    num_conv_layers: int = 3
    num_mlp_layers: int = 3
    enc_layers: int = 3
    t2v_layers: int = 2
    dummy_layers: int = 2
    dim_feedforward: int = 1024
    hidden_dim: int = 256
    input_dropout: float = 0.5
    dropout: float = 0.1
    use_txt_pos: bool = False
    nheads: int = 8
    num_dummies: int = 0
    n_input_proj: int = 2
    use_neg: bool = False
    strides: Tuple[int, ...] = (1, 2, 4, 8)
    max_num_moment: int = 50
    attn_chunk: int = 512
    variant: str = "core"  # "ms" is not ported yet

    # optimizer (AdamW, StepLR every lr_drop epochs, global-norm clipping)
    lr: float = 5e-4
    lr_drop: int = 400
    lr_gamma: float = 0.5
    wd: float = 1e-4
    n_epoch: int = 700
    grad_clip: float = 0.1

    # losses
    loss_cls: Optional[str] = "focal"
    loss_reg: Optional[str] = "l1"
    loss_sal: Optional[str] = "nce"
    nce_direction: Tuple[str, ...] = ("row", "col")
    loss_qfl: bool = False
    saliency_margin: float = 0.2
    sample_radius: float = 1.5
    lw_reg: float = 0.2
    lw_cls: float = 1.0
    lw_sal: float = 0.1
    lw_saliency: float = 0.1
    lw_wattn: float = 1.0
    label_loss_coef: float = 4.0

    # post-processing
    nms_thd: float = -1.0
    nms_type: str = "normal"
    eval_precision: str = "float32"  # the only precision of this port so far

    @property
    def use_tef(self) -> bool:
        return "tef" in self.ctx_mode

    @property
    def total_v_feat_dim(self) -> int:
        return self.v_feat_dim + (2 if self.use_tef else 0)

    def model_config(self) -> ModelConfig:
        return ModelConfig(
            vid_dim=self.total_v_feat_dim,
            txt_dim=self.t_feat_dim,
            hidden_dim=self.hidden_dim,
            nheads=self.nheads,
            enc_layers=self.enc_layers,
            t2v_layers=self.t2v_layers,
            dummy_layers=self.dummy_layers,
            num_dummies=self.num_dummies,
            dim_feedforward=self.dim_feedforward,
            dropout=self.dropout,
            input_dropout=self.input_dropout,
            n_input_proj=self.n_input_proj,
            use_txt_pos=self.use_txt_pos,
            max_q_l=self.max_q_l if self.max_q_l > 0 else 100,
            strides=tuple(self.strides),
            kernel_size=self.kernel_size,
            num_conv_layers=self.num_conv_layers,
            num_mlp_layers=self.num_mlp_layers,
            max_num_moment=self.max_num_moment,
            clip_length=self.clip_length,
            use_neg=self.use_neg,
            attn_chunk=self.attn_chunk,
        )

    def loss_config(self) -> LossConfig:
        return LossConfig(
            label_loss_coef=self.label_loss_coef,
            lw_saliency=self.lw_saliency,
            lw_reg=self.lw_reg,
            lw_cls=self.lw_cls,
            lw_sal=self.lw_sal,
            lw_wattn=self.lw_wattn,
            saliency_margin=self.saliency_margin,
            sample_radius=self.sample_radius,
            loss_cls=self.loss_cls,
            loss_reg=self.loss_reg,
            loss_sal=self.loss_sal,
            nce_direction=tuple(self.nce_direction),
            loss_qfl=self.loss_qfl,
            clip_length=self.clip_length,
            dset_name=self.dset_name,
        )

    def replace(self, **kw) -> "ExperimentConfig":
        return dataclasses.replace(self, **kw)


_HD_LOSSES = dict(
    strides=(1,), buffer_size=2048, loss_cls="dynamic_bce", loss_reg=None,
    loss_sal="nce", nce_direction=("row",),
)

PRESETS = {
    # scripts/train_qv_slowclip.sh (QVHighlights, InternVideo2 video 768 +
    # InternVideo2 text 4096, data/MR.py)
    "qvhighlights": dict(
        dset_name="hl", v_feat_dim=768, t_feat_dim=4096, bsz=64,
        max_v_l=75, max_q_l=40, eval_epoch=1, wd=1e-4, eval_bsz=256,
        enc_layers=3, t2v_layers=6, dummy_layers=2, num_dummies=10,
        kernel_size=5, num_conv_layers=1, num_mlp_layers=5,
        lw_reg=1.0, lw_cls=5.0, lw_sal=0.1, lw_saliency=0.8,
        label_loss_coef=4.0, n_epoch=150, lr_drop=400, nms_thd=0.7,
        use_neg=True, clip_length=2.0,
        train_path="data/highlight_train_release.jsonl",
        eval_path="data/highlight_val_release.jsonl",
    ),
    # classic SlowFast+CLIP QVHighlights feature set: video 2304+512, text
    # CLIP 512 — the flagship configuration
    "qvhighlights_slowclip": dict(
        dset_name="hl", v_feat_dim=2816, t_feat_dim=512, bsz=64,
        max_v_l=75, max_q_l=32, eval_epoch=1, wd=1e-4, eval_bsz=256,
        enc_layers=3, t2v_layers=6, dummy_layers=2, num_dummies=10,
        kernel_size=5, num_conv_layers=1, num_mlp_layers=5,
        lw_reg=1.0, lw_cls=5.0, lw_sal=0.1, lw_saliency=0.8,
        label_loss_coef=4.0, n_epoch=150, lr_drop=400, nms_thd=0.7,
        use_neg=True, clip_length=2.0,
        train_path="data/highlight_train_release.jsonl",
        eval_path="data/highlight_val_release.jsonl",
    ),
    # scripts/qv_internvideo2/train.sh (data/MR_16.py: strides to 16)
    "qv_internvideo2": dict(
        dset_name="qv_internvideo2", v_feat_dim=768, t_feat_dim=4096,
        bsz=64, max_v_l=75, max_q_l=40, eval_epoch=1, wd=1e-4, eval_bsz=256,
        enc_layers=3, t2v_layers=6, dummy_layers=2, num_dummies=40,
        kernel_size=5, num_conv_layers=1, num_mlp_layers=5,
        strides=(1, 2, 4, 8, 16),
        lw_reg=1.0, lw_cls=5.0, lw_sal=0.1, lw_saliency=0.8,
        label_loss_coef=0.0, n_epoch=150, nms_thd=0.7, use_neg=True,
        clip_length=2.0,
        train_path="data/highlight_train_release_IV2.jsonl",
        eval_path="data/highlight_val_release.jsonl",
    ),
    # scripts/charades_sta/train.sh (InternVideo2-like features, clip 1s)
    "charades": dict(
        dset_name="charadesSTA", v_feat_dim=768, t_feat_dim=4096, bsz=128,
        max_v_l=256, max_q_l=32, eval_epoch=1, eval_bsz=128,
        enc_layers=3, t2v_layers=6, dummy_layers=2, num_dummies=40,
        kernel_size=5, num_conv_layers=1, num_mlp_layers=5,
        lw_reg=1.0, lw_cls=5.0, lw_sal=0.01, lw_saliency=0.8,
        label_loss_coef=0.1, n_epoch=50, nms_thd=0.7, use_neg=True,
        clip_length=1.0, lr=2.5e-4,
        train_path="data/charades_sta/charades_sta_train_tvr_format.jsonl",
        eval_path="data/charades_sta/charades_sta_test_tvr_format.jsonl",
    ),
    # scripts/charades_sta/train_vgg.sh (VGG 4096 + GloVe 300, clip 1/6 s)
    "charades_vgg": dict(
        dset_name="charadesSTA", v_feat_dim=4096, t_feat_dim=300, bsz=16,
        max_v_l=2048, max_q_l=32, eval_epoch=1, eval_bsz=16,
        enc_layers=3, t2v_layers=6, dummy_layers=2, num_dummies=40,
        kernel_size=3, num_conv_layers=2, num_mlp_layers=5,
        lw_reg=1.0, lw_cls=5.0, lw_sal=0.01, lw_saliency=0.8,
        label_loss_coef=0.1, n_epoch=100, nms_thd=0.7, use_neg=True,
        clip_length=0.166666, lr=1e-4, q_feat_type="features",
        train_path="data/charades_sta/charades_sta_train_tvr_format.jsonl",
        eval_path="data/charades_sta/charades_sta_test_tvr_format.jsonl",
    ),
    # scripts/charades_sta_internvideo2/train.sh
    "charades_internvideo2": dict(
        dset_name="charadesSTA_internvideo2", v_feat_dim=768, t_feat_dim=4096,
        bsz=32, max_v_l=256, max_q_l=23, eval_epoch=1, eval_bsz=128,
        enc_layers=3, t2v_layers=6, dummy_layers=2, num_dummies=40,
        kernel_size=7, num_conv_layers=2, num_mlp_layers=3,
        lw_reg=1.0, lw_cls=5.0, lw_sal=0.01, lw_saliency=0.8,
        label_loss_coef=0.1, n_epoch=50, lr_drop=50, nms_thd=0.7,
        use_neg=True, clip_length=1.0, lr=1.5e-4,
        train_path="data/charades_sta/charades_sta_train_tvr_format.jsonl",
        eval_path="data/charades_sta/charades_sta_test_tvr_format.jsonl",
    ),
    # scripts/tacos/train.sh
    "tacos": dict(
        dset_name="tacos", v_feat_dim=768, t_feat_dim=4096, bsz=32,
        max_v_l=2048, max_q_l=40, eval_epoch=3, eval_bsz=8,
        enc_layers=3, t2v_layers=8, dummy_layers=3, num_dummies=35,
        kernel_size=5, num_conv_layers=2, num_mlp_layers=5,
        lw_reg=1.0, lw_cls=5.0, lw_sal=0.05, lw_saliency=0.8,
        label_loss_coef=4.0, n_epoch=150, nms_thd=0.7, use_neg=True,
        clip_length=2.0, lr=2e-4,
        train_path="data/tacos/train.jsonl", eval_path="data/tacos/val.jsonl",
    ),
    # scripts/tvsum/train.sh (HD task, data/HD.py)
    "tvsum": dict(
        dset_name="tvsum", v_feat_dim=2816, t_feat_dim=512, bsz=4,
        max_v_l=1000, max_q_l=32, eval_epoch=1, eval_bsz=4,
        enc_layers=3, t2v_layers=2, dummy_layers=2, num_dummies=3,
        kernel_size=5, num_conv_layers=2, num_mlp_layers=3,
        lw_cls=5.0, lw_sal=0.1, lw_saliency=0.8, label_loss_coef=4.0,
        n_epoch=600, lr_drop=3000, max_es_cnt=-1, lr=1e-3, wd=0.05,
        dropout=0.1, use_neg=True, clip_length=2.0,
        train_path="data/tvsum/tvsum_train.jsonl",
        eval_path="data/tvsum/tvsum_val.jsonl",
        **_HD_LOSSES,
    ),
    # FlashVTG_ms multi-scale variant on the HD tasks
    "tvsum_ms": dict(
        dset_name="tvsum", variant="ms", v_feat_dim=2816, t_feat_dim=512,
        bsz=4, max_v_l=1000, max_q_l=32, eval_epoch=1, eval_bsz=4,
        enc_layers=3, t2v_layers=2, dummy_layers=2, num_dummies=3,
        kernel_size=5, num_conv_layers=2, num_mlp_layers=3,
        lw_cls=5.0, lw_sal=0.1, lw_saliency=0.8, label_loss_coef=4.0,
        n_epoch=600, lr_drop=3000, max_es_cnt=-1, lr=1e-3, wd=0.05,
        use_neg=True, clip_length=2.0,
        num_phrase=3, phrase_layers=2, context_layers=2, rank=32, t_sa=2,
        train_path="data/tvsum/tvsum_train.jsonl",
        eval_path="data/tvsum/tvsum_val.jsonl",
        **_HD_LOSSES,
    ),
    # FlashVTG_ms on YouTube-HL
    "youtube_uni_ms": dict(
        dset_name="youtube_uni", variant="ms", v_feat_dim=2816,
        t_feat_dim=512, bsz=4, max_v_l=1000, max_q_l=32, eval_epoch=1,
        eval_bsz=4, enc_layers=3, t2v_layers=2, dummy_layers=2,
        num_dummies=3, kernel_size=5, num_conv_layers=2, num_mlp_layers=3,
        lw_cls=0.6, lw_sal=0.5, lw_saliency=0.7, label_loss_coef=5.0,
        n_epoch=5, lr_drop=2000, max_es_cnt=-1, lr=2e-4, clip_length=1.0,
        use_neg=True,
        num_phrase=3, phrase_layers=2, context_layers=2, rank=32, t_sa=2,
        train_path="data/youtube_uni/youtube_train.jsonl",
        eval_path="data/youtube_uni/youtube_valid.jsonl",
        **_HD_LOSSES,
    ),
    # scripts/youtube_uni/train.sh (HD task)
    "youtube_uni": dict(
        dset_name="youtube_uni", v_feat_dim=2816, t_feat_dim=512, bsz=4,
        max_v_l=1000, max_q_l=32, eval_epoch=1, eval_bsz=4,
        enc_layers=3, t2v_layers=2, dummy_layers=2, num_dummies=3,
        kernel_size=5, num_conv_layers=2, num_mlp_layers=3,
        lw_cls=0.6, lw_sal=0.5, lw_saliency=0.7, label_loss_coef=5.0,
        n_epoch=5, lr_drop=2000, max_es_cnt=-1, lr=2e-4, clip_length=1.0,
        use_neg=True,
        train_path="data/youtube_uni/youtube_train.jsonl",
        eval_path="data/youtube_uni/youtube_valid.jsonl",
        **_HD_LOSSES,
    ),
}

_FIELDS = frozenset(f.name for f in dataclasses.fields(ExperimentConfig))


def from_preset(name: str, **overrides) -> ExperimentConfig:
    """The preset's model and eval fields, with `overrides` on top (an
    override that is not a field of this config raises TypeError)."""
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; have {sorted(PRESETS)}")
    kw = {k: v for k, v in PRESETS[name].items() if k in _FIELDS}
    kw.update(overrides)
    return ExperimentConfig(**kw)
