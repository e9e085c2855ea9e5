"""Experiment configuration: one dataclass, its opt.json, the presets.

Counterpart of flashvtg_tpu/train/config.py. `ExperimentConfig` has every
field of the JAX package's, under the same name, in the same order and with
the same default. So an opt.json written by either package loads in the
other, field for field (`save` / `load`, with the reference sidecar keys and the
`model_cfg.py` beside it). `check_ported` refuses unknown values of the
fields with a fixed set; the reference's dead flags are accepted and warned
about (`warn_inert_flags`), as the JAX package does.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
from typing import Optional, Sequence, Tuple

from flashvtg_tpu_torch.losses.criterion import LossConfig
from flashvtg_tpu_torch.losses.criterion_ms import MSLossConfig
from flashvtg_tpu_torch.models.flashvtg import ModelConfig
from flashvtg_tpu_torch.models.flashvtg_ms import MSModelConfig
from flashvtg_tpu_torch.utils.runtime import PRECISIONS, TRANSFER_DTYPES

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class ExperimentConfig:
    # experiment / dataset
    dset_name: str = "hl"
    dset_domain: Optional[str] = None
    exp_id: str = "exp"
    seed: int = 2024
    results_root: str = "results"
    train_path: str = ""
    eval_path: str = ""
    # second eval split, evaluated for model_best and model_latest after
    # training (FlashVTG_ms/train.py:243-286); empty = off
    test_path: str = ""
    eval_split_name: str = "val"
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
    # InternVideo2 text rows of the _ms variant: the EOS row first
    eos_first: bool = False

    # lengths / batching
    max_q_l: int = 32
    max_v_l: int = 75
    clip_length: float = 2.0
    max_windows: int = 5
    bsz: int = 32
    eval_bsz: int = 32  # the reference forces 1; the decode here is batched
    v_buckets: Sequence[int] = (75, 128, 256, 512, 1024, 2048, 4096)
    # eval batches padded to their own length bucket, longest videos first
    bucket_eval: bool = False

    # optimization (AdamW, StepLR every lr_drop epochs, global-norm clip)
    lr: float = 5e-4
    lr_drop: int = 400
    lr_gamma: float = 0.5
    wd: float = 1e-4
    n_epoch: int = 700
    max_es_cnt: int = 200
    grad_clip: float = 0.1
    eval_epoch: int = 2
    start_epoch: Optional[int] = None
    resume: Optional[str] = None
    resume_all: bool = False
    # partial (non-strict) parameter preload: only entries whose name and
    # shape match are taken (reference inference.py:447-451)
    resume_adapter: Optional[str] = None
    # fast loop: 2 steps an epoch, 1 epoch (reference config.py:32-33)
    debug: bool = False

    # model architecture
    position_embedding: str = "sine"
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
    pre_norm: bool = False
    n_input_proj: int = 2
    use_neg: bool = False

    # model-structure config (data/MR*.py dicts)
    strides: Tuple[int, ...] = (1, 2, 4, 8)
    buffer_size: int = 1024
    max_num_moment: int = 50
    loss_cls: Optional[str] = "focal"
    loss_reg: Optional[str] = "l1"
    loss_sal: Optional[str] = "nce"
    nce_direction: Tuple[str, ...] = ("row", "col")
    loss_qfl: bool = False

    # loss weights
    saliency_margin: float = 0.2
    sample_radius: float = 1.5
    lw_reg: float = 0.2
    lw_cls: float = 1.0
    lw_sal: float = 0.1
    lw_saliency: float = 0.1
    lw_wattn: float = 1.0
    label_loss_coef: float = 4.0
    eos_coef: float = 0.1

    # post-processing
    max_before_nms: int = 50
    max_after_nms: int = 10
    conf_thd: float = 0.0
    nms_thd: float = -1.0
    nms_type: str = "normal"

    # test-time flags (reference TestOptions)
    eval_untrained: bool = False  # evaluate before epoch 0 (train.py:129)
    eval_results_dir: Optional[str] = None  # where infer writes
    # accepted for reference opt.json compatibility, inert (_INERT_FLAGS)
    temperature: float = 0.07
    span_loss_type: str = "l1"  # "ce" is refused: broken in the reference
    # static shapes drop the tail batch whatever this says
    drop_last: bool = False
    no_sort_results: bool = False
    a_feat_dim: Optional[int] = None
    a_feat_dir: Optional[str] = None
    eval_id: Optional[str] = None
    model_dir: Optional[str] = None
    lw_ms_align: float = 1.0
    aux_loss: bool = True  # --no_aux_loss store_false pair
    span_loss_coef: float = 10.0
    giou_loss_coef: float = 3.0
    use_SRM: bool = False  # the reference's spelling
    total_prompts: int = 10
    num_prompts: int = 1

    # the FlashVTG_ms variant (models/flashvtg_ms.py); the fields below are
    # read by it alone
    variant: str = "core"  # core | ms
    num_phrase: int = 3
    phrase_layers: int = 2
    context_layers: int = 2
    use_dfl: bool = False
    num_bins: int = 16
    rank: int = 32
    t_sa: int = 2
    lw_phrase: float = 1.0
    use_eos: bool = False
    lw_eos: float = 1.0

    # runtime
    # the precision dials (utils/runtime.py:matmul_precision): float32 |
    # tensorfloat32 | bfloat16
    eval_precision: str = "float32"
    # `cli infer --serving`: tensorfloat32 eval unless --eval_precision is
    # given; never persisted
    serving: bool = False
    train_precision: str = "bfloat16"
    # the JAX package's dropout PRNG; the port's dropout is its own hash
    dropout_rng_impl: str = "auto"  # auto | rbg | threefry
    # the features' dtype on the host-to-card copy in training: float32 |
    # bfloat16 (half the bytes; widened on the card)
    transfer_dtype: str = "float32"
    # the device-resident feed (data/feed.py): "auto" puts a split's
    # features on the device when they fit what is left of the budget
    # (fixed max_v_l, no txt_drop), "on" whatever their size; with it the
    # train epoch runs scan_steps steps a chunk; on the card each step, fed
    # or streamed at a fixed max_v_l, is a CUDA-graph replay
    # (train/graph.py) unless scan_steps <= 1, debug or debug_nans
    device_feed: str = "auto"  # auto | on | off
    device_feed_budget_gb: float = 8.0
    scan_steps: int = 128
    # mirrored from the JAX config; the port's self-attention goes to the
    # memory-linear flash kernel past 128 keys whatever it says
    attn_chunk: int = 512
    debug_nans: bool = False  # the NaN tripwire (utils/observability.py)
    profile_dir: Optional[str] = None  # a torch.profiler trace of the first epoch
    use_tensorboard: bool = True
    use_wandb: bool = False
    wandb_project: str = "FlashVTG"

    @property
    def use_tef(self) -> bool:
        return "tef" in self.ctx_mode

    @property
    def total_v_feat_dim(self) -> int:
        return self.v_feat_dim + (2 if self.use_tef else 0)

    def model_config(self) -> ModelConfig:
        """The architecture of the configured variant (what the JAX config's
        build_model builds): a ModelConfig, or for variant "ms" an
        MSModelConfig, the core fields and the _ms ones."""
        core = ModelConfig(
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
        if self.variant != "ms":
            return core
        return MSModelConfig(
            **dataclasses.asdict(core),
            num_phrase=self.num_phrase,
            phrase_layers=self.phrase_layers,
            context_layers=self.context_layers,
            use_dfl=self.use_dfl,
            num_bins=self.num_bins,
            rank=self.rank,
            t_sa_layers=self.t_sa,
            sample_radius=self.sample_radius,
            use_eos=self.use_eos,
        )

    def loss_config(self):
        """The criterion of the configured variant: a LossConfig, or for
        variant "ms" an MSLossConfig (losses/criterion_ms.py), which reads no
        loss_cls / loss_reg / loss_sal choice."""
        shared = dict(
            label_loss_coef=self.label_loss_coef,
            lw_saliency=self.lw_saliency,
            lw_reg=self.lw_reg,
            lw_cls=self.lw_cls,
            lw_sal=self.lw_sal,
            lw_wattn=self.lw_wattn,
            saliency_margin=self.saliency_margin,
            sample_radius=self.sample_radius,
            clip_length=self.clip_length,
            dset_name=self.dset_name,
        )
        if self.variant == "ms":
            return MSLossConfig(
                **shared,
                lw_phrase=self.lw_phrase,
                use_dfl=self.use_dfl,
                num_bins=self.num_bins,
                use_eos=self.use_eos,
                lw_eos=self.lw_eos,
            )
        return LossConfig(
            **shared,
            loss_cls=self.loss_cls,
            loss_reg=self.loss_reg,
            loss_sal=self.loss_sal,
            nce_direction=tuple(self.nce_direction),
            loss_qfl=self.loss_qfl,
        )

    def check_ported(self, train: bool) -> None:
        """Raise ValueError for an unknown value of a field with a fixed
        set (the precision dials among them); `train` adds the fields the
        train loop reads. The reference's dead flags only warn."""
        self.warn_inert_flags()
        if self.span_loss_type != "l1":
            raise ValueError(
                f"span_loss_type={self.span_loss_type!r} is not supported: the "
                "reference's 'ce' path is itself broken for FlashVTG; every shipped "
                "config uses 'l1'"
            )
        if self.variant not in ("core", "ms"):
            raise ValueError(f"unknown variant {self.variant!r}; expected core | ms")
        dials = [("eval_precision", PRECISIONS)]
        if train:
            dials += [("train_precision", PRECISIONS), ("transfer_dtype", TRANSFER_DTYPES)]
        for name, allowed in dials:
            if getattr(self, name) not in allowed:
                raise ValueError(f"unknown {name} {getattr(self, name)!r}; expected one of "
                                 f"{allowed}")
        if self.device_feed not in ("auto", "on", "off"):
            raise ValueError(f"unknown device_feed {self.device_feed!r}")
        if self.dropout_rng_impl not in ("auto", "rbg", "threefry"):
            raise ValueError(f"unknown dropout_rng_impl {self.dropout_rng_impl!r}")

    # flags that exist only for reference opt.json compatibility: dead (or
    # broken) in the reference itself, so no behaviour depends on them (the
    # JAX package's list); warned about when set away from their default
    _INERT_FLAGS = {
        "pre_norm": False,
        "eos_coef": 0.1,
        "conf_thd": 0.0,
        "max_before_nms": 50,
        "temperature": 0.07,
        "no_sort_results": False,
        "a_feat_dim": None,
        "a_feat_dir": None,
        "eval_id": None,
        "model_dir": None,
        "lw_ms_align": 1.0,
        "aux_loss": True,
        "span_loss_coef": 10.0,
        "giou_loss_coef": 3.0,
        "use_SRM": False,
        "total_prompts": 10,
        "num_prompts": 1,
        # the port's own: the JAX PRNG choice has no counterpart here (the
        # attention dropout is the port's hash, csrc/attn_dropout.cuh)
        "dropout_rng_impl": "auto",
    }

    def warn_inert_flags(self) -> None:
        for name, default in self._INERT_FLAGS.items():
            current = getattr(self, name)
            if (current is not None) if default is None else (current != default):
                logger.warning(
                    "--%s is accepted for reference opt.json compatibility but is "
                    "inert in this package", name,
                )

    # opt.json round trip (the reference saves and reloads every flag)
    def save(self, path, reference_sidecar: bool = True) -> None:
        """Write opt.json. With reference_sidecar (default) it also holds the
        keys the reference's TestOptions reload reads (device, num_workers,
        results_dir, config, eval_bsz=1: its model asserts batch 1 at eval),
        and a reference-style model-config file is written beside it, so the
        directory runs under the reference's inference.py. `serving` is an
        invocation-time knob and never persists."""
        d = dataclasses.asdict(self)
        d.pop("serving", None)
        if reference_sidecar:
            run_dir = os.path.dirname(os.path.abspath(path))
            cfg_py = os.path.join(run_dir, "model_cfg.py")
            with open(cfg_py, "w") as f:
                f.write(emit_model_cfg(self))
            d.update(device=-1, num_workers=0, results_dir=run_dir, config=cfg_py,
                     eval_bsz=1)
        with open(path, "w") as f:
            json.dump(d, f, indent=2, default=list)

    @classmethod
    def load(cls, path) -> "ExperimentConfig":
        """An opt.json of either package (keys that are not fields dropped,
        `serving` never restored)."""
        with open(path) as f:
            raw = json.load(f)
        raw.pop("serving", None)
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in raw.items() if k in fields})

    def replace(self, **kw) -> "ExperimentConfig":
        return dataclasses.replace(self, **kw)


def load_model_cfg_file(path: str) -> dict:
    """The `model` dict of a reference-style python model-config file
    (data/MR*.py), executed in its own namespace; `_base_` is ignored."""
    ns: dict = {}
    with open(path) as f:
        exec(compile(f.read(), path, "exec"), {}, ns)
    return ns.get("model", {})


# reference blocks-registry class name <-> loss kind; emit_model_cfg uses
# the inverse
_LOSS_TYPE_MAP = {
    "FocalLoss": "focal",
    "DynamicBCELoss": "dynamic_bce",
    "L1Loss": "l1",
    "SampledNCELoss": "nce",
}


def apply_model_cfg(cfg: ExperimentConfig, model_dict: dict) -> ExperimentConfig:
    """Overlay a data/MR*.py-style dict onto an ExperimentConfig."""
    kw = {}
    for key in ("buffer_size", "max_num_moment"):
        if key in model_dict:
            kw[key] = model_dict[key]
    if "strides" in model_dict:
        kw["strides"] = tuple(model_dict["strides"])
    loss_cfg = model_dict.get("loss_cfg", {})
    if loss_cfg:
        for key in ("loss_cls", "loss_reg", "loss_sal"):
            entry = loss_cfg.get(key)
            kw[key] = _LOSS_TYPE_MAP.get(entry["type"]) if entry else None
        sal = loss_cfg.get("loss_sal")
        if sal and "direction" in sal:
            d = sal["direction"]
            kw["nce_direction"] = (d,) if isinstance(d, str) else tuple(d)
        kw["loss_qfl"] = "loss_qfl" in loss_cfg
        if "sample_radius" in loss_cfg:
            kw["sample_radius"] = loss_cfg["sample_radius"]
    return cfg.replace(**kw)


def emit_model_cfg(cfg: ExperimentConfig) -> str:
    """Inverse of apply_model_cfg: a reference-style data/MR*.py model-config
    file for this experiment (the reference's inference.py builds its model
    from the file opt.json names), in the shipped files' shape."""
    type_map = {v: k for k, v in _LOSS_TYPE_MAP.items()}

    def entry(kind: Optional[str], extra: str = "") -> str:
        return f"dict(type='{type_map[kind]}'{extra})" if kind else "None"

    dirs = tuple(cfg.nce_direction)
    sal_extra = "" if dirs == ("row", "col") else (
        f", direction={dirs[0]!r}" if len(dirs) == 1 else f", direction={dirs!r}"
    )
    loss_lines = [
        "    loss_cfg=dict(",
        "        type='BundleLoss',",
        f"        sample_radius={cfg.sample_radius},",
    ]
    if cfg.loss_qfl:
        # data/MR_GFL.py has loss_qfl in place of loss_cls
        loss_lines.append("        loss_qfl=dict(type='QualityFocalLoss'),")
    else:
        loss_lines.append(f"        loss_cls={entry(cfg.loss_cls)},")
    loss_lines += [
        f"        loss_reg={entry(cfg.loss_reg)},",
        f"        loss_sal={entry(cfg.loss_sal, sal_extra)},",
        "    ),",
    ]
    lines = [
        "_base_ = ['blocks']",
        "model = dict(",
        f"    strides={tuple(cfg.strides)!r},",
        f"    buffer_size={cfg.buffer_size},",
        f"    max_num_moment={cfg.max_num_moment},",
        "    pyramid_cfg=dict(type='ConvPyramid'),",
        "    pooling_cfg=dict(type='AdaPooling'),",
        "    class_head_cfg=dict(type='ConvHead', kernal_size=3),",
        "    coord_head_cfg=dict(type='ConvHead', kernal_size=3),",
        *loss_lines,
        ")",
    ]
    return "\n".join(lines) + "\n"


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

def from_preset(name: str, **overrides) -> ExperimentConfig:
    """The preset's fields, with `overrides` on top (an override that is not
    a field raises TypeError)."""
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; have {sorted(PRESETS)}")
    kw = dict(PRESETS[name])
    kw.update(overrides)
    return ExperimentConfig(**kw)
