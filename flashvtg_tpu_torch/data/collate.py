"""Fixed-shape batch assembly (counterpart of flashvtg_tpu/data/collate.py).

Features and masks are padded to (max_q_l, video bucket) shapes; with labels
(training) the saliency labels are padded to the video length, the GT
windows to (max_windows, 2) with +inf, and every batch carries the
negative-pair indicator real_neg_mask. With pad_features off (the
device-resident feed, data/feed.py, holds the features) a batch carries no
feature or mask tensors (MODEL_KEYS), only labels and bookkeeping.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from flashvtg_tpu_torch.data.dataset import strip_vid_suffix
from flashvtg_tpu_torch.ops.pad import bucket_length, pad_batch

MODEL_KEYS = ("src_txt", "src_txt_mask", "src_vid", "src_vid_mask")
# what the train step reads: the model's inputs and the targets
TRAIN_KEYS = MODEL_KEYS + (
    "saliency_all_labels", "saliency_pos_labels", "saliency_neg_labels",
    "gt_windows", "real_neg_mask",
)


def neg_pair_base(vids: Sequence[str], dset_name: str) -> List[str]:
    """Vid identities the negative-pair mask compares (reference
    model.py:268-272): 'hl' strips the _start_end clip suffix, so clips of
    one source video are not used as negatives."""
    if dset_name in ("hl",):
        return [strip_vid_suffix(v) for v in vids]
    return list(vids)


def rolled_neg_mask(base: Sequence[str]) -> np.ndarray:
    """Rolled-by-one != own, the model's negative-pass pairing."""
    rolled = list(base[1:]) + list(base[:1])
    return np.asarray([a != b for a, b in zip(base, rolled)], np.float32)


@dataclasses.dataclass
class Collator:
    max_q_l: int
    v_buckets: Sequence[int]
    fixed_v_len: Optional[int] = None  # pin the video length (single bucket)
    max_windows: int = 5
    dset_name: str = "hl"
    pad_features: bool = True  # False: no MODEL_KEYS (the device feed has them)

    def __call__(self, samples: List[tuple]) -> Dict[str, object]:
        inputs = [x for _, x in samples]
        v_lens = [len(x["video_feat"]) for x in inputs]
        lv = self.fixed_v_len or bucket_length(max(v_lens), self.v_buckets)
        vids = [x["vid"] for x in inputs]
        batch = {
            "valid_v_lens": np.asarray([min(l, lv) for l in v_lens], np.int64),
            "vid": vids,
            "qid": [x["qid"] for x in inputs],
            "meta": [m for m, _ in samples],
            "real_neg_mask": rolled_neg_mask(neg_pair_base(vids, self.dset_name)),
        }
        if self.pad_features:
            src_vid, vid_mask = pad_batch([x["video_feat"] for x in inputs], lv)
            src_txt, txt_mask = pad_batch([x["query_feat"] for x in inputs], self.max_q_l)
            batch.update(src_txt=src_txt, src_txt_mask=txt_mask, src_vid=src_vid,
                         src_vid_mask=vid_mask)
        if "saliency_all_labels" in inputs[0]:
            batch["saliency_all_labels"] = pad_batch(
                [x["saliency_all_labels"] for x in inputs], lv
            )[0]
            for key in ("saliency_pos_labels", "saliency_neg_labels"):
                batch[key] = np.stack([x[key] for x in inputs])
        if "gt_windows" in inputs[0]:
            m = self.max_windows
            gt = np.full((len(inputs), m, 2), np.inf, np.float32)
            for i, x in enumerate(inputs):
                w = x["gt_windows"][:m]
                gt[i, : len(w)] = w
            batch["gt_windows"] = gt
        return batch
