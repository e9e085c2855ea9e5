"""Fixed-shape eval batch assembly (counterpart of flashvtg_tpu/data/collate.py,
without the label branches and the negative-pair mask, which are training's)."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from flashvtg_tpu_torch.ops.pad import bucket_length, pad_batch

MODEL_KEYS = ("src_txt", "src_txt_mask", "src_vid", "src_vid_mask")


@dataclasses.dataclass
class Collator:
    max_q_l: int
    v_buckets: Sequence[int]
    fixed_v_len: Optional[int] = None  # pin the video length (single bucket)

    def __call__(self, samples: List[tuple]) -> Dict[str, object]:
        inputs = [x for _, x in samples]
        v_lens = [len(x["video_feat"]) for x in inputs]
        lv = self.fixed_v_len or bucket_length(max(v_lens), self.v_buckets)
        src_vid, vid_mask = pad_batch([x["video_feat"] for x in inputs], lv)
        src_txt, txt_mask = pad_batch([x["query_feat"] for x in inputs], self.max_q_l)
        return {
            "valid_v_lens": np.asarray([min(l, lv) for l in v_lens], np.int64),
            "vid": [x["vid"] for x in inputs],
            "qid": [x["qid"] for x in inputs],
            "meta": [m for m, _ in samples],
            "src_txt": src_txt,
            "src_txt_mask": txt_mask,
            "src_vid": src_vid,
            "src_vid_mask": vid_mask,
        }
