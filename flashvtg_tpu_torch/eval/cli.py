"""Standalone metric CLI, a drop-in for the reference's
standalone_eval/eval.py (counterpart of flashvtg_tpu/eval/cli.py):

    python -m flashvtg_tpu_torch.eval.cli --submission_path preds.jsonl \
        --gt_path gt.jsonl --save_path metrics.json
"""

from __future__ import annotations

import argparse
import json
import os

from flashvtg_tpu_torch.eval.metrics import eval_submission
from flashvtg_tpu_torch.utils.io import load_jsonl


def main(argv=None):
    parser = argparse.ArgumentParser(description="Moments and Highlights Evaluation Script")
    parser.add_argument("--submission_path", type=str, required=True)
    parser.add_argument("--gt_path", type=str, required=True)
    parser.add_argument("--save_path", type=str, required=True)
    parser.add_argument("--not_verbose", action="store_true")
    args = parser.parse_args(argv)

    for label, path in (("--submission_path", args.submission_path),
                        ("--gt_path", args.gt_path)):
        if not os.path.exists(path):
            raise SystemExit(f"{label}: no such file: {path}")

    results = eval_submission(load_jsonl(args.submission_path), load_jsonl(args.gt_path),
                              verbose=not args.not_verbose)
    if not args.not_verbose:
        print(json.dumps(results, indent=4))
    with open(args.save_path, "w") as f:
        f.write(json.dumps(results, indent=4))


if __name__ == "__main__":
    main()
