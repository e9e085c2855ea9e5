"""Source snapshot of a run: one `code.zip` of the flashvtg_tpu_torch
package in the results directory (counterpart of
flashvtg_tpu/utils/snapshot.py; the reference zips its tree into every run).
Built kernel libraries (`_build/`) and bytecode are left out."""

from __future__ import annotations

import os
import zipfile

_SKIP_DIRS = ("__pycache__", "_build")


def snapshot_code(results_dir: str) -> str:
    import flashvtg_tpu_torch

    pkg_root = os.path.dirname(os.path.abspath(flashvtg_tpu_torch.__file__))
    out_path = os.path.join(results_dir, "code.zip")
    with zipfile.ZipFile(out_path, "w", zipfile.ZIP_DEFLATED) as zf:
        for dirpath, dirnames, filenames in os.walk(pkg_root):
            dirnames[:] = [d for d in dirnames if d not in _SKIP_DIRS]
            for fn in filenames:
                if fn.endswith((".pyc", ".swp")):
                    continue
                full = os.path.join(dirpath, fn)
                zf.write(full, os.path.join("flashvtg_tpu_torch",
                                            os.path.relpath(full, pkg_root)))
    return out_path
