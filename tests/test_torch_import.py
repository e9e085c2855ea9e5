"""The port imports torch and numpy only: never jax, flax, triton or the JAX
package, and neither does chip_smoke.py."""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch_threads  # noqa: F401  (torch's share of the cores under xdist)

REPO = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "flax", "optax", "triton", "flashvtg_tpu")


def _sources():
    files = sorted((REPO / "flashvtg_tpu_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py"]


def test_import_with_jax_flax_triton_blocked():
    code = (
        "import sys\n"
        "for m in ('jax', 'flax', 'triton', 'optax', 'flashvtg_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import flashvtg_tpu_torch\n"
        "import flashvtg_tpu_torch.train.infer, flashvtg_tpu_torch.eval.metrics\n"
        "import flashvtg_tpu_torch.utils.convert, flashvtg_tpu_torch.kernels\n"
        "assert callable(flashvtg_tpu_torch.entry)\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert res.returncode == 0, res.stderr


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(REPO)))
def test_no_forbidden_import_statements(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            root = name.split(".")[0]
            assert root not in FORBIDDEN, f"{path}:{node.lineno} imports {name}"
