"""The port imports torch and numpy only: never jax, flax, triton or the JAX
package, and neither does chip_smoke.py. Importing it builds nothing."""

import ast
import pathlib
import shutil
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


def test_scan_covers_the_host_runtime():
    scanned = {str(p.relative_to(REPO)) for p in _sources()}
    assert "flashvtg_tpu_torch/runtime/__init__.py" in scanned
    for src in ("featload.cpp", "mr_ap.cpp"):
        assert (REPO / "flashvtg_tpu_torch" / "runtime" / src).is_file()


def test_import_builds_nothing(tmp_path):
    """A fresh copy of the package (no _build/) imported with jax blocked:
    no compiler is started and no _build/ appears."""
    shutil.copytree(REPO / "flashvtg_tpu_torch", tmp_path / "flashvtg_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    code = (
        "import subprocess, sys\n"
        "started = []\n"
        "class Spy(subprocess.Popen):\n"
        "    def __init__(self, *a, **k):\n"
        "        started.append(a)\n"
        "        super().__init__(*a, **k)\n"
        "subprocess.Popen = Spy\n"
        "for m in ('jax', 'flax', 'triton', 'optax', 'flashvtg_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import flashvtg_tpu_torch, flashvtg_tpu_torch.runtime\n"
        "import flashvtg_tpu_torch.eval.metrics, flashvtg_tpu_torch.data.dataset\n"
        "import flashvtg_tpu_torch.data.feed, flashvtg_tpu_torch.train.infer\n"
        "assert flashvtg_tpu_torch.runtime.BUILD_DIR.startswith(sys.argv[1])\n"
        "assert not started and not flashvtg_tpu_torch.runtime._libs, started\n"
    )
    res = subprocess.run([sys.executable, "-c", code, str(tmp_path)], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert not (tmp_path / "flashvtg_tpu_torch" / "_build").exists()
