"""The port's copies of the JAX package's host modules, held against them:

  * data/glove.py: the text file, the cached (vocab.txt, vectors.npy) pair
    written by the first load, the FLASHVTG_GLOVE_PATH lookup and the error
    without vectors;
  * data/prep.py (TVSUM_SPLITS, videos_with_features, build_rows for tvsum,
    tvsum with sfc and youtube, main's files) and data/youtube_splits.py, on
    a tiny annotation json written here;
  * ops/windows.py;
  * the new modules import with jax, flax, optax, triton and the JAX
    package blocked.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch_threads  # noqa: F401  (torch's share of the cores under xdist)

from flashvtg_tpu.data import glove as jax_glove
from flashvtg_tpu.data import prep as jax_prep
from flashvtg_tpu.data.youtube_splits import YOUTUBE_SPLITS as JAX_YOUTUBE_SPLITS
from flashvtg_tpu.ops import windows as jax_windows
from flashvtg_tpu_torch.data import glove, prep
from flashvtg_tpu_torch.data.dataset import TVSUM_DOMAINS
from flashvtg_tpu_torch.data.youtube_splits import YOUTUBE_SPLITS
from flashvtg_tpu_torch.ops import windows
from flashvtg_tpu_torch.utils.io import load_jsonl

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _glove_file(path):
    rng = np.random.default_rng(0)
    words = ["person", "opens", "the", "door", "café"]
    with open(path, "w", encoding="utf-8") as f:
        for w in words:
            f.write(w + " " + " ".join(f"{x:.5f}" for x in rng.standard_normal(6)) + "\n")
    return words


@pytest.mark.parametrize("form", ["text", "cached"])
def test_glove_matches_jax(tmp_path, form):
    path = str(tmp_path / "glove.6B.300d.txt")
    words = _glove_file(path)
    if form == "cached":  # the first load writes the pair the second reads
        jax_glove.GloveEmbedder.from_text_file(path)
        assert os.path.exists(path + ".vectors.npy") and os.path.exists(path + ".vocab.txt")
    got = glove.GloveEmbedder.from_text_file(path)
    want = jax_glove.GloveEmbedder.from_text_file(path)
    assert got.stoi == want.stoi == {w: i for i, w in enumerate(words)}
    np.testing.assert_array_equal(got.vectors, want.vectors)
    for query in ("Person opens THE door", "café unknownword door", ""):
        np.testing.assert_array_equal(got(query), want(query))
    assert not got("unknownword").any() and got("DOOR").shape == (1, 6)


def test_glove_default_path_and_missing(tmp_path, monkeypatch):
    path = str(tmp_path / "glove.txt")
    _glove_file(path)
    monkeypatch.setenv("FLASHVTG_GLOVE_PATH", path)
    np.testing.assert_array_equal(glove.GloveEmbedder.default()("the door"),
                                  jax_glove.GloveEmbedder.default()("the door"))
    monkeypatch.setenv("FLASHVTG_GLOVE_PATH", str(tmp_path / "absent.txt"))
    # no torchtext here: the fallback import fails, and both raise alike
    monkeypatch.setitem(sys.modules, "torchtext", None)
    with pytest.raises(RuntimeError, match="FLASHVTG_GLOVE_PATH") as got:
        glove.GloveEmbedder.default()
    with pytest.raises(RuntimeError) as want:
        jax_glove.GloveEmbedder.default()
    assert str(got.value) == str(want.value)


def _annotations():
    """Raw TVSum / YouTube-HL annotation json: one train and one val video
    of a domain, a video of no split, a video without features."""
    rng = np.random.default_rng(1)
    tv_train, tv_val = prep.TVSUM_SPLITS["BK"]["train"][0], prep.TVSUM_SPLITS["BK"]["val"][0]
    tv = {}
    for vid in (tv_train, tv_val, "notinsplit", prep.TVSUM_SPLITS["GA"]["train"][1]):
        n = int(rng.integers(5, 9))
        tv[vid] = dict(frames=30.0 * 2 * n, fps=30.0, domain="GA" if vid.startswith("i3w") else "BK",
                       title=f"title of {vid}", anno=rng.integers(1, 6, (n, 20)).tolist())
    yt_train, yt_val = YOUTUBE_SPLITS["dog"]["train"][0], YOUTUBE_SPLITS["dog"]["val"][0]
    yt = {}
    for vid in (yt_train, yt_val, "notinsplit"):
        n = int(rng.integers(5, 9))
        yt[vid] = dict(frames=29.97 * n, fps=29.97, domain="dog", clip=[[0, n]],
                       match=rng.integers(0, 3, n).tolist())
    return tv, yt


def test_splits_match_jax():
    assert prep.TVSUM_SPLITS == jax_prep.TVSUM_SPLITS
    assert YOUTUBE_SPLITS == JAX_YOUTUBE_SPLITS
    assert sorted(prep.TVSUM_SPLITS) == sorted(TVSUM_DOMAINS)


@pytest.mark.parametrize("dataset,sfc", [("tvsum", False), ("tvsum", True), ("youtube", False)],
                         ids=["tvsum", "tvsum_sfc", "youtube"])
def test_build_rows_matches_jax(tmp_path, dataset, sfc):
    tv, yt = _annotations()
    anno = tv if dataset == "tvsum" else yt
    splits = prep.TVSUM_SPLITS if dataset == "tvsum" else YOUTUBE_SPLITS
    feat = tmp_path / "feats"
    for sub in ("rgb", "opt"):  # the last video has no features in one dir
        (feat / sub).mkdir(parents=True)
        for vid in list(anno)[: -1 if sub == "opt" else None]:
            (feat / sub / f"{vid}.npy").write_bytes(b"")
    available = prep.videos_with_features(str(feat))
    assert available == jax_prep.videos_with_features(str(feat)) == set(list(anno)[:-1])
    assert prep.videos_with_features(str(tmp_path / "empty")) is None
    for avail in (None, available):
        got = prep.build_rows(anno, splits, dataset, avail, sfc=sfc)
        want = jax_prep.build_rows(anno, splits, dataset, avail, sfc=sfc)
        assert got == want
    train_rows, val_rows = got
    assert len(train_rows) == 1 and len(val_rows) == 1
    row = train_rows[0]
    assert row["relevant_windows"] is None and row["qid"] == row["vid"]
    assert len(row["label"][0]) == (20 if dataset == "tvsum" and not sfc else 1)


@pytest.mark.parametrize("dataset,sfc", [("tvsum", False), ("tvsum", True), ("youtube", False)],
                         ids=["tvsum", "tvsum_sfc", "youtube"])
def test_prep_main_writes_what_jax_writes(tmp_path, dataset, sfc, capsys):
    tv, yt = _annotations()
    anno = tmp_path / "anno.json"
    anno.write_text(json.dumps(tv if dataset == "tvsum" else yt))
    outs = {}
    for name, mod in (("port", prep), ("jax", jax_prep)):
        out = tmp_path / name
        mod.main([dataset, "--anno", str(anno), "--out_dir", str(out)] + (["--sfc"] if sfc else []))
        outs[name] = {f: load_jsonl(out / f) for f in sorted(os.listdir(out))}
    assert outs["port"] == outs["jax"] and len(outs["port"]) == 2
    printed = capsys.readouterr().out.splitlines()
    assert len(printed) == 2 and printed[0] == printed[1]


def test_windows_match_jax():
    ids = [56, 57, 58, 59, 60, 61, 62, 64, 67, 68, 69, 70, 71]
    assert windows.clip_ids_to_windows(ids) == jax_windows.clip_ids_to_windows(ids) == [
        [56, 62], [64, 64], [67, 71]]
    assert windows.clip_ids_to_windows([3]) == jax_windows.clip_ids_to_windows([3])
    wins = windows.clip_ids_to_windows(ids)
    assert windows.windows_to_clip_ids(wins) == jax_windows.windows_to_clip_ids(wins) == ids
    assert windows.clip_window_to_seconds([3, 5], 2.0) == jax_windows.clip_window_to_seconds(
        [3, 5], 2.0) == [6.0, 12.0]
    scores = np.random.default_rng(2).standard_normal((9, 7))
    target = np.arange(9) % 7
    np.testing.assert_allclose(windows.accuracy_at_k(scores, target, (1, 3, 5)),
                               jax_windows.accuracy_at_k(scores, target, (1, 3, 5)))


def test_new_modules_import_without_jax_or_triton():
    code = (
        "import sys\n"
        "for m in ('jax', 'flax', 'triton', 'optax', 'flashvtg_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import flashvtg_tpu_torch.eval.hl, flashvtg_tpu_torch.data.glove\n"
        "import flashvtg_tpu_torch.data.prep, flashvtg_tpu_torch.ops.windows\n"
        "from flashvtg_tpu_torch.train.infer import run_hl_inference\n"
        "from flashvtg_tpu_torch.utils.synthetic import make_synthetic_tvsum\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
