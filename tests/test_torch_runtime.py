"""The port's host runtime (flashvtg_tpu_torch/runtime: featload.cpp,
mr_ap.cpp) against the JAX package's native runtime (flashvtg_tpu.runtime)
and against the port's plain numpy functions, on the CPU.

Every comparison is bit for bit: mr_ap_batch's AP matrix and `handled`
(the fuzz, tie-heavy, degenerate and zero-length cases of
tests/test_native_mrap.py, and queries past the kernel's limits, which both
runtimes decline alike), hl_ap_batch (NaN scores included), load_features
on every layout fl_load reads and the ones it declines, the metric suite on
a seeded submission of 1,550 queries (QVHighlights val's size), and the
VTGDataset rows. The counts of rows handled natively and declined show that
the native path ran. A build that cannot find its compiler, or that fails,
raises. chip_smoke.py's phase 18 (the host runtime) rehearses here.
"""

import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch_threads  # noqa: F401  (torch's share of the cores under xdist)
import torch

from flashvtg_tpu import runtime as jax_runtime
from flashvtg_tpu.data.dataset import DataConfig as JaxDataConfig
from flashvtg_tpu.data.dataset import VTGDataset as JaxDataset
from flashvtg_tpu.eval.metrics import eval_submission as jax_eval
from flashvtg_tpu_torch import runtime
from flashvtg_tpu_torch.data.dataset import DataConfig, VTGDataset
from flashvtg_tpu_torch.eval import metrics as M
from flashvtg_tpu_torch.utils.synthetic import make_synthetic_qvh, make_synthetic_submission

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# mr_ap_batch
# ---------------------------------------------------------------------------

def _quantized_case(rng, n_queries, max_p=12, max_g=18):
    """Window edges on 0.5 s and scores to one decimal: IoU and score ties
    are common; G from 0 to max_g, P from 0 to max_p, duplicated GTs."""
    preds, gts = [], []
    for _ in range(n_queries):
        p = int(rng.integers(0, max_p + 1))
        g = int(rng.integers(0, max_g + 1))
        starts = rng.integers(0, 280, p) * 0.5
        lens = rng.integers(1, 80, p) * 0.5
        scores = np.round(rng.random(p), 1)
        preds.append(np.stack([starts, starts + lens, scores], 1) if p else np.zeros((0, 3)))
        gs = rng.integers(0, 280, g) * 0.5
        gl = rng.integers(1, 80, g) * 0.5
        gt = np.stack([gs, gs + gl], 1) if g else np.zeros((0, 2))
        if g >= 2 and rng.random() < 0.5:
            gt[int(rng.integers(0, g))] = gt[int(rng.integers(0, g))]
        gts.append(gt)
    return preds, gts


def _continuous_case(rng, n_queries, max_p=12, max_g=15):
    """Unquantized windows with zero-length predictions and GTs, some
    zero-length predictions exactly on a zero-length GT (IoU 0/0 = NaN)."""
    preds, gts = [], []
    for _ in range(n_queries):
        p = int(rng.integers(1, max_p + 1))
        g = int(rng.integers(1, max_g + 1))
        starts = rng.random(p) * 140.0
        lens = rng.random(p) * 40.0
        if rng.random() < 0.5:
            lens[rng.integers(0, p)] = 0.0
        scores = rng.random(p)
        pred = np.stack([starts, starts + lens, scores], 1)
        gs = rng.random(g) * 140.0
        gl = rng.random(g) * 40.0
        if rng.random() < 0.5:
            gl[rng.integers(0, g)] = 0.0
        if rng.random() < 0.2:
            z = rng.random() * 140.0
            pred[0] = [z, z, scores[0]]
            gs[0], gl[0] = z, 0.0
        preds.append(pred)
        gts.append(np.stack([gs, gs + gl], 1))
    return preds, gts


def _mr_cases(name):
    if name == "fuzz":
        rng = np.random.default_rng(3)
        return [_quantized_case(rng, 25) for _ in range(40)]
    if name == "continuous_degenerate":
        rng = np.random.default_rng(11)
        return [_continuous_case(rng, 25) for _ in range(40)]
    if name == "past_the_limits":  # G to 20 and P to 150: declines on both sides
        rng = np.random.default_rng(5)
        return [_quantized_case(rng, 25, max_p=150, max_g=20) for _ in range(8)]
    if name == "tie_heavy":  # two GTs each at IoU 0.5 with the top prediction
        gt = np.asarray([[10.0, 15.0], [15.0, 20.0], [10.0, 20.0]])
        preds = np.asarray([[10.0, 20.0, 0.9], [10.0, 15.0, 0.9],
                            [12.0, 18.0, 0.5], [15.0, 20.0, 0.5]])
        return [([preds], [gt])]
    if name == "zero_length_pair":  # 0/0 IoU is NaN, which matches: AP 1
        return [([np.asarray([[5.0, 5.0, 0.9]])], [np.asarray([[7.0, 7.0]])])]
    raise ValueError(name)


MR_CASES = ("fuzz", "continuous_degenerate", "past_the_limits", "tie_heavy",
            "zero_length_pair")


@pytest.mark.parametrize("name", MR_CASES)
def test_mr_ap_batch_bit_equal(name):
    runtime.reset_counts()
    handled_rows = declined_rows = 0
    for preds, gts in _mr_cases(name):
        ap, handled = runtime.mr_ap_batch(preds, gts, M.MR_AP_THDS)
        j_ap, j_handled = jax_runtime.mr_ap_batch(preds, gts, M.MR_AP_THDS)
        np.testing.assert_array_equal(handled, j_handled)
        np.testing.assert_array_equal(ap, j_ap)
        for i, (p, g) in enumerate(zip(preds, gts)):
            declines = len(p) > 0 and (len(g) == 0 or len(g) > 15 or len(p) > 126)
            assert handled[i] == (not declines), (i, len(p), len(g))
            if not handled[i]:
                assert np.all(ap[i] == 0.0)
                continue
            want = (M.detection_ap(g, p[:, :2], p[:, 2]) if len(p)
                    else np.zeros(len(M.MR_AP_THDS)))
            np.testing.assert_array_equal(ap[i], want, err_msg=f"query {i}")
        handled_rows += int(handled.sum())
        declined_rows += int((~handled).sum())
    assert runtime.counts()["mr_ap_batch"] == {"native": handled_rows,
                                               "declined": declined_rows}
    if name in ("fuzz", "continuous_degenerate"):
        assert handled_rows > 500
    if name == "past_the_limits":
        assert declined_rows > 50 and handled_rows > 20
    if name == "zero_length_pair":
        assert np.all(ap[0] == 1.0)


def test_mr_ap_batch_refuses_malformed_windows():
    bad = [np.array([[0.0, 1.0], [1.0, 2.0], [2.0, 3.0]])]  # (3, 2): 2 * 3 % 3 == 0
    with pytest.raises(ValueError, match="3 columns"):
        runtime.mr_ap_batch(bad, [np.array([[0.0, 1.0]])], [0.5])
    with pytest.raises(ValueError, match="3 columns"):
        jax_runtime.mr_ap_batch(bad, [np.array([[0.0, 1.0]])], [0.5])


# ---------------------------------------------------------------------------
# hl_ap_batch
# ---------------------------------------------------------------------------

def _hl_case(name):
    scores_list, labels_list = [], []
    if name == "fuzz":  # up to TVSum-scale clip counts, ties, single-valued columns
        rng = np.random.default_rng(9)
        for _ in range(60):
            n = int(rng.integers(1, 400))
            s = np.round(rng.standard_normal(n), int(rng.integers(0, 3)))
            mat = rng.integers(0, 2, (9, n)).astype(float)
            if rng.random() < 0.4:
                mat[int(rng.integers(0, 9))] = float(rng.integers(0, 2))
            scores_list.append(s)
            labels_list.append(mat)
    else:  # NaN scores sort last, as numpy's mergesort puts them
        rng = np.random.default_rng(31)
        for _ in range(6):
            n = int(rng.integers(4, 60))
            s = np.round(rng.standard_normal(n), 1)
            s[rng.random(n) < 0.3] = np.nan
            scores_list.append(s)
            labels_list.append(rng.integers(0, 2, (9, n)).astype(float))
    return scores_list, labels_list


@pytest.mark.parametrize("name", ["fuzz", "nan_scores"])
def test_hl_ap_batch_bit_equal(name):
    scores_list, labels_list = _hl_case(name)
    runtime.reset_counts()
    got = runtime.hl_ap_batch(scores_list, labels_list)
    np.testing.assert_array_equal(got, jax_runtime.hl_ap_batch(scores_list, labels_list))
    for q, (s, m) in enumerate(zip(scores_list, labels_list)):
        np.testing.assert_array_equal(got[q], M.binary_ap_columns(m, s), err_msg=f"query {q}")
    assert runtime.counts()["hl_ap_batch"] == {"native": len(scores_list), "declined": 0}


def test_hl_ap_batch_refuses_mismatched_labels():
    with pytest.raises(ValueError, match="expected"):
        runtime.hl_ap_batch([np.zeros(5), np.zeros(4)], [np.zeros((9, 5)), np.zeros((9, 5))])


# ---------------------------------------------------------------------------
# load_features
# ---------------------------------------------------------------------------

def _write_layout(tmp_path, layout):
    """(path, key, array) of one feature file layout fl_load reads."""
    rng = np.random.default_rng(LAYOUTS.index(layout))
    shapes = {"npy_f4_rank2": ((57, 130), np.float32), "npy_f8_rank2": ((13, 7), np.float64),
              "npy_f4_rank1": ((33,), np.float32), "npy_f8_rank1": ((21,), np.float64),
              "npz_stored": ((75, 512), np.float32), "npz_deflated": ((75, 512), np.float32)}
    shape, dtype = shapes[layout]
    arr = (rng.standard_normal(shape) * 3).astype(dtype)
    if layout.startswith("npz"):
        path = str(tmp_path / f"{layout}.npz")
        save = np.savez_compressed if layout == "npz_deflated" else np.savez
        save(path, other=np.zeros(3), features=arr)
    else:
        path = str(tmp_path / f"{layout}.npy")
        np.save(path, arr)
    return path, "features", arr


LAYOUTS = ("npy_f4_rank2", "npy_f8_rank2", "npy_f4_rank1", "npy_f8_rank1", "npz_stored",
           "npz_deflated")


@pytest.mark.parametrize("max_rows,l2norm", [(0, False), (0, True), (10, False), (10, True)])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_load_features_bit_equal(tmp_path, layout, max_rows, l2norm):
    path, key, arr = _write_layout(tmp_path, layout)
    runtime.reset_counts()
    got = runtime.load_features(path, key, max_rows=max_rows, l2norm=l2norm)
    assert runtime.counts()["load_features"] == {"native": 1, "declined": 0}
    # the port's own library, never the JAX package's flashvtg_tpu/runtime/*.so
    assert os.path.dirname(runtime.load("featload")._name) == runtime.BUILD_DIR
    want = jax_runtime.load_features(path, key, max_rows=max_rows, l2norm=l2norm)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    plain = np.asarray(arr, np.float32).reshape(-1, arr.shape[-1])
    plain = plain[:max_rows] if max_rows else plain
    np.testing.assert_array_equal(got, runtime.l2norm_replica(plain) if l2norm else plain)


def _write_declined(tmp_path, kind):
    path = str(tmp_path / f"{kind}.npy")
    if kind == "int32":
        np.save(path, np.zeros((3, 3), np.int32))
    elif kind == "float16":
        np.save(path, np.zeros((3, 3), np.float16))
    elif kind == "big_endian":
        np.save(path, np.zeros((3, 3), ">f4"))
    elif kind == "rank3":
        np.save(path, np.zeros((2, 3, 4), np.float32))
    elif kind == "fortran_order":
        np.save(path, np.asfortranarray(np.arange(12, dtype=np.float32).reshape(3, 4)))
    elif kind == "npz_missing_key":
        path = str(tmp_path / "a.npz")
        np.savez(path, other=np.zeros((3, 3), np.float32))
    elif kind == "pt":
        path = str(tmp_path / "a.pt")
        torch.save(torch.zeros(3, 3), path)
    return path


@pytest.mark.parametrize("kind", ["int32", "float16", "big_endian", "rank3", "fortran_order",
                                  "npz_missing_key", "pt"])
def test_load_features_declines_like_jax(tmp_path, kind):
    path = _write_declined(tmp_path, kind)
    runtime.reset_counts()
    assert runtime.load_features(path) is None
    assert jax_runtime.load_features(path) is None
    assert runtime.counts()["load_features"] == {"native": 0, "declined": 1}


def test_load_features_counts_under_threads(tmp_path):
    """More threads than cores load at once with a short switch interval:
    every load is counted (a lost update would show)."""
    path, key, arr = _write_layout(tmp_path, "npy_f4_rank2")
    runtime.load("featload")
    runtime.reset_counts()
    threads, per_thread, errors = 16, 40, []

    def work():
        try:
            for _ in range(per_thread):
                np.testing.assert_array_equal(runtime.load_features(path, key), arr)
        except Exception as e:  # noqa: BLE001  (reported below)
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pool = [threading.Thread(target=work) for _ in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in pool) and not errors, errors
    assert runtime.counts()["load_features"] == {"native": threads * per_thread,
                                                 "declined": 0}


# ---------------------------------------------------------------------------
# the metric suite and the dataset through the runtime
# ---------------------------------------------------------------------------

def test_eval_submission_equals_jax_and_plain():
    import chip_smoke

    sub, gt = make_synthetic_submission(1550, seed=0)
    runtime.reset_counts()
    ours = M.eval_submission(sub, gt)
    c = runtime.counts()
    # four length buckets through mr_ap_batch, every query's HL in one call
    assert c["mr_ap_batch"]["native"] > 1550 and c["mr_ap_batch"]["declined"] > 0
    assert c["hl_ap_batch"] == {"native": 1550, "declined": 0}
    assert ours == jax_eval(sub, gt, verbose=False)
    with chip_smoke.plain_metrics():  # every query through the plain functions
        plain = M.eval_submission(sub, gt)
    assert ours == plain


def test_chip_phase_host_runtime_rehearses_on_the_cpu(monkeypatch):
    """chip_smoke.py phase 18 on the CPU: the fuzz bit for bit, the metric
    suite native against plain on a stand-in for phase 4's submissions, and
    the loader on every layout (two files each)."""
    import chip_smoke

    sub, gt = make_synthetic_submission(64, seed=2)
    monkeypatch.setitem(chip_smoke.MR_SUBMISSIONS, "hl", (sub, sub[::-1], gt))
    monkeypatch.setattr(chip_smoke, "HOST_FEATURE_FILES", 2)
    res = chip_smoke.run_host_runtime(0, {})
    assert res["fuzz_counts"]["mr_ap_batch"]["declined"] > 0
    assert set(res["metric_suite"]) == {"flagship", "flagship_nms", "qvh_val_1550"}
    assert set(res["feature_loads"]) == set(chip_smoke.HOST_FEATURE_LAYOUTS)
    for row in res["feature_loads"].values():
        assert row["raw"]["max_ulps"] == 0
        assert row["l2norm"]["max_ulps"] <= chip_smoke.HOST_L2_ULPS


def _qvh_npy_text(root):
    """The fixture's set with `{qid}.npy` text of 6-14 rows (the _ms
    InternVideo2 layout eos_first reorders)."""
    ann, vdir, qdir = make_synthetic_qvh(root, n_queries=22, v_dim=48, t_dim=32, n_clips=24,
                                         min_clips=6, seed=3)
    rng = np.random.default_rng(4)
    for f in os.listdir(qdir):
        os.remove(os.path.join(qdir, f))
    from flashvtg_tpu_torch.utils.io import load_jsonl

    rows = load_jsonl(ann)
    for r in rows:
        np.save(os.path.join(qdir, f"{r['qid']}.npy"),
                rng.standard_normal((int(rng.integers(6, 15)), 32)).astype(np.float32))
    return ann, vdir, qdir


@pytest.mark.parametrize("layout", ["qvh_npz", "qvh_npy_text_eos_first", "qvh_no_norm"])
def test_dataset_rows_bit_equal_to_jax(tmp_path, layout):
    if layout == "qvh_npy_text_eos_first":
        ann, vdir, qdir = _qvh_npy_text(str(tmp_path))
    else:  # tests/test_torch_infer.py's fixture
        ann, vdir, qdir = make_synthetic_qvh(str(tmp_path), n_queries=22, v_dim=48, t_dim=32,
                                             n_clips=24, min_clips=6, seed=3)
    kw = dict(dset_name="hl", data_path=ann, v_feat_dirs=(vdir,), q_feat_dir=qdir,
              max_q_l=10, max_v_l=20, eos_first=layout == "qvh_npy_text_eos_first",
              normalize_v=layout != "qvh_no_norm", normalize_t=layout != "qvh_no_norm")
    runtime.reset_counts()
    ds = VTGDataset(DataConfig(**kw))
    assert runtime.counts()["load_features"] == {"native": 44, "declined": 0}
    jds = JaxDataset(JaxDataConfig(**kw, load_labels=False))
    assert len(ds) == len(jds) == 22
    for i in range(len(ds)):
        (meta, ours), (_, ref) = ds[i], jds[i]
        assert set(ours) <= set(ref)
        for key in ours:
            np.testing.assert_array_equal(ours[key], ref[key], err_msg=f"{meta['qid']} {key}")


# ---------------------------------------------------------------------------
# the build
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fault", ["missing_compiler", "failed_build"])
def test_build_fault_raises(tmp_path, monkeypatch, fault):
    path, key, _ = _write_layout(tmp_path, "npy_f4_rank2")
    monkeypatch.setattr(runtime, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(runtime, "_libs", {})
    if fault == "missing_compiler":
        monkeypatch.setattr(runtime, "CXX", str(tmp_path / "no-such-dir" / "g++"))
        match = "cannot run the C\\+\\+ compiler"
    else:
        monkeypatch.setattr(runtime, "CXX_FLAGS", runtime.CXX_FLAGS + ("-fno-such-option",))
        match = "no-such-option"
    with pytest.raises(RuntimeError, match=match):
        runtime.load_features(path, key)
    with pytest.raises(RuntimeError, match=match):
        runtime.mr_ap_batch([np.zeros((1, 3))], [np.zeros((1, 2))], [0.5])
    assert not [f for f in os.listdir(tmp_path / "build") if f.endswith(".so")]


def test_processes_building_at_once_load_whole_libraries(tmp_path):
    """Four processes build into one empty directory at once: each renames
    its own finished library into place and loads a whole one."""
    code = (
        "import sys, numpy as np\n"
        "import flashvtg_tpu_torch.runtime as R\n"
        "R.BUILD_DIR = sys.argv[1]\n"
        "ap, handled = R.mr_ap_batch([np.array([[0.0, 2.0, 1.0]])], [np.array([[0.0, 2.0]])],"
        " [0.5])\n"
        "assert handled.all() and (ap == 1.0).all()\n"
        "assert R.load_features(sys.argv[2]).shape == (57, 130)\n"
    )
    path, _, _ = _write_layout(tmp_path, "npy_f4_rank2")
    build = str(tmp_path / "build")
    procs = [subprocess.Popen([sys.executable, "-c", code, build, path], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for _ in range(4)]
    for p in procs:
        out = p.communicate(timeout=300)[0]
        assert p.returncode == 0, out
    libs = sorted(f for f in os.listdir(build))
    assert [f.split("_")[0] for f in libs] == ["libfeatload", "libmrap"], libs
