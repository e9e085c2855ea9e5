"""The program's spans and counters (utils/observability.py) and the
benchmark's readers of them (vtgbench/harness/program.py), on the CPU under
torch.profiler, on tiny splits.

  * run_mr_inference's span tree: every batch id has eval.collate,
    eval.dispatch, eval.fetch_wait and eval.rows under the eval.infer root
    (data.collate under eval.collate), and the pass's eval.gather,
    eval.postprocess and eval.nms;
  * run_streamed_epoch's span tree: the prefetch thread's data.make_batch
    and data.collate spans are kept, with the thread's name, under the
    train.epoch root opened on the main thread;
  * with no profiler nothing is recorded (the counters still count);
  * the roots' counter deltas: eval.fetches = eval.batches = the batches,
    train.steps the steps, data.video_rows / data.valid_video_rows the rows
    as collated;
  * the submission's jsonl rows are byte for byte the same with recording
    on and off;
  * the same clock: a record_function range inside a span lies inside it;
  * profile_trace writes spans.jsonl;
  * the bound drops and counts spans past it; counters and spans from
    several threads at once lose no update;
  * each new per-layer reader on a synthetic trace and spans, and None
    where it has nothing to read (another mode, no span, no recorder);
  * on the card (marked `cuda`, skipped here): a kernel launched inside a
    span after a sync lies inside it on the profiler's record, within 50 us:

    python -m pytest --noconftest -q -m cuda tests/test_torch_trace.py -s
"""

import json
import os
import sys
import threading
import time
import types

import pytest
import torch_threads  # noqa: F401  (torch's share of the cores under xdist)
import torch
from torch.profiler import ProfilerActivity, profile

from flashvtg_tpu_torch.data.collate import Collator
from flashvtg_tpu_torch.data.dataset import VTGDataset
from flashvtg_tpu_torch.models import build_model
from flashvtg_tpu_torch.train import loop
from flashvtg_tpu_torch.train.config import from_preset
from flashvtg_tpu_torch.train.infer import eval_data_config, run_mr_inference
from flashvtg_tpu_torch.utils import observability as obs
from flashvtg_tpu_torch.utils.observability import RECORDER, Recorder, Span
from flashvtg_tpu_torch.utils.synthetic import make_synthetic_qvh
from vtgbench.harness.cell import Cell
from vtgbench.harness.cell import PACKAGE as BENCH_PACKAGE
from vtgbench.harness.trace import Trace

SMALL = dict(
    v_feat_dim=48, t_feat_dim=32, t2v_layers=1, enc_layers=1, dummy_layers=1,
    num_dummies=4, hidden_dim=64, dim_feedforward=128, num_mlp_layers=2, max_v_l=24,
    max_q_l=10, eval_bsz=8, bsz=4, nms_thd=0.7, train_precision="float32",
)
N_QUERIES = 22  # eval batches of 8, 8, then the 4 + 2 binary tail
BATCH_STAGES = ("eval.collate", "eval.dispatch", "eval.fetch_wait", "eval.rows")
CPU = [ProfilerActivity.CPU]


@pytest.fixture
def recorder():
    RECORDER.clear()
    yield RECORDER
    RECORDER.clear()


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("trace"))
    ann, vdir, qdir = make_synthetic_qvh(root, n_queries=N_QUERIES, v_dim=48, t_dim=32,
                                         n_clips=24, min_clips=6, seed=5)
    train, tvdir, tqdir = make_synthetic_qvh(root, n_queries=12, v_dim=48, t_dim=32,
                                             n_clips=24, min_clips=6, seed=6, split="train")
    return dict(eval_path=ann, v_feat_dirs=(vdir,), t_feat_dir=qdir, train_path=train,
                train_feat_dirs=(tvdir,), train_t_dir=tqdir)


@pytest.fixture(scope="module")
def evaluation(split):
    cfg = from_preset("qvhighlights_slowclip", **SMALL, eval_path=split["eval_path"],
                      v_feat_dirs=split["v_feat_dirs"], t_feat_dir=split["t_feat_dir"])
    model = build_model(cfg.model_config(), torch.device("cpu"), 3).eval()
    ds = VTGDataset(eval_data_config(cfg, split["eval_path"]))
    run_mr_inference(cfg, model, ds)  # builds the device feed, as a first pass does
    return cfg, model, ds


def _collated(collator, samples):
    """(video rows, valid video rows) of one batch as the Collator pads it."""
    batch, lv = collator._collate(samples)
    return len(samples) * lv, int(batch["valid_v_lens"].sum())


def _by_name(spans, name):
    return [s for s in spans if s.name == name]


def test_mr_inference_span_tree(recorder, evaluation):
    cfg, model, ds = evaluation
    with profile(activities=CPU):
        run_mr_inference(cfg, model, ds)
    (root,) = _by_name(recorder.spans, "eval.infer")
    assert root.parent is None and root.counters is not None
    batches = 4
    for name in BATCH_STAGES:
        mine = _by_name(recorder.spans, name)
        assert sorted(s.id for s in mine) == list(range(batches)), name
        assert all(s.parent == root.seq and s.thread == root.thread for s in mine)
        assert all(root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns for s in mine)
    collates = {s.seq: s for s in _by_name(recorder.spans, "eval.collate")}
    inner = _by_name(recorder.spans, "data.collate")
    assert sorted(s.id for s in inner) == list(range(batches))
    assert all(collates[s.parent].id == s.id for s in inner)
    for name in ("eval.gather", "eval.postprocess", "eval.nms"):
        (s,) = _by_name(recorder.spans, name)
        assert s.parent == root.seq
    # the stages hold most of the root's time on its thread
    stages = sum(s.end_ns - s.start_ns for s in recorder.spans
                 if s.parent == root.seq)
    assert stages / (root.end_ns - root.start_ns) > 0.5


def _train_parts(split):
    cfg = from_preset("qvhighlights_slowclip", **SMALL, train_path=split["train_path"],
                      v_feat_dirs=split["train_feat_dirs"], t_feat_dir=split["train_t_dir"],
                      device_feed="off")
    ds = VTGDataset(loop.train_data_config(cfg, cfg.train_path))
    collator = Collator(cfg.max_q_l, cfg.v_buckets, cfg.max_v_l, dset_name=cfg.dset_name)
    return cfg, ds, collator


def _streamed(cfg, ds, collator, n):
    """run_streamed_epoch of n steps through a step that reads its batch's
    valid clips; returns (steps run, [samples of each step])."""
    taken = []

    def host_batch(i):
        rows = list(range(i * cfg.bsz, (i + 1) * cfg.bsz))
        samples = [ds[j] for j in rows]
        taken.append(samples)
        return rows, collator(samples)

    def step(batch):
        return batch["src_vid_mask"].sum().reshape(1)

    loss_buf = torch.zeros((n, 1))
    done = loop.run_streamed_epoch(step, host_batch, n, loss_buf, "cpu")
    return done, taken


def test_streamed_epoch_span_tree(recorder, split):
    cfg, ds, collator = _train_parts(split)
    with profile(activities=CPU):
        done, taken = _streamed(cfg, ds, collator, 3)
    assert done == 3
    (root,) = _by_name(recorder.spans, "train.epoch")
    assert root.thread == threading.current_thread().name
    made = _by_name(recorder.spans, "data.make_batch")
    assert sorted(s.id for s in made) == [0, 1, 2]
    assert {s.thread for s in made} == {"batch-prefetch"}
    assert all(s.parent == root.seq for s in made)
    makes = {s.seq: s for s in made}
    inner = _by_name(recorder.spans, "data.collate")
    assert len(inner) == 3 and all(makes[s.parent].id == s.id for s in inner)
    assert {s.thread for s in inner} == {"batch-prefetch"}
    for name in ("train.batch_wait", "train.issue"):
        mine = _by_name(recorder.spans, name)
        assert mine and all(s.thread == root.thread and s.parent == root.seq for s in mine)
    # the last wait finds the queue's end: one more wait than steps
    assert sorted(s.id for s in _by_name(recorder.spans, "train.batch_wait")) == [0, 1, 2, 3]
    rows = [_collated(collator, samples) for samples in taken]
    assert root.counters == {"train.steps": 3,
                             "data.video_rows": sum(r for r, _ in rows),
                             "data.valid_video_rows": sum(v for _, v in rows)}


def test_nothing_recorded_without_a_profiler(recorder, evaluation, split):
    cfg, model, ds = evaluation
    fetches = obs.counter("eval.fetches")
    run_mr_inference(cfg, model, ds)
    tcfg, tds, collator = _train_parts(split)
    _streamed(tcfg, tds, collator, 2)
    assert recorder.spans == [] and recorder.active is None
    assert obs.counter("eval.fetches") - fetches == 4  # counted all the same


def test_root_counter_deltas(recorder, evaluation):
    cfg, model, ds = evaluation
    collator = Collator(max_q_l=cfg.max_q_l, v_buckets=cfg.v_buckets, fixed_v_len=cfg.max_v_l,
                        dset_name=cfg.dset_name)
    obs.count("eval.batches", 5)  # counts before the root are not its own
    with profile(activities=CPU):
        run_mr_inference(cfg, model, ds)
    (root,) = _by_name(recorder.spans, "eval.infer")
    sizes = (8, 8, 4, 2)
    rows, i = [], 0
    for b in sizes:
        rows.append(_collated(collator, [ds[j] for j in range(i, i + b)]))
        i += b
    assert root.counters["eval.fetches"] == root.counters["eval.batches"] == len(sizes)
    assert root.counters["data.video_rows"] == sum(r for r, _ in rows) == N_QUERIES * 24
    assert root.counters["data.valid_video_rows"] == sum(v for _, v in rows)
    assert root.counters["data.valid_video_rows"] == sum(
        min(len(ds[j][1]["video_feat"]), 24) for j in range(N_QUERIES))


def test_rows_are_the_same_with_recording_on_and_off(recorder, evaluation):
    cfg, model, ds = evaluation

    def lines(out):
        sub, sub_nms, _ = out
        return [json.dumps(e) for e in sub + sub_nms]

    off = lines(run_mr_inference(cfg, model, ds))
    with profile(activities=CPU):
        on = lines(run_mr_inference(cfg, model, ds))
    assert _by_name(recorder.spans, "eval.infer")
    assert on == off and len(on) == 2 * N_QUERIES


def test_spans_and_the_profiler_share_a_clock(recorder):
    with profile(activities=CPU) as prof:
        with obs.RECORDER.root("probe"):
            with obs.span("probe.inner", 7):
                with torch.autograd.profiler.record_function("probe_range"):
                    torch.ones(64).sum()
    (inner,) = _by_name(recorder.spans, "probe.inner")
    (event,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "probe_range"]
    start, end = event.start_ns(), event.start_ns() + event.duration_ns()
    assert inner.start_ns <= start <= end <= inner.end_ns


def test_profile_trace_writes_spans_jsonl(recorder, tmp_path, split):
    cfg, ds, collator = _train_parts(split)
    log_dir = tmp_path / "prof"
    with obs.profile_trace(str(log_dir)):
        _streamed(cfg, ds, collator, 2)
    with open(log_dir / "spans.jsonl") as f:
        rows = [json.loads(line) for line in f]
    assert [r for r in rows if r["name"] == "train.epoch"][0]["counters"]["train.steps"] == 2
    assert {r["thread"] for r in rows if r["name"] == "data.make_batch"} == {"batch-prefetch"}
    assert len(rows) == len(recorder.spans)
    assert set(rows[0]) >= {"name", "id", "seq", "parent", "thread", "start_ns", "end_ns"}


def test_bound_drops_and_counts(monkeypatch):
    rec = Recorder(bound=3)
    monkeypatch.setattr(torch._C._autograd, "_profiler_enabled", lambda: True)
    with rec.root("r"):
        for i in range(4):
            with rec.span("s", i):
                pass
    assert [s.name for s in rec.spans] == ["s", "s", "s"] and rec.dropped == 2


def test_threads_lose_no_count_or_span(monkeypatch):
    rec = Recorder()
    monkeypatch.setattr(torch._C._autograd, "_profiler_enabled", lambda: True)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(k):
            for i in range(500):
                with rec.span("w", i):
                    rec.count("n")
                    rec.count(f"t{k}", 2)

        with rec.root("r"):
            threads = [threading.Thread(target=work, args=(k,), name=f"w{k}") for k in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    (root,) = [s for s in rec.spans if s.name == "r"]
    assert root.counters["n"] == 16 * 500
    assert all(root.counters[f"t{k}"] == 1000 for k in range(16))
    assert len(rec.spans) == 16 * 500 + 1 and len({s.seq for s in rec.spans}) == len(rec.spans)


# the per-layer readers: a synthetic window (ms on the shared clock)
MS = 1_000_000
MAIN, PREFETCH = "MainThread", "batch-prefetch"


def _span(seq, name, start, end, id=None, parent=0, thread=MAIN, counters=None):
    return Span(seq, name, id, parent, thread, start * MS, end * MS, counters)


def _train_window():
    spans = [_span(0, "train.epoch", 0, 100, parent=None, counters={
        "train.steps": 4, "data.video_rows": 400, "data.valid_video_rows": 28})]
    for i, (a, b) in enumerate([(0, 5), (20, 25), (40, 45), (60, 65)]):
        spans.append(_span(len(spans), "data.make_batch", a, b, i, thread=PREFETCH))
    for i, (a, b) in enumerate([(5, 10), (10, 20), (60, 80), (82, 90)]):
        spans.append(_span(len(spans), "train.step_wait", a, b, i))
    spans += [_span(len(spans), "train.batch_wait", 0, 3, 0),
              _span(len(spans) + 1, "train.batch_wait", 95, 98, 4),
              _span(len(spans) + 2, "train.issue", 35, 50, 2)]
    # device busy 10-30 and 50-90: idle 30-50, of which the main thread's
    # train.issue names 35-50 (the prefetch thread's 40-45 names nothing)
    records = [("k", 10 * MS, 20 * MS), ("k", 50 * MS, 40 * MS)]
    return spans, records, "train", 4


def _eval_window():
    spans = [_span(0, "eval.infer", 0, 100, parent=None,
                   counters={"eval.batches": 2, "eval.fetches": 2})]
    for i in range(2):
        for name, start, length in (("eval.collate", 0, 1), ("eval.dispatch", 1, 4),
                                    ("eval.fetch_wait", 5, 10), ("eval.rows", 15, 2)):
            spans.append(_span(len(spans), name, 20 * i + start, 20 * i + start + length, i))
    for name, start, length in (("eval.gather", 60, 1), ("eval.postprocess", 61, 2),
                                ("eval.nms", 63, 3)):
        spans.append(_span(len(spans), name, start, start + length))
    spans.append(_span(len(spans), "eval.metrics", 100, 120, parent=None, counters={}))
    # device busy 0-5, 20-25, 66-70, 110-112: idle 5-20 (fetch_wait and rows
    # of batch 0 name 12), 25-66 (batch 1's 12, gather to nms 6), 70-110
    # (eval.metrics 10)
    records = [("k", 0, 5 * MS), ("k", 20 * MS, 5 * MS), ("k", 66 * MS, 4 * MS),
               ("k", 110 * MS, 2 * MS)]
    return spans, records, "eval", 2


EXPECTED = {
    "batch_make_ms_per_step.train": (_train_window, 5.0),
    "batch_wait_ms_per_step.train": (_train_window, 1.5),
    "step_wait_ms_per_step.train": (_train_window, 43 / 4),
    "valid_row_share.train": (_train_window, 7.0),
    "idle_named_share.train": (_train_window, 75.0),
    "collate_ms_per_batch.eval": (_eval_window, 1.0),
    "dispatch_ms_per_batch.eval": (_eval_window, 4.0),
    "fetch_wait_ms_per_batch.eval": (_eval_window, 10.0),
    "rows_ms_per_batch.eval": (_eval_window, 2.0),
    "tail_s.eval": (_eval_window, 0.006),
    "idle_named_share.eval": (_eval_window, 100.0 * (12 + 18 + 10) / (15 + 41 + 40)),
}


def _reader(name):
    return Cell(os.path.dirname(BENCH_PACKAGE), "tacos-eval-f32").reader(name)


def _trace(records, mode, steps):
    trace = Trace(False)
    trace.records, trace.steps, trace.window_s = records, steps, 0.12
    trace.extra.update(mode=mode)
    trace.spans = [("infer" if mode == "eval" else "epoch", 0, 100 * MS)]
    return trace


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_on_a_synthetic_window(recorder, name):
    window, want = EXPECTED[name]
    spans, records, mode, steps = window()
    recorder.spans.extend(spans)
    trace = _trace(records, mode, steps)
    assert _reader(name)(trace) == pytest.approx(want, rel=1e-12)
    if name.startswith("idle_named_share"):  # the accounting note
        (note,) = trace.extra["notes"]
        harness = "infer" if mode == "eval" else "epoch"
        assert f"0.1000 s over 1 roots, the harness's {harness} 0.1000 s" in note


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_has_nothing_to_read(recorder, monkeypatch, name):
    window, _ = EXPECTED[name]
    spans, records, mode, steps = window()
    read = _reader(name)
    assert read(_trace(records, mode, steps)) is None  # no span recorded
    recorder.spans.extend(spans)
    other = "train" if mode == "eval" else "eval"
    assert read(_trace(records, other, steps)) is None  # the other mode's window
    # a program without the recorder (an older tree): None, no exception
    monkeypatch.setitem(sys.modules, "flashvtg_tpu_torch.utils.observability",
                        types.ModuleType("flashvtg_tpu_torch.utils.observability"))
    assert read(_trace(records, mode, steps)) is None


@pytest.mark.cuda
def test_a_kernel_lies_inside_its_span_on_the_card(recorder):
    """torch.cuda._sleep launched inside a span after a sync: its record in
    a CUDA-only profile (the benchmark's; the window launches no other
    kernel) lies inside the span within 50 us; prints the lead and trail
    and the harness's offset."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the check reads a kernel's record")
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.__enter__()
    host0 = time.time_ns()
    try:
        with RECORDER.root("probe"):
            for i in range(8):
                torch.cuda.synchronize()
                with obs.span("probe.sleep", i):
                    torch.cuda._sleep(1_000_000)
                    torch.cuda.synchronize()
    finally:
        prof.__exit__(None, None, None)
    results = prof.profiler.kineto_results
    offset = results.trace_start_ns() - host0
    kernels = sorted((e.start_ns(), e.start_ns() + e.duration_ns()) for e in results.events()
                     if e.device_type() == torch.autograd.DeviceType.CUDA
                     and not e.is_user_annotation() and not e.name().startswith("Mem"))
    spans = sorted(_by_name(recorder.spans, "probe.sleep"), key=lambda s: s.start_ns)
    assert len(spans) == 8
    assert len(kernels) == 8, sorted({e.name() for e in results.events()})
    lead = [k0 - s.start_ns for (k0, _), s in zip(kernels, spans)]
    trail = [s.end_ns - k1 for (_, k1), s in zip(kernels, spans)]
    print(f"[clock] kernel start - span start {min(lead)}..{max(lead)} ns; span end - kernel "
          f"end {min(trail)}..{max(trail)} ns; harness _offset_ns {offset} ns "
          f"({torch.cuda.get_device_name(0)})")
    assert min(lead) >= -50_000 and min(trail) >= -50_000
