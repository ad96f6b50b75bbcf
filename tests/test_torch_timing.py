"""The port's span recorder (`khronos_tpu_torch/utils/timing.py`) on the CPU:
parents, stamps and starts of nested spans, the clock they lie on, the wait
spans, and the output frame's spans in a small office window. No test here
asserts a duration."""

import csv
import sys
import threading
import time
from pathlib import Path

import pytest
import torch

from khronos_tpu_torch.utils.host_copy import HostCopy
from khronos_tpu_torch.utils.timing import Timer, TimingRecorder, Wait

ROOT = Path(__file__).resolve().parent.parent
STATS_KEYS = ["name", "n_samples", "total_s", "mean_s", "stddev_s", "min_s", "max_s"]

torch.set_num_threads(1)  # as tests/torch_parity.py: several workers share the cores


def _intervals(rec):
    """Every sample as (name, start_ns, end_ns, stamp_ns, parent)."""
    return [(n, s, s + round(x * 1e9), st, p) for n in rec.names() for s, x, st, p in rec.series(n)]


def test_nested_spans_record_parent_and_inherit_stamp():
    rec = TimingRecorder()
    with rec.scoped("frame/all", 7):
        with rec.scoped("frame/step"):
            with rec.scoped("frame/inner", 9):
                pass
            with rec.scoped("frame/leaf"):
                pass
    with rec.scoped("other"):
        pass
    rows = {n: (st, p) for n, _, _, st, p in _intervals(rec)}
    assert rows == {
        "frame/all": (7, ""),
        "frame/step": (7, "frame/all"),
        "frame/inner": (9, "frame/step"),
        "frame/leaf": (7, "frame/step"),
        "other": (0, ""),
    }


def test_open_spans_are_kept_per_thread():
    """A span opened on another thread while one is open here is no child
    of it."""
    rec = TimingRecorder()

    def worker():
        with rec.scoped("worker/all"):
            rec.record("worker/tick", 0.0)

    with rec.scoped("main/all", 3):
        t = threading.Thread(target=worker)
        t.start()
        t.join()
        with rec.scoped("main/child"):
            pass
    rows = {n: (st, p) for n, _, _, st, p in _intervals(rec)}
    assert rows["worker/all"] == (0, "")
    assert rows["worker/tick"] == (0, "worker/all")
    assert rows["main/child"] == (3, "main/all")


def test_threads_recording_at_once_lose_no_sample_and_no_parent():
    """More threads than cores, switching often: every sample is kept, and
    each thread's spans name only that thread's own parent."""
    rec = TimingRecorder()
    n_threads, n_iter = 16, 200

    def worker(k):
        for _ in range(n_iter):
            with rec.scoped(f"t{k}/all", k):
                with rec.scoped("shared/step"):
                    with rec.scoped(f"t{k}/leaf"):
                        pass

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(k,)) for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert len(rec.series("shared/step")) == n_threads * n_iter
    assert sorted({(st, p) for _, _, st, p in rec.series("shared/step")}) == [(k, f"t{k}/all") for k in
                                                                              range(n_threads)]
    for k in range(n_threads):
        assert [(st, p) for _, _, st, p in rec.series(f"t{k}/leaf")] == [(k, "shared/step")] * n_iter


def test_self_time_is_never_negative():
    rec = TimingRecorder()

    def work(depth):
        torch.ones(64, 64).mm(torch.ones(64, 64))
        if depth:
            for i in range(3):
                with rec.scoped(f"level{depth - 1}"):
                    work(depth - 1)

    for _ in range(5):
        with rec.scoped("level3", 1):
            work(3)
    spans = _intervals(rec)
    assert len(spans) == 5 * (1 + 3 + 9 + 27)
    for name, s, e, _, _ in spans:
        children = [c for c in spans if c[4] == name and s <= c[1] and c[2] <= e]
        assert (e - s) - sum(c[2] - c[1] for c in children) >= 0, name
    # every child lies inside one sample of its parent
    for name, s, e, _, parent in spans:
        if parent:
            assert sum(1 for p in spans if p[0] == parent and p[1] <= s and e <= p[2]) == 1


def test_starts_lie_on_perf_counter_ns():
    rec = TimingRecorder()
    reads = []
    for _ in range(20):
        before = time.perf_counter_ns()
        with rec.scoped("probe"):
            inside = time.perf_counter_ns()
        after = time.perf_counter_ns()
        reads.append((before, inside, after))
    for (start, seconds, _, _), (before, inside, after) in zip(rec.series("probe"), reads):
        end = start + round(seconds * 1e9)
        assert before <= start <= inside <= end <= after


def test_record_without_a_start_takes_now_less_its_duration():
    rec = TimingRecorder()
    before = time.perf_counter_ns()
    with rec.scoped("outer", 5):
        rec.record("added", 0.0)
    after = time.perf_counter_ns()
    ((start, seconds, stamp, parent),) = rec.series("added")
    assert (seconds, stamp, parent) == (0.0, 5, "outer")
    assert before <= start <= after


def test_program_span_encloses_its_aten_ops_under_the_profiler():
    """The benchmark's offset method (a marked record_function beside a
    perf_counter read, benchmark/harness/worker.py's Trace) puts the
    profiler's events on the recorder's clock."""
    from torch.profiler import ProfilerActivity, profile, record_function

    rec = TimingRecorder()
    a = torch.ones(32, 32)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t_mark = time.perf_counter()
        with record_function("bench:mark"):
            pass
        for _ in range(3):
            with rec.scoped("probe/mm"):
                time.sleep(0.002)  # room around the op for the offset's error (a few microseconds)
                a.mm(a)
                time.sleep(0.002)
    evs = prof.events()
    mark = next(e.time_range.start for e in evs if e.name == "bench:mark")
    off = t_mark - mark * 1e-6
    mms = sorted((e.time_range.start * 1e-6 + off, e.time_range.end * 1e-6 + off) for e in evs if e.name == "aten::mm")
    spans = sorted((s * 1e-9, s * 1e-9 + x) for s, x, _, _ in rec.series("probe/mm"))
    assert len(mms) == len(spans) == 3
    for (op_s, op_e), (sp_s, sp_e) in zip(mms, spans):
        assert sp_s <= op_s <= op_e <= sp_e


def test_stats_rows_keep_their_keys(tmp_path):
    rec = TimingRecorder()
    with rec.scoped("a/all", 11):
        with rec.scoped("a/part"):
            pass
    rows = rec.stats()
    assert [list(r) for r in rows] == [STATS_KEYS, STATS_KEYS]
    assert [r["name"] for r in rows] == ["a/all", "a/part"]
    rec.save(str(tmp_path))
    with open(tmp_path / "stats.csv") as fh:
        assert next(csv.reader(fh)) == STATS_KEYS
    with open(tmp_path / "a_part.csv") as fh:
        header, row = list(csv.reader(fh))
    assert header == ["stamp_ns", "seconds", "start_ns", "parent"]
    assert row[0] == "11" and row[3] == "a/all"


class _InFlight:
    """A CUDA event's stand-in that has not completed until waited for."""

    def __init__(self):
        self.done = False

    def query(self):
        return self.done

    def synchronize(self):
        self.done = True


@pytest.mark.parametrize("earliest", [False, True])
def test_host_copy_of_cpu_tensors_records_no_wait(earliest):
    rec = TimingRecorder.instance()
    rec.reset()
    a = torch.arange(6, dtype=torch.int32)
    copy = HostCopy(a, a.float(), earliest=earliest, site="bus")
    assert copy.ready()
    copy.numpy(0), copy.numpy(1)
    assert not [n for n in rec.names() if n.startswith("wait/")]


def test_host_copy_in_flight_records_one_wait():
    """A copy whose event has not completed records one `wait/<site>` when
    it is consumed, inside the span open at the time; once it has landed,
    nothing more."""
    rec = TimingRecorder.instance()
    rec.reset()
    copy = HostCopy(torch.arange(3), site="bus")
    copy.events = [_InFlight()]
    with Timer("active_window/all", 13):
        assert not copy.ready()
        copy.numpy(0)
        copy.numpy(0)
    assert [(st, p) for _, _, st, p in rec.series("wait/bus")] == [(13, "active_window/all")]
    with Wait("site", blocks=False):
        pass
    assert "wait/site" not in rec.names()


def test_tiny_office_window_records_the_output_frame_spans():
    """The office window at the benchmark's CPU shrink: one `extract/emit`
    an output, inside it, and one `object_extraction/track` a track handed
    to the extractor, inside `object_extraction/all`; no wait on the CPU."""
    for p in (str(ROOT), str(ROOT / "benchmark"), str(ROOT / "benchmark" / "tests")):
        if p not in sys.path:
            sys.path.insert(0, p)
    from harness import manifest, scene, worker
    from tiny import shrink

    from khronos_tpu_torch.active_window.frame_data import FrameData

    bench = manifest.load()
    cfg, traffic = shrink(manifest.config(bench, "synthetic_office"), manifest.traffic("window.r4"))
    device = torch.device("cpu")
    frames = scene.render_loop(cfg["scene"], cfg["sensor"], float(traffic["stamp_hz"]), device)
    aw = worker.build_engine(cfg, device)
    handed = []
    extract_all = aw.object_extractor.extract_all

    def counted(tracks, frame_buffer):
        handed.append(len(tracks))
        return extract_all(tracks, frame_buffer)

    aw.object_extractor.extract_all = counted
    rec = TimingRecorder.instance()
    rec.reset()
    step_ns = int(round(1e9 / float(traffic["stamp_hz"])))
    outputs = []
    for j in range(92):  # the first tracks finish at frame 84
        i = j % len(frames)
        out = aw.spin_once(FrameData(stamp_ns=j * step_ns, depth=frames.depth[i], color=frames.color[i],
                                     labels=frames.labels[i], R_w_c=frames.R[i], t_w_c=frames.t[i]))
        if out is not None:
            outputs.append(out.stamp_ns)
    assert outputs and sum(handed) > 0
    emits = rec.series("extract/emit")
    assert [(st, p) for _, _, st, p in emits] == [(s, "active_window/extract_output") for s in outputs]
    tracks = rec.series("object_extraction/track")
    assert len(tracks) == sum(handed)
    extractions = {st for _, _, st, _ in rec.series("object_extraction/all")}
    assert {p for _, _, _, p in tracks} == {"object_extraction/all"}
    assert {st for _, _, st, _ in tracks} <= extractions <= set(outputs)
    assert not [n for n in rec.names() if n.startswith("wait/")]
