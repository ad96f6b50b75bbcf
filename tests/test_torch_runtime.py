"""Port parity for the runtime: the stage executor (khronos_tpu_torch/native.py
on native/executor.cpp, and its plain Python version) and the pipeline's
async stage mode (pipeline/pipeline.py), the cases of tests/test_runtime.py.

- The seven executor cases run on both executors.
- The async run (`ExperimentManager.run(async_stages=True)`) against the
  inline run on tests/test_runtime.py's sequence (rendered by the
  reference), with the reference test's bars: the same frame count,
  snapshot count, object ids and agent count, the final mesh's sorted
  vertices within 1e-5 m. Against the reference's inline run:
  tests/test_torch_runtime_reference.py.
- `start_async` / `submit_frame` / `finish_async`: tests/test_torch_async_stages.py.
The endurance run's corridor in both packages is tests/test_torch_endurance.py."""

import os
import threading
import time

import numpy as np
import pytest
import torch

from khronos_tpu.data import synthetic as jsyn
from khronos_tpu_torch import native
from khronos_tpu_torch.active_window.frame_data import FrameData as TFrame
from khronos_tpu_torch.config import build as tbuild
from khronos_tpu_torch.pipeline.pipeline import ExperimentConfig as TExperimentConfig
from khronos_tpu_torch.pipeline.pipeline import ExperimentManager as TManager
from khronos_tpu_torch.pipeline.pipeline import KhronosPipeline as TPipeline
from khronos_tpu_torch.pipeline.pipeline import PipelineConfig as TPipelineConfig

from torch_parity import torch_camera


EXECUTORS = {"native": native.make_pipeline_executor, "python": native.PyPipelineExecutor}


@pytest.fixture(params=list(EXECUTORS))
def make_executor(request):
    return EXECUTORS[request.param]


class TestExecutor:
    def test_available(self, make_executor):
        ex = make_executor([lambda i: None])
        ex.stop()
        ex.close()
        if make_executor is native.make_pipeline_executor:
            lib = native._library_path(native.EXECUTOR_SOURCE, native.EXECUTOR_LIBS, "libkhronos_executor")
            assert lib.exists() and lib.parent == native.BUILD_DIR

    def test_fifo_ordering_single_worker(self, make_executor):
        seen = []
        ex = make_executor([seen.append], capacity=8)
        for i in range(100):
            ex.push(0, i)
        ex.drain()
        ex.stop()
        ex.close()
        assert seen == list(range(100))

    def test_stage_chaining_and_conditional_fanout(self, make_executor):
        lock = threading.Lock()
        got = {"a": [], "b": []}

        def s0(i):
            with lock:
                got["a"].append(i)
            if i % 3 == 0:
                ex.push(1, i)

        def s1(i):
            with lock:
                got["b"].append(i)

        ex = make_executor([s0, s1], capacity=4)
        for i in range(30):
            ex.push(0, i)
        ex.drain()
        ex.stop()
        ex.close()
        assert sorted(got["a"]) == list(range(30))
        assert sorted(got["b"]) == [i for i in range(30) if i % 3 == 0]

    def test_stages_overlap(self, make_executor):
        """Two stages of sleepy work must pipeline, not serialise."""

        def s0(i):
            time.sleep(0.005)
            ex.push(1, i)

        def s1(i):
            time.sleep(0.005)

        ex = make_executor([s0, s1], capacity=4)
        t0 = time.perf_counter()
        for i in range(40):
            ex.push(0, i)
        ex.drain()
        dt = time.perf_counter() - t0
        ex.stop()
        ex.close()
        # serial: 40 * 0.01 = 0.4 s; pipelined ~0.2 s + overhead
        assert dt < 0.35, f"stages did not overlap: {dt:.3f}s"

    def test_backpressure_bounded_queue(self, make_executor):
        release = threading.Event()

        def slow(i):
            release.wait(timeout=5.0)

        ex = make_executor([slow], capacity=2)
        assert ex.push(0, 0)  # taken by the worker
        time.sleep(0.05)
        assert ex.push(0, 1)
        assert ex.push(0, 2)
        # queue now full (capacity 2): a non-blocking push must fail
        assert not ex.push(0, 3, block=False)
        release.set()
        ex.drain()
        ex.stop()
        ex.close()

    def test_error_propagation(self, make_executor):
        def bad(i):
            raise RuntimeError(f"stage failed on {i}")

        ex = make_executor([bad])
        ex.push(0, 7)
        with pytest.raises(RuntimeError, match="stage failed"):
            ex.drain()
        ex.stop()
        ex.close()

    def test_counters(self, make_executor):
        ex = make_executor([lambda i: None], capacity=16)
        for i in range(25):
            ex.push(0, i)
        ex.drain()
        assert ex.processed(0) == 25
        ex.stop()
        ex.close()


def test_many_workers_lose_no_item(make_executor):
    """More workers than cores on one stage, with a short switch interval:
    every item is processed once and the counter sees each (a lost update
    would break either)."""
    import os
    import sys

    seen, lock = [], threading.Lock()

    def s0(i):
        with lock:
            seen.append(i)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ex = make_executor([s0], capacity=64, workers=[2 * (os.cpu_count() or 4)])
        for i in range(2000):
            ex.push(0, i)
        ex.drain()
        assert ex.processed(0) == 2000
        ex.stop()
        ex.close()
    finally:
        sys.setswitchinterval(interval)
    assert sorted(seen) == list(range(2000))


def test_executor_build_failure_raises(tmp_path, monkeypatch):
    """No quiet fallback to the Python executor."""
    bad = tmp_path / "executor.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "EXECUTOR_SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_exec_lib", None)
    with pytest.raises(RuntimeError, match="building executor.cpp failed"):
        native.make_pipeline_executor([lambda i: None])


# ----------------------------------------------------------------------------
# the async stage mode
# ----------------------------------------------------------------------------

SMALL = {
    "active_window": {"volumetric_map": {"grid_shape": [128, 128, 32], "voxel_size": 0.12}},
    "label_space": {"num_classes": 7, "object_labels": [2, 3, 4, 5, 6], "dynamic_labels": [1]},
    "run_change_detection_every_n_frames": 10,
}


@pytest.fixture(scope="module")
def small_frames():
    """tests/test_runtime.py's _make_small_run sequence, rendered by the reference."""
    duration, fps = 10.0, 3.0
    seq = jsyn.SyntheticSequence(jsyn.office_scene(duration=duration), jsyn.SyntheticSequenceConfig(
        duration=duration, fps=fps, height=64, width=96, fx=60.0, fy=60.0, cx=48.0, cy=32.0, n_loops=1.0))
    rendered = [{k: (np.array(v) if hasattr(v, "shape") else v) for k, v in seq.render_frame(i).items()}
                for i in range(seq.n_frames)]
    return seq.camera, rendered


def _feed(rendered, make, conv):
    frames = [make(stamp_ns=f["stamp_ns"], depth=conv(f["depth"]), color=conv(f["color"]), labels=conv(f["labels"]),
                   R_w_c=f["R_w_c"], t_w_c=f["t_w_c"]) for f in rendered]
    return frames, [(f["R_gt"], f["t_gt"]) for f in rendered]


def _port_run(cam, rendered, tmp, mode):
    cfg = tbuild(TPipelineConfig, SMALL)
    pipe = TPipeline(cfg, torch_camera(cam), device="cpu")
    frames, gts = _feed(rendered, TFrame, torch.from_numpy)
    out = TManager(TExperimentConfig(output_dir=str(tmp / mode)), pipe, cfg).run(
        frames, gts, async_stages=(mode == "async"))
    return pipe, out


@pytest.fixture(scope="module")
def small_runs(small_frames, tmp_path_factory):
    cam, rendered = small_frames
    tmp = tmp_path_factory.mktemp("runs")
    return {mode: _port_run(cam, rendered, tmp, mode) for mode in ("inline", "async")}


def _assert_maps_agree(pipe_a, pipe_b):
    """tests/test_runtime.py's bars for two runs of one sequence."""
    assert pipe_a.frame_count == pipe_b.frame_count
    assert pipe_a.map.num_snapshots == pipe_b.map.num_snapshots
    dsg_a, dsg_b = pipe_a.map.snapshots[-1], pipe_b.map.snapshots[-1]
    assert len(dsg_a.mesh.vertices) == len(dsg_b.mesh.vertices) > 1000
    np.testing.assert_allclose(np.sort(np.asarray(dsg_a.mesh.vertices), axis=0),
                               np.sort(np.asarray(dsg_b.mesh.vertices), axis=0), atol=1e-5)
    assert set(dsg_a.objects) == set(dsg_b.objects)
    assert len(dsg_a.agents) == len(dsg_b.agents)


def test_async_matches_sync(small_runs):
    (pipe_sync, _), (pipe_async, out) = small_runs["inline"], small_runs["async"]
    _assert_maps_agree(pipe_async, pipe_sync)
    assert os.path.exists(os.path.join(out, "final.4dmap.npz"))


def test_take_places_update_hands_over_the_deferred_update(small_frames):
    """With defer_cd the places re-extraction is not run by process_frame but
    handed out once by take_places_update, and running it updates the layer."""
    cam, rendered = small_frames
    pipe = TPipeline(tbuild(TPipelineConfig, SMALL), torch_camera(cam), device="cpu")
    frames, gts = _feed(rendered[:4], TFrame, torch.from_numpy)
    calls = []
    update = pipe.places_extractor.update_local
    pipe.places_extractor.update_local = lambda *a, **k: calls.append(a) or update(*a, **k)
    pipe.process_frame(frames[0], gt_pose=gts[0], defer_cd=True)
    assert not calls
    job = pipe.take_places_update()
    assert job is not None and pipe.take_places_update() is None
    job()
    assert len(calls) == 1
