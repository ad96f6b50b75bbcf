"""The port's async stage mode through start_async / submit_frame /
finish_async (pipeline/pipeline.py), against its inline run.

The frame thread runs the active window only; a backend worker takes each
output (the deferred object extraction, the backend, the places layer) and
makes the change-detection requests, which a CD worker runs. The runs here
are fed so that no trigger is deferred: after each submit_frame the frame
thread waits for the backend stage to finish and the CD stage to go idle,
and `cd_deferred_triggers` stays 0.

- Loop-closure passes only (`run_change_detection_every_n_frames: 0`): a
  loop closure's request is made at the same output as inline, so the run
  equals the inline run: the same frames, snapshot stamps, object ids and
  agents, the final mesh bit for bit.
- A periodic trigger (every n frames) is served at the next output after
  it, and the frame counter restarts when it is served, as in the
  reference: each pass lands at an output stamp at or after the inline
  pass's, and none is lost but a trigger after the last output.
- A worker's error surfaces from finish_async; a pipeline checkpoints after
  finish_async (its threads and queues are left out).
The run is tests/test_torch_pipeline_cd.py's small drifted office (objects,
loop closures) with the places layer on, rendered by the port."""

import copy

import numpy as np
import pytest

from khronos_tpu_torch.active_window.frame_data import FrameData
from khronos_tpu_torch.config import build
from khronos_tpu_torch.data import synthetic as syn
from khronos_tpu_torch.pipeline.pipeline import KhronosPipeline, PipelineConfig

from test_torch_checkpoint import DURATION, DRIFT, FPS, H, PIPELINE, W

import torch_parity  # noqa: F401  (one PyTorch thread per worker)


@pytest.fixture(scope="module")
def rendered():
    seq = syn.SyntheticSequence(
        syn.office_scene(DURATION),
        syn.SyntheticSequenceConfig(duration=DURATION, fps=FPS, height=H, width=W, fx=W * 0.625, fy=W * 0.625,
                                    cx=W / 2, cy=H / 2, n_loops=2.0, drift_rate=DRIFT),
        device="cpu",
    )
    out = []
    for i in range(seq.n_frames):
        f = seq.render_frame(i)
        f["R_w_c"], f["t_w_c"] = seq.odometry_pose(i)
        out.append(f)
    return seq.camera, out


def _run(camera, rendered, cadence, mode):
    spec = copy.deepcopy(PIPELINE)
    spec["run_change_detection_every_n_frames"] = cadence
    pipe = KhronosPipeline(build(PipelineConfig, spec), camera, device="cpu")
    frames = [FrameData(stamp_ns=f["stamp_ns"], depth=f["depth"], color=f["color"], labels=f["labels"],
                        R_w_c=f["R_w_c"], t_w_c=f["t_w_c"]) for f in rendered]
    gts = [(f["R_gt"], f["t_gt"]) for f in rendered]
    outputs = []
    if mode == "inline":
        for f, g in zip(frames, gts):
            pipe.process_frame(f, gt_pose=g)
        pipe.finish()
        return pipe, outputs
    spin = pipe.active_window.spin_once

    def recording_spin(frame):
        out = spin(frame)
        if out is not None:
            outputs.append(out.stamp_ns)
        return out

    pipe.active_window.spin_once = recording_spin
    pipe.start_async()
    for f, g in zip(frames, gts):
        pipe.submit_frame(f, gt_pose=g)
        pipe._bq.join()  # the backend stage has finished this frame's output
        pipe._cdq.join()  # and the CD stage is idle: no trigger is deferred
    pipe.finish_async()
    del pipe.active_window.spin_once
    return pipe, outputs


@pytest.fixture(scope="module")
def runs(rendered):
    camera, frames = rendered
    return {(cadence, mode): _run(camera, frames, cadence, mode) for cadence in (0, 6)
            for mode in ("inline", "start_async")}


def test_loop_closure_passes_equal_inline(runs):
    (pipe, _), (inline, _) = runs[(0, "start_async")], runs[(0, "inline")]
    assert pipe.cd_deferred_triggers == 0 and not pipe._async_errors
    assert not pipe.active_window.defer_object_extraction
    assert pipe.frame_count == inline.frame_count
    assert len(inline.backend.loop_closures) >= 1
    assert pipe.map.stamps() == inline.map.stamps() and pipe.map.num_snapshots >= 2
    a, b = pipe.map.snapshots[-1], inline.map.snapshots[-1]
    assert sorted(a.objects) == sorted(b.objects) and len(b.objects) >= 3
    np.testing.assert_array_equal(a.agent_positions(), b.agent_positions())
    for field in ("vertices", "faces", "first_seen_ns", "last_seen_ns"):
        np.testing.assert_array_equal(getattr(a.mesh, field), getattr(b.mesh, field), err_msg=field)


def test_periodic_passes_are_served_at_the_next_output(runs):
    (pipe, outputs), (inline, _) = runs[(6, "start_async")], runs[(6, "inline")]
    assert pipe.cd_deferred_triggers == 0 and not pipe._async_errors
    got, want = pipe.map.stamps()[:-1], inline.map.stamps()[:-1]  # the last: finish's pass
    assert len(want) >= 3
    assert set(got) <= set(outputs)  # each pass at an output's stamp
    assert len(got) in (len(want), len(want) - 1)  # at most the trigger after the last output is not served
    assert all(g >= w for g, w in zip(got, want))
    assert pipe.map.stamps()[-1] == inline.map.stamps()[-1]


def test_worker_error_surfaces_from_finish_async(rendered):
    camera, frames = rendered
    pipe = KhronosPipeline(build(PipelineConfig, copy.deepcopy(PIPELINE)), camera, device="cpu")

    def broken(*args, **kwargs):
        raise ValueError("backend stage failed")

    pipe.backend.add_output = broken
    pipe.start_async()
    f = frames[0]
    pipe.submit_frame(FrameData(stamp_ns=f["stamp_ns"], depth=f["depth"], color=f["color"], labels=f["labels"],
                                R_w_c=f["R_w_c"], t_w_c=f["t_w_c"]))
    with pytest.raises(ValueError, match="backend stage failed"):
        pipe.finish_async()


def test_checkpoint_after_finish_async(runs, tmp_path):
    """A pipeline that ran in the async mode checkpoints after finish_async
    (its threads and queues are left out) and restores with the same map."""
    pipe = runs[(0, "start_async")][0]
    pipe.checkpoint(str(tmp_path))
    back = KhronosPipeline.restore(str(tmp_path), device="cpu")
    assert back.frame_count == pipe.frame_count and back.map.stamps() == pipe.map.stamps()
    np.testing.assert_array_equal(back.map.snapshots[-1].mesh.vertices, pipe.map.snapshots[-1].mesh.vertices)
