"""Port parity: the active window's host-pull "bus".

The reference batches each frame's packed tracker stats, with the metas of
the mesh emission rounds, into one buffer flushed every `stats_batch_frames`
frames; the tracker sees a whole batch only when that buffer has landed, and
an emission round's triangles reach an output only after the bus carrying
its meta has landed. That schedule decides in which output each finished
track and each mesh delta lands.

On the CPU a port copy is ready at once, so the port follows the reference's
earliest schedule. The reference's readiness depends on its CPU thread pool;
these tests make it deterministic by waiting for each buffer as it is
started (`block_until_ready` around the bus concat and the mesh pulls), which
is the same earliest schedule. The same frames then go through both
windows: the trackers must see the same frames at the same spins, in
batches of `stats_batch_frames`, and every output must carry the same
finished tracks (by observation stamps) and the same number of triangles."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import khronos_tpu.active_window.active_window as jaw_mod
import khronos_tpu.map.meshing as jmeshing
from khronos_tpu.active_window.active_window import ActiveWindow as JWindow
from khronos_tpu.active_window.active_window import ActiveWindowConfig as JConfig
from khronos_tpu.active_window.frame_data import FrameData as JFrame
from khronos_tpu.config import build as jbuild
from khronos_tpu.data import synthetic as jsyn
from khronos_tpu_torch.active_window.active_window import ActiveWindow as TWindow
from khronos_tpu_torch.active_window.active_window import ActiveWindowConfig as TConfig
from khronos_tpu_torch.active_window.frame_data import FrameData as TFrame
from khronos_tpu_torch.config import build as tbuild

from torch_parity import frames, torch_camera, torch_label_space

N_FRAMES = 24
AW_CONFIG = {
    "volumetric_map": {"grid_shape": [48, 48, 32], "voxel_size": 0.1, "recenter_margin": 1.0},
    "detection_stride": 2,
    "motion_detector": {"type": "FreeSpaceMotionDetector", "min_cluster_size": 20},
    "object_detector": {"type": "ConnectedSemantics", "min_cluster_size": 5},
    "tracker": {"type": "MaxIouTracker", "min_num_observations": 2, "temporal_window": 0.5},
    "object_extractor": {"type": "MeshObjectExtractor", "grid_size": 12, "max_frames": 4,
                         "min_num_observations": 2, "min_dynamic_displacement": 0.2,
                         "min_object_volume": 0.001},
}


@pytest.fixture
def reference_earliest_schedule(monkeypatch):
    """Every reference host pull has landed by the time it is polled."""
    concat, body, extract = jaw_mod._bus_concat, jmeshing.start_body_pull, jmeshing.extract_mesh_async
    monkeypatch.setattr(jaw_mod, "_bus_concat", lambda *xs: jax.block_until_ready(concat(*xs)))
    monkeypatch.setattr(jmeshing, "start_body_pull", lambda *a: jax.block_until_ready(body(*a)))
    monkeypatch.setattr(jmeshing, "extract_mesh_async",
                        lambda *a, **k: jax.block_until_ready(extract(*a, **k)))


def _run(aw, make_frame, conv, fr):
    """Per spin: the stamps the tracker processed during it; per output: its
    stamp, its finished tracks' observation stamps, its object count (the
    finish output extracts inline) and its triangle count."""
    seen, spins, outputs = [], [], []
    process = aw.tracker.process

    def recording(frame, *args, **kwargs):
        seen.append(frame.stamp_ns)
        return process(frame, *args, **kwargs)

    aw.tracker.process = recording

    def record(out):
        tracks = sorted(tuple(o.stamp_ns for o in t.observations) for t in out.pending_tracks or [])
        outputs.append((out.stamp_ns, tracks, len(out.objects), len(out.mesh_vertices)))

    for f in fr:
        before = len(seen)
        out = aw.spin_once(make_frame(stamp_ns=f["stamp_ns"], depth=conv(f["depth"]), color=conv(f["color"]),
                                      labels=conv(f["labels"]), R_w_c=f["R_w_c"], t_w_c=f["t_w_c"]))
        spins.append(seen[before:])
        if out is not None:
            record(out)
    before = len(seen)
    last = aw.finish_mapping()
    spins.append(seen[before:])
    record(last)
    return spins, outputs


@pytest.mark.parametrize("batch", [4, 3])
def test_tracker_batches_and_track_landing_match_reference(reference_earliest_schedule, batch):
    cam, fr = frames(N_FRAMES)
    fr = fr[:N_FRAMES]
    ls = jsyn.default_label_space()
    cfg = {**AW_CONFIG, "stats_batch_frames": batch}
    jaw = JWindow(jbuild(JConfig, cfg), cam, ls)
    taw = TWindow(tbuild(TConfig, cfg), torch_camera(cam), torch_label_space(ls), device="cpu")
    jaw.defer_object_extraction = taw.defer_object_extraction = True
    j_spins, j_out = _run(jaw, JFrame, jnp.asarray, fr)
    t_spins, t_out = _run(taw, TFrame, lambda a: torch.from_numpy(np.array(a)), copy.deepcopy(fr))

    # the port's tracker sees frames only at bus boundaries, a whole batch
    # at a time, and the rest at finish
    stamps = [f["stamp_ns"] for f in fr]
    for k, got in enumerate(t_spins[:-1]):
        want = stamps[k + 1 - batch : k + 1] if (k + 1) % batch == 0 else []
        assert got == want, (k, got, want)
    assert t_spins[-1] == stamps[N_FRAMES - N_FRAMES % batch :]
    assert t_spins == j_spins

    # every output carries the finished tracks and the triangles the
    # reference's does
    assert [o[0] for o in t_out] == [o[0] for o in j_out]
    assert [o[1] for o in t_out] == [o[1] for o in j_out]
    assert sum(len(o[1]) for o in t_out) >= 2
    assert [o[2] for o in t_out] == [o[2] for o in j_out]
    assert [o[3] for o in t_out] == [o[3] for o in j_out]
    assert sum(o[3] for o in t_out) > 1000
