"""Port parity for the slice as a whole: the active window.

The JAX ActiveWindow (deferred object extraction, tracker fed every frame)
and the port's ActiveWindow run the same synthetic office frames at detection
stride 2 through scrolls, periodic archived-surface emission and
finish_mapping. The sequence of finished tracks must be identical.

Mesh: both emit the same number of triangles. The quantised triangles are
compared as sets: the port reproduces the volume's integer state bit for
bit, but tsdf and color carry the reference's einsum rounding (a few ulp, see
tests/torch_parity.py), and a vertex sitting on a quantisation boundary can
then round to the neighbouring 16-bit step. So at least 95% of the triangles
must be bit-identical (measured: 98.8%), and each remaining reference triangle
must have a port triangle with the same labels and stamps whose vertices lie
within 1.5 quantisation steps and whose colors lie within 1.5/255."""

import numpy as np
import jax.numpy as jnp
import torch

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

GRID = [48, 48, 32]
CONFIG = {
    # a 1 m recenter margin makes the orbiting camera scroll the grid
    "volumetric_map": {"grid_shape": GRID, "voxel_size": 0.1, "recenter_margin": 1.0},
    "detection_stride": 2,
    "stats_batch_frames": 1,
    "motion_detector": {"type": "FreeSpaceMotionDetector", "min_cluster_size": 20},
    "object_detector": {"type": "ConnectedSemantics", "min_cluster_size": 5},
    "tracker": {"type": "MaxIouTracker", "min_num_observations": 2, "temporal_window": 0.5},
    "object_extractor": {"type": "MeshObjectExtractor"},
}


def _run(aw, make_frame, conv, fr):
    finished = []
    process, finish = aw.tracker.process, aw.tracker.finish

    def record(fn):
        def wrapped(*a, **k):
            out = fn(*a, **k)
            finished.extend(out)
            return out
        return wrapped

    aw.tracker.process, aw.tracker.finish = record(process), record(finish)
    outputs = []
    origin0 = None
    for f in fr:
        frame = make_frame(
            stamp_ns=f["stamp_ns"], depth=conv(f["depth"]), color=conv(f["color"]),
            labels=conv(f["labels"]), R_w_c=f["R_w_c"], t_w_c=f["t_w_c"],
        )
        out = aw.spin_once(frame)
        origin0 = aw._origin_np.copy() if origin0 is None else origin0
        if out is not None:
            outputs.append(out)
    outputs.append(aw.finish_mapping(frame))
    assert (aw._origin_np != origin0).any()  # the run scrolled
    tris = np.concatenate([
        np.concatenate([
            o.mesh_vertices.reshape(-1, 9).astype(np.float64),
            o.mesh_colors.reshape(-1, 9).astype(np.float64),
            o.mesh_labels.astype(np.float64),
            o.mesh_first_ns.astype(np.float64),
            o.mesh_last_ns.astype(np.float64),
        ], axis=1)
        for o in outputs
    ])
    return finished, outputs, tris


def _key(t):
    return (t.track_id, t.is_dynamic, t.first_seen_ns, t.last_seen_ns,
            tuple(o.stamp_ns for o in t.observations), t.semantic_category)


def test_active_window_matches_reference():
    cam, fr = frames(24)
    ls = jsyn.default_label_space()
    jaw = JWindow(jbuild(JConfig, CONFIG), cam, ls)
    jaw.defer_object_extraction = True
    # object extraction has tests of its own (test_torch_extraction.py,
    # test_torch_pipeline.py): keep both extractors out of this comparison
    # (finish_mapping would otherwise run them inline), recording the tracks
    # the port's finish_mapping hands to its extractor
    jaw.object_extractor.extract_all = lambda tracks, buffer: []
    taw = TWindow(tbuild(TConfig, CONFIG), torch_camera(cam), torch_label_space(ls), device="cpu")
    taw.defer_object_extraction = True
    extracted = []
    taw.object_extractor.extract_all = lambda tracks, buffer: extracted.extend(tracks) or []

    j_tracks, _, j_tris = _run(jaw, JFrame, jnp.asarray, fr)
    t_tracks, t_outputs, t_tris = _run(taw, TFrame, torch.from_numpy, fr)

    assert len(j_tracks) > 0 and any(t.is_dynamic for t in j_tracks)
    assert [_key(t) for t in j_tracks] == [_key(t) for t in t_tracks]
    # the port hands every finished track out on pending_tracks, in order,
    # and extracts the last ones inline at finish_mapping
    handed = [t for o in t_outputs for t in (o.pending_tracks or [])] + extracted
    assert [id(t) for t in handed] == [id(t) for t in t_tracks]
    assert all(o.objects == [] for o in t_outputs)

    assert len(j_tris) == len(t_tris) > 1000
    j_set = {r.tobytes(): r for r in j_tris}
    t_set = {r.tobytes(): r for r in t_tris}
    exact = len(j_set.keys() & t_set.keys()) / len(j_set)
    assert exact >= 0.95, exact
    rest_t = np.array([t_set[k] for k in t_set.keys() - j_set.keys()])
    step = max(GRID) * 0.1 / 65535.0
    for k in j_set.keys() - t_set.keys():
        r = j_set[k]
        same = (rest_t[:, 18:] == r[18:]).all(1)  # labels and stamps
        near = (np.abs(rest_t[:, :9] - r[:9]) <= 1.5 * step).all(1)
        close = (np.abs(rest_t[:, 9:18] - r[9:18]) <= 1.5 / 255).all(1)
        assert (same & near & close).any()
