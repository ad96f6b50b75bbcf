"""Port parity for the slice as a whole: active window -> finalize_output
(object extraction) -> backend, in both packages.

The JAX renderer's small office frames, posed at drifted odometry (the same
random walk in both packages: numpy's generator from the seed), go through
each package's ActiveWindow with deferred extraction; each output runs
finalize_output and then Backend.add_output with its ground-truth pose, and
the run ends with finish_mapping, finish_processing and get_dsg. A small
min_time_gap makes the GT loop closure fire on the second orbit, and the
drift makes its solve move the map.

Tolerances: the finished tracks are identical (tests/test_torch_slice.py),
so the outputs carry the same objects: the same ids, categories, presence
and trajectory stamps, trajectory positions within 1e-5 m (the cluster
centroids carry the fused step's float rounding, a few ulp), bboxes within
1e-4 m and triangle counts within 2% (the TSDF of the small grids agrees to
ulps, tests/test_torch_extraction.py). The
background mesh differs by a quantisation step on about 1% of the triangles
(tests/test_torch_slice.py), so its vertex count agrees within 1% and the
control points within a step; the backend then fires the same loop closures,
runs the same solves, with agent positions within 1e-3 m. Fed the
reference window's outputs, the port's backend also bumps the same epochs
and deforms the mesh to within 1e-3 m."""

import copy

import jax.numpy as jnp
import numpy as np
import torch

from khronos_tpu.active_window.active_window import ActiveWindow as JWindow
from khronos_tpu.active_window.active_window import ActiveWindowConfig as JConfig
from khronos_tpu.active_window.frame_data import FrameData as JFrame
from khronos_tpu.backend.backend import Backend as JBackend
from khronos_tpu.backend.backend import BackendConfig as JBackendConfig
from khronos_tpu.config import build as jbuild
from khronos_tpu.data import synthetic as jsyn
from khronos_tpu_torch.active_window.active_window import ActiveWindow as TWindow
from khronos_tpu_torch.active_window.active_window import ActiveWindowConfig as TConfig
from khronos_tpu_torch.active_window.frame_data import FrameData as TFrame
from khronos_tpu_torch.backend.backend import Backend as TBackend
from khronos_tpu_torch.backend.backend import BackendConfig as TBackendConfig
from khronos_tpu_torch.config import build as tbuild
from khronos_tpu_torch.data import synthetic as tsyn

from torch_parity import frames, torch_camera, torch_label_space, torch_output

N_FRAMES = 24
DRIFT = 0.5
AW_CONFIG = {
    "volumetric_map": {"grid_shape": [48, 48, 32], "voxel_size": 0.1, "recenter_margin": 1.0},
    "detection_stride": 2,
    "stats_batch_frames": 1,
    "motion_detector": {"type": "FreeSpaceMotionDetector", "min_cluster_size": 20},
    "object_detector": {"type": "ConnectedSemantics", "min_cluster_size": 5},
    "tracker": {"type": "MaxIouTracker", "min_num_observations": 2, "temporal_window": 0.5},
    "object_extractor": {"type": "MeshObjectExtractor", "grid_size": 12, "max_frames": 4,
                         "min_num_observations": 2, "min_dynamic_displacement": 0.2,
                         "min_object_volume": 0.001},  # the small frames see a sliver of the shelf
}
BACKEND_CONFIG = {"lcd": {"type": "GtLoopClosure", "min_time_gap": 1.0, "max_distance": 1.0,
                          "min_detection_separation": 0.5}}


def _odometry():
    """Drifted odometry poses of the frames: the JAX sequence's and the
    port's, which must be the same numbers."""
    duration = N_FRAMES / 10.0 + 1.0
    kw = dict(duration=duration, fps=10.0, height=8, width=8, drift_rate=DRIFT)
    jseq = jsyn.SyntheticSequence(jsyn.office_scene(duration=duration), jsyn.SyntheticSequenceConfig(**kw))
    tseq = tsyn.SyntheticSequence(tsyn.office_scene(duration=duration), tsyn.SyntheticSequenceConfig(**kw),
                                  device="cpu")
    poses = [jseq.odometry_pose(i) for i in range(N_FRAMES)]
    for i, (R, t) in enumerate(poses):
        tR, tt = tseq.odometry_pose(i)
        np.testing.assert_array_equal(tR, R)
        np.testing.assert_array_equal(tt, t)
    return poses


def _run(aw, be, make_frame, conv, fr, odo):
    outputs = []

    def hand_off(out, gt):
        aw.finalize_output(out)
        outputs.append((copy.deepcopy(out), gt))
        be.add_output(out, gt_pose=gt)

    for f, (R, t) in zip(fr, odo):
        frame = make_frame(stamp_ns=f["stamp_ns"], depth=conv(f["depth"]), color=conv(f["color"]),
                           labels=conv(f["labels"]), R_w_c=R, t_w_c=t)
        out = aw.spin_once(frame)
        if out is not None:
            hand_off(out, (f["R_gt"], f["t_gt"]))
    hand_off(aw.finish_mapping(frame), (fr[-1]["R_gt"], fr[-1]["t_gt"]))
    be.finish_processing()
    return outputs, be.get_dsg()


def test_window_extraction_and_backend_match_reference():
    cam, fr = frames(N_FRAMES)
    fr = fr[:N_FRAMES]
    odo = _odometry()
    ls = jsyn.default_label_space()
    jaw = JWindow(jbuild(JConfig, AW_CONFIG), cam, ls)
    taw = TWindow(tbuild(TConfig, AW_CONFIG), torch_camera(cam), torch_label_space(ls), device="cpu")
    jaw.defer_object_extraction = taw.defer_object_extraction = True
    jb = JBackend(jbuild(JBackendConfig, BACKEND_CONFIG))
    tb = TBackend(tbuild(TBackendConfig, BACKEND_CONFIG), device="cpu")
    j_out, j_dsg = _run(jaw, jb, JFrame, jnp.asarray, fr, odo)
    t_out, t_dsg = _run(taw, tb, TFrame, torch.from_numpy, fr, odo)

    # the same outputs, carrying the same objects
    assert [o.stamp_ns for o, _ in t_out] == [o.stamp_ns for o, _ in j_out]
    j_objs = [ob for o, _ in j_out for ob in o.objects]
    t_objs = [ob for o, _ in t_out for ob in o.objects]
    assert any(ob.is_dynamic for ob in t_objs) and any(len(ob.mesh_faces) for ob in t_objs)
    assert len(t_objs) == len(j_objs)
    for a, b in zip(j_objs, t_objs):
        assert (b.node_id, b.semantic_category, b.first_observed_ns, b.last_observed_ns, b.trajectory_stamps_ns) == (
            a.node_id, a.semantic_category, a.first_observed_ns, a.last_observed_ns, a.trajectory_stamps_ns)
        np.testing.assert_allclose(b.trajectory_positions, a.trajectory_positions, rtol=0, atol=1e-5)
        np.testing.assert_allclose(b.bbox_min, a.bbox_min, rtol=0, atol=1e-4)
        np.testing.assert_allclose(b.bbox_max, a.bbox_max, rtol=0, atol=1e-4)
        assert abs(len(b.mesh_faces) - len(a.mesh_faces)) <= 0.02 * max(len(a.mesh_faces), 1)
    assert all(o.pending_tracks is None for o, _ in t_out)
    assert not taw._inflight_tracks and not jaw._inflight_tracks
    j_tris = sum(len(o.mesh_vertices) for o, _ in j_out)
    assert sum(len(o.mesh_vertices) for o, _ in t_out) == j_tris > 1000

    # each backend on its own window's outputs: the same loop closures (as
    # agent indices: graph keys interleave agents with control nodes, which
    # arrive with the mesh deltas, and a delta joins the first output after
    # the bus carrying its meta has landed: at once in the port on the CPU,
    # when the reference's thread pool has finished it in the reference),
    # solves and agent trajectory
    def lc_agents(be):
        return [(be.agent_keys.index(lc.from_key), be.agent_keys.index(lc.to_key)) for lc in be.loop_closures]

    assert lc_agents(tb) == lc_agents(jb) and len(tb.loop_closures) >= 1
    assert tb.num_optimizations == jb.num_optimizations >= 2
    assert t_dsg.opt_epoch >= 1 and j_dsg.opt_epoch >= 1
    assert sorted(t_dsg.objects) == sorted(j_dsg.objects)
    assert tb.deformation.num_controls == jb.deformation.num_controls
    np.testing.assert_allclose(t_dsg.agent_positions(), j_dsg.agent_positions(), rtol=0, atol=1e-3)
    assert np.abs(t_dsg.mesh.vertices - tb.mesh_acc.build().vertices).max() > 0.01  # the solve moved the map

    # the port's backend on the reference window's outputs: the reference's
    # backend, within the tolerances of tests/test_torch_backend.py
    tb2 = TBackend(tbuild(TBackendConfig, BACKEND_CONFIG), device="cpu")
    for out, gt in j_out:
        tb2.add_output(torch_output(out), gt_pose=gt)
    tb2.finish_processing()
    t2_dsg = tb2.get_dsg()
    assert [(lc.from_key, lc.to_key) for lc in tb2.loop_closures] == [(lc.from_key, lc.to_key) for lc in jb.loop_closures]
    assert (tb2.num_optimizations, t2_dsg.opt_epoch) == (jb.num_optimizations, j_dsg.opt_epoch)
    assert [(p.from_id, p.into_id, p.is_valid, p.validated) for p in tb2.proposed_merges] == [
        (p.from_id, p.into_id, p.is_valid, p.validated) for p in jb.proposed_merges]
    np.testing.assert_array_equal(t2_dsg.mesh.faces, j_dsg.mesh.faces)
    np.testing.assert_allclose(t2_dsg.mesh.vertices, j_dsg.mesh.vertices, rtol=0, atol=1e-3)
    np.testing.assert_allclose(t2_dsg.agent_positions(), j_dsg.agent_positions(), rtol=0, atol=1e-3)
    for oid, jo in j_dsg.objects.items():
        np.testing.assert_allclose(t2_dsg.objects[oid].bbox_min, jo.bbox_min, rtol=0, atol=1e-3)
