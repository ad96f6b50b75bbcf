"""Live checkpoint / resume in the port (pipeline/checkpoint.py), the cases of
tests/test_checkpoint.py on the port's CPU path.

A run checkpointed at half its frames, deleted and restored must finish with
the same map as an uninterrupted run. The port's CPU path is deterministic,
so the comparison is bit for bit (tolerance 0): the final snapshot's mesh,
objects (ids, boxes, meshes) and agents, the 4D map's snapshot count and
the change evidence. The cut falls while the window's bus holds frames'
tracker stats that have not been flushed and emission rounds whose metas
ride the next bus, so a restore must carry them. The run is
tests/test_torch_pipeline_cd.py's small drifted office with the places layer
on (the reference test's own sequence extracts no object at the port's
size), rendered by the port."""

import os

import numpy as np
import pytest
import torch

from khronos_tpu_torch.active_window.frame_data import FrameData
from khronos_tpu_torch.config import build
from khronos_tpu_torch.data import synthetic as syn
from khronos_tpu_torch.pipeline import checkpoint as ckpt
from khronos_tpu_torch.pipeline.pipeline import ExperimentConfig, ExperimentManager, KhronosPipeline, PipelineConfig
from khronos_tpu_torch.utils.host_copy import HostCopy
from khronos_tpu_torch.utils.logging import ExperimentLogger

import torch_parity  # noqa: F401  (one PyTorch thread per worker)

DURATION, FPS, H, W, DRIFT = 6.0, 4.0, 48, 64, 0.3
# tests/test_torch_pipeline_cd.py's small office run (objects, a loop closure,
# drifted odometry), with the places layer on
PIPELINE = {
    "active_window": {
        "volumetric_map": {"grid_shape": [48, 48, 32], "voxel_size": 0.1, "recenter_margin": 1.0},
        "detection_stride": 2,
        "motion_detector": {"type": "FreeSpaceMotionDetector", "min_cluster_size": 20},
        "object_detector": {"type": "ConnectedSemantics", "min_cluster_size": 5},
        "tracker": {"type": "MaxIouTracker", "min_num_observations": 2},
        "object_extractor": {"type": "MeshObjectExtractor", "grid_size": 12, "max_frames": 4,
                             "min_num_observations": 2, "min_dynamic_displacement": 0.2,
                             "min_object_volume": 0.001},
    },
    "backend": {"lcd": {"type": "GtLoopClosure", "min_time_gap": 2.0, "max_distance": 1.0}},
    "label_space": {"num_classes": 7, "object_labels": [2, 3, 4, 5, 6], "dynamic_labels": [1]},
    "run_change_detection_every_n_frames": 6,
    "change_detection": {"verificator": {"ray_policy": "All", "temporal_resolution": 2.0, "num_bins": 32},
                         "detector": {"window_size": 3, "evidence_prior": 2.0}},
    "places": {},
}


@pytest.fixture(scope="module")
def sequence():
    seq = syn.SyntheticSequence(
        syn.office_scene(DURATION),
        syn.SyntheticSequenceConfig(duration=DURATION, fps=FPS, height=H, width=W, fx=W * 0.625, fy=W * 0.625,
                                    cx=W / 2, cy=H / 2, n_loops=2.0, drift_rate=DRIFT),
        device="cpu",
    )
    rendered = []
    for i in range(seq.n_frames):
        f = seq.render_frame(i)
        f["R_w_c"], f["t_w_c"] = seq.odometry_pose(i)
        rendered.append(f)
    return seq, rendered


def _frames(rendered):
    frames = [FrameData(stamp_ns=f["stamp_ns"], depth=f["depth"], color=f["color"], labels=f["labels"],
                        R_w_c=f["R_w_c"], t_w_c=f["t_w_c"]) for f in rendered]
    return frames, [(f["R_gt"], f["t_gt"]) for f in rendered]


def _config():
    return build(PipelineConfig, PIPELINE)


class Boom(RuntimeError):
    pass


@pytest.fixture(scope="module")
def runs(sequence, tmp_path_factory):
    """An uninterrupted run (ExperimentManager, a checkpoint every 10 frames)
    and a run that crashes at half its frames, leaves its crash checkpoint,
    is deleted, restored and resumed by ExperimentManager.run."""
    seq, rendered = sequence
    frames, gts = _frames(rendered)
    cut = len(frames) // 2 + 1  # not a multiple of stats_batch_frames: stats wait on the bus
    pipe_ref = KhronosPipeline(_config(), seq.camera, device="cpu")
    ref_mgr = ExperimentManager(ExperimentConfig(output_dir=str(tmp_path_factory.mktemp("ref")),
                                                 checkpoint_every_n_frames=10), pipe_ref)
    ref_mgr.run(frames, gts)

    frames, gts = _frames(rendered)
    pipe_a = KhronosPipeline(_config(), seq.camera, device="cpu")
    in_flight = []

    def poisoned():
        for i, f in enumerate(frames):
            if i == cut:
                aw = pipe_a.active_window
                in_flight.extend([len(aw._bus_unflushed), sum(e[3] == "meta_bus" for e in aw._pending_mesh_dev)])
                raise Boom("sensor died")
            yield f

    mgr = ExperimentManager(ExperimentConfig(output_dir=str(tmp_path_factory.mktemp("crash"))), pipe_a, _config())
    with pytest.raises(Boom):
        mgr.run(poisoned(), gts)
    crash_dir = os.path.join(mgr.output_dir, "checkpoint_crash")
    del pipe_a  # "crash"

    pipe_b = KhronosPipeline.restore(crash_dir, device="cpu")
    restored_at = pipe_b.frame_count
    frames, gts = _frames(rendered)
    resumed_out = ExperimentManager(ExperimentConfig(output_dir=str(tmp_path_factory.mktemp("resumed"))),
                                    pipe_b).run(frames, gts)
    return dict(ref=pipe_ref, ref_dir=ref_mgr.output_dir, res=pipe_b, cut=cut, restored_at=restored_at,
                crash_out=mgr.output_dir, crash_dir=crash_dir, resumed_out=resumed_out, in_flight=in_flight,
                n=len(frames))


class TestCheckpointResume:
    def test_frame_count_and_snapshots(self, runs):
        assert runs["restored_at"] == runs["cut"]
        assert runs["res"].frame_count == runs["ref"].frame_count == runs["n"]
        assert runs["res"].map.num_snapshots == runs["ref"].map.num_snapshots >= 3
        assert len(runs["res"].backend.loop_closures) == len(runs["ref"].backend.loop_closures) >= 1

    def test_mesh_identical(self, runs):
        m_ref, m_res = runs["ref"].map.snapshots[-1].mesh, runs["res"].map.snapshots[-1].mesh
        assert m_ref.num_vertices > 1000
        for field in ("vertices", "colors", "labels", "first_seen_ns", "last_seen_ns", "faces"):
            np.testing.assert_array_equal(getattr(m_res, field), getattr(m_ref, field), err_msg=field)

    def test_objects_and_agents_identical(self, runs):
        dsg_ref, dsg_res = runs["ref"].map.snapshots[-1], runs["res"].map.snapshots[-1]
        assert set(dsg_res.objects) == set(dsg_ref.objects) and len(dsg_ref.objects) >= 3
        for oid, o in dsg_ref.objects.items():
            r = dsg_res.objects[oid]
            for field in ("bbox_min", "bbox_max", "mesh_vertices", "mesh_faces", "mesh_colors"):
                np.testing.assert_array_equal(getattr(r, field), getattr(o, field), err_msg=f"{oid} {field}")
        np.testing.assert_array_equal(dsg_res.agent_positions(), dsg_ref.agent_positions())

    def test_change_evidence_preserved(self, runs):
        ch_ref, ch_res = runs["ref"].change_detector.changes, runs["res"].change_detector.changes
        assert set(ch_res.object_changes) == set(ch_ref.object_changes)

    def test_cut_falls_while_bus_pulls_are_in_flight(self, runs):
        unflushed_stats, metas_on_next_bus = runs["in_flight"]
        assert unflushed_stats > 0 and metas_on_next_bus > 0

    def test_checkpoint_exists_api(self, tmp_path):
        assert not ckpt.exists(str(tmp_path))

    def test_manager_periodic_checkpoint(self, runs):
        path = os.path.join(runs["ref_dir"], "checkpoint")
        assert ckpt.exists(path)
        restored = KhronosPipeline.restore(path, device="cpu")
        assert restored.frame_count == runs["n"] - runs["n"] % 10


class TestCrashRecovery:
    def test_crash_writes_resumable_checkpoint(self, runs):
        """An exception mid-run leaves a [FLAG]-logged crash checkpoint that
        ExperimentManager.run resumes from its frame_count and finishes."""
        assert os.path.isdir(runs["crash_dir"])
        assert ExperimentLogger.has_flag(runs["crash_out"], "Experiment Crashed")
        assert runs["res"].map.num_snapshots >= 1
        assert ExperimentLogger.has_flag(runs["resumed_out"], "Experiment Finished Cleanly")


def test_host_copy_pickles_as_a_landed_copy(tmp_path):
    """A host copy in flight pickles as its host arrays and restores ready;
    tensors come back on the CPU with their dtype."""
    import gzip
    import pickle

    copy = HostCopy(torch.arange(6, dtype=torch.int32), torch.ones(2, dtype=torch.float32))
    copy.tag = "scroll_final"
    path = tmp_path / "c.pkl.gz"
    with gzip.open(path, "wb") as fh:
        ckpt._HostPickler(fh).dump({"copy": copy, "t": torch.zeros(3, dtype=torch.int64)})
    ckpt._target.device = torch.device("cpu")
    try:
        with gzip.open(path, "rb") as fh:
            back = pickle.load(fh)
    finally:
        ckpt._target.device = None
    assert back["copy"].ready() and back["copy"].tag == "scroll_final"
    np.testing.assert_array_equal(back["copy"].numpy(0), np.arange(6, dtype=np.int32))
    assert back["t"].dtype == torch.int64 and back["t"].device.type == "cpu"


def test_cpu_checkpoint_restores_on_the_cpu_only(sequence, tmp_path):
    seq, _ = sequence
    cfg = build(PipelineConfig, {"active_window": {"volumetric_map": {"grid_shape": [16, 16, 8]}}, "places": None})
    KhronosPipeline(cfg, seq.camera, device="cpu").checkpoint(str(tmp_path))
    with pytest.raises(ValueError, match="on the CPU only"):
        ckpt.load(str(tmp_path), torch.device("cuda"))


def test_native_accumulator_restores_bit_for_bit():
    """The native mesh accumulator pickles as its mesh and restores the same
    table: its vertex order, stamps and faces, and later additions land the
    same as in the accumulator that was never pickled."""
    import pickle

    from khronos_tpu_torch.native import NativeMeshAccumulator

    rng = np.random.default_rng(0)

    def soup(n):
        v = np.round(rng.uniform(-1, 1, (n, 3, 3)) * 20).astype(np.float32) / 20
        first = rng.integers(0, 10**9, (n, 3)).astype(np.int64)
        return (v, rng.uniform(0, 1, (n, 3, 3)).astype(np.float32), first, first + 5,
                rng.integers(0, 7, (n, 3)).astype(np.int32))

    acc = NativeMeshAccumulator(0.05)
    acc.add_triangles(*soup(400))
    back = pickle.loads(pickle.dumps(acc))
    later = soup(200)
    acc.add_triangles(*later)
    back.add_triangles(*later)
    a, b = acc.build(), back.build()
    assert a.num_faces > 300
    for field in ("vertices", "colors", "labels", "first_seen_ns", "last_seen_ns", "faces"):
        np.testing.assert_array_equal(getattr(b, field), getattr(a, field), err_msg=field)
