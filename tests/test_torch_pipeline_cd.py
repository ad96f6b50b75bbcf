"""Port parity for the slice as a whole: KhronosPipeline with change
detection, the reconciler and the 4D map (places off), in both packages, and
the port's CLI.

The JAX renderer's small office frames (48x64 at 4 fps, 6 s, two orbits),
posed at drifted odometry (the same numbers in both packages), go through
each package's ExperimentManager with GT loop closure and change detection
every 6 frames. The output a mesh delta lands in depends on when the
reference's host pulls land (tests/test_torch_bus.py), so the snapshots that
change detection sees may differ a little between the two runs: the whole runs are held to the
same loop closures, snapshot count, change verdicts and object presence
intervals within one evidence bin. For the strict comparison, the
reference's recorded change-detection requests (snapshot DSG, stamp, loop
closure flag, validated merges) go through the port's
`run_change_detection_on`: Changes and the whole `.4dmap.npz` archive then
equal the reference's bit for bit."""

import copy
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from khronos_tpu.active_window.frame_data import FrameData as JFrame
from khronos_tpu.changes.change_state import Changes as JChanges
from khronos_tpu.config import build as jbuild
from khronos_tpu.config import to_dict as jto_dict
from khronos_tpu.data import synthetic as jsyn
from khronos_tpu.pipeline.pipeline import ExperimentConfig as JExperimentConfig
from khronos_tpu.pipeline.pipeline import ExperimentManager as JManager
from khronos_tpu.pipeline.pipeline import KhronosPipeline as JPipeline
from khronos_tpu.pipeline.pipeline import PipelineConfig as JPipelineConfig
from khronos_tpu.stm.spatio_temporal_map import SpatioTemporalMap as JMap
from khronos_tpu.utils.logging import ExperimentLogger
from khronos_tpu_torch import run as trun
from khronos_tpu_torch.active_window.frame_data import FrameData as TFrame
from khronos_tpu_torch.config import build as tbuild
from khronos_tpu_torch.config import to_dict as tto_dict
from khronos_tpu_torch.data import synthetic as tsyn
from khronos_tpu_torch.pipeline.pipeline import ExperimentConfig as TExperimentConfig
from khronos_tpu_torch.pipeline.pipeline import ExperimentManager as TManager
from khronos_tpu_torch.pipeline.pipeline import KhronosPipeline as TPipeline
from khronos_tpu_torch.pipeline.pipeline import PipelineConfig as TPipelineConfig

from torch_parity import torch_camera, torch_cd_request

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DURATION, FPS, H, W, DRIFT = 6.0, 4.0, 48, 64, 0.3
BIN_S = 2.0
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
    "change_detection": {
        "verificator": {"ray_policy": "All", "temporal_resolution": BIN_S, "num_bins": 32},
        "detector": {"window_size": 3, "evidence_prior": 2.0},
    },
    "places": None,
}


def _sequence_and_frames():
    cfg = dict(duration=DURATION, fps=FPS, height=H, width=W, fx=W * 0.625, fy=W * 0.625, cx=W / 2, cy=H / 2,
               n_loops=2.0, drift_rate=DRIFT)
    jseq = jsyn.SyntheticSequence(jsyn.office_scene(DURATION), jsyn.SyntheticSequenceConfig(**cfg))
    tseq = tsyn.SyntheticSequence(tsyn.office_scene(DURATION), tsyn.SyntheticSequenceConfig(**cfg), device="cpu")
    frames = []
    for i in range(jseq.n_frames):
        f = {k: (np.array(v) if hasattr(v, "shape") else v) for k, v in jseq.render_frame(i).items()}
        R, t = jseq.odometry_pose(i)
        tR, tt = tseq.odometry_pose(i)
        np.testing.assert_array_equal(tR, R)
        np.testing.assert_array_equal(tt, t)
        frames.append((f, np.asarray(R, np.float32), np.asarray(t, np.float32)))
    return jseq.camera, frames


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cam, frames = _sequence_and_frames()
    out = {}
    jcfg, tcfg = jbuild(JPipelineConfig, PIPELINE), tbuild(TPipelineConfig, PIPELINE)
    out["configs"] = (jto_dict(jcfg), tto_dict(tcfg))
    jpipe = JPipeline(jcfg, cam)
    tpipe = TPipeline(tcfg, torch_camera(cam), device="cpu")
    requests = []
    run_cd = jpipe.run_change_detection_on

    def record(*req):
        requests.append(copy.deepcopy(req))
        return run_cd(*req)

    jpipe.run_change_detection_on = record
    gts = [(f["R_gt"], f["t_gt"]) for f, _, _ in frames]
    for name, pipe, manager, make_frame, conv in (
        ("j", jpipe, JManager, JFrame, jnp.asarray), ("t", tpipe, TManager, TFrame, torch.from_numpy)
    ):
        cfg_cls = JExperimentConfig if name == "j" else TExperimentConfig
        run_frames = [make_frame(stamp_ns=f["stamp_ns"], depth=conv(f["depth"]), color=conv(f["color"]),
                                 labels=conv(f["labels"]), R_w_c=R, t_w_c=t) for f, R, t in frames]
        directory = str(tmp_path_factory.mktemp(f"office_{name}"))
        manager(cfg_cls(output_dir=directory), pipe, jcfg if name == "j" else tcfg).run(run_frames, gts)
        out[name] = (pipe, directory)
    out["requests"] = requests
    return out


def test_one_config_builds_both_pipelines(runs):
    j, t = runs["configs"]
    assert j == t and j["places"] is None


def test_runs_agree(runs):
    (jp, jdir), (tp, tdir) = runs["j"], runs["t"]
    for d in (jdir, tdir):
        for f in ("dsg.npz", "final.4dmap.npz", "mesh.ply", "object_changes.csv", "background_changes.csv",
                  "objects.csv", "experiment_log.txt", "config.txt", "t0_ns.txt", "timing/stats.csv"):
            assert os.path.exists(os.path.join(d, f)), f
        assert ExperimentLogger.has_flag(d, "Experiment Finished Cleanly")

    def lc_agents(be):
        return [(be.agent_keys.index(lc.from_key), be.agent_keys.index(lc.to_key)) for lc in be.loop_closures]

    assert lc_agents(tp.backend) == lc_agents(jp.backend) and len(tp.backend.loop_closures) >= 1
    assert tp.map.num_snapshots == jp.map.num_snapshots >= 4
    assert tp.map.stamps() == jp.map.stamps()
    # change verdicts per object: absent before / after, merged
    jc, tc = jp.change_detector.changes.object_changes, tp.change_detector.changes.object_changes
    assert sorted(tc) == sorted(jc) and len(tc) >= 3

    def verdict(oc):
        return (oc.first_absent_ns >= 0, oc.last_absent_ns >= 0, oc.merged_id)

    assert {k: verdict(v) for k, v in tc.items()} == {k: verdict(v) for k, v in jc.items()}
    # presence intervals of the final snapshot's objects, within one bin
    jf, tf = jp.map.snapshots[-1], tp.map.snapshots[-1]
    assert sorted(tf.objects) == sorted(jf.objects)
    for k, jo in jf.objects.items():
        to = tf.objects[k]
        assert len(to.first_observed_ns) == len(jo.first_observed_ns)
        for a, b in zip(to.first_observed_ns + to.last_observed_ns, jo.first_observed_ns + jo.last_observed_ns):
            assert a == b or abs(a - b) <= BIN_S * 1e9, (k, a, b)


def test_reference_requests_give_the_reference_map(runs, tmp_path):
    """The reference run's own change-detection requests through the port:
    the same Changes (CSV bytes) and the same 4D map, archive key for key,
    dtype for dtype, bit for bit; and each package reads the other's files."""
    jp, jdir = runs["j"]
    requests = runs["requests"]
    assert len(requests) == jp.map.num_snapshots and any(r[2] for r in requests)  # a loop-closure pass
    cam = torch_camera(jp.camera)
    tp = TPipeline(tbuild(TPipelineConfig, PIPELINE), cam, device="cpu")
    for req in requests:
        tp.run_change_detection_on(*torch_cd_request(req))
    tdir = str(tmp_path / "t")
    os.makedirs(tdir)
    tp.map.save(os.path.join(tdir, "final.4dmap.npz"))
    tp.change_detector.changes.save(tdir)
    for name in ("object_changes.csv", "background_changes.csv"):
        with open(os.path.join(jdir, name), "rb") as a, open(os.path.join(tdir, name), "rb") as b:
            assert a.read() == b.read(), name
    with np.load(os.path.join(jdir, "final.4dmap.npz")) as j, np.load(os.path.join(tdir, "final.4dmap.npz")) as t:
        assert sorted(j.files) == sorted(t.files)
        for k in j.files:
            assert j[k].dtype == t[k].dtype, k
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    v = tp.change_detector.verificator
    # a rebuild after a solve that moved geometry, a delta index and a merge
    assert v.n_full_builds >= 2 and v.n_delta_updates >= 1 and v.n_merges >= 1
    # each package reads the other's archive and CSVs
    jm = JMap.load(os.path.join(tdir, "final.4dmap.npz"))
    assert jm.stamps() == tp.map.stamps()
    ch = JChanges.load(tdir)
    assert sorted(ch.object_changes) == sorted(tp.change_detector.changes.object_changes)


def test_cli_runs_on_the_cpu(tmp_path):
    """python -m khronos_tpu_torch.run --device cpu on a tiny version of the
    office config: every output file, the finished flag, a 4D map the JAX
    package loads."""
    with open(os.path.join(ROOT, "configs", "office_synthetic.yaml")) as fh:
        base = yaml.safe_load(fh)
    tiny = str(tmp_path / "tiny.yaml")
    with open(tiny, "w") as fh:
        yaml.safe_dump({"pipeline": {"active_window": {"volumetric_map": {"grid_shape": [32, 32, 16]}}},
                        "dataset": {"duration": 2.0, "fps": 5.0, "height": 24, "width": 32}}, fh)
    out_dir = str(tmp_path / "run")
    got = trun.main(["--device", "cpu", "--config", os.path.join(ROOT, "configs", "office_synthetic.yaml"), tiny,
                     "pipeline.places=null", "run.evaluate=false", "run.export_viewer=false",
                     "pipeline.run_change_detection_every_n_frames=4", f"run.output_dir={out_dir}"])
    assert got == out_dir and base["pipeline"]["change_detection"]["verificator"]["ray_policy"] == "All"
    assert ExperimentLogger.has_flag(out_dir, "Experiment Finished Cleanly")
    for f in ("dsg.npz", "final.4dmap.npz", "mesh.ply", "object_changes.csv", "objects.csv"):
        assert os.path.exists(os.path.join(out_dir, f)), f
    assert JMap.load(os.path.join(out_dir, "final.4dmap.npz")).num_snapshots >= 3
