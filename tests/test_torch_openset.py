"""Port parity: the open-set path and the two new configs.

- The fused step's open-set branch (InstanceForwarding with max_instances
  <= MC): the JAX renderer's small apartment frames, with their instance
  images and embeddings, through both packages' steps from one start state,
  with and without background embeddings. Id images and the exact packed
  fields bit for bit; bbox extremes within 1e-6 m and centroid sums within
  rtol 1e-5 (tests/test_torch_fused_step.py); the states as in
  tests/torch_parity.assert_states_match.
- `unpack_stats(..., features=, openset=True)` bit for bit.
- Modular against fused in the port, as tests/test_openset.py does it: the
  same number of semantic clusters in every frame, at the same centroids
  (to 0.1 m), each with its feature.
- A small open-set pipeline (modular path: max_instances 64 > MC) in both
  packages: the same static objects with the same features, which survive
  into the saved .4dmap.npz and match the scene's instance features.
- The port's CLI with --device cpu on the apartment and open-set configs at
  a small size: the finished flag and every output file; the open-set
  config builds no fused step, and with max_instances=32 it does.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from khronos_tpu.active_window import fused_step as jfs
from khronos_tpu.active_window.frame_data import FrameData as JFrame
from khronos_tpu.config import build as jbuild
from khronos_tpu.data import synthetic as jsyn
from khronos_tpu.map import active_volume as jav
from khronos_tpu.pipeline.pipeline import ExperimentConfig as JExpConfig
from khronos_tpu.pipeline.pipeline import ExperimentManager as JManager
from khronos_tpu.pipeline.pipeline import KhronosPipeline as JPipeline
from khronos_tpu.pipeline.pipeline import PipelineConfig as JPipelineConfig
from khronos_tpu_torch import run as trun
from khronos_tpu_torch.active_window import fused_step as tfs
from khronos_tpu_torch.active_window.active_window import ActiveWindow as TWindow
from khronos_tpu_torch.active_window.active_window import ActiveWindowConfig as TConfig
from khronos_tpu_torch.active_window.frame_data import FrameData as TFrame
from khronos_tpu_torch.active_window.instance_forwarding import OPENSET_CATEGORY, InstanceForwardingConfig
from khronos_tpu_torch.config import build as tbuild
from khronos_tpu_torch.config import load_mapping
from khronos_tpu_torch.data import synthetic as tsyn
from khronos_tpu_torch.map import active_volume as tav
from khronos_tpu_torch.pipeline.pipeline import ExperimentConfig as TExpConfig
from khronos_tpu_torch.pipeline.pipeline import ExperimentManager as TManager
from khronos_tpu_torch.pipeline.pipeline import KhronosPipeline as TPipeline
from khronos_tpu_torch.pipeline.pipeline import PipelineConfig as TPipelineConfig
from khronos_tpu_torch.stm.spatio_temporal_map import SpatioTemporalMap as TMap
from khronos_tpu_torch.utils.logging import ExperimentLogger

from test_torch_fused_step import _assert_packed
from torch_parity import H, W, assert_states_match, torch_camera, torch_label_space

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRID = [48, 48, 32]


def _apartment(duration=6.0, fps=5.0):
    cfg = jsyn.SyntheticSequenceConfig(duration=duration, fps=fps, height=H, width=W,
                                       fx=W * 0.625, fy=W * 0.625, cx=W / 2, cy=H / 2)
    return jsyn.SyntheticSequence(jsyn.apartment_scene(duration), cfg)


def _frames(seq, n):
    out = []
    for i in range(n):
        f = seq.render_frame(i)
        out.append({k: (np.array(v) if hasattr(v, "shape") else v) for k, v in f.items()})
    return out


def _feature_rows(f, dim=32):
    feats = np.zeros((tfs.MC, dim), np.float32)
    n = min(len(f["features"]), tfs.MC)
    feats[:n] = f["features"][:n, :dim]
    return feats


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("background", [False, True])
def test_fused_openset_step_matches_reference(background, stride):
    seq = _apartment()
    cam, fr = seq.camera, _frames(seq, 8)
    ls = jsyn.default_label_space()
    bg = None
    if background:  # the first seen instance's own embedding is a background prompt
        first = int(np.unique(fr[0]["instances"][fr[0]["instances"] > 0])[0])
        bg = np.stack([seq.instance_features()[first - 1], -seq.instance_features()[-1]])
    od = dict(min_cluster_size=10, max_instances=32, feature_dim=32)
    md = dict(min_cluster_size=20)
    vj, vt = jav.VolumeConfig(grid_shape=GRID), tav.VolumeConfig(grid_shape=GRID)
    from khronos_tpu.active_window.instance_forwarding import InstanceForwardingConfig as JIF
    from khronos_tpu.active_window.motion_detection import FreeSpaceMotionDetectorConfig as JMD
    from khronos_tpu_torch.active_window.motion_detection import FreeSpaceMotionDetectorConfig as TMD

    jstep = jfs.make_frame_step(vj, cam, JMD(**md), JIF(**od), ls, detection_stride=stride, donate=False,
                                background_embeddings=bg, feature_dim=32)
    tstep = tfs.make_frame_step(vt, torch_camera(cam), TMD(**md), InstanceForwardingConfig(**od),
                                torch_label_space(ls), detection_stride=stride, background_embeddings=bg)
    origin = np.floor(fr[0]["t_w_c"] / 0.1 - np.asarray(GRID) / 2.0).astype(np.int32)
    js = jav.create(vj)._replace(origin=jnp.asarray(origin))
    ts = tav.state_from_numpy([np.asarray(a) for a in js], device="cpu")
    kept = dropped = 0
    for f in fr:
        feats = _feature_rows(f)
        js, jd, jo, jp = jstep(js, jnp.asarray(f["depth"]), jnp.asarray(f["color"]), jnp.asarray(f["labels"]),
                               jnp.asarray(f["instances"]), jnp.asarray(feats), f["R_w_c"], f["t_w_c"],
                               jnp.float32(f["t"]))
        ts, td, to, tp = tstep(ts, torch.from_numpy(f["depth"]), torch.from_numpy(f["color"]),
                               torch.from_numpy(f["labels"]), torch.from_numpy(f["instances"]),
                               torch.from_numpy(feats), f["R_w_c"], f["t_w_c"], f["t"])
        np.testing.assert_array_equal(np.asarray(jd), td.numpy())
        np.testing.assert_array_equal(np.asarray(jo), to.numpy())
        _assert_packed(np.asarray(jp), tp.numpy())
        kept += int(to.max())
        if background:
            dropped += int(((f["instances"][::stride, ::stride] == first) & (to.numpy()[::stride, ::stride] == 0)).any())
    assert_states_match(js, ts)
    assert kept > 0
    assert dropped > 0 or not background


def test_unpack_openset_stats_matches_reference():
    rng = np.random.default_rng(5)
    n = tfs.MC * 24 + 2 * tfs.MC * tfs.K_SAMPLES * 3
    packed = rng.normal(size=n).astype(np.float32)
    stats = packed[: tfs.MC * 24].reshape(2 * tfs.MC, 12)
    stats[:, 9] = rng.integers(0, 200, 2 * tfs.MC)
    stats[:, 10] = rng.integers(-1, 40, 2 * tfs.MC)  # instance index, some beyond the features
    stats[:, 11] = np.where(rng.random(2 * tfs.MC) < 0.5, rng.integers(1, 20, 2 * tfs.MC), 0)
    features = rng.normal(size=(30, 32)).astype(np.float32)
    want = jfs.unpack_stats(packed, features=features, openset=True)
    got = tfs.unpack_stats(packed, features=features, openset=True)
    assert len(got[1]) == len(want[1]) > 0
    for a, b in zip(want[1], got[1]):
        assert (b.cluster_id, b.num_pixels, b.category_id) == (a.cluster_id, a.num_pixels, a.category_id)
        assert b.category_id == OPENSET_CATEGORY
        assert (a.feature is None) == (b.feature is None)
        if a.feature is not None:
            np.testing.assert_array_equal(b.feature, a.feature)
    assert any(c.feature is None for c in got[1]) and any(c.feature is not None for c in got[1])


def _openset_window(fused):
    cfg = tbuild(TConfig, {
        "volumetric_map": {"grid_shape": [64, 64, 32], "voxel_size": 0.1},
        "fused": fused,
        "motion_detector": None,
        "object_detector": {"type": "InstanceForwarding", "min_cluster_size": 10, "max_instances": 32},
        "tracker": {"type": "MaxIouTracker", "min_num_observations": 3},
        "object_extractor": {"type": "MeshObjectExtractor", "min_num_observations": 3, "max_frames": 8},
    })
    seq = tsyn.SyntheticSequence(tsyn.apartment_scene(6.0), tsyn.SyntheticSequenceConfig(
        duration=6.0, fps=5.0, height=H, width=W, fx=W * 0.625, fy=W * 0.625, cx=W / 2, cy=H / 2), device="cpu")
    return seq, TWindow(cfg, seq.camera, tsyn.default_label_space(), device="cpu")


def test_modular_matches_fused_in_port():
    seq, fused = _openset_window(True)
    _, modular = _openset_window(False)
    assert fused._fused_step is not None and fused._openset_fused
    assert modular._fused_step is None
    f_frames, m_frames = [], []
    for i in range(8):
        f = seq.render_frame(i)
        for aw, keep in ((fused, f_frames), (modular, m_frames)):
            fr = TFrame(stamp_ns=f["stamp_ns"], depth=f["depth"], color=f["color"], labels=f["labels"],
                        R_w_c=f["R_w_c"], t_w_c=f["t_w_c"], instances=f["instances"], label_features=f["features"])
            aw.spin_once(fr)
            keep.append(fr)
    fused._flush_tracker_queue()
    compared = 0
    for a, b in zip(f_frames, m_frames):
        assert len(a.semantic_clusters) == len(b.semantic_clusters)
        for c in a.semantic_clusters:
            assert c.category_id == OPENSET_CATEGORY and c.feature is not None and c.feature.shape == (32,)
        assert sorted(round(float(c.centroid[0]), 1) for c in a.semantic_clusters) == sorted(
            round(float(c.centroid[0]), 1) for c in b.semantic_clusters)
        compared += len(a.semantic_clusters)
    assert compared >= 3


OPENSET_PIPELINE = {
    "active_window": {
        "volumetric_map": {"grid_shape": GRID, "voxel_size": 0.1},
        "motion_detector": {"type": "FreeSpaceMotionDetector", "min_cluster_size": 20},
        "object_detector": {"type": "InstanceForwarding", "min_cluster_size": 10},
        "tracker": {"type": "ExternalTracker", "min_num_observations": 3},
        "object_extractor": {"type": "MeshObjectExtractor", "min_num_observations": 3, "max_frames": 8},
    },
    "backend": {"lcd": {"type": "GtLoopClosure", "min_time_gap": 3.0, "max_distance": 1.0}},
    "label_space": {"num_classes": 7, "object_labels": [2, 3, 4, 5, 6], "dynamic_labels": [1]},
    "places": None,
    "run_change_detection_every_n_frames": 10,
}


def test_openset_pipeline_matches_reference_and_keeps_features(tmp_path):
    seq = _apartment(duration=8.0)
    fr = _frames(seq, seq.n_frames)
    gts = [(f["R_gt"], f["t_gt"]) for f in fr]
    jp = JPipeline(jbuild(JPipelineConfig, OPENSET_PIPELINE), seq.camera)
    tp = TPipeline(tbuild(TPipelineConfig, OPENSET_PIPELINE), torch_camera(seq.camera), device="cpu")
    assert jp.active_window._fused_step is None and tp.active_window._fused_step is None
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")

    def frame(make, conv, f):
        return make(stamp_ns=f["stamp_ns"], depth=conv(f["depth"]), color=conv(f["color"]),
                    labels=conv(f["labels"]), R_w_c=f["R_w_c"], t_w_c=f["t_w_c"],
                    instances=conv(f["instances"]), label_features=f["features"])

    JManager(JExpConfig(output_dir=jdir), jp).run([frame(JFrame, jnp.asarray, f) for f in fr], gts)
    TManager(TExpConfig(output_dir=tdir), tp).run([frame(TFrame, torch.from_numpy, f) for f in fr], gts)
    for d in (jdir, tdir):
        assert ExperimentLogger.has_flag(d, "Experiment Finished Cleanly")

    def static_objects(dsg):
        return sorted((o for o in dsg.objects.values() if not o.is_dynamic), key=lambda o: o.node_id)

    jobjs = static_objects(jp.map.get_dsg(jp.map.latest_ns()))
    tobjs = static_objects(tp.map.get_dsg(tp.map.latest_ns()))
    assert [o.node_id for o in tobjs] == [o.node_id for o in jobjs]
    assert [o.semantic_category for o in tobjs] == [o.semantic_category for o in jobjs]
    for a, b in zip(jobjs, tobjs):
        assert (a.feature is None) == (b.feature is None)
        if a.feature is not None:
            np.testing.assert_array_equal(b.feature, a.feature)
    feats = [o.feature for o in tobjs if o.feature is not None]
    assert feats, "no open-set object kept its embedding"
    lib = seq.instance_features()
    for f in feats:
        assert (lib @ (f / np.linalg.norm(f))).max() > 0.99
    saved = TMap.load(os.path.join(tdir, "final.4dmap.npz"))
    final = saved.get_dsg(saved.latest_ns())
    kept = {o.node_id: o.feature for o in final.objects.values() if o.feature is not None}
    for o in tobjs:
        if o.feature is not None:
            np.testing.assert_array_equal(kept[o.node_id], o.feature)


TINY = ["dataset.duration=3.0", "dataset.height=48", "dataset.width=64",
        "pipeline.active_window.volumetric_map.grid_shape=[48,48,32]",
        "pipeline.run_change_detection_every_n_frames=10"]
RESULT_FILES = ("background_mesh.csv", "static_objects.csv", "dynamic_objects.csv", "changes.csv")


@pytest.mark.parametrize("config", ["apartment_synthetic", "openset_synthetic"])
def test_cli_runs_new_configs_on_the_cpu(config, tmp_path):
    out_dir = str(tmp_path / config)
    path = os.path.join(ROOT, "configs", f"{config}.yaml")
    assert trun.main(["--device", "cpu", "--config", path, *TINY, f"run.output_dir={out_dir}"]) == out_dir
    assert ExperimentLogger.has_flag(out_dir, "Experiment Finished Cleanly")
    for f in ("dsg.npz", "final.4dmap.npz", "mesh.ply", "viewer.html", "gt.npz"):
        assert os.path.exists(os.path.join(out_dir, f)), f
    for f in RESULT_FILES:
        assert os.path.exists(os.path.join(out_dir, "results", f)), f
    stm = TMap.load(os.path.join(out_dir, "final.4dmap.npz"))
    assert stm.num_snapshots >= 1 and len(stm.get_dsg(stm.latest_ns()).mesh.vertices) > 0


@pytest.mark.parametrize("max_instances,fused", [(None, False), (32, True)])
def test_openset_config_path(max_instances, fused):
    """openset_synthetic.yaml leaves max_instances at 64 > MC: the modular
    path; at 32 it takes the fused open-set branch."""
    over = [] if max_instances is None else [f"pipeline.active_window.object_detector.max_instances={max_instances}"]
    data = load_mapping([os.path.join(ROOT, "configs", "openset_synthetic.yaml")],
                        ["pipeline.active_window.volumetric_map.grid_shape=[16,16,8]", *over])
    cfg = tbuild(TPipelineConfig, data["pipeline"])
    cam = tsyn.SyntheticSequence(tsyn.apartment_scene(), tsyn.SyntheticSequenceConfig(height=8, width=8),
                                 device="cpu").camera
    aw = TWindow(cfg.active_window, cam, cfg.label_space.create(), device="cpu")
    assert (aw._fused_step is not None) == fused and aw._openset_fused == fused
