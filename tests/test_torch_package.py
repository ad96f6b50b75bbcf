"""The port as a package: no JAX inside, the device rule, one config for both
packages."""

import dataclasses
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from khronos_tpu.active_window.active_window import ActiveWindowConfig as JConfig
from khronos_tpu.config import build as jbuild
from khronos_tpu.config import to_dict as jto_dict
from khronos_tpu_torch.active_window.active_window import ActiveWindow, ActiveWindowConfig
from khronos_tpu_torch.active_window.object_extraction import MeshObjectExtractor, MeshObjectExtractorConfig
from khronos_tpu_torch.backend import factor_graph
from khronos_tpu_torch.backend.backend import Backend, BackendConfig
from khronos_tpu_torch.backend.deformation import DeformationGraph
from khronos_tpu_torch.backend.distributed import optimize_distributed
from khronos_tpu_torch import run as trun
from khronos_tpu_torch.changes.change_detector import RayChangeDetector, RayChangeDetectorConfig
from khronos_tpu_torch.changes.detectors import SequentialChangeDetector, SequentialChangeDetectorConfig
from khronos_tpu_torch.changes.ray_verificator import RayVerificator, RayVerificatorConfig
from khronos_tpu_torch.changes.reconciler import Reconciler, ReconcilerConfig
from khronos_tpu_torch.config import build, to_dict
from khronos_tpu_torch.eval.evaluators import evaluate_mesh, min_distances
from khronos_tpu_torch.eval.pipeline_evaluator import PipelineEvaluator
from khronos_tpu_torch.stm.places import PlacesExtractor
from khronos_tpu_torch.pipeline.pipeline import KhronosPipeline, PipelineConfig
from khronos_tpu_torch.data import synthetic as tsyn
from khronos_tpu_torch.data.datasets import SyntheticDataset
from khronos_tpu_torch.map import active_volume as tav
from khronos_tpu_torch.utils.host_copy import HostCopy

ROOT = pathlib.Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "khronos_tpu_torch"
BENCH = {
    "volumetric_map": {"grid_shape": [160, 160, 48], "voxel_size": 0.1},
    "detection_stride": 2,
    "motion_detector": {"type": "FreeSpaceMotionDetector", "min_cluster_size": 400},
    "object_detector": {"type": "ConnectedSemantics", "min_cluster_size": 50},
    "tracker": {"type": "MaxIouTracker"},
    "object_extractor": {"type": "MeshObjectExtractor"},
}


def test_imports_no_jax():
    """Import every module of the port in a fresh interpreter: neither jax
    nor the JAX package may be loaded. Then scan the sources and
    chip_smoke.py for such imports."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import khronos_tpu_torch as pkg\n"
        "mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, 'khronos_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') or m == 'khronos_tpu' or m.startswith('khronos_tpu.')]\n"
        "assert len(mods) > 30, mods\n"
        "for m in ('backend.backend', 'backend.factor_graph', 'backend.deformation', 'backend.loop_closure',\n"
        "          'stm.scene_graph', 'stm.serialization', 'native', 'geometry.transforms', 'geometry.bbox',\n"
        "          'utils.intervals', 'data.datasets', 'active_window.object_extraction',\n"
        "          'changes.change_state', 'changes.ray_verificator', 'changes.change_detector',\n"
        "          'changes.detectors', 'changes.reconciler', 'eval.evaluators', 'stm.spatio_temporal_map',\n"
        "          'pipeline.pipeline', 'run', 'stm.places', 'eval.pipeline_evaluator', 'eval.plotting',\n"
        "          'eval.viewer', 'eval.ground_truth', 'eval.__main__', 'active_window.instance_forwarding',\n"
        "          'active_window.motion_detection', 'active_window.object_detection',\n"
        "          'backend.registration', 'data.rosbag2', 'pipeline.checkpoint', 'backend.distributed',\n"
        "          'eval.visualizers', 'parallel.sharding', 'parallel.distributed', 'parallel.workers'):\n"
        "    assert 'khronos_tpu_torch.' + m in mods, m\n"
        "assert not bad, bad\n"
        "print(len(mods))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|khronos_tpu)(\s|\.|$)", re.M)
    sources = sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py", ROOT / "bench_torch.py"] + [
        ROOT / "scripts" / f"torch_port_{name}.py" for name in ("endurance", "sharding_cards", "multiprocess_cards")]
    offenders = [str(p) for p in sources if pattern.search(p.read_text())]
    assert not offenders


def test_entry_points_need_a_gpu_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = build(ActiveWindowConfig, {"volumetric_map": {"grid_shape": [16, 16, 8]}})
    seq_cfg = tsyn.SyntheticSequenceConfig(height=8, width=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tav.create(cfg.volumetric_map)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsyn.SyntheticSequence(tsyn.office_scene(), seq_cfg)
    cam = tsyn.SyntheticSequence(tsyn.office_scene(), seq_cfg, device="cpu").camera
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ActiveWindow(cfg, cam, tsyn.default_label_space())
    aw = ActiveWindow(cfg, cam, tsyn.default_label_space(), device="cpu")
    assert aw.state.tsdf.device.type == "cpu"
    assert aw.object_extractor.device.type == "cpu"
    backend_cfg = build(BackendConfig, {"lcd": None})
    pipe_cfg = {"active_window": {"volumetric_map": {"grid_shape": [16, 16, 8]}}, "places": None}
    for make in (lambda d: Backend(backend_cfg, device=d),
                 lambda d: MeshObjectExtractor(MeshObjectExtractorConfig(), cam, device=d),
                 lambda d: DeformationGraph(device=d),
                 lambda d: SyntheticDataset(height=8, width=8, device=d),
                 lambda d: factor_graph.optimize(_one_node_graph(), device=d),
                 lambda d: optimize_distributed(_one_node_graph(), device=d),
                 lambda d: RayVerificator(RayVerificatorConfig(), device=d),
                 lambda d: RayChangeDetector(RayChangeDetectorConfig(), 2.0, device=d),
                 lambda d: SequentialChangeDetector(SequentialChangeDetectorConfig(), device=d),
                 lambda d: Reconciler(ReconcilerConfig(), device=d),
                 lambda d: min_distances(np.zeros((1, 3)), np.ones((1, 3)), device=d),
                 lambda d: evaluate_mesh(np.zeros((1, 3)), np.ones((1, 3)), device=d),
                 lambda d: PlacesExtractor(device=d),
                 lambda d: PipelineEvaluator(device=d),
                 lambda d: KhronosPipeline(build(PipelineConfig, pipe_cfg), cam, device=d),
                 lambda d: KhronosPipeline(build(PipelineConfig, {**pipe_cfg, "places": {}}), cam, device=d)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make(None)
        make("cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trun.main(["--config", str(ROOT / "configs" / "office_synthetic.yaml")])
    from khronos_tpu_torch.eval.__main__ import main as eval_main

    with pytest.raises(RuntimeError, match="device='cpu'"):
        eval_main(["--map", str(ROOT / "final.4dmap.npz")])


def _one_node_graph():
    g = factor_graph.FactorGraphData()
    g.add_node(np.eye(3), np.zeros(3))
    g.add_prior(0, np.eye(3), np.ones(3))
    return g


def test_one_config_builds_both_packages():
    j = jto_dict(jbuild(JConfig, BENCH))
    t = to_dict(build(ActiveWindowConfig, BENCH))
    assert j == t
    with pytest.raises(ValueError):
        build(ActiveWindowConfig, {"no_such_key": 1})


def test_sharded_window_needs_a_gpu_unless_told_cpu(monkeypatch):
    """n_devices >= 1 follows the device rule: without a GPU the window and
    the default mesh raise unless told the CPU, and on the CPU every shard
    lies on the CPU."""
    from khronos_tpu_torch.parallel import sharding

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = build(ActiveWindowConfig, {**BENCH, "volumetric_map": {"grid_shape": [16, 16, 8]}, "n_devices": 2})
    cam = tsyn.SyntheticSequence(tsyn.office_scene(), tsyn.SyntheticSequenceConfig(height=8, width=8), device="cpu").camera
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ActiveWindow(cfg, cam, tsyn.default_label_space())
    with pytest.raises(RuntimeError, match="devices=\\['cpu'\\]"):
        sharding.make_mesh(2)
    aw = ActiveWindow(cfg, cam, tsyn.default_label_space(), device="cpu")
    assert aw.mesh.devices == (torch.device("cpu"),) * 2
    assert [s.tsdf.device.type for s in aw.state.slabs] == ["cpu", "cpu"]


def test_host_copy_on_cpu_is_ready():
    a = torch.arange(6, dtype=torch.int32)
    copy = HostCopy(a, a.float())
    assert copy.ready()
    np.testing.assert_array_equal(copy.numpy(0), np.arange(6))
    assert copy.numpy(1).dtype == np.float32


class _InFlight:
    """A CUDA event's stand-in that has not completed until waited for."""

    def __init__(self):
        self.done = False

    def query(self):
        return self.done

    def synchronize(self):
        self.done = True


@pytest.mark.parametrize("earliest", [False, True])
def test_host_copy_earliest_waits_at_the_first_poll(earliest):
    """A copy made with earliest=True waits for its copies the first time it
    is polled and says it is ready; by default a poll never waits."""
    copy = HostCopy(torch.arange(3), earliest=earliest)
    copy.events = [_InFlight()]
    assert copy.ready() == earliest
    assert copy.events[0].done == earliest


def test_chip_smoke_refuses_without_a_gpu(tmp_path):
    """chip_smoke.py must fail, and print no result line, without CUDA, and
    in a directory that holds it alone."""
    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    res = subprocess.run([sys.executable, str(lone)], cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
