"""The port as a package: no JAX inside, the device rule, one config for both
packages, and the options this slice leaves out."""

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
from khronos_tpu_torch.config import build, to_dict
from khronos_tpu_torch.data import synthetic as tsyn
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
        "assert len(mods) > 20, mods\n"
        "assert not bad, bad\n"
        "print(len(mods))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|khronos_tpu)(\s|\.|$)", re.M)
    sources = sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py"]
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


def test_one_config_builds_both_packages():
    j = jto_dict(jbuild(JConfig, BENCH))
    t = to_dict(build(ActiveWindowConfig, BENCH))
    assert j == t
    with pytest.raises(ValueError):
        build(ActiveWindowConfig, {"no_such_key": 1})


@pytest.mark.parametrize(
    "override",
    [{"n_devices": 1}, {"fused": False}],
)
def test_unported_options_raise(override):
    cfg = build(ActiveWindowConfig, {**BENCH, "volumetric_map": {"grid_shape": [16, 16, 8]}, **override})
    cam = tsyn.SyntheticSequence(tsyn.office_scene(), tsyn.SyntheticSequenceConfig(height=8, width=8), device="cpu").camera
    with pytest.raises(NotImplementedError):
        ActiveWindow(cfg, cam, tsyn.default_label_space(), device="cpu")


def test_modular_parts_and_extraction_raise():
    cfg = build(ActiveWindowConfig, {**BENCH, "volumetric_map": {"grid_shape": [16, 16, 8]}})
    cam = tsyn.SyntheticSequence(tsyn.office_scene(), tsyn.SyntheticSequenceConfig(height=8, width=8), device="cpu").camera
    for plugin, args in ((cfg.motion_detector, (cfg.volumetric_map, cam)),
                         (cfg.object_detector, (cfg.volumetric_map, cam, tsyn.default_label_space())),
                         (cfg.object_extractor, (cam,))):
        with pytest.raises(NotImplementedError):
            plugin.create(*args)
    aw = ActiveWindow(cfg, cam, tsyn.default_label_space(), device="cpu")
    with pytest.raises(NotImplementedError):
        aw.finalize_output(None)


def test_host_copy_on_cpu_is_ready():
    a = torch.arange(6, dtype=torch.int32)
    copy = HostCopy(a, a.float())
    assert copy.ready()
    np.testing.assert_array_equal(copy.numpy(0), np.arange(6))
    assert copy.numpy(1).dtype == np.float32


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
