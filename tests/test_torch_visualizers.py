"""Port parity for eval/visualizers.py: the cases of tests/test_visualizers.py,
each held to the reference's own output on the same inputs.

- Colormaps: the same uint8 images, bit for bit.
- ActiveWindowVisualizer (the sink of `ActiveWindow.add_sink`) on both
  packages' active windows over the same frames: the same files, and the
  same PNG panels pixel for pixel.
- The ray inspector on both packages' RayVerificators over one DSG: the same
  rays and classes, depth / radial / ray length within 1e-5 m; the same HTML
  table rows.
- The association SVG: the same counts and the same HTML, byte for byte."""

import os

import numpy as np
import pytest

from khronos_tpu.active_window.active_window import ActiveWindow as JWindow
from khronos_tpu.active_window.active_window import ActiveWindowConfig as JConfig
from khronos_tpu.active_window.frame_data import FrameData as JFrame
from khronos_tpu.active_window.object_detection import LabelSpace as JLabelSpace
from khronos_tpu.changes.ray_verificator import RayVerificator as JVerificator
from khronos_tpu.changes.ray_verificator import RayVerificatorConfig as JVerConfig
from khronos_tpu.config import build as jbuild
from khronos_tpu.data import synthetic as jsyn
from khronos_tpu.eval import visualizers as jvz
from khronos_tpu.eval.evaluators import GtObject as JGt
from khronos_tpu.stm.scene_graph import AgentNode as JAgent
from khronos_tpu.stm.scene_graph import KhronosObject as JObject
from khronos_tpu.stm.scene_graph import Mesh as JMesh
from khronos_tpu.stm.scene_graph import SceneGraph as JGraph
from khronos_tpu_torch.active_window.active_window import ActiveWindow as TWindow
from khronos_tpu_torch.active_window.active_window import ActiveWindowConfig as TConfig
from khronos_tpu_torch.active_window.frame_data import FrameData as TFrame
from khronos_tpu_torch.active_window.object_detection import LabelSpace as TLabelSpace
from khronos_tpu_torch.changes.ray_verificator import RayVerificator as TVerificator
from khronos_tpu_torch.changes.ray_verificator import RayVerificatorConfig as TVerConfig
from khronos_tpu_torch.config import build as tbuild
from khronos_tpu_torch.eval import visualizers as tvz
from khronos_tpu_torch.eval.evaluators import GtObject as TGt
from khronos_tpu_torch.stm.scene_graph import AgentNode as TAgent
from khronos_tpu_torch.stm.scene_graph import KhronosObject as TObject
from khronos_tpu_torch.stm.scene_graph import Mesh as TMesh
from khronos_tpu_torch.stm.scene_graph import SceneGraph as TGraph

import torch
from torch_parity import torch_camera


class TestColormaps:
    def test_depth_colormap_shapes_and_invalid(self):
        d = np.array([[0.5, 2.0], [0.0, np.inf]], np.float32)
        img = tvz.depth_colormap(d, max_range=4.0)
        assert img.shape == (2, 2, 3) and img.dtype == np.uint8
        assert (img[1, 0] == 0).all() and (img[1, 1] == 0).all()  # invalid black
        assert (img[0, 0] != img[0, 1]).any()
        ramp = np.linspace(-1, 8, 4096, dtype=np.float32).reshape(64, 64)
        np.testing.assert_array_equal(tvz.depth_colormap(ramp, 6.0), jvz.depth_colormap(ramp, 6.0))
        np.testing.assert_array_equal(tvz.depth_colormap(d, 4.0), jvz.depth_colormap(d, 4.0))

    def test_id_colormap_background_black_and_distinct(self):
        ids = np.array([[0, 1], [2, 1]])
        img = tvz.id_colormap(ids)
        assert (img[0, 0] == 0).all()
        assert (img[0, 1] == img[1, 1]).all() and (img[0, 1] != img[1, 0]).any()
        many = np.arange(-5, 4091).reshape(64, 64)
        np.testing.assert_array_equal(tvz.id_colormap(many), jvz.id_colormap(many))


class TestActiveWindowVisualizer:
    def test_sink_writes_debug_frames(self, tmp_path):
        """Both packages' windows with the sink attached on the same six
        frames: every 2nd frame written, the same panels."""
        from PIL import Image

        seq = jsyn.SyntheticSequence(jsyn.office_scene(duration=4.0), jsyn.SyntheticSequenceConfig(
            duration=4.0, fps=2.0, height=48, width=64, fx=40.0, fy=40.0, cx=32.0, cy=24.0))
        spec = {"volumetric_map": {"grid_shape": [96, 96, 32], "voxel_size": 0.15}}
        jaw = JWindow(jbuild(JConfig, spec), seq.camera, JLabelSpace(7, (2, 3, 4, 5, 6), (1,)))
        taw = TWindow(tbuild(TConfig, spec), torch_camera(seq.camera), TLabelSpace(7, (2, 3, 4, 5, 6), (1,)),
                      device="cpu")
        for name, aw, vz in (("j", jaw, jvz), ("t", taw, tvz)):
            aw.add_sink(vz.ActiveWindowVisualizer(vz.ActiveWindowVisualizerConfig(
                output_dir=str(tmp_path / name), every_n_frames=2)))
        for i in range(6):
            f = {k: (np.array(v) if hasattr(v, "shape") else v) for k, v in seq.render_frame(i).items()}
            for aw, make, conv in ((jaw, JFrame, np.asarray), (taw, TFrame, torch.from_numpy)):
                aw.spin_once(make(stamp_ns=f["stamp_ns"], depth=conv(f["depth"]), color=conv(f["color"]),
                                  labels=conv(f["labels"]), R_w_c=f["R_w_c"], t_w_c=f["t_w_c"]))
        files = sorted(os.listdir(tmp_path / "t"))
        pngs = [f for f in files if f.endswith(".png")]
        assert len(pngs) == 3 and "index.html" in files
        assert files == sorted(os.listdir(tmp_path / "j"))
        for name in pngs:
            got = np.asarray(Image.open(tmp_path / "t" / name))
            assert got.shape == (48 * 2, 64 * 2, 3)  # 2x2 tiling
            np.testing.assert_array_equal(got, np.asarray(Image.open(tmp_path / "j" / name)), err_msg=name)


def _dsg(agent, mesh, graph):
    dsg = graph()
    n = 6
    for i in range(n):
        dsg.agents.append(agent(int(i * 1e9), np.eye(3), np.array([i * 0.3, 0.0, 0.0]), i))
    verts = np.array([[1.0, 2.0, 0.0], [1.2, 2.0, 0.0], [1.1, 2.1, 0.0]], np.float32)
    dsg.mesh = mesh(vertices=verts, colors=np.zeros_like(verts), labels=np.zeros(3, np.int32),
                    first_seen_ns=np.zeros(3, np.int64), last_seen_ns=np.full(3, int((n - 1) * 1e9), np.int64),
                    faces=np.array([[0, 1, 2]], np.int64))
    return dsg


class TestCdInspector:
    @pytest.fixture(scope="class")
    def verificators(self):
        """Both packages' verificators over one simple DSG: an agent walks +x
        looking at a wall vertex."""
        j = JVerificator(JVerConfig(ray_policy="All", active_window_duration=0.0))
        j.build(_dsg(JAgent, JMesh, JGraph))
        t = TVerificator(TVerConfig(ray_policy="All", active_window_duration=0.0), device="cpu")
        t.build(_dsg(TAgent, TMesh, TGraph))
        assert j._built and t._built
        return j, t

    @staticmethod
    def _assert_same_rays(got, want):
        assert [(e["ray"], e["cls"]) for e in got] == [(e["ray"], e["cls"]) for e in want]
        for g, w in zip(got, want):
            assert g["stamp_s"] == w["stamp_s"]
            for k in ("depth", "radial", "ray_len"):
                assert g[k] == pytest.approx(w[k], abs=1e-5), k
            np.testing.assert_allclose(g["origin"] + g["target"], w["origin"] + w["target"], rtol=0, atol=1e-5)

    def test_inspect_point_on_surface_matches(self, verificators):
        j, t = verificators
        rays = tvz.inspect_point(t, np.array([1.0, 2.0, 0.0]))
        assert rays and any(e["cls"] == "match" for e in rays)
        for e in rays:
            assert e["cls"] in ("match", "absent", "occluded", "no_overlap") and e["stamp_s"] >= 0.0
        self._assert_same_rays(rays, jvz.inspect_point(j, np.array([1.0, 2.0, 0.0])))

    def test_inspect_point_in_front_is_absent(self, verificators):
        j, t = verificators
        rays = tvz.inspect_point(t, np.array([1.0, 1.0, 0.0]))
        self._assert_same_rays(rays, jvz.inspect_point(j, np.array([1.0, 1.0, 0.0])))
        if rays:  # the point's cell must be traversed by some ray
            assert any(e["cls"] in ("absent", "no_overlap") for e in rays)

    def test_export_html(self, verificators, tmp_path):
        j, t = verificators
        point = np.array([1.0, 2.0, 0.0])
        rays = tvz.export_point_inspection(t, point, str(tmp_path / "t.html"))
        jvz.export_point_inspection(j, point, str(tmp_path / "j.html"))
        html = open(tmp_path / "t.html").read()
        assert "<svg" in html and str(rays[0]["ray"]) in html

        def rows(text):
            return text[text.index("<table"):text.index("</table>")]

        assert rows(html) == rows(open(tmp_path / "j.html").read())


class TestEvalVisualizer:
    def test_association_svg(self, tmp_path):
        def est_obj(cls, oid, center, cat=2):
            c = np.asarray(center, np.float32)
            return cls(node_id=oid, semantic_category=cat, bbox_min=c - 0.2, bbox_max=c + 0.2,
                       mesh_vertices=np.zeros((0, 3), np.float32), mesh_faces=np.zeros((0, 3), np.int64),
                       mesh_colors=np.zeros((0, 3), np.float32), first_observed_ns=[0],
                       last_observed_ns=[10**10])

        def gt(cls):
            return [
                cls(1, 2, np.array([1.05, 1.0, 0.0]), np.array([0.8, 0.8, -0.2]), np.array([1.3, 1.2, 0.2])),
                cls(2, 3, np.array([3.0, 3.0, 0.0]), np.array([2.8, 2.8, -0.2]), np.array([3.2, 3.2, 0.2])),
            ]

        out = {}
        for name, vz, obj, g in (("j", jvz, JObject, JGt), ("t", tvz, TObject, TGt)):
            est = [est_obj(obj, 1, [1, 1, 0]), est_obj(obj, 2, [5, 5, 0])]  # the 2nd hallucinated
            path = str(tmp_path / f"{name}.html")
            out[name] = (vz.export_association_svg(est, gt(g), 10**9, path), open(path).read())
        stats, html = out["t"]
        assert stats == {"num_est": 2, "num_gt": 2, "detected": 1, "missed": 1, "hallucinated": 1}
        assert "<svg" in html and "hallucinated" in html
        assert out["t"] == out["j"]
