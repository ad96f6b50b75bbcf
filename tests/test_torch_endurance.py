"""Port parity for the endurance run's operating point
(scripts/torch_port_endurance.py against scripts/endurance.py).

The corridor scene and camera path of both scripts, at 60x80 frames with a
48x48x32 grid, 60 frames at 5 frames/s (out and back, so loop closures
fire), solver "schur", the cluster sizes cut to this image size, inline so
the host-pull schedule is fixed, in both packages on the same frames (the
reference's renderer): the same loop closures and number of solves, the
Schur-solved agents within 1e-4 m (the dense solver's bar), the same change
verdicts, the same count of changed background vertices, and the same
snapshot count;
and the scripts' scene, camera path, pipeline config and flag defaults
equal, the reference's taken from scripts/endurance.py's own source (its
camera path and config are nested in its main). At this size neither
package flags the corridor's removed box (no object change, no changed
background vertex)."""

import os
import sys

import jax
import numpy as np
import pytest
import torch

from khronos_tpu.active_window.frame_data import FrameData as JFrame
from khronos_tpu.config import build as jbuild
from khronos_tpu.data import synthetic as jsyn
from khronos_tpu.pipeline.pipeline import KhronosPipeline as JPipeline
from khronos_tpu.pipeline.pipeline import PipelineConfig as JPipelineConfig
from khronos_tpu_torch.active_window.frame_data import FrameData as TFrame
from khronos_tpu_torch.config import build as tbuild
from khronos_tpu_torch.pipeline.pipeline import KhronosPipeline as TPipeline
from khronos_tpu_torch.pipeline.pipeline import PipelineConfig as TPipelineConfig

from torch_parity import torch_camera

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))
import endurance as jendurance  # noqa: E402
import torch_port_endurance as tendurance  # noqa: E402


def _reference_main():
    """The parts of scripts/endurance.py's main the port must copy, from its
    source: (pose_at(duration), the unbound CorridorSequence.pose_at;
    config(args), the dict main passes to build; parser(), an ArgumentParser
    with main's add_argument calls)."""
    import argparse
    import ast
    import inspect
    import textwrap

    main = next(n for n in ast.parse(inspect.getsource(jendurance)).body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    cls = next(n for n in ast.walk(main) if isinstance(n, ast.ClassDef) and n.name == "CorridorSequence")
    pose = next(n for n in cls.body if isinstance(n, ast.FunctionDef) and n.name == "pose_at")
    spec = next(n for n in ast.walk(main) if isinstance(n, ast.Call) and getattr(n.func, "id", None) == "build").args[1]
    flags = [ast.unparse(n) for n in ast.walk(main) if isinstance(n, ast.Call)
             and isinstance(n.func, ast.Attribute) and n.func.attr == "add_argument"]
    ns = dict(vars(jendurance))
    exec("def pose_at_factory(duration):\n" + textwrap.indent(ast.unparse(pose), "    ") + "\n    return pose_at\n", ns)

    def config(args):
        return eval(ast.unparse(spec), dict(vars(jendurance)), {"args": args})

    def parser():
        ap = argparse.ArgumentParser()
        for call in flags:
            eval(call, {}, {"ap": ap})
        return ap

    return ns["pose_at_factory"], config, parser


REF_POSE_AT, REF_CONFIG, REF_PARSER = _reference_main()


def _feed(rendered, make, conv):
    frames = [make(stamp_ns=f["stamp_ns"], depth=conv(f["depth"]), color=conv(f["color"]), labels=conv(f["labels"]),
                   R_w_c=f["R_w_c"], t_w_c=f["t_w_c"]) for f in rendered]
    return frames, [(f["R_gt"], f["t_gt"]) for f in rendered]


CORRIDOR_FRAMES, CORRIDOR_FPS = 60, 5.0


@pytest.fixture(scope="module")
def corridor_runs():
    duration = CORRIDOR_FRAMES / CORRIDOR_FPS
    length = tendurance.SPEED * duration / 2.0

    class JCorridor(jsyn.SyntheticSequence):
        pose_at = REF_POSE_AT(duration)

    H, W = 60, 80
    jseq = JCorridor(jendurance.corridor_scene(length, duration), jsyn.SyntheticSequenceConfig(
        duration=duration, fps=CORRIDOR_FPS, height=H, width=W, fx=W * 0.625, fy=W * 0.625, cx=W / 2, cy=H / 2))
    rendered = [{k: (np.array(v) if hasattr(v, "shape") else v) for k, v in jseq.render_frame(i).items()}
                for i in range(CORRIDOR_FRAMES)]
    specs = [REF_CONFIG(_args(grid=[48, 48, 32], cd_every=10, all_cap=8)),
             tendurance.pipeline_config([48, 48, 32], cd_every=10, all_cap=8)]
    for spec in specs:
        spec["active_window"]["motion_detector"]["min_cluster_size"] = 20
        spec["active_window"]["object_detector"]["min_cluster_size"] = 5
    jpipe = JPipeline(jbuild(JPipelineConfig, specs[0]), jseq.camera)
    tpipe = TPipeline(tbuild(TPipelineConfig, specs[1]), torch_camera(jseq.camera), device="cpu")
    for pipe, make, conv in ((jpipe, JFrame, jax.numpy.asarray), (tpipe, TFrame, torch.from_numpy)):
        frames, gts = _feed(rendered, make, conv)
        for f, g in zip(frames, gts):
            pipe.process_frame(f, gt_pose=g)
        pipe.finish()
    return jpipe, tpipe, jseq


def _args(**flags):
    import types

    return types.SimpleNamespace(**flags)


def test_corridor_scene_and_pose_match_reference(corridor_runs):
    """Scene arrays and the camera path bit for bit, out and back (both
    sides of the turn at duration / 2)."""
    jseq = corridor_runs[2]
    duration = CORRIDOR_FRAMES / CORRIDOR_FPS
    tseq = tendurance.corridor_sequence(CORRIDOR_FRAMES, CORRIDOR_FPS, 60, 80, "cpu")
    for t in [*np.linspace(0, duration, 9), duration / 2 + 1e-3]:
        for a, b in zip(jseq.scene.device_arrays(t), tseq.scene.host_arrays(t)):
            np.testing.assert_array_equal(np.asarray(a), b)
        got, want = tseq.pose_at(t), jseq.pose_at(t)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)


def test_operating_point_config_and_flags_match_reference():
    """The port's pipeline config equals the dict the reference's main builds,
    at the default flags and at the test's; the shared flags' defaults are
    the reference's (the port adds --device and writes under build/)."""
    ref, port = vars(REF_PARSER().parse_args([])), vars(tendurance.parser().parse_args([]))
    assert set(ref) == set(port) - {"device"}
    assert {k: v for k, v in port.items() if k not in ("device", "out")} == {k: v for k, v in ref.items() if k != "out"}
    for flags in (ref, {"grid": [48, 48, 32], "cd_every": 10, "all_cap": 8}):
        assert tendurance.pipeline_config(flags["grid"], flags["cd_every"], flags["all_cap"]) == REF_CONFIG(_args(**flags))


def test_corridor_schur_run_matches_reference(corridor_runs):
    jp, tp, _ = corridor_runs

    def lc_agents(be):
        return [(be.agent_keys.index(lc.from_key), be.agent_keys.index(lc.to_key)) for lc in be.loop_closures]

    assert lc_agents(tp.backend) == lc_agents(jp.backend) and len(tp.backend.loop_closures) >= 1
    assert tp.backend.num_optimizations == jp.backend.num_optimizations >= 1
    assert tp.backend.config.solver == jp.backend.config.solver == "schur"
    jd, td = jp.backend.get_dsg(), tp.backend.get_dsg()
    np.testing.assert_allclose(td.agent_positions(), jd.agent_positions(), rtol=0, atol=1e-4)


def test_corridor_changes_match_reference(corridor_runs):
    jp, tp, _ = corridor_runs
    jc, tc = jp.change_detector.changes.object_changes, tp.change_detector.changes.object_changes

    def verdict(oc):
        return (oc.first_absent_ns >= 0, oc.last_absent_ns >= 0, oc.merged_id)

    assert sorted(tc) == sorted(jc)
    assert {k: verdict(v) for k, v in tc.items()} == {k: verdict(v) for k, v in jc.items()}
    jb, tb = jp.change_detector.changes.background_states, tp.change_detector.changes.background_states
    # the same changed background vertices (the meshes differ in a few
    # vertices: the meshing's quantisation rounding, tests/test_torch_slice.py)
    assert np.count_nonzero(tb) == np.count_nonzero(np.asarray(jb))
    assert abs(len(tb) - len(jb)) <= 1e-3 * len(jb)
    assert tp.map.num_snapshots == jp.map.num_snapshots >= 5
