"""Port parity for the backend: backend/factor_graph.py, deformation.py,
loop_closure.py (GtLoopClosure), backend.py and stm/serialization.py.

The same host inputs go to both packages (graphs and active-window outputs
rebuilt in the port's types by tests/torch_parity.py). Tolerances:
- `optimize` (tests/test_factor_graph.py's graphs): node positions and
  rotations within 1e-4, outlier masks equal. Both run float32 LM/GNC from
  the same start; the Jacobians agree to about 1e-5 of their size
  (tests/test_torch_geometry.py) and the dense solves round differently, so
  the iterates drift apart by a few ulp a step, and an LM step may stop one
  iteration earlier or later.
- `_deform_points`: within 1e-5 m (the matmul-identity distance rounds
  differently; equal distances may pick neighbours in another order).
- `Backend` (tests/test_backend.py's TestBackend and TestGeometryEpoch
  scenarios): the same loop closures, solves, geometry epochs, merge
  proposals and their verdicts, outlier masks and mesh sizes; agent
  positions and deformed vertices within 1e-3 m (the card is held to the
  port's CPU path with the same numbers in chip_smoke.py).
- `dsg.npz`: each package reads what the other writes, exactly."""

import copy
import csv
import dataclasses

import numpy as np
import pytest
import torch

from khronos_tpu.backend import deformation as jdef
from khronos_tpu.backend import factor_graph as jfg
from khronos_tpu.backend.backend import Backend as JBackend
from khronos_tpu.backend.backend import BackendConfig as JBackendConfig
from khronos_tpu.backend.loop_closure import GtLoopClosureConfig as JGtConfig
from khronos_tpu.backend.loop_closure import LoopClosure as JLoopClosure
from khronos_tpu.config import build as jbuild
from khronos_tpu.geometry import transforms as jtf
from khronos_tpu.stm import serialization as jser
from khronos_tpu.stm.scene_graph import KhronosObject as JObject
from khronos_tpu_torch.backend import deformation as tdef
from khronos_tpu_torch.backend import factor_graph as tfg
from khronos_tpu_torch.backend.backend import Backend as TBackend
from khronos_tpu_torch.backend.backend import BackendConfig as TBackendConfig
from khronos_tpu_torch.backend.loop_closure import GtLoopClosureConfig as TGtConfig
from khronos_tpu_torch.backend.loop_closure import LoopClosure as TLoopClosure
from khronos_tpu_torch.config import build as tbuild
from khronos_tpu_torch.stm import serialization as tser

from test_backend import make_orbit, make_output
from test_factor_graph import circle_poses, relative
from torch_parity import torch_graph, torch_object, torch_output

POSE_ATOL = 1e-4
BACKEND_ATOL = 1e-3  # m


# ----------------------------------------------------------------------------
# factor graph
# ----------------------------------------------------------------------------


def _prior_only():
    g = jfg.FactorGraphData()
    g.add_node(np.eye(3), np.zeros(3))
    c, s = np.cos(0.3), np.sin(0.3)
    g.add_prior(0, np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32), np.array([1.0, 2.0, 3.0]))
    return g, dict(gnc_enabled=False, max_iterations=10)


def _loop_closure():
    n = 30
    gt = circle_poses(n)
    rng = np.random.default_rng(0)
    g = jfg.FactorGraphData()
    est = [gt[0]]
    g.add_node(*gt[0])
    for k in range(1, n):
        Rrel, trel = relative(*gt[k - 1], *gt[k])
        trel_n = trel + rng.normal(0, 0.06, 3)
        est.append((est[-1][0] @ Rrel, est[-1][0] @ trel_n + est[-1][1]))
        g.add_node(*est[-1])
        g.add_between(k - 1, k, Rrel, trel_n, sigma_rot=0.01, sigma_trans=0.06)
    g.add_prior(0, *gt[0])
    for a, b in [(n - 1, 0), (n - 2, 0), (n - 1, 1), (n - 2, 1)]:
        g.add_between(a, b, *relative(*gt[a], *gt[b]), sigma_rot=0.005, sigma_trans=0.01)
    return g, dict(gnc_enabled=False, max_iterations=30)


def _gnc_outlier():
    n = 20
    gt = circle_poses(n)
    rng = np.random.default_rng(1)
    g = jfg.FactorGraphData()
    for k in range(n):
        g.add_node(*gt[k])
    g.add_prior(0, *gt[0])
    for k in range(1, n):
        Rrel, trel = relative(*gt[k - 1], *gt[k])
        g.add_between(k - 1, k, Rrel, trel + rng.normal(0, 0.005, 3), sigma_rot=0.01, sigma_trans=0.02)
    g.add_between(n - 1, 0, *relative(*gt[n - 1], *gt[0]), sigma_rot=0.01, sigma_trans=0.02, robust=True)
    g.add_between(5, 15, np.eye(3), np.array([4.0, -3.0, 1.0]), sigma_rot=0.01, sigma_trans=0.02, robust=True)
    return g, {}


def _shadow():
    n = 8
    gt = circle_poses(n)
    g = jfg.FactorGraphData()
    for k in range(n):
        g.add_node(*gt[k])
    g.add_prior(0, *gt[0])
    for k in range(1, n):
        g.add_between(k - 1, k, *relative(*gt[k - 1], *gt[k]), sigma_trans=0.05)
    g.add_between(0, n // 2, np.eye(3), np.zeros(3), sigma_trans=0.2, sigma_rot=0.2, robust=True, shadow=True)
    a = g.add_node(np.eye(3), np.array([9.0, 0, 0]))
    b = g.add_node(np.eye(3), np.array([9.1, 0, 0]))
    g.add_between(0, a, *relative(*gt[0], np.eye(3), np.array([9.0, 0, 0])), sigma_trans=0.01)
    g.add_between(0, b, *relative(*gt[0], np.eye(3), np.array([9.1, 0, 0])), sigma_trans=0.01)
    g.add_between(a, b, np.eye(3), np.zeros(3), sigma_trans=0.2, sigma_rot=0.2, robust=True, shadow=True)
    return g, {}


def _drifted_chain_with_robust_loop():
    """GNC annealing from mu > 64: odometry drifted 0.5 m, one robust loop."""
    n = 24
    gt = circle_poses(n)
    g = jfg.FactorGraphData()
    for k in range(n):
        g.add_node(gt[k][0], gt[k][1] + np.asarray([0.02 * k, 0.0, 0.0], np.float32))
    g.add_prior(0, *gt[0])
    for k in range(1, n):
        Rrel, trel = relative(*gt[k - 1], *gt[k])
        g.add_between(k - 1, k, Rrel, trel + np.asarray([0.02, 0.0, 0.0]), sigma_trans=0.05)
    g.add_between(n - 1, 0, *relative(*gt[n - 1], *gt[0]), sigma_trans=0.02, sigma_rot=0.005, robust=True)
    return g, {}


GRAPHS = {"prior_only": _prior_only, "loop_closure": _loop_closure, "gnc_outlier": _gnc_outlier,
          "shadow": _shadow, "gnc_anneal": _drifted_chain_with_robust_loop}


@pytest.mark.parametrize("name", list(GRAPHS))
def test_optimize_matches_reference(name):
    g, cfg = GRAPHS[name]()
    want = jfg.optimize(g, jfg.OptimizerConfig(**cfg))
    got = tfg.optimize(torch_graph(g), tfg.OptimizerConfig(**cfg), device="cpu")
    np.testing.assert_allclose(got.node_t, want.node_t, rtol=0, atol=POSE_ATOL)
    np.testing.assert_allclose(got.node_R, want.node_R, rtol=0, atol=POSE_ATOL)
    np.testing.assert_array_equal(got.outlier_mask, want.outlier_mask)
    assert got.final_error == pytest.approx(want.final_error, rel=1e-3, abs=1e-3)
    if name == "gnc_outlier":
        assert got.outlier_mask[-1] and not got.outlier_mask[-2]


def test_optimize_is_deterministic_and_ignores_node_padding():
    """Two runs give the same bits. The reference padded nodes to powers of
    two with decoupled unit-prior blocks; padding the port's graph the same
    way leaves the real nodes within float noise, which is why the port
    drops the padding."""
    g, cfg = _gnc_outlier()
    tg = torch_graph(g)
    a = tfg.optimize(tg, tfg.OptimizerConfig(**cfg), device="cpu")
    b = tfg.optimize(torch_graph(g), tfg.OptimizerConfig(**cfg), device="cpu")
    np.testing.assert_array_equal(a.node_t, b.node_t)
    np.testing.assert_array_equal(a.node_R, b.node_R)
    padded = copy.deepcopy(tg)
    n = padded.num_nodes
    for k in range(32 - n):
        padded.add_node(np.eye(3), np.zeros(3))
        padded.add_prior(n + k, np.eye(3), np.zeros(3), sigma_rot=1.0, sigma_trans=1.0)
    c = tfg.optimize(padded, tfg.OptimizerConfig(**cfg), device="cpu")
    np.testing.assert_allclose(c.node_t[:n], a.node_t, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(c.outlier_mask, a.outlier_mask)


def test_linearize_matches_reference():
    """One GN step on the loop-closure graph: delta and error."""
    g, _ = _loop_closure()
    N = g.num_nodes
    node_R, node_t = np.stack(g.node_R), np.stack(g.node_t)
    arr = lambda x, dt=np.float32: np.asarray(x, dt)  # noqa: E731
    b_w = np.ones(g.num_between, np.float32)
    jd, je = jfg._linearize_and_solve(
        node_R, node_t, arr(g.b_i, np.int32), arr(g.b_j, np.int32), np.stack(g.b_R), np.stack(g.b_t),
        np.stack(g.b_sqrt_info), b_w, arr(g.p_i, np.int32), np.stack(g.p_R), np.stack(g.p_t),
        np.stack(g.p_sqrt_info), np.float32(1e-4), N)
    f = tfg._factors(torch_graph(g), "cpu")
    td, te = tfg._linearize_and_solve(torch.from_numpy(node_R), torch.from_numpy(node_t), f,
                                      torch.from_numpy(b_w), 1e-4)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=1e-4 * float(np.abs(jd).max()))
    assert float(te) == pytest.approx(float(je), rel=1e-5)
    errs_j = jfg._between_errors(node_R, node_t, arr(g.b_i, np.int32), arr(g.b_j, np.int32), np.stack(g.b_R),
                                 np.stack(g.b_t), np.stack(g.b_sqrt_info))
    errs_t = tfg._between_errors(torch.from_numpy(node_R), torch.from_numpy(node_t), f)
    np.testing.assert_allclose(errs_t.numpy(), np.asarray(errs_j), rtol=1e-4, atol=1e-4)
    Rj, tj = jfg._apply_delta(node_R, node_t, jd)
    Rt, tt = tfg._apply_delta(torch.from_numpy(node_R), torch.from_numpy(node_t), torch.from_numpy(np.array(jd)))
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), rtol=0, atol=2e-6)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), rtol=0, atol=2e-5)


# ----------------------------------------------------------------------------
# deformation
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 4])
def test_deform_points_matches_reference(k):
    rng = np.random.default_rng(k)
    pts = rng.uniform(-5, 5, (500, 3)).astype(np.float32)
    ctrl = rng.uniform(-5, 5, (40, 3)).astype(np.float32)
    ctrl_R = np.asarray(jtf.so3_exp(rng.normal(0, 0.05, (40, 3)).astype(np.float32)))
    ctrl_new = ctrl + rng.normal(0, 0.2, (40, 3)).astype(np.float32)
    want = np.asarray(jdef._deform_points(pts, ctrl, ctrl_R, ctrl_new, k))
    got = tdef._deform_points(*(torch.from_numpy(a) for a in (pts, ctrl, ctrl_R, ctrl_new)), k).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_deformation_graph_matches_reference():
    """DeformationGraph.deform_points over more points than one chunk, with
    the identity short-circuit returning the input array itself."""
    rng = np.random.default_rng(7)
    ctrl = rng.uniform(-4, 4, (12, 3)).astype(np.float32)
    jg, tg = jdef.DeformationGraph(), tdef.DeformationGraph(device="cpu")
    tg.CHUNK = 1000  # several chunks at a test's size
    for i, p in enumerate(ctrl):
        jg.add_control(p, i)
        tg.add_control(p, i)
    pts = rng.uniform(-4, 4, (2500, 3)).astype(np.float32)
    eye = np.tile(np.eye(3, dtype=np.float32), (12, 1, 1))
    assert tg.deform_points(pts, eye, ctrl, eye, ctrl) is pts
    shift = ctrl + rng.normal(0, 0.1, (12, 3)).astype(np.float32)
    np.testing.assert_allclose(tg.deform_points(pts, eye, shift, eye, ctrl),
                               jg.deform_points(pts, eye, shift, eye, ctrl), rtol=0, atol=1e-5)
    assert (tdef.sample_control_points(pts, 2.5, existing=ctrl) == jdef.sample_control_points(pts, 2.5, existing=ctrl)).all()


def test_interpolate_stamped_corrections_matches_reference():
    rng = np.random.default_rng(8)
    keys = np.sort(rng.integers(0, 10**10, 20)).astype(np.int64)
    q = rng.integers(-10**9, 11 * 10**9, 50).astype(np.int64)
    t_old, t_new = rng.normal(size=(20, 3)), rng.normal(size=(20, 3))
    R = np.tile(np.eye(3), (20, 1, 1))
    for a, b in zip(jdef.interpolate_stamped_corrections(q, keys, t_old, t_new, R, R),
                    tdef.interpolate_stamped_corrections(q, keys, t_old, t_new, R, R)):
        np.testing.assert_array_equal(a, b)


# ----------------------------------------------------------------------------
# loop closure
# ----------------------------------------------------------------------------


def test_gt_loop_closure_matches_reference():
    gt, _ = make_orbit(60)
    cfg = dict(min_time_gap=5.0, max_distance=1.0, min_detection_separation=2.0)
    jd, td = JGtConfig(**cfg).create(), TGtConfig(**cfg).create()
    fired = 0
    for k, (R, t) in enumerate(gt):
        jl = jd.add_keyframe(k, int(k * 4e8), R, t)
        tl = td.add_keyframe(k, int(k * 4e8), R, t)
        assert [(l.from_key, l.to_key) for l in jl] == [(l.from_key, l.to_key) for l in tl]
        for a, b in zip(jl, tl):
            np.testing.assert_allclose(b.R, a.R, rtol=0, atol=1e-6)
            np.testing.assert_allclose(b.t, a.t, rtol=0, atol=1e-6)
        fired += len(tl)
    assert fired >= 2


# ----------------------------------------------------------------------------
# the backend
# ----------------------------------------------------------------------------


def _obj(cls, center, t0_s, t1_s, label=3):
    c = np.asarray(center, np.float32)
    return cls(node_id=0, semantic_category=label, bbox_min=c - 0.3, bbox_max=c + 0.3,
               first_observed_ns=[int(t0_s * 1e9)], last_observed_ns=[int(t1_s * 1e9)],
               mesh_vertices=np.zeros((0, 3), np.float32), mesh_faces=np.zeros((0, 3), np.int64),
               mesh_colors=np.zeros((0, 3), np.float32))


def _orbit_feed(n, lc=True, with_mesh=lambda k: True, objects=lambda k: [], gt_odometry=False, stamp=4e8):
    gt, odom = make_orbit(n)
    odo = gt if gt_odometry else odom
    return [(make_output(int(k * stamp), odo[k], gt[k], with_mesh=with_mesh(k), objects=objects(k)), gt[k])
            for k in range(n)]


def _moving_object(k, gt_pose, odo_pose):
    world = np.array([4.0, 0.0, 0.5], np.float32)
    p = odo_pose[0] @ (gt_pose[0].T @ (world - gt_pose[1])) + odo_pose[1]
    return [_obj(JObject, p, k * 0.4, k * 0.4 + 1.0, label=2)]


def _scenario(name):
    """(config dict, [(JAX output, gt pose)], [actions after the feed])"""
    lcd = {"type": "GtLoopClosure", "min_time_gap": 5.0, "max_distance": 1.0}
    if name == "loop_closure_improves_map":
        return {"lcd": lcd, "sigma_odom_trans": 0.02}, _orbit_feed(40), []
    if name == "objects_move_with_correction":
        gt, odom = make_orbit(30)
        feed = [(make_output(int(k * 4e8), odom[k], gt[k], with_mesh=(k % 3 == 0),
                             objects=_moving_object(k, gt[k], odom[k]) if k == 10 else []), gt[k])
                for k in range(30)]
        return {"lcd": {"type": "GtLoopClosure", "min_time_gap": 4.0}}, feed, ["finish_processing"]
    if name == "merge_proposals":
        gt, odom = make_orbit(4)
        objs = {0: [(0, 5, [1, 1, 0.3])], 1: [(10, 15, [1.05, 1.0, 0.3])], 2: [(12, 20, [1.0, 1.05, 0.3])]}
        stamps = [0, 8e9, 9e9]
        feed = [(make_output(int(stamps[k]), odom[k], gt[k], with_mesh=False,
                             objects=[_obj(JObject, c, a, b) for a, b, c in objs[k]]), gt[k]) for k in range(3)]
        return {"lcd": None, "merge_min_iou": 0.2}, feed, ["optimize"]
    if name == "identity_solves_keep_epoch":
        return {"lcd": None}, _orbit_feed(20, gt_odometry=True), ["optimize", "optimize"]
    if name == "object_only_motion_keeps_epoch":
        def objects(k):
            return {2: [_obj(JObject, [2, 1, 0.3], 2, 3)], 12: [_obj(JObject, [2.1, 1.05, 0.3], 12, 13)]}.get(k, [])
        return {"lcd": None}, _orbit_feed(20, with_mesh=lambda k: False, objects=objects, gt_odometry=True,
                                          stamp=1e9), ["optimize", "optimize"]
    if name == "moving_solve_bumps_epoch":
        return {"lcd": lcd, "sigma_odom_trans": 0.02}, _orbit_feed(40), []
    raise KeyError(name)


def _run(backend, feed, actions, convert):
    for out, gt in feed:
        backend.add_output(convert(copy.deepcopy(out)), gt_pose=gt)
    for a in actions:
        getattr(backend, a)()
    return backend.get_dsg()


def _assert_backends_agree(jb, jdsg, tb, tdsg):
    assert len(tb.loop_closures) == len(jb.loop_closures)
    assert (tb.num_optimizations, tb.optimizes_skipped_consistent) == (jb.num_optimizations, jb.optimizes_skipped_consistent)
    assert tdsg.opt_epoch == jdsg.opt_epoch
    assert [dataclasses.astuple(p) for p in tb.proposed_merges] == [
        (p.from_id, p.into_id, pytest.approx(p.iou, abs=1e-3), p.is_valid, p.factor_idx, p.validated)
        for p in jb.proposed_merges]
    assert [(p.from_id, p.into_id) for p in tb.validated_merges()] == [(p.from_id, p.into_id) for p in jb.validated_merges()]
    if jb._opt_result is not None:
        np.testing.assert_array_equal(tb._opt_result.outlier_mask, jb._opt_result.outlier_mask)
    assert tb.graph.num_nodes == jb.graph.num_nodes and tb.graph.b_shadow == jb.graph.b_shadow
    assert tdsg.mesh.num_vertices == jdsg.mesh.num_vertices and tdsg.mesh.num_faces == jdsg.mesh.num_faces
    np.testing.assert_array_equal(tdsg.mesh.faces, jdsg.mesh.faces)
    np.testing.assert_allclose(tdsg.mesh.vertices, jdsg.mesh.vertices, rtol=0, atol=BACKEND_ATOL)
    np.testing.assert_allclose(tdsg.agent_positions(), jdsg.agent_positions(), rtol=0, atol=BACKEND_ATOL)
    assert sorted(tdsg.objects) == sorted(jdsg.objects)
    for oid, jo in jdsg.objects.items():
        to = tdsg.objects[oid]
        np.testing.assert_allclose(to.bbox_min, jo.bbox_min, rtol=0, atol=BACKEND_ATOL)
        np.testing.assert_allclose(to.bbox_max, jo.bbox_max, rtol=0, atol=BACKEND_ATOL)


SCENARIOS = ["loop_closure_improves_map", "objects_move_with_correction", "merge_proposals",
             "identity_solves_keep_epoch", "object_only_motion_keeps_epoch", "moving_solve_bumps_epoch"]


@pytest.mark.parametrize("name", SCENARIOS)
def test_backend_matches_reference(name):
    cfg, feed, actions = _scenario(name)
    jb = JBackend(jbuild(JBackendConfig, cfg))
    tb = TBackend(tbuild(TBackendConfig, cfg), device="cpu")
    jdsg = _run(jb, feed, actions, lambda o: o)
    tdsg = _run(tb, feed, actions, torch_output)
    _assert_backends_agree(jb, jdsg, tb, tdsg)
    if name in ("loop_closure_improves_map", "moving_solve_bumps_epoch"):
        assert len(tb.loop_closures) >= 1 and tdsg.opt_epoch >= 1
        assert np.abs(tdsg.mesh.vertices - tb.mesh_acc.build().vertices).max() > 0.01
    if name in ("identity_solves_keep_epoch", "object_only_motion_keeps_epoch"):
        assert tdsg.opt_epoch == 0 and tb.num_optimizations == 2
    if name == "identity_solves_keep_epoch":
        assert np.array_equal(tdsg.mesh.vertices, tb.mesh_acc.build().vertices)
    if name == "merge_proposals":
        assert (2, 1) in {(p.from_id, p.into_id) for p in tb.proposed_merges}


def test_merge_validation_matches_reference(tmp_path):
    """tests/test_backend.py's merge judging: a distinct pair is proposed on
    drifted geometry and invalidated by a loop closure's solve; a re-seen
    object's proposal is validated. Both packages, step by step, and the
    CSVs they save."""
    eye = np.eye(3, dtype=np.float32)

    def kf(k):
        truth = np.asarray([0.5 * k, 0.0, 0.0], np.float32)
        return (eye, truth), (eye, truth + np.asarray([0.0, 0.1 * k, 0.0], np.float32))

    def obj(k, true_pos, t0_s, t1_s):
        return _obj(JObject, np.asarray(true_pos, np.float32) + np.asarray([0, 0.1 * k, 0], np.float32), t0_s, t1_s)

    cfg = {"lcd": None, "merge_min_iou": 0.3, "add_merge_factor": True, "sigma_odom_trans": 0.05}
    backends = [(JBackend(jbuild(JBackendConfig, cfg)), lambda o: o, JLoopClosure),
                (TBackend(tbuild(TBackendConfig, cfg), device="cpu"), torch_output, TLoopClosure)]
    seen = {2: [(2, [2, 1, 0.3], 2, 3)], 5: [(5, [6, 1, 0.3], 5, 6)], 15: [(15, [6, 0, 0.3], 15, 16)],
            18: [(18, [2, 1, 0.3], 18, 19)]}
    for be, conv, LC in backends:
        for k in range(16):
            gt_p, odo_p = kf(k)
            objects = [obj(*o) for o in seen.get(k, [])]
            be.add_output(conv(make_output(int(k * 1e9), odo_p, gt_p, with_mesh=False, objects=objects)))
        be.optimize()
        be.add_loop_closure(LC(from_key=be.agent_keys[15], to_key=be.agent_keys[0], R=eye,
                               t=np.asarray([-7.5, 0, 0], np.float32)))
        for k in range(16, 21):
            gt_p, odo_p = kf(k)
            objects = [obj(*o) for o in seen.get(k, [])]
            be.add_output(conv(make_output(int(k * 1e9), odo_p, gt_p, with_mesh=False, objects=objects)))
        be.add_loop_closure(LC(from_key=be.agent_keys[20], to_key=be.agent_keys[0], R=eye,
                               t=np.asarray([-10.0, 0, 0], np.float32)))
        be.optimize()
    (jb, _, _), (tb, _, _) = backends
    _assert_backends_agree(jb, jb.get_dsg(), tb, tb.get_dsg())
    assert {(p.from_id, p.into_id) for p in tb.validated_merges()} == {(4, 1)}
    jb.save(str(tmp_path / "jax"))
    tb.save(str(tmp_path / "torch"))
    rows = [list(csv.DictReader(open(tmp_path / side / "proposed_merges.csv"))) for side in ("jax", "torch")]
    assert [{k: v for k, v in r.items() if k != "iou"} for r in rows[0]] == [
        {k: v for k, v in r.items() if k != "iou"} for r in rows[1]]
    np.testing.assert_allclose([float(r["iou"]) for r in rows[1]], [float(r["iou"]) for r in rows[0]], atol=1e-3)


def test_dsg_npz_crosses_packages(tmp_path):
    """A scene graph with a deformed mesh, agents, static and dynamic objects
    (with and without a feature): each package loads the other's dsg.npz,
    array for array, and writes the same keys and dtypes."""
    cfg, feed, actions = _scenario("objects_move_with_correction")
    jb = JBackend(jbuild(JBackendConfig, cfg))
    tb = TBackend(tbuild(TBackendConfig, cfg), device="cpu")
    jdsg, tdsg = _run(jb, feed, actions, lambda o: o), _run(tb, feed, actions, torch_output)
    dyn = _obj(JObject, [1, 2, 0.5], 1, 2, label=1)
    dyn.node_id, dyn.trajectory_stamps_ns = 99, [10, 20, 30]
    dyn.trajectory_positions = np.arange(9, dtype=np.float32).reshape(3, 3)
    dyn.feature = np.linspace(0, 1, 8).astype(np.float32)
    jdsg.objects[99] = dyn
    tdsg.objects[99] = torch_object(dyn)
    jser.save_scene_graph(jdsg, str(tmp_path / "j.npz"))
    tser.save_scene_graph(tdsg, str(tmp_path / "t.npz"))
    with np.load(tmp_path / "j.npz") as a, np.load(tmp_path / "t.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            assert a[key].dtype == b[key].dtype and a[key].shape == b[key].shape, key
    for write, read, src in ((jser.save_scene_graph, tser.load_scene_graph, jdsg),
                             (tser.save_scene_graph, jser.load_scene_graph, tdsg)):
        path = str(tmp_path / "cross.npz")
        write(src, path)
        back = read(path)
        want = jser.scene_graph_arrays(src) if write is jser.save_scene_graph else tser.scene_graph_arrays(src)
        got = tser.scene_graph_arrays(back) if read is tser.load_scene_graph else jser.scene_graph_arrays(back)
        assert want.keys() == got.keys()
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_backend_save_roundtrip(tmp_path):
    gt, odom = make_orbit(10)
    be = TBackend(tbuild(TBackendConfig, {"lcd": None}), device="cpu")
    for k in range(10):
        be.add_output(torch_output(make_output(int(k * 4e8), odom[k], gt[k])), gt_pose=gt[k])
    be.save(str(tmp_path))
    dsg = tser.load_scene_graph(str(tmp_path / "dsg.npz"))
    assert dsg.mesh.num_vertices > 0 and len(dsg.agents) == 10
    assert (tmp_path / "proposed_merges.csv").exists()
    tser.save_mesh_ply(dsg.mesh, str(tmp_path / "mesh.ply"))
    jser.save_mesh_ply(dsg.mesh, str(tmp_path / "mesh_jax.ply"))
    assert (tmp_path / "mesh.ply").read_text() == (tmp_path / "mesh_jax.ply").read_text()
