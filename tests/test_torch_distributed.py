"""Port parity for the Schur solver: backend/distributed.py.

The same graphs go to both packages (tests/test_torch_backend.py's graphs and
Backend scenarios, rebuilt in the port's types by tests/torch_parity.py).
Tolerances:
- `assemble_normal_equations` and `solve_schur` run with the nodes moved
  off the optimum, where the gradient is not rounding noise.
- `assemble_normal_equations`: H and g within 1e-5 of their largest entry (the
  reference scatter-adds per-factor blocks, the port multiplies the dense
  weighted Jacobian: another summation order); err within rtol 1e-5.
- `solve_schur` on the reference's own H and g: within 1e-4 of the largest
  step entry (float32 Cholesky factorisations from two libraries).
- `optimize_distributed`, `optimize_backend_graph`: node positions and
  rotations within 1e-4, outlier masks equal, as the dense solver's test.
- `Backend(solver="schur")`: the dense scenarios' bars (agents and deformed
  vertices within 1e-3 m, the same loop closures, solves, epochs, merges).
- Schur against dense in the port: agents within 1e-4 m.
The sharded assembly (`mesh=`) is held in tests/test_torch_sharding.py."""

import copy

import numpy as np
import pytest

from khronos_tpu.backend import distributed as jdist
from khronos_tpu.backend import factor_graph as jfg
from khronos_tpu.backend.backend import Backend as JBackend
from khronos_tpu.backend.backend import BackendConfig as JBackendConfig
from khronos_tpu.config import build as jbuild
from khronos_tpu_torch.backend import distributed as tdist
from khronos_tpu_torch.backend import factor_graph as tfg
from khronos_tpu_torch.backend.backend import Backend as TBackend
from khronos_tpu_torch.backend.backend import BackendConfig as TBackendConfig
from khronos_tpu_torch.config import build as tbuild

import torch
from test_torch_backend import GRAPHS, SCENARIOS, _assert_backends_agree, _run, _scenario
from torch_parity import torch_graph, torch_output

POSE_ATOL = 1e-4


def _reference_backend(name, solver="schur"):
    """The reference backend after a scenario's feed: its graph mixes agent
    keyframes and mesh-control nodes."""
    cfg, feed, actions = _scenario(name)
    jb = JBackend(jbuild(JBackendConfig, {**cfg, "solver": solver}))
    jdsg = _run(jb, feed, actions, lambda o: o)
    return cfg, feed, actions, jb, jdsg


@pytest.fixture(scope="module")
def lc_backend():
    return _reference_backend("loop_closure_improves_map")


def _permuted(graph, pose_ids):
    """The graph with its nodes ordered [poses | controls] (both packages' types)."""
    order = list(pose_ids) + [i for i in range(graph.num_nodes) if i not in set(pose_ids)]
    inv = np.empty(graph.num_nodes, np.int64)
    inv[order] = np.arange(graph.num_nodes)
    g2 = jfg.FactorGraphData()
    g2.node_R = [graph.node_R[i] for i in order]
    g2.node_t = [graph.node_t[i] for i in order]
    g2.b_i, g2.b_j, g2.p_i = ([int(inv[i]) for i in getattr(graph, k)] for k in ("b_i", "b_j", "p_i"))
    for k in ("b_R", "b_t", "b_sqrt_info", "b_robust", "b_shadow", "p_R", "p_t", "p_sqrt_info"):
        setattr(g2, k, list(getattr(graph, k)))
    return g2


def _moved(graph):
    """The graph with its nodes moved by 5 cm: at its own nodes the gradient
    is a sum of cancelling terms, rounding noise on both sides."""
    g = copy.deepcopy(graph)
    rng = np.random.default_rng(3)
    g.node_t = [t + rng.normal(0, 0.05, 3).astype(np.float32) for t in g.node_t]
    return g


def test_assemble_normal_equations_matches_reference(lc_backend):
    jb = lc_backend[3]
    g = _moved(jb.graph)
    w = np.linspace(0.5, 1.0, g.num_between).astype(np.float32)
    jH, jg, jerr = (np.asarray(a) for a in jdist.assemble_normal_equations(g, weights=w))
    tH, tg, terr = (a.numpy() for a in tdist.assemble_normal_equations(torch_graph(g), weights=w, device="cpu"))
    assert g.num_nodes > len(jb.agent_keys) > 10
    np.testing.assert_allclose(tH, jH, rtol=0, atol=1e-5 * np.abs(jH).max())
    np.testing.assert_allclose(tg, jg, rtol=0, atol=1e-5 * np.abs(jg).max())
    assert float(terr) == pytest.approx(float(jerr), rel=1e-5)


@pytest.mark.parametrize("split", ["poses_and_controls", "poses_only"])
def test_solve_schur_matches_reference(lc_backend, split):
    """The reference's own H and g of the backend graph (nodes moved, then
    permuted to [poses | controls]) through both packages' Schur solves."""
    jb = lc_backend[3]
    g = _permuted(_moved(jb.graph), jb.agent_keys)
    n_a = len(jb.agent_keys) if split == "poses_and_controls" else g.num_nodes
    H, gv, _ = jdist.assemble_normal_equations(g)
    want = np.asarray(jdist.solve_schur(H, gv, n_a, 1e-4))
    got = tdist.solve_schur(torch.from_numpy(np.array(H)), torch.from_numpy(np.array(gv)), n_a, 1e-4).numpy()
    assert np.isfinite(want).all() and np.abs(want).max() > 1e-3
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("name", list(GRAPHS))
def test_optimize_distributed_matches_reference(name):
    g, cfg = GRAPHS[name]()
    n_a = max(1, g.num_nodes // 2)
    want = jdist.optimize_distributed(g, n_pose_nodes=n_a, config=jfg.OptimizerConfig(**cfg))
    got = tdist.optimize_distributed(torch_graph(g), n_pose_nodes=n_a, config=tfg.OptimizerConfig(**cfg),
                                     device="cpu")
    np.testing.assert_allclose(got.node_t, want.node_t, rtol=0, atol=POSE_ATOL)
    np.testing.assert_allclose(got.node_R, want.node_R, rtol=0, atol=POSE_ATOL)
    np.testing.assert_array_equal(got.outlier_mask, want.outlier_mask)
    assert got.final_error == pytest.approx(want.final_error, rel=1e-3, abs=1e-3)


def test_optimize_backend_graph_matches_reference(lc_backend):
    jb = lc_backend[3]
    want = jdist.optimize_backend_graph(jb.graph, jb.agent_keys, config=jb.config.optimizer)
    got = tdist.optimize_backend_graph(torch_graph(jb.graph), jb.agent_keys,
                                       config=tfg.OptimizerConfig(**vars(jb.config.optimizer)), device="cpu")
    assert got.node_t.shape == (jb.graph.num_nodes, 3)
    np.testing.assert_allclose(got.node_t, want.node_t, rtol=0, atol=POSE_ATOL)
    np.testing.assert_allclose(got.node_R, want.node_R, rtol=0, atol=POSE_ATOL)
    np.testing.assert_array_equal(got.outlier_mask, want.outlier_mask)


def test_bucket_padding_changes_no_result(lc_backend):
    """The reference pads pose, control and factor counts to buckets (decoupled
    unit-prior pad nodes, zero-information pad factors) to reuse compiled
    programs. The port solves the unpadded graph; padded the reference's way
    it gives the same nodes within 1e-6 m, so the padding is left out."""
    jb = lc_backend[3]
    tg = torch_graph(jb.graph)
    plain = tdist.optimize_backend_graph(tg, jb.agent_keys, device="cpu")
    g = _permuted(jb.graph, jb.agent_keys)
    nA, N = len(jb.agent_keys), jb.graph.num_nodes
    padA, padC = 64 - nA, 64 - (N - nA)
    eye, zero = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    ctrl_shift = [i if i < nA else i + padA for i in range(N)]
    p = jfg.FactorGraphData()
    p.node_R = g.node_R[:nA] + [eye] * padA + g.node_R[nA:] + [eye] * padC
    p.node_t = g.node_t[:nA] + [zero] * padA + g.node_t[nA:] + [zero] * padC
    p.b_i, p.b_j, p.p_i = ([ctrl_shift[i] for i in getattr(g, k)] for k in ("b_i", "b_j", "p_i"))
    for k in ("b_R", "b_t", "b_sqrt_info", "b_robust", "b_shadow", "p_R", "p_t", "p_sqrt_info"):
        setattr(p, k, list(getattr(g, k)))
    for k in list(range(nA, nA + padA)) + list(range(N + padA, N + padA + padC)):
        p.add_prior(k, eye, zero, sigma_rot=1.0, sigma_trans=1.0)
    for _ in range(7):
        p.add_between(0, 0, eye, zero)
        p.b_sqrt_info[-1] = np.zeros(6, np.float32)
    padded = tdist.optimize_distributed(torch_graph(p), n_pose_nodes=nA + padA, device="cpu")
    real = [ctrl_shift[i] for i in range(N)]
    order = list(jb.agent_keys) + [i for i in range(N) if i not in set(jb.agent_keys)]
    np.testing.assert_allclose(padded.node_t[real], plain.node_t[order], rtol=0, atol=1e-6)
    np.testing.assert_allclose(padded.node_R[real], plain.node_R[order], rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", SCENARIOS)
def test_backend_schur_matches_reference(name):
    cfg, feed, actions, jb, jdsg = _reference_backend(name)
    tb = TBackend(tbuild(TBackendConfig, {**cfg, "solver": "schur"}), device="cpu")
    tdsg = _run(tb, feed, actions, torch_output)
    _assert_backends_agree(jb, jdsg, tb, tdsg)


def test_schur_matches_dense_in_port():
    cfg, feed, actions = _scenario("loop_closure_improves_map")
    runs = {}
    for solver in ("dense", "schur"):
        tb = TBackend(tbuild(TBackendConfig, {**cfg, "solver": solver}), device="cpu")
        runs[solver] = (tb, _run(tb, copy.deepcopy(feed), actions, torch_output))
    (db, ddsg), (sb, sdsg) = runs["dense"], runs["schur"]
    assert sb.num_optimizations == db.num_optimizations >= 1
    np.testing.assert_allclose(sdsg.agent_positions(), ddsg.agent_positions(), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(sdsg.mesh.faces, ddsg.mesh.faces)

