"""Schur-complement pose-graph / deformation-graph solver.

Port of `khronos_tpu/backend/distributed.py` (`Backend(solver="schur")`):
with the nodes ordered [poses | mesh-control nodes] (kimera_pgmo's MESH_ONLY
deformation graphs couple both), the control block C is eliminated first,
S = A - B C^-1 B^T, the small pose system is solved and the controls are
back-substituted: the globally solved system stays at pose count while the
control nodes grow with the map.

The normal equations come from the dense solver's assembly
(`factor_graph._normal_equations`: H = J^T J from dense per-factor blocks, a
fixed summation order, so two runs on one card agree bit for bit) where the
reference scatter-adds per-factor blocks. The Jacobi scaling and the damping
are the reference's. The dense Cholesky factorisations and solves are
torch.linalg's.

The reference padded pose, control and factor counts to coarse buckets so
that XLA reused one compiled program as the graph grew; pad nodes were
decoupled blocks with unit priors and pad factors carried zero information.
The port solves the unpadded system: on the graphs of
tests/test_torch_distributed.py the padded and unpadded solves give the same
poses to within float rounding (held there), so padding changes no result.

With `mesh=` (a `parallel.sharding.Mesh`) the factors are split into one
contiguous part per shard, as the reference shards its padded factor axis:
each shard linearises its part at the replicated nodes on its device, and
H, g and the error are summed in shard order on the solving device (no
float atomics; the sum differs from one device's by float rounding).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from khronos_tpu_torch import resolve_device
from khronos_tpu_torch.backend import factor_graph as fg


def _parts(n: int, shards: int):
    """Contiguous [start, stop) of each shard over n items: ceil(n / shards)
    each, the last ones shorter (the reference pads n to a multiple)."""
    k = -(-n // shards)
    return [(min(i * k, n), min((i + 1) * k, n)) for i in range(shards)]


def _normal_equations(node_R, node_t, f: fg._Factors, b_weight, mesh=None):
    """fg._normal_equations; with a mesh, over the factors split into the
    mesh's shards, summed in shard order on node_R's device."""
    if mesh is None:
        return fg._normal_equations(node_R, node_t, f, b_weight)
    dev = node_R.device
    H = g = err = None
    for d, (b0, b1), (p0, p1) in zip(mesh.devices, _parts(f.b_i.shape[0], mesh.size), _parts(f.p_i.shape[0], mesh.size)):
        if b1 == b0 and p1 == p0:
            continue  # an empty part adds nothing
        part = fg._Factors(
            **{k: getattr(f, k)[b0:b1].to(d) for k in ("b_i", "b_j", "b_R", "b_t", "b_info")},
            **{k: getattr(f, k)[p0:p1].to(d) for k in ("p_i", "p_R", "p_t", "p_info")},
        )
        Hi, gi, ei = (x.to(dev) for x in fg._normal_equations(node_R.to(d), node_t.to(d), part, b_weight[b0:b1].to(d)))
        H, g, err = (Hi, gi, ei) if H is None else (H + Hi, g + gi, err + ei)
    if H is None:  # a graph without factors
        return fg._normal_equations(node_R, node_t, f, b_weight)
    return H, g, err


def assemble_normal_equations(graph: fg.FactorGraphData, mesh=None, weights: Optional[np.ndarray] = None,
                              device=None):
    """(H [6N, 6N], g [6N], err) of the graph at its current nodes, the
    between factors weighted by `weights` (default 1), on `device`."""
    dev = resolve_device(device)
    node_R = torch.from_numpy(np.stack(graph.node_R).astype(np.float32)).to(dev)
    node_t = torch.from_numpy(np.stack(graph.node_t).astype(np.float32)).to(dev)
    w = np.ones(graph.num_between, np.float32)
    if weights is not None:
        w[:] = np.asarray(weights, np.float32)[: graph.num_between]
    return _normal_equations(node_R, node_t, fg._factors(graph, dev), torch.from_numpy(w).to(dev), mesh)


def _cholesky_solve(L: torch.Tensor, info: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """L L^T x = rhs [k, m]; NaN where the matrix was not positive definite,
    as the reference's Cholesky solve gives."""
    return torch.where(info == 0, torch.cholesky_solve(rhs, L), float("nan"))


def solve_schur(H: torch.Tensor, g: torch.Tensor, n_a: int, damping: float = 1e-6) -> torch.Tensor:
    """Solve (H + damping I) delta = -g by eliminating the trailing block.

    n_a: the number of leading (pose) NODES; the split is at n_a * 6. The
    trailing block (deformation-control nodes) is factorised once and the
    coupled solve runs at pose size: S = A - B C^-1 B^T."""
    ka = n_a * 6
    H = H.clone()
    H.diagonal().add_(float(np.float32(damping)))
    # Jacobi equilibration: the elimination squares the conditioning, which
    # float32 cannot afford with ~1e6-scale prior-information entries
    d = 1.0 / torch.sqrt(torch.clamp(torch.diagonal(H), min=1e-12))
    H = H * d[:, None] * d[None, :]
    g = g * d
    A, B, C = H[:ka, :ka], H[:ka, ka:], H[ka:, ka:]
    ga, gc = -g[:ka], -g[ka:]
    if C.shape[0]:
        Lc, info_c = torch.linalg.cholesky_ex(C)
        Cinv_Bt = _cholesky_solve(Lc, info_c, B.T.contiguous())  # [kc, ka]
        Cinv_gc = _cholesky_solve(Lc, info_c, gc[:, None])[:, 0]
        S = A - B @ Cinv_Bt
        rhs = ga - B @ Cinv_gc
    else:
        S, rhs = A, ga
    Ls, info_s = torch.linalg.cholesky_ex(S)
    xa = _cholesky_solve(Ls, info_s, rhs[:, None])[:, 0]
    parts = [xa]
    if C.shape[0]:
        parts.append(Cinv_gc - Cinv_Bt @ xa)
    return torch.cat(parts) * d


def optimize_distributed(graph: fg.FactorGraphData, mesh=None, n_pose_nodes: Optional[int] = None,
                         config: fg.OptimizerConfig = None, device=None) -> fg.OptimizeResult:
    """factor_graph.optimize with the linear step replaced by the Schur
    elimination: the GNC/LM loop is shared, so the solver inherits its
    robustness semantics. Nodes must be ordered [poses | controls];
    n_pose_nodes defaults to all (a plain pose graph). With mesh= the
    factors are linearised per shard (see the module docstring)."""
    N = graph.num_nodes
    if N == 0:
        return fg.OptimizeResult(np.zeros((0, 3, 3)), np.zeros((0, 3)), 0.0, np.zeros(0, bool))
    dev = resolve_device(device)
    n_a = N if n_pose_nodes is None else max(1, min(n_pose_nodes, N))
    f = fg._factors(graph, dev)

    def step_fn(node_R, node_t, weights, damping):
        H, g, err = _normal_equations(node_R, node_t, f, weights, mesh)
        # the reference adds 1e-6 to the Python float before its float32 cast
        return solve_schur(H, g, n_a, float(damping) + 1e-6).reshape(N, 6), err

    return fg.optimize(graph, config, device=dev, step_fn=step_fn)


def optimize_backend_graph(graph: fg.FactorGraphData, pose_node_ids, mesh=None,
                           config: fg.OptimizerConfig = None, device=None) -> fg.OptimizeResult:
    """optimize_distributed for a backend graph whose pose (agent keyframe)
    and deformation-control nodes are interleaved in insertion order: permute
    the nodes to [poses | controls], Schur-eliminate the control block,
    permute back. Returns the result in the ORIGINAL node order."""
    N = graph.num_nodes
    pose_ids = list(pose_node_ids)
    pose_set = set(pose_ids)
    order = pose_ids + [i for i in range(N) if i not in pose_set]
    inv = np.empty(N, np.int64)
    inv[np.asarray(order, np.int64)] = np.arange(N)
    g2 = fg.FactorGraphData()
    g2.node_R = [graph.node_R[i] for i in order]
    g2.node_t = [graph.node_t[i] for i in order]
    g2.b_i = [int(inv[i]) for i in graph.b_i]
    g2.b_j = [int(inv[j]) for j in graph.b_j]
    g2.p_i = [int(inv[i]) for i in graph.p_i]
    for name in ("b_R", "b_t", "b_sqrt_info", "b_robust", "b_shadow", "p_R", "p_t", "p_sqrt_info"):
        setattr(g2, name, list(getattr(graph, name)))
    res = optimize_distributed(g2, mesh=mesh, n_pose_nodes=len(pose_ids), config=config, device=device)
    return fg.OptimizeResult(
        node_R=res.node_R[inv], node_t=res.node_t[inv], final_error=res.final_error,
        outlier_mask=res.outlier_mask, iterations=res.iterations,
    )
