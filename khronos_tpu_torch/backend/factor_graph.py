"""SE(3) factor-graph optimizer: Gauss-Newton/LM with GNC robust weights.

Port of `khronos_tpu/backend/factor_graph.py`, the replacement for the
reference's GTSAM + Kimera-RPGO backbone (SURVEY.md §2.3: `optimizer: type:
KimeraRpgoOptimizer, solver: LM, gnc: inlier_probability 0.9`,
uHumans2.yaml:212-219). The graph couples agent keyframe poses, mesh
deformation-control nodes and object nodes through between factors.

Factor types:
  prior   : r = Log(T_i^{-1} Z)
  between : r = Log(Z^{-1} T_i^{-1} T_j)
Each factor has a 6-vector sqrt information (diagonal) and a robust flag.

On the device: the per-factor 6x6 Jacobian blocks come from
`torch.func.jacfwd` vmapped over the factors (the reference's jax.jacfwd),
at xi = 0. The normal equations are assembled as a dense incidence product,
H = J^T J and g = J^T r with J the [6(F+P), 6N] weighted Jacobian, so every
sum runs in the matrix product's fixed order: two runs on one card give the
same trajectory bit for bit, which a float scatter-add with atomics would
not. Each position of J is written by exactly one factor block, except a
between factor whose two ends are one node, whose two blocks add (a sum of
two terms, the same in either order). The solve is a dense Cholesky. The
reference padded node and factor counts to powers of two so that XLA
compiled once per doubling; pad nodes were decoupled blocks with unit priors
and pad factors had zero information, so they changed no real node's
solution, and the port has no padding. The GN/LM and GNC loops are the
reference's, on the host: each step reads the error back to decide.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch
from torch.func import jacfwd, vmap

from khronos_tpu_torch import resolve_device
from khronos_tpu_torch.geometry import transforms as tf


@dataclasses.dataclass
class FactorGraphData:
    """Host-side graph under construction (append-only)."""

    # nodes
    node_R: List[np.ndarray] = dataclasses.field(default_factory=list)
    node_t: List[np.ndarray] = dataclasses.field(default_factory=list)
    # between factors
    b_i: List[int] = dataclasses.field(default_factory=list)
    b_j: List[int] = dataclasses.field(default_factory=list)
    b_R: List[np.ndarray] = dataclasses.field(default_factory=list)
    b_t: List[np.ndarray] = dataclasses.field(default_factory=list)
    b_sqrt_info: List[np.ndarray] = dataclasses.field(default_factory=list)
    b_robust: List[bool] = dataclasses.field(default_factory=list)
    # shadow factors: ZERO weight in the solve (they cannot distort the
    # solution), classified against the GNC inlier gate at the final
    # geometry; used for merge-proposal judging
    b_shadow: List[bool] = dataclasses.field(default_factory=list)
    # prior factors
    p_i: List[int] = dataclasses.field(default_factory=list)
    p_R: List[np.ndarray] = dataclasses.field(default_factory=list)
    p_t: List[np.ndarray] = dataclasses.field(default_factory=list)
    p_sqrt_info: List[np.ndarray] = dataclasses.field(default_factory=list)

    def add_node(self, R: np.ndarray, t: np.ndarray) -> int:
        self.node_R.append(np.asarray(R, np.float32))
        self.node_t.append(np.asarray(t, np.float32))
        return len(self.node_R) - 1

    def add_between(self, i: int, j: int, R: np.ndarray, t: np.ndarray,
                    sigma_rot: float = 0.01, sigma_trans: float = 0.01,
                    robust: bool = False, shadow: bool = False):
        self.b_i.append(i)
        self.b_j.append(j)
        self.b_R.append(np.asarray(R, np.float32))
        self.b_t.append(np.asarray(t, np.float32))
        info = np.array([1 / sigma_trans] * 3 + [1 / sigma_rot] * 3, np.float32)
        self.b_sqrt_info.append(info)
        self.b_robust.append(robust)
        self.b_shadow.append(shadow)

    def add_prior(self, i: int, R: np.ndarray, t: np.ndarray,
                  sigma_rot: float = 0.001, sigma_trans: float = 0.001):
        self.p_i.append(i)
        self.p_R.append(np.asarray(R, np.float32))
        self.p_t.append(np.asarray(t, np.float32))
        self.p_sqrt_info.append(
            np.array([1 / sigma_trans] * 3 + [1 / sigma_rot] * 3, np.float32)
        )

    @property
    def num_nodes(self) -> int:
        return len(self.node_R)

    @property
    def num_between(self) -> int:
        return len(self.b_i)


# ----------------------------------------------------------------------------
# residuals (tangent increments xi: [..., 6] around the linearization point)
# ----------------------------------------------------------------------------


def _retract(R, t, xi):
    dR, dt = tf.se3_exp(xi)
    return R @ dR, (R @ dt[..., None])[..., 0] + t


def _between_residual(xi_i, xi_j, Ri, ti, Rj, tj, Zr, Zt):
    """r = Log(Z^{-1} (Ti Exp(xi_i))^{-1} (Tj Exp(xi_j)))."""
    Ri2, ti2 = _retract(Ri, ti, xi_i)
    Rj2, tj2 = _retract(Rj, tj, xi_j)
    Rrel, trel = tf.between(Ri2, ti2, Rj2, tj2)
    Zri, Zti = tf.inverse(Zr, Zt)
    Re, te = tf.compose(Zri, Zti, Rrel, trel)
    return tf.se3_log(Re, te)


def _prior_residual(xi_i, Ri, ti, Zr, Zt):
    Ri2, ti2 = _retract(Ri, ti, xi_i)
    Rrel, trel = tf.between(Ri2, ti2, Zr, Zt)
    return tf.se3_log(Rrel, trel)


@dataclasses.dataclass
class _Factors:
    """The graph's factors as device tensors (F between, P priors)."""

    b_i: torch.Tensor  # [F] int64
    b_j: torch.Tensor
    b_R: torch.Tensor  # [F, 3, 3]
    b_t: torch.Tensor  # [F, 3]
    b_info: torch.Tensor  # [F, 6]
    p_i: torch.Tensor  # [P] int64
    p_R: torch.Tensor
    p_t: torch.Tensor
    p_info: torch.Tensor


def _between_residuals(node_R, node_t, f: _Factors):
    zero = torch.zeros((f.b_i.shape[0], 6), dtype=node_R.dtype, device=node_R.device)
    return _between_residual(zero, zero, node_R[f.b_i], node_t[f.b_i], node_R[f.b_j], node_t[f.b_j], f.b_R, f.b_t)


def _prior_residuals(node_R, node_t, f: _Factors):
    zero = torch.zeros((f.p_i.shape[0], 6), dtype=node_R.dtype, device=node_R.device)
    return _prior_residual(zero, node_R[f.p_i], node_t[f.p_i], f.p_R, f.p_t)


def _weighted_error(node_R, node_t, f: _Factors, b_weight) -> torch.Tensor:
    """Total weighted squared error (0-dim tensor), as `_linearize_and_solve`
    computes it."""
    wb = f.b_info * torch.sqrt(b_weight)[:, None]
    r_bw = _between_residuals(node_R, node_t, f) * wb
    r_pw = _prior_residuals(node_R, node_t, f) * f.p_info
    return torch.sum(r_bw**2) + torch.sum(r_pw**2)


def _normal_equations(node_R, node_t, f: _Factors, b_weight):
    """The linearised system at the current nodes: (H [6N, 6N], g [6N], total
    weighted error), H = J^T J and g = J^T r from the dense weighted
    Jacobian."""
    N = node_R.shape[0]
    F, P = f.b_i.shape[0], f.p_i.shape[0]
    dev, dt = node_R.device, node_R.dtype
    zero6 = torch.zeros(6, dtype=dt, device=dev)

    Ri, ti, Rj, tj = node_R[f.b_i], node_t[f.b_i], node_R[f.b_j], node_t[f.b_j]
    r_b = _between_residual(zero6.expand(F, 6), zero6.expand(F, 6), Ri, ti, Rj, tj, f.b_R, f.b_t)  # [F, 6]
    Ji_b, Jj_b = vmap(jacfwd(_between_residual, argnums=(0, 1)), in_dims=(None, None, 0, 0, 0, 0, 0, 0))(
        zero6, zero6, Ri, ti, Rj, tj, f.b_R, f.b_t
    )  # [F, 6, 6] each
    Rp, tp = node_R[f.p_i], node_t[f.p_i]
    r_p = _prior_residual(zero6.expand(P, 6), Rp, tp, f.p_R, f.p_t)
    J_p = vmap(jacfwd(_prior_residual, argnums=0), in_dims=(None, 0, 0, 0, 0))(zero6, Rp, tp, f.p_R, f.p_t)

    # weighted by sqrt info * robust weight
    wb = f.b_info * torch.sqrt(b_weight)[:, None]  # [F, 6]
    r_bw = r_b * wb
    r_pw = r_p * f.p_info

    # J: row block k is factor k (between factors first, then priors), column
    # block n is node n
    six = torch.arange(6, device=dev)
    J = torch.zeros(((F + P) * 6, N * 6), dtype=dt, device=dev)
    rows_b = (torch.arange(F, device=dev)[:, None] * 6 + six)[:, :, None]  # [F, 6, 1]
    cols_i = (f.b_i[:, None] * 6 + six)[:, None, :]  # [F, 1, 6]
    cols_j = (f.b_j[:, None] * 6 + six)[:, None, :]
    J[rows_b, cols_i] = Ji_b * wb[:, :, None]
    J[rows_b, cols_j] = J[rows_b, cols_j] + Jj_b * wb[:, :, None]
    rows_p = ((F + torch.arange(P, device=dev))[:, None] * 6 + six)[:, :, None]
    J[rows_p, (f.p_i[:, None] * 6 + six)[:, None, :]] = J_p * f.p_info[:, :, None]
    r = torch.cat([r_bw.reshape(-1), r_pw.reshape(-1)])

    err = torch.sum(r_bw**2) + torch.sum(r_pw**2)
    return J.T @ J, J.T @ r, err


def _linearize_and_solve(node_R, node_t, f: _Factors, b_weight, damping: float):
    """One GN/LM step: returns (delta [N,6], total weighted error)."""
    N = node_R.shape[0]
    H, g, err = _normal_equations(node_R, node_t, f, b_weight)
    # LM damping + gauge regularization (the damping is a float32 scalar, as
    # in the reference)
    H.diagonal().add_(float(np.float32(damping) + np.float32(1e-6)))
    L, info = torch.linalg.cholesky_ex(H)
    delta = torch.cholesky_solve(-g[:, None], L)[:, 0]
    # a matrix that is not positive definite gives NaN, as the reference's
    # Cholesky solve does (the LM loop then rejects the step)
    delta = torch.where(info == 0, delta, float("nan"))
    return delta.reshape(N, 6), err


def _apply_delta(node_R, node_t, delta):
    dR, dt = tf.se3_exp(delta)
    R_new = node_R @ dR
    t_new = (node_R @ dt[..., None])[..., 0] + node_t
    return R_new, t_new


def _between_errors(node_R, node_t, f: _Factors):
    """Weighted squared residual per between factor (for GNC weights)."""
    return torch.sum((_between_residuals(node_R, node_t, f) * f.b_info) ** 2, dim=-1)


@dataclasses.dataclass
class OptimizerConfig:
    max_iterations: int = 25
    init_damping: float = 1e-4
    error_tol: float = 1e-7
    # GNC (Geman-McClure): anneal mu from mu_init toward 1
    gnc_enabled: bool = True
    # inlier gate on the weighted squared residual: chi-square(6 dof) upper
    # quantile at RPGO's `inlier_probability: 0.9` (uHumans2.yaml:217) = 10.64
    # — a correctly-noisy loop closure must not be rejected
    gnc_barc2: float = 10.64
    gnc_mu_init: float = 64.0
    gnc_mu_step: float = 1.4
    # enough outer iterations to anneal mu from ~2*r2_max/barc2 down to 1
    # (RPGO caps at 100); the loop breaks early once mu reaches 1
    gnc_outer_iterations: int = 40
    inner_iterations: int = 5


@dataclasses.dataclass
class OptimizeResult:
    node_R: np.ndarray  # [N,3,3]
    node_t: np.ndarray  # [N,3]
    final_error: float
    outlier_mask: np.ndarray  # [F] bool: robust factors judged outliers
    iterations: int = 0


def _factors(graph: FactorGraphData, device) -> _Factors:
    def t(rows, shape, dtype=torch.float32):
        arr = np.stack(rows).astype(np.float32) if rows else np.zeros(shape, np.float32)
        return torch.from_numpy(arr).to(device=device, dtype=dtype)

    def ids(values):
        return torch.as_tensor(np.asarray(values, np.int64).reshape(-1), device=device)

    return _Factors(
        b_i=ids(graph.b_i), b_j=ids(graph.b_j),
        b_R=t(graph.b_R, (0, 3, 3)), b_t=t(graph.b_t, (0, 3)), b_info=t(graph.b_sqrt_info, (0, 6)),
        p_i=ids(graph.p_i),
        p_R=t(graph.p_R, (0, 3, 3)), p_t=t(graph.p_t, (0, 3)), p_info=t(graph.p_sqrt_info, (0, 6)),
    )


def optimize(graph: FactorGraphData, config: OptimizerConfig = None, device=None, step_fn=None) -> OptimizeResult:
    """Run robust pose-graph optimization; returns optimized poses (host).

    device: where the linear algebra runs; CUDA unless the caller passes
    device="cpu". step_fn(node_R, node_t, weights, damping) -> (delta [N, 6],
    err) replaces the dense linear step: the Schur solver
    (backend/distributed.py) plugs in here and inherits this GNC/LM loop."""
    config = config or OptimizerConfig()
    dev = resolve_device(device)
    N = graph.num_nodes
    if N == 0:
        return OptimizeResult(np.zeros((0, 3, 3)), np.zeros((0, 3)), 0.0, np.zeros(0, bool))

    node_R = torch.from_numpy(np.stack(graph.node_R).astype(np.float32)).to(dev)
    node_t = torch.from_numpy(np.stack(graph.node_t).astype(np.float32)).to(dev)
    f = _factors(graph, dev)
    F = graph.num_between
    has_between = F > 0
    robust = np.asarray(graph.b_robust, bool).reshape(F)
    shadow = (
        np.asarray(graph.b_shadow, bool)
        if len(graph.b_shadow) == F
        else np.zeros(F, bool)
    )
    shadow_t = torch.from_numpy(shadow).to(dev)
    # shadow factors never influence the solution (weight 0 throughout);
    # they are classified against the GNC gate at the final geometry
    weights = torch.where(shadow_t, 0.0, 1.0)
    robust_t = torch.from_numpy(robust).to(dev) & ~shadow_t

    if step_fn is None:
        def step_fn(node_R, node_t, weights, damping):
            return _linearize_and_solve(node_R, node_t, f, weights, damping)

    def run_gn(node_R, node_t, weights, iters):
        damping = config.init_damping
        prev_err = np.inf
        it = 0
        for it in range(iters):
            delta, err = step_fn(node_R, node_t, weights, damping)
            err = float(err)
            if not np.isfinite(err):
                damping *= 10
                continue
            node_R2, node_t2 = _apply_delta(node_R, node_t, delta)
            # simple LM accept/reject
            err2 = _weighted_error(node_R2, node_t2, f, weights)
            if float(err2) <= err:
                node_R, node_t = node_R2, node_t2
                damping = max(damping * 0.5, 1e-7)
            else:
                damping = min(damping * 8, 1e4)
            if abs(prev_err - err) < config.error_tol * max(err, 1.0):
                break
            prev_err = err
        return node_R, node_t, prev_err, it

    total_iters = 0
    any_robust = bool((robust & ~shadow).any())
    c2 = config.gnc_barc2
    if config.gnc_enabled and any_robust and has_between:
        # GNC-GM annealing over robust factors
        node_R, node_t, err, it = run_gn(node_R, node_t, weights, config.inner_iterations)
        total_iters += it
        errs0 = _between_errors(node_R, node_t, f)
        r2_max = float(torch.max(torch.where(robust_t, errs0, 0.0)))
        mu = max(2 * r2_max / max(c2, 1e-9), config.gnc_mu_init)
        if r2_max <= c2:
            # every robust factor is already an inlier at the plain-GN
            # optimum: annealing mu from 64 -> 1 would run ~12 more outer
            # rounds of solves to reach the same weights (~1)
            mu = 1.0
        for _ in range(config.gnc_outer_iterations):
            errs = _between_errors(node_R, node_t, f)
            # mu c2 / (errs + mu c2) as a true division (a Python scalar over
            # a tensor multiplies by the reciprocal in PyTorch)
            mu_c2 = torch.full((), mu * c2, dtype=errs.dtype, device=dev)
            w_gm = (mu_c2 / (errs + mu * c2)) ** 2
            weights = torch.where(shadow_t, 0.0, torch.where(robust_t, w_gm, 1.0))
            node_R, node_t, err, it = run_gn(node_R, node_t, weights, config.inner_iterations)
            total_iters += it
            mu = max(mu / config.gnc_mu_step, 1.0)
            if mu <= 1.0:
                break
        errs = _between_errors(node_R, node_t, f)
        outliers = (robust_t & (errs > c2 * 4)).cpu().numpy()
    else:
        node_R, node_t, err, it = run_gn(node_R, node_t, weights, config.max_iterations)
        total_iters += it
        outliers = np.zeros(F, bool)

    # final error + shadow classification: a shadow factor is an outlier iff
    # its residual at the UNBENT optimum exceeds the GNC inlier gate (the
    # solve never mitigated it, so the raw gate applies — no 4x slack)
    errs = _between_errors(node_R, node_t, f)
    if bool(shadow.any()):
        outliers = outliers | (shadow_t & (errs > c2)).cpu().numpy()
    final = float(torch.sum(torch.where(shadow_t, 0.0, torch.where(robust_t, torch.clamp_max(errs, c2), errs))))
    return OptimizeResult(
        node_R=node_R.cpu().numpy(),
        node_t=node_t.cpu().numpy(),
        final_error=final,
        outlier_mask=outliers,
        iterations=total_iters,
    )
