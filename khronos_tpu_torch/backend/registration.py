"""Robust point-cloud registration: GNC-TLS (TEASER++-parity slot).

Port of `khronos_tpu/backend/registration.py`. The reference verifies
loop-closure candidates with TEASER++ robust registration (hydra LCD,
khronos_ros/config/mapper/uHumans2.yaml:298-307 teaser params). The design
keeps truncated-least-squares estimation solved by graduated non-convexity
(GNC, Yang et al.) with a closed-form weighted-Horn solve per iteration, over
a fixed schedule with no data-dependent exit, and lets the GNC weights stand
in for TEASER's combinatorial inlier pruning.

Two entry points, both on `device` (CUDA unless the caller passes
device="cpu"):
  - `gnc_tls_register(src, dst, noise_bound)`: known putative correspondences
    (src[i] <-> dst[i]); returns (R, t, weights, inlier_rms).
  - `robust_icp(src, dst, R0, t0, noise_bound)`: correspondences unknown —
    outer nearest-neighbour association rounds with a GNC-TLS weighted solve
    inside, initialised from odometry. This is the LCD verify slot.

The reference's `lax.scan` schedules (32 GNC iterations; 12 outer x 12
inner) are plain loops of the same counts. Every contraction is full float32
(TF32 is off package-wide): the rotations and the 3x3 cross-covariance decide
which loops close. Points move through R as the reference's `src @ R.T + t`
rounds on XLA CPU (`transform_points`' fused chain), and nearest neighbours
come from the broadcast difference and a sum of squares, as in the reference
(not `torch.cdist`, whose matrix-product path rounds differently), with the
first index on ties. The 3x3 SVD is the library's (LAPACK on the CPU,
cuSOLVER on the card): U and V may differ from the reference's in sign, the
rotation R = V D U^T does not while the singular values differ.

Conventions match loop_closure.py: the returned (R, t) maps src points into
the dst frame, dst ~= R @ src + t.
"""

from __future__ import annotations

import numpy as np
import torch

from khronos_tpu_torch import fma32, resolve_device


def _f32(x, device) -> torch.Tensor:
    if torch.is_tensor(x):
        return x.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def _moved(src: torch.Tensor, R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """src @ R.T + t: per component the fma chain over j = 0, 1, 2, then + t."""
    cols = []
    for i in range(3):
        acc = src[:, 0] * R[i, 0]
        acc = fma32(src[:, 1], R[i, 1], acc)
        acc = fma32(src[:, 2], R[i, 2], acc)
        cols.append(acc + t[i])
    return torch.stack(cols, dim=-1)


def _sq_norm(d: torch.Tensor) -> torch.Tensor:
    """Sum of squares over the last axis of 3, in order."""
    return d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]


def _weighted_horn(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor):
    """Closed-form weighted alignment (Horn/Umeyama, no scale).

    src, dst: [N, 3]; w: [N] nonneg. Returns (R, t) with dst ~= R src + t."""
    wsum = torch.clamp_min(w.sum(), 1e-9)
    mu_s = (w[:, None] * src).sum(0) / wsum
    mu_d = (w[:, None] * dst).sum(0) / wsum
    H = ((src - mu_s) * w[:, None]).T @ (dst - mu_d)
    U, _, Vt = torch.linalg.svd(H)
    det = torch.sign(torch.linalg.det(Vt.T @ U.T))
    D = torch.diag(torch.stack([torch.ones_like(det), torch.ones_like(det), det]))
    R = Vt.T @ D @ U.T
    t = mu_d - R @ mu_s
    return R, t


def _gnc_tls_weights(r2: torch.Tensor, mu, c2) -> torch.Tensor:
    """GNC-TLS weight update (Yang et al. 2020, eq. 14).

    r2: squared residuals; c2: squared truncation (noise bound); mu: GNC
    control parameter (mu -> inf recovers hard TLS)."""
    lo = mu / (mu + 1.0) * c2
    hi = (mu + 1.0) / mu * c2
    w_mid = torch.sqrt(c2 * mu * (mu + 1.0) / torch.clamp_min(r2, 1e-12)) - mu
    w = torch.where(r2 <= lo, 1.0, torch.where(r2 >= hi, 0.0, w_mid))
    return w.clamp(0.0, 1.0)


def gnc_tls_register(src, dst, noise_bound: float, valid=None, iters: int = 32, device=None):
    """Robust SE(3) fit over putative correspondences src[i] <-> dst[i].

    valid: optional [N] mask for padded entries. Returns (R, t, w, inlier_rms)
    as tensors on `device`, where w are the final GNC-TLS weights in [0, 1]
    (0 = rejected outlier) and inlier_rms is the weighted residual RMS."""
    dev = resolve_device(device)
    src, dst = _f32(src, dev), _f32(dst, dev)
    N = src.shape[0]
    vmask = torch.ones((N,), dtype=torch.float32, device=dev) if valid is None else _f32(valid, dev)
    c2 = torch.tensor(np.float32(noise_bound) ** 2, device=dev)
    hard = torch.tensor(np.float32(1e6), device=dev)

    # init: unweighted fit; mu from the max residual (GNC schedule start)
    R, t = _weighted_horn(src, dst, vmask)
    r2 = _sq_norm(_moved(src, R, t) - dst) * vmask
    r2max = torch.maximum(r2.max(), c2 * (1.0 + 1e-3))
    mu = c2 / (2.0 * r2max - c2)
    for _ in range(iters):
        r2 = _sq_norm(_moved(src, R, t) - dst)
        w = _gnc_tls_weights(r2, mu, c2) * vmask
        R, t = _weighted_horn(src, dst, w)
        mu = torch.clamp_max(mu * 1.4, 1e6)
    # final polish: hard-TLS inlier set, unweighted refit (TEASER's last step)
    for _ in range(2):
        r2 = _sq_norm(_moved(src, R, t) - dst)
        w = _gnc_tls_weights(r2, hard, c2) * vmask
        # keep the previous estimate if the hard inlier set is degenerate
        wr, tr = _weighted_horn(src, dst, w)
        ok = w.sum() >= 3.0
        R = torch.where(ok, wr, R)
        t = torch.where(ok, tr, t)
    r2 = _sq_norm(_moved(src, R, t) - dst)
    w = _gnc_tls_weights(r2, hard, c2) * vmask  # hard TLS verdict
    wsum = torch.clamp_min(w.sum(), 1e-9)
    inlier_rms = torch.sqrt((w * r2).sum() / wsum)
    return R, t, w, inlier_rms


def _nearest(moved: torch.Tensor, dst: torch.Tensor):
    """(index of the nearest dst point, its squared distance) per moved point;
    the first index on ties."""
    d2 = _sq_norm(moved[:, None, :] - dst[None, :, :])
    return torch.argmin(d2, dim=1), d2


def robust_icp(src, dst, R0, t0, noise_bound: float = 0.1, outer_iters: int = 12, gnc_iters: int = 12,
               device=None):
    """ICP with a GNC-TLS robust core: outer rounds re-associate by nearest
    neighbour under the current estimate; the inner solve downweights wrong
    associations instead of trusting them (plain point-to-point ICP's failure
    mode under partial overlap). Returns (R, t, inlier_rms, inlier_fraction)
    as tensors on `device`."""
    dev = resolve_device(device)
    src, dst = _f32(src, dev), _f32(dst, dev)
    c2 = np.float32(noise_bound) ** 2
    # anneal the truncation over outer rounds: loose early (capture region
    # with a coarse initialization), tight late (precision)
    c2_sched = (c2 * np.geomspace(4.0, 1.0, outer_iters).astype(np.float32)).astype(np.float32)
    R, t = _f32(R0, dev), _f32(t0, dev)
    for c2_round in c2_sched:
        c2_round = torch.tensor(c2_round, device=dev)
        nn, _ = _nearest(_moved(src, R, t), dst)
        target = dst[nn]
        r2 = _sq_norm(_moved(src, R, t) - target)
        r2max = torch.maximum(r2.max(), c2_round * (1.0 + 1e-3))
        mu = c2_round / (2.0 * r2max - c2_round)
        for _ in range(gnc_iters):
            r2 = _sq_norm(_moved(src, R, t) - target)
            w = _gnc_tls_weights(r2, mu, c2_round)
            R, t = _weighted_horn(src, target, w)
            mu = torch.clamp_max(mu * 1.6, 1e6)
    _, d2 = _nearest(_moved(src, R, t), dst)
    r2 = d2.amin(dim=1)
    w = _gnc_tls_weights(r2, torch.tensor(np.float32(1e6), device=dev), torch.tensor(c2, device=dev))
    wsum = torch.clamp_min(w.sum(), 1e-9)
    inlier_rms = torch.sqrt((w * r2).sum() / wsum)
    inlier_fraction = w.mean()
    return R, t, inlier_rms, inlier_fraction
