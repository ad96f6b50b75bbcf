"""SE(3)/SO(3) utilities in PyTorch (float32, batched over leading dims).

Port of `khronos_tpu/geometry/transforms.py`. Poses are (R, t) with R:
[..., 3, 3], t: [..., 3], mapping sensor/body points into world:
p_w = R @ p_s + t. Also the exp/log maps used by the pose-graph backend
(Gauss-Newton on SE(3) with right-multiplicative increments).

The factor-graph optimizer takes forward-mode Jacobians
(`torch.func.jacfwd`) of these maps at xi = 0, which is exactly the
small-angle branch of every `torch.where` below. So each branch stays finite
where it is not taken: `_safe_theta` keeps theta away from 0, and the Taylor
branches switch at t2 < 1e-3, as in the reference. A NaN in an untaken
branch would poison the whole Jacobian.
"""

from __future__ import annotations

import torch

_TINY = 1e-12


def _safe_theta(w: torch.Tensor):
    """Differentiable-at-zero rotation angle: [..., 3] -> ([...,1,1] theta,
    [...,1,1] theta^2). Derivatives are exact for theta > sqrt(_TINY) and zero
    (not NaN) at w = 0."""
    theta2 = torch.sum(w * w, dim=-1, keepdim=True)[..., None]
    theta = torch.sqrt(torch.clamp_min(theta2, _TINY))
    return theta, theta2


def _eye_like(K: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=K.dtype, device=K.device).expand(K.shape)


def hat(w: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator: [..., 3] -> [..., 3, 3]."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([zero, -wz, wy], dim=-1),
            torch.stack([wz, zero, -wx], dim=-1),
            torch.stack([-wy, wx, zero], dim=-1),
        ],
        dim=-2,
    )


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: [..., 3] axis-angle -> [..., 3, 3] rotation."""
    theta, t2 = _safe_theta(w)
    K = hat(w)
    K2 = K @ K
    # wide Taylor branch: 1-cos(theta) is float32-degenerate below ~3e-2
    small = t2 < 1e-3
    a = torch.where(small, 1.0 - t2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - t2 / 24.0, (1.0 - torch.cos(theta)) / (theta * theta))
    return _eye_like(K) + a * K + b * K2


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] rotation -> [..., 3] axis-angle."""
    # atan2 formulation: |w_skew| = 2 sin(theta), trace = 1 + 2 cos(theta);
    # arccos has an infinite derivative at theta = 0, atan2 is smooth there
    # (keepdim throughout: PyTorch's forward-mode AD under vmap gives 0-dim
    # float32 tensors float64 tangents in clamp and pow)
    trace = torch.diagonal(R, dim1=-2, dim2=-1).sum(dim=-1, keepdim=True)
    cos_theta = torch.clamp((trace - 1.0) / 2.0, -1.0, 1.0)
    w_skew = torch.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        dim=-1,
    )
    sin_theta = 0.5 * torch.sqrt(torch.clamp_min(torch.sum(w_skew * w_skew, dim=-1, keepdim=True), _TINY))
    theta = torch.atan2(sin_theta, cos_theta)
    small = sin_theta < 1e-5
    safe_sin = torch.where(small, 1.0, sin_theta)
    scale = torch.where(small, 0.5 + theta**2 / 12.0, theta / (2.0 * safe_sin))
    return scale * w_skew


def se3_exp(xi: torch.Tensor):
    """[..., 6] (rho, w) -> (R [...,3,3], t [...,3]). rho = translation part."""
    rho, w = xi[..., :3], xi[..., 3:]
    R = so3_exp(w)
    theta, t2 = _safe_theta(w)
    K = hat(w)
    K2 = K @ K
    small = t2 < 1e-3
    b = torch.where(small, 0.5 - t2 / 24.0, (1.0 - torch.cos(theta)) / (theta * theta))
    c = torch.where(
        small, 1.0 / 6.0 - t2 / 120.0, (theta - torch.sin(theta)) / (theta * theta * theta)
    )
    V = _eye_like(K) + b * K + c * K2
    t = (V @ rho[..., None])[..., 0]
    return R, t


def se3_log(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(R, t) -> [..., 6] (rho, w)."""
    w = so3_log(R)
    theta, t2 = _safe_theta(w)
    K = hat(w)
    K2 = K @ K
    # V^{-1} = I - K/2 + (1/theta^2)(1 - theta sin / (2 (1-cos))) K^2; the
    # Taylor branch covers every theta where 1-cos(theta) is degenerate in
    # float32 (catastrophic near 1.0): switch at theta ~ 3e-2
    small = t2 < 1e-3
    denom = torch.where(small, 1.0, torch.clamp_min(2.0 * (1.0 - torch.cos(theta)), 1e-9))
    coef = torch.where(
        small,
        1.0 / 12.0 + t2 / 720.0,
        (1.0 - theta * torch.sin(theta) / denom) / torch.clamp_min(theta * theta, 1e-12),
    )
    Vinv = _eye_like(K) - 0.5 * K + coef * K2
    rho = (Vinv @ t[..., None])[..., 0]
    return torch.cat([rho, w], dim=-1)


def compose(Ra, ta, Rb, tb):
    """(Ra,ta) ∘ (Rb,tb): first apply b, then a."""
    return Ra @ Rb, (Ra @ tb[..., None])[..., 0] + ta


def inverse(R, t):
    Rt = R.transpose(-1, -2)
    return Rt, -(Rt @ t[..., None])[..., 0]


def transform_points(R, t, points):
    """Apply pose to points [..., N, 3] (R,t broadcast over leading dims)."""
    return points @ R.transpose(-1, -2) + t[..., None, :]


def between(Ra, ta, Rb, tb):
    """Relative pose a^{-1} ∘ b (the 'between' factor measurement model)."""
    Ri, ti = inverse(Ra, ta)
    return compose(Ri, ti, Rb, tb)


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """[..., 4] (w, x, y, z) unit quaternion -> [..., 3, 3]."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
            torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
            torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
        ],
        dim=-2,
    )


def interpolate_pose(Ra, ta, Rb, tb, alpha):
    """Geodesic interpolation between two poses (alpha in [0,1])."""
    Rrel, trel = between(Ra, ta, Rb, tb)
    xi = se3_log(Rrel, trel)
    Ri, ti = se3_exp(alpha * xi)
    return compose(Ra, ta, Ri, ti)
