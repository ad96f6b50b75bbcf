"""Pinhole camera model: projection, back-projection, vertex/range images.

Port of `khronos_tpu/geometry/camera.py`. Conventions: depth image is z-depth
along the optical axis (meters, float32), image shape [H, W]; camera frame is
x-right, y-down, z-forward; `T_w_c=(R,t)` maps camera points to world.

The pixel rays are computed once on the host in float32 numpy (IEEE division,
as the reference's constant-folded rays) and cached per device. Poses stay
host numpy float32 (FrameData's contract); the small 3x3 products are written
out elementwise with the pose entries as scalars, rounding as XLA CPU
compiles the reference's contractions (fused multiply-adds where it fuses;
see `transform_points` and `world_to_camera`): their results feed decisions
(voxel index floors, in-image tests), so they avoid a matmul whose
accumulation order and TF32 setting are the library's choice, and no pose is
copied to the device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from khronos_tpu_torch import fma32, true_div


@dataclasses.dataclass(frozen=True)
class Camera:
    height: int
    width: int
    fx: float
    fy: float
    cx: float
    cy: float
    min_range: float = 0.1
    max_range: float = 5.0

    @property
    def intrinsics(self) -> np.ndarray:
        return np.array(
            [[self.fx, 0, self.cx], [0, self.fy, self.cy], [0, 0, 1]], dtype=np.float32
        )

    def pixel_rays_np(self, reciprocal: bool = False) -> np.ndarray:
        """Unit-z ray directions per pixel in camera frame: [H, W, 3] float32.

        The reference's rays divide by fx and fy with IEEE division where
        they are computed op by op (the renderer, the modular detectors, the
        LCD payload), and multiply by the float32 reciprocal inside a
        compiled program (XLA CPU's division by a constant: the fused step's
        vertex image): `reciprocal=True` gives those."""
        u = np.arange(self.width, dtype=np.float32) + np.float32(0.5)
        v = np.arange(self.height, dtype=np.float32) + np.float32(0.5)
        uu, vv = np.meshgrid(u, v)
        if reciprocal:
            x = (uu - np.float32(self.cx)) * (np.float32(1) / np.float32(self.fx))
            y = (vv - np.float32(self.cy)) * (np.float32(1) / np.float32(self.fy))
        else:
            x = (uu - np.float32(self.cx)) / np.float32(self.fx)
            y = (vv - np.float32(self.cy)) / np.float32(self.fy)
        return np.stack([x, y, np.ones_like(x)], axis=-1)

    def pixel_rays(self, device, reciprocal: bool = False) -> torch.Tensor:
        key = (str(torch.device(device)), reciprocal)
        cache = self.__dict__.setdefault("_rays", {})  # frozen dataclass: no setattr
        if key not in cache:
            cache[key] = torch.from_numpy(self.pixel_rays_np(reciprocal)).to(device)
        return cache[key]

    def back_project(self, depth: torch.Tensor, reciprocal: bool = False) -> torch.Tensor:
        """Depth [H, W] -> camera-frame vertex image [H, W, 3]."""
        return self.pixel_rays(depth.device, reciprocal) * depth[..., None]

    def vertex_image_world(self, depth: torch.Tensor, R_w_c, t_w_c, reciprocal: bool = False) -> torch.Tensor:
        """Depth + host pose -> world-frame vertex image [H, W, 3]."""
        return transform_points(self.back_project(depth, reciprocal), R_w_c, t_w_c)

    def project(self, points_c: torch.Tensor):
        """Camera-frame points [..., 3] -> (u [..,], v [..], z [..]), float pixel coords."""
        z = points_c[..., 2]
        safe_z = torch.where(z.abs() > 1e-6, z, torch.full_like(z, 1e-6))
        u = points_c[..., 0] / safe_z * self.fx + self.cx
        v = points_c[..., 1] / safe_z * self.fy + self.cy
        return u, v, z

    def in_image(self, u, v, margin: float = 0.0):
        return (
            (u >= margin)
            & (u <= self.width - 1 - margin)
            & (v >= margin)
            & (v <= self.height - 1 - margin)
        )


def _host_pose(R_w_c, t_w_c):
    R = np.asarray(R_w_c, np.float32).tolist()
    t = np.asarray(t_w_c, np.float32).tolist()
    return R, t


def fma_dot3(x, coeffs):
    """fma(x2, c2, fma(x1, c1, x0 * c0)): XLA CPU's float32 dot of a 3-vector,
    the product of j = 0 rounded, then j = 1 and j = 2 each fused."""
    acc = x[0] * coeffs[0]
    for j in (1, 2):
        acc = fma32(x[j], coeffs[j], acc)
    return acc


def transform_points(p: torch.Tensor, R_w_c, t_w_c) -> torch.Tensor:
    """Camera points p [..., 3] -> world (p @ R.T + t), R and t host float32.

    Rounds as XLA CPU compiles the reference's `pts_c @ R_w_c.T + t_w_c`
    (`khronos_tpu/geometry/camera.py:58`, and the renderer's rotation einsum):
    component i is the fma chain over j = 0, 1, 2 (`fma_dot3`), then
    `+ t[i]` as a rounding of its own. Bit for bit in
    tests/test_torch_contraction.py, alone and inside the reference's fused
    frame step."""
    R, t = _host_pose(R_w_c, t_w_c)
    x = [p[..., j] for j in range(3)]
    return torch.stack([fma_dot3(x, R[i]) + t[i] for i in range(3)], dim=-1)


def world_to_camera(p_w, R_w_c, t_w_c, scale=None):
    """World points (a list of 3 component tensors) -> camera-frame
    components [R^T (p - t)]_i; with `scale`, the points are p_w * scale and
    each p_w[j] * scale - t[j] is one fused rounding (as XLA CPU compiles
    voxel centers less t in the reference's integrate_frame).

    Rounds as XLA CPU compiles the reference's
    `einsum("ji,xyzj->xyzi", R_w_c, p - t)` (`map/active_volume.py:179`):
    components 0 and 1 are the plain chain (each product rounded, summed
    j = 0, 1, 2), component 2 the fma chain. Bit for bit in
    tests/test_torch_contraction.py."""
    R, t = _host_pose(R_w_c, t_w_c)
    if scale is None:
        d = [p_w[j] - t[j] for j in range(3)]
    else:
        d = [fma32(p_w[j], scale, -t[j]) for j in range(3)]
    out = [d[0] * R[0][i] + d[1] * R[1][i] + d[2] * R[2][i] for i in range(2)]
    return out + [fma_dot3(d, [R[0][2], R[1][2], R[2][2]])]


def voxel_floor(points: torch.Tensor, voxel_size: float) -> torch.Tensor:
    """floor(points / voxel_size) as int32, with true division."""
    return torch.floor(true_div(points, voxel_size)).to(torch.int32)


def bilinear_sample(image: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Bilinear interpolation of image [H, W] (or [H, W, C]) at float coords."""
    H, W = image.shape[0], image.shape[1]
    u0 = torch.floor(u).to(torch.int32).clamp(0, W - 2)
    v0 = torch.floor(v).to(torch.int32).clamp(0, H - 2)
    du = (u - u0).clamp(0.0, 1.0)
    dv = (v - v0).clamp(0.0, 1.0)
    if image.dim() == 3:
        du, dv = du[..., None], dv[..., None]
    u0, v0 = u0.long(), v0.long()
    i00 = image[v0, u0]
    i01 = image[v0, u0 + 1]
    i10 = image[v0 + 1, u0]
    i11 = image[v0 + 1, u0 + 1]
    return (
        i00 * (1 - du) * (1 - dv)
        + i01 * du * (1 - dv)
        + i10 * (1 - du) * dv
        + i11 * du * dv
    )


def nearest_sample(image: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbor lookup (for label/id images); ties round to even, as
    jnp.round does."""
    H, W = image.shape[0], image.shape[1]
    ui = torch.round(u).to(torch.int32).clamp(0, W - 1).long()
    vi = torch.round(v).to(torch.int32).clamp(0, H - 1).long()
    return image[vi, ui]
