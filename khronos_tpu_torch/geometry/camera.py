"""Pinhole camera model: projection, back-projection, vertex/range images.

Port of `khronos_tpu/geometry/camera.py`. Conventions: depth image is z-depth
along the optical axis (meters, float32), image shape [H, W]; camera frame is
x-right, y-down, z-forward; `T_w_c=(R,t)` maps camera points to world.

The pixel rays are computed once on the host in float32 numpy (IEEE division,
as the reference's constant-folded rays) and cached per device. Poses stay
host numpy float32 (FrameData's contract); the small 3x3 products are written
out elementwise in j = 0, 1, 2 order with the pose entries as scalars: their
results feed decisions (voxel index floors, in-image tests), so they avoid a
matmul whose accumulation order and TF32 setting are the library's choice,
and no pose is copied to the device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from khronos_tpu_torch import true_div


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

    def pixel_rays_np(self) -> np.ndarray:
        """Unit-z ray directions per pixel in camera frame: [H, W, 3] float32."""
        u = np.arange(self.width, dtype=np.float32) + np.float32(0.5)
        v = np.arange(self.height, dtype=np.float32) + np.float32(0.5)
        uu, vv = np.meshgrid(u, v)
        x = (uu - np.float32(self.cx)) / np.float32(self.fx)
        y = (vv - np.float32(self.cy)) / np.float32(self.fy)
        return np.stack([x, y, np.ones_like(x)], axis=-1)

    def pixel_rays(self, device) -> torch.Tensor:
        key = str(torch.device(device))
        cache = self.__dict__.setdefault("_rays", {})  # frozen dataclass: no setattr
        if key not in cache:
            cache[key] = torch.from_numpy(self.pixel_rays_np()).to(device)
        return cache[key]

    def back_project(self, depth: torch.Tensor) -> torch.Tensor:
        """Depth [H, W] -> camera-frame vertex image [H, W, 3]."""
        return self.pixel_rays(depth.device) * depth[..., None]

    def vertex_image_world(self, depth: torch.Tensor, R_w_c, t_w_c) -> torch.Tensor:
        """Depth + host pose -> world-frame vertex image [H, W, 3]."""
        return transform_points(self.back_project(depth), R_w_c, t_w_c)

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


def transform_points(p: torch.Tensor, R_w_c, t_w_c) -> torch.Tensor:
    """Camera points p [..., 3] -> world (p @ R.T + t), R and t host float32."""
    R, t = _host_pose(R_w_c, t_w_c)
    cols = [
        p[..., 0] * R[i][0] + p[..., 1] * R[i][1] + p[..., 2] * R[i][2] + t[i]
        for i in range(3)
    ]
    return torch.stack(cols, dim=-1)


def world_to_camera(p_w, R_w_c, t_w_c):
    """World points (a list of 3 component tensors) -> camera-frame
    components [R^T (p - t)]_i, summed j = 0, 1, 2."""
    R, t = _host_pose(R_w_c, t_w_c)
    d = [p_w[j] - t[j] for j in range(3)]
    return [d[0] * R[0][i] + d[1] * R[1][i] + d[2] * R[2][i] for i in range(3)]


def voxel_floor(points: torch.Tensor, voxel_size: float) -> torch.Tensor:
    """floor(points / voxel_size) as int32, with true division."""
    return torch.floor(true_div(points, voxel_size)).to(torch.int32)
