"""Port parity: geometry/camera.py and active_volume.voxel_centers.

Seeded depth images and poses go through the JAX camera and the port's. Rays,
back-projection, projection and the in-image test compute the same float32
operations in the same order and must match bit for bit. The world-frame
vertex image is a 3x3 matmul in the reference and elementwise fused
multiply-adds in the port (XLA CPU's rounding, bit for bit in
tests/test_torch_contraction.py): held here to 1e-6 m (a few ulp at 5 m)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from khronos_tpu.geometry.camera import Camera as JCamera
from khronos_tpu.map import active_volume as jav
from khronos_tpu_torch.geometry.camera import Camera as TCamera
from khronos_tpu_torch.map import active_volume as tav

CAMS = [
    (48, 64, 40.0, 40.0, 32.0, 24.0),
    (30, 40, 33.3, 31.7, 19.6, 15.2),
]


def _pose(rng):
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    w, x, y, z = q
    R = np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ], np.float32)
    return R, rng.uniform(-3, 3, 3).astype(np.float32)


@pytest.mark.parametrize("intrinsics", CAMS)
def test_camera_matches_reference(intrinsics):
    rng = np.random.default_rng(len(CAMS) + int(intrinsics[0]))
    jc, tc = JCamera(*intrinsics), TCamera(*intrinsics)
    H, W = jc.height, jc.width
    depth = rng.uniform(0.05, 6.0, (H, W)).astype(np.float32)
    R, t = _pose(rng)

    np.testing.assert_array_equal(np.asarray(jc.pixel_rays()), tc.pixel_rays("cpu").numpy())
    pc_j = np.asarray(jc.back_project(jnp.asarray(depth)))
    pc_t = tc.back_project(torch.from_numpy(depth)).numpy()
    np.testing.assert_array_equal(pc_j, pc_t)
    np.testing.assert_allclose(
        np.asarray(jc.vertex_image_world(jnp.asarray(depth), jnp.asarray(R), jnp.asarray(t))),
        tc.vertex_image_world(torch.from_numpy(depth), R, t).numpy(),
        rtol=0, atol=1e-6,
    )
    # points in front of, beside and behind the camera (z near 0 included)
    pts = rng.uniform(-2, 2, (500, 3)).astype(np.float32)
    pts[:10, 2] = 0.0
    uj, vj, zj = (np.asarray(a) for a in jc.project(jnp.asarray(pts)))
    ut, vt, zt = (a.numpy() for a in tc.project(torch.from_numpy(pts)))
    for a, b in ((uj, ut), (vj, vt), (zj, zt)):
        np.testing.assert_array_equal(a, b)
    for margin in (0.0, 2.0):
        np.testing.assert_array_equal(
            np.asarray(jc.in_image(jnp.asarray(uj), jnp.asarray(vj), margin)),
            tc.in_image(torch.from_numpy(ut), torch.from_numpy(vt), margin).numpy(),
        )


@pytest.mark.parametrize("origin", [(0, 0, 0), (-37, 12, -5)])
def test_voxel_centers_match_reference(origin):
    cfg = jav.VolumeConfig(grid_shape=(12, 10, 8), voxel_size=0.1)
    js = jav.create(cfg)._replace(origin=jnp.asarray(origin, jnp.int32))
    ts = tav.state_from_numpy([np.asarray(a) for a in js], device="cpu")
    np.testing.assert_array_equal(
        np.asarray(jav.voxel_centers(js, cfg.voxel_size)), tav.voxel_centers(ts, cfg.voxel_size).numpy()
    )
