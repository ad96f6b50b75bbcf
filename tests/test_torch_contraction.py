"""Port parity: the reference's 3x3 contractions, rounded as XLA CPU does.

XLA's CPU build contracts the reference's small float32 dots into fused
multiply-adds, and the port reproduces each pattern found by probing the
compiled reference (`khronos_tpu_torch.fma32`):

- `pts_c @ R_w_c.T + t_w_c` (`khronos_tpu/geometry/camera.py:58`) and the
  renderer's `einsum("ij,hwj->hwi", R, rays)` (`data/synthetic.py:155`):
  component i = fma(x2, R[i,2], fma(x1, R[i,1], x0 * R[i,0])), then + t[i]
  as a rounding of its own (the port's `transform_points`, `fma_dot3`);
- `einsum("ji,xyzj->xyzi", R, p - t)` (`map/active_volume.py:179`):
  components 0 and 1 the plain chain, component 2 the fma chain
  (`world_to_camera`).

Each expression alone, bit for bit. Then inside the reference's compiled
programs, where XLA also fuses the operations around the dots: the volume
state after `integrate_frame` and after the fused frame step, the fused
step's cluster extremes and point samples (from its vertex image, whose
pixel rays multiply by the reciprocal of f inside the program), and the
object reconstruction, all bit for bit on office and apartment frames
(tolerance 0)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from khronos_tpu.active_window import fused_step as jfs
from khronos_tpu.active_window.active_window import ActiveWindowConfig as JConfig
from khronos_tpu.config import build as jbuild
from khronos_tpu.data import synthetic as jsyn
from khronos_tpu.map import active_volume as jav
from khronos_tpu_torch.active_window import fused_step as tfs
from khronos_tpu_torch.active_window.active_window import ActiveWindowConfig as TConfig
from khronos_tpu_torch.config import build as tbuild
from khronos_tpu_torch.data import synthetic as tsyn
from khronos_tpu_torch.geometry.camera import transform_points, world_to_camera
from khronos_tpu_torch.map import active_volume as tav

from torch_parity import torch_camera, torch_label_space

GRID = [64, 64, 32]


def _rotations(rng, n):
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q.T
    R = np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], 1)
    return R.astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_transform_points_matches_reference_matmul(seed):
    """camera.py:58's `pts_c @ R_w_c.T + t_w_c`, jitted, bit for bit."""
    rng = np.random.default_rng(seed)
    ref = jax.jit(lambda p, R, t: p @ R.T + t)
    for R in _rotations(rng, 4):
        p = rng.uniform(-6, 6, (60, 80, 3)).astype(np.float32)
        t = rng.uniform(-5, 5, 3).astype(np.float32)
        want = np.asarray(ref(jnp.asarray(p), jnp.asarray(R), jnp.asarray(t)))
        got = transform_points(torch.from_numpy(p), R, t).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("hw", [(60, 80), (240, 320)])
def test_renderer_ray_rotation_matches_reference_einsum(hw):
    """synthetic.py:155's `einsum("ij,hwj->hwi", R_w_c, rays_c)`, jitted, on the
    renderer's own rays, bit for bit."""
    H, W = hw
    rng = np.random.default_rng(H)
    cam = tsyn.Camera(H, W, W * 0.625, W * 0.625, W / 2, H / 2)
    rays = cam.pixel_rays("cpu")
    ref = jax.jit(lambda R, r: jnp.einsum("ij,hwj->hwi", R, r))
    for R in _rotations(rng, 4):
        want = np.asarray(ref(jnp.asarray(R), jnp.asarray(rays.numpy())))
        got = tsyn.rotate_rays(rays, R).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(64, 64, 16), (40, 24, 48)])
def test_world_to_camera_matches_reference_einsum(shape):
    """active_volume.py:179's `einsum("ji,xyzj->xyzi", R_w_c, p)` of p = points
    less t, jitted, bit for bit."""
    rng = np.random.default_rng(shape[0])
    ref = jax.jit(lambda R, p, t: jnp.einsum("ji,xyzj->xyzi", R, p - t))
    for R in _rotations(rng, 4):
        p = rng.uniform(-8, 8, (*shape, 3)).astype(np.float32)
        t = rng.uniform(-5, 5, 3).astype(np.float32)
        want = np.asarray(ref(jnp.asarray(R), jnp.asarray(p), jnp.asarray(t)))
        got = world_to_camera([torch.from_numpy(p[..., j]) for j in range(3)], R, t)
        np.testing.assert_array_equal(torch.stack(got, -1).numpy(), want)


def _sequence(scene_name, n, H, W):
    dur = n / 10 + 1
    scene = jsyn.office_scene(dur) if scene_name == "office" else jsyn.apartment_scene(dur)
    seq = jsyn.SyntheticSequence(scene, jsyn.SyntheticSequenceConfig(
        duration=dur, fps=10.0, height=H, width=W, fx=W * 0.625, fy=W * 0.625, cx=W / 2, cy=H / 2))
    frames = []
    for i in range(n):
        f = seq.render_frame(i)
        frames.append({k: (np.array(v) if hasattr(v, "shape") else v) for k, v in f.items()})
    return seq.camera, frames


def _start_state(vol_cfg, frame):
    origin = np.floor(np.asarray(frame["t_w_c"]) / 0.1 - np.asarray(GRID) / 2.0).astype(np.int32)
    js = jav.create(vol_cfg)._replace(origin=jnp.asarray(origin))
    return js, tav.state_from_numpy([np.asarray(a) for a in js], device="cpu")


def _assert_state_bits(js, ts):
    got = tav.state_to_numpy(ts)
    for name, a, b in zip(got._fields, js, got):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=name)


@pytest.mark.parametrize("scene_name,hw", [("office", (48, 64)), ("apartment", (60, 80))])
def test_integrate_frame_bit_exact_inside_reference_program(scene_name, hw):
    """The reference's jitted integrate_frame and the port's, frame after
    frame from the same start: every state field bit for bit."""
    cam, frames = _sequence(scene_name, 8, *hw)
    vc = jbuild(JConfig, {"volumetric_map": {"grid_shape": GRID, "voxel_size": 0.1}}).volumetric_map
    js, ts = _start_state(vc, frames[0])
    jint = jax.jit(functools.partial(jav.integrate_frame, vc, cam))
    tcam = torch_camera(cam)
    for f in frames:
        excl = np.zeros(hw, bool)
        js = jint(js, jnp.asarray(f["depth"]), jnp.asarray(f["color"]), jnp.asarray(f["labels"]), jnp.asarray(excl),
                  jnp.asarray(f["R_w_c"]), jnp.asarray(f["t_w_c"]), jnp.float32(f["t"]))
        ts = tav.integrate_frame(vc, tcam, ts, torch.from_numpy(f["depth"]), torch.from_numpy(f["color"]),
                                 torch.from_numpy(f["labels"]), torch.from_numpy(excl), f["R_w_c"], f["t_w_c"], f["t"])
    _assert_state_bits(js, ts)
    assert float(np.asarray(js.weight).sum()) > 0


@pytest.mark.parametrize("scene_name,hw,stride", [("office", (48, 64), 2), ("office", (48, 64), 1),
                                                  ("apartment", (60, 80), 2)])
def test_fused_step_bit_exact_inside_reference_program(scene_name, hw, stride):
    """The fused frame step: the state bit for bit, and the cluster extremes
    and point samples (from the vertex image) bit for bit. The centroid sums
    add their terms in another order and are not compared here
    (tests/test_torch_fused_step.py holds them)."""
    cam, frames = _sequence(scene_name, 12, *hw)
    d = {"volumetric_map": {"grid_shape": GRID, "voxel_size": 0.1},
         "motion_detector": {"type": "FreeSpaceMotionDetector", "min_cluster_size": 20},
         "object_detector": {"type": "ConnectedSemantics", "min_cluster_size": 5}}
    jc, tc = jbuild(JConfig, d), tbuild(TConfig, d)
    ls = jsyn.default_label_space()
    jstep = jfs.make_frame_step(jc.volumetric_map, cam, jc.motion_detector.config, jc.object_detector.config, ls,
                                detection_stride=stride, donate=False)
    tstep = tfs.make_frame_step(tc.volumetric_map, torch_camera(cam), tc.motion_detector.config,
                                tc.object_detector.config, torch_label_space(ls), detection_stride=stride)
    js, ts = _start_state(jc.volumetric_map, frames[0])
    n = tfs.MC * 12
    clusters = 0
    for f in frames:
        js, _, jo, jp = jstep(js, jnp.asarray(f["depth"]), jnp.asarray(f["color"]), jnp.asarray(f["labels"]),
                              f["R_w_c"], f["t_w_c"], jnp.float32(f["t"]))
        ts, _, to, tp = tstep(ts, torch.from_numpy(f["depth"]), torch.from_numpy(f["color"]),
                              torch.from_numpy(f["labels"]), f["R_w_c"], f["t_w_c"], f["t"])
        jp, tp = np.asarray(jp), tp.numpy()
        for part in (slice(0, n), slice(n, 2 * n)):
            np.testing.assert_array_equal(jp[part].reshape(tfs.MC, 12)[:, 3:], tp[part].reshape(tfs.MC, 12)[:, 3:])
        np.testing.assert_array_equal(jp[2 * n:], tp[2 * n:])
        clusters += int(np.asarray(jo).max())
    _assert_state_bits(js, ts)
    assert clusters > 0


def test_reconstruct_bit_exact_inside_reference_program():
    """The object reconstruction's scan (centers, projection, range, weighted
    mean): tsdf, weights and confidences bit for bit."""
    import test_torch_extraction as tx

    for ids in (tx.FRAME_IDS[:tx.K], tx.FRAME_IDS[2:]):
        (jt, jw, jc), (tt, tw, tc), _, _ = tx._reconstruct_both(ids)
        for name, a, b in (("tsdf", jt, tt), ("weight", jw, tw), ("confidence", jc, tc)):
            np.testing.assert_array_equal(a, b, err_msg=name)
