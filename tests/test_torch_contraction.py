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

The renderer's sphere march (`data/synthetic.py:126-186`): the point
t + dirs * t_acc is one fma a component; the sphere's norm reduces its squares
from zero, fma(z, z, fma(y, y, x * x)); the box's reduction starts from
x*x + y*y, which LLVM contracts into fma(x, x, y * y), then fma(z, z, .).
With these the march's t_hit is bit-exact; the final depth t_hit / |ray_c|
is compiled into t_hit * rsqrt(|ray_c|^2) with the host's rsqrt estimate,
refined (AVX-512's rsqrt14 on a host with AVX-512, AVX's rsqrtps when XLA
targets AVX2: the reference's depth bits depend on the host), which the
port cannot reproduce on every device: it multiplies by the correctly
rounded rsqrt (at most 2 ulps of depth apart, on about 15% of the pixels).

Each expression alone, bit for bit. Then inside the reference's compiled
programs, where XLA also fuses the operations around the dots: the volume
state after `integrate_frame` and after the fused frame step, the fused
step's cluster extremes and point samples (from its vertex image, whose
pixel rays multiply by the reciprocal of f inside the program), and the
object reconstruction, all bit for bit on office and apartment frames
(tolerance 0). The reference's modular window path calls its integrate_frame
outside jit, one XLA operation at a time, where nothing is fused: the port's
`integrate_frame(eager=True)`, and the modular window's volume, bit for bit
against it too."""

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


def test_renderer_march_point_matches_reference():
    """synthetic.py:169's `t_w_c + dirs * t_acc[..., None]` as the march body
    consumes it (q = p - centre, synthetic.py:128), jitted: one fma a
    component, bit for bit."""
    rng = np.random.default_rng(5)
    ref = jax.jit(lambda d, ta, t, c: (t + d * ta[..., None])[None] - c[:, None, None])
    d = rng.normal(size=(96, 128, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    for _ in range(4):
        ta = rng.uniform(0, 9, (96, 128)).astype(np.float32)
        t = rng.uniform(-5, 5, 3).astype(np.float32)
        c = rng.uniform(-3, 3, (4, 3)).astype(np.float32)
        want = np.asarray(ref(*(jnp.asarray(a) for a in (d, ta, t, c))))
        p = tsyn.march_point(torch.from_numpy(d), torch.from_numpy(ta), torch.from_numpy(t))
        np.testing.assert_array_equal((p[None] - torch.from_numpy(c)[:, None, None]).numpy(), want)


@pytest.mark.parametrize("seed", [0, 1])
def test_renderer_sdf_norms_match_reference(seed):
    """synthetic.py:126-136's `_primitive_sdf` (the box norm of max(d, 0) and
    the sphere norm of q), jitted and vmapped over the primitives as the
    renderer does, on random points: bit for bit."""
    rng = np.random.default_rng(seed)
    kinds = np.array([jsyn.ROOM, jsyn.BOX, jsyn.SPHERE, jsyn.BOX, jsyn.SPHERE, jsyn.BOX], np.int32)
    centers = rng.uniform(-3, 3, (6, 3)).astype(np.float32)
    halfs = rng.uniform(0.2, 2, (6, 3)).astype(np.float32)
    p = rng.uniform(-5, 5, (128, 160, 3)).astype(np.float32)
    ref = jax.jit(lambda k, c, h, p: jax.vmap(lambda k, c, h: jsyn._primitive_sdf(k, c, h, p))(k, c, h))
    want = np.asarray(ref(kinds, centers, halfs, p))
    got = tsyn._primitive_sdf(*(torch.from_numpy(a) for a in (kinds, centers, halfs, p))).numpy()
    np.testing.assert_array_equal(got, want)


def _reference_render_with_t_hit():
    """A copy of the reference's jitted `_render` that also returns t_hit."""
    import inspect

    src = inspect.getsource(jsyn._render).replace(
        "    return depth, label_img, color_img, hit_prim, hit_ok",
        "    return depth, label_img, color_img, hit_prim, hit_ok, t_hit")
    ns = dict(vars(jsyn))
    exec(src, ns)
    return ns["_render"]


@pytest.mark.parametrize("scene_name,index", [("office", 10), ("apartment", 10), ("apartment", 85)])
def test_renderer_march_bit_exact_inside_reference_program(scene_name, index):
    """The whole 96-step march at 60x80: the port's depth is the reference's
    own t_hit times the correctly rounded rsqrt of |ray_c|^2, bit for bit
    (so t_hit is bit-exact); labels, colour, hit mask and primitive bit for
    bit; depth within 2 ulps of the reference's (its rsqrt estimate)."""
    dur = 10.0
    cfg = jsyn.SyntheticSequenceConfig(duration=dur, fps=10.0, height=60, width=80, fx=50.0, fy=50.0, cx=40.0, cy=30.0)
    scene = jsyn.office_scene(dur) if scene_name == "office" else jsyn.apartment_scene(dur)
    jseq = jsyn.SyntheticSequence(scene, cfg)
    tscene = tsyn.office_scene(dur) if scene_name == "office" else tsyn.apartment_scene(dur)
    t = index / cfg.fps
    R, pos = jseq.pose_at(t)
    want = [np.asarray(a) for a in _reference_render_with_t_hit()(
        *jseq.scene.device_arrays(t), jseq._rays, jnp.asarray(R), jnp.asarray(pos), jnp.float32(cfg.max_range),
        cfg.height, cfg.width)]
    rays = torch.from_numpy(np.array(jseq._rays))
    got = [a.numpy() for a in tsyn._render(*tscene.device_arrays(t, "cpu"), rays, R, pos, cfg.max_range)]
    for name, a, b in zip(("labels", "color", "hit_prim", "hit_ok"), want[1:5], got[1:5]):
        np.testing.assert_array_equal(b, a, err_msg=name)
    rsqrt = (1.0 / torch.sqrt(torch.from_numpy(
        np.asarray(tsyn._sum_sq3(rays))).double())).float().numpy()
    np.testing.assert_array_equal(got[0], np.where(want[4], want[5] * rsqrt, 0.0).astype(np.float32))
    ulps = np.abs(got[0].view(np.int32).astype(np.int64) - want[0].view(np.int32))
    assert ulps.max() <= 2 and want[4].mean() > 0.5


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


@pytest.mark.parametrize("scene_name,hw", [("office", (48, 64)), ("apartment", (60, 80))])
def test_integrate_frame_bit_exact_against_reference_eager_call(scene_name, hw):
    """The reference's integrate_frame called eagerly (as its modular window
    path calls it) and the port's with eager=True, frame after frame from the
    same start: every state field bit for bit."""
    cam, frames = _sequence(scene_name, 6, *hw)
    vc = jbuild(JConfig, {"volumetric_map": {"grid_shape": GRID, "voxel_size": 0.1}}).volumetric_map
    js, ts = _start_state(vc, frames[0])
    tcam = torch_camera(cam)
    for f in frames:
        excl = np.zeros(hw, bool)
        js = jav.integrate_frame(vc, cam, js, jnp.asarray(f["depth"]), jnp.asarray(f["color"]),
                                 jnp.asarray(f["labels"]), jnp.asarray(excl), f["R_w_c"], f["t_w_c"],
                                 jnp.float32(f["t"]))
        ts = tav.integrate_frame(vc, tcam, ts, torch.from_numpy(f["depth"]), torch.from_numpy(f["color"]),
                                 torch.from_numpy(f["labels"]), torch.from_numpy(excl), f["R_w_c"], f["t_w_c"],
                                 f["t"], eager=True)
    _assert_state_bits(js, ts)
    assert float(np.asarray(js.weight).sum()) > 0


def test_update_archival_horizon_rounds_as_the_reference():
    """update_archival's horizon t_now - temporal_window: the reference's
    compiled programs (a float32 t_now) take the float32 difference, its
    modular path (outside jit, a Python t_now) the float64 difference
    rounded once. Voxels last observed at every frame stamp of 5 frames/s,
    archived at t = 3.0 .. 4.6 s: the port's default and eager=True give
    each reference's flags, bit for bit, and the two references differ."""
    vc = jbuild(JConfig, {"volumetric_map": {"grid_shape": [32, 8, 8], "voxel_size": 0.1}}).volumetric_map
    stamps = np.asarray([np.float32(k * 200_000_000 * 1e-9) for k in range(32)], np.float32)
    last_obs = np.broadcast_to(stamps[:, None, None], (32, 8, 8)).copy()
    js = jav.create(vc)._replace(weight=jnp.ones((32, 8, 8), jnp.float32), last_obs=jnp.asarray(last_obs))
    ts = tav.state_from_numpy([np.asarray(a) for a in js], device="cpu")
    jitted = jax.jit(functools.partial(jav.update_archival, vc))
    differ = 0
    for k in range(15, 24):
        t_now = k * 200_000_000 * 1e-9  # as the window computes it from stamps
        want_eager = np.asarray(jav.update_archival(vc, js, t_now).archived)
        want_jit = np.asarray(jitted(js, jnp.float32(t_now)).archived)
        np.testing.assert_array_equal(tav.update_archival(vc, ts, t_now, eager=True).archived.numpy(), want_eager)
        np.testing.assert_array_equal(tav.update_archival(vc, ts, t_now).archived.numpy(), want_jit)
        differ += int((want_eager != want_jit).sum())
    assert differ > 0


def test_modular_window_volume_bit_exact():
    """ActiveWindow(fused=False) in both packages on the same office frames:
    the volume after every frame bit for bit (the modular path's
    integration rounds as the reference's eager call)."""
    from khronos_tpu.active_window.active_window import ActiveWindow as JWindow
    from khronos_tpu.active_window.frame_data import FrameData as JFrame
    from khronos_tpu_torch.active_window.active_window import ActiveWindow as TWindow
    from khronos_tpu_torch.active_window.frame_data import FrameData as TFrame

    cam, frames = _sequence("office", 6, 48, 64)
    cfg = {"fused": False, "volumetric_map": {"grid_shape": GRID, "voxel_size": 0.1},
           "motion_detector": {"type": "FreeSpaceMotionDetector", "min_cluster_size": 20},
           "object_detector": {"type": "ConnectedSemantics", "min_cluster_size": 5}}
    ls = jsyn.default_label_space()
    jaw = JWindow(jbuild(JConfig, cfg), cam, ls)
    taw = TWindow(tbuild(TConfig, cfg), torch_camera(cam), torch_label_space(ls), device="cpu")
    for f in frames:
        jaw.spin_once(JFrame(stamp_ns=f["stamp_ns"], depth=jnp.asarray(f["depth"]), color=jnp.asarray(f["color"]),
                             labels=jnp.asarray(f["labels"]), R_w_c=f["R_w_c"], t_w_c=f["t_w_c"]))
        taw.spin_once(TFrame(stamp_ns=f["stamp_ns"], depth=torch.from_numpy(f["depth"]),
                             color=torch.from_numpy(f["color"]), labels=torch.from_numpy(f["labels"]),
                             R_w_c=f["R_w_c"], t_w_c=f["t_w_c"]))
        _assert_state_bits(jaw.state, taw.state)
    assert taw._fused_step is None and float(taw.state.weight.sum()) > 0


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
