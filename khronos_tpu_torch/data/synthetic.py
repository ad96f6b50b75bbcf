"""Synthetic scene generator + analytic RGB-D-semantic renderer (fake sensor).

Port of the clean-frame part of `khronos_tpu/data/synthetic.py`: parametric
indoor scenes (the office, the apartment and the four-room hard scene: a
room, static objects with semantic labels, objects with presence intervals,
humans walking along waypoint paths) and a camera orbit or waypoint tour,
rendered to depth / color / semantic-label / instance images by
sphere-tracing the scene SDF on the device (rounded as XLA CPU rounds the
reference's compiled renderer, tests/test_torch_contraction.py: all but the
final depth's rsqrt bit for bit), the open-set embeddings
(`instance_features`, `background_embeddings`: numpy's generators from the
reference's seeds, bit for bit), the drifted odometry (`odometry_pose`, the
same random walk as the reference: numpy's generator from the same seed), and
the ground-truth surface samples of the evaluation (`sample_scene_surface`,
host numpy), and the structured-light sensor noise (`SensorNoiseConfig`,
`_apply_sensor_noise`). The reference draws that noise with `jax.random`; the
port draws it from a torch.Generator on the CPU seeded from (noise.seed, frame
index), so a frame's noise is the same on the card and on the CPU, and its
parity with the reference is statistical (tests/test_torch_noise.py).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from khronos_tpu_torch import fma32, resolve_device, sqrt32
from khronos_tpu_torch.active_window.object_detection import LabelSpace
from khronos_tpu_torch.geometry.camera import Camera, fma_dot3

# primitive types
BOX, SPHERE, ROOM = 0, 1, 2


@dataclasses.dataclass
class Primitive:
    kind: int
    center: np.ndarray  # [3]
    half_extents: np.ndarray  # [3]; sphere radius in [0]
    label: int
    color: np.ndarray  # [3] in [0,1]
    name: str = ""
    # presence interval in seconds (long-term changes)
    t_appear: float = -np.inf
    t_disappear: float = np.inf
    # dynamic motion: waypoints [K,3] visited at times waypoint_times [K]
    waypoints: Optional[np.ndarray] = None
    waypoint_times: Optional[np.ndarray] = None
    # building structure: rendered, but not a ground-truth object instance
    structure: bool = False
    # primitives sharing a non-empty `group` are ONE object instance
    group: str = ""

    @property
    def is_dynamic(self) -> bool:
        return self.waypoints is not None

    def center_at(self, t: float) -> np.ndarray:
        if not self.is_dynamic:
            return self.center
        wt = self.waypoint_times
        w = self.waypoints
        if t <= wt[0]:
            return w[0]
        if t >= wt[-1]:
            return w[-1]
        k = int(np.searchsorted(wt, t) - 1)
        a = (t - wt[k]) / (wt[k + 1] - wt[k])
        return (1 - a) * w[k] + a * w[k + 1]

    def present_at(self, t: float) -> bool:
        return self.t_appear <= t <= self.t_disappear


@dataclasses.dataclass
class Scene:
    room_half_extents: np.ndarray  # room is a box centered at room_center
    room_center: np.ndarray
    primitives: List[Primitive]
    room_label: int = 0
    room_color: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0.7, 0.7, 0.65], np.float32)
    )

    def host_arrays(self, t: float):
        """Scene state at time t as numpy arrays, slot 0 being the room:
        (kinds, centers, halfs, labels, colors, present)."""
        P = len(self.primitives)
        kinds = np.zeros(P + 1, np.int32)
        centers = np.zeros((P + 1, 3), np.float32)
        halfs = np.ones((P + 1, 3), np.float32)
        labels = np.zeros(P + 1, np.int32)
        colors = np.zeros((P + 1, 3), np.float32)
        present = np.zeros(P + 1, np.bool_)
        kinds[0] = ROOM
        centers[0] = self.room_center
        halfs[0] = self.room_half_extents
        labels[0] = self.room_label
        colors[0] = self.room_color
        present[0] = True
        for i, p in enumerate(self.primitives):
            kinds[i + 1] = p.kind
            centers[i + 1] = p.center_at(t)
            halfs[i + 1] = p.half_extents
            labels[i + 1] = p.label
            colors[i + 1] = p.color
            present[i + 1] = p.present_at(t)
        return kinds, centers, halfs, labels, colors, present

    def device_arrays(self, t: float, device):
        """Pack the scene state at time t for the renderer, on `device`."""
        return tuple(torch.from_numpy(a).to(device) for a in self.host_arrays(t))


def _sum_sq3(v: torch.Tensor) -> torch.Tensor:
    """x*x + y*y + z*z over the last axis of 3 as XLA CPU reduces
    `jnp.linalg.norm`'s squares from its zero: fma(z, z, fma(y, y, x * x))."""
    x, y, z = v.unbind(-1)
    return fma32(z, z, fma32(y, y, x * x))


def _norm3(v: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis of 3, rounded as the reference's
    compiled `jnp.linalg.norm` (`_sum_sq3`, then a correctly rounded root)."""
    return sqrt32(_sum_sq3(v))


def _box_norm(d: torch.Tensor) -> torch.Tensor:
    """|max(d, 0)| over the last axis of 3 as XLA CPU computes the box SDF's
    norm: its reduction starts from x*x + y*y, which LLVM contracts into
    fma(x, x, y * y), then fma(z, z, .) and a correctly rounded root."""
    x, y, z = d.clamp_min(0.0).unbind(-1)
    return sqrt32(fma32(z, z, fma32(x, x, y * y)))


def _primitive_sdf(kinds, centers, halfs, p):
    """SDF of every primitive at points p [H, W, 3] -> [P, H, W] (solid:
    negative inside; the room is the complement of its box)."""
    q = p[None] - centers[:, None, None, :]
    d = q.abs() - halfs[:, None, None, :]
    box = _box_norm(d) + d.amax(dim=-1).clamp_max(0.0)
    sphere = _norm3(q) - halfs[:, None, None, 0]
    k = kinds[:, None, None]
    return torch.where(k == BOX, box, torch.where(k == SPHERE, sphere, -box))


def march_point(dirs: torch.Tensor, t_acc: torch.Tensor, t) -> torch.Tensor:
    """The sphere tracer's point t + dirs * t_acc, one fused multiply-add a
    component as XLA CPU computes it inside the reference's march."""
    return fma32(dirs, t_acc[..., None], t)


def rotate_rays(rays_c: torch.Tensor, R_w_c) -> torch.Tensor:
    """rays [H, W, 3] rotated by the host float32 R_w_c: the reference's
    einsum("ij,hwj->hwi", R, rays) as XLA CPU rounds it (`fma_dot3`)."""
    R = np.asarray(R_w_c, np.float32).tolist()
    x = [rays_c[..., j] for j in range(3)]
    return torch.stack([fma_dot3(x, R[i]) for i in range(3)], dim=-1)


def _render(kinds, centers, halfs, labels, colors, present, rays_c, R_w_c, t_w_c, max_range, n_steps=96):
    """Sphere-trace every pixel ray; returns (depth, labels, color, hit_prim,
    hit_ok) images. R_w_c / t_w_c are host float32."""
    t = torch.from_numpy(np.asarray(t_w_c, np.float32)).to(rays_c.device)
    dirs_w = rotate_rays(rays_c, R_w_c)
    dirs = dirs_w / _norm3(dirs_w)[..., None]  # unit rays, world frame
    inf = torch.full((), float("inf"), device=rays_c.device)

    def scene_sdf(p):
        return torch.where(present[:, None, None], _primitive_sdf(kinds, centers, halfs, p), inf)

    H, W = rays_c.shape[:2]
    t_acc = torch.zeros((H, W), dtype=torch.float32, device=rays_c.device)
    done = torch.zeros((H, W), dtype=torch.bool, device=rays_c.device)
    far = np.float32(max_range) * np.float32(1.5)
    for _ in range(n_steps):
        sd = scene_sdf(march_point(dirs, t_acc, t)).amin(dim=0)
        t_new = torch.where(done, t_acc, t_acc + sd.clamp(1e-4, 0.5))
        done = done | (sd < 1e-3) | (t_new > far)
        t_acc = t_new

    sd_final = scene_sdf(march_point(dirs, t_acc, t))
    hit_prim = sd_final.argmin(dim=0)
    hit_ok = (sd_final.amin(dim=0) < 5e-3) & (t_acc <= far)
    # euclidean t -> z-depth: rays_c = (x, y, 1), so unit-ray z = 1/|ray_c|.
    # XLA CPU rewrites the division into t * rsqrt(|ray_c|^2) and computes
    # the rsqrt from the host's hardware estimate, refined: AVX-512's
    # vrsqrt14ps where the host has it, AVX's vrsqrtps on an AVX2 host, so
    # the reference's depth bits depend on the host that runs it (up to 2
    # ulps apart on 13% of a frame's pixels between the two). The port
    # takes the correctly rounded rsqrt, the same on every device.
    rsqrt = (1.0 / torch.sqrt(_sum_sq3(rays_c).double())).float()
    depth = torch.where(hit_ok, t_acc * rsqrt, 0.0)
    label_img = torch.where(hit_ok, labels[hit_prim], -1)
    color_img = torch.where(hit_ok[..., None], colors[hit_prim], 0.0)
    return depth, label_img, color_img, hit_prim, hit_ok


@dataclasses.dataclass
class SensorNoiseConfig:
    """Structured-light RGB-D sensor noise: Kinect-style error model (sigma and
    quantization step growing ~depth^2, lateral jitter + dropout at depth
    discontinuities, label flicker at segmentation boundaries)."""

    depth_sigma0: float = 0.002  # m, range-noise floor
    depth_sigma2: float = 0.0019  # m per m^2 (sigma grows with depth^2)
    disparity_quant: float = 0.0007  # quantization step = quant * depth^2
    edge_grad_m: float = 0.10  # neighbor depth jump (m) that marks an edge
    edge_jitter_p: float = 0.5  # edge pixels sampling a random neighbor depth
    edge_dropout_p: float = 0.3  # edge pixels returning no depth
    dropout_p: float = 0.002  # speckle dropout probability anywhere
    label_flicker_p: float = 0.35  # boundary pixels taking a neighbor's label
    seed: int = 7


def _neighbours(img: torch.Tensor) -> torch.Tensor:
    """[4, H, W] up / down / left / right neighbours, edge-replicated."""
    up = torch.cat([img[:1], img[:-1]], dim=0)
    dn = torch.cat([img[1:], img[-1:]], dim=0)
    lf = torch.cat([img[:, :1], img[:, :-1]], dim=1)
    rt = torch.cat([img[:, 1:], img[:, -1:]], dim=1)
    return torch.stack([up, dn, lf, rt])


def _noise_draws(seed: int, index: int, shape, device):
    """The random draws of one frame: a standard normal, a neighbour choice in
    [0, 4) and three uniforms [3, H, W] (jitter, dropout, flicker), from a CPU
    torch.Generator seeded from (seed, index), moved to `device`."""
    g = torch.Generator().manual_seed(int(np.random.SeedSequence([seed, index]).generate_state(1, np.uint64)[0]))
    normal = torch.randn(shape, generator=g)
    sel = torch.randint(0, 4, shape, generator=g)
    uni = torch.rand((3, *shape), generator=g)
    return normal.to(device), sel.to(device), uni.to(device)


def _apply_sensor_noise(draws, depth, labels, nz: SensorNoiseConfig):
    """Range noise + depth^2 quantization + edge jitter/dropout + boundary
    label flicker, the reference's model with `draws` (_noise_draws) in place
    of its jax.random keys. Invalid pixels (depth <= 0) stay invalid."""
    normal, sel, (u_jit, u_drop, u_flick) = draws
    f = lambda x: float(np.float32(x))  # noqa: E731  the reference's float32 parameters
    valid = depth > 0.0
    nbrs = _neighbours(depth)
    max_jump = (nbrs - depth[None]).abs().amax(dim=0)
    edge = valid & (max_jump > f(nz.edge_grad_m))
    # range noise + quantization (step grows with depth^2)
    d = depth + normal * (f(nz.depth_sigma0) + f(nz.depth_sigma2) * depth * depth)
    step = f(nz.disparity_quant) * d.clamp_min(0.1) ** 2
    d = torch.round(d / step) * step
    # edge jitter: edge pixels sample a random 4-neighbor's depth
    nbr_d = torch.gather(nbrs, 0, sel[None])[0]
    jit = edge & (u_jit < f(nz.edge_jitter_p))
    d = torch.where(jit & (nbr_d > 0), nbr_d, d)
    # dropout: speckle everywhere + elevated at edges
    p_drop = f(nz.dropout_p) + torch.where(edge, f(nz.edge_dropout_p), 0.0)
    d = torch.where(u_drop < p_drop, 0.0, d)
    d = torch.where(valid, d.clamp_min(0.0), 0.0)
    # label flicker at segmentation boundaries: take a random neighbor label
    lnbrs = _neighbours(labels)
    boundary = (lnbrs - labels[None]).abs().amax(dim=0) > 0
    nbr_l = torch.gather(lnbrs, 0, sel[None])[0]
    flick = boundary & (u_flick < f(nz.label_flicker_p))
    return d, torch.where(flick, nbr_l, labels)


@dataclasses.dataclass
class SyntheticSequenceConfig:
    height: int = 240
    width: int = 320
    fx: float = 200.0
    fy: float = 200.0
    cx: float = 160.0
    cy: float = 120.0
    max_range: float = 5.0
    min_range: float = 0.1
    fps: float = 10.0
    duration: float = 30.0
    n_loops: float = 2.0  # camera orbits (>=2 gives revisits / loop closure)
    orbit_radius: float = 2.5
    camera_height: float = 1.4
    drift_rate: float = 0.0  # m per m of odometric drift (0 = GT odometry)
    seed: int = 0
    # sensor-noise model applied to depth + labels at render time (None = the
    # noise-free renderer)
    noise: Optional[SensorNoiseConfig] = None


class SyntheticSequence:
    """Sequence of rendered frames with GT poses; frames live on `device`
    (CUDA unless the caller passes device="cpu")."""

    def __init__(self, scene: Scene, config: SyntheticSequenceConfig, device=None):
        self.scene = scene
        self.config = config
        self.device = resolve_device(device)
        self.camera = Camera(
            config.height, config.width, config.fx, config.fy,
            config.cx, config.cy, config.min_range, config.max_range,
        )
        self.n_frames = int(config.duration * config.fps)
        rng = np.random.default_rng(config.seed)
        self._drift_dirs = rng.normal(size=(self.n_frames, 3))
        self._drift_dirs[:, 2] *= 0.1

    def pose_at(self, t: float):
        """GT camera pose: orbit around room center, looking outward/forward."""
        cfg = self.config
        c = self.scene.room_center
        w = 2 * np.pi * cfg.n_loops / cfg.duration
        ang = w * t
        pos = c + np.array(
            [cfg.orbit_radius * np.cos(ang), cfg.orbit_radius * np.sin(ang), 0.0]
        )
        pos[2] = cfg.camera_height
        # look direction: travel direction blended inward so room content
        # (humans, furniture, change objects) crosses the view
        fwd = np.array([-np.sin(ang), np.cos(ang), 0.0])
        inward = c - pos
        inward[2] = 0.0
        inward /= max(np.linalg.norm(inward), 1e-6)
        look = fwd + 0.8 * inward + np.array([0.0, 0.0, -0.15])
        up = np.array([0.0, 0.0, 1.0])
        z = look / np.linalg.norm(look)
        x = np.cross(z, up)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        R = np.stack([x, y, z], axis=1)  # columns = camera axes in world
        return R.astype(np.float32), pos.astype(np.float32)

    def frame_stamp_ns(self, i: int) -> int:
        return int(round(i / self.config.fps * 1e9))

    def render_frame(self, i: int):
        """Returns dict with depth/labels/color tensors on the device + GT
        pose (host float32) + stamp."""
        t = i / self.config.fps
        R, pos = self.pose_at(t)
        depth, label_img, color_img, hit_prim, hit_ok = _render(
            *self.scene.device_arrays(t, self.device),
            self.camera.pixel_rays(self.device),
            R,
            pos,
            self.config.max_range,
        )
        label_img = label_img.to(torch.int32)
        nz = self.config.noise
        if nz is not None:
            draws = _noise_draws(nz.seed, i, tuple(depth.shape), self.device)
            depth, label_img = _apply_sensor_noise(draws, depth, label_img, nz)
        # open-set outputs: stable instance ids (primitive index, 0 = room/bg)
        # + synthetic per-instance embedding vectors (fixed unit vectors per
        # primitive, a stand-in for CLIP features from semantic_inference)
        instances = torch.where(hit_ok & (hit_prim > 0), hit_prim, 0)
        return {
            "stamp_ns": self.frame_stamp_ns(i),
            "t": t,
            "depth": depth,
            "labels": label_img,
            "color": color_img,
            "instances": instances.to(torch.int32),
            "features": self.instance_features(),
            "R_w_c": R,
            "t_w_c": pos,
            "R_gt": R,
            "t_gt": pos,
        }

    def instance_features(self, dim: int = 32) -> np.ndarray:
        """Deterministic unit embedding per primitive (row i = instance i+1)."""
        if not hasattr(self, "_feat_cache"):
            rng = np.random.default_rng(1234)
            n = len(self.scene.primitives)
            f = rng.normal(size=(n, dim)).astype(np.float32)
            f /= np.linalg.norm(f, axis=1, keepdims=True)
            self._feat_cache = f
        return self._feat_cache

    def background_embeddings(self, dim: int = 32) -> np.ndarray:
        """Fake background-prompt embeddings (near the room's visual feature
        space): vectors orthogonal-ish to object features."""
        rng = np.random.default_rng(4321)
        f = rng.normal(size=(4, dim)).astype(np.float32)
        f /= np.linalg.norm(f, axis=1, keepdims=True)
        return f

    def odometry_pose(self, i: int):
        """Drifted odometry (for backend testing): GT + accumulated noise."""
        R, pos = self.pose_at(i / self.config.fps)
        if self.config.drift_rate <= 0:
            return R, pos
        # accumulate small drift per frame
        drift = np.cumsum(self._drift_dirs[: i + 1], axis=0)[-1] if i >= 0 else 0
        scale = self.config.drift_rate / max(self.config.fps, 1)
        return R, pos + drift * scale


# ----------------------------------------------------------------------------
# Scene presets (labels: 0 bg/room, 1 human, 2 table, 3 chair, 4 cooler,
#                5 box, 6 shelf)
# ----------------------------------------------------------------------------

LABEL_NAMES = ["background", "human", "table", "chair", "cooler", "box", "shelf"]
HUMAN, TABLE, CHAIR, COOLER, BOXLBL, SHELF = 1, 2, 3, 4, 5, 6


def office_scene(duration: float = 30.0) -> Scene:
    """Office-like room with static furniture, one removed + one added object
    (changes at duration/2, mirroring tesse_cd_office), and two walking humans."""
    half = np.array([5.0, 4.0, 1.5], np.float32)
    center = np.array([0.0, 0.0, 1.5], np.float32)
    t_change = duration / 2

    def box(name, label, cx, cy, cz, hx, hy, hz, color, **kw):
        return Primitive(
            kind=BOX,
            center=np.array([cx, cy, cz], np.float32),
            half_extents=np.array([hx, hy, hz], np.float32),
            label=label,
            color=np.asarray(color, np.float32),
            name=name,
            **kw,
        )

    prims = [
        box("table_1", TABLE, 4.0, 2.4, 0.4, 0.6, 0.4, 0.4, [0.6, 0.4, 0.2]),
        box("table_2", TABLE, -4.0, -2.4, 0.4, 0.6, 0.4, 0.4, [0.6, 0.4, 0.2]),
        box("shelf_1", SHELF, 0.0, 3.5, 0.9, 0.8, 0.3, 0.9, [0.4, 0.3, 0.2]),
        box("box_1", BOXLBL, -4.2, 2.8, 0.3, 0.3, 0.3, 0.3, [0.8, 0.7, 0.2]),
        # long-term changes:
        box("chair_removed", CHAIR, 3.8, -2.6, 0.35, 0.3, 0.3, 0.35, [0.2, 0.3, 0.8],
            t_disappear=t_change),
        box("cooler_added", COOLER, -0.5, -3.4, 0.5, 0.3, 0.3, 0.5, [0.2, 0.7, 0.8],
            t_appear=t_change),
    ]
    # two humans walking back and forth across the room center
    walk_t = np.linspace(0, duration, 9)
    path1 = np.array([[1.5, -1.5, 0.85], [-1.5, 1.5, 0.85]] * 5, np.float32)[: len(walk_t)]
    path2 = np.array([[-1.5, -1.0, 0.85], [1.5, 1.0, 0.85]] * 5, np.float32)[: len(walk_t)]
    for name, path, hx, hz, color in (
        ("human_1", path1, 0.25, 0.85, [0.9, 0.3, 0.3]),
        ("human_2", path2, 0.22, 0.8, [0.3, 0.9, 0.3]),
    ):
        prims.append(
            Primitive(
                kind=BOX,
                center=path[0],
                half_extents=np.array([hx, hx, hz], np.float32),
                label=HUMAN,
                color=np.array(color, np.float32),
                name=name,
                waypoints=path,
                waypoint_times=walk_t,
            )
        )
    return Scene(room_half_extents=half, room_center=center, primitives=prims)


def apartment_scene(duration: float = 20.0) -> Scene:
    """Smaller static-heavy scene (tesse_cd apartment analog): no humans."""
    half = np.array([3.5, 3.0, 1.4], np.float32)
    center = np.array([0.0, 0.0, 1.4], np.float32)
    prims = [
        Primitive(
            kind=BOX,
            center=np.array([2.6, 1.8, 0.4], np.float32),
            half_extents=np.array([0.5, 0.4, 0.4], np.float32),
            label=TABLE,
            color=np.array([0.6, 0.4, 0.2], np.float32),
            name="table_1",
        ),
        Primitive(
            kind=SPHERE,
            center=np.array([-2.4, -1.8, 0.4], np.float32),
            half_extents=np.array([0.4, 0.4, 0.4], np.float32),
            label=BOXLBL,
            color=np.array([0.8, 0.7, 0.2], np.float32),
            name="ball_1",
        ),
        Primitive(
            kind=BOX,
            center=np.array([0.0, 2.6, 0.8], np.float32),
            half_extents=np.array([0.7, 0.3, 0.8], np.float32),
            label=SHELF,
            color=np.array([0.4, 0.3, 0.2], np.float32),
            name="shelf_1",
        ),
    ]
    return Scene(room_half_extents=half, room_center=center, primitives=prims)


def default_label_space() -> LabelSpace:
    return LabelSpace(
        num_classes=len(LABEL_NAMES),
        object_labels=(TABLE, CHAIR, COOLER, BOXLBL, SHELF),
        dynamic_labels=(HUMAN,),
    )


# ----------------------------------------------------------------------------
# Hard-mode multi-room scene + waypoint tour (the uHumans2-office-class
# difficulty tier: multi-room and cluttered, khronos_eval/README.md:13-16)
# ----------------------------------------------------------------------------


def hard_scene(duration: float = 60.0) -> Scene:
    """Four-room flat (16 x 12 m) with interior walls + doorways, 32 object
    instances including compound (multi-primitive) and spherical shapes,
    near-duplicate same-class neighbors, occluding clutter (pillars, stacked
    boxes, under-desk boxes), SIX long-term changes (removals, additions, a
    MOVED object = disappear at A + appear at B, and a removal in a
    partially-viewed corner), and four humans on crossing waypoint paths
    through the doorways. GT protocol mirrors the tesse ground truth's: structure
    primitives belong to the background; `group`ed primitives are one
    instance."""
    half = np.array([8.0, 6.0, 1.5], np.float32)
    center = np.array([0.0, 0.0, 1.5], np.float32)
    t1, t2, t3 = 0.42 * duration, 0.50 * duration, 0.58 * duration

    def box(name, label, cx, cy, cz, hx, hy, hz, color, **kw):
        return Primitive(
            kind=BOX, center=np.array([cx, cy, cz], np.float32),
            half_extents=np.array([hx, hy, hz], np.float32),
            label=label, color=np.asarray(color, np.float32), name=name, **kw,
        )

    def sphere(name, label, cx, cy, cz, r, color, **kw):
        return Primitive(
            kind=SPHERE, center=np.array([cx, cy, cz], np.float32),
            half_extents=np.array([r, r, r], np.float32),
            label=label, color=np.asarray(color, np.float32), name=name, **kw,
        )

    wallc = [0.75, 0.73, 0.7]
    prims = [
        # interior walls: x=0 spine (doorways at y ~ +-3), y=0 spine
        # (doorways at x ~ +-4), all structure (background)
        box("wall_x_s", 0, 0.0, -4.85, 1.5, 0.1, 1.15, 1.5, wallc, structure=True),
        box("wall_x_m", 0, 0.0, 0.0, 1.5, 0.1, 2.3, 1.5, wallc, structure=True),
        box("wall_x_n", 0, 0.0, 4.85, 1.5, 0.1, 1.15, 1.5, wallc, structure=True),
        # y=0 spine in two segments per side, leaving 1.4 m doorways at
        # x in [-5.0,-3.6] and [3.6,5.0] (north and south stay separate
        # free-space components; the tour crosses at x=+-4.0 and the humans
        # at x=+-4.6, both in-doorway)
        box("wall_y_w", 0, -6.5, 0.0, 1.5, 1.5, 0.1, 1.5, wallc, structure=True),
        box("wall_y_w2", 0, -1.825, 0.0, 1.5, 1.775, 0.1, 1.5, wallc, structure=True),
        box("wall_y_e", 0, 6.5, 0.0, 1.5, 1.5, 0.1, 1.5, wallc, structure=True),
        box("wall_y_e2", 0, 1.825, 0.0, 1.5, 1.775, 0.1, 1.5, wallc, structure=True),
        # occluding pillars
        box("pillar_nw", 0, -2.0, 4.0, 1.5, 0.22, 0.22, 1.5, wallc, structure=True),
        box("pillar_se", 0, 2.0, -4.0, 1.5, 0.22, 0.22, 1.5, wallc, structure=True),

        # ---- SW room (x<0, y<0): 9 instances -------------------------------
        # compound table: top + 2 legs (one GT instance)
        box("sw_table_top", TABLE, -5.5, -3.0, 0.72, 0.7, 0.45, 0.05, [0.6, 0.4, 0.2], group="sw_table"),
        box("sw_table_leg1", TABLE, -6.1, -3.0, 0.34, 0.06, 0.4, 0.34, [0.5, 0.35, 0.18], group="sw_table"),
        box("sw_table_leg2", TABLE, -4.9, -3.0, 0.34, 0.06, 0.4, 0.34, [0.5, 0.35, 0.18], group="sw_table"),
        # near-duplicate chairs, adjacent
        box("sw_chair_a", CHAIR, -5.8, -2.1, 0.35, 0.25, 0.25, 0.35, [0.2, 0.3, 0.8]),
        box("sw_chair_b", CHAIR, -5.15, -2.1, 0.35, 0.25, 0.25, 0.35, [0.22, 0.32, 0.78]),
        box("sw_chair_removed", CHAIR, -6.6, -4.6, 0.35, 0.28, 0.28, 0.35, [0.2, 0.35, 0.75],
            t_disappear=t1),
        box("sw_shelf", SHELF, -7.6, -1.2, 0.9, 0.3, 0.8, 0.9, [0.4, 0.3, 0.2]),
        # stacked box clutter (2 instances, stacked -> segmentation stress)
        box("sw_box_lo", BOXLBL, -2.6, -4.9, 0.3, 0.3, 0.3, 0.3, [0.8, 0.7, 0.2]),
        box("sw_box_hi", BOXLBL, -2.6, -4.9, 0.84, 0.22, 0.22, 0.22, [0.75, 0.65, 0.25]),
        sphere("sw_ball", BOXLBL, -2.0, -2.6, 0.28, 0.28, [0.85, 0.5, 0.2]),

        # ---- NW room (x<0, y>0): 6 instances -------------------------------
        box("nw_desk_top", TABLE, -6.0, 3.5, 0.72, 0.8, 0.4, 0.05, [0.55, 0.4, 0.25], group="nw_desk"),
        box("nw_desk_leg1", TABLE, -6.7, 3.5, 0.34, 0.06, 0.35, 0.34, [0.5, 0.35, 0.2], group="nw_desk"),
        box("nw_desk_leg2", TABLE, -5.3, 3.5, 0.34, 0.06, 0.35, 0.34, [0.5, 0.35, 0.2], group="nw_desk"),
        box("nw_chair", CHAIR, -6.0, 2.6, 0.35, 0.25, 0.25, 0.35, [0.25, 0.3, 0.7]),
        # near-duplicate coolers
        box("nw_cooler_a", COOLER, -3.1, 5.2, 0.45, 0.25, 0.25, 0.45, [0.2, 0.7, 0.8]),
        box("nw_cooler_b", COOLER, -2.3, 5.2, 0.45, 0.25, 0.25, 0.45, [0.22, 0.68, 0.82]),
        # removal in a PARTIALLY-VIEWED corner (behind the tour's gaze, near
        # the NW corner; the pillar occludes it from part of the pass)
        box("nw_shelf_removed", SHELF, -7.5, 5.3, 0.9, 0.3, 0.6, 0.9, [0.38, 0.28, 0.22],
            t_disappear=t2),
        # under-desk clutter
        box("nw_underdesk_box", BOXLBL, -6.0, 3.5, 0.22, 0.2, 0.2, 0.22, [0.8, 0.72, 0.3]),

        # ---- NE room (x>0, y>0): 8 instances -------------------------------
        # compound shelf unit: two boards + back panel (one instance)
        box("ne_shelf_b1", SHELF, 7.55, 1.5, 0.5, 0.3, 0.8, 0.05, [0.42, 0.3, 0.2], group="ne_shelf"),
        box("ne_shelf_b2", SHELF, 7.55, 1.5, 1.05, 0.3, 0.8, 0.05, [0.42, 0.3, 0.2], group="ne_shelf"),
        box("ne_shelf_back", SHELF, 7.85, 1.5, 0.78, 0.05, 0.8, 0.78, [0.38, 0.27, 0.18], group="ne_shelf"),
        box("ne_cooler_added", COOLER, 5.0, 5.0, 0.45, 0.28, 0.28, 0.45, [0.2, 0.72, 0.78],
            t_appear=t1),
        # compound lamp: pole + sphere head (non-box, one instance), removed
        box("ne_lamp_pole", BOXLBL, 2.8, 4.5, 0.75, 0.05, 0.05, 0.75, [0.3, 0.3, 0.3],
            group="ne_lamp", t_disappear=t3),
        sphere("ne_lamp_head", BOXLBL, 2.8, 4.5, 1.62, 0.2, [0.9, 0.85, 0.5],
               group="ne_lamp", t_disappear=t3),
        box("ne_table", TABLE, 4.5, 2.0, 0.4, 0.6, 0.4, 0.4, [0.6, 0.42, 0.22]),
        box("ne_chair_a", CHAIR, 4.2, 1.1, 0.35, 0.25, 0.25, 0.35, [0.2, 0.28, 0.8]),
        box("ne_chair_b", CHAIR, 4.9, 1.1, 0.35, 0.25, 0.25, 0.35, [0.21, 0.3, 0.79]),
        box("ne_box_a", BOXLBL, 6.6, 4.6, 0.3, 0.3, 0.3, 0.3, [0.82, 0.7, 0.25]),
        box("ne_box_b", BOXLBL, 6.6, 3.8, 0.25, 0.25, 0.25, 0.25, [0.78, 0.68, 0.28]),

        # ---- SE room (x>0, y<0): 9 instances -------------------------------
        # MOVED object: disappears at A (t2), an identical box appears at B
        box("se_box_moved_a", BOXLBL, 6.0, -4.6, 0.3, 0.3, 0.3, 0.3, [0.85, 0.68, 0.2],
            t_disappear=t2),
        box("se_box_moved_b", BOXLBL, 3.2, -5.2, 0.3, 0.3, 0.3, 0.3, [0.85, 0.68, 0.2],
            t_appear=t2),
        box("se_box_added", BOXLBL, 6.8, -2.0, 0.3, 0.3, 0.3, 0.3, [0.8, 0.66, 0.3],
            t_appear=t3),
        box("se_table_top", TABLE, 5.5, -3.2, 0.72, 0.7, 0.4, 0.05, [0.58, 0.4, 0.22], group="se_table"),
        box("se_table_leg1", TABLE, 6.1, -3.2, 0.34, 0.06, 0.35, 0.34, [0.5, 0.36, 0.2], group="se_table"),
        box("se_table_leg2", TABLE, 4.9, -3.2, 0.34, 0.06, 0.35, 0.34, [0.5, 0.36, 0.2], group="se_table"),
        box("se_chair", CHAIR, 5.5, -2.3, 0.35, 0.25, 0.25, 0.35, [0.24, 0.3, 0.76]),
        box("se_shelf", SHELF, 7.7, -3.6, 0.9, 0.25, 0.7, 0.9, [0.4, 0.29, 0.21]),
        sphere("se_ball", BOXLBL, 2.5, -2.6, 0.3, 0.3, [0.3, 0.8, 0.4]),
        # near-duplicate chairs along the south wall
        box("se_chair_dup_a", CHAIR, 5.4, -5.3, 0.35, 0.25, 0.25, 0.35, [0.2, 0.3, 0.8]),
        box("se_chair_dup_b", CHAIR, 6.05, -5.3, 0.35, 0.25, 0.25, 0.35, [0.2, 0.31, 0.79]),
    ]

    # four humans on crossing paths through the doorways
    def human(name, path, color, hx=0.24, hz=0.85):
        k = len(path)
        wt = np.linspace(0, duration, k)
        return Primitive(
            kind=BOX, center=np.asarray(path[0], np.float32),
            half_extents=np.array([hx, hx, hz], np.float32),
            label=HUMAN, color=np.asarray(color, np.float32), name=name,
            waypoints=np.asarray(path, np.float32), waypoint_times=wt,
        )

    # paths run 0.6 m laterally off the camera tour lines (so the camera is
    # never INSIDE a human) but cross it at the doorways
    z = 0.85
    p1 = [[-4.6, -3.6, z], [-4.6, 0, z], [-4.6, 3.6, z], [0, 3.6, z], [4.6, 3.6, z],
          [0, 3.6, z], [-4.6, 3.6, z], [-4.6, 0, z], [-4.6, -3.6, z]] * 2
    p2 = [[4.6, 3.6, z], [0, 3.6, z], [-4.6, 3.6, z], [-4.6, 0, z], [-4.6, -3.6, z],
          [-4.6, 0, z], [-4.6, 3.6, z], [0, 3.6, z], [4.6, 3.6, z]] * 2
    p3 = [[4.6, -3.6, z], [0, -3.6, z], [-4.6, -3.6, z], [0, -3.6, z], [4.6, -3.6, z],
          [4.6, 0, z], [4.6, 3.6, z], [4.6, 0, z], [4.6, -3.6, z]] * 2
    p4 = [[5.5, 4.5, z], [3.0, 2.5, z], [6.5, 2.0, z], [5.5, 4.5, z]] * 4
    prims.append(human("human_1", p1[:17], [0.9, 0.3, 0.3]))
    prims.append(human("human_2", p2[:17], [0.3, 0.9, 0.3]))
    prims.append(human("human_3", p3[:17], [0.3, 0.3, 0.9]))
    prims.append(human("human_4", p4[:13], [0.9, 0.8, 0.3]))
    return Scene(room_half_extents=half, room_center=center, primitives=prims)


def hard_scene_tour_waypoints() -> np.ndarray:
    """Closed tour through all four rooms of `hard_scene` via the doorways."""
    return np.array(
        [
            [-4.0, -3.0, 0.0], [-4.0, 0.0, 0.0], [-4.0, 3.0, 0.0],
            [0.0, 3.0, 0.0], [4.0, 3.0, 0.0], [4.0, 0.0, 0.0],
            [4.0, -3.0, 0.0], [0.0, -3.0, 0.0],
        ],
        np.float64,
    )


class TourSequence(SyntheticSequence):
    """Waypoint-tour camera for multi-room scenes: constant-speed traversal
    of a closed polyline (`n_loops` times over `duration`), gaze at a
    look-ahead point on the path (slightly downward) — the analog of the
    uHumans2 robot's multi-room sweep."""

    def __init__(self, scene: Scene, config: SyntheticSequenceConfig,
                 waypoints: Optional[np.ndarray] = None, look_ahead: float = 1.8, device=None):
        self.waypoints = np.asarray(
            waypoints if waypoints is not None else hard_scene_tour_waypoints(),
            np.float64,
        )
        closed = np.vstack([self.waypoints, self.waypoints[:1]])
        seg = np.diff(closed, axis=0)
        self._closed = closed
        self._seg_len = np.linalg.norm(seg[:, :2], axis=1)
        self._cum = np.concatenate([[0.0], np.cumsum(self._seg_len)])
        self._perimeter = float(self._cum[-1])
        self._look_ahead = look_ahead
        super().__init__(scene, config, device=device)

    def _point_at_arc(self, s: float) -> np.ndarray:
        s = s % self._perimeter
        k = int(np.searchsorted(self._cum, s, side="right") - 1)
        k = min(max(k, 0), len(self._seg_len) - 1)
        a = (s - self._cum[k]) / max(self._seg_len[k], 1e-9)
        return (1 - a) * self._closed[k] + a * self._closed[k + 1]

    def pose_at(self, t: float):
        cfg = self.config
        speed = self._perimeter * cfg.n_loops / cfg.duration
        s = t * speed
        pos = np.asarray(self._point_at_arc(s), np.float64)
        tgt = np.asarray(self._point_at_arc(s + self._look_ahead), np.float64)
        pos[2] = cfg.camera_height
        tgt[2] = cfg.camera_height
        look = tgt - pos
        horiz = max(np.linalg.norm(look[:2]), 1e-6)
        look = look / horiz
        look[2] = -0.12  # slight downward pitch: floor + low furniture in view
        up = np.array([0.0, 0.0, 1.0])
        zax = look / np.linalg.norm(look)
        xax = np.cross(zax, up)
        xax /= max(np.linalg.norm(xax), 1e-6)
        yax = np.cross(zax, xax)
        R = np.stack([xax, yax, zax], axis=1)
        return R.astype(np.float32), pos.astype(np.float32)


def sample_scene_surface(scene: Scene, t: float, n_points: int = 20000, seed: int = 0):
    """GT surface samples at time t via rejection sampling + SDF projection.

    Returns (points [N,3], labels [N]): background (room) + present objects.
    Used as the evaluation ground-truth cloud. Host numpy on the scene's
    arrays, drawn from numpy's generator with `seed`: the reference's
    samples, bit for bit."""
    rng = np.random.default_rng(seed)
    kinds, centers, halfs, labels, colors, present = scene.host_arrays(t)
    pts_all, lab_all = [], []
    for i in range(len(kinds)):
        if not present[i]:
            continue
        n = n_points // 2 if kinds[i] == ROOM else max(n_points // (2 * (len(kinds) - 1)), 200)
        if kinds[i] == SPHERE:
            d = rng.normal(size=(n, 3))
            d /= np.linalg.norm(d, axis=1, keepdims=True)
            p = centers[i] + d * halfs[i][0]
        else:
            h = halfs[i]
            # sample box faces proportional to area
            areas = np.array([h[1] * h[2], h[1] * h[2], h[0] * h[2], h[0] * h[2], h[0] * h[1], h[0] * h[1]])
            face = rng.choice(6, size=n, p=areas / areas.sum())
            u = rng.uniform(-1, 1, size=(n, 3)) * h
            for k in range(3):
                sel = face // 2 == k
                u[sel, k] = np.where(face[sel] % 2 == 0, -h[k], h[k])
            p = centers[i] + u
        if kinds[i] == ROOM:
            lab = np.full(len(p), scene.room_label)
        else:
            lab = np.full(len(p), labels[i])
        pts_all.append(p)
        lab_all.append(lab)
    pts = np.concatenate(pts_all)
    labs = np.concatenate(lab_all)
    # drop points hidden inside other solids (e.g. object bottom inside floor)
    keep = np.ones(len(pts), bool)
    for i in range(len(kinds)):
        if not present[i] or kinds[i] == ROOM:
            continue
        q = np.abs(pts - centers[i]) - halfs[i]
        if kinds[i] == BOX:
            inside = (q < -1e-3).all(axis=1)
        else:
            inside = np.linalg.norm(pts - centers[i], axis=1) < halfs[i][0] - 1e-3
        keep &= ~inside
    # drop points outside the room
    qr = np.abs(pts - scene.room_center) - scene.room_half_extents
    keep &= (qr <= 1e-3).all(axis=1)
    return pts[keep], labs[keep]
