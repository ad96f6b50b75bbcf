"""Synthetic scene generator + analytic RGB-D-semantic renderer (fake sensor).

Port of the clean-frame part of `khronos_tpu/data/synthetic.py`: parametric
indoor scenes (a room, static objects with semantic labels, objects with
presence intervals, humans walking along waypoint paths) and a camera orbit,
rendered to depth / color / semantic-label images by sphere-tracing the scene
SDF on the device. Sensor noise (the reference draws it with `jax.random`) is
a later slice: `SyntheticSequenceConfig.noise` must stay None.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from khronos_tpu_torch import resolve_device
from khronos_tpu_torch.active_window.object_detection import LabelSpace
from khronos_tpu_torch.geometry.camera import Camera

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


def _norm3(v: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis of 3 (summed x, y, z in order)."""
    return torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1] + v[..., 2] * v[..., 2])


def _primitive_sdf(kinds, centers, halfs, p):
    """SDF of every primitive at points p [H, W, 3] -> [P, H, W] (solid:
    negative inside; the room is the complement of its box)."""
    q = p[None] - centers[:, None, None, :]
    d = q.abs() - halfs[:, None, None, :]
    box = _norm3(d.clamp_min(0.0)) + d.amax(dim=-1).clamp_max(0.0)
    sphere = _norm3(q) - halfs[:, None, None, 0]
    k = kinds[:, None, None]
    return torch.where(k == BOX, box, torch.where(k == SPHERE, sphere, -box))


def _render(kinds, centers, halfs, labels, colors, present, rays_c, R_w_c, t_w_c, max_range, n_steps=96):
    """Sphere-trace every pixel ray; returns (depth, labels, color, hit_prim,
    hit_ok) images. R_w_c / t_w_c are host float32."""
    R = np.asarray(R_w_c, np.float32).tolist()
    t = torch.from_numpy(np.asarray(t_w_c, np.float32)).to(rays_c.device)
    dirs_w = torch.stack(
        [rays_c[..., 0] * R[i][0] + rays_c[..., 1] * R[i][1] + rays_c[..., 2] * R[i][2] for i in range(3)],
        dim=-1,
    )
    dirs = dirs_w / _norm3(dirs_w)[..., None]  # unit rays, world frame
    inf = torch.full((), float("inf"), device=rays_c.device)

    def scene_sdf(p):
        return torch.where(present[:, None, None], _primitive_sdf(kinds, centers, halfs, p), inf)

    H, W = rays_c.shape[:2]
    t_acc = torch.zeros((H, W), dtype=torch.float32, device=rays_c.device)
    done = torch.zeros((H, W), dtype=torch.bool, device=rays_c.device)
    far = np.float32(max_range) * np.float32(1.5)
    for _ in range(n_steps):
        p = t + dirs * t_acc[..., None]
        sd = scene_sdf(p).amin(dim=0)
        t_new = torch.where(done, t_acc, t_acc + sd.clamp(1e-4, 0.5))
        done = done | (sd < 1e-3) | (t_new > far)
        t_acc = t_new

    sd_final = scene_sdf(t + dirs * t_acc[..., None])
    hit_prim = sd_final.argmin(dim=0)
    hit_ok = (sd_final.amin(dim=0) < 5e-3) & (t_acc <= far)
    # euclidean t -> z-depth: rays_c = (x, y, 1), so unit-ray z = 1/|ray_c|
    depth = torch.where(hit_ok, t_acc / _norm3(rays_c), 0.0)
    label_img = torch.where(hit_ok, labels[hit_prim], -1)
    color_img = torch.where(hit_ok[..., None], colors[hit_prim], 0.0)
    return depth, label_img, color_img, hit_prim, hit_ok


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
    # sensor-noise model: a later slice of the port; must be None
    noise: Optional[object] = None


class SyntheticSequence:
    """Sequence of rendered frames with GT poses; frames live on `device`
    (CUDA unless the caller passes device="cpu")."""

    def __init__(self, scene: Scene, config: SyntheticSequenceConfig, device=None):
        if config.noise is not None:
            raise NotImplementedError("synthetic sensor noise is not ported yet (a later slice)")
        self.scene = scene
        self.config = config
        self.device = resolve_device(device)
        self.camera = Camera(
            config.height, config.width, config.fx, config.fy,
            config.cx, config.cy, config.min_range, config.max_range,
        )
        self.n_frames = int(config.duration * config.fps)

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
        depth, label_img, color_img, _, _ = _render(
            *self.scene.device_arrays(t, self.device),
            self.camera.pixel_rays(self.device),
            R,
            pos,
            self.config.max_range,
        )
        return {
            "stamp_ns": self.frame_stamp_ns(i),
            "t": t,
            "depth": depth,
            "labels": label_img.to(torch.int32),
            "color": color_img,
            "R_w_c": R,
            "t_w_c": pos,
            "R_gt": R,
            "t_gt": pos,
        }


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


def default_label_space() -> LabelSpace:
    return LabelSpace(
        num_classes=len(LABEL_NAMES),
        object_labels=(TABLE, CHAIR, COOLER, BOXLBL, SHELF),
        dynamic_labels=(HUMAN,),
    )
