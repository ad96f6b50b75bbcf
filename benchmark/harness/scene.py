"""The benchmark's frame source: the synthetic office and apartment, rendered
on the device many frames to a call.

A frozen copy of the program's synthetic scenes and camera path
(`data/synthetic.py`: `office_scene`, `apartment_scene`,
`SyntheticSequence.pose_at`), kept here so that no later change to the
program moves the traffic. The program sphere-traces each frame in 96
steps; this copy casts the same rays in closed form (slab and sphere
intersections), a block of frames to a call, so a run renders its whole
loop in a fraction of a second. The two agree up to where the sphere
trace stops short of a surface; `tests/test_bench_scene.py` holds them to
that on the CPU.

Imports nothing of the program.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

BOX, SPHERE, ROOM = 0, 1, 2
HUMAN, TABLE, CHAIR, COOLER, BOXLBL, SHELF = 1, 2, 3, 4, 5, 6


@dataclasses.dataclass
class Primitive:
    kind: int
    center: np.ndarray
    half_extents: np.ndarray  # sphere radius in [0]
    label: int
    color: np.ndarray
    t_appear: float = -np.inf
    t_disappear: float = np.inf
    waypoints: Optional[np.ndarray] = None
    waypoint_times: Optional[np.ndarray] = None

    def center_at(self, t: float) -> np.ndarray:
        if self.waypoints is None:
            return self.center
        wt, w = self.waypoint_times, self.waypoints
        if t <= wt[0]:
            return w[0]
        if t >= wt[-1]:
            return w[-1]
        k = int(np.searchsorted(wt, t) - 1)
        a = (t - wt[k]) / (wt[k + 1] - wt[k])
        return (1 - a) * w[k] + a * w[k + 1]


@dataclasses.dataclass
class Scene:
    room_half_extents: np.ndarray
    room_center: np.ndarray
    primitives: List[Primitive]
    room_label: int = 0
    room_color: np.ndarray = dataclasses.field(default_factory=lambda: np.array([0.7, 0.7, 0.65], np.float32))

    def host_arrays(self, t: float):
        """(kinds, centers, halfs, labels, colors, present) at time t, slot 0
        the room."""
        P = len(self.primitives)
        kinds = np.zeros(P + 1, np.int32)
        centers = np.zeros((P + 1, 3), np.float32)
        halfs = np.ones((P + 1, 3), np.float32)
        labels = np.zeros(P + 1, np.int32)
        colors = np.zeros((P + 1, 3), np.float32)
        present = np.zeros(P + 1, np.bool_)
        kinds[0], centers[0], halfs[0] = ROOM, self.room_center, self.room_half_extents
        labels[0], colors[0], present[0] = self.room_label, self.room_color, True
        for i, p in enumerate(self.primitives):
            kinds[i + 1], centers[i + 1], halfs[i + 1] = p.kind, p.center_at(t), p.half_extents
            labels[i + 1], colors[i + 1] = p.label, p.color
            present[i + 1] = p.t_appear <= t <= p.t_disappear
        return kinds, centers, halfs, labels, colors, present


def _box(label, c, h, color, **kw):
    return Primitive(BOX, np.array(c, np.float32), np.array(h, np.float32), label, np.array(color, np.float32), **kw)


def office_scene(duration: float) -> Scene:
    """The office: furniture, a chair removed and a cooler added at half the
    duration (tesse_cd_office's long-term changes), two humans walking
    across the room's centre."""
    t_change = duration / 2
    prims = [
        _box(TABLE, [4.0, 2.4, 0.4], [0.6, 0.4, 0.4], [0.6, 0.4, 0.2]),
        _box(TABLE, [-4.0, -2.4, 0.4], [0.6, 0.4, 0.4], [0.6, 0.4, 0.2]),
        _box(SHELF, [0.0, 3.5, 0.9], [0.8, 0.3, 0.9], [0.4, 0.3, 0.2]),
        _box(BOXLBL, [-4.2, 2.8, 0.3], [0.3, 0.3, 0.3], [0.8, 0.7, 0.2]),
        _box(CHAIR, [3.8, -2.6, 0.35], [0.3, 0.3, 0.35], [0.2, 0.3, 0.8], t_disappear=t_change),
        _box(COOLER, [-0.5, -3.4, 0.5], [0.3, 0.3, 0.5], [0.2, 0.7, 0.8], t_appear=t_change),
    ]
    walk_t = np.linspace(0, duration, 9)
    path1 = np.array([[1.5, -1.5, 0.85], [-1.5, 1.5, 0.85]] * 5, np.float32)[: len(walk_t)]
    path2 = np.array([[-1.5, -1.0, 0.85], [1.5, 1.0, 0.85]] * 5, np.float32)[: len(walk_t)]
    for path, hx, hz, color in ((path1, 0.25, 0.85, [0.9, 0.3, 0.3]), (path2, 0.22, 0.8, [0.3, 0.9, 0.3])):
        prims.append(_box(HUMAN, path[0], [hx, hx, hz], color, waypoints=path, waypoint_times=walk_t))
    return Scene(np.array([5.0, 4.0, 1.5], np.float32), np.array([0.0, 0.0, 1.5], np.float32), prims)


def apartment_scene(duration: float) -> Scene:
    """The apartment: static, no humans (tesse_cd_apartment analog)."""
    del duration
    prims = [
        _box(TABLE, [2.6, 1.8, 0.4], [0.5, 0.4, 0.4], [0.6, 0.4, 0.2]),
        Primitive(SPHERE, np.array([-2.4, -1.8, 0.4], np.float32), np.array([0.4, 0.4, 0.4], np.float32),
                  BOXLBL, np.array([0.8, 0.7, 0.2], np.float32)),
        _box(SHELF, [0.0, 2.6, 0.8], [0.7, 0.3, 0.8], [0.4, 0.3, 0.2]),
    ]
    return Scene(np.array([3.5, 3.0, 1.4], np.float32), np.array([0.0, 0.0, 1.4], np.float32), prims)


SCENES = {"office": office_scene, "apartment": apartment_scene}


def pixel_rays(height: int, width: int, fx: float, fy: float, cx: float, cy: float) -> np.ndarray:
    """Unit-z rays [H, W, 3] float32, IEEE division (the renderer's rays)."""
    u = np.arange(width, dtype=np.float32) + np.float32(0.5)
    v = np.arange(height, dtype=np.float32) + np.float32(0.5)
    uu, vv = np.meshgrid(u, v)
    x = (uu - np.float32(cx)) / np.float32(fx)
    y = (vv - np.float32(cy)) / np.float32(fy)
    return np.stack([x, y, np.ones_like(x)], axis=-1)


def pose_at(t: float, duration: float, room_center, n_loops: float, radius: float, height: float):
    """Ground-truth camera pose (R_w_c, t_w_c) as float32: `n_loops` orbits
    of the room's centre in `duration`, looking along the path and inward."""
    c = np.asarray(room_center)
    ang = 2 * np.pi * n_loops / duration * t
    pos = c + np.array([radius * np.cos(ang), radius * np.sin(ang), 0.0])
    pos[2] = height
    fwd = np.array([-np.sin(ang), np.cos(ang), 0.0])
    inward = c - pos
    inward[2] = 0.0
    inward /= max(np.linalg.norm(inward), 1e-6)
    look = fwd + 0.8 * inward + np.array([0.0, 0.0, -0.15])
    z = look / np.linalg.norm(look)
    x = np.cross(z, np.array([0.0, 0.0, 1.0]))
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    return np.stack([x, y, z], axis=1).astype(np.float32), pos.astype(np.float32)


def _render_block(kinds, centers, halfs, labels, colors, present, rays_c, R, t, max_range):
    """Ray-cast a block of B frames in closed form: the first surface each
    pixel's ray meets (a box or a sphere from outside, the room's walls from
    inside), within 1.5 x the sensor's range. centers/present [B, P+1, ...],
    R [B, 3, 3], t [B, 3] float32 tensors; rays_c [H, W, 3]. Returns depth
    [B, H, W], labels [B, H, W] int32, color [B, H, W, 3]."""
    dirs = torch.einsum("bij,hwj->bhwi", R, rays_c)  # [B, H, W, 3]
    dirs = dirs / torch.linalg.vector_norm(dirs, dim=-1, keepdim=True)
    tiny = torch.full((), 1e-12, device=dirs.device)
    d = torch.where(dirs.abs() < 1e-12, tiny, dirs)[:, None]  # [B, 1, H, W, 3]
    o = t[:, None, None, None, :]  # [B, 1, 1, 1, 3]
    c = centers[:, :, None, None, :]  # [B, P, 1, 1, 3]
    h = halfs[None, :, None, None, :]
    t1, t2 = (c - h - o) / d, (c + h - o) / d
    t_near = torch.minimum(t1, t2).amax(dim=-1)  # [B, P, H, W]
    t_far = torch.maximum(t1, t2).amin(dim=-1)
    box = torch.where((t_far >= t_near) & (t_near > 0), t_near, float("inf"))
    room = torch.where(t_far > 0, t_far, float("inf"))  # the camera stands inside the room
    oc = o - c
    b = (d * oc).sum(-1)
    disc = b * b - ((oc * oc).sum(-1) - h[..., 0] ** 2)
    ts = -b - torch.sqrt(disc.clamp_min(0.0))
    sphere = torch.where((disc >= 0) & (ts > 0), ts, float("inf"))
    k = kinds[None, :, None, None]
    hit_t = torch.where(k == BOX, box, torch.where(k == SPHERE, sphere, room))
    hit_t = torch.where(present[:, :, None, None], hit_t, float("inf"))
    t_hit, prim = hit_t.min(dim=1)  # [B, H, W]
    hit_ok = t_hit <= float(np.float32(max_range) * np.float32(1.5))
    z_of_t = 1.0 / torch.linalg.vector_norm(rays_c, dim=-1)  # z of the unit ray
    depth = torch.where(hit_ok, t_hit * z_of_t, 0.0)
    label_img = torch.where(hit_ok, labels[prim], -1).to(torch.int32)
    color_img = torch.where(hit_ok[..., None], colors[prim], 0.0)
    return depth, label_img, color_img


@dataclasses.dataclass
class Frames:
    """One loop of rendered frames on the device, and their poses."""

    depth: torch.Tensor  # [L, H, W] float32
    labels: torch.Tensor  # [L, H, W] int32
    color: torch.Tensor  # [L, H, W, 3] float32
    R: np.ndarray  # [L, 3, 3] float32
    t: np.ndarray  # [L, 3] float32

    def __len__(self):
        return self.depth.shape[0]


def render_loop(scene_cfg: dict, sensor: dict, hz: float, device, block: int = 16) -> Frames:
    """Every frame of one loop of the trajectory, `scene_cfg["seconds"]` of
    it at `hz`, rendered `block` frames to a call on `device`."""
    duration = float(scene_cfg["seconds"])
    n = int(round(duration * hz))
    scene = SCENES[scene_cfg["kind"]](duration)
    rays = torch.from_numpy(pixel_rays(sensor["height"], sensor["width"], sensor["fx"], sensor["fy"],
                                       sensor["cx"], sensor["cy"])).to(device)
    poses = [pose_at(i / hz, duration, scene.room_center, scene_cfg["n_loops"], scene_cfg["orbit_radius"],
                     scene_cfg["camera_height"]) for i in range(n)]
    R = np.stack([p[0] for p in poses])
    t = np.stack([p[1] for p in poses])
    kinds, _, halfs, labels, colors, _ = (torch.from_numpy(a).to(device) for a in scene.host_arrays(0.0))
    H, W = sensor["height"], sensor["width"]
    out = Frames(torch.empty((n, H, W), dtype=torch.float32, device=device),
                 torch.empty((n, H, W), dtype=torch.int32, device=device),
                 torch.empty((n, H, W, 3), dtype=torch.float32, device=device), R, t)
    for s in range(0, n, block):
        e = min(n, s + block)
        per_t = [scene.host_arrays(i / hz) for i in range(s, e)]
        centers = torch.from_numpy(np.stack([a[1] for a in per_t])).to(device)
        present = torch.from_numpy(np.stack([a[5] for a in per_t])).to(device)
        out.depth[s:e], out.labels[s:e], out.color[s:e] = _render_block(
            kinds, centers, halfs, labels, colors, present, rays, torch.from_numpy(R[s:e]).to(device),
            torch.from_numpy(t[s:e]).to(device), sensor["max_range"])
    return out
