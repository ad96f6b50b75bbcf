"""Object extraction: finished tracks -> KhronosObject nodes.

Port of `khronos_tpu/active_window/object_extraction.py` (the reference
MeshObjectExtractor, khronos/src/active_window/object_extraction/
mesh_object_extractor.cpp):
  - dynamic tracks: per-observation centroid trajectory + mean bbox; dropped
    if total displacement < min_dynamic_displacement (cpp:106-172);
  - static tracks: merged observation bbox -> dedicated small TSDF grid
    (voxel size = fraction of extent or fixed, cpp:200-228) -> re-integrate
    the buffered frames with binary semantics (foreground = pixels of the
    track's semantic cluster, ObjectIntegrator cpp:58-81) -> prune voxels
    whose foreground confidence is below min_object_reconstruction_confidence
    (cpp:245-264, 342-356) -> mesh -> volume filters -> mesh shifted into the
    bbox frame (cpp:266-303).

Two device functions do the grid work, as PyTorch operations on the device
the buffered frames live on: `_reconstruct_device` fuses the frames into a
[G, G, G] grid one frame after the other (the reference's scan over K padded
frames; padding frames change nothing, so only real frames are visited), and
`_mesh_small_grid` runs marching tetrahedra over all (G-1)^3 cells with the
active window's tables and compacts the triangles to MAX_OBJ_TRIS rows on the
device. The host pulls the meta row first, then only the triangle rows: the
spans `wait/extract_meta` and `wait/extract_body` (`utils/timing.py`), each
inside the track's `object_extraction/track`.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from khronos_tpu_torch import fma32, resolve_device, sqrt32
from khronos_tpu_torch.active_window.tracking import Track
from khronos_tpu_torch.config import check_gt, register
from khronos_tpu_torch.geometry.camera import Camera, world_to_camera
from khronos_tpu_torch.map.meshing import CORNER_OFFSETS, TET_EDGES, TET_TABLE, TETS
from khronos_tpu_torch.ops.clusters import compact_rows
from khronos_tpu_torch.stm.scene_graph import KhronosObject, MeshAccumulator
from khronos_tpu_torch.utils.timing import Timer, Wait


@register("object_extractor", "MeshObjectExtractor")
@dataclasses.dataclass
class MeshObjectExtractorConfig:
    min_object_allocation_confidence: float = 0.5
    min_object_volume: float = 0.005  # m^3 (uHumans2.yaml:91)
    max_object_volume: float = 10.0  # m^3
    min_dynamic_displacement: float = 1.0  # m
    min_object_reconstruction_confidence: float = 0.5
    only_extract_reconstructed_objects: bool = True
    # negative: voxel = |value| * max bbox extent; positive: meters (yaml:98)
    object_reconstruction_resolution: float = -0.02
    grid_size: int = 48  # reconstruction grid voxels per side
    max_frames: int = 24  # buffered frames re-integrated per object
    min_num_observations: int = 15  # for track confidence

    def check(self):
        check_gt(self.grid_size, 7, "grid_size")
        check_gt(self.max_frames, 0, "max_frames")

    def create(self, camera: Camera, device=None):
        return MeshObjectExtractor(self, camera, device=device)


def _reconstruct_device(frames, camera: Camera, origin, voxel, trunc, min_conf, G: int, device):
    """Binary-semantic TSDF fusion of `frames` into a [G, G, G] grid.

    frames: (depth [H, W], object_image [H, W] int32, cluster_id, R_w_c,
    t_w_c) per frame, images on `device`, poses host float32; origin [3]
    float32 grid corner, voxel / trunc / min_conf float32 scalars.

    Returns (tsdf, weight, confidence) where confidence = w_fg/(w_fg+w_bg);
    tsdf<0 voxels with confidence < min_conf are pruned to +trunc with
    their weight kept (mesh_object_extractor.cpp:245-264 semantics).

    Rounds as XLA CPU compiles the reference's program (fused multiply-adds
    for the centers, the camera z, the pixel coordinates, the range and the
    weighted mean; tests/test_torch_contraction.py holds it bit for bit)."""
    voxel, trunc, min_conf = (float(np.float32(x)) for x in (voxel, trunc, min_conf))
    G3 = (G, G, G)
    centers = []
    for axis in range(3):
        # XLA CPU fuses origin + (i + 0.5) * voxel into one rounding
        c = fma32(torch.arange(G, device=device).to(torch.float32) + 0.5, voxel, float(np.float32(origin[axis])))
        view = [1, 1, 1]
        view[axis] = G
        centers.append(c.view(view).expand(G3))
    W, H = camera.width, camera.height
    tsdf = torch.full(G3, trunc, dtype=torch.float32, device=device)
    w = torch.zeros(G3, dtype=torch.float32, device=device)
    w_fg = torch.zeros(G3, dtype=torch.float32, device=device)
    w_bg = torch.zeros(G3, dtype=torch.float32, device=device)
    for depth, obj_img, cid, R, t in frames:
        pc = world_to_camera(centers, R, t)
        z = pc[2]
        safe_z = torch.where(z > 1e-6, z, 1e-6)
        u = fma32(pc[0] / safe_z, camera.fx, camera.cx)
        v = fma32(pc[1] / safe_z, camera.fy, camera.cy)
        in_img = (z > 1e-6) & (u >= 0) & (u <= W - 1) & (v >= 0) & (v <= H - 1)
        # clamp in float first: an out-of-range float->int cast is undefined
        # (the index only matters where in_img holds)
        ui = torch.round(u - 0.5).clamp(-1, W).to(torch.int32).clamp(0, W - 1)
        vi = torch.round(v - 0.5).clamp(-1, H).to(torch.int32).clamp(0, H - 1)
        pix = (vi * W + ui).reshape(-1)
        d = depth.reshape(-1)[pix].view(G3)
        is_fg = (obj_img.reshape(-1)[pix] == cid).view(G3)
        valid_pix = in_img & (d > 0.0)
        rscale = sqrt32(fma32(z, z, fma32(pc[0], pc[0], pc[1] * pc[1]))) / safe_z
        sdf = (d - z) * rscale

        in_band = valid_pix & (sdf.abs() <= trunc)
        in_front = valid_pix & (sdf > trunc)
        # tsdf from foreground pixels only (ObjectIntegrator binary semantics);
        # free-space carving from any valid pixel seeing through the voxel
        upd = (in_band & is_fg) | in_front
        sdf_c = sdf.clamp(-trunc, trunc)
        tsdf = torch.where(upd, fma32(tsdf, w, sdf_c) / (w + 1.0), tsdf)
        w = torch.where(upd, w + 1.0, w)
        # binary semantic evidence near the surface band
        w_fg = w_fg + (in_band & is_fg).to(torch.float32)
        w_bg = w_bg + ((in_band & ~is_fg) | in_front).to(torch.float32)
    conf = w_fg / torch.clamp_min(w_fg + w_bg, 1.0)
    prune = (tsdf < 0.0) & (conf < min_conf)
    tsdf = torch.where(prune, trunc, tsdf)
    return tsdf, w, conf


MAX_OBJ_TRIS = 32768

# global cube corner (0..7) of each triangle vertex's two edge ends, by
# [tet, case, triangle, vertex]; -1 where the case has no such triangle
_EDGE_CORNERS = {}


def _edge_corner_tables(device):
    key = str(device)
    if key not in _EDGE_CORNERS:
        safe = np.maximum(TET_TABLE, 0)  # [16, 2, 3] edge ids
        ends = TET_EDGES[safe]  # [16, 2, 3, 2] tet-local vertex ids
        corners = np.stack([TETS[t][ends] for t in range(len(TETS))])  # [6, 16, 2, 3, 2]
        _EDGE_CORNERS[key] = tuple(
            torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in (corners[..., 0].astype(np.int64), corners[..., 1].astype(np.int64),
                      TETS.astype(np.int64), CORNER_OFFSETS.astype(np.int64), TET_TABLE[:, :, 0] >= 0)
        )
    return _EDGE_CORNERS[key]


def _mesh_small_grid(tsdf, weight, origin, voxel, G: int):
    """Marching tetrahedra over ALL cells of a small grid, compacted on the
    device to MAX_OBJ_TRIS rows. Returns packed [MAX_OBJ_TRIS + 1, 9] float32;
    last row = [n_tris, vmin(3), vmax(3), 0, 0] where the bbox covers ALL
    valid triangles (even those dropped by the capacity cap, so volume
    filters see the true extent).

    Memory: per-cell values are gathered as [N, 8] rows and per-triangle
    vertices as [N, 36] columns (N = (G-1)^3 cells, 6 tets x 2 triangles x 3
    vertices), so no [N, 6, 2, 3]-shaped index tensor is built per axis."""
    dev = tsdf.device
    voxel = float(np.float32(voxel))
    C = G - 1
    N = C * C * C
    gc_p_tab, gc_q_tab, tets, off, has_tri = _edge_corner_tables(dev)
    ar = torch.arange(C, device=dev)
    cell_ijk = [
        ar.view(C, 1, 1).expand(C, C, C).reshape(-1),
        ar.view(1, C, 1).expand(C, C, C).reshape(-1),
        ar.view(1, 1, C).expand(C, C, C).reshape(-1),
    ]
    corner = [cell_ijk[a][:, None] + off[None, :, a] for a in range(3)]  # [N, 8] each
    flat = (corner[0] * G + corner[1]) * G + corner[2]
    sdf = tsdf.reshape(-1)[flat]  # [N, 8]
    wgt = weight.reshape(-1)[flat]
    pos = [float(np.float32(origin[a])) + (corner[a].to(torch.float32) + 0.5) * voxel for a in range(3)]
    cell_ok = (wgt > 0.0).all(dim=1)

    t_sdf = sdf[:, tets]  # [N, 6, 4]
    inside = (t_sdf < 0.0).to(torch.int64)
    case = inside[..., 0] + inside[..., 1] * 2 + inside[..., 2] * 4 + inside[..., 3] * 8  # [N, 6]
    t_idx = torch.arange(6, device=dev)[None, :]
    tri_valid = has_tri[case] & cell_ok[:, None, None]  # [N, 6, 2]
    gc_p = gc_p_tab[t_idx, case].reshape(N, 36)  # [N, 6 tets x 2 tris x 3 verts]
    gc_q = gc_q_tab[t_idx, case].reshape(N, 36)

    sdf_p = sdf.gather(1, gc_p)
    sdf_q = sdf.gather(1, gc_q)
    denom = sdf_p - sdf_q
    t_int = torch.where(
        denom.abs() > 1e-9, sdf_p / torch.where(denom == 0, 1e-9, denom), 0.5
    ).clamp(0.0, 1.0)
    verts = []
    for a in range(3):
        pos_p = pos[a].gather(1, gc_p)
        pos_q = pos[a].gather(1, gc_q)
        verts.append(pos_p + t_int * (pos_q - pos_p))
    verts = torch.stack(verts, dim=-1)  # [N, 36, 3]

    flat_valid = tri_valid.reshape(N * 12)
    flat_verts = verts.reshape(N * 12, 9)
    packed = compact_rows(flat_verts, flat_valid, MAX_OBJ_TRIS)
    n = torch.clamp_max(flat_valid.sum(dtype=torch.int32), MAX_OBJ_TRIS)
    # bbox over ALL valid triangles (cap-independent)
    tri_pts = flat_verts.view(N * 12, 3, 3)
    big = 1e30
    vmask = flat_valid[:, None, None]
    vmin = torch.where(vmask, tri_pts, big).amin(dim=(0, 1))
    vmax = torch.where(vmask, tri_pts, -big).amax(dim=(0, 1))
    meta = torch.cat([n.to(torch.float32)[None], vmin, vmax, torch.zeros(2, dtype=torch.float32, device=dev)])
    return torch.cat([packed, meta[None, :]], dim=0)


class MeshObjectExtractor:
    def __init__(self, config: MeshObjectExtractorConfig, camera: Camera, device=None):
        """device: where the grid work runs (the buffered frames are moved
        there); CUDA unless the caller passes device="cpu"."""
        self.config = config
        self.camera = camera
        self.device = resolve_device(device)
        self._next_node_id = 1

    # ------------------------------------------------------------------
    def extract(self, track: Track, frame_buffer) -> Optional[KhronosObject]:
        """Turn a finished track into an object node (or None if rejected)."""
        cfg = self.config
        if track.confidence(cfg.min_num_observations) < cfg.min_object_allocation_confidence:
            return None
        if track.is_dynamic:
            return self._extract_dynamic(track)
        return self._extract_static(track, frame_buffer)

    def extract_all(self, tracks: List[Track], frame_buffer) -> List[KhronosObject]:
        out = []
        for t in tracks:
            with Timer("object_extraction/track"):
                obj = self.extract(t, frame_buffer)
            if obj is not None:
                out.append(obj)
        return out

    # ------------------------------------------------------------------
    def _extract_dynamic(self, track: Track) -> Optional[KhronosObject]:
        obs = [o for o in track.observations if o.centroid is not None]
        if len(obs) < 2:
            return None
        traj = np.stack([o.centroid for o in obs]).astype(np.float32)
        stamps = [o.stamp_ns for o in obs]
        disp = float(np.linalg.norm(traj - traj[0], axis=1).max())
        if disp < self.config.min_dynamic_displacement:
            return None
        # mean bbox extent, placed at the first centroid
        ext = np.stack([o.bbox_max - o.bbox_min for o in obs]).mean(axis=0)
        bbox_min = traj[0] - ext / 2
        bbox_max = traj[0] + ext / 2
        obj = KhronosObject(
            node_id=self._next_node_id,
            semantic_category=track.semantic_category,
            bbox_min=bbox_min,
            bbox_max=bbox_max,
            first_observed_ns=[track.first_seen_ns],
            last_observed_ns=[track.last_seen_ns],
            mesh_vertices=np.zeros((0, 3), np.float32),
            mesh_faces=np.zeros((0, 3), np.int64),
            mesh_colors=np.zeros((0, 3), np.float32),
            trajectory_stamps_ns=stamps,
            trajectory_positions=traj,
            feature=track.feature,
            confidence=track.confidence(self.config.min_num_observations),
        )
        self._next_node_id += 1
        return obj

    # ------------------------------------------------------------------
    def reconstruct(self, track: Track, frame_buffer):
        """The grid of a static track: (bbox_min, bbox_max, origin, voxel,
        (tsdf, weight, confidence)), or None when the track has no buffered
        frame with its semantic cluster or no extent."""
        cfg = self.config
        # observations with a semantic cluster and a buffered frame
        obs = [
            o
            for o in track.observations
            if o.semantic_cluster_id > 0 and frame_buffer.get(o.stamp_ns) is not None
        ]
        if not obs:
            return None
        if len(obs) > cfg.max_frames:
            sel = np.linspace(0, len(obs) - 1, cfg.max_frames).astype(int)
            obs = [obs[i] for i in sel]

        bbox_min = np.min(np.stack([o.bbox_min for o in obs]), axis=0)
        bbox_max = np.max(np.stack([o.bbox_max for o in obs]), axis=0)
        extent = bbox_max - bbox_min
        max_extent = float(extent.max())
        if max_extent <= 0:
            return None
        res = cfg.object_reconstruction_resolution
        if res == 0:
            return None
        voxel = abs(res) * max_extent if res < 0 else res
        voxel = max(voxel, 0.005)
        # grid covers bbox + margin
        margin = 2.5 * voxel
        origin = np.asarray(bbox_min - margin, np.float32)
        G = cfg.grid_size
        needed = (extent + 2 * margin).max() / G
        voxel = max(voxel, float(needed) * 1.001)
        trunc = 2.0 * voxel

        frames = []
        for o in obs:
            fd = frame_buffer.get(o.stamp_ns)
            frames.append((fd.depth.to(self.device), fd.object_image.to(self.device),
                           o.semantic_cluster_id, fd.R_w_c, fd.t_w_c))
        grid = _reconstruct_device(
            frames, self.camera, origin, voxel, trunc,
            cfg.min_object_reconstruction_confidence, G, self.device,
        )
        return bbox_min, bbox_max, origin, voxel, grid

    def _extract_static(self, track: Track, frame_buffer) -> Optional[KhronosObject]:
        cfg = self.config
        rec = self.reconstruct(track, frame_buffer)
        if rec is None:
            return None
        bbox_min, bbox_max, origin, voxel, (tsdf, weight, _) = rec
        packed_dev = _mesh_small_grid(tsdf, weight, origin, voxel, cfg.grid_size)
        # pull the meta row first, then ONLY the real triangle rows (the full
        # packed array is ~1.2 MB a track, mostly padding)
        with Wait("extract_meta", packed_dev.is_cuda):
            meta_row = packed_dev[-1].cpu().numpy()
        n = int(meta_row[0])
        if n:
            with Wait("extract_body", packed_dev.is_cuda):
                body = packed_dev[:n].cpu().numpy()
            packed = np.concatenate([body, meta_row[None]])
        else:
            packed = meta_row[None]
        verts = packed[:n].reshape(-1, 3, 3)
        if len(verts) == 0:
            return None if cfg.only_extract_reconstructed_objects else self._bbox_only(track, bbox_min, bbox_max)

        # volume filter: bbox of the FULL reconstructed surface (from the
        # device-side reduction over all valid triangles, independent of the
        # MAX_OBJ_TRIS packing cap)
        vmin = packed[-1, 1:4].copy()
        vmax = packed[-1, 4:7].copy()
        vol = float(np.prod(np.clip(vmax - vmin, 0, None)))
        if vol < cfg.min_object_volume or vol > cfg.max_object_volume:
            return None

        # index the triangle soup (dedup at half-voxel resolution)
        acc = MeshAccumulator(resolution=voxel * 0.5)
        T = len(verts)
        zero = np.zeros((T, 3), np.int64)
        col = np.full((T, 3, 3), 0.5, np.float32)
        acc.add_triangles(verts, col, zero, zero, np.full((T, 3), track.semantic_category))
        mesh = acc.build()

        obj = KhronosObject(
            node_id=self._next_node_id,
            semantic_category=track.semantic_category,
            bbox_min=vmin,
            bbox_max=vmax,
            first_observed_ns=[track.first_seen_ns],
            last_observed_ns=[track.last_seen_ns],
            mesh_vertices=mesh.vertices - vmin.astype(np.float32),
            mesh_faces=mesh.faces,
            mesh_colors=mesh.colors,
            feature=track.feature,
            confidence=track.confidence(cfg.min_num_observations),
        )
        self._next_node_id += 1
        return obj

    def _bbox_only(self, track: Track, bbox_min, bbox_max) -> KhronosObject:
        obj = KhronosObject(
            node_id=self._next_node_id,
            semantic_category=track.semantic_category,
            bbox_min=bbox_min,
            bbox_max=bbox_max,
            first_observed_ns=[track.first_seen_ns],
            last_observed_ns=[track.last_seen_ns],
            mesh_vertices=np.zeros((0, 3), np.float32),
            mesh_faces=np.zeros((0, 3), np.int64),
            mesh_colors=np.zeros((0, 3), np.float32),
            feature=track.feature,
            confidence=track.confidence(self.config.min_num_observations),
        )
        self._next_node_id += 1
        return obj
