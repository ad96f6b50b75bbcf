"""Fused per-frame step: the whole active-window hot path as one function.

Port of `khronos_tpu/active_window/fused_step.py`. One call runs motion
detection, object detection, TSDF + tracking integration and archival on the
device; its only outputs are the new volume state (stays on the device), the
id images (stay on the device for the frame buffer), and ONE packed float32
stats vector that the host tracker consumes:

  packed layout (float32), byte-identical to the reference:
    [0                 : MC*DYN_F]        dynamic cluster stats (DYN_F=12):
                                          centroid sums xyz, bbox min/max,
                                          pixels, voxels, out id
    [MC*DYN_F          : +MC*SEM_F]       semantic cluster stats (SEM_F=12):
                                          centroid sums xyz, bbox min/max,
                                          pixels, category, out id
    [...               : +MC*K*3]         dynamic cluster point subsamples
    [...               : +MC*K*3]         semantic cluster point subsamples

The step issues no host sync: crop starts and voxel origins are host
integers, and every reduction stays on the device. Motion-region growing goes
through kernel A (`ops/propagate.py`), the per-voxel payload lookup of
`integrate_frame` through kernel B (`ops/gather.py`).

With an `InstanceForwardingConfig` the step runs the open-set branch: the
upstream instance image and per-instance embeddings go in, the count,
volume and background-prompt filters run on the device, and the packed
'category' slot carries the original instance index. The device-mesh
(`mesh=`) variant raises NotImplementedError (a later slice).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from khronos_tpu_torch.active_window.motion_detection import (
    FreeSpaceMotionDetectorConfig,
    MeasurementCluster,
)
from khronos_tpu_torch.active_window.instance_forwarding import (
    OPENSET_CATEGORY,
    InstanceForwardingConfig,
)
from khronos_tpu_torch.active_window.object_detection import (
    ConnectedSemanticsConfig,
    LabelSpace,
)
from khronos_tpu_torch.geometry.camera import Camera, voxel_floor
from khronos_tpu_torch.map import active_volume as av
from khronos_tpu_torch.ops import clusters as cl
from khronos_tpu_torch.ops.dense import (
    dilate,
    max_pool3,
    propagate_labels_3d,
    propagate_labels_keyed_3d,
)

MC = 32  # max clusters per frame per kind
K_SAMPLES = 64  # point subsamples per cluster
DYN_F = 12
SEM_F = 12


def _scatter_max(n: int, index: torch.Tensor, values: torch.Tensor, fill: int) -> torch.Tensor:
    """out[index[i]] = max(out[index[i]], values[i]) over a [n] int32 vector
    that starts at `fill` (the reference's `.at[].max`; order-free)."""
    out = torch.full((n,), fill, dtype=torch.int32, device=values.device)
    return out.scatter_reduce_(0, index, values.reshape(-1).to(torch.int32), "amax", include_self=True)


def make_frame_step(
    vol_cfg: av.VolumeConfig,
    camera: Camera,
    md_cfg: Optional[FreeSpaceMotionDetectorConfig],
    od_cfg: Optional[ConnectedSemanticsConfig],
    label_space: LabelSpace,
    detection_stride: int = 1,
    crop: bool = True,
    background_embeddings: Optional[np.ndarray] = None,
    mesh=None,
):
    """Build the fused step:
    step(state, depth, color, labels, R_w_c, t_w_c, t_now)
      -> (state', dynamic_image, object_image, packed_stats).

    Open-set: when od_cfg is an InstanceForwardingConfig the step instead
    takes step(state, depth, color, labels, instances, features, R, t, t_now)
    with externally-segmented instances [H, W] (0 = none) and per-instance
    embeddings [MC, D] (a tensor on the state's device);
    `background_embeddings` [B, D] enable the on-device background filter.

    depth/color/labels are tensors on the state's device; R_w_c/t_w_c host
    float32; t_now seconds. The step updates `state`'s grids IN PLACE where
    the crop is written back (the reference donates its state buffer), so
    keep using only the returned state.

    detection_stride s > 1 runs detection (pixel->voxel scatter, label
    compaction, segment stats) on an s-strided image; TSDF/semantic
    integration stays full-resolution. Cluster pixel counts and size
    thresholds are then in detection-res pixels; the returned id images are
    nearest-upsampled back to full resolution."""
    if mesh is not None:
        raise NotImplementedError(
            "a device-mesh (sharded) frame step is not ported yet (a later slice: "
            "parallel/sharding.py)"
        )
    if od_cfg is not None and not isinstance(od_cfg, (ConnectedSemanticsConfig, InstanceForwardingConfig)):
        raise NotImplementedError(f"the fused step has no branch for object detector {type(od_cfg).__name__}")
    openset = isinstance(od_cfg, InstanceForwardingConfig)
    bg_emb = None
    if openset:
        if od_cfg.max_instances > MC:
            raise ValueError(f"max_instances {od_cfg.max_instances} > fused cap {MC}")
        if background_embeddings is not None and len(background_embeddings):
            bg = np.asarray(background_embeddings, np.float32)
            bg_emb = torch.from_numpy(bg / np.maximum(np.linalg.norm(bg, axis=-1, keepdims=True), 1e-9))
    is_object_lut = torch.from_numpy(label_space.is_object_lut())
    is_dynamic_lut = torch.from_numpy(label_space.is_dynamic_lut())
    shape = tuple(vol_cfg.grid_shape)
    md_enabled = md_cfg is not None
    seed_dyn = md_enabled and md_cfg.seed_dynamic_labels
    od_enabled = od_cfg is not None and not openset
    merge_dilation = max(0, (md_cfg.min_separation_distance - 1) if md_enabled else 0)
    s = int(detection_stride)
    if camera.height % s or camera.width % s:
        raise ValueError(f"detection_stride {s} must divide image {camera.height}x{camera.width}")
    s2 = s * s
    # detection-res camera: det pixel (i, j) <-> full pixel (i*s, j*s)
    cam_d = dataclasses.replace(
        camera,
        height=camera.height // s,
        width=camera.width // s,
        fx=camera.fx / s,
        fy=camera.fy / s,
        cx=camera.cx / s + 0.5 * (s - 1) / s,
        cy=camera.cy / s + 0.5 * (s - 1) / s,
    )
    md_min_px = max(1, round(md_cfg.min_cluster_size / s2)) if md_enabled else 0
    md_max_px = max(1, round(md_cfg.max_cluster_size / s2)) if md_enabled else 0
    od_min_px = max(1, round(od_cfg.min_cluster_size / s2)) if od_cfg is not None else 0
    max_r = min(camera.max_range, md_cfg.max_range if md_enabled else camera.max_range)

    # all grid work runs in a camera-centered crop: every voxel within
    # max_range is inside it
    crop = av.crop_shape_for_camera(vol_cfg, camera) if crop else shape
    cropping = any(c < g for c, g in zip(crop, shape))
    n_crop = crop[0] * crop[1] * crop[2]
    consts = {}  # per-device constants: crop linear ids and the label LUTs

    def _consts(dev):
        key = str(dev)
        if key not in consts:
            consts[key] = (
                torch.arange(n_crop, dtype=torch.int32, device=dev).view(crop),
                is_object_lut.to(dev),
                is_dynamic_lut.to(dev),
                bg_emb.to(dev) if bg_emb is not None else None,
            )
        return consts[key]

    def _upsample(img):
        return img.repeat_interleave(s, 0).repeat_interleave(s, 1) if s > 1 else img

    def _lut(lut, lab):
        return (lab >= 0) & lut[lab.clamp(0, lut.shape[0] - 1).long()]

    def _body(state, depth, color, labels, instances, features, R_w_c, t_w_c, t_now):
        dev = state.tsdf.device
        lin, obj_lut, dyn_lut, bg = _consts(dev)
        depth_d = depth[::s, ::s]
        labels_d = labels[::s, ::s]
        H, W = depth_d.shape
        points_w = cam_d.vertex_image_world(depth_d, R_w_c, t_w_c, reciprocal=True)  # as compiled
        valid = (depth_d > camera.min_range) & (depth_d <= max_r)

        start = av.crop_start(vol_cfg, state, t_w_c, crop)
        sub = av.slice_state(state, start, crop) if cropping else state

        vox = voxel_floor(points_w, vol_cfg.voxel_size)
        idx = [vox[..., a] - int(o) for a, o in enumerate(sub.origin.tolist())]
        in_grid = valid
        for a in range(3):
            in_grid = in_grid & (idx[a] >= 0) & (idx[a] < crop[a])
        ci, cj, ck = (torch.where(in_grid, i, 0) for i in idx)
        # ONE linear scatter index per pixel
        clin = ((ci * crop[1] + cj) * crop[2] + ck).reshape(-1).long()

        # ---------------- pixel -> voxel scatters ----------------
        # With both detectors, the seed scan and the per-voxel max object
        # class ride ONE scatter-max of a packed value (0: no pixel, 1: pixel
        # without object class, c+2: object-class pixel), with the dynamic
        # label bit in the LSB when seeding is on.
        pix_class = torch.where(_lut(obj_lut, labels_d), labels_d, -1) if od_enabled else None
        dyn_pix = _lut(dyn_lut, labels_d) if seed_dyn else None
        scan = vclass = dyn_hit = None
        if md_enabled and od_enabled:
            val = torch.where(in_grid, torch.where(pix_class >= 0, pix_class + 2, 1), 0)
            if seed_dyn:
                val = val * 2 + (in_grid & dyn_pix).to(torch.int32)
            packed_grid = _scatter_max(n_crop, clin, val, 0).view(crop)
            if seed_dyn:
                dyn_hit = (packed_grid & 1) == 1
                packed_grid = packed_grid >> 1
            scan = packed_grid >= 1
            vclass = torch.where(packed_grid >= 2, packed_grid - 2, -1)
        elif md_enabled:
            if seed_dyn:
                val = in_grid.to(torch.int32) * 2 + (in_grid & dyn_pix).to(torch.int32)
                packed_grid = _scatter_max(n_crop, clin, val, 0).view(crop)
                dyn_hit = (packed_grid & 1) == 1
                scan = packed_grid >= 2
            else:
                scan = _scatter_max(n_crop, clin, in_grid, 0).view(crop) > 0

        f32 = torch.float32
        zeros3 = torch.zeros((MC, 3), dtype=f32, device=dev)
        zeros_i = torch.zeros((MC,), dtype=torch.int32, device=dev)
        zeros_pts = torch.zeros((MC, K_SAMPLES, 3), dtype=f32, device=dev)
        # ---------------- motion detection ----------------
        if md_enabled:
            seeds = scan & ((sub.ever_free | dyn_hit) if seed_dyn else sub.ever_free)
            growable = dilate(seeds, merge_dilation) if merge_dilation > 0 else seeds
            mlab = propagate_labels_3d(torch.where(seeds, lin, -1), growable, md_cfg.grow_iterations)
            # one boundary layer: adjacent occupied scan voxels join a cluster
            # but do not extend it
            spread = max_pool3(mlab)
            mlab = torch.where(mlab >= 0, mlab, torch.where(scan, spread, -1))
            mlab = torch.where(scan, mlab, -1)
            pix_dyn_raw = torch.where(in_grid, mlab.reshape(-1)[clin].view(H, W), -1)
            pix_dyn_raw = torch.where(points_w[..., 2] >= md_cfg.min_z, pix_dyn_raw, -1)
            dyn_compact = cl.compact_labels(pix_dyn_raw, MC)
            d_counts, d_sums, d_bmin, d_bmax = cl.cluster_stats(dyn_compact, points_w, max_clusters=MC)
            # nothing downstream reads MeasurementCluster.num_voxels on this path
            d_vox = zeros_i
            d_keep = (d_counts >= md_min_px) & (d_counts <= md_max_px)
            dynamic_image, d_ids = cl.filter_and_renumber(dyn_compact, d_keep)
            d_pts, _ = cl.cluster_point_samples(dyn_compact, points_w, K_SAMPLES, MC)
        else:
            dynamic_image = torch.zeros((H, W), dtype=torch.int32, device=dev)
            d_counts = d_vox = d_ids = zeros_i
            d_sums = d_bmin = d_bmax = zeros3
            d_pts = zeros_pts

        # ---------------- object detection (3D keyed CC) ----------------
        if od_enabled:
            ok = in_grid & (pix_class >= 0)
            oclin = torch.where(ok.reshape(-1), clin, 0)
            if vclass is None:  # not merged with the motion-detection scatter
                vclass = _scatter_max(n_crop, oclin, torch.where(ok, pix_class, -1), -1).view(crop)
            ogrow = vclass >= 0
            olab = propagate_labels_keyed_3d(
                torch.where(ogrow, lin, -1), vclass, ogrow, od_cfg.grow_iterations
            )
            g_class = vclass.reshape(-1)[oclin].view(H, W)
            g_olab = olab.reshape(-1)[oclin].view(H, W)
            pix_sem_raw = torch.where(ok & (g_class == pix_class), g_olab, -1)
            sem_compact = cl.compact_labels(pix_sem_raw, MC)
            s_counts, s_sums, s_bmin, s_bmax, s_cat = cl.cluster_stats(
                sem_compact, points_w, extra=pix_class, max_clusters=MC
            )
            s_keep = s_counts >= od_min_px
            object_image, s_ids = cl.filter_and_renumber(sem_compact, s_keep)
            s_pts, _ = cl.cluster_point_samples(sem_compact, points_w, K_SAMPLES, MC)
        elif openset:
            # -------- open-set instance forwarding (device-side filters) ----
            inst_d = instances[::s, ::s]
            os_valid = (depth_d > camera.min_range) & (depth_d <= min(camera.max_range, od_cfg.max_range))
            sem_compact = torch.where(os_valid & (inst_d >= 1) & (inst_d <= MC), inst_d - 1, -1)
            s_counts, s_sums, s_bmin, s_bmax = cl.cluster_stats(sem_compact, points_w, max_clusters=MC)
            vol = torch.where(s_counts > 0, (s_bmax - s_bmin).clamp_min(0.0).prod(dim=-1), 0.0)
            s_keep = (s_counts >= od_min_px) & (vol >= od_cfg.min_bbox_volume) & (vol <= od_cfg.max_bbox_volume)
            if bg is not None:
                fn = features / torch.linalg.vector_norm(features, dim=-1, keepdim=True).clamp_min(1e-9)
                s_keep = s_keep & ((fn @ bg.T).amax(dim=-1) <= od_cfg.max_background_score)
            object_image, s_ids = cl.filter_and_renumber(sem_compact, s_keep)
            # 'category' slot carries the ORIGINAL instance index (the host
            # maps it to the frame's feature row and OPENSET_CATEGORY)
            s_cat = torch.arange(MC, dtype=torch.int32, device=dev)
            s_pts, _ = cl.cluster_point_samples(sem_compact, points_w, K_SAMPLES, MC)
        else:
            object_image = torch.zeros((H, W), dtype=torch.int32, device=dev)
            s_counts = s_ids = zeros_i
            s_sums = s_bmin = s_bmax = zeros3
            s_cat = torch.full((MC,), -1, dtype=torch.int32, device=dev)
            s_pts = zeros_pts

        # ---------------- integrate + archival (full resolution) ----------
        dynamic_image = _upsample(dynamic_image)
        object_image = _upsample(object_image)
        sub = av.integrate_frame(
            vol_cfg, camera, sub, depth, color, labels, dynamic_image > 0, R_w_c, t_w_c, t_now,
        )
        state = av.unslice_state(state, sub, start) if cropping else sub
        state = av.update_archival(vol_cfg, state, t_now)

        # ---------------- pack stats ----------------
        def _stats(sums, bmin, bmax, a, b, c):
            cols = [sums.to(f32), bmin.to(f32), bmax.to(f32)]
            cols += [v.to(f32)[:, None] for v in (a, b, c)]
            return torch.cat(cols, dim=1)  # [MC, 12]

        packed = torch.cat(
            [
                _stats(d_sums, d_bmin, d_bmax, d_counts, d_vox, d_ids).reshape(-1),
                _stats(s_sums, s_bmin, s_bmax, s_counts, s_cat, s_ids).reshape(-1),
                d_pts.to(f32).reshape(-1),
                s_pts.to(f32).reshape(-1),
            ]
        )
        return state, dynamic_image, object_image, packed

    if openset:
        def step(state, depth, color, labels, instances, features, R_w_c, t_w_c, t_now):
            return _body(state, depth, color, labels, instances, features, R_w_c, t_w_c, t_now)
    else:
        def step(state, depth, color, labels, R_w_c, t_w_c, t_now):
            return _body(state, depth, color, labels, None, None, R_w_c, t_w_c, t_now)
    return step


def unpack_stats(packed: np.ndarray, features: np.ndarray = None, openset: bool = False):
    """Host-side unpack -> (dyn_clusters, sem_clusters, dyn_points, sem_points).

    Cluster lists contain MeasurementCluster for valid (renumbered id > 0)
    entries; points dict maps output id -> [K, 3] subsample. With
    openset=True the sem 'category' slot is the original instance index:
    clusters get OPENSET_CATEGORY and feature = features[index]."""
    off = 0
    d_stats = packed[off : off + MC * DYN_F].reshape(MC, DYN_F)
    off += MC * DYN_F
    s_stats = packed[off : off + MC * SEM_F].reshape(MC, SEM_F)
    off += MC * SEM_F
    d_pts = packed[off : off + MC * K_SAMPLES * 3].reshape(MC, K_SAMPLES, 3)
    off += MC * K_SAMPLES * 3
    s_pts = packed[off : off + MC * K_SAMPLES * 3].reshape(MC, K_SAMPLES, 3)

    dyn_clusters, sem_clusters = [], []
    dyn_points, sem_points = {}, {}
    for k in range(MC):
        out_id = int(d_stats[k, 11])
        if out_id > 0:
            n = max(int(d_stats[k, 9]), 1)
            dyn_clusters.append(
                MeasurementCluster(
                    cluster_id=out_id,
                    num_pixels=int(d_stats[k, 9]),
                    num_voxels=int(d_stats[k, 10]),
                    centroid=d_stats[k, 0:3] / n,
                    bbox_min=d_stats[k, 3:6],
                    bbox_max=d_stats[k, 6:9],
                )
            )
            dyn_points[out_id] = d_pts[k, : min(int(d_stats[k, 9]), K_SAMPLES)]
        out_id = int(s_stats[k, 11])
        if out_id > 0:
            n = max(int(s_stats[k, 9]), 1)
            cat = int(s_stats[k, 10])
            feat = None
            if openset:
                if features is not None and 0 <= cat < len(features):
                    feat = np.asarray(features[cat], np.float32)
                cat = OPENSET_CATEGORY
            sem_clusters.append(
                MeasurementCluster(
                    cluster_id=out_id,
                    num_pixels=int(s_stats[k, 9]),
                    num_voxels=0,
                    centroid=s_stats[k, 0:3] / n,
                    bbox_min=s_stats[k, 3:6],
                    bbox_max=s_stats[k, 6:9],
                    category_id=cat,
                    feature=feat,
                )
            )
            sem_points[out_id] = s_pts[k, : min(int(s_stats[k, 9]), K_SAMPLES)]
    return dyn_clusters, sem_clusters, dyn_points, sem_points
