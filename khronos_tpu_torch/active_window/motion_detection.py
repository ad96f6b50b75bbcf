"""Free-space motion detection (Dynablox-derived) on the dense active volume.

Port of `khronos_tpu/active_window/motion_detection.py` (the reference
FreeSpaceMotionDetector, free_space_motion_detector.cpp): depth pixels landing
in ever-free voxels seed dynamic clusters (cpp:158-203); seeds region-grow
through this scan's occupied voxels (cpp:205-272); nearby clusters merge
(min_separation_distance, cpp:274-355); size filters (cpp:365-379); cluster
ids are written into the dynamic image (cpp:381-399).

The fused per-frame step (`fused_step.make_frame_step`) runs the same
detection inside one step; `FreeSpaceMotionDetector` is the modular path
(`ActiveWindowConfig.fused=False`, or an open-set config whose instance cap
exceeds the fused one). Region growing goes through kernel A
(`ops.dense.propagate_labels_3d`). Ids, counts and images match the reference
bit for bit; the point sums are a one-hot float32 matmul (deterministic, TF32
off), so centroids agree to float32 rounding of a differently ordered sum.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple

import numpy as np
import torch

from khronos_tpu_torch.config import check_ge, check_gt, register
from khronos_tpu_torch.geometry.camera import voxel_floor
from khronos_tpu_torch.ops import clusters as cl
from khronos_tpu_torch.ops.dense import dilate, max_pool3, propagate_labels_3d

MAX_CLUSTERS = 64

class MeasurementCluster(NamedTuple):
    """Host-side per-cluster record (mirrors khronos MeasurementCluster)."""

    cluster_id: int  # id as written in the image (1-based)
    num_pixels: int
    num_voxels: int
    centroid: np.ndarray  # [3]
    bbox_min: np.ndarray
    bbox_max: np.ndarray
    category_id: int = -1  # semantic clusters only
    feature: np.ndarray = None  # open-set clusters only


@register("motion_detector", "FreeSpaceMotionDetector")
@dataclasses.dataclass
class FreeSpaceMotionDetectorConfig:
    min_cluster_size: int = 500  # pixels (uHumans2.yaml:54)
    max_cluster_size: int = 100000  # pixels
    min_separation_distance: int = 2  # voxels (uHumans2.yaml:55)
    max_range: float = 5.0  # m
    min_z: float = -1.0e9  # m, ground removal off by default
    grow_iterations: int = 16  # label-propagation rounds (~1.6 m reach @ 0.1 m)
    # semantic motion seeding (fused mode): dynamic-labeled pixels seed
    # motion clusters directly, without requiring ever-free history. Off by
    # default for reference parity (geometry-only detection).
    seed_dynamic_labels: bool = False

    def check(self):
        check_gt(self.min_cluster_size, 0, "min_cluster_size")
        check_ge(self.min_separation_distance, 0, "min_separation_distance")

    def create(self, volume_config, camera):
        return FreeSpaceMotionDetector(self, volume_config, camera)


def _detect_device(
    state,
    points_w: torch.Tensor,  # [H, W, 3] world-frame vertex image
    valid: torch.Tensor,  # [H, W] valid depth & range mask
    voxel_size: float,
    grow_iterations: int,
    merge_dilation: int,
):
    """(compact [H, W], pix_counts, vox_counts, sums, bb_min, bb_max), every
    per-cluster array [MAX_CLUSTERS, ...]."""
    shape = tuple(state.tsdf.shape)
    dev = points_w.device
    vox = voxel_floor(points_w, voxel_size)
    idx = [vox[..., a] - int(o) for a, o in enumerate(state.origin.tolist())]
    in_grid = valid
    for a in range(3):
        in_grid = in_grid & (idx[a] >= 0) & (idx[a] < shape[a])
    ci, cj, ck = (torch.where(in_grid, i, 0) for i in idx)
    vox_lin = (ci * shape[1] + cj) * shape[2] + ck
    n = shape[0] * shape[1] * shape[2]

    # scan occupancy: voxels containing >= 1 point this frame
    scan = torch.zeros(n, dtype=torch.int32, device=dev)
    scan = scan.scatter_reduce_(0, vox_lin.reshape(-1).long(), in_grid.reshape(-1).to(torch.int32), "amax")
    scan = scan.view(shape) > 0
    seeds = scan & state.ever_free
    # growth is restricted to seed voxels; dilating the seed mask lets labels
    # hop the min_separation_distance gap so nearby clusters merge
    growable = dilate(seeds, merge_dilation) if merge_dilation > 0 else seeds
    lin = torch.arange(n, dtype=torch.int32, device=dev).view(shape)
    labels = propagate_labels_3d(torch.where(seeds, lin, -1), growable, grow_iterations)
    # one boundary layer: adjacent occupied scan voxels join the cluster but
    # do not extend it (cpp:259-268)
    spread = max_pool3(labels)
    labels = torch.where(labels >= 0, labels, torch.where(scan, spread, -1))
    labels = torch.where(scan, labels, -1)  # only real scan voxels carry ids

    pix_label = torch.where(in_grid, labels.reshape(-1)[vox_lin.reshape(-1).long()].view(in_grid.shape), -1)
    # jnp.unique(size=MAX_CLUSTERS + 1) + searchsorted keeps the
    # MAX_CLUSTERS smallest distinct labels, ranked ascending
    compact = cl.compact_labels(pix_label, MAX_CLUSTERS)
    pix_counts, sums, bb_min, bb_max = cl.cluster_stats(compact, points_w, max_clusters=MAX_CLUSTERS)
    vox_counts = cl.cluster_voxel_counts(compact, vox_lin, MAX_CLUSTERS)
    return compact, pix_counts, vox_counts, sums, bb_min, bb_max


def _clusters_and_remap(keep, pix_counts, sums, bb_min, bb_max, num_voxels=None, category=None):
    """Kept clusters renumbered 1..N in compact order (MeasurementClusters)
    and the [MAX_CLUSTERS + 1] int32 remap (dropped and none -> 0)."""
    out_ids = np.zeros(MAX_CLUSTERS + 1, np.int32)
    clusters: List[MeasurementCluster] = []
    next_id = 1
    for k in range(MAX_CLUSTERS):
        if keep[k]:
            out_ids[k] = next_id
            clusters.append(
                MeasurementCluster(
                    cluster_id=next_id,
                    num_pixels=int(pix_counts[k]),
                    num_voxels=int(num_voxels[k]) if num_voxels is not None else 0,
                    centroid=sums[k] / max(int(pix_counts[k]), 1),
                    bbox_min=bb_min[k],
                    bbox_max=bb_max[k],
                    category_id=int(category[k]) if category is not None else -1,
                )
            )
            next_id += 1
    return clusters, out_ids


def remap_image(compact: torch.Tensor, out_ids: np.ndarray) -> torch.Tensor:
    """Id image: compact id k -> out_ids[k], -1 -> out_ids[MAX_CLUSTERS]."""
    lut = torch.from_numpy(out_ids).to(compact.device)
    return lut[torch.where(compact >= 0, compact, MAX_CLUSTERS).long()]


class FreeSpaceMotionDetector:
    def __init__(self, config: FreeSpaceMotionDetectorConfig, volume_config, camera):
        self.config = config
        self.volume_config = volume_config
        self.camera = camera

    def process(self, state, frame) -> List[MeasurementCluster]:
        """Fill frame.dynamic_image (+ frame.dynamic_clusters). Returns clusters.

        frame: FrameData with depth (a tensor on the state's device) and pose
        set; uses the *pre-integration* volume state (ever-free from previous
        frames), matching the reference pipeline order."""
        cam = self.camera
        depth = frame.depth
        points_w = cam.vertex_image_world(depth, frame.R_w_c, frame.t_w_c)
        z_ok = points_w[..., 2] >= self.config.min_z
        valid = (depth > cam.min_range) & (depth <= min(cam.max_range, self.config.max_range)) & z_ok
        compact, pix_counts, vox_counts, sums, bb_min, bb_max = _detect_device(
            state,
            points_w,
            valid,
            self.volume_config.voxel_size,
            self.config.grow_iterations,
            max(0, self.config.min_separation_distance - 1),
        )
        pix_counts = pix_counts.cpu().numpy()
        keep = (pix_counts >= self.config.min_cluster_size) & (pix_counts <= self.config.max_cluster_size)
        clusters, out_ids = _clusters_and_remap(
            keep, pix_counts, sums.cpu().numpy(), bb_min.cpu().numpy(), bb_max.cpu().numpy(),
            num_voxels=vox_counts.cpu().numpy(),
        )
        frame.dynamic_image = remap_image(compact, out_ids)
        frame.dynamic_clusters = clusters
        return clusters
