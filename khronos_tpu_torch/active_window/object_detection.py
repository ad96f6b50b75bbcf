"""Semantic object detection: connected components of object-labeled pixels.

Port of `khronos_tpu/active_window/object_detection.py` (the reference
ConnectedSemantics detector, connected_semantics.cpp): 3D mode bins pixels by
(semantic class, voxel) and region-grows per class in voxel space
(cpp:70-144); 2D mode flood-fills the label image with 4/8 connectivity
(cpp:146-198); min-size filtering (cpp:200-217), gated by the label space's
`isObject()`.

The fused per-frame step runs the 3D mode inside one step;
`ConnectedSemantics` is the modular path. Ids, counts, classes and images
match the reference bit for bit; centroid sums agree to float32 rounding.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from khronos_tpu_torch.active_window.motion_detection import (
    MAX_CLUSTERS,
    MeasurementCluster,
    _clusters_and_remap,
    remap_image,
)
from khronos_tpu_torch.config import check_gt, register
from khronos_tpu_torch.geometry.camera import voxel_floor
from khronos_tpu_torch.ops import clusters as cl
from khronos_tpu_torch.ops.dense import propagate_labels_keyed_2d, propagate_labels_keyed_3d


@dataclasses.dataclass
class LabelSpace:
    """Closed-set label space: which class ids count as trackable objects
    (hydra GlobalInfo labelspace equivalent). Everything else is background."""

    num_classes: int = 32
    object_labels: Tuple[int, ...] = ()
    dynamic_labels: Tuple[int, ...] = ()  # classes expected to move (e.g. human)

    def is_object_lut(self) -> np.ndarray:
        lut = np.zeros(self.num_classes + 1, np.bool_)
        for l in self.object_labels:
            lut[l] = True
        return lut

    def is_dynamic_lut(self) -> np.ndarray:
        lut = np.zeros(self.num_classes + 1, np.bool_)
        for l in self.dynamic_labels:
            lut[l] = True
        return lut


@register("object_detector", "ConnectedSemantics")
@dataclasses.dataclass
class ConnectedSemanticsConfig:
    min_cluster_size: int = 50  # pixels (uHumans2.yaml:62)
    use_3d: bool = True
    use_full_connectivity: bool = True  # 2D mode connectivity
    grid_size: float = 0.1  # m; 3D binning resolution (uHumans2.yaml:65)
    max_range: float = 5.0
    grow_iterations: int = 20

    def check(self):
        check_gt(self.min_cluster_size, 0, "min_cluster_size")
        check_gt(self.grid_size, 0.0, "grid_size")

    def create(self, volume_config, camera, label_space: LabelSpace):
        return ConnectedSemantics(self, volume_config, camera, label_space)


def _detect_3d(origin, points_w, pix_class, valid, grid_shape, grid_size: float, iterations: int):
    """Per-pixel raw component label (-1 none): pixels binned by (class,
    voxel), 6-connected components per class in voxel space."""
    dev = points_w.device
    vox = voxel_floor(points_w, grid_size)
    idx = [vox[..., a] - int(o) for a, o in enumerate(origin.tolist())]
    in_grid = torch.ones_like(valid)
    for a in range(3):
        in_grid = in_grid & (idx[a] >= 0) & (idx[a] < grid_shape[a])
    ok = valid & in_grid & (pix_class >= 0)
    ci, cj, ck = (torch.where(ok, i, 0) for i in idx)
    n = grid_shape[0] * grid_shape[1] * grid_shape[2]
    lin_pix = ((ci * grid_shape[1] + cj) * grid_shape[2] + ck).reshape(-1).long()
    # voxel class = max class id of pixels landing in it (-1 = none)
    vclass = torch.full((n,), -1, dtype=torch.int32, device=dev)
    vclass = vclass.scatter_reduce_(0, lin_pix, torch.where(ok, pix_class, -1).reshape(-1).to(torch.int32), "amax")
    vclass = vclass.view(grid_shape)
    growable = vclass >= 0
    lin = torch.arange(n, dtype=torch.int32, device=dev).view(grid_shape)
    labels = propagate_labels_keyed_3d(torch.where(growable, lin, -1), vclass, growable, iterations)
    # per-pixel label: only if the pixel's class is its voxel's winning class
    g_class = vclass.reshape(-1)[lin_pix].view(ok.shape)
    g_lab = labels.reshape(-1)[lin_pix].view(ok.shape)
    return torch.where(ok & (g_class == pix_class), g_lab, -1)


def _detect_2d(pix_class, valid, iterations: int, full_connectivity: bool):
    H, W = pix_class.shape
    ok = valid & (pix_class >= 0)
    lin = torch.arange(H * W, dtype=torch.int32, device=pix_class.device).view(H, W)
    return propagate_labels_keyed_2d(torch.where(ok, lin, -1), pix_class, ok, iterations, full_connectivity)


def _cluster_stats(pix_label, pix_class, points_w):
    """Compact raw pixel labels and reduce per-cluster stats: (compact,
    counts, sums, bb_min, bb_max, class). Empty clusters carry class -1 (the
    reference's segment_max identity there is INT32_MIN; no empty cluster is
    ever kept)."""
    compact = cl.compact_labels(pix_label, MAX_CLUSTERS)
    counts, sums, bb_min, bb_max, cls = cl.cluster_stats(
        compact, points_w, extra=pix_class, max_clusters=MAX_CLUSTERS
    )
    return compact, counts, sums, bb_min, bb_max, cls


class ConnectedSemantics:
    def __init__(self, config: ConnectedSemanticsConfig, volume_config, camera, label_space: LabelSpace):
        self.config = config
        self.volume_config = volume_config
        self.camera = camera
        self.label_space = label_space
        self._is_object = torch.from_numpy(label_space.is_object_lut())

    def process(self, state, frame) -> List[MeasurementCluster]:
        """Fill frame.object_image (+ frame.semantic_clusters)."""
        cam = self.camera
        depth = frame.depth
        valid = (depth > cam.min_range) & (depth <= min(cam.max_range, self.config.max_range))
        labels = frame.labels
        lut = self._is_object.to(labels.device)
        safe = labels.clamp(0, lut.shape[0] - 1).long()
        pix_class = torch.where((labels >= 0) & lut[safe], labels, -1)
        points_w = cam.vertex_image_world(depth, frame.R_w_c, frame.t_w_c)
        if self.config.use_3d:
            pl = _detect_3d(
                state.origin, points_w, pix_class, valid, tuple(state.tsdf.shape),
                self.volume_config.voxel_size, self.config.grow_iterations,
            )
        else:
            pl = _detect_2d(pix_class, valid, self.config.grow_iterations, self.config.use_full_connectivity)
        compact, counts, sums, bb_min, bb_max, cls = _cluster_stats(pl, pix_class, points_w)
        counts = counts.cpu().numpy()
        clusters, out_ids = _clusters_and_remap(
            counts >= self.config.min_cluster_size, counts, sums.cpu().numpy(),
            bb_min.cpu().numpy(), bb_max.cpu().numpy(), category=cls.cpu().numpy(),
        )
        frame.object_image = remap_image(compact, out_ids)
        frame.semantic_clusters = clusters
        return clusters
