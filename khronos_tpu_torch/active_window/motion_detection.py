"""Free-space motion detection (Dynablox-derived): configuration and the
per-cluster record.

Port of the parts of `khronos_tpu/active_window/motion_detection.py` that the
fused per-frame step uses: `MeasurementCluster` and
`FreeSpaceMotionDetectorConfig` (registered under the same plugin name, so
both packages build from one config dict). The detection itself runs inside
`fused_step.make_frame_step`. The modular `FreeSpaceMotionDetector` (the
reference's stage-by-stage path) is a later slice of the port; `create`
raises until then.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np

from khronos_tpu_torch.config import check_ge, check_gt, register

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
        raise NotImplementedError(
            "the modular FreeSpaceMotionDetector is not ported yet (a later slice: "
            "the modular detectors); the fused step runs motion detection"
        )
