"""Semantic object detection: label space and ConnectedSemantics configuration.

Port of the parts of `khronos_tpu/active_window/object_detection.py` that the
fused per-frame step uses: `LabelSpace` and `ConnectedSemanticsConfig`
(registered under the same plugin name). The 3D connected components run
inside `fused_step.make_frame_step`; the modular `ConnectedSemantics`
detector is a later slice of the port, and `create` raises until then.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from khronos_tpu_torch.config import check_gt, register


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
        raise NotImplementedError(
            "the modular ConnectedSemantics detector is not ported yet (a later "
            "slice: the modular detectors); the fused step runs object detection"
        )
