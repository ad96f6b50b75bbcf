"""Object extraction: configuration only.

`MeshObjectExtractorConfig` is registered under the same plugin name as in
`khronos_tpu/active_window/object_extraction.py`, so one config dict builds
both packages. The extractor itself (per-object re-integration over buffered
frames and the small-grid meshing) is the next slice of the port; until then
the active window hands finished tracks out on
`ActiveWindowOutput.pending_tracks`, and `create` raises.
"""

from __future__ import annotations

import dataclasses

from khronos_tpu_torch.config import check_gt, register


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

    def create(self, camera):
        raise NotImplementedError(
            "MeshObjectExtractor is not ported yet (the next slice: object extraction)"
        )
