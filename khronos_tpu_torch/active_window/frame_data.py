"""FrameData: one sensor frame plus derived detection images, and a ring buffer.

Port of `khronos_tpu/active_window/frame_data.py` (the reference's
khronos::FrameData, frame_data.h:59-83, and FrameDataBuffer,
frame_data_buffer.cpp:57-109). Images are torch tensors (on the device the
active window runs on); poses are host numpy float32; the buffer is host-side
bookkeeping. Stamps: int64 ns on the host, float32 seconds (relative to
sequence start) on the device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from khronos_tpu_torch.config import check_ge, check_gt


@dataclasses.dataclass
class FrameData:
    """One input frame with pose and derived images.

    depth:   [H, W] float32 z-depth (m); <=0 marks invalid pixels.
    color:   [H, W, 3] float32 in [0, 1].
    labels:  [H, W] int32 semantic class id (-1 = unknown).
    instances: optional [H, W] int32 externally-provided instance ids (0 = none).
    R_w_c / t_w_c: camera-to-world pose (host numpy float32).
    dynamic_image: [H, W] int32 motion-cluster id, 0 = static.
    object_image: [H, W] int32 semantic-cluster id, 0 = background.
    """

    stamp_ns: int
    depth: torch.Tensor
    color: torch.Tensor
    labels: torch.Tensor
    R_w_c: np.ndarray
    t_w_c: np.ndarray
    instances: Optional[torch.Tensor] = None
    label_features: Optional[np.ndarray] = None  # [num_instances, D] open-set
    dynamic_image: Optional[torch.Tensor] = None
    object_image: Optional[torch.Tensor] = None
    dynamic_clusters: list = dataclasses.field(default_factory=list)
    semantic_clusters: list = dataclasses.field(default_factory=list)

    def __post_init__(self):
        # poses are host data read by host bookkeeping every frame
        self.R_w_c = np.asarray(self.R_w_c, np.float32)
        self.t_w_c = np.asarray(self.t_w_c, np.float32)

    @property
    def stamp_s(self) -> float:
        return self.stamp_ns * 1e-9


@dataclasses.dataclass
class FrameDataBufferConfig:
    max_buffer_size: int = 300
    store_every_n_frames: int = 1

    def check(self):
        check_gt(self.max_buffer_size, 0, "max_buffer_size")
        check_ge(self.store_every_n_frames, 1, "store_every_n_frames")


class FrameDataBuffer:
    """Bounded frame retention for object extraction (host-side)."""

    def __init__(self, config: FrameDataBufferConfig):
        self.config = config
        self._frames: Dict[int, FrameData] = {}  # stamp_ns -> frame
        self._counter = 0

    def store(self, frame: FrameData) -> bool:
        self._counter += 1
        if (self._counter - 1) % self.config.store_every_n_frames != 0:
            return False
        self._frames[frame.stamp_ns] = frame
        return True

    def trim(self, referenced_stamps: set) -> int:
        """Drop frames not referenced by any active track; enforce max size.

        Mirrors FrameDataBuffer::trimBuffer: oldest unreferenced frames go
        first; if still over capacity, oldest referenced frames are dropped too.
        Returns number of frames removed.
        """
        removed = 0
        for s in sorted(self._frames):
            if s not in referenced_stamps:
                del self._frames[s]
                removed += 1
        stamps = sorted(self._frames)
        while len(stamps) > self.config.max_buffer_size:
            del self._frames[stamps.pop(0)]
            removed += 1
        return removed

    def get(self, stamp_ns: int) -> Optional[FrameData]:
        return self._frames.get(stamp_ns)

    def frames_in(self, stamps) -> List[FrameData]:
        return [self._frames[s] for s in stamps if s in self._frames]

    def __len__(self):
        return len(self._frames)

    def stamps(self) -> List[int]:
        return sorted(self._frames)
