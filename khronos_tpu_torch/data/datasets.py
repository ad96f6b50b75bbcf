"""Dataset adapters: frame sources for the pipeline (L0, no ROS).

Port of `khronos_tpu/data/datasets.py` as far as the synthetic source goes:
a dataset yields (FrameData, gt_pose or None). `SyntheticDataset` renders the
office scene, or the apartment for every other scene name (the reference's
rule), as clean frames on the device and poses each frame at its drifted
odometry, with the ground-truth pose beside it; with `openset=True` each
frame also carries the instance image and the per-instance embeddings.
`DirectoryDataset`, `TumRGBDDataset` and rosbag input are later slices of
the port and raise NotImplementedError.
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np

from khronos_tpu_torch.active_window.frame_data import FrameData
from khronos_tpu_torch.geometry.camera import Camera


class Dataset:
    """Iterable of (FrameData, gt_pose or None)."""

    camera: Camera

    def __len__(self) -> int:
        raise NotImplementedError

    def __iter__(self) -> Iterator[Tuple[FrameData, Optional[tuple]]]:
        raise NotImplementedError


class SyntheticDataset(Dataset):
    def __init__(self, scene_name: str = "office", duration: float = 30.0,
                 fps: float = 10.0, height: int = 240, width: int = 320,
                 drift_rate: float = 0.0, openset: bool = False, device=None):
        """device: where frames are rendered; CUDA unless the caller passes
        device="cpu" (raises when no GPU is visible)."""
        from khronos_tpu_torch.data import synthetic as syn

        self.scene = syn.office_scene(duration) if scene_name == "office" else syn.apartment_scene(duration)
        f = width * 0.625
        self.seq = syn.SyntheticSequence(
            self.scene,
            syn.SyntheticSequenceConfig(
                duration=duration, fps=fps, height=height, width=width,
                fx=f, fy=f, cx=width / 2, cy=height / 2, drift_rate=drift_rate,
            ),
            device=device,
        )
        self.camera = self.seq.camera
        self.openset = openset
        self.duration = duration

    def __len__(self):
        return self.seq.n_frames

    def __iter__(self):
        for i in range(self.seq.n_frames):
            f = self.seq.render_frame(i)
            R_odo, t_odo = self.seq.odometry_pose(i)
            frame = FrameData(
                stamp_ns=f["stamp_ns"],
                depth=f["depth"],
                color=f["color"],
                labels=f["labels"],
                R_w_c=np.asarray(R_odo, np.float32),
                t_w_c=np.asarray(t_odo, np.float32),
                instances=f["instances"] if self.openset else None,
                label_features=f["features"] if self.openset else None,
            )
            yield frame, (f["R_gt"], f["t_gt"])


def make_dataset(kind: str, **kwargs) -> Dataset:
    if kind == "synthetic":
        return SyntheticDataset(**kwargs)
    if kind in ("directory", "tum", "rosbag2"):
        raise NotImplementedError(f"dataset kind '{kind}' is not ported yet (a later slice)")
    raise ValueError(f"unknown dataset kind '{kind}'")
