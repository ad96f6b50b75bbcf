"""Dataset adapters: frame sources for the pipeline (L0, no ROS).

Port of `khronos_tpu/data/datasets.py`: a dataset yields (FrameData, gt_pose
or None), its images on the dataset's device (CUDA unless the caller passes
device="cpu") and its poses host float32. Adapters:

  SyntheticDataset   the parametric renderer: the office scene, or the
                     apartment for every other scene name (the reference's
                     rule), posed at its drifted odometry with the
                     ground-truth pose beside it; with `openset=True` each
                     frame also carries the instance image and the
                     per-instance embeddings
  DirectoryDataset   one .npz per frame + poses.csv + intrinsics.json — the
                     documented interchange format for converted bags
  TumRGBDDataset     TUM RGB-D layout (depth/ rgb/ png + groundtruth.txt)
  rosbag2            `data/rosbag2.py`'s Rosbag2Dataset (make_dataset)

DirectoryDataset layout:
  <root>/intrinsics.json   {"height","width","fx","fy","cx","cy",
                            "depth_scale" (m per unit), "max_range"}
  <root>/poses.csv         stamp_ns,tx,ty,tz,qw,qx,qy,qz   (T_world_camera)
  <root>/frames/<stamp_ns>.npz  depth (u16/f32 HxW), color (u8 HxWx3),
                                labels (i16/i32 HxW, optional),
                                instances (i32, optional),
                                features (f32 NxD, optional)
"""

from __future__ import annotations

import csv
import json
import os
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from khronos_tpu_torch import resolve_device
from khronos_tpu_torch.active_window.frame_data import FrameData
from khronos_tpu_torch.geometry import transforms as tf
from khronos_tpu_torch.geometry.camera import Camera


def host_rotation(q_wxyz) -> np.ndarray:
    """(w, x, y, z) quaternion -> host float32 rotation, computed in float32
    as the reference's quat_to_rot of the quaternion as a float32 array."""
    q = torch.from_numpy(np.asarray(q_wxyz, np.float32))
    return tf.quat_to_rot(q).numpy()


def _on(device, a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


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


class DirectoryDataset(Dataset):
    def __init__(self, root: str, device=None):
        self.root = root
        self.device = resolve_device(device)
        with open(os.path.join(root, "intrinsics.json")) as fh:
            intr = json.load(fh)
        self.camera = Camera(
            height=intr["height"], width=intr["width"], fx=intr["fx"], fy=intr["fy"],
            cx=intr["cx"], cy=intr["cy"],
            min_range=intr.get("min_range", 0.1), max_range=intr.get("max_range", 5.0),
        )
        self.depth_scale = float(intr.get("depth_scale", 1.0))
        self.poses = {}
        with open(os.path.join(root, "poses.csv")) as fh:
            for row in csv.DictReader(fh):
                stamp = int(row["stamp_ns"])
                q = np.asarray([float(row["qw"]), float(row["qx"]), float(row["qy"]), float(row["qz"])], np.float32)
                t = np.asarray([float(row["tx"]), float(row["ty"]), float(row["tz"])], np.float32)
                self.poses[stamp] = (host_rotation(q), t)
        frames_dir = os.path.join(root, "frames")
        self.stamps: List[int] = sorted(
            int(f[:-4]) for f in os.listdir(frames_dir) if f.endswith(".npz")
        )
        self.stamps = [s for s in self.stamps if s in self.poses]

    def __len__(self):
        return len(self.stamps)

    def __iter__(self):
        dev = self.device
        for stamp in self.stamps:
            data = np.load(os.path.join(self.root, "frames", f"{stamp}.npz"))
            depth = data["depth"].astype(np.float32) * self.depth_scale
            color = data["color"].astype(np.float32)
            if color.max() > 1.5:
                color = color / 255.0
            labels = data["labels"].astype(np.int32) if "labels" in data else np.full(depth.shape, -1, np.int32)
            instances = data["instances"].astype(np.int32) if "instances" in data else None
            features = data["features"].astype(np.float32) if "features" in data else None
            R, t = self.poses[stamp]
            yield (
                FrameData(
                    stamp_ns=stamp,
                    depth=_on(dev, depth),
                    color=_on(dev, color),
                    labels=_on(dev, labels),
                    R_w_c=R,
                    t_w_c=t,
                    instances=_on(dev, instances) if instances is not None else None,
                    label_features=features,
                ),
                None,
            )


class TumRGBDDataset(Dataset):
    """TUM RGB-D: depth/*.png (16-bit, 5000 units/m), rgb/*.png,
    groundtruth.txt `stamp tx ty tz qx qy qz qw` (no semantics)."""

    def __init__(self, root: str, camera: Optional[Camera] = None, max_frames: int = 0, device=None):
        self.root = root
        self.device = resolve_device(device)
        self.camera = camera or Camera(480, 640, 525.0, 525.0, 319.5, 239.5)
        gt = []
        with open(os.path.join(root, "groundtruth.txt")) as fh:
            for line in fh:
                if line.startswith("#"):
                    continue
                v = line.split()
                gt.append([float(x) for x in v])
        self.gt = np.asarray(gt)
        depth_dir = os.path.join(root, "depth")
        self.depth_files = sorted(os.listdir(depth_dir))
        rgb_dir = os.path.join(root, "rgb")
        self.rgb_files = sorted(os.listdir(rgb_dir)) if os.path.isdir(rgb_dir) else []
        if max_frames:
            self.depth_files = self.depth_files[:max_frames]

    def __len__(self):
        return len(self.depth_files)

    def _pose_at(self, t: float):
        i = int(np.clip(np.searchsorted(self.gt[:, 0], t), 0, len(self.gt) - 1))
        row = self.gt[i]
        q = np.asarray([row[7], row[4], row[5], row[6]], np.float32)  # wxyz
        return host_rotation(q), row[1:4].astype(np.float32)

    def __iter__(self):
        from PIL import Image

        dev = self.device
        rgb_stamps = np.asarray([float(f[:-4]) for f in self.rgb_files]) if self.rgb_files else None
        for fname in self.depth_files:
            t = float(fname[:-4])
            depth = np.asarray(Image.open(os.path.join(self.root, "depth", fname)), np.float32) / 5000.0
            color = np.zeros(depth.shape + (3,), np.float32)
            if rgb_stamps is not None and len(rgb_stamps):
                j = int(np.clip(np.searchsorted(rgb_stamps, t), 0, len(self.rgb_files) - 1))
                color = np.asarray(
                    Image.open(os.path.join(self.root, "rgb", self.rgb_files[j])), np.float32
                )[..., :3] / 255.0
            R, pos = self._pose_at(t)
            yield (
                FrameData(
                    stamp_ns=int(t * 1e9),
                    depth=_on(dev, depth),
                    color=_on(dev, color),
                    labels=torch.full(depth.shape, -1, dtype=torch.int32, device=dev),
                    R_w_c=R,
                    t_w_c=pos,
                ),
                None,
            )


def make_dataset(kind: str, device=None, **kwargs) -> Dataset:
    """The dataset of `kind`; device: where its frames land (CUDA unless the
    caller passes device="cpu")."""
    if kind == "synthetic":
        return SyntheticDataset(device=device, **kwargs)
    if kind == "directory":
        return DirectoryDataset(device=device, **kwargs)
    if kind == "tum":
        return TumRGBDDataset(device=device, **kwargs)
    if kind == "rosbag2":
        from khronos_tpu_torch.data.rosbag2 import Rosbag2Dataset, Rosbag2DatasetConfig

        return Rosbag2Dataset(Rosbag2DatasetConfig(**kwargs), device=device)
    raise ValueError(f"unknown dataset kind '{kind}'")
