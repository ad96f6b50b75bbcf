"""Pure-Python rosbag2 reader: ingest the reference's datasets without ROS.

Port of `khronos_tpu/data/rosbag2.py`: host code, copied, with frames landing
on the dataset's device (CUDA unless the caller passes device="cpu") and
poses as host float32. The reference pipeline consumes ROS 2 bags (tesse_cd office/apartment and the
khronos_real mezzanine bag, reference README.md:101-142, played back through
ianvs). This module reads the rosbag2 sqlite3 storage format directly —
stdlib sqlite3 plus a minimal CDR (little-endian) decoder for the message
types the pipeline needs:

  sensor_msgs/msg/Image, sensor_msgs/msg/CameraInfo,
  nav_msgs/msg/Odometry, geometry_msgs/msg/PoseStamped,
  tf2_msgs/msg/TFMessage

`Rosbag2Dataset` synchronizes depth / color / label image topics to frames,
interpolates the pose topic, and yields FrameData like every other adapter
(SURVEY.md §1 L0 boundary).
"""

from __future__ import annotations

import dataclasses
import glob
import os
import sqlite3
import struct
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from khronos_tpu_torch import resolve_device
from khronos_tpu_torch.active_window.frame_data import FrameData
from khronos_tpu_torch.data.datasets import Dataset, host_rotation
from khronos_tpu_torch.geometry.camera import Camera


# ----------------------------------------------------------------------------
# CDR (little-endian) primitives
# ----------------------------------------------------------------------------


class CdrReader:
    """Minimal XCDR1 little-endian reader (alignment relative to the payload
    start, after the 4-byte encapsulation header)."""

    def __init__(self, buf: bytes):
        if len(buf) < 4:
            raise ValueError("CDR buffer too short")
        if buf[1] not in (0x01, 0x00):  # 0x0001 = CDR_LE
            raise ValueError(f"unsupported CDR encapsulation {buf[:2].hex()}")
        self.buf = buf
        self.pos = 4

    def _align(self, n: int) -> None:
        rel = self.pos - 4
        pad = (-rel) % n
        self.pos += pad

    def _read(self, fmt: str, size: int):
        self._align(size)
        v = struct.unpack_from("<" + fmt, self.buf, self.pos)[0]
        self.pos += size
        return v

    def u8(self):
        v = self.buf[self.pos]
        self.pos += 1
        return v

    def u32(self):
        return self._read("I", 4)

    def i32(self):
        return self._read("i", 4)

    def f64(self):
        return self._read("d", 8)

    def string(self) -> str:
        n = self.u32()
        s = self.buf[self.pos : self.pos + n]
        self.pos += n
        return s.rstrip(b"\x00").decode("utf-8", "replace")

    def bytes_seq(self) -> bytes:
        n = self.u32()
        b = self.buf[self.pos : self.pos + n]
        self.pos += n
        return b

    def f64_array(self, n: int) -> np.ndarray:
        self._align(8)
        out = np.frombuffer(self.buf, "<f8", count=n, offset=self.pos)
        self.pos += 8 * n
        return out

    def f64_seq(self) -> np.ndarray:
        return self.f64_array(self.u32())

    # ---- common compound types ----
    def time_ns(self) -> int:
        sec = self.i32()
        nsec = self.u32()
        return sec * 1_000_000_000 + nsec

    def header(self) -> Tuple[int, str]:
        stamp = self.time_ns()
        frame_id = self.string()
        return stamp, frame_id

    def point(self) -> np.ndarray:
        return np.array([self.f64(), self.f64(), self.f64()])

    def quaternion_wxyz(self) -> np.ndarray:
        x, y, z, w = self.f64(), self.f64(), self.f64(), self.f64()
        return np.array([w, x, y, z])


@dataclasses.dataclass
class ImageMsg:
    stamp_ns: int
    frame_id: str
    height: int
    width: int
    encoding: str
    data: np.ndarray  # decoded [H, W] or [H, W, C]


_ENCODINGS = {
    "mono8": (np.uint8, 1),
    "8UC1": (np.uint8, 1),
    "rgb8": (np.uint8, 3),
    "bgr8": (np.uint8, 3),
    "rgba8": (np.uint8, 4),
    "bgra8": (np.uint8, 4),
    "mono16": (np.uint16, 1),
    "16UC1": (np.uint16, 1),
    "16SC1": (np.int16, 1),
    "32SC1": (np.int32, 1),
    "32FC1": (np.float32, 1),
}


def decode_image(buf: bytes) -> ImageMsg:
    r = CdrReader(buf)
    stamp, frame_id = r.header()
    height, width = r.u32(), r.u32()
    encoding = r.string()
    _ = r.u8()  # is_bigendian
    step = r.u32()
    raw = r.bytes_seq()
    if encoding not in _ENCODINGS:
        raise ValueError(f"unsupported image encoding '{encoding}'")
    dt, ch = _ENCODINGS[encoding]
    itemsize = np.dtype(dt).itemsize
    rows = np.frombuffer(raw, np.uint8).reshape(height, step)
    img = rows[:, : width * ch * itemsize].reshape(height, -1).copy().view(dt)
    img = img.reshape(height, width, ch) if ch > 1 else img.reshape(height, width)
    if encoding == "bgr8":
        img = img[..., ::-1]
    elif encoding == "bgra8":
        img = img[..., [2, 1, 0, 3]]
    return ImageMsg(stamp, frame_id, height, width, encoding, img)


_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"


def decode_compressed_image(buf: bytes) -> ImageMsg:
    """sensor_msgs/msg/CompressedImage: header + format string + bytes.

    Needs PIL, imported here only (the raw Image path does not). Handles PNG/JPEG color images and 16-bit PNG depth, including the
    `compressed_depth_image_transport` framing (12-byte config header —
    format enum + two floats — before the PNG stream). The reference's real
    bags (mezzanine, README.md:101-142) ship these encodings."""
    import io

    from PIL import Image as PILImage

    r = CdrReader(buf)
    stamp, frame_id = r.header()
    fmt = r.string()  # e.g. "rgb8; jpeg compressed bgr8", "16UC1; compressedDepth png"
    raw = r.bytes_seq()
    payload = raw
    if not raw.startswith(_PNG_MAGIC) and raw[:2] != b"\xff\xd8":  # not PNG/JPEG
        if raw[12 : 12 + len(_PNG_MAGIC)].startswith(_PNG_MAGIC):
            payload = raw[12:]  # compressedDepth config header
        else:
            raise ValueError(f"unrecognized compressed payload (format '{fmt}')")
    img = np.asarray(PILImage.open(io.BytesIO(payload)))
    source_enc = fmt.split(";")[0].strip() or "rgb8"
    if img.ndim == 3 and "bgr" in fmt.split(";")[-1]:
        img = img[..., :3][..., ::-1]
    encoding = source_enc if source_enc in _ENCODINGS else (
        "16UC1" if img.dtype == np.uint16 and img.ndim == 2
        else "mono8" if img.ndim == 2
        else "rgb8"
    )
    return ImageMsg(stamp, frame_id, img.shape[0], img.shape[1], encoding, img)


@dataclasses.dataclass
class CameraInfoMsg:
    stamp_ns: int
    height: int
    width: int
    K: np.ndarray  # [3, 3]


def decode_camera_info(buf: bytes) -> CameraInfoMsg:
    r = CdrReader(buf)
    stamp, _ = r.header()
    height, width = r.u32(), r.u32()
    _ = r.string()  # distortion_model
    _ = r.f64_seq()  # d
    K = r.f64_array(9).reshape(3, 3)
    return CameraInfoMsg(stamp, height, width, K)


@dataclasses.dataclass
class PoseMsg:
    stamp_ns: int
    t: np.ndarray  # [3]
    q_wxyz: np.ndarray  # [4]


def decode_pose_stamped(buf: bytes) -> PoseMsg:
    r = CdrReader(buf)
    stamp, _ = r.header()
    t = r.point()
    q = r.quaternion_wxyz()
    return PoseMsg(stamp, t, q)


def decode_odometry(buf: bytes) -> PoseMsg:
    r = CdrReader(buf)
    stamp, _ = r.header()
    _ = r.string()  # child_frame_id
    t = r.point()
    q = r.quaternion_wxyz()
    return PoseMsg(stamp, t, q)


def decode_tf_message(buf: bytes) -> List[Tuple[str, str, PoseMsg]]:
    r = CdrReader(buf)
    n = r.u32()
    out = []
    for _ in range(n):
        stamp, frame_id = r.header()
        child = r.string()
        t = r.point()
        q = r.quaternion_wxyz()
        out.append((frame_id, child, PoseMsg(stamp, t, q)))
    return out


# ----------------------------------------------------------------------------
# bag access
# ----------------------------------------------------------------------------


class Rosbag2Reader:
    """Reads messages from a rosbag2 directory (one or more .db3 files)."""

    def __init__(self, path: str):
        if os.path.isdir(path):
            self.db_files = sorted(glob.glob(os.path.join(path, "*.db3")))
        else:
            self.db_files = [path]
        if not self.db_files:
            raise FileNotFoundError(f"no .db3 files under '{path}'")
        self.topics: Dict[str, Tuple[int, str]] = {}  # name -> (per-db id ok: resolved per file)

    def topic_types(self) -> Dict[str, str]:
        out = {}
        for db in self.db_files:
            con = sqlite3.connect(db)
            for _, name, typ in con.execute("SELECT id, name, type FROM topics"):
                out[name] = typ
            con.close()
        return out

    def messages(self, topic: str) -> Iterator[Tuple[int, bytes]]:
        """Yields (bag_timestamp_ns, raw CDR payload) in time order."""
        for db in self.db_files:
            con = sqlite3.connect(db)
            row = con.execute("SELECT id FROM topics WHERE name=?", (topic,)).fetchone()
            if row is None:
                con.close()
                continue
            for ts, data in con.execute(
                "SELECT timestamp, data FROM messages WHERE topic_id=? ORDER BY timestamp",
                (row[0],),
            ):
                yield ts, data
            con.close()


# ----------------------------------------------------------------------------
# dataset adapter
# ----------------------------------------------------------------------------


@dataclasses.dataclass
class Rosbag2DatasetConfig:
    path: str = ""
    depth_topic: str = "/depth/image_raw"
    color_topic: str = "/color/image_raw"
    label_topic: str = ""  # optional semantic label image
    pose_topic: str = "/odom"  # Odometry or PoseStamped
    camera_info_topic: str = ""  # else intrinsics must be passed explicitly
    depth_scale: float = 0.001  # m per unit for integer depth (mm default)
    sync_tolerance_s: float = 0.05
    max_range: float = 5.0
    max_frames: int = 0  # 0 = all
    # color-coded label images (the reference's simulators publish semantic
    # labels as RGB): palette row i maps to label_palette_ids[i]; empty = the
    # label topic already carries integer ids
    label_palette: tuple = ()  # ((r,g,b), ...) uint8
    label_palette_ids: tuple = ()
    label_palette_nearest: bool = True  # tolerate compression artifacts


class Rosbag2Dataset(Dataset):
    """FrameData straight from a rosbag2 directory (no ROS installation).
    Images land on `device` (CUDA unless the caller passes device="cpu")."""

    def __init__(self, config: Rosbag2DatasetConfig, camera: Optional[Camera] = None, device=None):
        self.config = config
        self.device = resolve_device(device)
        self.reader = Rosbag2Reader(config.path)
        types = self.reader.topic_types()
        self._pose_decoder = (
            decode_odometry if "Odometry" in types.get(config.pose_topic, "Odometry")
            else decode_pose_stamped
        )

        # per-topic image decoder: raw Image vs CompressedImage by type
        def image_decoder(topic: str):
            if "CompressedImage" in types.get(topic, ""):
                return decode_compressed_image
            return decode_image

        self._decode_depth = image_decoder(config.depth_topic)
        self._decode_color = image_decoder(config.color_topic)
        self._decode_label = image_decoder(config.label_topic) if config.label_topic else decode_image
        self._label_map = None
        if len(config.label_palette):
            from khronos_tpu_torch.eval.ground_truth import ColorLabelMap

            self._label_map = ColorLabelMap(
                np.asarray(config.label_palette, np.uint8),
                list(config.label_palette_ids),
                nearest=config.label_palette_nearest,
            )
        # poses, sorted
        self.poses: List[PoseMsg] = [
            self._pose_decoder(raw) for _, raw in self.reader.messages(config.pose_topic)
        ]
        self.poses.sort(key=lambda p: p.stamp_ns)
        if not self.poses:
            raise ValueError(f"no poses on '{config.pose_topic}'")
        # camera
        self.camera = camera
        if self.camera is None:
            if not config.camera_info_topic:
                raise ValueError("pass a Camera or set camera_info_topic")
            _, raw = next(iter(self.reader.messages(config.camera_info_topic)))
            info = decode_camera_info(raw)
            self.camera = Camera(
                height=info.height, width=info.width,
                fx=float(info.K[0, 0]), fy=float(info.K[1, 1]),
                cx=float(info.K[0, 2]), cy=float(info.K[1, 2]),
                max_range=config.max_range,
            )
        # index color/label stamps for sync
        self._color = [(ts, raw) for ts, raw in self.reader.messages(config.color_topic)]
        self._labels = (
            [(ts, raw) for ts, raw in self.reader.messages(config.label_topic)]
            if config.label_topic
            else []
        )
        self._depth_count = sum(1 for _ in self.reader.messages(config.depth_topic))
        if config.max_frames:
            self._depth_count = min(self._depth_count, config.max_frames)

    def __len__(self) -> int:
        return self._depth_count

    def _pose_at(self, stamp_ns: int) -> Tuple[np.ndarray, np.ndarray]:
        stamps = np.asarray([p.stamp_ns for p in self.poses], np.int64)
        i = int(np.clip(np.searchsorted(stamps, stamp_ns), 1, len(stamps) - 1))
        a, b = self.poses[i - 1], self.poses[i]
        if b.stamp_ns == a.stamp_ns:
            w = 0.0
        else:
            w = (stamp_ns - a.stamp_ns) / (b.stamp_ns - a.stamp_ns)
            w = float(np.clip(w, 0.0, 1.0))
        t = (1 - w) * a.t + w * b.t
        q = a.q_wxyz if w < 0.5 else b.q_wxyz  # nearest (slerp unnecessary at bag rates)
        return host_rotation(q), t.astype(np.float32)

    @staticmethod
    def _nearest(stamp_ns: int, items, tol_ns: int):
        if not items:
            return None
        stamps = np.asarray([s for s, _ in items], np.int64)
        i = int(np.clip(np.searchsorted(stamps, stamp_ns), 0, len(items) - 1))
        best = i
        if i > 0 and abs(stamps[i - 1] - stamp_ns) < abs(stamps[i] - stamp_ns):
            best = i - 1
        if abs(int(stamps[best]) - stamp_ns) > tol_ns:
            return None
        return items[best][1]

    def __iter__(self):
        cfg = self.config
        tol_ns = int(cfg.sync_tolerance_s * 1e9)
        n = 0
        for _, raw in self.reader.messages(cfg.depth_topic):
            depth_msg = self._decode_depth(raw)
            stamp = depth_msg.stamp_ns
            depth = depth_msg.data.astype(np.float32)
            if depth_msg.encoding in ("16UC1", "mono16"):
                depth = depth * cfg.depth_scale
            craw = self._nearest(stamp, self._color, tol_ns)
            if craw is not None:
                color = self._decode_color(craw).data.astype(np.float32)[..., :3] / 255.0
            else:
                color = np.zeros(depth.shape + (3,), np.float32)
            lraw = self._nearest(stamp, self._labels, tol_ns)
            if lraw is not None:
                lab_img = self._decode_label(lraw).data
                if lab_img.ndim == 3 and self._label_map is not None:
                    labels = self._label_map(lab_img[..., :3]).reshape(
                        lab_img.shape[:2]
                    ).astype(np.int32)
                elif lab_img.ndim == 3:
                    raise ValueError(
                        "color-coded label image needs label_palette(+ids) in config"
                    )
                else:
                    labels = lab_img.astype(np.int32)
            else:
                labels = np.full(depth.shape, -1, np.int32)
            R, t = self._pose_at(stamp)
            dev = self.device
            yield (
                FrameData(
                    stamp_ns=stamp,
                    depth=torch.from_numpy(np.ascontiguousarray(depth)).to(dev),
                    color=torch.from_numpy(np.ascontiguousarray(color)).to(dev),
                    labels=torch.from_numpy(np.ascontiguousarray(labels)).to(dev),
                    R_w_c=R,
                    t_w_c=t,
                ),
                None,
            )
            n += 1
            if cfg.max_frames and n >= cfg.max_frames:
                return
