"""Port parity: data/rosbag2.py and the directory and TUM datasets.

Bags are written with the reference test's CDR + sqlite3 writer
(tests/test_rosbag2.py) and read by both packages: raw and compressed images
(PNG depth with and without the compressedDepth header, JPEG colour, PNG
palette labels), Odometry, PoseStamped and TF messages, camera info. The
frames must be the same bit for bit, the camera the same, and the poses
within 1 ulp (each package turns the quaternion into a float32 rotation with
its own quat_to_rot). DirectoryDataset and TumRGBDDataset read directories
the tests write, with the same checks. Then the port's side alone: a bag
frame through its active window, the device rule, and configs/jackal_real.yaml
through the port's CLI on a bag of a few frames (no loop closure expected).
The jackal config end to end at the reference test's scale, in both
packages, is marked slow as the reference's own test is."""

import json
import os
import pathlib

import numpy as np
import pytest
import torch

from khronos_tpu.data import datasets as jds
from khronos_tpu.data import rosbag2 as jrb
from khronos_tpu_torch.data import datasets as tds
from khronos_tpu_torch.data import rosbag2 as trb

import torch_parity  # noqa: F401  (one PyTorch thread per test worker)
from test_rosbag2 import (
    LABEL_PALETTE,
    CdrWriter,
    encode_camera_info,
    encode_compressed_image,
    encode_image,
    encode_odometry,
    jpeg_bytes,
    png_bytes,
    rot_to_quat_wxyz,
    write_bag,
)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def encode_pose_stamped(stamp_ns, t, q_wxyz):
    w = CdrWriter()
    w.header(stamp_ns)
    for v in t:
        w.f64(v)
    qw, qx, qy, qz = q_wxyz
    for v in (qx, qy, qz, qw):
        w.f64(v)
    return w.done()


def encode_tf(transforms):
    w = CdrWriter()
    w.u32(len(transforms))
    for stamp_ns, parent, child, t, q_wxyz in transforms:
        w.header(stamp_ns, parent)
        w.string(child)
        for v in t:
            w.f64(v)
        qw, qx, qy, qz = q_wxyz
        for v in (qx, qy, qz, qw):
            w.f64(v)
    return w.done()


def _rotation(rng):
    q = rng.normal(size=4)
    return q / np.linalg.norm(q)


def _assert_frames_match(jframes, tframes):
    assert len(jframes) == len(tframes) > 0
    for (jf, jgt), (tf, tgt) in zip(jframes, tframes):
        assert jf.stamp_ns == tf.stamp_ns and jgt is None and tgt is None
        for name in ("depth", "color", "labels", "instances"):
            a, b = getattr(jf, name), getattr(tf, name)
            assert (a is None) == (b is None), name
            if a is not None:
                assert b.device.type == "cpu"
                np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)
        if jf.label_features is not None or tf.label_features is not None:
            np.testing.assert_array_equal(tf.label_features, jf.label_features)
        for name in ("R_w_c", "t_w_c"):
            a, b = np.asarray(getattr(jf, name), np.float32), getattr(tf, name)
            assert isinstance(b, np.ndarray) and b.dtype == np.float32
            np.testing.assert_array_max_ulp(b, a, maxulp=1)


def _assert_cameras_match(jc, tc):
    for f in ("height", "width", "fx", "fy", "cx", "cy", "min_range", "max_range"):
        assert getattr(jc, f) == getattr(tc, f), f


@pytest.fixture()
def raw_bag(tmp_path):
    """Raw images, Odometry poses between the frames, camera info."""
    H, W = 24, 32
    rng = np.random.default_rng(0)
    topics = {"/depth": "sensor_msgs/msg/Image", "/color": "sensor_msgs/msg/Image",
              "/labels": "sensor_msgs/msg/Image", "/odom": "nav_msgs/msg/Odometry",
              "/camera_info": "sensor_msgs/msg/CameraInfo"}
    msgs = []
    for k in range(4):
        ts = int(1e9 + k * 1e8)
        depth = rng.integers(300, 6000, (H, W)).astype(np.uint16)
        color = rng.integers(0, 255, (H, W, 3), dtype=np.uint8)
        labels = rng.integers(0, 7, (H, W)).astype(np.int16)
        msgs.append(("/depth", ts, encode_image(ts, depth, "16UC1")))
        msgs.append(("/color", ts + 1000, encode_image(ts + 1000, color[..., ::-1].copy(), "bgr8")))
        msgs.append(("/labels", ts - 1000, encode_image(ts - 1000, labels, "16SC1")))
    for k in range(6):
        ts = int(0.93e9 + k * 1e8)
        msgs.append(("/odom", ts, encode_odometry(ts, rng.uniform(-3, 3, 3), _rotation(rng))))
    msgs.append(("/camera_info", int(1e9), encode_camera_info(int(1e9), H, W, 20.5, 19.5, 16.25, 12.0)))
    write_bag(str(tmp_path / "bag_0.db3"), topics, msgs)
    return str(tmp_path)


def test_raw_bag_reads_the_same(raw_bag):
    jr, tr = jrb.Rosbag2Reader(raw_bag), trb.Rosbag2Reader(raw_bag)
    assert tr.topic_types() == jr.topic_types()
    for topic, decode in (("/depth", "decode_image"), ("/color", "decode_image"), ("/labels", "decode_image"),
                          ("/odom", "decode_odometry"), ("/camera_info", "decode_camera_info")):
        jm, tm = list(jr.messages(topic)), list(tr.messages(topic))
        assert [ts for ts, _ in tm] == [ts for ts, _ in jm]
        for (_, a), (_, b) in zip(jm, tm):
            x, y = getattr(jrb, decode)(a), getattr(trb, decode)(b)
            for field, v in vars(x).items():
                w = getattr(y, field)
                if isinstance(v, np.ndarray):
                    np.testing.assert_array_equal(w, v, err_msg=field)
                else:
                    assert w == v, field
    cfg = dict(path=raw_bag, depth_topic="/depth", color_topic="/color", label_topic="/labels",
               pose_topic="/odom", camera_info_topic="/camera_info", depth_scale=0.001)
    jd = jrb.Rosbag2Dataset(jrb.Rosbag2DatasetConfig(**cfg))
    td = trb.Rosbag2Dataset(trb.Rosbag2DatasetConfig(**cfg), device="cpu")
    assert len(td) == len(jd) == 4
    _assert_cameras_match(jd.camera, td.camera)
    _assert_frames_match(list(jd), list(td))


def test_compressed_images_decode_the_same():
    """The reference test's compressed cases: PNG depth with the
    compressedDepth header and without, JPEG bgr colour, PNG palette labels."""
    depth = (np.arange(24 * 32, dtype=np.uint16) % 3000).reshape(24, 32)
    rgb = np.zeros((16, 16, 3), np.uint8)
    rgb[:, :8] = [200, 30, 40]
    labels_rgb = LABEL_PALETTE[np.arange(16 * 16) % 7].reshape(16, 16, 3)
    for payload, fmt in ((b"\x00" * 12 + png_bytes(depth), "16UC1; compressedDepth png"),
                         (png_bytes(depth), "16UC1; png"),
                         (jpeg_bytes(rgb[..., ::-1].copy()), "rgb8; jpeg compressed bgr8"),
                         (png_bytes(labels_rgb), "rgb8; png")):
        buf = encode_compressed_image(7, payload, fmt)
        a, b = jrb.decode_compressed_image(buf), trb.decode_compressed_image(buf)
        assert (b.encoding, b.height, b.width, b.stamp_ns) == (a.encoding, a.height, a.width, a.stamp_ns)
        np.testing.assert_array_equal(b.data, a.data)
    with pytest.raises(ValueError):
        trb.decode_compressed_image(encode_compressed_image(7, b"not an image", "rgb8; png"))


def test_compressed_bag_with_palette_labels_reads_the_same(tmp_path):
    H, W = 16, 24
    label_ids = np.arange(H * W).reshape(H, W) % 7
    rng = np.random.default_rng(2)
    topics = {"/depth/compressed": "sensor_msgs/msg/CompressedImage",
              "/color/compressed": "sensor_msgs/msg/CompressedImage",
              "/labels/compressed": "sensor_msgs/msg/CompressedImage",
              "/odom": "nav_msgs/msg/Odometry", "/camera_info": "sensor_msgs/msg/CameraInfo"}
    msgs = []
    for k in range(3):
        ts = int(1e9 + k * 2e8)
        depth = rng.integers(500, 4000, (H, W)).astype(np.uint16)
        color = rng.integers(0, 255, (H, W, 3), dtype=np.uint8)
        msgs += [("/depth/compressed", ts, encode_compressed_image(ts, b"\x00" * 12 + png_bytes(depth),
                                                                   "16UC1; compressedDepth png")),
                 ("/color/compressed", ts, encode_compressed_image(ts, jpeg_bytes(color[..., ::-1].copy()),
                                                                   "rgb8; jpeg compressed bgr8")),
                 ("/labels/compressed", ts, encode_compressed_image(ts, png_bytes(LABEL_PALETTE[label_ids]),
                                                                    "rgb8; png")),
                 ("/odom", ts - int(1e8), encode_odometry(ts - int(1e8), rng.uniform(-1, 1, 3), _rotation(rng)))]
    msgs.append(("/camera_info", int(1e9), encode_camera_info(int(1e9), H, W, 20.0, 20.0, W / 2, H / 2)))
    write_bag(str(tmp_path / "bag_0.db3"), topics, msgs)
    cfg = dict(path=str(tmp_path), depth_topic="/depth/compressed", color_topic="/color/compressed",
               label_topic="/labels/compressed", pose_topic="/odom", camera_info_topic="/camera_info",
               label_palette=tuple(map(tuple, LABEL_PALETTE)), label_palette_ids=tuple(range(7)))
    jd = list(jrb.Rosbag2Dataset(jrb.Rosbag2DatasetConfig(**cfg)))
    td = list(trb.Rosbag2Dataset(trb.Rosbag2DatasetConfig(**cfg), device="cpu"))
    _assert_frames_match(jd, td)
    np.testing.assert_array_equal(td[0][0].labels.numpy(), label_ids)


def test_pose_stamped_and_tf_read_the_same(tmp_path):
    """A PoseStamped pose topic (the decoder chosen by the topic's type) and a
    TF message with two transforms."""
    H, W = 8, 12
    rng = np.random.default_rng(3)
    topics = {"/depth": "sensor_msgs/msg/Image", "/pose": "geometry_msgs/msg/PoseStamped",
              "/tf": "tf2_msgs/msg/TFMessage"}
    msgs = []
    for k in range(3):
        ts = int(2e9 + k * 1e8)
        msgs.append(("/depth", ts, encode_image(ts, rng.random((H, W)).astype(np.float32) * 4, "32FC1")))
        msgs.append(("/pose", ts + 30_000_000, encode_pose_stamped(ts + 30_000_000, rng.uniform(-2, 2, 3),
                                                                    _rotation(rng))))
    tf_msg = encode_tf([(int(2e9), "map", "odom", rng.uniform(-1, 1, 3), _rotation(rng)),
                        (int(2e9) + 5, "odom", "base", rng.uniform(-1, 1, 3), _rotation(rng))])
    msgs.append(("/tf", int(2e9), tf_msg))
    write_bag(str(tmp_path / "bag_0.db3"), topics, msgs)
    from khronos_tpu.geometry.camera import Camera as JCamera
    from khronos_tpu_torch.geometry.camera import Camera as TCamera

    cfg = dict(path=str(tmp_path), depth_topic="/depth", color_topic="/none", pose_topic="/pose")
    jd = list(jrb.Rosbag2Dataset(jrb.Rosbag2DatasetConfig(**cfg), JCamera(H, W, 10.0, 10.0, 6.0, 4.0)))
    td = list(trb.Rosbag2Dataset(trb.Rosbag2DatasetConfig(**cfg), TCamera(H, W, 10.0, 10.0, 6.0, 4.0), device="cpu"))
    _assert_frames_match(jd, td)
    a, b = jrb.decode_tf_message(tf_msg), trb.decode_tf_message(tf_msg)
    assert [(p, c) for p, c, _ in b] == [(p, c) for p, c, _ in a] == [("map", "odom"), ("odom", "base")]
    for (_, _, x), (_, _, y) in zip(a, b):
        assert x.stamp_ns == y.stamp_ns
        np.testing.assert_array_equal(y.t, x.t)
        np.testing.assert_array_equal(y.q_wxyz, x.q_wxyz)


def _write_directory(root, rng, depth_dtype):
    H, W = 12, 16
    os.makedirs(os.path.join(root, "frames"))
    with open(os.path.join(root, "intrinsics.json"), "w") as fh:
        json.dump({"height": H, "width": W, "fx": 11.5, "fy": 12.0, "cx": 8.0, "cy": 6.25,
                   "depth_scale": 0.001 if depth_dtype == np.uint16 else 1.0, "max_range": 4.0}, fh)
    rows = []
    for k in range(3):
        stamp = 1_000_000_000 + k * 100_000_000
        depth = rng.integers(200, 5000, (H, W)).astype(depth_dtype) if depth_dtype == np.uint16 else \
            rng.random((H, W)).astype(np.float32) * 5
        arrays = {"depth": depth, "color": rng.integers(0, 255, (H, W, 3)).astype(np.uint8)}
        if k != 1:
            arrays["labels"] = rng.integers(-1, 7, (H, W)).astype(np.int16)
            arrays["instances"] = rng.integers(0, 4, (H, W)).astype(np.int32)
            arrays["features"] = rng.normal(size=(4, 8)).astype(np.float32)
        np.savez(os.path.join(root, "frames", f"{stamp}.npz"), **arrays)
        q = _rotation(rng)
        t = rng.uniform(-3, 3, 3)
        rows.append(",".join(str(v) for v in (stamp, *t, *q)))
    with open(os.path.join(root, "poses.csv"), "w") as fh:
        fh.write("stamp_ns,tx,ty,tz,qw,qx,qy,qz\n" + "\n".join(rows) + "\n")


@pytest.mark.parametrize("depth_dtype", [np.uint16, np.float32])
def test_directory_dataset_reads_the_same(tmp_path, depth_dtype):
    _write_directory(str(tmp_path), np.random.default_rng(4), depth_dtype)
    jd, td = jds.DirectoryDataset(str(tmp_path)), tds.DirectoryDataset(str(tmp_path), device="cpu")
    assert len(td) == len(jd) == 3
    _assert_cameras_match(jd.camera, td.camera)
    _assert_frames_match(list(jd), list(td))
    assert isinstance(tds.make_dataset("directory", device="cpu", root=str(tmp_path)), tds.DirectoryDataset)


def test_tum_dataset_reads_the_same(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(5)
    H, W = 12, 16
    for d in ("depth", "rgb"):
        os.makedirs(tmp_path / d)
    stamps = [1305031102.175304, 1305031102.211214, 1305031102.243211]
    for k, s in enumerate(stamps):
        Image.fromarray(rng.integers(0, 30000, (H, W)).astype(np.uint16), mode="I;16").save(
            tmp_path / "depth" / f"{s:.6f}.png")
        Image.fromarray(rng.integers(0, 255, (H, W, 3)).astype(np.uint8)).save(tmp_path / "rgb" / f"{s + 0.01:.6f}.png")
    with open(tmp_path / "groundtruth.txt", "w") as fh:
        fh.write("# timestamp tx ty tz qx qy qz qw\n")
        for k in range(5):
            q = _rotation(rng)
            fh.write(" ".join(str(v) for v in (stamps[0] - 0.02 + 0.03 * k, *rng.uniform(-2, 2, 3), *q[1:], q[0])) + "\n")
    from khronos_tpu.geometry.camera import Camera as JCamera
    from khronos_tpu_torch.geometry.camera import Camera as TCamera

    jd = jds.TumRGBDDataset(str(tmp_path), JCamera(H, W, 10.0, 10.0, 8.0, 6.0), max_frames=2)
    td = tds.TumRGBDDataset(str(tmp_path), TCamera(H, W, 10.0, 10.0, 8.0, 6.0), max_frames=2, device="cpu")
    assert len(td) == len(jd) == 2
    _assert_frames_match(list(jd), list(td))
    default = tds.make_dataset("tum", device="cpu", root=str(tmp_path))
    _assert_cameras_match(jds.TumRGBDDataset(str(tmp_path)).camera, default.camera)


def test_bag_frame_feeds_the_active_window(raw_bag):
    """The reference test's case on the port: bag frames through the port's
    ActiveWindow integrate into the volume."""
    from khronos_tpu_torch.active_window.active_window import ActiveWindow, ActiveWindowConfig
    from khronos_tpu_torch.config import build
    from khronos_tpu_torch.pipeline.pipeline import LabelSpaceConfig

    ds = trb.Rosbag2Dataset(trb.Rosbag2DatasetConfig(path=raw_bag, depth_topic="/depth", color_topic="/color",
                                                     pose_topic="/odom", camera_info_topic="/camera_info"),
                            device="cpu")
    cfg = build(ActiveWindowConfig, {"volumetric_map": {"grid_shape": [32, 32, 16]}})
    aw = ActiveWindow(cfg, ds.camera, LabelSpaceConfig(num_classes=3, object_labels=[2]).create(), device="cpu")
    for frame, _ in ds:
        aw.spin_once(frame)
    assert float(aw.state.weight.sum()) > 0


def test_real_data_entry_points_need_a_gpu_unless_told_cpu(raw_bag, tmp_path, monkeypatch):
    from khronos_tpu_torch.backend import loop_closure as tlc

    _write_directory(str(tmp_path / "dir"), np.random.default_rng(6), np.uint16)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = trb.Rosbag2DatasetConfig(path=raw_bag, depth_topic="/depth", camera_info_topic="/camera_info")
    for make in (lambda d: trb.Rosbag2Dataset(cfg, device=d),
                 lambda d: tds.DirectoryDataset(str(tmp_path / "dir"), device=d),
                 lambda d: tds.make_dataset("rosbag2", device=d, path=raw_bag, camera_info_topic="/camera_info"),
                 lambda d: tlc.DescriptorLoopClosureConfig().create(device=d),
                 lambda d: tlc.AppearanceLoopClosureConfig().create(device=d),
                 lambda d: tlc.HybridLoopClosureConfig().create(device=d)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make(None)
        make("cpu")


def _jackal_bag(path, n_frames, H, W, compressed):
    """The reference test's jackal bag: the JAX renderer's office with sensor
    noise and drifted odometry (two orbits), every frame into a bag."""
    from khronos_tpu.data import synthetic as jsyn

    duration, fps = n_frames / 3.0, 3.0
    seq = jsyn.SyntheticSequence(jsyn.office_scene(duration=duration), jsyn.SyntheticSequenceConfig(
        duration=duration, fps=fps, height=H, width=W, fx=W * 0.625, fy=W * 0.625, cx=W / 2, cy=H / 2,
        n_loops=2.0, drift_rate=0.02, noise=jsyn.SensorNoiseConfig()))
    kind = "CompressedImage" if compressed else "Image"
    topics = {"/depth": f"sensor_msgs/msg/{kind}", "/color": f"sensor_msgs/msg/{kind}",
              "/labels": f"sensor_msgs/msg/{kind}", "/odom": "nav_msgs/msg/Odometry",
              "/camera_info": "sensor_msgs/msg/CameraInfo"}
    msgs, truth = [], {"stamps_ns": [], "gt": [], "odom": []}
    for i in range(seq.n_frames):
        f = seq.render_frame(i)
        ts = int(f["stamp_ns"])
        depth_mm = (np.asarray(f["depth"]) * 1000).astype(np.uint16)
        color = (np.clip(np.asarray(f["color"]), 0, 1) * 255).astype(np.uint8)
        labels = LABEL_PALETTE[np.clip(np.asarray(f["labels"]), 0, 6)]
        if compressed:
            msgs += [("/depth", ts, encode_compressed_image(ts, b"\x00" * 12 + png_bytes(depth_mm),
                                                            "16UC1; compressedDepth png")),
                     ("/color", ts, encode_compressed_image(ts, jpeg_bytes(color[..., ::-1].copy()),
                                                            "rgb8; jpeg compressed bgr8")),
                     ("/labels", ts, encode_compressed_image(ts, png_bytes(labels), "rgb8; png"))]
        else:
            msgs += [("/depth", ts, encode_image(ts, depth_mm, "16UC1")), ("/color", ts, encode_image(ts, color, "rgb8")),
                     ("/labels", ts, encode_image(ts, labels, "rgb8"))]
        Ro, to = seq.odometry_pose(i)
        msgs.append(("/odom", ts, encode_odometry(ts, [float(v) for v in np.asarray(to)],
                                                  rot_to_quat_wxyz(np.asarray(Ro, np.float64)))))
        truth["stamps_ns"].append(ts)
        truth["gt"].append(np.asarray(f["t_gt"], np.float64))
        truth["odom"].append(np.asarray(to, np.float64))
    cam = seq.camera
    ts0 = truth["stamps_ns"][0]
    msgs.append(("/camera_info", ts0, encode_camera_info(ts0, cam.height, cam.width, cam.fx, cam.fy, cam.cx, cam.cy)))
    write_bag(str(path / "bag_0.db3"), topics, msgs)
    return {k: np.asarray(v) for k, v in truth.items()}


def _jackal_overrides(bag, out, grid):
    import chip_smoke

    return [*chip_smoke.JACKAL_OVERRIDES, f"pipeline.active_window.volumetric_map.grid_shape={grid}",
            f"dataset.path={bag}", f"run.output_dir={out}"]


def _run_and_capture(run_module, pipeline_cls, argv):
    state = {}
    original = pipeline_cls.process_frame

    def process_frame(self, *args, **kwargs):
        state["pipeline"] = self
        return original(self, *args, **kwargs)

    pipeline_cls.process_frame = process_frame
    try:
        run_module.main(argv)
    finally:
        pipeline_cls.process_frame = original
    return state["pipeline"]


def test_jackal_config_runs_through_the_port_cli_on_a_short_bag(tmp_path):
    """configs/jackal_real.yaml through the port's CLI with --device cpu on a
    bag of 6 frames (48x64, raw images): it finishes cleanly on every frame
    with no loop closure (the run is shorter than the detector's gap)."""
    import sys

    sys.path.insert(0, str(ROOT))
    from khronos_tpu_torch import run as trun
    from khronos_tpu_torch.pipeline.pipeline import KhronosPipeline
    from khronos_tpu_torch.utils.logging import FINISHED_CLEANLY, ExperimentLogger

    bag = tmp_path / "bag"
    bag.mkdir()
    _jackal_bag(bag, 6, 48, 64, compressed=False)
    out = tmp_path / "run"
    pipe = _run_and_capture(trun, KhronosPipeline,
                            ["--device", "cpu", "--config", str(ROOT / "configs" / "jackal_real.yaml"),
                             *_jackal_overrides(bag, out, "[48,48,32]")])
    assert ExperimentLogger.has_flag(str(out), FINISHED_CLEANLY)
    assert pipe.frame_count == 6
    assert type(pipe.backend.lcd).__name__ == "DescriptorLoopClosureDetector"
    assert pipe.backend.loop_closures == []
    for f in ("dsg.npz", "final.4dmap.npz", "viewer.html"):
        assert (out / f).exists(), f


@pytest.mark.slow
def test_jackal_config_end_to_end_in_both_packages(tmp_path):
    """tests/test_rosbag2.py's jackal case at its scale (72 frames of 60x80,
    a 128x128x32 grid, a noisy compressed bag from the JAX renderer), through
    both packages' CLIs (the port with --device cpu): the same loop-closure
    pairs, and each package's optimised ATE below the odometry's."""
    import sys

    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from khronos_tpu import run as jrun
    from khronos_tpu.pipeline.pipeline import KhronosPipeline as JPipeline
    from khronos_tpu_torch import run as trun
    from khronos_tpu_torch.pipeline.pipeline import KhronosPipeline as TPipeline

    bag = tmp_path / "bag"
    bag.mkdir()
    truth = _jackal_bag(bag, 72, 60, 80, compressed=True)
    config = str(ROOT / "configs" / "jackal_real.yaml")
    results = {}
    for name, run_module, cls, argv in (("jax", jrun, JPipeline, []), ("torch", trun, TPipeline, ["--device", "cpu"])):
        out = tmp_path / name
        pipe = _run_and_capture(run_module, cls, [*argv, "--config", config,
                                                  *_jackal_overrides(bag, out, "[128,128,32]")])
        dsg = np.load(out / "dsg.npz")
        results[name] = ([(c.from_key, c.to_key) for c in pipe.backend.loop_closures],
                         chip_smoke.trajectory_ates(dsg["agents/stamps_ns"], dsg["agents/t"], truth))
    (jpairs, jate), (tpairs, tate) = results["jax"], results["torch"]
    assert len(jpairs) >= 1 and tpairs == jpairs, results
    assert jate["odometry"] > 0.01
    assert jate["optimised"] < jate["odometry"] and tate["optimised"] < tate["odometry"], results
