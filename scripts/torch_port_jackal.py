#!/usr/bin/env python3
"""configs/jackal_real.yaml on a rosbag2, through either package: the
yardstick of chip_smoke.py's jackal_path.

    # the bag chip_smoke.py writes on the card, written here with the port on the CPU
    python scripts/torch_port_jackal.py write /tmp/jackal_bag
    # the JAX package (the reference) or the port on it, as chip_smoke.py runs it
    python scripts/torch_port_jackal.py run jax /tmp/jackal_bag /tmp/jackal_jax
    python scripts/torch_port_jackal.py run torch /tmp/jackal_bag /tmp/jackal_torch --device cpu
    # each loop closure of a run against the ground truth and the odometry
    python scripts/torch_port_jackal.py accuracy /tmp/jackal_bag /tmp/jackal_torch

`run` calls the package's `run.main` with chip_smoke.py's JACKAL_OVERRIDES
(tests/test_rosbag2.py's, with the config's own grid) and prints one JSON
line: frames, the loop closures (from_key, to_key), the solves, the ATE of
the optimised trajectory and of the odometry against the ground truth, and
the run's seconds; it also writes that line to <out>/jackal_result.json.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (the bag writer and the overrides)


def write(bag: str, device: str) -> None:
    truth = chip_smoke.write_jackal_bag(bag, device)
    np.savez(os.path.join(bag, "truth.npz"), **truth)
    print(f"{len(truth['stamps_ns'])} frames -> {bag}")


def run(package: str, bag: str, out: str, device: str) -> dict:
    if package == "jax":
        from khronos_tpu import run as prun
        from khronos_tpu.pipeline.pipeline import KhronosPipeline

        argv = []
    else:
        from khronos_tpu_torch import run as prun
        from khronos_tpu_torch.pipeline.pipeline import KhronosPipeline

        argv = ["--device", device]
    state = {}
    original = KhronosPipeline.process_frame

    def process_frame(self, *args, **kwargs):
        state["pipeline"] = self
        return original(self, *args, **kwargs)

    KhronosPipeline.process_frame = process_frame
    ts = time.perf_counter()
    try:
        prun.main(argv + ["--config", str(chip_smoke.JACKAL_CONFIG), *chip_smoke.JACKAL_OVERRIDES,
                          f"dataset.path={bag}", f"run.output_dir={out}"])
    finally:
        KhronosPipeline.process_frame = original
    seconds = time.perf_counter() - ts
    pipe = state["pipeline"]
    dsg = np.load(os.path.join(out, "dsg.npz"))
    truth = dict(np.load(os.path.join(bag, "truth.npz")))
    ate = chip_smoke.trajectory_ates(dsg["agents/stamps_ns"], dsg["agents/t"], truth)
    result = {"package": package, "frames": pipe.frame_count,
              "loop_closures": [(int(c.from_key), int(c.to_key)) for c in pipe.backend.loop_closures],
              "num_optimizations": pipe.backend.num_optimizations, "ate": ate, "seconds": seconds}
    with open(os.path.join(out, "jackal_result.json"), "w") as fh:
        json.dump(result, fh)
    print(json.dumps(result))
    return result


def accuracy(bag: str, out: str) -> None:
    """For each loop closure of a run: the odometry's and the registration's
    error (translation m, rotation degrees) against the ground-truth relative
    pose. The registration is the port's robust_icp on the CPU, on the
    payload the pipeline builds (back-projection at stride 4, valid ranges,
    256 evenly spaced points), from the odometry's initial guess."""
    from khronos_tpu_torch.backend.registration import robust_icp
    from khronos_tpu_torch.config import load_mapping
    from khronos_tpu_torch.data import synthetic as syn
    from khronos_tpu_torch.data.rosbag2 import Rosbag2Dataset, Rosbag2DatasetConfig

    result = json.load(open(os.path.join(out, "jackal_result.json")))
    dsg = np.load(os.path.join(out, "dsg.npz"))
    stamp_of = dict(zip(dsg["agents/keys"].tolist(), dsg["agents/stamps_ns"].tolist()))
    spec = load_mapping([], [o for o in chip_smoke.JACKAL_OVERRIDES if o.startswith("dataset.")])["dataset"]
    ds = Rosbag2Dataset(Rosbag2DatasetConfig(path=bag, **spec), device="cpu")
    frames = {f.stamp_ns: f for f, _ in ds}
    seq = syn.SyntheticSequence(syn.office_scene(duration=chip_smoke.JACKAL_SECONDS), syn.SyntheticSequenceConfig(
        duration=chip_smoke.JACKAL_SECONDS, fps=chip_smoke.JACKAL_FPS, n_loops=2.0), device="cpu")
    cam = ds.camera

    def cloud(f):
        depth = f.depth[::4, ::4].numpy()
        pts = cam.back_project(f.depth)[::4, ::4].numpy()[(depth > 0.1) & (depth < cam.max_range)]
        return pts[np.linspace(0, len(pts) - 1, 256).astype(int)]

    def degrees(A, B):
        return float(np.degrees(np.arccos(np.clip((np.trace(A.T @ B) - 1) / 2, -1, 1))))

    for a, b in result["loop_closures"]:
        fa, fb = frames[stamp_of[a]], frames[stamp_of[b]]
        Ra, ta = seq.pose_at(fa.stamp_ns * 1e-9)
        Rb, tb = seq.pose_at(fb.stamp_ns * 1e-9)
        R_gt, t_gt = Ra.T @ Rb, Ra.T @ (tb - ta)
        R0 = (fa.R_w_c.T @ fb.R_w_c).astype(np.float32)
        t0 = (fa.R_w_c.T @ (fb.t_w_c - fa.t_w_c)).astype(np.float32)
        R, t, _, _ = (x.numpy() for x in robust_icp(cloud(fb), cloud(fa), R0, t0, noise_bound=0.07, device="cpu"))
        print(json.dumps({"from_s": fa.stamp_ns * 1e-9, "to_s": fb.stamp_ns * 1e-9,
                          "odometry_err_m": float(np.linalg.norm(t0 - t_gt)), "odometry_err_deg": degrees(R0, R_gt),
                          "registration_err_m": float(np.linalg.norm(t - t_gt)),
                          "registration_err_deg": degrees(R, R_gt)}))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    w = sub.add_parser("write", help="write the jackal bag with the port")
    w.add_argument("bag")
    w.add_argument("--device", default="cpu")
    r = sub.add_parser("run", help="run configs/jackal_real.yaml on the bag")
    r.add_argument("package", choices=("jax", "torch"))
    r.add_argument("bag")
    r.add_argument("out")
    r.add_argument("--device", default=None, help="the port's device (default: cuda)")
    a = sub.add_parser("accuracy", help="each loop closure of a run against the ground truth")
    a.add_argument("bag")
    a.add_argument("out")
    args = ap.parse_args(argv)
    if args.cmd == "write":
        write(args.bag, args.device)
    elif args.cmd == "run":
        run(args.package, args.bag, args.out, args.device)
    else:
        accuracy(args.bag, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
