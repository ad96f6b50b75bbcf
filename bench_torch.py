"""Benchmark of khronos_tpu_torch: active-window frames/s on one card
(tesse_cd_office-like load). The port of bench.py, which benchmarks the JAX
package; the flags, the sequence, the configs and the output are bench.py's.

    python3 bench_torch.py --aw-only          # the active window alone
    python3 bench_torch.py                    # the full pipeline (the default)
    python3 bench_torch.py --device cpu --frames 3 --warmup 2 --height 48 \\
        --width 64 --grid 32 32 16 --repeats 1   # a small run on the CPU

Prints ONE JSON line {"metric", "value", "unit", "vs_baseline"} on stdout;
everything else goes to stderr.

Workload: 480x640 RGB-D + semantics of the synthetic office with walking
humans at voxel 0.1 m (motion detection, object detection, tracking,
TSDF + tracking-layer integration a frame). The baseline is the reference's
25 Hz input cap (uHumans2.yaml:10): vs_baseline = fps / 25. The full
pipeline adds the backend (GtLoopClosure, 8 s / 1 m), change detection
every 50 frames and the incremental places updates, both on a detached
thread fed by process_frame(..., defer_cd=True).

Frames are rendered onto the device before the timed loop, and a warm-up
scroll pair with its forced emission runs the scroll and emission paths
before it. Each of `--repeats` timed runs builds a fresh engine; the timed
window ends once every card the window uses has finished its work, and the
median frames/s is reported. Runs on CUDA unless `--device cpu`; without a
GPU and without `--device cpu` it raises.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import numpy as np


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=100)
    ap.add_argument("--warmup", type=int, default=10)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--grid", type=int, nargs=3, default=[160, 160, 48])
    ap.add_argument("--aw-only", action="store_true",
                    help="bench the active window only (no backend/CD)")
    ap.add_argument("--full-pipeline", action="store_true",
                    help="(default) include backend + change detection cadence")
    ap.add_argument("--det-stride", type=int, default=2,
                    help="detection stride (integration stays full-res)")
    ap.add_argument("--repeats", type=int, default=3,
                    help="timed repetitions (fresh engine each); median reported")
    ap.add_argument("--device", default="cuda", help="torch device (cuda, or cpu)")
    return ap


def aw_config(args) -> dict:
    return {
        "volumetric_map": {"grid_shape": list(args.grid), "voxel_size": 0.1},
        "detection_stride": args.det_stride,
        "motion_detector": {"type": "FreeSpaceMotionDetector", "min_cluster_size": 400},
        "object_detector": {"type": "ConnectedSemantics", "min_cluster_size": 50},
        "tracker": {"type": "MaxIouTracker"},
        "object_extractor": {"type": "MeshObjectExtractor"},
    }


def pipeline_config(args) -> dict:
    return {
        "active_window": aw_config(args),
        "backend": {"lcd": {"type": "GtLoopClosure", "min_time_gap": 8.0, "max_distance": 1.0}},
        "label_space": {
            "num_classes": 7,
            "object_labels": [2, 3, 4, 5, 6],
            "dynamic_labels": [1],
        },
        # reference cadence: every 50 frames + on LC (uHumans2.yaml:7)
        "run_change_detection_every_n_frames": 50,
    }


def warmup_scroll(aw) -> int:
    """Scroll the volume by +1 and then -1 voxel along x, emitting the mesh of
    the cells each scroll drops first (the first camera-driven scroll's
    work, done before the timed run); the triangles those emissions made."""
    from khronos_tpu_torch.map import active_volume as av
    from khronos_tpu_torch.map import meshing

    vol_cfg = aw.config.volumetric_map
    first = len(aw._pending_mesh_dev)
    for shift in (np.array([1, 0, 0], np.int32), np.array([-1, 0, 0], np.int32)):
        out_mask = av.scroll_out_mask(aw.state, shift)
        aw._emit_mesh(meshing.forced_emission_mask(aw.state, out_mask))
        aw.state = av.scroll(vol_cfg, aw.state, shift)
        aw._origin_np = aw._origin_np + shift
    aw.synchronize()
    # each round of the drain has its meta in its own host copy: [0] = triangles
    return sum(int(ent[1].numpy(0)[0]) for ent in aw._pending_mesh_dev[first:])


def run(argv=None) -> dict:
    """bench.py's run: {"line": the JSON line's object, "fps_runs",
    "launches" (kernel launches in each run's timed frames),
    "warmup_triangles" (each run's warm-up scroll pair), "device"}."""
    args = parser().parse_args(argv)
    args.full_pipeline = not args.aw_only

    import torch

    from khronos_tpu_torch import resolve_device
    from khronos_tpu_torch.active_window.active_window import ActiveWindow, ActiveWindowConfig
    from khronos_tpu_torch.active_window.frame_data import FrameData
    from khronos_tpu_torch.config import build
    from khronos_tpu_torch.data import synthetic as syn
    from khronos_tpu_torch.ops import gather, propagate
    from khronos_tpu_torch.utils.timing import TimingRecorder

    device = resolve_device(args.device)
    fps_render = 10.0
    duration = (args.frames + args.warmup) / fps_render + 1
    scene = syn.office_scene(duration=duration)
    seq = syn.SyntheticSequence(
        scene,
        syn.SyntheticSequenceConfig(
            duration=duration,
            fps=fps_render,
            height=args.height,
            width=args.width,
            fx=args.width * 0.625,
            fy=args.width * 0.625,
            cx=args.width / 2,
            cy=args.height / 2,
        ),
        device=device,
    )

    n_total = args.frames + args.warmup
    print(f"rendering {n_total} frames (device-resident) ...", file=sys.stderr)
    device_frames = []
    for i in range(n_total):
        f = seq.render_frame(i)
        if f["depth"].is_cuda:
            torch.cuda.synchronize(f["depth"].device)
        device_frames.append(f)

    def build_engine():
        if args.full_pipeline:
            from khronos_tpu_torch.pipeline.pipeline import KhronosPipeline, PipelineConfig

            pipe = KhronosPipeline(build(PipelineConfig, pipeline_config(args)), seq.camera, device=device)
            return pipe, pipe.active_window
        aw_cfg = build(ActiveWindowConfig, aw_config(args))
        return None, ActiveWindow(aw_cfg, seq.camera, syn.default_label_space(), device=device)

    launches, warmup_triangles = [], []

    def run_once() -> float:
        pipe, aw = build_engine()
        cd_queue = cd_thread = None
        if pipe is not None:
            # detached change detection (the reference's detached thread,
            # backend.cpp:189-216): CD never blocks the frame loop
            import queue
            import threading

            cd_queue = queue.Queue()

            def cd_worker():
                while True:
                    item = cd_queue.get()
                    if item is None:
                        return
                    kind, payload = item
                    if kind == "cd":
                        pipe.run_change_detection_on(*payload)
                    else:  # deferred incremental places update
                        payload()

            cd_thread = threading.Thread(target=cd_worker, daemon=True)
            cd_thread.start()

        def run_frame(f):
            frame = FrameData(
                stamp_ns=f["stamp_ns"],
                depth=f["depth"],
                color=f["color"],
                labels=f["labels"],
                R_w_c=f["R_w_c"],
                t_w_c=f["t_w_c"],
            )
            if pipe is not None:
                req = pipe.process_frame(frame, gt_pose=(f["R_gt"], f["t_gt"]), defer_cd=True)
                if req is not None:
                    cd_queue.put(("cd", req))
                pu = pipe.take_places_update()
                if pu is not None:
                    cd_queue.put(("places", pu))
            else:
                aw.spin_once(frame)

        print("warmup ...", file=sys.stderr)
        for hf in device_frames[: args.warmup]:
            run_frame(hf)
        # the scroll + forced-emission paths run once before the timed run
        # (the first camera-driven scroll would otherwise pay their first use)
        warmup_triangles.append(warmup_scroll(aw))

        print("timed run ...", file=sys.stderr)
        TimingRecorder.instance().reset()  # steady-state stats only
        before = propagate.launches, gather.launches
        t0 = time.perf_counter()
        for hf in device_frames[args.warmup:]:
            run_frame(hf)
        aw.synchronize()
        dt = time.perf_counter() - t0
        launches.append({"propagate": propagate.launches - before[0], "gather": gather.launches - before[1]})
        if cd_thread is not None:
            cd_queue.put(None)
            cd_thread.join(timeout=600)
        return args.frames / dt

    fps_runs = [run_once() for _ in range(max(args.repeats, 1))]

    for row in sorted(TimingRecorder.instance().stats(), key=lambda r: -r["total_s"])[:14]:
        print(
            f"  {row['name']}: total={row['total_s']:.2f}s mean={row['mean_s']*1e3:.1f}ms n={row['n_samples']}",
            file=sys.stderr,
        )
    print(f"runs: {[round(f, 2) for f in fps_runs]}", file=sys.stderr)
    print(f"warm-up scroll triangles: {warmup_triangles}; kernel launches in the timed frames: {launches}",
          file=sys.stderr)

    fps = statistics.median(fps_runs)
    name = "full_pipeline" if args.full_pipeline else "active_window"
    line = {
        "metric": f"{name}_fps_1chip_office_synthetic_{args.height}x{args.width}",
        "value": round(fps, 2),
        "unit": "frames/s",
        "vs_baseline": round(fps / 25.0, 3),
    }
    return {"line": line, "fps_runs": fps_runs, "launches": launches, "warmup_triangles": warmup_triangles,
            "device": str(device)}


def main(argv=None) -> int:
    print(json.dumps(run(argv)["line"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
