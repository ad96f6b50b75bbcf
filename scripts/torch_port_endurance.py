"""Sustained-throughput endurance run of the PyTorch port (khronos_tpu_torch):
scripts/endurance.py's operating point, flags, defaults and output keys on
the port.

480x640 frames, a 160x160x48 grid at 0.1 m, detection stride 2, change
detection every 50 frames with the All ray policy capped at 8 observers, the
Schur solver, GtLoopClosure (8 s, 1 m, 20 s between detections), over a
corridor sweep whose map grows in area at bounded sensor range; the pipeline
runs in its async stage mode (frame loop = active window only, a backend
worker, a detached change-detection worker with adaptive cadence). Reports

  * the time-weighted sustained frame rate (frames / summed chunk time) and
    the per-chunk rates,
  * each change-detection pass's time and phase breakdown, and the passes
    the adaptive cadence deferred,
  * ray-library growth (full builds vs delta updates), host RSS and the
    per-component memory (device bytes from torch.cuda.memory_allocated).

Frames are rendered onto the device a chunk at a time before each timed
window, so the synthetic sensor stays out of the pipeline's timing.

    python scripts/torch_port_endurance.py                 # on the card
    python scripts/torch_port_endurance.py --device cpu --frames 60 \\
        --height 60 --width 80 --grid 48 48 32 --cd-every 20 --chunk 20
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SPEED = 1.0  # m/s along the corridor (out and back)

# per-pass phase breakdown from TimingRecorder deltas
PHASES = {
    "verificator": "change_detection/update_verificator",
    "merge": "ray_verificator/merge_delta",
    "objects": "change_detection/objects",
    "bg_query": "change_detection/background_query",
    "bg_scan": "change_detection/background_scan",
    "obj_points": "change_detection/objects_points",
    "obj_query": "change_detection/objects_query",
    "obj_votes": "change_detection/objects_votes",
    "obj_scan": "change_detection/objects_scan",
    "reconcile": "reconciliation/all",
    "map_update": "pipeline/map_update",
    "places_reset": "pipeline/places_reset",
}


def _vm_rss_mb() -> int:
    """The CURRENT resident set (MB), after malloc_trim returns freed arena
    pages (a high-water mark would read transient spikes as leaks)."""
    try:
        import ctypes

        ctypes.CDLL("libc.so.6").malloc_trim(0)
    except OSError:
        pass
    try:
        with open("/proc/self/status") as fh:
            for line in fh:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) // 1024
    except OSError:
        pass
    return -1


def _component_mb(pipe) -> dict:
    """Rough per-component live-memory accounting (MB): which store carries
    the memory."""
    def mesh_b(m):
        return sum(getattr(a, "nbytes", 0) for a in
                   (m.vertices, m.colors, m.labels, m.first_seen_ns, m.last_seen_ns, m.faces))

    def graph_b(g):
        tot = mesh_b(g.mesh)
        for o in g.objects.values():
            tot += sum(getattr(a, "nbytes", 0) for a in
                       (o.mesh_vertices, o.mesh_faces, o.mesh_colors, o.trajectory_positions))
        return tot

    out = {}
    stm = pipe.map
    tot = sum(mesh_b(m) for m in stm._unions)
    for st in stm._stores:
        tot += graph_b(st["graph"]) + st["keep"].nbytes
        for idx, old in st["rev"].values():
            tot += idx.nbytes + (old.nbytes if old is not None else 0)
    out["map_4d"] = tot
    out["map_unions"] = len(stm._unions)
    out["backend_mesh"] = mesh_b(pipe.backend.mesh_acc.build())
    out["frame_buffer_n"] = len(pipe.active_window.frame_buffer._frames)
    ver = pipe.change_detector.verificator
    tot = 0
    if ver._built:
        for idx in ver._indexes():
            for k in ("sorted_cells", "sorted_rays", "cell_start", "ray_table", "target_idx"):
                tot += int(np.prod(idx[k].shape)) * 4
            raw = idx.get("raw")
            if raw:
                tot += sum(getattr(a, "nbytes", 0) for a in raw)
    out["ray_library_dev"] = tot
    if pipe.places_extractor is not None:
        out["places_occ"] = sum(len(v) for v in pipe.places_extractor._blocks.values()) * 8
    from khronos_tpu_torch.utils.timing import TimingRecorder

    rec = TimingRecorder.instance()
    out["timing_samples"] = sum(len(rec.samples(n)) for n in rec.names())
    out["device_allocated_dev"] = torch.cuda.memory_allocated() if pipe.device.type == "cuda" else 0
    import gc

    out["numpy_heap_dev"] = sum(o.nbytes for o in gc.get_objects() if isinstance(o, np.ndarray))
    return {k: (v // (1 << 20) if isinstance(v, int) and k.endswith(("_4d", "mesh", "_dev", "_occ")) else v)
            for k, v in out.items()}


def corridor_scene(length: float, duration: float):
    """A corridor of boxes on alternating sides, one of which is removed
    half way through the run, so change detection has a change to find."""
    from khronos_tpu_torch.data import synthetic as syn

    half = np.array([length / 2 + 3.0, 3.0, 1.5], np.float32)
    center = np.array([length / 2, 0.0, 1.5], np.float32)
    prims = []
    rng = np.random.default_rng(7)
    for i, x in enumerate(np.arange(3.0, length - 2.0, 5.0)):
        side = 1.0 if i % 2 == 0 else -1.0
        prims.append(syn.Primitive(
            kind=syn.BOX, center=np.array([x, side * 1.9, 0.35], np.float32),
            half_extents=np.array([0.35, 0.3, 0.35], np.float32), label=2 + (i % 5),
            color=rng.random(3).astype(np.float32) * 0.7 + 0.2, name=f"box_{i}",
        ))
    prims.append(syn.Primitive(
        kind=syn.BOX, center=np.array([length * 0.3, -1.5, 0.35], np.float32),
        half_extents=np.array([0.4, 0.35, 0.35], np.float32), label=6,
        color=np.array([0.9, 0.2, 0.2], np.float32), name="removed_box", t_disappear=duration * 0.5,
    ))
    return syn.Scene(room_half_extents=half, room_center=center, primitives=prims)


def corridor_pose(t: float, duration: float):
    """(R_w_c, t_w_c) float32: out along +x for half the run, then back."""
    T2 = duration / 2.0
    out = t <= T2
    x = SPEED * t if out else SPEED * (duration - t)
    pos = np.array([x, 0.0, 1.4])
    fwd = np.array([1.0, 0.0, 0.0]) if out else np.array([-1.0, 0.0, 0.0])
    look = fwd + np.array([0.0, 0.0, -0.12])
    up = np.array([0.0, 0.0, 1.0])
    z = look / np.linalg.norm(look)
    xax = np.cross(z, up)
    xax /= np.linalg.norm(xax)
    yax = np.cross(z, xax)
    return np.stack([xax, yax, z], axis=1).astype(np.float32), pos.astype(np.float32)


def corridor_sequence(frames: int, fps: float, height: int, width: int, device):
    from khronos_tpu_torch.data import synthetic as syn

    duration = frames / fps

    class CorridorSequence(syn.SyntheticSequence):
        def pose_at(self, t: float):
            return corridor_pose(t, duration)

    scene = corridor_scene(SPEED * duration / 2.0, duration)
    return CorridorSequence(scene, syn.SyntheticSequenceConfig(
        duration=duration, fps=fps, height=height, width=width, fx=width * 0.625, fy=width * 0.625,
        cx=width / 2, cy=height / 2,
    ), device=device)


def pipeline_config(grid, cd_every: int, all_cap: int) -> dict:
    return {
        "active_window": {
            "volumetric_map": {"grid_shape": list(grid), "voxel_size": 0.1},
            "detection_stride": 2,
            "motion_detector": {"type": "FreeSpaceMotionDetector", "min_cluster_size": 400},
            "object_detector": {"type": "ConnectedSemantics", "min_cluster_size": 50},
            "tracker": {"type": "MaxIouTracker"},
            "object_extractor": {"type": "MeshObjectExtractor"},
        },
        # schur: eliminate the (dominant) mesh-control block; 20 s between
        # loop closures matches the reference's sparse real-data profile
        "backend": {"lcd": {"type": "GtLoopClosure", "min_time_gap": 8.0, "max_distance": 1.0,
                            "min_detection_separation": 20.0},
                    "solver": "schur"},
        "label_space": {"num_classes": 8, "object_labels": [2, 3, 4, 5, 6], "dynamic_labels": [1]},
        "run_change_detection_every_n_frames": cd_every,
        "change_detection": {
            "verificator": {"ray_policy": "All", "all_max_observers": all_cap, "temporal_resolution": 2.0},
            "detector": {"window_size": 3, "evidence_prior": 2.0},
        },
    }


def run(args, log=None):
    """Drive the endurance run; returns (result dict, pipeline)."""
    from khronos_tpu_torch import resolve_device
    from khronos_tpu_torch.active_window.frame_data import FrameData
    from khronos_tpu_torch.config import build
    from khronos_tpu_torch.pipeline.pipeline import KhronosPipeline, PipelineConfig
    from khronos_tpu_torch.utils.timing import TimingRecorder

    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    device = resolve_device(args.device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    seq = corridor_sequence(args.frames, args.fps, args.height, args.width, device)
    cfg = build(PipelineConfig, pipeline_config(args.grid, args.cd_every, args.all_cap))
    pipe = KhronosPipeline(cfg, seq.camera, device=device)

    cd_rows = []
    cd_inner = pipe.run_change_detection_on

    def phase_totals():
        rec = TimingRecorder.instance()
        return {k: sum(rec.samples(n)) for k, n in PHASES.items()}

    def instrumented_cd(*req):
        t0 = time.perf_counter()
        frame_i = pipe.frame_count
        before = phase_totals()
        cd_inner(*req)
        after = phase_totals()
        ver = pipe.change_detector.verificator
        cd_rows.append({
            "frame": frame_i, "cd_s": round(time.perf_counter() - t0, 2), "rays": int(ver.total_rays),
            "full_builds": ver.n_full_builds, "delta_updates": ver.n_delta_updates, "merges": ver.n_merges,
            "rss_mb": _vm_rss_mb(), **{f"{k}_s": round(after[k] - before[k], 2) for k in PHASES},
        })
        log(f"  cd pass @frame {frame_i}: {cd_rows[-1]}")

    pipe.run_change_detection_on = instrumented_cd
    pipe.start_async()

    chunk_fps, chunk_dt, rss_series = [], [], []
    n_done = 0
    t_begin = time.perf_counter()
    while n_done < args.frames:
        hi = min(n_done + args.chunk, args.frames)
        frames = [seq.render_frame(i) for i in range(n_done, hi)]
        sync()
        t0 = time.perf_counter()
        for f in frames:
            pipe.submit_frame(FrameData(
                stamp_ns=f["stamp_ns"], depth=f["depth"], color=f["color"], labels=f["labels"],
                R_w_c=f["R_w_c"], t_w_c=f["t_w_c"],
            ), gt_pose=(f["R_gt"], f["t_gt"]))
        sync()
        dt = time.perf_counter() - t0
        chunk_fps.append(round(len(frames) / dt, 2))
        chunk_dt.append(dt)
        rss_series.append(_vm_rss_mb())
        n_done = hi
        log(f"frames {n_done}/{args.frames}: chunk fps {chunk_fps[-1]:.1f} (deferred CD triggers so far: "
            f"{pipe.cd_deferred_triggers}, rss {rss_series[-1]} MB)")

    t_drain = time.perf_counter()
    pipe.finish_async()
    sync()
    drain_s = time.perf_counter() - t_drain
    log(f"finish_async drain: {drain_s:.1f}s")
    wall = time.perf_counter() - t_begin

    # the TIME-WEIGHTED sustained rate (frames / summed chunk time) is the
    # headline: a median of per-chunk rates hides long stalls
    tw = args.frames / max(sum(chunk_dt), 1e-9)
    components = _component_mb(pipe)
    log(f"component MB: {components}")
    out = {
        "metric": "sustained_pipeline_fps_timeweighted",
        "value": round(tw, 2),
        "unit": "frames/s",
        "vs_baseline": round(tw / 25.0, 3),
        "frames": args.frames,
        "shape": f"{args.height}x{args.width}",
        "chunk_fps_median": float(np.median(chunk_fps)),
        "chunk_fps_p10": round(float(np.percentile(chunk_fps, 10)), 2),
        "chunk_fps_first": chunk_fps[0],
        "chunk_fps_min": min(chunk_fps),
        "chunk_fps_last": chunk_fps[-1],
        "wall_s_incl_render": round(wall, 1),
        "cd_cadence_wall_s": round(args.cd_every / max(tw, 1e-9), 2),
        "cd_passes": len(cd_rows),
        "cd_deferred_triggers": pipe.cd_deferred_triggers,
        "cd_max_s": max((r["cd_s"] for r in cd_rows), default=0.0),
        "finish_drain_s": round(drain_s, 1),
        "cd_median_s": float(np.median([r["cd_s"] for r in cd_rows])) if cd_rows else 0.0,
        "rss_mb_final": _vm_rss_mb(),
        "component_mb": components,
        "rss_mb_series": rss_series,
        "cd_rows": cd_rows,
        "chunk_fps": chunk_fps,
    }
    return out, pipe


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=3000)
    ap.add_argument("--fps", type=float, default=10.0, help="stamp rate")
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--grid", type=int, nargs=3, default=[160, 160, 48])
    ap.add_argument("--chunk", type=int, default=100)
    ap.add_argument("--cd-every", type=int, default=50)
    ap.add_argument("--all-cap", type=int, default=8)
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "torch_port_endurance.json"))
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    out, _ = run(args)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(out, fh, indent=1)
    from khronos_tpu_torch.utils.timing import TimingRecorder

    for row in sorted(TimingRecorder.instance().stats(), key=lambda r: -r["total_s"])[:16]:
        print(f"  {row['name']}: total={row['total_s']:.1f}s mean={row['mean_s'] * 1e3:.1f}ms "
              f"n={row['n_samples']}", file=sys.stderr)
    print(json.dumps({k: v for k, v in out.items() if k not in ("cd_rows", "chunk_fps")}))


if __name__ == "__main__":
    main()
