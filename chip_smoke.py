#!/usr/bin/env python3
"""On-card smoke run of khronos_tpu_torch, the PyTorch + CUDA port.

    python3 chip_smoke.py [--profile PATH]

Needs one CUDA card (an H100 is the target) and the CUDA toolkit (`nvcc`).
Phases, in order; any failure raises and the run exits non-zero:

1. card: torch / CUDA versions, and the card's name and power limit as
   `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` gives them;
2. build: both hand-written kernels from the sources in this checkout (one
   `nvcc` per source, all started together) into build/khronos_tpu_torch/;
3. checks: each kernel against its plain PyTorch version on made-up inputs,
   bit for bit. A (one launch a call, which also reports the rounds it ran
   and the tiles it found active, both checked): at 112x112x48 over 16
   rounds with random seeds; a wall that keeps two labels apart, over 16 and
   112 rounds; odd shapes x inputs (none growable, all growable, a fixpoint
   at round 0, blobs that settle mid-way, a plane that does not settle) x
   iterations around the rounds of one step; a grid with more active tiles a
   block than the kernel lists (the odd inputs and the expectations are
   tests/test_torch_kernels_cuda.py's); one call captured in a CUDA graph
   and replayed on new inputs. B: a [307200, 2] image holding NaN bit patterns,
   602,112 rows. A also at its fixpoint, as the room segmentation calls it
   (`propagate_labels_3d_fixpoint`, one launch): a 144x144x16 snaking
   corridor (over a thousand rounds), a 144^3 grid of random free space (the
   room grid's largest size) and an odd shape with Z below one tile, each
   against the plain fixpoint loop, the rounds it reports included. Then the
   fused per-frame step at a small size on the card
   and on the CPU (the CPU path is held to the JAX package by
   tests/test_torch_*.py): id images and the volume's integer state bit for
   bit, floats to 1e-5;
4. main path: the port's ActiveWindow at the bench operating point (480x640
   RGB-D + semantics from the port's synthetic office, a 160x160x48 grid at
   0.1 m, detection stride 2, FreeSpaceMotionDetector min 400 px,
   ConnectedSemantics min 50 px, MaxIouTracker): warm-up frames, then timed
   frames, then a few frames whose kernel inputs are recorded, then
   finish_mapping, with every kernel's launch count set to 0 just before the
   timed frames and read just after them. Asserts that each kernel ran once
   a frame, that the mesh has triangles and that a dynamic track was found;
5. kernels: each kernel's wrapper on the inputs the main path gave it (the
   gather also on a NaN-pattern image with the main path's rows), bit-exact
   against its plain PyTorch version, timed beside it, beside one library
   call where there is one, and beside its bound (device times from CUDA
   events; see time_ms). A is also timed on a dense input (40% growable, all
   tiles active), and beside the first port's design of it (one launch a
   round, kept as the yardstick), with
   the rounds it ran, its active tiles and the inputs' growable share;
6. backend_path: object extraction and the backend at the bench point over
   a 24 s office run at 10 fps (two orbits) with drifted odometry
   (drift_rate 0.1): every frame through ActiveWindow.spin_once, every output
   through finalize_output (MeshObjectExtractor, G = 48, K = 24) and
   Backend.add_output (GtLoopClosure, min gap 8 s, max distance 1 m), then
   finish_mapping, finish_processing, get_dsg and save into build/. Asserts
   A and B launched once a frame, a loop closure and a solve that moved
   geometry, static objects with meshes and dynamic ones with trajectories, a
   deformed background mesh, dsg.npz loading back equal; the port's backend
   on the CPU fed the same outputs agrees with the card, and a second card
   run is bit-identical; the extractor on the card and on the CPU agrees on
   two static tracks. Times each of the slice's device functions alone;
7. pipeline_path: the office run users start, `python -m khronos_tpu_torch.run
   --config configs/office_synthetic.yaml dataset.drift_rate=0.1` (300 frames
   of 240x320, the places layer per output, change detection every 50 frames
   and on each loop closure, then the viewer export and the evaluation),
   through run.main. Asserts the finished flag and the output files (the
   viewer, gt.npz, the result CSVs, the printed tables), B launched once a
   frame and A once a frame plus once a room segmentation, a loop closure and
   a solve that moved geometry, a full ray-library build, a delta update and
   a merge, at least 2 4D-map snapshots, final.4dmap.npz loading back equal,
   the removed chair's presence ending before the last 2 s, the places layer
   as the reference's office e2e test holds it (mid-run and final snapshots
   non-empty, at least one room, every place in a room, clearances in [0.2,
   6] m), and the map quality within the band of the JAX package's own runs
   of the same command on the CPU (REFERENCE_QUALITY). The run's
   extractor calls replayed through a PlacesExtractor on the CPU and again on
   the card give the same layers, bit for bit; `python -m
   khronos_tpu_torch.eval --only-final` on the saved run writes the same
   CSVs. The run's change-detection requests replayed through the port on
   the CPU (up to CPU_REPLAY_BUDGET_S, at least to the first full rebuild
   after a loop closure) give the same Changes, background states and 4D-map
   arrays, and a second card replay of all of them the same bits; the ray
   index and the largest background query card vs CPU. Times each of the
   slice's device functions alone, and the evaluation's prune-to-observed
   distances. Then kernel A on the run's largest room grid, to the fixpoint:
   bit for bit and timed beside the plain fixpoint loop;
8. apartment_path and openset_path: `python -m khronos_tpu_torch.run --config
   configs/apartment_synthetic.yaml` (200 frames of 240x320, the fused step)
   and `... configs/openset_synthetic.yaml` (80 frames of 120x160,
   InstanceForwarding with max_instances 64 > the fused cap: the modular
   detectors) through run.main as users run them. Each asserts the finished
   flag and the output files, A once a frame plus once a room segmentation
   and B once a frame, static objects with meshes, and the map quality
   against the JAX package's CPU runs of the same command
   (APARTMENT_QUALITY, OPENSET_QUALITY). A on the motion-detector input of
   the run's frame with the most growable voxels (the fused step's motion
   regions; the modular motion detector on the full grid) or, where no
   frame has one, on the run's largest room grid to the fixpoint; B on the
   inputs of frame RECORD_FRAME; each bit for bit, with growable voxels and
   rounds run for A, and timed. The open-set run must
   build no fused step and keep its objects' features (the scene's instance
   embeddings) into final.4dmap.npz; the same config with max_instances=32
   then takes the fused open-set branch and must give the same semantic
   clusters in every frame;
9. jackal_path: real-data input and loop closure without the oracle. Writes
   a rosbag2 (this script's own CDR + sqlite3 writer) of the port's office at
   240x320 with the sensor noise model and drifted odometry (200 frames at 5
   frames/s, two orbits; raw depth, colour, palette labels, Odometry, camera
   info), then runs `python -m khronos_tpu_torch.run --config
   configs/jackal_real.yaml` on it through run.main with the reference test's
   overrides and the config's own 128x128x48 grid (descriptor LCD with GNC
   registration). Asserts the finished flag and 200 frames, the JAX
   package's loop closures on the same bag (by stamp) and a solve, the
   optimised ATE within the JAX package's band (JACKAL_ATE; reported beside
   the odometry's, which the reference does not beat on this bag), A once a
   frame plus once a
   room segmentation and B once a frame, and the run's detector calls
   replayed through the port's detector on the CPU giving the same loop
   closures (R and t within 1e-4); A and B checked and timed on this path's
   inputs as in 8;
10. sweep: kernel A built and timed at other rounds per step and tile shapes
   (phase_sweep), the measurements behind the ones csrc/propagate.cu uses;
11. prints the kernels line as JSON, then `{"ok": true, "device": ...}` last.

With --profile PATH it also traces a few more frames with torch.profiler and
writes the device time by kernel, the device operations per frame and the
device busy share to PATH.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import math
import statistics
import struct
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
FP32_OPS_PER_S = 67e12  # H100 SXM 32-bit operations outside the tensor cores
WARMUP, FRAMES = 10, 40  # main path: warm-up frames, then timed frames
CAPTURED = 5  # frames after the timed ones whose kernel inputs are recorded
PROFILE_FRAMES = 10  # traced frames with --profile


def log(msg: str) -> None:
    print(msg, flush=True)


def require(cond, what) -> None:
    """Fail the run (a check that `python -O` does not strip, unlike assert)."""
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20, samples: int = 5, warmup: int = 3) -> float:
    """Device time of one call of fn: the median over `samples` of CUDA events
    around `reps` back-to-back calls, divided by reps. Each sample first
    queues a sleep kernel of about 25 ms, so the host has queued the calls
    before the start event runs: the time is the device's, not the host's
    launch overhead (unless the calls take longer to queue than the sleep)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def in_turns(*fns):
    """ms of each function, measured in order and then in reverse order (for
    two: plain, kernel, kernel, plain), each the mean of its two times."""
    first = [time_ms(f) for f in fns]
    second = [time_ms(f) for f in reversed(fns)][::-1]
    return [(a + b) / 2 for a, b in zip(first, second)]


def bench_config():
    return {
        "volumetric_map": {"grid_shape": [160, 160, 48], "voxel_size": 0.1},
        "detection_stride": 2,
        "motion_detector": {"type": "FreeSpaceMotionDetector", "min_cluster_size": 400},
        "object_detector": {"type": "ConnectedSemantics", "min_cluster_size": 50},
        "tracker": {"type": "MaxIouTracker"},
        "object_extractor": {"type": "MeshObjectExtractor"},
    }


def make_sequence(syn, n_frames, height, width, device):
    duration = n_frames / 10.0 + 1.0
    return syn.SyntheticSequence(
        syn.office_scene(duration=duration),
        syn.SyntheticSequenceConfig(
            duration=duration, fps=10.0, height=height, width=width,
            fx=width * 0.625, fy=width * 0.625, cx=width / 2, cy=height / 2,
        ),
        device=device,
    )


def phase_parity():
    """The fused step on the card and on the CPU, same frames, same start."""
    from khronos_tpu_torch.active_window import fused_step as fs
    from khronos_tpu_torch.active_window.active_window import ActiveWindowConfig
    from khronos_tpu_torch.config import build
    from khronos_tpu_torch.data import synthetic as syn
    from khronos_tpu_torch.map import active_volume as av

    n = 12
    seq = make_sequence(syn, n, 96, 128, "cuda")
    cfg = build(ActiveWindowConfig, {
        "volumetric_map": {"grid_shape": [64, 64, 32], "voxel_size": 0.1},
        "detection_stride": 2,
        "motion_detector": {"type": "FreeSpaceMotionDetector", "min_cluster_size": 40},
        "object_detector": {"type": "ConnectedSemantics", "min_cluster_size": 10},
    })
    steps = {
        dev: fs.make_frame_step(
            cfg.volumetric_map, seq.camera, cfg.motion_detector.config,
            cfg.object_detector.config, syn.default_label_space(), detection_stride=2,
        )
        for dev in ("cuda", "cpu")
    }
    first = seq.render_frame(0)
    origin = np.floor(first["t_w_c"] / 0.1 - np.asarray([64, 64, 32]) / 2.0).astype(np.int32)
    state = av.create(cfg.volumetric_map, device="cpu")._replace(origin=torch.from_numpy(origin))
    states = {"cpu": state, "cuda": av.state_from_numpy(av.state_to_numpy(state), "cuda")}
    repeat = av.state_from_numpy(av.state_to_numpy(state), "cuda")  # the card again, from the same start
    n_dyn = n_obj = 0
    for i in range(n):
        f = seq.render_frame(i)
        outs = {}
        for dev in ("cuda", "cpu"):
            imgs = [f[k].to(dev) for k in ("depth", "color", "labels")]
            states[dev], d, o, p = steps[dev](states[dev], *imgs, f["R_w_c"], f["t_w_c"], f["t"])
            outs[dev] = (d.cpu(), o.cpu(), p.cpu())
        (dg, og, pg), (dc, oc, pc) = outs["cuda"], outs["cpu"]
        require(torch.equal(dg, dc) and torch.equal(og, oc), f"id images differ at frame {i}")
        stats_g = pg[: 2 * fs.MC * 12].view(2 * fs.MC, 12)
        stats_c = pc[: 2 * fs.MC * 12].view(2 * fs.MC, 12)
        require(torch.equal(stats_g[:, 9:], stats_c[:, 9:]), f"cluster counts/ids differ at frame {i}")
        torch.testing.assert_close(pg, pc, rtol=1e-5, atol=1e-5, equal_nan=True)
        n_dyn += int(dg.max())
        n_obj += int(og.max())
    for i in range(n):
        f = seq.render_frame(i)
        repeat = steps["cuda"](repeat, *[f[k].cuda() for k in ("depth", "color", "labels")],
                               f["R_w_c"], f["t_w_c"], f["t"])[0]
    got, want = av.state_to_numpy(states["cuda"]), av.state_to_numpy(states["cpu"])
    again = av.state_to_numpy(repeat)
    unrepeated = [name for name, a, b in zip(got._fields, got, again) if not np.array_equal(a, b, equal_nan=True)]
    worst, worst_field = 0.0, None
    for name, a, b in zip(got._fields, got, want):
        if a.dtype.kind == "f":
            fin = np.isfinite(b)
            require((np.isfinite(a) == fin).all() and (a[~fin] == b[~fin]).all(), name)
            diff = np.abs(a[fin] - b[fin])
            if diff.max(initial=0.0) > worst:
                worst, worst_field = float(diff.max()), f"{name} ({int((diff > 1e-5).sum())} cells over 1e-5)"
        else:
            require((a == b).all(), name)
    require(worst <= 1e-5, f"float state max |diff| {worst} in {worst_field}; the card's second run from the same "
                           f"start differs from its first in {unrepeated or 'no field'}")
    require(n_dyn > 0 and n_obj > 0, (n_dyn, n_obj))
    log(f"parity: {n} frames at 96x128, card == CPU (ids, counts, integer state exact; "
        f"float state max |diff| {worst:.3g}); dynamic ids {n_dyn}, object ids {n_obj}; the card's second run "
        f"from the same start differs from its first in {unrepeated or 'no field'}")


def phase_main_path(profile_path):
    from khronos_tpu_torch.active_window.active_window import ActiveWindow, ActiveWindowConfig
    from khronos_tpu_torch.active_window.frame_data import FrameData
    from khronos_tpu_torch.config import build
    from khronos_tpu_torch.data import synthetic as syn
    from khronos_tpu_torch.ops import gather, propagate
    from khronos_tpu_torch.utils.timing import TimingRecorder

    n_total = WARMUP + FRAMES + CAPTURED + (PROFILE_FRAMES if profile_path else 0)
    seq = make_sequence(syn, n_total, 480, 640, "cuda")
    t0 = time.perf_counter()
    frames = [seq.render_frame(i) for i in range(n_total)]
    torch.cuda.synchronize()
    log(f"rendered {n_total} frames at 480x640 on the card in {time.perf_counter() - t0:.2f} s")
    aw = ActiveWindow(build(ActiveWindowConfig, bench_config()), seq.camera, syn.default_label_space())
    # the per-frame work alone: object extraction waits for finalize_output,
    # which the backend stage runs (phase_backend_path drives it)
    aw.defer_object_extraction = True

    outputs = []

    def run(f):
        frame = FrameData(
            stamp_ns=f["stamp_ns"], depth=f["depth"], color=f["color"], labels=f["labels"],
            R_w_c=f["R_w_c"], t_w_c=f["t_w_c"],
        )
        out = aw.spin_once(frame)
        if out is not None:
            outputs.append(out)
        return frame

    for f in frames[:WARMUP]:
        run(f)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    propagate.launches = 0
    gather.launches = 0
    recorder = TimingRecorder.instance()
    recorder.reset()
    # the host's launch rate paces this path, and the host's cores are
    # shared: report each window of 10 frames (each ends in a synchronize)
    window_ms, call_ms = [], []
    t0 = tw = time.perf_counter()
    for i, f in enumerate(frames[WARMUP: WARMUP + FRAMES]):
        tc = time.perf_counter()
        last = run(f)
        call_ms.append((time.perf_counter() - tc) * 1e3)
        if (i + 1) % 10 == 0 or i + 1 == FRAMES:
            torch.cuda.synchronize()
            now = time.perf_counter()
            window_ms.append((now - tw) * 1e3 / (i % 10 + 1))
            tw = now
    dt = time.perf_counter() - t0
    counts = {"propagate": propagate.launches, "gather": gather.launches}
    peak = torch.cuda.max_memory_allocated()
    log(f"main path: {FRAMES} frames in {dt:.3f} s = {FRAMES / dt:.2f} frames/s, "
        f"{dt / FRAMES * 1e3:.2f} ms/frame (windows of 10 frames: "
        f"{', '.join(f'{w:.2f}' for w in window_ms)} ms/frame), peak device memory {peak / 2**20:.1f} MiB")
    q = statistics.quantiles(call_ms, n=4)
    log(f"host time of one spin_once call (no synchronize): median {statistics.median(call_ms):.2f} ms, "
        f"p75 {q[2]:.2f} ms, max {max(call_ms):.2f} ms over {len(call_ms)} frames")
    # host time by stage (the port's Timer spans; children nest in their parents)
    stages = {r["name"]: r["total_s"] * 1e3 / FRAMES for r in recorder.stats()}
    log("host ms/frame by stage: " + ", ".join(f"{k} {v:.2f}" for k, v in stages.items()))
    log(f"launches during the timed frames: {counts}")
    require(counts["propagate"] == FRAMES and counts["gather"] == FRAMES, f"not one launch a frame each: {counts}")

    # a few more frames with the wrappers recording their inputs (clones),
    # for the kernel checks on main-path inputs; launches here are not counted
    captured = {"propagate_labels_3d_cuda": [], "gather_rows_cuda": []}

    def record(module, name):
        fn = getattr(module, name)

        def wrapped(*a):
            captured[name].append([x.clone() if torch.is_tensor(x) else x for x in a])
            return fn(*a)

        setattr(module, name, wrapped)
        return lambda: setattr(module, name, fn)

    restore = [record(propagate, "propagate_labels_3d_cuda"), record(gather, "gather_rows_cuda")]
    for f in frames[WARMUP + FRAMES: WARMUP + FRAMES + CAPTURED]:
        last = run(f)
    for r in restore:
        r()
    require(all(len(v) >= 1 for v in captured.values()), {k: len(v) for k, v in captured.items()})

    if profile_path:
        profile(aw, run, frames[WARMUP + FRAMES + CAPTURED:], profile_path)

    outputs.append(aw.finish_mapping(last))  # extracts the last tracks inline
    n_tris = sum(len(o.mesh_vertices) for o in outputs)
    tracks = [t for o in outputs for t in (o.pending_tracks or [])]
    n_dyn = sum(t.is_dynamic for t in tracks)
    n_objects = len(outputs[-1].objects)
    verts = np.concatenate([o.mesh_vertices for o in outputs])
    require(n_tris > 0 and np.isfinite(verts).all(), n_tris)
    require(n_dyn > 0, f"no dynamic track among {len(tracks)} finished tracks")
    state = aw.state
    require(tuple(state.tsdf.shape) == (160, 160, 48), f"volume shape {tuple(state.tsdf.shape)}")
    require(bool(torch.isfinite(state.tsdf).all() & torch.isfinite(state.color).all()),
            "non-finite tsdf or color in the volume")
    log(f"mesh triangles {n_tris}, finished tracks handed out {len(tracks)} ({n_dyn} dynamic), "
        f"objects extracted at finish_mapping {n_objects}")
    return {
        "fps": FRAMES / dt,
        "ms_per_frame": dt / FRAMES * 1e3,
        "window_ms_per_frame": window_ms,
        "spin_once_host_ms": {"median": statistics.median(call_ms), "p75": q[2], "max": max(call_ms)},
        "host_stage_ms_per_frame": stages,
        "peak_mib": peak / 2**20,
        "launches": counts,
        "captured": captured,
    }


def profile(aw, run, frames, path):
    """Trace a few frames; write the device time of each kernel (and of the
    PyTorch operator that launched it), the kernels per frame and the device
    busy share (kernel time over wall time: one stream, so kernels do not
    overlap)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for f in frames:
            run(f)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels, ops = [], []
    for e in prof.key_averages():
        row = (e.self_device_time_total, e.count, e.key[:160])
        if e.device_type == DeviceType.CUDA:
            kernels.append(row)
        elif e.self_device_time_total > 0 or e.device_time_total > 0:
            ops.append((e.device_time_total, e.count, e.key[:160]))
    n = len(frames)
    busy = sum(r[0] for r in kernels) * 1e-6
    launches = sum(r[1] for r in kernels) / n
    with open(path, "w") as fh:
        fh.write(f"{n} frames, wall {wall * 1e3:.3f} ms, device kernel time {busy * 1e3:.3f} ms, "
                 f"busy share {busy / wall:.4f}, {launches:.1f} device operations/frame\n")
        fh.write("\n-- kernels (device time) --\n")
        for dev_us, count, key in sorted(kernels, reverse=True)[:40]:
            fh.write(f"{dev_us / n:12.1f} us/frame {count / n:8.1f} calls/frame  {key}\n")
        fh.write("\n-- operators (device time of the kernels they launched) --\n")
        for dev_us, count, key in sorted(ops, reverse=True)[:40]:
            fh.write(f"{dev_us / n:12.1f} us/frame {count / n:8.1f} calls/frame  {key}\n")
    log(f"profile: {n} frames, wall {wall / n * 1e3:.3f} ms/frame, device kernel time "
        f"{busy / n * 1e3:.3f} ms/frame, busy share {busy / wall:.4f}, "
        f"{launches:.1f} device operations/frame -> {path}")


CROP = (112, 112, 48)  # the bench point's camera-centred crop
ITERATIONS = 16  # FreeSpaceMotionDetectorConfig.grow_iterations
IMG_ROWS, VOXELS = 480 * 640, 112 * 112 * 48


def nan_pattern_image(g):
    """[H*W, 2] words: random bits, with payload words that are NaN patterns."""
    words = torch.randint(-2**31, 2**31 - 1, (IMG_ROWS, 2), device="cuda", generator=g,
                          dtype=torch.int64).to(torch.int32)
    words[::97, 1] = 0x7FC00001  # quiet-NaN payload words
    words[1::89, 1] = -8388607  # 0xFF800001: signalling-NaN pattern
    return words.view(torch.float32)


def dense_input(seed):
    """Random seeds in 40% growable cells at the crop: every tile is active
    and the grid is still changing after 16 rounds."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    seeds = torch.rand(CROP, device="cuda", generator=g) < 0.02
    grow = (torch.rand(CROP, device="cuda", generator=g) < 0.4) | seeds
    lin = torch.arange(VOXELS, dtype=torch.int32, device="cuda").view(CROP)
    return torch.where(seeds, lin, -1), grow


def kernel_cases():
    """tests/test_torch_kernels_cuda.py, which holds kernel A's made-up inputs
    and what the kernel must report on them (it imports no jax)."""
    tests = str(Path(__file__).resolve().parent / "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import test_torch_kernels_cuda

    return test_torch_kernels_cuda


def check_propagate(propagate, lab, grow, iterations, name) -> dict:
    """Kernel A against its plain version, bit for bit, in one launch; the
    rounds it ran and the tiles it found active against what the input
    needs (tests/test_torch_kernels_cuda.py's expected_rounds, active_tiles)."""
    before = propagate.launches
    got, ws = propagate.launch(lab, grow, iterations)
    want = propagate.propagate_labels_3d_plain(lab, grow, iterations)
    torch.cuda.synchronize()
    require(propagate.launches - before == 1, f"kernel A: {propagate.launches - before} launches ({name})")
    require(torch.equal(got, want), f"kernel A differs from its plain version ({name}, {iterations} rounds)")
    cases = kernel_cases()
    tiles = propagate.n_tiles(lab.shape)
    active = int((ws[propagate.WS_HEADER: propagate.WS_HEADER + tiles] != 0).sum())
    rounds = int(ws[propagate.WS_ROUNDS])
    want_rounds = cases.expected_rounds(lab, grow, iterations)
    require(rounds == want_rounds, f"kernel A ran {rounds} rounds, the input needs {want_rounds} ({name})")
    if iterations > 0:
        require(active == cases.active_tiles(grow), f"kernel A found {active} active tiles ({name})")
    return {"max_abs_err": int((got.long() - want.long()).abs().max()) if got.numel() else 0,
            "rounds": rounds, "rounds_to_fixpoint": cases.expected_rounds(lab, grow, iterations, depth=1),
            "active_tiles": active, "tiles": tiles}


def check_fixpoint(propagate, lab, grow, name) -> dict:
    """Kernel A to the fixpoint (propagate_labels_3d_fixpoint, one launch)
    against the plain fixpoint loop, bit for bit, and the rounds it reports
    against the loop's count (tests/test_torch_kernels_cuda.py's
    fixpoint_rounds)."""
    before = propagate.launches
    got = propagate.propagate_labels_3d_fixpoint(lab, grow)
    want, plain_rounds = propagate.propagate_labels_3d_fixpoint_plain(lab, grow)
    torch.cuda.synchronize()
    require(propagate.launches - before == 1, f"kernel A at the fixpoint: {propagate.launches - before} launches ({name})")
    require(torch.equal(got, want), f"kernel A at the fixpoint differs from the plain fixpoint loop ({name})")
    _, ws = propagate.launch(lab, grow, lab.numel())
    rounds = int(ws[propagate.WS_ROUNDS])
    want_rounds = kernel_cases().fixpoint_rounds(plain_rounds, grow, lab.numel())
    require(rounds == want_rounds, f"kernel A ran {rounds} rounds to the fixpoint, the plain loop {plain_rounds} "
                                   f"(want {want_rounds}) ({name})")
    return {"input": name, "shape": list(lab.shape), "plain_rounds": plain_rounds, "rounds": rounds,
            "growable_share": float(grow.float().mean()), "max_abs_err": 0}


def check_propagate_graph(propagate):
    """One call of kernel A captured into a CUDA graph, replayed on new inputs
    copied into the captured tensors: bit-exact each time."""
    lab, grow = dense_input(5)
    propagate.propagate_labels_3d(lab, grow, ITERATIONS)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = propagate.propagate_labels_3d(lab, grow, ITERATIONS)
    for seed in (6, 7, 6):
        new_lab, new_grow = dense_input(seed)
        lab.copy_(new_lab)
        grow.copy_(new_grow)
        graph.replay()
        torch.cuda.synchronize()
        require(torch.equal(out, propagate.propagate_labels_3d_plain(lab, grow, ITERATIONS)),
                f"kernel A's graph replay differs from its plain version (seed {seed})")


def check_gather(gather, img, idx, name) -> int:
    got = gather.gather_rows_cuda(img, idx).view(torch.int32)
    want = gather.gather_rows_plain(img, idx).view(torch.int32)
    torch.cuda.synchronize()
    require(torch.equal(got, want), f"kernel B differs from its plain version ({name})")
    return int((got.long() - want.long()).abs().max())


def phase_kernel_checks():
    """Both kernels on made-up inputs, bit-exact against their plain versions,
    before the main path runs: A at the main path's shape (random seeds; a
    wall at 16 and 112 rounds), at odd shapes and iterations, and replayed
    from a CUDA graph; B at the main path's shapes."""
    from khronos_tpu_torch.ops import gather, propagate

    check_propagate(propagate, *dense_input(0), ITERATIONS, "random seeds")
    # a wall of non-growable cells keeps two labels apart, however many rounds
    wall_lab = torch.full(CROP, -1, dtype=torch.int32, device="cuda")
    wall_lab[1, 1, 1] = 100
    wall_lab[100, 100, 40] = 200
    wall_grow = torch.ones(CROP, dtype=torch.bool, device="cuda")
    wall_grow[:, 56, :] = False
    check_propagate(propagate, wall_lab, wall_grow, ITERATIONS, "wall")
    check_propagate(propagate, wall_lab, wall_grow, 112, "wall")
    out = propagate.propagate_labels_3d_cuda(wall_lab, wall_grow, 112)
    require(bool((out[:, :56] == 100).all() & (out[:, 57:] == 200).all() & (out[:, 56] == -1).all()),
            "the wall did not keep labels 100 and 200 apart")
    n_odd = 0
    cases = kernel_cases()
    for shape in cases.ODD_SHAPES:
        for family in cases.FAMILIES:
            lab, grow = (x.cuda() for x in cases.propagate_case(shape, family, seed=2))
            for iterations in cases.ODD_ITERATIONS:
                check_propagate(propagate, lab, grow, iterations, f"{shape} {family}")
                n_odd += 1
    # more active tiles a block than its shared-memory list holds: 40,960
    # tiles, every one active, once with a fixpoint at round 0
    big = (320, 256, 416)
    gb = torch.Generator(device="cuda").manual_seed(3)
    big_grow = torch.rand(big, device="cuda", generator=gb) < 0.4
    big_lab = torch.where(torch.rand(big, device="cuda", generator=gb) < 0.01,
                          torch.arange(math.prod(big), dtype=torch.int32, device="cuda").view(big), -1)
    check_propagate(propagate, big_lab, big_grow, 4, "more active tiles than a block lists")
    check_propagate(propagate, torch.full(big, 7, dtype=torch.int32, device="cuda"), big_grow, 4,
                    "more active tiles than a block lists, fixpoint at round 0")
    del big_grow, big_lab
    check_propagate_graph(propagate)
    # to the fixpoint, as the room segmentation runs it
    fixpoints = [check_fixpoint(propagate, *(x.cuda() for x in cases.snake_case((144, 144, 16), pitch=16)),
                                "144x144x16 snaking corridor")]
    require(fixpoints[0]["plain_rounds"] > 300, fixpoints[0])
    gr = torch.Generator(device="cuda").manual_seed(8)
    room = torch.rand((144, 144, 144), device="cuda", generator=gr) < 0.6
    seeds = torch.arange(1, room.numel() + 1, dtype=torch.int32, device="cuda").view(room.shape)
    fixpoints.append(check_fixpoint(propagate, torch.where(room, seeds, -1), room, "144^3 random free space"))
    del room, seeds
    fixpoints.append(check_fixpoint(propagate, *(x.cuda() for x in cases.propagate_case((37, 53, 5), "mid", seed=1)),
                                    "37x53x5 (Z below one tile)"))
    g = torch.Generator(device="cuda").manual_seed(0)
    idx = torch.randint(0, IMG_ROWS, (VOXELS,), device="cuda", generator=g, dtype=torch.int32)
    idx[:4] = torch.tensor([-1, -IMG_ROWS - 1, IMG_ROWS, 2**31 - 1], dtype=torch.int32)  # clamped
    check_gather(gather, nan_pattern_image(g), idx, "NaN patterns, random rows")
    log(f"kernel checks: A at {CROP} x {ITERATIONS} rounds (random seeds), the wall at {ITERATIONS} and 112 "
        f"rounds, {n_odd} odd shape x input x iterations cases, a {big} grid with more active tiles a block "
        f"than its list holds, and a CUDA-graph replay, one launch each; A to the fixpoint on "
        + ", ".join(f"{f['input']} ({f['rounds']} rounds, the plain loop {f['plain_rounds']})" for f in fixpoints)
        + f"; B at [{IMG_ROWS}, 2] x {VOXELS} rows (NaN patterns); all bit-exact against their plain versions")


def per_round_propagate(lab, grow, iterations):
    """The first port's design of kernel A, the yardstick kept in
    csrc/propagate.cu (`khr_propagate_round`: one launch per round, 27
    guarded loads a cell)."""
    from khronos_tpu_torch.ops import native

    lib = native.load_library()
    X, Y, Z = lab.shape
    g = grow.view(torch.uint8)
    out, tmp = torch.empty_like(lab), torch.empty_like(lab)
    stream = torch.cuda.current_stream().cuda_stream
    src = lab
    for k in range(iterations):
        dst = out if (iterations - 1 - k) % 2 == 0 else tmp
        native.check(lib.khr_propagate_round(src.data_ptr(), g.data_ptr(), dst.data_ptr(), X, Y, Z, 1,
                                             int(k == 0), stream), "khr_propagate_round")
        src = dst
    return out


def propagate_bound(lab, rounds):
    """(µs, "bytes" or "operations"): the least time of kernel A's work. Bytes:
    labels and mask read once, labels written once. Operations: per round
    run and cell, the separable 3 x 3 x 3 max (6) and the mask select, 32-bit
    integer work held to the card's 32-bit rate outside the tensor cores."""
    t_bytes = (2 * lab.nbytes + lab.numel()) / HBM_BYTES_PER_S
    t_ops = rounds * 7 * lab.numel() / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e6, "bytes" if t_bytes >= t_ops else "operations"


def time_propagate(propagate, name, lab, grow, iterations) -> dict:
    """Kernel A on one input: checked, then timed in turns beside its plain
    version and the per-round yardstick (plain, per-round, kernel, kernel,
    per-round, plain)."""
    info = check_propagate(propagate, lab, grow, iterations, name)
    require(torch.equal(per_round_propagate(lab, grow, iterations),
                        propagate.propagate_labels_3d_plain(lab, grow, iterations)),
            f"the per-round kernel A differs from the plain version ({name})")
    p_ms, o_ms, k_ms = in_turns(lambda: propagate.propagate_labels_3d_plain(lab, grow, iterations),
                                lambda: per_round_propagate(lab, grow, iterations),
                                lambda: propagate.propagate_labels_3d_cuda(lab, grow, iterations))
    bound_us, bound_by = propagate_bound(lab, info["rounds"])
    return {"input": name, "us": k_ms * 1e3, "plain_us": p_ms * 1e3, "per_round_kernel_us": o_ms * 1e3,
            "per_round_kernel_us_per_round": o_ms * 1e3 / iterations, "bound_us": bound_us, "bound_by": bound_by,
            "launches_per_call": 1, "rounds": info["rounds"],
            "rounds_to_fixpoint": info["rounds_to_fixpoint"], "active_tiles": info["active_tiles"],
            "active_share": info["active_tiles"] / info["tiles"], "growable_share": float(grow.float().mean()),
            "max_abs_err": info["max_abs_err"]}


def phase_kernels(main):
    """Both kernels on the inputs the main path gave them: bit-exact against
    their plain versions, then timed beside them, the library call and the
    bound; A also on the dense input, and beside its per-round yardstick."""
    from khronos_tpu_torch.ops import gather, propagate

    frames = main["frames"]
    results = []
    # ---- A: label propagation ----
    captured = main["captured"]["propagate_labels_3d_cuda"]
    runs = []
    for i, (lab, grow, iterations) in enumerate(captured):
        require(tuple(lab.shape) == CROP and iterations == ITERATIONS, (lab.shape, iterations))
        runs.append(time_propagate(propagate, f"main path, frame {WARMUP + FRAMES + i}", lab, grow, iterations))
    dense = time_propagate(propagate, "dense", *dense_input(0), ITERATIONS)
    for r in runs + [dense]:
        log(f"kernel A on {r['input']}: {r['us']:.2f} us/call in 1 launch, {r['rounds']} rounds run "
            f"({r['rounds_to_fixpoint']} up to the first that changes nothing, or all), "
            f"{r['active_tiles']} active tiles ({r['active_share']:.4f} of them), growable share "
            f"{r['growable_share']:.6f}; per-round yardstick {r['per_round_kernel_us']:.2f} us = "
            f"{r['per_round_kernel_us_per_round']:.3f} us/round; "
            f"plain {r['plain_us']:.1f} us; bound {r['bound_us']:.3f} us by {r['bound_by']}")
    mean = lambda key: statistics.fmean(r[key] for r in runs)  # noqa: E731
    bound_us, bound_by = propagate_bound(lab, mean("rounds"))
    results.append({
        "name": "propagate_labels_3d", "route": "cuda", "source": "khronos_tpu_torch/csrc/propagate.cu",
        "replaces": "khronos_tpu/ops/pallas/propagate.py:49",
        "launches": main["launches"]["propagate"], "launches_per_frame": main["launches"]["propagate"] / frames,
        "match": True, "max_abs_err": max(r["max_abs_err"] for r in runs + [dense]),
        "ms": mean("us") * 1e-3, "plain_ms": mean("plain_us") * 1e-3,
        "bound_ms": bound_us * 1e-3, "bound_us": bound_us, "bound_by": bound_by,
        "library_ms": None, "shape": list(lab.shape), "iterations": ITERATIONS,
        "per_round_kernel_ms": mean("per_round_kernel_us") * 1e-3, "rounds": mean("rounds"),
        "active_share": mean("active_share"),
        "main_path_inputs": runs, "dense_input": dense,
    })
    # ---- B: row gather ----
    img, idx = main["captured"]["gather_rows_cuda"][-1]
    require(tuple(img.shape) == (IMG_ROWS, 2) and tuple(idx.shape) == (VOXELS,), (img.shape, idx.shape))
    err = check_gather(gather, img, idx, "main path")
    g = torch.Generator(device="cuda").manual_seed(1)
    err = max(err, check_gather(gather, nan_pattern_image(g), idx, "NaN patterns, projective rows"))
    p_ms, k_ms = in_turns(lambda: gather.gather_rows_plain(img, idx), lambda: gather.gather_rows_cuda(img, idx))
    lib_ms = time_ms(lambda: img[idx])  # the yardstick: one advanced-indexing call
    bytes_b = img.nbytes + idx.nbytes + idx.numel() * img.shape[1] * 4
    results.append({
        "name": "gather_rows", "route": "cuda", "source": "khronos_tpu_torch/csrc/gather.cu",
        "replaces": "khronos_tpu/ops/pallas/gather_probe.py:32",
        "launches": main["launches"]["gather"], "launches_per_frame": main["launches"]["gather"] / frames,
        "match": True, "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
        "bound_ms": bytes_b / HBM_BYTES_PER_S * 1e3, "bound_us": bytes_b / HBM_BYTES_PER_S * 1e6,
        "bound_by": "bytes", "library_ms": lib_ms, "shape": [list(img.shape), list(idx.shape)],
    })
    for r in results:
        lib = "none" if r["library_ms"] is None else f"{r['library_ms'] * 1e3:.1f} us"
        log(f"kernel {r['name']}: bit-exact on the main path's inputs, {r['ms'] * 1e3:.2f} us "
            f"(plain {r['plain_ms'] * 1e3:.1f} us, library {lib}), bound {r['bound_us']:.3f} us "
            f"by {r['bound_by']}, {r['launches_per_frame']:.1f} launches/frame")
    return results


# ---- backend_path: object extraction and the backend over a drifted run ----

BACKEND_SECONDS = 24.0  # 240 frames at 10 fps, two orbits: every frame after 12 s revisits
DRIFT_RATE = 0.1  # odometry random walk (SyntheticSequence.odometry_pose)
BACKEND_CONFIG = {"lcd": {"type": "GtLoopClosure", "min_time_gap": 8.0, "max_distance": 1.0}}
# the card against the port's CPU path, with the tolerances that
# tests/test_torch_backend.py and tests/test_torch_extraction.py state
AGENT_ATOL = VERTEX_ATOL = 1e-3  # m
EXTRACT_WEIGHT_SHARE, EXTRACT_TSDF_ATOL, EXTRACT_TRI_RTOL = 0.999, 1e-5, 0.01
# the slice's device functions: (module, function)
DEVICE_FUNCTIONS = (
    ("active_window.object_extraction", "_reconstruct_device"),
    ("active_window.object_extraction", "_mesh_small_grid"),
    ("backend.factor_graph", "_linearize_and_solve"),
    ("backend.factor_graph", "_weighted_error"),
    ("backend.factor_graph", "_apply_delta"),
    ("backend.factor_graph", "_between_errors"),
    ("backend.deformation", "_deform_points"),
)


def _size(args) -> int:
    """Elements in a call's tensor and array arguments (lists and tuples included)."""
    total = 0
    for a in args:
        if torch.is_tensor(a) or isinstance(a, np.ndarray):
            total += a.size if isinstance(a, np.ndarray) else a.numel()
        elif isinstance(a, (list, tuple)):
            total += _size(a)
        elif hasattr(a, "__dataclass_fields__"):
            total += _size(list(vars(a).values()))
    return total


def _shapes(args) -> list:
    """The shapes of a call's tensor arguments, for the report."""
    out = []
    for a in args:
        if torch.is_tensor(a) or isinstance(a, np.ndarray):
            out.append(list(a.shape))
        elif isinstance(a, list):
            out.append(f"{len(a)} items")
        elif hasattr(a, "__dataclass_fields__"):
            out.append({k: list(v.shape) for k, v in vars(a).items() if torch.is_tensor(v)})
    return out


class DeviceCalls:
    """Counts the calls of a slice's device functions while installed and
    keeps the arguments of the largest call of each, to time it alone.
    `key(name)` names the entry a call counts under (default: the name)."""

    def __init__(self, functions=DEVICE_FUNCTIONS, key=None):
        import importlib

        key = key or (lambda name: name)
        self.calls = {}
        self.largest = {}
        self.counting = True  # off while a check calls them
        self.first_ms = {}  # the first call of each, synchronized: first-use setup included
        self._installed = []
        for mod, name in functions:
            module = importlib.import_module(f"khronos_tpu_torch.{mod}")
            fn = getattr(module, name)

            def counted(*args, _fn=fn, _name=name, **kwargs):
                if not self.counting:
                    return _fn(*args, **kwargs)
                k = key(_name)
                self.calls[k] = self.calls.get(k, 0) + 1
                size = _size(args)
                if size >= self.largest.get(k, (-1, None))[0]:
                    self.largest[k] = (size, args, kwargs)
                if k in self.first_ms:
                    return _fn(*args, **kwargs)
                ts = time.perf_counter()
                out = _fn(*args, **kwargs)
                torch.cuda.synchronize()
                self.first_ms[k] = (time.perf_counter() - ts) * 1e3
                return out

            setattr(module, name, counted)
            self._installed.append((module, name, fn))

    def uninstall(self) -> None:
        for module, name, fn in self._installed:
            setattr(module, name, fn)
        self._installed = []


def drive_window_and_backend(dataset, device, before_finalize=None) -> dict:
    """The port's path from frames to a scene graph: every frame through
    ActiveWindow.spin_once; every output through finalize_output (the object
    extraction) and Backend.add_output with its ground-truth pose; then
    finish_mapping, finish_processing and get_dsg. Outputs are recorded as
    the backend received them, for replays."""
    from khronos_tpu_torch.active_window.active_window import ActiveWindow, ActiveWindowConfig
    from khronos_tpu_torch.backend.backend import Backend, BackendConfig
    from khronos_tpu_torch.config import build
    from khronos_tpu_torch.data import synthetic as syn

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    items = list(dataset)  # rendered up front: the timed loop holds no rendering
    sync()
    render_s = time.perf_counter() - t0
    aw = ActiveWindow(build(ActiveWindowConfig, bench_config()), dataset.camera, syn.default_label_space(),
                      device=device)
    aw.defer_object_extraction = True  # the backend stage extracts, in finalize_output
    be = Backend(build(BackendConfig, BACKEND_CONFIG), device=device)
    static_ms = []  # (ms, extracted) per static track
    extract_static = aw.object_extractor._extract_static

    def timed_static(track, buffer):
        ts = time.perf_counter()
        obj = extract_static(track, buffer)
        static_ms.append(((time.perf_counter() - ts) * 1e3, obj is not None))
        return obj

    aw.object_extractor._extract_static = timed_static
    solves = []  # (ms, iterations, nodes, between factors) per Backend.optimize
    optimize = be.optimize

    def timed_optimize():
        ts = time.perf_counter()
        res = optimize()
        solves.append(((time.perf_counter() - ts) * 1e3, res.iterations, be.graph.num_nodes, be.graph.num_between))
        return res

    be.optimize = timed_optimize
    records, finalize_ms, add_ms = [], [], []

    def hand_off(out, gt):
        if before_finalize is not None and out.pending_tracks:
            before_finalize(aw, out)
        ts = time.perf_counter()
        had_tracks = bool(out.pending_tracks)
        aw.finalize_output(out)
        if had_tracks:
            finalize_ms.append((time.perf_counter() - ts) * 1e3)
        records.append((copy.deepcopy(out), gt))
        ts = time.perf_counter()
        be.add_output(out, gt_pose=gt)
        add_ms.append((time.perf_counter() - ts) * 1e3)

    spin_s = 0.0
    for frame, gt in items:
        ts = time.perf_counter()
        out = aw.spin_once(frame)
        spin_s += time.perf_counter() - ts
        if out is not None:
            hand_off(out, gt)
    ts = time.perf_counter()
    sync()
    spin_s += time.perf_counter() - ts
    ts = time.perf_counter()
    last = aw.finish_mapping(items[-1][0])  # extracts inline
    finish_mapping_ms = (time.perf_counter() - ts) * 1e3
    hand_off(last, items[-1][1])
    ts = time.perf_counter()
    be.finish_processing()
    finish_processing_ms = (time.perf_counter() - ts) * 1e3
    ts = time.perf_counter()
    dsg = be.get_dsg()
    get_dsg_ms = (time.perf_counter() - ts) * 1e3
    return {"aw": aw, "backend": be, "dsg": dsg, "records": records, "frames": len(items),
            "render_s": render_s, "spin_s": spin_s, "finalize_ms": finalize_ms, "static_ms": static_ms,
            "add_output_ms": add_ms, "solves": solves, "finish_mapping_ms": finish_mapping_ms,
            "finish_processing_ms": finish_processing_ms, "get_dsg_ms": get_dsg_ms}


def replay_backend(records, device):
    """A new Backend on `device` fed the recorded outputs; (backend, dsg)."""
    from khronos_tpu_torch.backend.backend import Backend, BackendConfig
    from khronos_tpu_torch.config import build

    be = Backend(build(BackendConfig, BACKEND_CONFIG), device=device)
    for out, gt in records:
        be.add_output(copy.deepcopy(out), gt_pose=gt)
    be.finish_processing()
    return be, be.get_dsg()


def backend_summary(be, dsg) -> dict:
    objs = list(dsg.objects.values())
    return {"loop_closures": len(be.loop_closures), "solves": be.num_optimizations,
            "skipped_consistent": be.optimizes_skipped_consistent, "geometry_epoch": dsg.opt_epoch,
            "nodes": be.graph.num_nodes, "between_factors": be.graph.num_between,
            "objects": len(objs), "static_objects": sum(not o.is_dynamic for o in objs),
            "static_with_mesh": sum((not o.is_dynamic) and len(o.mesh_faces) > 0 for o in objs),
            "dynamic_objects": sum(o.is_dynamic for o in objs),
            "dynamic_with_trajectory": sum(len(o.trajectory_positions) > 1 for o in objs),
            "object_triangles": sum(len(o.mesh_faces) for o in objs),
            "mesh_vertices": dsg.mesh.num_vertices, "mesh_triangles": dsg.mesh.num_faces,
            "outlier_mask": [bool(x) for x in be._opt_result.outlier_mask],
            "validated_merges": [(p.from_id, p.into_id) for p in be.validated_merges()],
            "proposed_merges": len(be.proposed_merges)}


def scene_arrays(dsg) -> dict:
    from khronos_tpu_torch.stm import serialization

    return serialization.scene_graph_arrays(dsg)


def check_extraction_card_vs_cpu(camera, config, checks, calls):
    """A hook for drive_window_and_backend: before the first outputs'
    extraction, rebuild the grids of their static tracks (at most two) with
    MeshObjectExtractor on the card and on the CPU, from the same buffered
    frames: weights and confidences equal on nearly every voxel, TSDF within
    EXTRACT_TSDF_ATOL where they are, triangle counts within EXTRACT_TRI_RTOL."""
    from khronos_tpu_torch.active_window import object_extraction as oe

    extractors = {dev: oe.MeshObjectExtractor(config, camera, device=dev) for dev in ("cuda", "cpu")}

    def hook(aw, out):
        calls.counting = False
        try:
            compare(aw, out)
        finally:
            calls.counting = True

    def compare(aw, out):
        for track in out.pending_tracks:
            if len(checks) >= 2 or track.is_dynamic:
                continue
            if track.confidence(config.min_num_observations) < config.min_object_allocation_confidence:
                continue
            got = {}
            for dev, ext in extractors.items():
                rec = ext.reconstruct(track, aw.frame_buffer)
                if rec is None:
                    break
                _, _, origin, voxel, (tsdf, weight, conf) = rec
                meta = oe._mesh_small_grid(tsdf, weight, origin, voxel, config.grid_size)[-1]
                got[dev] = [x.cpu().numpy() for x in (tsdf, weight, conf, meta)]
            if len(got) < 2:
                continue
            (tg, wg, cg, mg), (tc, wc, cc, mc) = got["cuda"], got["cpu"]
            same = (wg == wc) & (cg == cc)
            tsdf_err = float(np.abs(tg - tc)[same].max(initial=0.0))
            tris = (int(mg[0]), int(mc[0]))
            require(same.mean() >= EXTRACT_WEIGHT_SHARE, f"extraction: weights agree on {same.mean():.5f} of voxels")
            require(tsdf_err <= EXTRACT_TSDF_ATOL, f"extraction: tsdf differs by {tsdf_err}")
            require(abs(tris[0] - tris[1]) <= EXTRACT_TRI_RTOL * max(tris[1], 1), f"extraction: triangles {tris}")
            checks.append({"track": track.track_id, "observations": len(track.observations),
                           "voxels_equal_share": float(same.mean()), "tsdf_max_abs_err": tsdf_err,
                           "triangles_card": tris[0], "triangles_cpu": tris[1]})

    return hook


def time_device_function(name, args, kwargs=None, functions=DEVICE_FUNCTIONS) -> dict:
    """One of a slice's device functions on the largest inputs the path gave
    it: host wall time a call (with a synchronize; the path pays this), device
    kernel time a call and kernels a call (torch.profiler), peak device
    memory above what was allocated before the call."""
    import importlib

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    mod = next(m for m, n in functions if n == name)
    fn = getattr(importlib.import_module(f"khronos_tpu_torch.{mod}"), name)
    kwargs = kwargs or {}
    fn(*args, **kwargs)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn(*args, **kwargs)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    wall = []
    for _ in range(5):
        ts = time.perf_counter()
        fn(*args, **kwargs)
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - ts) * 1e3)
    reps = 3
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn(*args, **kwargs)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return {"wall_ms": statistics.median(wall), "device_ms": sum(e.self_device_time_total for e in kernels) * 1e-3 / reps,
            "kernels_per_call": sum(e.count for e in kernels) / reps, "peak_extra_mib": peak / 2**20}


def device_function_bound(name, args) -> tuple:
    """(ms, "bytes" or "operations") for the two larger device functions; the
    bytes each input needs once and each output once, the operations at the
    card's 32-bit rate outside the tensor cores."""
    if name == "_reconstruct_device":
        frames, camera, G = args[0], args[1], args[6]
        K, cells = len(frames), G ** 3
        # each frame's depth and object id of the pixels the cells project to
        # (at most the whole image), the pose; tsdf, weight, confidence out
        read = K * (min(camera.height * camera.width, cells) * 8 + 48)
        write = 3 * cells * 4
        ops = K * cells * 40  # projection, band tests and the running means, a cell and frame
        t_bytes, t_ops = (read + write) / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    elif name == "_linearize_and_solve":
        node_R, f = args[0], args[2]
        n, factors = 6 * node_R.shape[0], f.b_i.shape[0] + f.p_i.shape[0]
        # node poses and factors in, delta and error out; the Cholesky of the
        # dense H and its two triangular solves
        t_bytes = (node_R.shape[0] * 12 * 4 + factors * 26 * 4 + n * 4 + 4) / HBM_BYTES_PER_S
        t_ops = (n ** 3 / 3 + 2 * n ** 2) / FP32_OPS_PER_S
    else:
        return None, None
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def phase_backend_path(card_name):
    """Object extraction and the backend on the card, at the bench point, over
    a drifted office run; held against the port's CPU path and a second card
    run of the backend."""
    from khronos_tpu_torch.data.datasets import SyntheticDataset
    from khronos_tpu_torch.ops import gather, propagate
    from khronos_tpu_torch.stm import serialization
    from khronos_tpu_torch.utils.timing import TimingRecorder

    dataset = SyntheticDataset("office", duration=BACKEND_SECONDS, fps=10.0, height=480, width=640,
                               drift_rate=DRIFT_RATE, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    from khronos_tpu_torch.active_window.object_extraction import MeshObjectExtractorConfig
    from khronos_tpu_torch.config import build

    ext_checks = []
    calls = DeviceCalls()
    hook = check_extraction_card_vs_cpu(dataset.camera, build(MeshObjectExtractorConfig, {}), ext_checks, calls)
    propagate.launches = 0
    gather.launches = 0
    recorder = TimingRecorder.instance()
    recorder.reset()
    t0 = time.perf_counter()
    run = drive_window_and_backend(dataset, "cuda", before_finalize=hook)
    wall_s = time.perf_counter() - t0
    calls.uninstall()
    # host time by the backend stage's Timer spans (children nest in parents)
    spans = {r["name"]: {"calls": r["n_samples"], "total_ms": r["total_s"] * 1e3, "max_ms": r["max_s"] * 1e3}
             for r in recorder.stats() if r["name"].startswith(("backend/", "object_extraction/"))}
    launches = {"propagate": propagate.launches, "gather": gather.launches}
    peak = torch.cuda.max_memory_allocated()
    be, dsg, n = run["backend"], run["dsg"], run["frames"]
    card = backend_summary(be, dsg)
    require(n == int(BACKEND_SECONDS * 10), f"{n} frames")
    # the fused step launches A and B once a frame (finish_mapping runs none)
    require(launches == {"propagate": n, "gather": n}, f"not one launch a frame each: {launches}")
    require(card["loop_closures"] >= 1, "no loop closure")
    require(card["solves"] >= 1 and card["geometry_epoch"] > 0, f"no solve moved geometry: {card}")
    require(card["static_with_mesh"] >= 1, f"no static object with a mesh: {card}")
    require(card["dynamic_with_trajectory"] >= 1, f"no dynamic object with a trajectory: {card}")
    require(len(ext_checks) == 2, f"extraction compared on {len(ext_checks)} static tracks")
    raw = be.mesh_acc.build()
    require(raw.num_vertices == dsg.mesh.num_vertices > 0, (raw.num_vertices, dsg.mesh.num_vertices))
    moved = float(np.abs(dsg.mesh.vertices - raw.vertices).max())
    require(moved > 0.0, "the deformed background mesh equals the raw one")
    require(all(np.isfinite(a).all() for a in (dsg.mesh.vertices, dsg.agent_positions())), "non-finite output")
    # save, and read back what was written
    out_dir = Path(__file__).resolve().parent / "build" / "backend_path"
    ts = time.perf_counter()
    be.save(str(out_dir))
    save_ms = (time.perf_counter() - ts) * 1e3
    saved = scene_arrays(serialization.load_scene_graph(str(out_dir / "dsg.npz")))
    want = scene_arrays(dsg)
    require(saved.keys() == want.keys() and all(np.array_equal(saved[k], want[k]) for k in want),
            "dsg.npz does not load back equal")

    # the same recorded outputs: the port's backend on the CPU, and again on the card
    ts = time.perf_counter()
    cpu_be, cpu_dsg = replay_backend(run["records"], "cpu")
    cpu_s = time.perf_counter() - ts
    cpu = backend_summary(cpu_be, cpu_dsg)
    for key in ("loop_closures", "solves", "objects", "mesh_vertices", "outlier_mask", "validated_merges",
                "geometry_epoch"):
        require(card[key] == cpu[key], f"card and CPU differ in {key}: {card[key]} vs {cpu[key]}")
    agent_err = float(np.abs(dsg.agent_positions() - cpu_dsg.agent_positions()).max())
    vertex_err = float(np.abs(dsg.mesh.vertices - cpu_dsg.mesh.vertices).max())
    require(agent_err <= AGENT_ATOL and vertex_err <= VERTEX_ATOL, f"card vs CPU: agents {agent_err}, vertices {vertex_err}")
    again_be, again_dsg = replay_backend(run["records"], "cuda")
    again = scene_arrays(again_dsg)
    require(backend_summary(again_be, again_dsg) == card, "a second card run of the backend differs in its counts")
    require(again.keys() == want.keys() and all(np.array_equal(again[k], want[k]) for k in want),
            "a second card run of the backend is not bit-identical")

    # the slice's device functions alone, on the largest inputs the path gave them
    functions = {}
    for _, name in DEVICE_FUNCTIONS:
        require(name in calls.largest, f"{name} never ran on the path")
        args = calls.largest[name][1]
        info = time_device_function(name, args)
        info["calls"] = calls.calls[name]
        info["shapes"] = _shapes(args)
        info["first_call_ms"] = calls.first_ms[name]
        info["bound_ms"], info["bound_by"] = device_function_bound(name, args)
        functions[name] = info

    solves = run["solves"]
    static_ok = [ms for ms, ok in run["static_ms"] if ok]
    result = {
        "frames": n, "render_s": run["render_s"], "wall_s": wall_s,
        "aw_fps": n / run["spin_s"], "aw_ms_per_frame": run["spin_s"] / n * 1e3,
        "outputs": len(run["records"]),
        "finalize_ms": {"calls_with_tracks": len(run["finalize_ms"]),
                        "median": statistics.median(run["finalize_ms"]), "max": max(run["finalize_ms"]),
                        "total": sum(run["finalize_ms"])},
        "static_extraction_ms": {"tracks": len(run["static_ms"]), "extracted": len(static_ok),
                                 "median_extracted": statistics.median(static_ok),
                                 "total": sum(ms for ms, _ in run["static_ms"])},
        "add_output_ms": {"median": statistics.median(run["add_output_ms"]), "max": max(run["add_output_ms"])},
        "solves": [{"ms": ms, "iterations": it, "nodes": nn, "between_factors": nf} for ms, it, nn, nf in solves],
        "finish_mapping_ms": run["finish_mapping_ms"], "finish_processing_ms": run["finish_processing_ms"],
        "get_dsg_ms": run["get_dsg_ms"], "save_ms": save_ms, "peak_mib": peak / 2**20,
        "launches": launches, "host_spans": spans, "summary": card, "cpu_replay_s": cpu_s,
        "card_vs_cpu": {"agent_max_abs_err": agent_err, "vertex_max_abs_err": vertex_err},
        "deformation_max_move_m": moved, "extraction_card_vs_cpu": ext_checks,
        "device_functions": functions,
    }
    log(f"backend_path ({card_name}): {n} frames at 480x640 (drift {DRIFT_RATE}), active window {result['aw_fps']:.2f} frames/s "
        f"({result['aw_ms_per_frame']:.2f} ms/frame host time of spin_once), {result['outputs']} outputs")
    log(f"backend_path: finalize_output with tracks median {result['finalize_ms']['median']:.2f} ms "
        f"(max {result['finalize_ms']['max']:.2f}); static extraction {len(static_ok)} of "
        f"{len(run['static_ms'])} tracks extracted, median {result['static_extraction_ms']['median_extracted']:.2f} "
        f"ms each; add_output median {result['add_output_ms']['median']:.2f} ms, max "
        f"{result['add_output_ms']['max']:.2f} ms")
    log("backend_path: host ms by span (calls, total, max): " + ", ".join(
        f"{k} {v['calls']} / {v['total_ms']:.1f} / {v['max_ms']:.1f}" for k, v in spans.items()))
    log("backend_path: solves " + ", ".join(f"{s['ms']:.1f} ms / {s['iterations']} iterations "
                                             f"({s['nodes']} nodes, {s['between_factors']} factors)"
                                             for s in result["solves"]))
    log(f"backend_path: get_dsg {run['get_dsg_ms']:.2f} ms, save {save_ms:.1f} ms; {card['loop_closures']} loop "
        f"closures, {card['objects']} objects ({card['static_objects']} static, {card['dynamic_objects']} dynamic), "
        f"{card['mesh_triangles']} background triangles, {card['object_triangles']} object triangles; "
        f"peak device memory {peak / 2**20:.1f} MiB; launches {launches}")
    log(f"backend_path: card == CPU (counts, outlier masks, merges; agents {agent_err:.3g} m, vertices "
        f"{vertex_err:.3g} m; CPU replay {cpu_s:.1f} s); a second card run bit-identical; extraction card vs CPU "
        + "; ".join(f"track {c['track']}: {c['voxels_equal_share']:.5f} of voxels equal, tsdf {c['tsdf_max_abs_err']:.3g}, "
                    f"triangles {c['triangles_card']} / {c['triangles_cpu']}" for c in ext_checks))
    for name, info in functions.items():
        bound = "" if info["bound_ms"] is None else f", bound {info['bound_ms'] * 1e3:.3f} us by {info['bound_by']}"
        log(f"device function {name}: {info['calls']} calls (the first {info['first_call_ms']:.1f} ms), "
            f"{info['wall_ms']:.3f} ms a call on the host clock, "
            f"{info['device_ms']:.3f} ms device kernel time in {info['kernels_per_call']:.0f} kernels, "
            f"peak +{info['peak_extra_mib']:.1f} MiB{bound}; largest inputs {info['shapes']}")
    return result


# ---- pipeline_path: the office run users start, through the port's run.main ----

PIPELINE_CONFIG = ROOT / "configs" / "office_synthetic.yaml"
PIPELINE_OVERRIDES = ("dataset.drift_rate=0.1",)
CHAIR = np.asarray([3.8, -2.6, 0.35])  # the office's chair, removed half-way through (data/synthetic.py)
CPU_REPLAY_BUDGET_S = 90.0  # the CPU replay stops after the first rebuild after a loop closure past this
MAP_FLOAT_ATOL = 0.0  # the change-detection path copies map floats from its inputs: card == CPU exactly
CD_FUNCTIONS = (
    ("changes.ray_verificator", "_build_index_device"),
    ("changes.ray_verificator", "_query_device"),
    ("changes.ray_verificator", "_merge_sorted_device"),
    ("changes.ray_verificator", "_touched_cells_device"),
    ("changes.change_detector", "_scan_device"),
    ("changes.detectors", "_votes_device"),
    ("eval.evaluators", "min_distances"),
)
PLACES_FUNCTIONS = (
    ("stm.places", "_candidate_field"),
    ("stm.places", "_room_blobs"),
)
PIPELINE_FUNCTIONS = CD_FUNCTIONS + PLACES_FUNCTIONS
PLACES_CALLS = ("add_mesh_delta", "update_local", "reset_occupancy", "refresh_rooms", "extract")
PLACES_SPANS = ("pipeline/places_incremental", "pipeline/places", "pipeline/places_reset", "places/window_cells",
                "places/candidates", "places/edges", "places/rooms")
RESULT_FILES = ("background_mesh.csv", "static_objects.csv", "dynamic_objects.csv", "changes.csv",
                "map_timestamps.txt")
# The map quality of the same command through the JAX package on the CPU
# (`python -m khronos_tpu.run --config configs/office_synthetic.yaml
# dataset.drift_rate=0.1`, its results/*.csv): (CSV, column, value, slack).
# The reference's own runs spread: which output a finished track or a mesh
# delta lands in follows when its host pulls land, and under drift that
# moves the deformed map. Five runs on the CPU gave accuracy@0.2 0.94055,
# 0.9415, 0.9428, 0.94025, and 0.9417 with stats_batch_frames=1;
# completeness@0.2 0.99496, 0.99748, 0.9984891216760677, 0.9978847703464948,
# 0.99598; f1@0.2 0.96699, 0.96868, 0.9698457930917915, 0.9682104358001398,
# 0.96808; objects P and R 1.0 and changes P 0.5 R 1.0 in each. Each mesh
# value is the lowest run's and its slack the runs' range (the band widened
# below by its own width); the object and change slacks are the standing
# ones. The reference's own earliest schedule (every pull landed when
# polled, which the port follows) gave 0.9394 / 0.99485731572048 /
# 0.9663336462963893 twice; the port 0.93975 / 0.995664011293738 /
# 0.966899329190898 on the CPU and 0.93975 / 0.9949581526671373 /
# 0.9665663761016975 on the card.
REFERENCE_QUALITY = (
    ("background_mesh.csv", "accuracy@0.2", 0.94025, 0.00255),
    ("background_mesh.csv", "completeness@0.2", 0.99496, 0.0035291216760677),
    ("background_mesh.csv", "f1@0.2", 0.96699, 0.0028557930917915),
    ("static_objects.csv", "precision", 1.0, 0.2),
    ("static_objects.csv", "recall", 1.0, 0.2),
    ("changes.csv", "change_precision", 0.5, 0.25),
    ("changes.csv", "change_recall", 1.0, 0.5),
)
# The same for the apartment and open-set configs, with no override. Each
# value is the lowest of the JAX package's CPU runs of the command, and each
# slack the width of their range (the band of the runs, widened below by its
# own width) where the port's runs lie inside that band. Runs of `python -m
# khronos_tpu.run --config configs/apartment_synthetic.yaml`: accuracy@0.2
# 0.99895, 0.99895, 0.99915; completeness@0.2 1.0 each; f1@0.2
# 0.9994747242302209 twice, 0.9995748192982017; static objects P 1.0, R 1.0
# each; 13 extractor calls each. The port's apartment mesh lies just under
# that band (card 0.99875 / 0.9984092716736734 / 0.9985796067716054 in each
# of three runs, CPU 0.99895 / 0.9984092716736734 / 0.998679562643414: an
# open fault, ROADMAP.md), 0.0002 / 0.0016 / 0.0009 under the lowest run;
# so each mesh slack is 0.003, the band's width (0.0002 / 0 / 0.0001) plus
# the largest such deficit, with room on both sides. Of
# configs/openset_synthetic.yaml: accuracy@0.2 0.9998, completeness@0.2
# 0.9989853724528621, f1@0.2 0.9993925202211036, static objects P 1.0 and R
# 0.3333333333333333, 3 extractor calls, in each of three runs.
APARTMENT_QUALITY = (
    ("background_mesh.csv", "accuracy@0.2", 0.99895, 0.003),
    ("background_mesh.csv", "completeness@0.2", 1.0, 0.003),
    ("background_mesh.csv", "f1@0.2", 0.9994747242302209, 0.003),
    ("static_objects.csv", "precision", 1.0, 0.0),
    ("static_objects.csv", "recall", 1.0, 0.0),
)
OPENSET_QUALITY = (
    ("background_mesh.csv", "accuracy@0.2", 0.9998, 0.0),
    ("background_mesh.csv", "completeness@0.2", 0.9989853724528621, 0.0),
    ("background_mesh.csv", "f1@0.2", 0.9993925202211036, 0.0),
    ("static_objects.csv", "precision", 1.0, 0.0),
    ("static_objects.csv", "recall", 0.3333333333333333, 0.0),
)
CD_SPANS = ("pipeline/change_detection", "change_detection/update_verificator", "change_detection/objects",
            "change_detection/background", "pipeline/map_update", "ray_verificator/merge_delta")


def changes_record(changes) -> tuple:
    """A copy of a Changes state: ObjectChange fields by node id, background states."""
    return ({k: dataclasses.astuple(v) for k, v in changes.object_changes.items()},
            changes.background_states.copy())


def changes_csv(record, directory) -> tuple:
    """The CSV bytes the port's Changes.save writes for a recorded state."""
    from khronos_tpu_torch.changes.change_state import Changes, ObjectChange

    ch = Changes()
    ch.object_changes = {k: ObjectChange(*v) for k, v in record[0].items()}
    ch.background_states = record[1]
    ch.save(str(directory))
    return tuple((Path(directory) / n).read_bytes() for n in ("object_changes.csv", "background_changes.csv"))


def map_arrays(stm, n=None) -> dict:
    """The first n snapshots of a 4D map: each one's scene-graph arrays as
    materialised, its keep mask and union chunk, and the stamps."""
    from khronos_tpu_torch.stm import serialization

    n = stm.num_snapshots if n is None else n
    out = {"stamps_ns": np.asarray(stm.stamps_ns[:n], np.int64)}
    for i in range(n):
        for k, v in serialization.scene_graph_arrays(stm.snapshots[i]).items():
            out[f"{i}/{k}"] = np.asarray(v)
        store = stm._stores[i]
        out[f"{i}/keep"] = store["keep"]
        out[f"{i}/union"] = np.asarray([store["u"], store["L"], store["F"]], np.int64)
    return out


def compare_arrays(got, want, what) -> float:
    """Integer arrays bit for bit, float arrays within MAP_FLOAT_ATOL (the
    same NaN pattern); returns the largest float difference."""
    require(got.keys() == want.keys(), f"{what}: different keys")
    worst = 0.0
    for k, b in want.items():
        a = got[k]
        require(a.dtype == b.dtype and a.shape == b.shape, f"{what}: {k} is {a.dtype}{a.shape}, want {b.dtype}{b.shape}")
        if a.dtype.kind == "f":
            nan = np.isnan(b)
            require(np.array_equal(np.isnan(a), nan), f"{what}: {k} NaN pattern")
            err = float(np.abs(a[~nan].astype(np.float64) - b[~nan]).max(initial=0.0))
            require(err <= MAP_FLOAT_ATOL, f"{what}: {k} differs by {err}")
            worst = max(worst, err)
        else:
            require(np.array_equal(a, b), f"{what}: {k} differs")
    return worst


def replay_cd(config, requests, device, stop=None):
    """A fresh SequentialChangeDetector + Reconciler + SpatioTemporalMap on
    `device` fed recorded change-detection requests in order (the body of
    KhronosPipeline.run_change_detection_on); `stop(i, seconds)` ends the
    replay after pass i. Returns (detector, map, per-pass Changes records,
    seconds)."""
    from khronos_tpu_torch.changes.detectors import SequentialChangeDetector
    from khronos_tpu_torch.changes.reconciler import Reconciler
    from khronos_tpu_torch.stm.spatio_temporal_map import SpatioTemporalMap

    det = SequentialChangeDetector(copy.deepcopy(config.change_detection), device=device)
    rec = Reconciler(copy.deepcopy(config.reconciler), device=device)
    stm = SpatioTemporalMap()
    passes = []
    t0 = time.perf_counter()
    for i, req in enumerate(requests):
        dsg, stamp_ns, had_lc, merges = copy.deepcopy(req)
        changes = det.detect_changes(dsg, had_lc, merges)
        canonical = dsg.mesh.clone(share_arrays=True)
        stm.update(rec.reconcile(dsg, changes, merges), stamp_ns, canonical_mesh=canonical)
        passes.append(changes_record(changes))
        if stop is not None and stop(i, time.perf_counter() - t0):
            break
    return det, stm, passes, time.perf_counter() - t0


def query_candidates(points, cell_start, num_cells, block_size, max_candidates) -> int:
    """Candidate rays a query reads for these points (data-dependent work)."""
    from khronos_tpu_torch import true_div
    from khronos_tpu_torch.changes.ray_verificator import _hash_cells_dev

    lin = _hash_cells_dev(torch.floor(true_div(points, block_size)).to(torch.int32), num_cells).long()
    return int((cell_start[lin + 1] - cell_start[lin]).clamp(0, max_candidates).sum())


def cd_function_bound(name, args, kwargs, out) -> tuple:
    """(ms, "bytes" or "operations"): each input read once and each output
    written once over the card's memory rate, against the operations over its
    32-bit rate outside the tensor cores. The query counts only the candidate
    rays its points read."""
    def nbytes(xs):
        return sum(x.nbytes for x in xs if isinstance(x, np.ndarray)) + sum(
            x.numel() * x.element_size() for x in xs if torch.is_tensor(x))

    outs = out if isinstance(out, (tuple, list)) else (out,)
    if name == "_query_device":
        points, _, cell_start, _, num_cells, block, tol, _, _, num_bins, k = args
        n = query_candidates(points, cell_start, num_cells, block, k)
        P = points.shape[0]
        read = P * (12 + 4 + 8) + n * (4 + 32)  # points, tolerances, cell starts; per candidate a ray id and row
        t_bytes = (read + P * num_bins * 2 * 4) / HBM_BYTES_PER_S
        ops = n * 45  # a candidate's geometry: ray length, direction, depth, radial distance, the tests
    else:
        t_bytes = (nbytes(args) + nbytes(kwargs.values()) + nbytes(outs)) / HBM_BYTES_PER_S
        if name == "_build_index_device":
            ops = args[0].shape[0] * args[5] * 40  # a (ray, step): the march on 3 axes, the hash
        elif name == "min_distances":
            ops = len(args[0]) * len(args[1]) * 9  # a pair: 3 differences, 3 products, 2 sums, the min
        elif name == "_scan_device":
            ops = args[0].numel() * 15  # a (point, bin, class): masks, window sums, fractions, tests
        else:
            ops = 2 * sum(x.numel() for x in args if torch.is_tensor(x))  # index arithmetic
    t_ops = ops / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def layer_record(layer) -> tuple:
    """A places layer as arrays: positions, clearances, room ids, edges."""
    n = layer.nodes
    return (np.asarray([x.position for x in n], np.float32).reshape(-1, 3),
            np.asarray([x.distance for x in n], np.float64), np.asarray([x.room_id for x in n], np.int64),
            np.asarray([(int(a), int(b), float(c)) for a, b, c in layer.edges], np.float64).reshape(-1, 3))


def layers_equal(a, b) -> bool:
    return all(x.dtype == y.dtype and np.array_equal(x, y) for x, y in zip(a, b))


def replay_places(config, calls, device):
    """A fresh PlacesExtractor on `device` fed the recorded calls in order;
    (extractor, the layer after each call, seconds)."""
    from khronos_tpu_torch.stm.places import PlacesExtractor

    ex = PlacesExtractor(copy.deepcopy(config), device=device)
    layers = []
    t0 = time.perf_counter()
    for name, args, kwargs in calls:
        out = getattr(ex, name)(*args, **kwargs)
        layers.append(layer_record(out if name == "extract" else ex.layer))
    return ex, layers, time.perf_counter() - t0


def room_grid_of(args):
    """The (labels, growable) grid one _room_blobs call hands kernel A."""
    from khronos_tpu_torch.stm import places

    grids = []
    fixpoint = places.propagate_labels_3d_fixpoint
    places.propagate_labels_3d_fixpoint = lambda lab, grow: grids.append((lab, grow)) or fixpoint(lab, grow)
    try:
        places._room_blobs(*args)
    finally:
        places.propagate_labels_3d_fixpoint = fixpoint
    return grids[0]


def places_function_bound(name, args, rounds=None) -> tuple:
    """(ms, "bytes" or "operations") of the places device functions: the
    cell indices read once and the outputs written once, against the
    operations a cell: _candidate_field's chamfer (per round and axis two
    neighbour minima, an add, a minimum) and maxima test; _room_blobs' ball
    taps (a multiply-add each), the floor closing's two pools and cumsum,
    and 7 a round of the components (this run's rounds)."""
    from khronos_tpu_torch.stm import places

    cells = math.prod(args[2] if name == "_room_blobs" else args[1])
    if name == "_candidate_field":
        iterations = args[3]
        t_bytes = (args[0].numel() * 8 + cells * 5) / HBM_BYTES_PER_S
        ops = cells * (iterations * 3 * 4 + 12)
    else:
        _, ball = places._ball(args[3], args[4])
        f = args[5]
        t_bytes = (args[0].numel() * 8 + args[1].numel() + cells * 4) / HBM_BYTES_PER_S
        ops = cells * (2 * int(ball.sum()) + 2 * (2 * f + 1) ** 2 + 1 + 7 * rounds)
    t_ops = ops / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def read_result(path) -> dict:
    """The last row of a result CSV, as floats where they parse."""
    import csv

    with open(path) as fh:
        row = list(csv.DictReader(fh))[-1]
    out = {}
    for k, v in row.items():
        try:
            out[k] = float(v)
        except ValueError:
            out[k] = v
    return out


def phase_pipeline_path(card_name, device="cuda", overrides=()):
    """The office run users start (configs/office_synthetic.yaml, drift 0.1)
    through the port's run.main on the card, the places layer, the viewer and
    the evaluation on; its places calls replayed on the CPU and on the card;
    its change-detection requests replayed on the CPU and again on the card;
    the slice's device functions timed alone. `device` and `overrides`
    (appended to the run's) are for a rehearsal on the CPU at a small size."""
    import contextlib
    import importlib
    import io

    import yaml

    from khronos_tpu_torch import run as trun
    from khronos_tpu_torch.changes.detectors import SequentialChangeDetector
    from khronos_tpu_torch.eval import pipeline_evaluator as pe  # bound to the original min_distances
    from khronos_tpu_torch.eval import viewer
    from khronos_tpu_torch.ops import gather, propagate
    from khronos_tpu_torch.pipeline.pipeline import KhronosPipeline
    from khronos_tpu_torch.stm.places import PlacesExtractor
    from khronos_tpu_torch.stm.spatio_temporal_map import SpatioTemporalMap
    from khronos_tpu_torch.utils.logging import FINISHED_CLEANLY, ExperimentLogger
    from khronos_tpu_torch.utils.timing import TimingRecorder

    out_dir = ROOT / "build" / "pipeline_path"
    dataset = yaml.safe_load(PIPELINE_CONFIG.read_text())["dataset"]
    for ov in overrides:
        k, _, v = ov.partition("=")
        if k.startswith("dataset."):
            dataset[k.split(".", 1)[1]] = yaml.safe_load(v)
    duration = dataset["duration"]
    recorder = TimingRecorder.instance()
    requests, passes, state, frame_times = [], [], {}, []
    in_objects = [False]

    def key(name):
        return f"{name} ({'objects' if in_objects[0] else 'background'})" if name == "_query_device" else name

    calls = DeviceCalls(PIPELINE_FUNCTIONS, key=key)
    originals = {(cls, n): getattr(cls, n) for cls, n in ((KhronosPipeline, "run_change_detection_on"),
                                                           (KhronosPipeline, "process_frame"),
                                                           (SequentialChangeDetector, "_detect_object_changes"),
                                                           (pe.PipelineEvaluator, "evaluate"),
                                                           (pe, "save_ground_truth"), (viewer, "export_html"),
                                                           *((PlacesExtractor, n) for n in PLACES_CALLS))}
    place_calls, after_ms = [], {}

    def record_places(name):
        def recorded(self, *args, **kwargs):
            place_calls.append((name, copy.deepcopy(args), copy.deepcopy(kwargs)))
            return originals[(PlacesExtractor, name)](self, *args, **kwargs)
        return recorded

    def after_the_run(owner, name):
        """The steps of run.main after the frame loop, timed; the slice's
        device-function counts leave their distances out."""
        def timed(*args, **kwargs):
            calls.counting = False
            ts = time.perf_counter()
            try:
                return originals[(owner, name)](*args, **kwargs)
            finally:
                torch.cuda.synchronize()
                after_ms[name] = (time.perf_counter() - ts) * 1e3
                calls.counting = True
        return timed

    def run_cd(self, dsg, stamp_ns, had_lc, merges):
        state["pipeline"] = self
        requests.append(copy.deepcopy((dsg, stamp_ns, had_lc, merges)))
        v = self.change_detector.verificator
        before = (v.n_full_builds, v.n_delta_updates, v.n_merges)
        counts = {n: len(recorder.samples(n)) for n in CD_SPANS}
        torch.cuda.synchronize()
        ts = time.perf_counter()
        originals[(KhronosPipeline, "run_change_detection_on")](self, dsg, stamp_ns, had_lc, merges)
        torch.cuda.synchronize()
        entries = sum(int(ix["cell_start"][-1]) for ix in v._indexes()) if v._built else 0
        passes.append({
            "ms": (time.perf_counter() - ts) * 1e3, "had_loop_closure": had_lc,
            "full_build": v.n_full_builds > before[0], "delta_update": v.n_delta_updates > before[1],
            "merge": v.n_merges > before[2], "opt_epoch": dsg.opt_epoch, "vertices": len(requests[-1][0].mesh.vertices),
            "rays": v.total_rays, "index_entries": entries, "bins": v.active_num_bins,
            "spans_ms": {n: sum(recorder.samples(n)[counts[n]:]) * 1e3 for n in CD_SPANS},
            "changes": changes_record(self.change_detector.changes),
        })

    def process_frame(self, *args, **kwargs):
        ts = time.perf_counter()
        out = originals[(KhronosPipeline, "process_frame")](self, *args, **kwargs)
        frame_times.append((ts, time.perf_counter()))
        return out

    def detect_objects(self, *args, **kwargs):
        in_objects[0] = True
        try:
            return originals[(SequentialChangeDetector, "_detect_object_changes")](self, *args, **kwargs)
        finally:
            in_objects[0] = False

    KhronosPipeline.run_change_detection_on = run_cd
    KhronosPipeline.process_frame = process_frame
    SequentialChangeDetector._detect_object_changes = detect_objects
    for owner, name in ((pe.PipelineEvaluator, "evaluate"), (pe, "save_ground_truth"), (viewer, "export_html")):
        setattr(owner, name, after_the_run(owner, name))
    for name in PLACES_CALLS:
        setattr(PlacesExtractor, name, record_places(name))
    argv = ["--device", device, "--config", str(PIPELINE_CONFIG), *PIPELINE_OVERRIDES, *overrides,
            f"run.output_dir={out_dir}"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    recorder.reset()
    propagate.launches = 0
    gather.launches = 0
    printed = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(printed):
            got_dir = trun.main(argv)
    finally:
        for (cls, n), fn in originals.items():
            setattr(cls, n, fn)
        calls.uninstall()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = {"propagate": propagate.launches, "gather": gather.launches}
    printed = printed.getvalue()
    pipe = state["pipeline"]
    n = pipe.frame_count
    loop_s = frame_times[-1][1] - frame_times[0][0]
    cd_in_loop_ms = sum(p["ms"] for p in passes[:-1])  # the last pass runs in finish()
    spans = {r["name"]: {"calls": r["n_samples"], "total_ms": r["total_s"] * 1e3, "max_ms": r["max_s"] * 1e3}
             for r in recorder.stats()}

    # the run's outputs, as tests/test_pipeline_e2e.py checks the reference's
    require(Path(got_dir) == out_dir and ExperimentLogger.has_flag(got_dir, FINISHED_CLEANLY), "not finished cleanly")
    for f in ("dsg.npz", "final.4dmap.npz", "mesh.ply", "object_changes.csv", "background_changes.csv",
              "objects.csv", "experiment_log.txt", "viewer.html", "gt.npz", *(f"results/{r}" for r in RESULT_FILES)):
        require((out_dir / f).exists(), f"{f} not written")
    require("Background mesh (final row; values in %):" in printed and "Changes:" in printed
            and "pipeline/frame" in printed, f"the results and timing tables were not printed:\n{printed}")
    require(n == round(duration * dataset["fps"]), f"{n} frames")
    # A launches once a frame (the motion regions) and once a room
    # segmentation (in update_local's and refresh_rooms' places/rooms spans,
    # and in extract, which places_mode 'output' does not call); B once a
    # frame. (A CPU rehearsal launches no kernel: its tensors take the plain
    # versions.)
    room_calls = calls.calls.get("_room_blobs", 0)
    rooms_spans = spans.get("places/rooms", {}).get("calls", 0)
    extracts = sum(c[0] == "extract" for c in place_calls)
    require(room_calls == rooms_spans + extracts and room_calls >= 1,
            f"room segmentations: {room_calls} calls, {rooms_spans} places/rooms spans, {extracts} extract calls")
    require(device != "cuda" or launches == {"propagate": n + room_calls, "gather": n},
            f"launches {launches}: want A {n} + {room_calls}, B {n}")
    be, v = pipe.backend, pipe.change_detector.verificator
    require(len(be.loop_closures) >= 1, "no loop closure")
    require(max(p["opt_epoch"] for p in passes) > 0, "no solve moved geometry")
    counters = {"n_full_builds": v.n_full_builds, "n_delta_updates": v.n_delta_updates, "n_merges": v.n_merges}
    require(all(c >= 1 for c in counters.values()), f"the ray library missed a path: {counters}")
    require(pipe.map.num_snapshots >= 2 and pipe.map.num_snapshots == len(passes), pipe.map.num_snapshots)
    want_map = map_arrays(pipe.map)
    compare_arrays(map_arrays(SpatioTemporalMap.load(str(out_dir / "final.4dmap.npz"))), want_map,
                   "final.4dmap.npz loaded back")
    final = pipe.map.get_dsg(pipe.map.latest_ns())
    near = [o for o in final.objects.values()
            if not o.is_dynamic and np.linalg.norm(o.position() - CHAIR) < 1.0]
    ends_s = sorted((o.last_observed_ns[-1] - pipe.t0_ns) * 1e-9 for o in near)
    require(near and ends_s[0] < duration - 2.0, f"the removed chair's presence never ended: {ends_s}")
    require(all(np.isfinite(a).all() for a in (final.mesh.vertices, final.agent_positions())), "non-finite map")

    # the places layer, as tests/test_pipeline_e2e.py holds the reference's
    snaps = pipe.map.snapshots
    mid_places, final_places = snaps[len(snaps) // 2].places, snaps[-1].places
    require(mid_places is not None and len(mid_places.nodes) > 0, "the mid-run snapshot has no places layer")
    require(final_places is not None and len(final_places.nodes) > 0, "the final snapshot has no places layer")
    require(final_places.num_rooms >= 1 and all(p.room_id >= 0 for p in final_places.nodes),
            f"final rooms: {sorted({p.room_id for p in final_places.nodes})}")
    clearances = [p.distance for p in final_places.nodes]
    require(all(0.2 <= c <= 6.0 for c in clearances), f"clearances {min(clearances)} to {max(clearances)} m")
    # the extractor's calls replayed on the CPU and on the card: the same layers
    live = layer_record(pipe.places_extractor.layer)
    cpu_ex, cpu_layers, places_cpu_s = replay_places(pipe.config.places, place_calls, "cpu")
    card_ex, card_layers, places_card_s = replay_places(pipe.config.places, place_calls, device)
    for i, (a, b) in enumerate(zip(cpu_layers, card_layers)):
        require(layers_equal(a, b), f"places: the CPU and card replays differ after call {i} ({place_calls[i][0]})")
    require(layers_equal(card_layers[-1], live), "places: the replays' final layer differs from the run's")

    # the evaluation: quality against the reference's run of the same command,
    # and the standalone CLI on the saved run
    quality = {}
    for csv_name, column, ref, slack in REFERENCE_QUALITY:
        got = read_result(out_dir / "results" / csv_name)[column]
        quality[f"{csv_name[:-4]}/{column}"] = {"card": got, "reference": ref, "slack": slack}
        require(got >= ref - slack, f"map quality: {csv_name} {column} = {got}, the reference {ref} less {slack}")
    cli_dir = out_dir / "results_cli"
    ts = time.perf_counter()
    cli = subprocess.run([sys.executable, "-m", "khronos_tpu_torch.eval", "--map", str(out_dir / "final.4dmap.npz"),
                          "--only-final", "--out", str(cli_dir), "--device", device],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    cli_s = time.perf_counter() - ts
    require(cli.returncode == 0, f"the eval CLI failed:\n{cli.stderr[-3000:]}")
    for r in RESULT_FILES:
        require((cli_dir / r).read_bytes() == (out_dir / "results" / r).read_bytes(),
                f"the eval CLI's {r} differs from the run's")
    # the evaluation's largest distance call (prune-to-observed: the ground
    # truth's cloud against every observed vertex), alone
    from khronos_tpu_torch.eval.evaluators import min_distances

    gt_cloud = pe.FileGroundTruth(str(out_dir / "gt.npz")).background_points(pipe.map.latest_ns() * 1e-9)
    prune_args = (gt_cloud.astype(np.float32), final.mesh.vertices.astype(np.float32))
    prune = time_device_function("min_distances", prune_args, {"device": device}, functions=CD_FUNCTIONS)
    prune["shapes"] = _shapes(prune_args)
    prune["bound_ms"], prune["bound_by"] = cd_function_bound("min_distances", prune_args, {},
                                                             min_distances(*prune_args, device=device))

    # card vs CPU: the recorded requests through the port on the CPU, up to
    # the budget (at least to the first full rebuild after a loop closure)
    lc_seen = [any(p["had_loop_closure"] for p in passes[: i + 1]) for i in range(len(passes))]
    first_rebuild = next((i for i, p in enumerate(passes) if i > 0 and p["full_build"] and lc_seen[i]), len(passes) - 1)
    cpu_det, cpu_map, cpu_passes, cpu_s = replay_cd(
        pipe.config, requests, "cpu", stop=lambda i, s: s > CPU_REPLAY_BUDGET_S and i >= first_rebuild)
    k = len(cpu_passes)
    for i in range(k):
        require(cpu_passes[i][0] == passes[i]["changes"][0], f"card and CPU object changes differ at pass {i}")
        require(np.array_equal(cpu_passes[i][1], passes[i]["changes"][1]), f"card and CPU background states differ at pass {i}")
    scratch = ROOT / "build" / "pipeline_path_compare"
    require(changes_csv(cpu_passes[-1], scratch / "cpu") == changes_csv(passes[k - 1]["changes"], scratch / "card"),
            "card and CPU Changes CSV bytes differ")
    map_err = compare_arrays(map_arrays(cpu_map), map_arrays(pipe.map, k), "card vs CPU 4D map")
    # a second card replay of every request: the same bits
    again_det, again_map, again_passes, again_s = replay_cd(pipe.config, requests, device)
    require(all(a[0] == p["changes"][0] and np.array_equal(a[1], p["changes"][1]) for a, p in zip(again_passes, passes)),
            "a second card replay differs in its Changes")
    compare_arrays(map_arrays(again_map), want_map, "second card replay 4D map")

    # the index and the largest background query, card vs CPU
    from khronos_tpu_torch.changes import ray_verificator as rv

    def on_cpu(xs):
        return [x.cpu() if torch.is_tensor(x) else x for x in xs]

    build_args = calls.largest["_build_index_device"][1]
    card_index = rv._build_index_device(*build_args)
    ts = time.perf_counter()
    cpu_index = rv._build_index_device(*on_cpu(build_args))
    index_cpu_s = time.perf_counter() - ts
    require(all(torch.equal(a.cpu(), b) for a, b in zip(card_index, cpu_index)), "card and CPU ray index differ")
    query_args = calls.largest["_query_device (background)"][1]
    card_ev = rv._query_device(*query_args).cpu()
    cpu_ev = rv._query_device(*on_cpu(query_args))
    ev_diff = int((card_ev != cpu_ev).sum())

    # the slice's device functions alone, on the largest inputs the run gave them
    # kernel A's room grid: the largest room segmentation's
    room_lab, room_grow = room_grid_of(calls.largest["_room_blobs"][1])
    room_rounds = propagate.propagate_labels_3d_fixpoint_plain(room_lab, room_grow)[1]
    functions = {}
    for key_name, (size, args, kwargs) in sorted(calls.largest.items()):
        name = key_name.split(" ")[0]
        module = importlib.import_module("khronos_tpu_torch." + next(m for m, f in PIPELINE_FUNCTIONS if f == name))
        fn = getattr(module, name)
        info = time_device_function(name, args, kwargs, functions=PIPELINE_FUNCTIONS)
        info["calls"] = calls.calls[key_name]
        info["shapes"] = _shapes(args) + ([list(args[2])] if name == "_room_blobs" else
                                          [list(args[1])] if name == "_candidate_field" else [])
        info["first_call_ms"] = calls.first_ms[key_name]
        if name in ("_candidate_field", "_room_blobs"):
            info["bound_ms"], info["bound_by"] = places_function_bound(name, args, room_rounds)
        else:
            info["bound_ms"], info["bound_by"] = cd_function_bound(name, args, kwargs, fn(*args, **kwargs))
        functions[key_name] = info
    for key_name in ("_build_index_device", "_query_device (objects)", "_query_device (background)",
                     "_merge_sorted_device", "_touched_cells_device", "_scan_device", "_votes_device",
                     "min_distances", "_candidate_field", "_room_blobs"):
        require(key_name in functions, f"{key_name} never ran on the path")

    full = [p for p in passes if p["full_build"]]
    incremental = [p for p in passes if not p["full_build"]]

    def pass_summary(ps):
        if not ps:
            return None
        return {"passes": len(ps), "median_ms": statistics.median(p["ms"] for p in ps), "max_ms": max(p["ms"] for p in ps),
                "spans_ms_mean": {s: statistics.fmean(p["spans_ms"][s] for p in ps) for s in CD_SPANS}}

    last = passes[-1]
    result = {
        "frames": n, "wall_s": wall_s, "frame_loop_s": loop_s, "fps": n / loop_s, "ms_per_frame": loop_s / n * 1e3,
        "fps_without_cd": n / (loop_s - cd_in_loop_ms * 1e-3), "peak_mib": peak / 2**20, "launches": launches,
        "loop_closures": len(be.loop_closures), "solves": be.num_optimizations, "geometry_epoch": last["opt_epoch"],
        "snapshots": pipe.map.num_snapshots, "unions": len(pipe.map._unions), "counters": counters,
        "passes": [{k2: p[k2] for k2 in p if k2 != "changes"} for p in passes],
        "full_passes": pass_summary(full), "incremental_passes": pass_summary(incremental),
        "last_pass": {"rays": last["rays"], "index_entries": last["index_entries"], "bins": last["bins"],
                      "vertices": last["vertices"]},
        "objects": len(final.objects), "chair_candidates_end_s": ends_s,
        "cpu_replay": {"passes": k, "of": len(passes), "seconds": cpu_s, "map_float_max_abs_err": map_err},
        "card_replay_s": again_s, "index_cpu_build_s": index_cpu_s,
        "evidence_entries_differing": ev_diff, "evidence_entries": card_ev.numel(),
        "host_spans": spans, "device_functions": functions,
        "places": {"calls": {n: sum(c[0] == n for c in place_calls) for n in PLACES_CALLS},
                   "room_segmentations": room_calls, "final_nodes": len(final_places.nodes),
                   "final_edges": len(final_places.edges), "final_rooms": final_places.num_rooms,
                   "mid_nodes": len(mid_places.nodes), "clearance_m": [min(clearances), max(clearances)],
                   "replay_cpu_s": places_cpu_s, "replay_card_s": places_card_s,
                   "room_grid": list(room_lab.shape), "room_grid_growable": int(room_grow.sum()),
                   "room_fixpoint_rounds": room_rounds,
                   "spans_ms": {k: spans[k] for k in PLACES_SPANS if k in spans}},
        "after_the_run_ms": after_ms, "eval_cli_s": cli_s, "quality": quality, "prune_to_observed": prune,
        "_room_grid": (room_lab, room_grow),
    }
    log(f"pipeline_path ({card_name}): {n} frames at {dataset['height']}x{dataset['width']} through run.main in {wall_s:.1f} s; frame loop "
        f"{result['fps']:.2f} frames/s ({result['ms_per_frame']:.2f} ms/frame, CD passes inline; "
        f"{result['fps_without_cd']:.2f} frames/s without them); peak device memory {peak / 2**20:.1f} MiB; "
        f"launches {launches}")
    log(f"pipeline_path: {len(be.loop_closures)} loop closures, {be.num_optimizations} solves, geometry epoch "
        f"{last['opt_epoch']}; {len(passes)} CD passes ({len(full)} full builds, {len(incremental)} incremental), "
        f"ray library {counters}; {pipe.map.num_snapshots} snapshots in {len(pipe.map._unions)} union chunks; "
        f"chair candidates end at {[round(e, 2) for e in ends_s]} s (duration {duration} s)")
    for label, summary in (("full", result["full_passes"]), ("incremental", result["incremental_passes"])):
        if summary:
            log(f"pipeline_path: {label} CD passes: {summary['passes']}, median {summary['median_ms']:.1f} ms, max "
                f"{summary['max_ms']:.1f} ms; mean span ms " + ", ".join(
                    f"{s} {v:.1f}" for s, v in summary["spans_ms_mean"].items()))
    log(f"pipeline_path: last pass {last['rays']} rays, {last['index_entries']} index entries, {last['bins']} bins, "
        f"{last['vertices']} vertices; card == CPU on {k} of {len(passes)} passes ({cpu_s:.1f} s; Changes, "
        f"background states, map arrays, float max |diff| {map_err}); a second card replay bit-identical "
        f"({again_s:.1f} s); ray index card == CPU ({index_cpu_s:.1f} s on the CPU); largest background query "
        f"{ev_diff} of {card_ev.numel()} evidence entries differ card vs CPU")
    pl = result["places"]
    log(f"pipeline_path: places: calls {pl['calls']}, {room_calls} room segmentations; final layer "
        f"{pl['final_nodes']} places, {pl['final_edges']} edges, {pl['final_rooms']} rooms, clearances "
        f"{min(clearances):.3f} to {max(clearances):.3f} m; mid-run {pl['mid_nodes']} places; replays bit-identical "
        f"(CPU {places_cpu_s:.1f} s, card {places_card_s:.1f} s); host ms by span (calls, total, max): " + ", ".join(
            f"{k} {v['calls']} / {v['total_ms']:.1f} / {v['max_ms']:.1f}" for k, v in pl["spans_ms"].items()))
    log("pipeline_path: after the frame loop (ms): " + ", ".join(f"{k} {v:.1f}" for k, v in after_ms.items())
        + f"; eval CLI {cli_s:.1f} s, the same CSVs; prune-to-observed min_distances {prune['shapes']}: "
        f"{prune['wall_ms']:.2f} ms host, {prune['device_ms']:.3f} ms device in {prune['kernels_per_call']:.0f} "
        f"kernels, peak +{prune['peak_extra_mib']:.1f} MiB, bound {prune['bound_ms'] * 1e3:.3f} us")
    log("pipeline_path: quality (card / reference less slack): " + ", ".join(
        f"{k} {v['card']:.4f} / {v['reference']:.4f} - {v['slack']}" for k, v in quality.items()))
    log("pipeline_path: printed tables:\n" + printed.strip())
    for name, info in functions.items():
        log(f"device function {name}: {info['calls']} calls (the first {info['first_call_ms']:.1f} ms), "
            f"{info['wall_ms']:.3f} ms a call on the host clock, {info['device_ms']:.3f} ms device kernel time in "
            f"{info['kernels_per_call']:.0f} kernels, peak +{info['peak_extra_mib']:.1f} MiB, bound "
            f"{info['bound_ms'] * 1e3:.3f} us by {info['bound_by']}; largest inputs {info['shapes']}")
    return result


def time_fixpoint(propagate, name, lab, grow) -> dict:
    """Kernel A to the fixpoint on one input: checked (check_fixpoint), then
    one call timed in turns beside the plain fixpoint loop and beside its
    bound."""
    info = check_fixpoint(propagate, lab, grow, name)
    p_ms, k_ms = in_turns(lambda: propagate.propagate_labels_3d_fixpoint_plain(lab, grow),
                          lambda: propagate.propagate_labels_3d_fixpoint(lab, grow))
    bound_us, bound_by = propagate_bound(lab, info["rounds"])
    return {**info, "us": k_ms * 1e3, "plain_us": p_ms * 1e3, "bound_us": bound_us, "bound_by": bound_by,
            "active_share": kernel_cases().active_tiles(grow) / propagate.n_tiles(lab.shape)}


def phase_room_fixpoint(pipeline):
    """Kernel A on the pipeline run's largest room grid, to the fixpoint:
    bit-exact against the plain fixpoint loop (rounds included), then one
    call timed beside the loop and beside its bound. The kernels line's row
    for the room segmentation's calls."""
    from khronos_tpu_torch.ops import propagate

    lab, grow = (x.cuda() for x in pipeline.pop("_room_grid"))
    info = time_fixpoint(propagate, "pipeline_path's largest room grid", lab, grow)
    row = {
        "name": "propagate_labels_3d_fixpoint (room segmentation)", "route": "cuda",
        "source": "khronos_tpu_torch/csrc/propagate.cu", "replaces": "khronos_tpu/ops/pallas/propagate.py:49",
        "launches": pipeline["places"]["room_segmentations"], "launches_per_segmentation": 1, "match": True,
        "max_abs_err": info["max_abs_err"], "ms": info["us"] * 1e-3, "plain_ms": info["plain_us"] * 1e-3,
        "bound_ms": info["bound_us"] * 1e-3, "bound_us": info["bound_us"], "bound_by": info["bound_by"],
        "library_ms": None, "shape": info["shape"], "rounds": info["rounds"], "plain_rounds": info["plain_rounds"],
        "growable_share": info["growable_share"], "active_tiles_share": info["active_share"],
    }
    log(f"kernel A to the fixpoint on {row['shape']} (the run's largest room grid, growable share "
        f"{row['growable_share']:.4f}, {row['active_tiles_share']:.4f} of tiles active): {info['us']:.2f} us in 1 "
        f"launch, {info['rounds']} rounds (the plain loop {info['plain_rounds']}); plain fixpoint loop "
        f"{info['plain_us']:.1f} us; bound {info['bound_us']:.3f} us by {info['bound_by']}; {row['launches']} "
        "launches on pipeline_path")
    return row


# ---- the apartment and open-set configs, through run.main as users run them ----

APARTMENT_CONFIG = ROOT / "configs" / "apartment_synthetic.yaml"
OPENSET_CONFIG = ROOT / "configs" / "openset_synthetic.yaml"
# the fused open-set branch: max_instances within the fused cap (MC = 32).
# The reference's ExternalTracker has no fused-stats entry (its process takes
# the vertex image only, so the fused path raises TypeError there), so this
# run tracks with MaxIouTracker, as tests/test_openset.py's fused case does.
OPENSET_FUSED_OVERRIDES = ("pipeline.active_window.object_detector.max_instances=32",
                           "pipeline.active_window.tracker.type=MaxIouTracker",
                           "run.evaluate=false", "run.export_viewer=false")
RECORD_FRAME = 10  # the frame whose kernel B inputs the new paths record


def record_kernel_inputs(frame_index):
    """A spin_once wrapper factory and a kernel A wrapper factory. Kernel
    B's inputs of the `frame_index`-th spin_once call are cloned into
    `captured["gather_rows_cuda"]`. Of kernel A's per-frame calls (the
    motion detector's), `captured["motion"]` keeps the input with the most
    growable voxels and its frame, compared and selected on the device so
    the frame loop never waits. The launches still count: they are the
    path's own."""
    from khronos_tpu_torch.ops import gather

    captured = {"gather_rows_cuda": [], "motion": {}}
    frames = []

    def wrap(spin_once):
        def spin(self, frame):
            frames.append(frame)
            if len(frames) - 1 != frame_index:
                return spin_once(self, frame)
            fn = gather.gather_rows_cuda

            def wrapped(*a):
                captured["gather_rows_cuda"].append([x.clone() if torch.is_tensor(x) else x for x in a])
                return fn(*a)

            gather.gather_rows_cuda = wrapped
            try:
                return spin_once(self, frame)
            finally:
                gather.gather_rows_cuda = fn
        return spin

    def wrap_propagate(fn):
        def keep_most_growable(lab, grow, iterations):
            best = captured["motion"]
            count = grow.sum(dtype=torch.int64)
            frame = torch.full((), len(frames) - 1, dtype=torch.int64, device=lab.device)
            if not best:
                best.update(lab=lab.clone(), grow=grow.clone(), count=count, frame=frame, iterations=iterations)
            else:
                require(lab.shape == best["lab"].shape and iterations == best["iterations"],
                        f"kernel A's per-frame inputs changed: {list(lab.shape)}, {iterations} rounds")
                more = count > best["count"]
                best.update(lab=torch.where(more, lab, best["lab"]), grow=torch.where(more, grow, best["grow"]),
                            count=torch.maximum(count, best["count"]), frame=torch.where(more, frame, best["frame"]))
            return fn(lab, grow, iterations)
        return keep_most_growable

    return wrap, wrap_propagate, captured, frames


def run_config(config, overrides, out_dir, device="cuda"):
    """run.main on `config` with `overrides`, the kernels' launch counts set
    to 0 just before and read just after; returns the run's record."""
    import contextlib
    import io

    from khronos_tpu_torch import run as trun
    from khronos_tpu_torch.active_window.active_window import ActiveWindow
    from khronos_tpu_torch.ops import gather, propagate
    from khronos_tpu_torch.pipeline.pipeline import KhronosPipeline
    from khronos_tpu_torch.utils.timing import TimingRecorder

    wrap, wrap_propagate, captured, frames = record_kernel_inputs(RECORD_FRAME)
    originals = {"spin_once": ActiveWindow.spin_once, "process_frame": KhronosPipeline.process_frame,
                 "propagate": propagate.propagate_labels_3d_cuda}
    state, frame_times = {}, []

    def process_frame(self, *args, **kwargs):
        state["pipeline"] = self
        ts = time.perf_counter()
        out = originals["process_frame"](self, *args, **kwargs)
        frame_times.append((ts, time.perf_counter()))
        return out

    calls = DeviceCalls((("stm.places", "_room_blobs"),))
    ActiveWindow.spin_once = wrap(originals["spin_once"])
    KhronosPipeline.process_frame = process_frame
    propagate.propagate_labels_3d_cuda = wrap_propagate(originals["propagate"])
    recorder = TimingRecorder.instance()
    printed = io.StringIO()
    argv = ["--device", device, "--config", str(config), *overrides, f"run.output_dir={out_dir}"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    recorder.reset()
    propagate.launches = 0
    gather.launches = 0
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(printed):
            got_dir = trun.main(argv)
    finally:
        ActiveWindow.spin_once = originals["spin_once"]
        KhronosPipeline.process_frame = originals["process_frame"]
        propagate.propagate_labels_3d_cuda = originals["propagate"]
        calls.uninstall()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {"propagate": propagate.launches, "gather": gather.launches}
    pipe = state["pipeline"]
    n = pipe.frame_count
    loop_s = frame_times[-1][1] - frame_times[0][0]
    spans = {r["name"]: {"calls": r["n_samples"], "total_ms": r["total_s"] * 1e3} for r in recorder.stats()}
    require(Path(got_dir) == Path(out_dir), got_dir)
    return {"pipe": pipe, "frames": frames, "captured": captured, "printed": printed.getvalue(),
            "launches": launches, "room_segmentations": calls.calls.get("_room_blobs", 0),
            "room_args": calls.largest.get("_room_blobs", (None, None))[1], "n": n,
            "wall_s": wall_s, "fps": n / loop_s, "ms_per_frame": loop_s / n * 1e3,
            "peak_mib": torch.cuda.max_memory_allocated() / 2**20, "spans": spans}


def check_config_run(name, run, config, out_dir, quality_bars, device="cuda", evaluate=True, overrides=()):
    """What every new path checks: the finished flag and the output files, the
    frame count, A once a frame plus once a room segmentation and B once a
    frame, static objects with meshes, a finite map, and the map quality
    against the JAX package's CPU runs of the same command."""
    import yaml

    from khronos_tpu_torch.stm.spatio_temporal_map import SpatioTemporalMap
    from khronos_tpu_torch.utils.logging import FINISHED_CLEANLY, ExperimentLogger

    dataset = yaml.safe_load(Path(config).read_text())["dataset"]
    for ov in overrides:
        k, _, v = ov.partition("=")
        if k.startswith("dataset."):
            dataset[k.split(".", 1)[1]] = yaml.safe_load(v)
    require(ExperimentLogger.has_flag(str(out_dir), FINISHED_CLEANLY), f"{name}: not finished cleanly")
    files = ["dsg.npz", "final.4dmap.npz", "mesh.ply", "objects.csv", "experiment_log.txt"]
    if evaluate:
        files += ["viewer.html", "gt.npz", *(f"results/{r}" for r in RESULT_FILES)]
    for f in files:
        require((Path(out_dir) / f).exists(), f"{name}: {f} not written")
    n = run["n"]
    require(n == round(dataset["duration"] * dataset["fps"]), f"{name}: {n} frames")
    rooms = run["room_segmentations"]
    require(rooms >= 1, f"{name}: no room segmentation")
    require(device != "cuda" or run["launches"] == {"propagate": n + rooms, "gather": n},
            f"{name}: launches {run['launches']}: want A {n} + {rooms}, B {n}")
    pipe = run["pipe"]
    final = pipe.map.get_dsg(pipe.map.latest_ns())
    static = [o for o in final.objects.values() if not o.is_dynamic and len(o.mesh_faces)]
    require(static, f"{name}: no static object with a mesh")
    require(all(np.isfinite(a).all() for a in (final.mesh.vertices, final.agent_positions())), f"{name}: non-finite map")
    loaded = SpatioTemporalMap.load(str(Path(out_dir) / "final.4dmap.npz"))
    require(loaded.num_snapshots == pipe.map.num_snapshots, f"{name}: final.4dmap.npz snapshots")
    quality = {}
    for csv_name, column, ref, slack in quality_bars if evaluate else ():
        got = read_result(Path(out_dir) / "results" / csv_name)[column]
        quality[f"{csv_name[:-4]}/{column}"] = {"card": got, "reference": ref, "slack": slack}
        require(got >= ref - slack, f"{name}: map quality {csv_name} {column} = {got}, the reference {ref} less {slack}")
    return final, static, quality


def kernel_a_input_of(name, run) -> dict:
    """Kernel A on the path's input that exercises it most: the motion
    detector's input with the most growable voxels, or, where no frame has a
    growable voxel (a scene with nothing moving), the run's largest room grid
    to the fixpoint (the room segmentation's own call). Checked bit for bit
    and timed; it must hold growable voxels and run rounds."""
    from khronos_tpu_torch.ops import propagate

    best = run["captured"]["motion"]
    count = int(best["count"]) if best else 0
    if count > 0:
        what = f"{name}, frame {int(best['frame'])}'s motion regions ({count} growable voxels, the run's most)"
        a = time_propagate(propagate, what, best["lab"], best["grow"], best["iterations"])
        a.update(shape=list(best["lab"].shape), iterations=best["iterations"])
    else:
        require(run["room_args"] is not None, f"{name}: no room segmentation to check kernel A on")
        lab, grow = room_grid_of(run["room_args"])
        log(f"{name}: no frame's motion detector had a growable voxel ({len(run['frames'])} frames); kernel A is "
            "checked and timed on the run's largest room grid, to the fixpoint")
        a = time_fixpoint(propagate, f"{name}'s largest room grid", lab, grow)
        a.update(iterations=None)
    require(a["growable_share"] > 0 and a["rounds"] > 0,
            f"{name}: kernel A's check input has growable share {a['growable_share']} and {a['rounds']} rounds")
    return a


def kernel_rows_on(name, run):
    """A on kernel_a_input_of's input and B on the recorded frame's inputs:
    bit-exact against their plain versions, timed beside them (and B beside
    img[idx]) and beside their bounds; the kernels line's rows for the path."""
    from khronos_tpu_torch.ops import gather

    cap = run["captured"]
    require(len(cap["gather_rows_cuda"]) == 1, f"{name}: frame {RECORD_FRAME} launched B "
                                               f"{len(cap['gather_rows_cuda'])} times")
    a = kernel_a_input_of(name, run)
    img, idx = cap["gather_rows_cuda"][0]
    err = check_gather(gather, img, idx, f"{name}, frame {RECORD_FRAME}")
    p_ms, k_ms = in_turns(lambda: gather.gather_rows_plain(img, idx), lambda: gather.gather_rows_cuda(img, idx))
    lib_ms = time_ms(lambda: img[idx])
    bytes_b = img.nbytes + idx.nbytes + idx.numel() * img.shape[1] * 4
    n = run["n"]
    rows = [
        {"name": f"propagate_labels_3d ({name})", "route": "cuda", "source": "khronos_tpu_torch/csrc/propagate.cu",
         "replaces": "khronos_tpu/ops/pallas/propagate.py:49", "launches": run["launches"]["propagate"],
         "launches_per_frame": (run["launches"]["propagate"] - run["room_segmentations"]) / n, "match": True,
         "max_abs_err": a["max_abs_err"], "ms": a["us"] * 1e-3, "plain_ms": a["plain_us"] * 1e-3,
         "bound_ms": a["bound_us"] * 1e-3, "bound_us": a["bound_us"], "bound_by": a["bound_by"], "library_ms": None,
         "input": a["input"], "shape": a["shape"], "iterations": a["iterations"], "rounds": a["rounds"],
         "active_share": a["active_share"], "growable_share": a["growable_share"]},
        {"name": f"gather_rows ({name})", "route": "cuda", "source": "khronos_tpu_torch/csrc/gather.cu",
         "replaces": "khronos_tpu/ops/pallas/gather_probe.py:32", "launches": run["launches"]["gather"],
         "launches_per_frame": run["launches"]["gather"] / n, "match": True, "max_abs_err": err, "ms": k_ms,
         "plain_ms": p_ms, "bound_ms": bytes_b / HBM_BYTES_PER_S * 1e3, "bound_us": bytes_b / HBM_BYTES_PER_S * 1e6,
         "bound_by": "bytes", "library_ms": lib_ms, "input": f"{name}, frame {RECORD_FRAME}",
         "shape": [list(img.shape), list(idx.shape)]},
    ]
    for r in rows:
        lib = "none" if r["library_ms"] is None else f"{r['library_ms'] * 1e3:.1f} us"
        extra = (f", {r['rounds']} rounds, growable share {r['growable_share']:.6f}, active tiles "
                 f"{r['active_share']:.4f}" if "rounds" in r else "")
        log(f"kernel {r['name']}: bit-exact on {r['input']} {r['shape']}{extra}, {r['ms'] * 1e3:.2f} us "
            f"(plain {r['plain_ms'] * 1e3:.1f} us, library {lib}), bound {r['bound_us']:.3f} us by {r['bound_by']}, "
            f"{r['launches']} launches in the run")
    return rows


def summary_of(name, run, quality):
    log(f"{name}: {run['n']} frames through run.main in {run['wall_s']:.1f} s; frame loop {run['fps']:.2f} frames/s "
        f"({run['ms_per_frame']:.2f} ms/frame); peak device memory {run['peak_mib']:.1f} MiB; launches "
        f"{run['launches']} ({run['room_segmentations']} room segmentations)")
    if quality:
        log(f"{name}: quality (card / reference less slack): " + ", ".join(
            f"{k} {v['card']:.5f} / {v['reference']:.5f} - {v['slack']}" for k, v in quality.items()))
    return {"frames": run["n"], "wall_s": run["wall_s"], "fps": run["fps"], "ms_per_frame": run["ms_per_frame"],
            "peak_mib": run["peak_mib"], "launches": run["launches"],
            "room_segmentations": run["room_segmentations"], "quality": quality,
            "host_spans": {k: v for k, v in run["spans"].items() if k.split("/")[0] in
                           ("pipeline", "active_window", "motion_detection", "object_detection", "integration",
                            "tracking", "object_extraction")}}


def phase_apartment_path(card_name, device="cuda", overrides=()):
    """`python -m khronos_tpu_torch.run --config configs/apartment_synthetic.yaml`
    as users run it (200 frames of 240x320 on a 128x128x40 grid, the fused
    step, places, the evaluation and the viewer on)."""
    out_dir = ROOT / "build" / "apartment_path"
    run = run_config(APARTMENT_CONFIG, overrides, out_dir, device)
    final, static, quality = check_config_run("apartment_path", run, APARTMENT_CONFIG, out_dir,
                                              APARTMENT_QUALITY, device, overrides=overrides)
    require(run["pipe"].active_window._fused_step is not None, "apartment_path: no fused step")
    result = summary_of("apartment_path", run, quality)
    result["static_objects"] = len(static)
    log(f"apartment_path ({card_name}): {len(static)} static objects with meshes; printed tables:\n"
        + run["printed"].strip())
    if device == "cuda":
        result["kernel_rows"] = kernel_rows_on("apartment_path", run)
    return result


def semantic_clusters_by_frame(frames):
    """Per frame: (cluster count, sorted centroid x rounded to 0.1 m), the
    comparison tests/test_openset.py makes between the fused and modular
    open-set paths."""
    return [(len(f.semantic_clusters), sorted(round(float(c.centroid[0]), 1) for c in f.semantic_clusters))
            for f in frames]


def phase_openset_path(card_name, device="cuda", overrides=()):
    """`python -m khronos_tpu_torch.run --config configs/openset_synthetic.yaml`
    (80 frames of 120x160, InstanceForwarding with max_instances 64 > MC:
    the MODULAR path), then the same config with max_instances=32, which
    takes the fused open-set branch: the same clusters in every frame."""
    from khronos_tpu_torch.data import synthetic as syn
    from khronos_tpu_torch.stm.spatio_temporal_map import SpatioTemporalMap

    out_dir = ROOT / "build" / "openset_path"
    run = run_config(OPENSET_CONFIG, overrides, out_dir, device)
    final, static, quality = check_config_run("openset_path", run, OPENSET_CONFIG, out_dir, OPENSET_QUALITY, device,
                                              overrides=overrides)
    aw = run["pipe"].active_window
    require(aw._fused_step is None and not aw._openset_fused, "openset_path: the window built a fused step")
    # objects whose features are the scene's instance embeddings, kept into the saved 4D map
    lib = syn.SyntheticSequence(syn.apartment_scene(), syn.SyntheticSequenceConfig(), device="cpu").instance_features()
    feats = {o.node_id: o.feature for o in static if o.feature is not None}
    require(feats, "openset_path: no static object carries a feature")
    cos = {k: float((lib @ (f / np.linalg.norm(f))).max()) for k, f in feats.items()}
    require(all(c > 0.99 for c in cos.values()), f"openset_path: features off the scene's embeddings: {cos}")
    loaded = SpatioTemporalMap.load(str(out_dir / "final.4dmap.npz"))
    kept = {o.node_id: o.feature for o in loaded.get_dsg(loaded.latest_ns()).objects.values() if o.feature is not None}
    require(all(k in kept and np.array_equal(kept[k], f) for k, f in feats.items()),
            "openset_path: features lost in final.4dmap.npz")
    result = summary_of("openset_path", run, quality)
    result.update(static_objects=len(static), objects_with_features=len(feats), min_feature_cosine=min(cos.values()))
    log(f"openset_path ({card_name}): modular path; {len(static)} static objects with meshes, {len(feats)} with "
        f"features (cosine to the scene's embeddings >= {min(cos.values()):.6f}), kept in final.4dmap.npz; printed "
        "tables:\n" + run["printed"].strip())
    if device == "cuda":
        result["kernel_rows"] = kernel_rows_on("openset_path", run)
    modular = semantic_clusters_by_frame(run["frames"])
    del run

    fused_dir = ROOT / "build" / "openset_fused_path"
    fused = run_config(OPENSET_CONFIG, (*OPENSET_FUSED_OVERRIDES, *overrides), fused_dir, device)
    check_config_run("openset_fused_path", fused, OPENSET_CONFIG, fused_dir, (), device, evaluate=False,
                     overrides=overrides)
    aw = fused["pipe"].active_window
    require(aw._fused_step is not None and aw._openset_fused, "openset_fused_path: no fused open-set step")
    got = semantic_clusters_by_frame(fused["frames"])
    require(len(got) == len(modular), (len(got), len(modular)))
    differ = [i for i, (a, b) in enumerate(zip(modular, got)) if a != b]
    require(not differ, f"openset: fused and modular clusters differ at frames {differ[:10]}")
    require(sum(c for c, _ in got) >= 3, "openset: too few clusters to compare")
    fused_static = [o for o in fused["pipe"].map.get_dsg(fused["pipe"].map.latest_ns()).objects.values()
                    if not o.is_dynamic and len(o.mesh_faces)]
    result["fused"] = summary_of("openset_fused_path", fused, {})
    result["fused"].update(static_objects=len(fused_static), clusters=sum(c for c, _ in got))
    log(f"openset_fused_path: the fused open-set step; the same semantic clusters as the modular run in all "
        f"{len(got)} frames ({sum(c for c, _ in got)} clusters); {len(fused_static)} static objects (MaxIouTracker) "
        f"against {len(static)} (ExternalTracker, modular)")
    return result


# ---- jackal_path: real-data input and loop closure without the oracle ----

JACKAL_CONFIG = ROOT / "configs" / "jackal_real.yaml"
JACKAL_SECONDS, JACKAL_FPS = 40.0, 5.0  # the office at the renderer's 240x320: 200 frames, two orbits
JACKAL_DRIFT = 0.02  # odometry random walk: the drift descriptor LCD must undo
# the reference's 7-colour label palette (tests/test_rosbag2.py), row i = label i
LABEL_PALETTE = ((0, 0, 0), (255, 0, 0), (0, 255, 0), (0, 0, 255), (255, 255, 0), (255, 0, 255), (0, 255, 255))
# tests/test_rosbag2.py's overrides of configs/jackal_real.yaml (all but its
# grid: the config's own 128x128x48 stays), and the bag's topics
JACKAL_OVERRIDES = (
    "pipeline.active_window.motion_detector.max_range=5.0",
    "pipeline.active_window.object_detector.max_range=5.0",
    "pipeline.active_window.tracker.min_num_observations=3",
    "pipeline.active_window.object_extractor.min_num_observations=3",
    "pipeline.backend.lcd.min_time_gap=8.0",
    "pipeline.backend.lcd.min_descriptor_similarity=0.9",
    "pipeline.label_space.num_classes=7",
    "pipeline.label_space.object_labels=[2,3,4,5,6]",
    "pipeline.run_change_detection_every_n_frames=60",
    "dataset.depth_topic=/depth", "dataset.color_topic=/color", "dataset.label_topic=/labels",
    "dataset.pose_topic=/odom", "dataset.camera_info_topic=/camera_info", "dataset.max_range=5.0",
    "dataset.label_palette=" + json.dumps([list(c) for c in LABEL_PALETTE]).replace(" ", ""),
    "dataset.label_palette_ids=[0,1,2,3,4,5,6]",
)
LCD_POSE_ATOL = 1e-4  # card vs CPU replay of the detector: R and t
# The JAX package on the same bag (`scripts/torch_port_jackal.py write` with
# the port on the CPU, then `... run jax`, two runs on the CPU): both gave
# loop closures at the stamps (s) (20.0, 0.0), (25.0, 5.0), (30.0, 10.0),
# (35.6, 15.6), 5 solves, and the ATE of the optimised trajectory
# 0.045943601803713915 m against the odometry's 0.039885111629321526 m. The
# runs agree to the last digit, so the band has no width; the slack is the
# card's float spread of the solved agents against the CPU's (2e-6 m, PR 3)
# with room. The reference's loop closures do not bring its ATE below the
# odometry's on this bag (their registrations carry 0.3 to 1.2 degrees of
# rotation error where the synthetic odometry drifts in translation only),
# so that comparison is reported, not required.
JACKAL_ATE = (0.045943601803713915, 1e-5)
JACKAL_LOOP_CLOSURE_STAMPS_S = ((20.0, 0.0), (25.0, 5.0), (30.0, 10.0), (35.6, 15.6))


class CdrWriter:
    """XCDR1 little-endian writer: the inverse of khronos_tpu_torch.data.rosbag2.CdrReader
    (a copy of the test-side writer in tests/test_rosbag2.py)."""

    def __init__(self):
        self.buf = bytearray(b"\x00\x01\x00\x00")  # CDR_LE encapsulation

    def _align(self, n):
        self.buf.extend(b"\x00" * ((-(len(self.buf) - 4)) % n))

    def u8(self, v):
        self.buf.append(v & 0xFF)

    def u32(self, v):
        self._align(4)
        self.buf += struct.pack("<I", v)

    def i32(self, v):
        self._align(4)
        self.buf += struct.pack("<i", v)

    def f64(self, v):
        self._align(8)
        self.buf += struct.pack("<d", v)

    def string(self, s):
        b = s.encode() + b"\x00"
        self.u32(len(b))
        self.buf += b

    def raw_seq(self, b):
        self.u32(len(b))
        self.buf += b

    def header(self, stamp_ns, frame_id="cam"):
        self.i32(stamp_ns // 1_000_000_000)
        self.u32(stamp_ns % 1_000_000_000)
        self.string(frame_id)

    def done(self):
        return bytes(self.buf)


def encode_image(stamp_ns, img, encoding):
    w = CdrWriter()
    w.header(stamp_ns)
    w.u32(img.shape[0])
    w.u32(img.shape[1])
    w.string(encoding)
    w.u8(0)
    w.u32(img.nbytes // img.shape[0])
    w.raw_seq(img.tobytes())
    return w.done()


def encode_odometry(stamp_ns, t, q_wxyz):
    w = CdrWriter()
    w.header(stamp_ns)
    w.string("base")
    for v in t:
        w.f64(v)
    qw, qx, qy, qz = q_wxyz
    for v in (qx, qy, qz, qw):
        w.f64(v)
    for _ in range(36):  # pose covariance
        w.f64(0.0)
    return w.done()


def encode_camera_info(stamp_ns, H, W, fx, fy, cx, cy):
    w = CdrWriter()
    w.header(stamp_ns)
    w.u32(H)
    w.u32(W)
    w.string("plumb_bob")
    w.u32(0)  # empty d
    for v in (fx, 0, cx, 0, fy, cy, 0, 0, 1):
        w.f64(v)
    return w.done()


def rot_to_quat_wxyz(R):
    """Rotation matrix -> unit quaternion (w, x, y, z)."""
    R = np.asarray(R, np.float64)
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array([0.25 * s, (R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s])
    i = int(np.argmax(np.diag(R)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(R[i, i] - R[j, j] - R[k, k] + 1.0) * 2
    q = np.zeros(4)
    q[0] = (R[k, j] - R[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (R[j, i] + R[i, j]) / s
    q[1 + k] = (R[k, i] + R[i, k]) / s
    return q


def write_jackal_bag(directory, device) -> dict:
    """A rosbag2 (one .db3) of the port's office at 240x320 (fx = fy = 200),
    JACKAL_SECONDS at JACKAL_FPS, two orbits, with the sensor noise model and
    drifted odometry: raw /depth (16UC1, mm), /color (rgb8), /labels (rgb8
    through LABEL_PALETTE), /odom (nav_msgs/msg/Odometry, the drifted pose)
    and /camera_info. Rendered on `device` (the noise is drawn on the CPU, so
    the bag is the same from the card and the CPU up to the renderer's
    rounding). Returns the ground truth and odometry positions by stamp."""
    import sqlite3

    from khronos_tpu_torch.data import synthetic as syn

    seq = syn.SyntheticSequence(
        syn.office_scene(duration=JACKAL_SECONDS),
        syn.SyntheticSequenceConfig(duration=JACKAL_SECONDS, fps=JACKAL_FPS, n_loops=2.0, drift_rate=JACKAL_DRIFT,
                                    noise=syn.SensorNoiseConfig()),
        device=device,
    )
    palette = np.asarray(LABEL_PALETTE, np.uint8)
    topics = {"/depth": "sensor_msgs/msg/Image", "/color": "sensor_msgs/msg/Image",
              "/labels": "sensor_msgs/msg/Image", "/odom": "nav_msgs/msg/Odometry",
              "/camera_info": "sensor_msgs/msg/CameraInfo"}
    Path(directory).mkdir(parents=True, exist_ok=True)
    con = sqlite3.connect(str(Path(directory) / "bag_0.db3"))
    con.execute("CREATE TABLE topics(id INTEGER PRIMARY KEY, name TEXT, type TEXT,"
                " serialization_format TEXT, offered_qos_profiles TEXT)")
    con.execute("CREATE TABLE messages(id INTEGER PRIMARY KEY, topic_id INTEGER, timestamp INTEGER, data BLOB)")
    ids = {name: i for i, name in enumerate(topics, start=1)}
    con.executemany("INSERT INTO topics VALUES (?,?,?,?,?)", [(i, n, topics[n], "cdr", "") for n, i in ids.items()])
    gt = {"stamps_ns": [], "gt": [], "odom": []}
    rows = []
    for i in range(seq.n_frames):
        f = seq.render_frame(i)
        ts = int(f["stamp_ns"])
        depth_mm = (f["depth"].cpu().numpy() * 1000).astype(np.uint16)
        color = (np.clip(f["color"].cpu().numpy(), 0, 1) * 255).astype(np.uint8)
        labels = np.clip(f["labels"].cpu().numpy(), 0, 6)
        Ro, to = seq.odometry_pose(i)
        rows += [(ids["/depth"], ts, encode_image(ts, depth_mm, "16UC1")),
                 (ids["/color"], ts, encode_image(ts, color, "rgb8")),
                 (ids["/labels"], ts, encode_image(ts, palette[labels], "rgb8")),
                 (ids["/odom"], ts, encode_odometry(ts, [float(v) for v in np.asarray(to)], rot_to_quat_wxyz(Ro)))]
        gt["stamps_ns"].append(ts)
        gt["gt"].append(np.asarray(f["t_gt"], np.float64))
        gt["odom"].append(np.asarray(to, np.float64))
    cam = seq.camera
    rows.append((ids["/camera_info"], gt["stamps_ns"][0],
                 encode_camera_info(gt["stamps_ns"][0], cam.height, cam.width, cam.fx, cam.fy, cam.cx, cam.cy)))
    con.executemany("INSERT INTO messages(topic_id, timestamp, data) VALUES (?,?,?)", rows)
    con.commit()
    con.close()
    return {k: np.asarray(v) for k, v in gt.items()}


def trajectory_ates(agents_stamps_ns, agents_t, truth) -> dict:
    """ATE (RMSE, m) of the agent trajectory and of the odometry against the
    ground truth, as tests/test_rosbag2.py measures them."""
    from khronos_tpu_torch.eval.evaluators import evaluate_trajectory

    est = evaluate_trajectory(np.asarray(agents_stamps_ns, np.int64), np.asarray(agents_t, np.float64),
                              truth["stamps_ns"], truth["gt"])
    odo = evaluate_trajectory(truth["stamps_ns"], truth["odom"], truth["stamps_ns"], truth["gt"])
    return {"optimised": float(est["ate_rmse"]), "odometry": float(odo["ate_rmse"])}


def record_lcd():
    """Wraps the descriptor detector's add_keyframe: records every call's
    inputs and loop closures, and times each registration (robust_icp,
    synchronized)."""
    from khronos_tpu_torch.backend import loop_closure as lc

    record = {"calls": [], "registration_ms": []}
    originals = (lc.DescriptorLoopClosureDetector.add_keyframe, lc.robust_icp)

    def add_keyframe(self, *args):
        out = originals[0](self, *args)
        record["calls"].append((copy.deepcopy(args), [(c.from_key, c.to_key, c.R.copy(), c.t.copy()) for c in out]))
        return out

    def robust_icp(*args, **kwargs):
        torch.cuda.synchronize()
        ts = time.perf_counter()
        out = originals[1](*args, **kwargs)
        torch.cuda.synchronize()
        record["registration_ms"].append((time.perf_counter() - ts) * 1e3)
        return out

    lc.DescriptorLoopClosureDetector.add_keyframe = add_keyframe
    lc.robust_icp = robust_icp

    def uninstall():
        lc.DescriptorLoopClosureDetector.add_keyframe, lc.robust_icp = originals

    return record, uninstall


def replay_lcd(config, calls, device):
    """The recorded add_keyframe calls through a fresh descriptor detector on
    `device`; its loop closures."""
    det = config.create(device=device)
    return [[(c.from_key, c.to_key, c.R, c.t) for c in det.add_keyframe(*args)] for args, _ in calls]


def phase_jackal_path(card_name, device="cuda", overrides=()):
    """`python -m khronos_tpu_torch.run --config configs/jackal_real.yaml` on a
    rosbag2 that this phase writes (the port's office with sensor noise and
    drifted odometry, 200 frames of 240x320), with the reference test's
    overrides and the config's own 128x128x48 grid: descriptor LCD with GNC
    registration and no oracle. Checks the finished run and its frame count,
    the JAX package's loop closures (by stamp) and a solve, the optimised
    ATE within the JAX package's band (and reports it beside the
    odometry's), A once a frame plus once a room segmentation and B once a
    frame, and the card's detector calls replayed on the CPU giving the same
    loop closures."""
    import tempfile

    from khronos_tpu_torch.stm.serialization import load_scene_graph
    from khronos_tpu_torch.utils.logging import FINISHED_CLEANLY, ExperimentLogger

    out_dir = ROOT / "build" / "jackal_path"
    with tempfile.TemporaryDirectory(prefix="jackal_bag_") as bag:
        ts = time.perf_counter()
        truth = write_jackal_bag(bag, device)
        write_s = time.perf_counter() - ts
        bag_mib = sum(p.stat().st_size for p in Path(bag).iterdir()) / 2**20
        log(f"jackal_path: wrote {len(truth['stamps_ns'])} frames ({bag_mib:.1f} MiB) in {write_s:.1f} s")
        record, uninstall = record_lcd()
        try:
            run = run_config(JACKAL_CONFIG, (*JACKAL_OVERRIDES, f"dataset.path={bag}", *overrides), out_dir, device)
        finally:
            uninstall()
    name = "jackal_path"
    n = run["n"]
    pipe = run["pipe"]
    be = pipe.backend
    dsg = load_scene_graph(str(out_dir / "dsg.npz"))
    ate = trajectory_ates([a.stamp_ns for a in dsg.agents], np.stack([a.t_w_b for a in dsg.agents]), truth)
    log(f"{name}: loop closures " + ", ".join(
        f"{c.from_key}->{c.to_key} (score {c.score:.4f}, |t| {np.linalg.norm(c.t):.3f} m)" for c in be.loop_closures)
        + f"; {be.num_optimizations} solves; ATE {ate}")
    require(ExperimentLogger.has_flag(str(out_dir), FINISHED_CLEANLY), f"{name}: not finished cleanly")
    require(n == len(truth["stamps_ns"]), f"{name}: {n} frames of {len(truth['stamps_ns'])}")
    require(len(be.loop_closures) >= 1, f"{name}: the descriptor LCD never fired")
    require(be.num_optimizations >= 1, f"{name}: no solve")
    rooms = run["room_segmentations"]
    require(device != "cuda" or run["launches"] == {"propagate": n + rooms, "gather": n},
            f"{name}: launches {run['launches']}: want A {n} + {rooms}, B {n}")
    require(ate["odometry"] > 0.01, f"{name}: drift injection broken: odometry ATE {ate['odometry']}")
    bar, slack = JACKAL_ATE
    require(ate["optimised"] <= bar + slack,
            f"{name}: optimised ATE {ate['optimised']} above the JAX band {bar} + {slack}")
    closures = [(c.from_key, c.to_key) for c in be.loop_closures]
    key_stamp = {a.key: a.stamp_ns for a in dsg.agents}
    stamps = tuple((round(key_stamp[a] * 1e-9, 3), round(key_stamp[b] * 1e-9, 3)) for a, b in closures)
    require(stamps == JACKAL_LOOP_CLOSURE_STAMPS_S,
            f"{name}: loop closures at {stamps} (s), the JAX package's at {JACKAL_LOOP_CLOSURE_STAMPS_S}")
    # the card's detector calls through the port's detector on the CPU
    calls = record["calls"]
    card = [out for _, out in calls]
    cpu = replay_lcd(pipe.config.backend.lcd.config, calls, "cpu")
    require([[(a, b) for a, b, *_ in o] for o in cpu] == [[(a, b) for a, b, *_ in o] for o in card],
            f"{name}: the CPU replay's loop closures differ from the card's")
    lcd_err = max([0.0] + [float(max(np.abs(R - R2).max(), np.abs(t - t2).max()))
                           for o, o2 in zip(card, cpu) for (_, _, R, t), (_, _, R2, t2) in zip(o, o2)])
    require(lcd_err <= LCD_POSE_ATOL, f"{name}: card vs CPU loop closure poses differ by {lcd_err}")
    spans = run["spans"]
    lcd_span = spans.get("backend/lcd_section", {"calls": 0, "total_ms": 0.0})
    reg = record["registration_ms"]
    result = summary_of(name, run, {})
    result.update(
        loop_closures=closures, loop_closure_stamps_s=stamps, num_optimizations=be.num_optimizations, ate=ate,
        bag_mib=bag_mib,
        bag_write_s=write_s, lcd_section_ms=lcd_span["total_ms"], lcd_section_calls=lcd_span["calls"],
        lcd_section_ms_per_call=lcd_span["total_ms"] / max(lcd_span["calls"], 1), registrations=len(reg),
        registration_ms=reg, registration_ms_median=statistics.median(reg) if reg else None,
        lcd_replay_max_pose_err=lcd_err, ate_band=JACKAL_ATE,
    )
    log(f"{name} ({card_name}): {n} frames, loop closures {closures} at {stamps} s, {be.num_optimizations} solves; ATE "
        f"optimised {ate['optimised']:.4f} m, odometry {ate['odometry']:.4f} m (JAX band {bar} + {slack}); "
        f"backend/lcd_section {lcd_span['total_ms']:.1f} ms in {lcd_span['calls']} calls "
        f"({result['lcd_section_ms_per_call']:.2f} ms each); {len(reg)} registrations"
        + (f", {statistics.median(reg):.1f} ms each (median; {min(reg):.1f} to {max(reg):.1f})" if reg else "")
        + f"; card vs CPU replay of the detector: the same loop closures, poses within {lcd_err:.2e}")
    if device == "cuda":
        result["kernel_rows"] = kernel_rows_on(name, run)
    return result


SWEEP = [(d, tx, ty) for d in (1, 2, 3, 4) for tx, ty in ((8, 8), (8, 4), (4, 8), (4, 4))]


def phase_sweep(main):
    """Kernel A's design space: each (D, TX, TY) of SWEEP, D the
    rounds a step and TX x TY x (32 - 2 D) the tile, is csrc/propagate.cu with
    those constants, built alone (one nvcc each, all at once), checked bit for
    bit and timed on the dense input and the main path's inputs."""
    import ctypes
    import re

    from khronos_tpu_torch.ops import native, propagate

    source = (native.CSRC / "propagate.cu").read_text()
    sweep_dir = native.BUILD_DIR / "sweep"
    sweep_dir.mkdir(parents=True, exist_ok=True)
    builds = []
    for d, tx, ty in SWEEP:
        text = re.sub(r"constexpr int D = \d+;", f"constexpr int D = {d};", source)
        text = re.sub(r"constexpr int TX = \d+, TY = \d+,", f"constexpr int TX = {tx}, TY = {ty},", text)
        cu = sweep_dir / f"propagate_d{d}_{tx}x{ty}.cu"
        cu.write_text(text)
        cmd = [native._nvcc(), *native.NVCC_FLAGS, "-shared", "-o", str(cu.with_suffix(".so")), str(cu)]
        builds.append(((d, tx, ty), cu.with_suffix(".so"),
                       subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    captured = main["captured"]["propagate_labels_3d_cuda"]
    inputs = [("dense", *dense_input(0))] + [(f"frame {WARMUP + FRAMES + i}", a[0], a[1]) for i, a in enumerate(captured)]
    wants = [propagate.propagate_labels_3d_plain(lab, grow, ITERATIONS) for _, lab, grow in inputs]
    results = []
    for (d, tx, ty), so, proc in builds:
        report, _ = proc.communicate()
        require(proc.returncode == 0, f"nvcc failed on the sweep's D={d} {tx}x{ty}:\n{report}")
        fn = ctypes.CDLL(str(so)).khr_propagate
        fn.argtypes, fn.restype = list(native.SIGNATURES["khr_propagate"]), ctypes.c_int
        tile = (tx, ty, 32 - 2 * d)

        def call(lab, grow):
            n = math.prod(-(-s // t) for s, t in zip(lab.shape, tile))
            out, tmp = torch.empty_like(lab), torch.empty_like(lab)
            ws = torch.empty(propagate.WS_HEADER + 2 * n, dtype=torch.int32, device=lab.device)
            native.check(fn(lab.data_ptr(), grow.view(torch.uint8).data_ptr(), out.data_ptr(), tmp.data_ptr(),
                            ws.data_ptr(), *lab.shape, n, ITERATIONS, torch.cuda.current_stream().cuda_stream),
                         "khr_propagate")
            return out

        us = []
        for (name, lab, grow), want in zip(inputs, wants):
            require(torch.equal(call(lab, grow), want), f"the sweep's D={d} {tx}x{ty} differs on {name}")
            us.append(time_ms(lambda: call(lab, grow)) * 1e3)
        results.append({"depth": d, "tile": list(tile), "dense_us": us[0], "main_path_us": us[1:],
                        "main_path_mean_us": statistics.fmean(us[1:])})
        log(f"sweep D={d} tile {tx}x{ty}x{32 - 2 * d}: dense {us[0]:.2f} us; main path "
            f"{', '.join(f'{u:.2f}' for u in us[1:])} us (mean {statistics.fmean(us[1:]):.2f})")
    return results


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", default=None, help="write a torch.profiler summary of a few more frames here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this script runs on the card only", file=sys.stderr)
        return 1
    from khronos_tpu_torch.ops import native  # fails outside a checkout of the repo

    # 1) card
    card = nvidia_smi()
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    log(f"card: {card}")

    # 2) build
    native.load_library()
    log(f"build: {native.build_info['seconds']:.2f} s -> {native.build_info['path']}")
    for line in native.build_info["ptxas"].splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            print(line, file=sys.stderr)

    # 3) kernels against their plain versions; the fused step, card vs CPU
    phase_kernel_checks()
    phase_parity()
    # 4) main path
    main_path = phase_main_path(args.profile)
    main_path["frames"] = FRAMES
    # 5) kernels on the main path's inputs, timed
    kernels = phase_kernels(main_path)
    # 6) object extraction and the backend
    backend_path = phase_backend_path(card)
    # 7) the pipeline: places, change detection, the reconciler, the 4D map
    # and the evaluation, run.main end to end; A on its room grid
    pipeline_path = phase_pipeline_path(card)
    kernels.append(phase_room_fixpoint(pipeline_path))
    # 8) the apartment and open-set configs as users run them
    apartment_path = phase_apartment_path(card)
    kernels += apartment_path.pop("kernel_rows")
    openset_path = phase_openset_path(card)
    kernels += openset_path.pop("kernel_rows")
    # 9) real-data input and loop closure without the oracle: the jackal config on a rosbag2
    jackal_path = phase_jackal_path(card)
    kernels += jackal_path.pop("kernel_rows")
    # 10) kernel A at other rounds per step and tile shapes
    sweep = phase_sweep(main_path)

    log(json.dumps({"main_path": {k: main_path[k] for k in ("fps", "ms_per_frame", "window_ms_per_frame",
                                                                 "spin_once_host_ms", "host_stage_ms_per_frame",
                                                                 "peak_mib", "launches")},
                    "backend_path": backend_path, "pipeline_path": pipeline_path,
                    "apartment_path": apartment_path, "openset_path": openset_path, "jackal_path": jackal_path,
                    "propagate_sweep": sweep,
                    "card": card}))
    log(f"card: {card}")
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
