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
   602,112 rows. Then the fused per-frame step at a small size on the card
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
6. sweep: kernel A built and timed at other rounds per step and tile shapes
   (phase_sweep), the measurements behind the ones csrc/propagate.cu uses;
7. prints the kernels line as JSON, then `{"ok": true, "device": ...}` last.

With --profile PATH it also traces a few more frames with torch.profiler and
writes the device time by kernel, the device operations per frame and the
device busy share to PATH.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

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
    got, want = av.state_to_numpy(states["cuda"]), av.state_to_numpy(states["cpu"])
    worst = 0.0
    for name, a, b in zip(got._fields, got, want):
        if a.dtype.kind == "f":
            fin = np.isfinite(b)
            require((np.isfinite(a) == fin).all() and (a[~fin] == b[~fin]).all(), name)
            worst = max(worst, float(np.abs(a[fin] - b[fin]).max(initial=0.0)))
        else:
            require((a == b).all(), name)
    require(worst <= 1e-5, worst)
    require(n_dyn > 0 and n_obj > 0, (n_dyn, n_obj))
    log(f"parity: {n} frames at 96x128, card == CPU (ids, counts, integer state exact; "
        f"float state max |diff| {worst:.3g}); dynamic ids {n_dyn}, object ids {n_obj}")


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

    outputs.append(aw.finish_mapping(last))
    n_tris = sum(len(o.mesh_vertices) for o in outputs)
    tracks = [t for o in outputs for t in (o.pending_tracks or [])]
    n_dyn = sum(t.is_dynamic for t in tracks)
    verts = np.concatenate([o.mesh_vertices for o in outputs])
    require(n_tris > 0 and np.isfinite(verts).all(), n_tris)
    require(n_dyn > 0, f"no dynamic track among {len(tracks)} finished tracks")
    state = aw.state
    require(tuple(state.tsdf.shape) == (160, 160, 48), f"volume shape {tuple(state.tsdf.shape)}")
    require(bool(torch.isfinite(state.tsdf).all() & torch.isfinite(state.color).all()),
            "non-finite tsdf or color in the volume")
    log(f"mesh triangles {n_tris}, finished tracks {len(tracks)} ({n_dyn} dynamic)")
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
    g = torch.Generator(device="cuda").manual_seed(0)
    idx = torch.randint(0, IMG_ROWS, (VOXELS,), device="cuda", generator=g, dtype=torch.int32)
    idx[:4] = torch.tensor([-1, -IMG_ROWS - 1, IMG_ROWS, 2**31 - 1], dtype=torch.int32)  # clamped
    check_gather(gather, nan_pattern_image(g), idx, "NaN patterns, random rows")
    log(f"kernel checks: A at {CROP} x {ITERATIONS} rounds (random seeds), the wall at {ITERATIONS} and 112 "
        f"rounds, {n_odd} odd shape x input x iterations cases, a {big} grid with more active tiles a block "
        f"than its list holds, and a CUDA-graph replay, one launch each; B at "
        f"[{IMG_ROWS}, 2] x {VOXELS} rows (NaN patterns); all bit-exact against their plain versions")


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
    # 6) kernel A at other rounds per step and tile shapes
    sweep = phase_sweep(main_path)

    log(json.dumps({"main_path": {k: main_path[k] for k in ("fps", "ms_per_frame", "window_ms_per_frame",
                                                                 "spin_once_host_ms", "host_stage_ms_per_frame",
                                                                 "peak_mib", "launches")},
                    "propagate_sweep": sweep, "card": card}))
    log(f"card: {card}")
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
