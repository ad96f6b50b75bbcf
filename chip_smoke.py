#!/usr/bin/env python3
"""On-card smoke run of khronos_tpu_torch, the PyTorch + CUDA port.

    python3 chip_smoke.py [--profile PATH]

Needs one CUDA card (an H100 is the target) and the CUDA toolkit (`nvcc`).
Phases, in order; any failure raises and the run exits non-zero:

1. card: torch / CUDA versions, and the card's name and power limit as
   `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` gives them;
2. build: both hand-written kernels from the sources in this checkout (one
   `nvcc` per source, all started together) into build/khronos_tpu_torch/;
3. checks: each kernel against its plain PyTorch version on made-up inputs
   at the main path's shapes (A at 112x112x48 over 16 rounds: random seeds,
   and a wall that keeps two labels apart; B on a [307200, 2] image holding
   NaN bit patterns, 602,112 rows), bit for bit; then the fused per-frame
   step at a small size on the card and on the CPU (the CPU path is held to
   the JAX package by tests/test_torch_*.py): id images and the volume's
   integer state bit for bit, floats to 1e-5;
4. main path: the port's ActiveWindow at the bench operating point (480x640
   RGB-D + semantics from the port's synthetic office, a 160x160x48 grid at
   0.1 m, detection stride 2, FreeSpaceMotionDetector min 400 px,
   ConnectedSemantics min 50 px, MaxIouTracker): warm-up frames, then timed
   frames, then finish_mapping, with every kernel's launch count set to 0
   just before the timed frames and read just after them. Asserts
   that both kernels were launched, that the mesh has triangles and that a
   dynamic track was found;
5. kernels: each kernel's wrapper on the inputs the main path gave it (the
   gather also on a NaN-pattern image with the main path's rows), bit-exact
   against its plain PyTorch version, timed beside it, beside one library
   call where there is one, and beside its bound (device times from CUDA
   events; see time_ms);
6. prints the kernels line as JSON, then `{"ok": true, "device": ...}` last.

With --profile PATH it also traces a few more frames with torch.profiler and
writes the device time by kernel, the device operations per frame and the
device busy share to PATH.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
FP32_OPS_PER_S = 67e12  # H100 SXM 32-bit operations outside the tensor cores
WARMUP, FRAMES = 10, 40  # main path: warm-up frames, then timed frames
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


def in_turns(plain, kernel):
    """(kernel ms, plain ms), measured plain, kernel, kernel, plain."""
    p1, k1, k2, p2 = time_ms(plain), time_ms(kernel), time_ms(kernel), time_ms(plain)
    return (k1 + k2) / 2, (p1 + p2) / 2


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

    n_total = WARMUP + FRAMES + 1 + (PROFILE_FRAMES if profile_path else 0)
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
    require(counts["propagate"] > 0 and counts["gather"] > 0, counts)

    # one more frame with the wrappers recording their inputs (clones), for
    # the kernel checks on main-path inputs; launches here are not counted
    captured = {}

    def record(module, name):
        fn = getattr(module, name)

        def wrapped(*a):
            captured[name] = [x.clone() if torch.is_tensor(x) else x for x in a]
            return fn(*a)

        setattr(module, name, wrapped)
        return lambda: setattr(module, name, fn)

    restore = [record(propagate, "propagate_labels_3d_cuda"), record(gather, "gather_rows_cuda")]
    last = run(frames[WARMUP + FRAMES])
    for r in restore:
        r()
    require(set(captured) == {"propagate_labels_3d_cuda", "gather_rows_cuda"}, captured.keys())

    if profile_path:
        profile(aw, run, frames[WARMUP + FRAMES + 1:], profile_path)

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


def check_propagate(propagate, lab, grow, iterations, name) -> int:
    got = propagate.propagate_labels_3d_cuda(lab, grow, iterations)
    want = propagate.propagate_labels_3d_plain(lab, grow, iterations)
    torch.cuda.synchronize()
    require(torch.equal(got, want), f"kernel A differs from its plain version ({name})")
    return int((got.long() - want.long()).abs().max())


def check_gather(gather, img, idx, name) -> int:
    got = gather.gather_rows_cuda(img, idx).view(torch.int32)
    want = gather.gather_rows_plain(img, idx).view(torch.int32)
    torch.cuda.synchronize()
    require(torch.equal(got, want), f"kernel B differs from its plain version ({name})")
    return int((got.long() - want.long()).abs().max())


def phase_kernel_checks():
    """Both kernels on made-up inputs at the main path's shapes, bit-exact
    against their plain versions, before the main path runs."""
    from khronos_tpu_torch.ops import gather, propagate

    g = torch.Generator(device="cuda").manual_seed(0)
    seeds = torch.rand(CROP, device="cuda", generator=g) < 0.02
    grow = (torch.rand(CROP, device="cuda", generator=g) < 0.4) | seeds
    lin = torch.arange(VOXELS, dtype=torch.int32, device="cuda").view(CROP)
    check_propagate(propagate, torch.where(seeds, lin, -1), grow, ITERATIONS, "random seeds")
    # a wall of non-growable cells keeps two labels apart, however many rounds
    wall_lab = torch.full(CROP, -1, dtype=torch.int32, device="cuda")
    wall_lab[1, 1, 1] = 100
    wall_lab[100, 100, 40] = 200
    wall_grow = torch.ones(CROP, dtype=torch.bool, device="cuda")
    wall_grow[:, 56, :] = False
    check_propagate(propagate, wall_lab, wall_grow, ITERATIONS, "wall")
    out = propagate.propagate_labels_3d_cuda(wall_lab, wall_grow, 112)
    require(bool((out[:, :56] == 100).all() & (out[:, 57:] == 200).all() & (out[:, 56] == -1).all()),
            "the wall did not keep labels 100 and 200 apart")
    idx = torch.randint(0, IMG_ROWS, (VOXELS,), device="cuda", generator=g, dtype=torch.int32)
    idx[:4] = torch.tensor([-1, -IMG_ROWS - 1, IMG_ROWS, 2**31 - 1], dtype=torch.int32)  # clamped
    check_gather(gather, nan_pattern_image(g), idx, "NaN patterns, random rows")
    log(f"kernel checks: A at {CROP} x {ITERATIONS} rounds (random seeds, wall) and B at "
        f"[{IMG_ROWS}, 2] x {VOXELS} rows (NaN patterns) bit-exact against their plain versions")


def phase_kernels(main):
    """Both kernels on the inputs the main path gave them: bit-exact against
    their plain versions, then timed beside them, the library call and the
    bound."""
    from khronos_tpu_torch.ops import gather, propagate

    frames = main["frames"]
    results = []
    # ---- A: label propagation ----
    lab, grow, iterations = main["captured"]["propagate_labels_3d_cuda"]
    require(tuple(lab.shape) == CROP and iterations == ITERATIONS, (lab.shape, iterations))
    err = check_propagate(propagate, lab, grow, iterations, "main path")
    k_ms, p_ms = in_turns(lambda: propagate.propagate_labels_3d_plain(lab, grow, iterations),
                          lambda: propagate.propagate_labels_3d_cuda(lab, grow, iterations))
    bytes_a = lab.nbytes + grow.nbytes + lab.nbytes  # labels + mask in, labels out
    # per round and cell: the 27-point max as a separable 3 x 3 x 3 max (6
    # operations) + the mask select; 32-bit integer work, held to the card's
    # 32-bit rate outside the tensor cores
    ops_a = iterations * 7 * lab.numel()
    t_bytes, t_ops = bytes_a / HBM_BYTES_PER_S, ops_a / FP32_OPS_PER_S
    results.append({
        "name": "propagate_labels_3d", "route": "cuda", "source": "khronos_tpu_torch/csrc/propagate.cu",
        "replaces": "khronos_tpu/ops/pallas/propagate.py:49",
        "launches": main["launches"]["propagate"], "launches_per_frame": main["launches"]["propagate"] / frames,
        "match": True, "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
        "bound_ms": max(t_bytes, t_ops) * 1e3, "bound_us": max(t_bytes, t_ops) * 1e6,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None, "shape": list(lab.shape), "iterations": iterations,
    })
    # ---- B: row gather ----
    img, idx = main["captured"]["gather_rows_cuda"]
    require(tuple(img.shape) == (IMG_ROWS, 2) and tuple(idx.shape) == (VOXELS,), (img.shape, idx.shape))
    err = check_gather(gather, img, idx, "main path")
    g = torch.Generator(device="cuda").manual_seed(1)
    err = max(err, check_gather(gather, nan_pattern_image(g), idx, "NaN patterns, projective rows"))
    k_ms, p_ms = in_turns(lambda: gather.gather_rows_plain(img, idx), lambda: gather.gather_rows_cuda(img, idx))
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
        log(f"kernel {r['name']}: bit-exact on the main path's inputs, {r['ms'] * 1e3:.1f} us "
            f"(plain {r['plain_ms'] * 1e3:.1f} us, library {lib}), bound {r['bound_us']:.2f} us "
            f"by {r['bound_by']}, {r['launches_per_frame']:.1f} launches/frame")
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

    log(json.dumps({"main_path": {k: main_path[k] for k in ("fps", "ms_per_frame", "window_ms_per_frame",
                                                                 "spin_once_host_ms", "host_stage_ms_per_frame",
                                                                 "peak_mib", "launches")},
                    "card": card}))
    log(f"card: {card}")
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
