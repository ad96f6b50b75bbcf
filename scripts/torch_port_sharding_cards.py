"""The grid in slabs over several cards: the step, the window, the office
config and a checkpoint.

At chip_smoke.py's sharding_path widths (480x640, a 160x160x48 grid at
0.1 m, detection stride 2, the bench detectors), on a host with 2 or more
cards:

1. the step: the fused step over a device mesh (`parallel/sharding.py`,
   cropping off) with the slabs round-robin over every visible card,
   against the one-grid step with cropping off on the first card, as
   chip_smoke.py's `sharded_step_parity` holds it (id images, cluster counts
   and ids, labels and the volume's integer fields bit for bit; packed stats
   within atol 2e-3 / rtol 1e-5, float fields within 1e-5); A and B launch
   once a slab a frame. Then the step timed a frame for one grid, N shards
   on the first card and N shards over N cards, in turns;
2. the window: `ActiveWindow(n_devices=N)` with N = the cards, one slab a
   card (`sharding.mesh_for`), against the same window with every slab on
   the first card (built while it sees one card) on the same frames: slab i
   on card i, the final volume's integer fields and the emitted mesh (every
   delta, in emission order) bit for bit, float fields within 1e-5, the same
   finished tracks and objects, A and B once a slab a frame. ms a frame in turns for
   n_devices = 1, 2, .., N over as many cards and N slabs on the first card,
   with the reference's scaling figure, efficiency t(1) / (k t(k))
   (scripts/scaling_study.py). A and B on a slab on the second card, bit for
   bit against their plain versions and timed there;
3. the office config at n_devices=N through run.main, quality held to
   chip_smoke.py's REFERENCE_QUALITY;
4. a checkpoint of the office config at n_devices=N (chip_smoke.py's
   checkpoint_resume): restored with slab i on card i, resumed equal to the
   uninterrupted run.

Every timing synchronises every card it used.

    python3 scripts/torch_port_sharding_cards.py     # on a host with 2+ cards

The last line of its output is one JSON object with the results.
"""

from __future__ import annotations

import collections
import contextlib
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (the repo's root on the path first)

WARMUP, FRAMES = cs.WARMUP, cs.FRAMES
OFFICE_OVERRIDES = cs.PIPELINE_OVERRIDES  # chip_smoke.py's office run, with n_devices appended


def step_ms(step, start, frames, devices) -> float:
    """ms a frame of `step` over the frames after WARMUP, from `start`."""
    from khronos_tpu_torch.parallel import sharding

    state = start
    for f in frames[:WARMUP]:
        state = step(state, f["depth"], f["color"], f["labels"], f["R_w_c"], f["t_w_c"], f["t"])[0]
    sharding.synchronize(devices)
    t0 = time.perf_counter()
    for f in frames[WARMUP:]:
        state = step(state, f["depth"], f["color"], f["labels"], f["R_w_c"], f["t_w_c"], f["t"])[0]
    sharding.synchronize(devices)
    return (time.perf_counter() - t0) / (len(frames) - WARMUP) * 1e3


def run(cards, size=(480, 640), grid=(160, 160, 48)):
    """The step's check and times over the devices `cards` (the first one
    holds the images and the one-grid step); `size` and `grid` are cut for a
    rehearsal on the CPU."""
    from khronos_tpu_torch.active_window import fused_step as fs
    from khronos_tpu_torch.active_window.active_window import ActiveWindowConfig
    from khronos_tpu_torch.config import build
    from khronos_tpu_torch.data import synthetic as syn
    from khronos_tpu_torch.map import active_volume as av
    from khronos_tpu_torch.ops import gather, propagate
    from khronos_tpu_torch.parallel import sharding

    cards = [torch.device(c) for c in cards]
    n = len(cards)
    seq = cs.make_sequence(syn, WARMUP + FRAMES, size[0], size[1], cards[0])
    frames = [seq.render_frame(i) for i in range(WARMUP + FRAMES)]
    config = build(ActiveWindowConfig, {**cs.bench_config(), "volumetric_map": {"grid_shape": list(grid),
                                                                                "voxel_size": 0.1}})
    counts = tuple(sorted({2, n}))
    propagate.launches = gather.launches = 0
    parity = cs.sharded_step_parity(seq, frames, config, cards, counts=counts)
    want = (1 + sum(counts)) * len(frames)  # once a slab a frame, and once a frame for the one grid
    if cards[0].type == "cuda":  # CPU tensors take the plain versions, which count nothing
        cs.require(propagate.launches == want and gather.launches == want,
                   f"launches A {propagate.launches}, B {gather.launches}, want {want} each")
        held = [torch.cuda.max_memory_allocated(c) for c in cards]
        cs.require(all(m > 0 for m in held), f"a card held no memory: {held}")

    vol, md, od = config.volumetric_map, config.motion_detector.config, config.object_detector.config
    ls = syn.default_label_space()
    origin = np.floor(np.asarray(frames[0]["t_w_c"]) / vol.voxel_size - np.asarray(vol.grid_shape) / 2.0)

    def fresh(mesh):
        state = av.create(vol, device=cards[0])._replace(origin=torch.from_numpy(origin.astype(np.int32)))
        return sharding.shard_volume(state, mesh) if mesh else state

    modes = {"one grid": None, f"{n} shards on one card": [cards[0]], f"{n} shards over {n} cards": cards}
    meshes = {name: sharding.make_mesh(n, devices=d) if d else None for name, d in modes.items()}
    steps = {name: fs.make_frame_step(vol, seq.camera, md, od, ls, detection_stride=2, crop=False, mesh=mesh)
             for name, mesh in meshes.items()}
    ms = {name: [] for name in modes}
    for order in (list(modes), list(modes)[::-1]):
        for name in order:
            ms[name].append(step_ms(steps[name], fresh(meshes[name]), frames, cards))
    result = {"cards": n, "counts": list(counts), "parity": parity, "launches_each": want,
              "ms_per_frame": {k: statistics.fmean(v) for k, v in ms.items()}, "ms_per_frame_runs": ms,
              "size": list(size), "grid": list(grid), "frames": FRAMES}
    cs.log("sharded step, ms a frame in turns: " + ", ".join(
        f"{k} {statistics.fmean(v):.2f} ({', '.join(f'{x:.2f}' for x in v)})" for k, v in ms.items()))
    return result


@contextlib.contextmanager
def cards_seen(k: int):
    """While the block runs, torch reports only the first k cards, as
    CUDA_VISIBLE_DEVICES would to a new process: a window built here takes
    its mesh over those cards (`sharding.mesh_for`)."""
    count = torch.cuda.device_count
    torch.cuda.device_count = lambda: min(k, count())
    try:
        yield
    finally:
        torch.cuda.device_count = count


def window(config, seq, frames, n_devices, seen, device, capture=False):
    """ActiveWindow(n_devices) built while it sees `seen` cards: WARMUP
    frames, FRAMES timed (launch counts set to 0 just before and read just
    after, every card of the mesh synchronised), then finish_mapping. With
    `capture`, the last frames' kernel inputs on the mesh's second card are
    cloned (the run is then not timed for the record). Returns the slabs'
    cards, ms a frame, launches, the final volume (numpy), the emitted mesh
    in emission order, the finished tracks and the captured inputs."""
    from khronos_tpu_torch.active_window.active_window import ActiveWindow, ActiveWindowConfig
    from khronos_tpu_torch.active_window.frame_data import FrameData
    from khronos_tpu_torch.config import build
    from khronos_tpu_torch.data import synthetic as syn
    from khronos_tpu_torch.map import active_volume as av
    from khronos_tpu_torch.ops import gather, propagate
    from khronos_tpu_torch.parallel import sharding

    with cards_seen(seen):
        aw = ActiveWindow(build(ActiveWindowConfig, {**config, "n_devices": n_devices}), seq.camera,
                          syn.default_label_space(), device=device)
    aw.defer_object_extraction = True
    slab_cards = [s.tsdf.device for s in aw.state.slabs]
    captured = {"propagate": collections.deque(maxlen=cs.CAPTURED), "gather": collections.deque(maxlen=cs.CAPTURED)}
    restore = []
    if capture and len(set(slab_cards)) > 1:
        second = slab_cards[1]
        for module, name, key in ((propagate, "propagate_labels_3d_cuda", "propagate"),
                                  (gather, "gather_rows_cuda", "gather")):
            fn = getattr(module, name)

            def wrapped(*a, fn=fn, key=key):
                if a[0].device == second:
                    captured[key].append([x.clone() if torch.is_tensor(x) else x for x in a])
                return fn(*a)

            setattr(module, name, wrapped)
            restore.append((module, name, fn))
    outputs = []

    def run(f):
        frame = FrameData(stamp_ns=f["stamp_ns"], depth=f["depth"], color=f["color"], labels=f["labels"],
                          R_w_c=f["R_w_c"], t_w_c=f["t_w_c"])
        out = aw.spin_once(frame)
        if out is not None:
            outputs.append(out)
        return frame

    try:
        for f in frames[:WARMUP]:
            run(f)
        aw.synchronize()
        propagate.launches = gather.launches = 0
        t0 = time.perf_counter()
        for f in frames[WARMUP: WARMUP + FRAMES]:
            last = run(f)
        aw.synchronize()
        dt = time.perf_counter() - t0
        launches = {"propagate": propagate.launches, "gather": gather.launches}
    finally:
        for module, name, fn in restore:
            setattr(module, name, fn)
    outputs.append(aw.finish_mapping(last))  # extracts the tracks still open inline
    mesh = {k: np.concatenate([getattr(o, k) for o in outputs])
            for k in ("mesh_vertices", "mesh_colors", "mesh_first_ns", "mesh_last_ns", "mesh_labels")}
    tracks = sorted(tuple(o.stamp_ns for o in t.observations) for out in outputs for t in (out.pending_tracks or []))
    objects = [{"node_id": o.node_id, "bbox_min": o.bbox_min, "bbox_max": o.bbox_max,
                "mesh_vertices": o.mesh_vertices, "mesh_faces": o.mesh_faces} for o in outputs[-1].objects]
    return {"slab_cards": slab_cards, "mesh_cards": list(aw.mesh.devices), "ms_per_frame": dt / FRAMES * 1e3,
            "launches": launches, "state": av.state_to_numpy(sharding.gather_volume(aw.state)), "mesh": mesh,
            "tracks": tracks, "objects": objects, "captured": captured}


def same_window(a, b, what) -> float:
    """Two windows' results: integer fields, the emitted mesh and the tracks
    bit for bit; float fields within chip_smoke's SHARDED_FLOAT_ATOL. The
    largest float difference."""
    worst = 0.0
    for name, x, y in zip(a["state"]._fields, a["state"], b["state"]):
        if x.dtype.kind == "f":
            fin = np.isfinite(y)
            cs.require((np.isfinite(x) == fin).all() and (x[~fin] == y[~fin]).all(), f"{what}: {name}")
            worst = max(worst, float(np.abs(x[fin] - y[fin]).max(initial=0.0)))
        else:
            cs.require((x == y).all(), f"{what}: {name}")
    cs.require(worst <= cs.SHARDED_FLOAT_ATOL, f"{what}: float state max |diff| {worst}")
    for k in a["mesh"]:
        cs.require(np.array_equal(a["mesh"][k], b["mesh"][k]), f"{what}: emitted mesh {k}")
    cs.require(a["tracks"] == b["tracks"], f"{what}: finished tracks")
    cs.require(len(a["objects"]) == len(b["objects"]) and all(
        x.keys() == y.keys() and all(np.array_equal(x[k], y[k]) for k in x) for x, y in zip(a["objects"], b["objects"])),
        f"{what}: the objects extracted at finish_mapping")
    return worst


def second_card_rows(captured, card, launches):
    """A and B on the inputs of a slab on `card`: bit-exact against their
    plain versions, timed there (CUDA events on that card), beside the
    library call and the bound: the kernels line's rows."""
    from khronos_tpu_torch.ops import gather, propagate

    cs.require(captured["propagate"] and captured["gather"], f"no kernel input recorded on {card}")
    with torch.cuda.device(card):
        lab, grow, iterations = max(captured["propagate"], key=lambda c: int(c[1].sum()))
        a = cs.time_propagate(propagate, f"a slab on {card}", lab, grow, iterations)
        img, idx = captured["gather"][-1]
        err = cs.check_gather(gather, img, idx, f"a slab on {card}")
        p_ms, k_ms = cs.in_turns(lambda: gather.gather_rows_plain(img, idx), lambda: gather.gather_rows_cuda(img, idx))
        lib_ms = cs.time_ms(lambda: img[idx])
    bytes_b = img.nbytes + idx.nbytes + idx.numel() * img.shape[1] * 4
    rows = [
        {"name": f"propagate_labels_3d (window, a slab on {card})", "route": "cuda",
         "source": "khronos_tpu_torch/csrc/propagate.cu", "replaces": "khronos_tpu/ops/pallas/propagate.py:49",
         "launches": launches["propagate"], "match": True, "max_abs_err": a["max_abs_err"], "ms": a["us"] * 1e-3,
         "plain_ms": a["plain_us"] * 1e-3, "bound_ms": a["bound_us"] * 1e-3, "bound_by": a["bound_by"],
         "library_ms": None, "shape": list(lab.shape), "iterations": iterations, "rounds": a["rounds"],
         "growable_share": a["growable_share"]},
        {"name": f"gather_rows (window, a slab on {card})", "route": "cuda", "source": "khronos_tpu_torch/csrc/gather.cu",
         "replaces": "khronos_tpu/ops/pallas/gather_probe.py:32", "launches": launches["gather"], "match": True,
         "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms, "bound_ms": bytes_b / cs.HBM_BYTES_PER_S * 1e3,
         "bound_by": "bytes", "library_ms": lib_ms, "shape": [list(img.shape), list(idx.shape)]},
    ]
    for r in rows:
        lib = "none" if r["library_ms"] is None else f"{r['library_ms'] * 1e3:.1f} us"
        cs.log(f"kernel {r['name']}: bit-exact, {r['ms'] * 1e3:.2f} us on {r['shape']} (plain "
               f"{r['plain_ms'] * 1e3:.1f} us, library {lib}), bound {r['bound_ms'] * 1e3:.3f} us by {r['bound_by']}, "
               f"{r['launches']} launches in {FRAMES} frames (all slabs)")
    return rows


def window_check(cards, size=(480, 640), grid=(160, 160, 48)):
    """Part 2 of the module docstring: the window over the cards against
    every slab on the first card, then timed in turns."""
    from khronos_tpu_torch.data import synthetic as syn

    cards = [torch.device(c) for c in cards]
    n, device = len(cards), cards[0]
    seq = cs.make_sequence(syn, WARMUP + FRAMES, size[0], size[1], device)
    frames = [seq.render_frame(i) for i in range(WARMUP + FRAMES)]
    config = {**cs.bench_config(), "volumetric_map": {"grid_shape": list(grid), "voxel_size": 0.1}}
    # (n_devices, cards seen) of each mode; k over k cards for the scaling figure
    modes = {f"{k} over {k} cards": (k, k) for k in sorted({1, 2, n})}
    modes[f"{n} on one card"] = (n, 1)
    runs, ms = {}, {name: [] for name in modes}
    for order in (list(modes), list(modes)[::-1]):
        for name in order:
            k, seen = modes[name]
            w = window(config, seq, frames, k, seen, device)
            ms[name].append(w["ms_per_frame"])
            if device.type == "cuda":
                want_cards = [cards[i % seen] for i in range(k)]
                cs.require(w["slab_cards"] == want_cards == w["mesh_cards"],
                           f"window {name}: slabs on {w['slab_cards']}, want {want_cards}")
                cs.require(w["launches"] == {"propagate": k * FRAMES, "gather": k * FRAMES},
                           f"window {name}: launches {w['launches']}, want {k} a frame each")
            runs.setdefault(name, w)
    over, one = runs[f"{n} over {n} cards"], runs[f"{n} on one card"]
    worst = same_window(over, one, f"window, {n} slabs over {n} cards against {n} on one card")
    cs.require(len(over["mesh"]["mesh_vertices"]) > 0, "window: no triangle emitted")
    mean = {k: statistics.fmean(v) for k, v in ms.items()}
    t1 = mean["1 over 1 cards"]
    efficiency = {k: t1 / (k * mean[f"{k} over {k} cards"]) for k in sorted({1, 2, n})}
    result = {"cards": n, "slab_cards": [str(d) for d in over["slab_cards"]], "float_state_max_abs_diff": worst,
              "triangles": len(over["mesh"]["mesh_vertices"]), "finished_tracks": len(over["tracks"]),
              "objects_at_finish": len(over["objects"]),
              "launches": {k: w["launches"] for k, w in runs.items()}, "ms_per_frame": mean, "ms_per_frame_runs": ms,
              "efficiency": efficiency, "size": list(size), "grid": list(grid), "frames": FRAMES}
    cs.log(f"window: {n} slabs over {n} cards == {n} slabs on one card on {WARMUP + FRAMES} frames (integer state, "
           f"{result['triangles']} triangles, {result['finished_tracks']} tracks handed out and "
           f"{result['objects_at_finish']} objects at finish bit for bit; float "
           f"state max |diff| {worst}); ms a frame in turns: " + ", ".join(
               f"{k} {mean[k]:.2f} ({', '.join(f'{x:.2f}' for x in v)})" for k, v in ms.items())
           + "; efficiency t(1) / (k t(k)): " + ", ".join(f"{k}: {e:.3f}" for k, e in efficiency.items()))
    if device.type == "cuda" and n > 1:
        w = window(config, seq, frames, n, n, device, capture=True)
        result["kernel_rows"] = second_card_rows(w["captured"], cards[1], w["launches"])
    return result


def office_check(cards, overrides=()):
    """Parts 3 and 4: the office config at n_devices = len(cards) through
    run.main, its quality held to REFERENCE_QUALITY; then chip_smoke.py's
    checkpoint_resume on its ASYNC_OVERRIDES cut at that n_devices, slab i
    restored on card i. `overrides` are appended (a CPU rehearsal's sizes)."""
    n, device = len(cards), torch.device(cards[0]).type
    nd = (f"pipeline.active_window.n_devices={n}",)
    out_dir = ROOT / "build" / "sharding_cards_office"
    run_ = cs.run_config(cs.PIPELINE_CONFIG, OFFICE_OVERRIDES + nd + tuple(overrides), out_dir, device)
    final, static, quality = cs.check_config_run("sharding_cards office", run_, cs.PIPELINE_CONFIG, out_dir,
                                                 cs.REFERENCE_QUALITY, device,
                                                 overrides=OFFICE_OVERRIDES + nd + tuple(overrides), slabs=n)
    aw = run_["pipe"].active_window
    placed = [str(s.tsdf.device) for s in aw.state.slabs]
    if device == "cuda":
        cs.require(placed == [str(torch.device(c)) for c in cards], f"office: slabs on {placed}")
    office = {**cs.summary_of("sharding_cards office", run_, quality), "static_objects": len(static),
              "slab_cards": placed}
    del run_, aw
    pack = cs.office_frames(cs.ASYNC_OVERRIDES + nd + tuple(overrides), device)
    uninterrupted, _ = cs.office_run(pack, ROOT / "build" / "sharding_cards_checkpoint" / "uninterrupted")
    checkpoint = cs.phase_checkpoint_resume(str(cards), (pack, uninterrupted))
    if device == "cuda":
        cs.require(checkpoint["restored_on"] == [str(torch.device(c)) for c in cards],
                   f"checkpoint: slabs restored on {checkpoint['restored_on']}")
    return {"office": office, "checkpoint": checkpoint}


def main() -> int:
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        print("torch_port_sharding_cards: needs two or more CUDA devices", file=sys.stderr)
        return 1
    from khronos_tpu_torch.ops import native

    native.load_library()
    smi = cs.subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                            capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()
    cs.log(f"torch {torch.__version__}, CUDA {torch.version.cuda}; cards: {smi}")
    cards = [torch.device("cuda", k) for k in range(torch.cuda.device_count())]
    seconds = {}
    result = {"card": smi}
    for name, fn in (("step", run), ("window", window_check), ("office", office_check)):
        t0 = time.perf_counter()
        result[name] = fn(cards)
        seconds[name] = round(time.perf_counter() - t0, 1)
        cs.log(f"part {name}: {seconds[name]} s")
    result["seconds"] = seconds
    rows = result["window"].pop("kernel_rows")
    cs.log(json.dumps({"kernels": rows}))
    print(json.dumps(result, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
