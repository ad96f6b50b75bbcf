"""Work for several ranks, and a launcher that starts them as processes.

The port's counterparts of the reference's two multi-process workers,
`tests/multihost_worker.py` (the full fused frame step over a global mesh)
and `tests/multihost_pipeline_worker.py` (a whole `KhronosPipeline` in mesh
mode), on the same inputs and configs, plus a window runner at any width.
Each takes a group (`parallel.distributed`) as its first argument, or None
for the one-process run it is compared with, and returns what it found as
JSON-ready values (digests of tensors are sha256 of their bytes, so equal
digests mean equal bits).

`launch` starts W fresh interpreters, one a rank, each running

    python -m khronos_tpu_torch.parallel.workers --rank R --world W \\
        --backend gloo|nccl --init file:///dir/rendezvous --device cuda|cpu \\
        --fn NAME --args JSON --out RESULT.json

(never `fork`: a child forked from a process that used CUDA cannot). The
rendezvous is a file, each rank's output and errors go to files, and the
first rank that fails or outlives the timeout ends them all. In one process,
`distributed.run_threads(ThreadGroup.create(W), fn, ...)` runs the same
functions with the ranks as threads.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from khronos_tpu_torch import resolve_device
from khronos_tpu_torch.parallel import distributed

ROOT = Path(__file__).resolve().parents[2]


def digest(*tensors) -> str:
    """sha256 of the tensors' bytes (numpy arrays too), in order."""
    h = hashlib.sha256()
    for t in tensors:
        a = t.detach().cpu().contiguous().numpy() if torch.is_tensor(t) else np.ascontiguousarray(t)
        h.update(str((a.dtype, a.shape)).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def _device(group, device) -> torch.device:
    """The group's rank device, or `device` (CUDA unless the caller asks for
    the CPU; raises when no GPU is visible)."""
    return group.device if group is not None else resolve_device(device)


def _whole(state, mesh):
    from khronos_tpu_torch.parallel import sharding

    return sharding.gather_volume(state, mesh=mesh)


def volume_digests(state) -> dict:
    """Per field of a VolumeState, its digest."""
    return {f: digest(getattr(state, f)) for f in state._fields}


# ---------------------------------------------------------------------------
# tests/multihost_worker.py's step
# ---------------------------------------------------------------------------


def step_inputs(device):
    """The reference worker's config and inputs: a 32x32x16 grid at 0.1 m,
    48x64 frames from numpy's generator with seed 11, an object box."""
    from khronos_tpu_torch.active_window.motion_detection import FreeSpaceMotionDetectorConfig
    from khronos_tpu_torch.active_window.object_detection import ConnectedSemanticsConfig, LabelSpace
    from khronos_tpu_torch.geometry.camera import Camera
    from khronos_tpu_torch.map import active_volume as av

    cfg = av.VolumeConfig(grid_shape=(32, 32, 16), voxel_size=0.1)
    cam = Camera(48, 64, 40.0, 40.0, 32.0, 24.0, max_range=5.0)
    ls = LabelSpace(num_classes=7, object_labels=(2, 3, 4, 5, 6), dynamic_labels=(1,))
    md = FreeSpaceMotionDetectorConfig(min_cluster_size=5)
    od = ConnectedSemanticsConfig(min_cluster_size=5)
    rng = np.random.default_rng(11)
    depth = rng.uniform(0.4, 1.4, (48, 64)).astype(np.float32)
    color = rng.uniform(0, 1, (48, 64, 3)).astype(np.float32)
    labels = np.zeros((48, 64), np.int32)
    labels[10:30, 20:44] = 3
    images = [torch.from_numpy(a).to(device) for a in (depth, color, labels)]
    return cfg, cam, ls, md, od, images


def sharded_step(group=None, n_devices: int = 4, device="cuda"):
    """Two full fused steps over n_devices slabs (over the group's ranks, or
    in this process) from a fresh grid, as the reference worker runs them.
    Returns (mesh, state, [(dynamic image, object image, packed)] a step)."""
    from khronos_tpu_torch.map import active_volume as av
    from khronos_tpu_torch.parallel import sharding

    dev = _device(group, device)
    cfg, cam, ls, md, od, (depth, color, labels) = step_inputs(dev)
    mesh = (sharding.make_mesh(n_devices, group=group) if group is not None
            else sharding.make_mesh(n_devices, devices=[dev]))
    state = sharding.shard_volume(av.create(cfg, origin_xyz=np.array([-1.6, -1.6, -0.6]), device=dev), mesh)
    step = sharding.make_sharded_frame_step(cfg, cam, md, od, ls, mesh)
    R, t = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    outs = []
    for k in range(2):
        state, dyn, obj, packed = step(state, depth, color, labels, R, t, 0.5 + 0.5 * k)
        outs.append((dyn, obj, packed))
    return mesh, state, outs


def sharded_step_checksums(group=None, n_devices: int = 4, device="cuda") -> dict:
    """The reference worker's checksums (weight sum, |tsdf| sum, object id
    sum, finite packed stats sum) of two steps over n_devices slabs, from
    the whole grid every rank gathers; and the digests of the whole grid's
    fields and of each step's images and stats."""
    mesh, state, outs = sharded_step(group, n_devices, device)
    whole = _whole(state, mesh)
    dyn, obj, packed = outs[-1]
    return {
        "devices": mesh.size,
        "weight_sum": float(whole.weight.sum()),
        "tsdf_abs_sum": float(whole.tsdf.abs().sum()),
        "obj_sum": float(obj.sum()),
        "packed_sum": float(torch.where(torch.isfinite(packed), packed, 0.0).sum()),
        "state": volume_digests(whole),
        "steps": [digest(*o) for o in outs],
    }


# ---------------------------------------------------------------------------
# tests/multihost_pipeline_worker.py's pipeline
# ---------------------------------------------------------------------------


def pipeline_config(n_devices: int) -> dict:
    """tests/multihost_pipeline_worker.py's pipeline config."""
    X = max(n_devices * 8, 32)
    return {
        "active_window": {
            "n_devices": n_devices,
            "volumetric_map": {"grid_shape": [X, 32, 16], "voxel_size": 0.3, "truncation_distance": 0.6},
            "motion_detector": {"type": "FreeSpaceMotionDetector", "min_cluster_size": 5},
            "object_detector": {"type": "ConnectedSemantics", "min_cluster_size": 5},
            "tracker": {"type": "MaxIouTracker", "min_num_observations": 2},
            "object_extractor": {"type": "MeshObjectExtractor", "min_num_observations": 2},
        },
        "backend": {"lcd": {"type": "GtLoopClosure", "min_time_gap": 4.0, "max_distance": 1.0}},
        "label_space": {"num_classes": 7, "object_labels": [2, 3, 4, 5, 6], "dynamic_labels": [1]},
        "run_change_detection_every_n_frames": 4,
        "places": None,
    }


def pipeline_frames(device):
    """The reference worker's sequence (8 s of the office at 1 frame/s,
    48x64), rendered by the port: (camera, [frame dicts])."""
    from khronos_tpu_torch.data import synthetic as syn

    seq = syn.SyntheticSequence(syn.office_scene(duration=8.0), syn.SyntheticSequenceConfig(
        duration=8.0, fps=1.0, height=48, width=64, fx=40.0, fy=40.0, cx=32.0, cy=24.0), device=device)
    return seq.camera, [seq.render_frame(i) for i in range(seq.n_frames)]


def run_pipeline(group=None, n_devices: int = 4, device="cuda", frames=None, camera=None,
                 digests: bool = False) -> dict:
    """tests/multihost_pipeline_worker.py's run_pipeline: the office sequence
    through a complete KhronosPipeline (window over n_devices slabs, backend,
    change detection every 4 frames, 4D snapshots), with the reference's
    summary keys, in the earliest host-pull schedule (`earliest_pulls`).
    `frames` / `camera` (frame dicts of arrays, and their camera): other
    frames than the port's renderer's (the tests pass the JAX renderer's).
    digests: also the final mesh's and the whole grid's."""
    from khronos_tpu_torch.active_window.frame_data import FrameData
    from khronos_tpu_torch.config import build
    from khronos_tpu_torch.pipeline.pipeline import KhronosPipeline, PipelineConfig

    dev = _device(group, device)
    if frames is None:
        camera, frames = pipeline_frames(dev)

    def tensor(a):
        return torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a).to(dev)

    pipe = KhronosPipeline(build(PipelineConfig, pipeline_config(n_devices)), camera, device=dev, group=group)
    pipe.active_window.earliest_pulls = True
    for f in frames:
        pipe.process_frame(FrameData(stamp_ns=f["stamp_ns"], depth=tensor(f["depth"]),
                                     color=tensor(f["color"]), labels=tensor(f["labels"]),
                                     R_w_c=np.array(f["R_w_c"]), t_w_c=np.array(f["t_w_c"])),
                           gt_pose=(np.array(f["R_gt"]), np.array(f["t_gt"])))
    pipe.finish()
    aw = pipe.active_window
    whole = _whole(aw.state, aw.mesh)
    dsg = pipe.backend.get_dsg()
    bg = pipe.change_detector.changes.background_states
    out = {
        "n_state_devices": len(aw.state.slabs),
        "weight_sum": float(whole.weight.sum()),
        "n_agents": len(dsg.agents),
        "n_objects": len(dsg.objects),
        "n_mesh_vertices": int(dsg.mesh.num_vertices),
        "mesh_vertex_sum": round(float(np.abs(dsg.mesh.vertices).sum()), 1),
        "n_graph_nodes": pipe.backend.graph.num_nodes,
        "n_optimizations": pipe.backend.num_optimizations,
        "bg_state_counts": [int((bg == s).sum()) for s in (-1, 0, 1, 2)] if bg is not None else [],
        "n_snapshots": pipe.map.num_snapshots,
    }
    if digests:
        out["mesh_digest"] = digest(dsg.mesh.vertices, dsg.mesh.faces)
        out["state_digest"] = digest(*whole[1:])
    return out


# ---------------------------------------------------------------------------
# the window at any width
# ---------------------------------------------------------------------------


def run_window(group, config: dict, sequence: dict, n_devices: int = 2, device="cuda", warmup: int = 10,
               frames: int = 40, capture: int = 0, record: Optional[str] = None) -> dict:
    """The window built from `config` (ActiveWindowConfig's fields, as
    JSON; its n_devices set to `n_devices`) over the port's synthetic office
    rendered with `sequence` (SyntheticSequenceConfig's fields, as JSON; the
    scene spans its duration), with n_devices slabs over the group's ranks
    or in this process: `warmup` frames, then `frames` timed with the
    kernels' launch counts set to 0 just before and read just after, then
    `capture` frames with kernel A's and B's inputs recorded, then
    finish_mapping. chip_smoke.py passes its main path's settings.

    Returns ms a frame, the launches (this process's), the collectives, the
    bytes they gathered and the host's ms inside them a timed frame (over
    ranks), and the digests of every frame's packed stats and id images, of
    the emitted triangles in emission order, of the finished tracks and of
    every slab this process holds. With `record` (a directory) on CUDA, the recorded calls are
    checked bit for bit against the plain versions here and the one with
    the most growable voxels (A) and the first (B) are saved there with
    torch.save as kernels_rank{r}.pt."""
    from khronos_tpu_torch.active_window.active_window import ActiveWindow, ActiveWindowConfig
    from khronos_tpu_torch.active_window.frame_data import FrameData
    from khronos_tpu_torch.config import build
    from khronos_tpu_torch.data import synthetic as syn
    from khronos_tpu_torch.ops import gather, propagate

    dev = _device(group, device)
    seq = syn.SyntheticSequence(syn.office_scene(duration=sequence["duration"]),
                                build(syn.SyntheticSequenceConfig, sequence), device=dev)
    rendered = [seq.render_frame(i) for i in range(warmup + frames + capture)]
    aw = ActiveWindow(build(ActiveWindowConfig, {**config, "n_devices": n_devices}), seq.camera,
                      syn.default_label_space(), device=dev, group=group)
    aw.defer_object_extraction = True
    outputs, per_frame, packed = [], [], []
    track_frame = aw._track_frame

    def keep_stats(frame, stats):  # the frame's packed stats, as the window queues them for the bus
        packed.append(stats)
        track_frame(frame, stats)

    aw._track_frame = keep_stats

    def spin(f):
        frame = FrameData(stamp_ns=f["stamp_ns"], depth=f["depth"], color=f["color"], labels=f["labels"],
                          R_w_c=f["R_w_c"], t_w_c=f["t_w_c"])
        out = aw.spin_once(frame)
        per_frame.append((frame.dynamic_image, frame.object_image, packed[-1]))
        if out is not None:
            outputs.append(out)
        return frame

    for f in rendered[:warmup]:
        spin(f)
    aw.synchronize()
    propagate.launches = gather.launches = 0
    calls, gathered, seconds = (group.calls, group.gathered_bytes, group.seconds) if group is not None else (0, 0, 0.0)
    t0 = time.perf_counter()
    for f in rendered[warmup: warmup + frames]:
        last = spin(f)
    aw.synchronize()
    dt = time.perf_counter() - t0
    launches = {"propagate": propagate.launches, "gather": gather.launches}
    if group is not None:
        calls, gathered, seconds = group.calls - calls, group.gathered_bytes - gathered, group.seconds - seconds
    captured = {"propagate": [], "gather": []}
    if capture:
        prop, gat = propagate.propagate_labels_3d_cuda, gather.gather_rows_cuda

        def rec_prop(*a):
            captured["propagate"].append([x.clone() if torch.is_tensor(x) else x for x in a])
            return prop(*a)

        def rec_gat(*a):
            captured["gather"].append([x.clone() for x in a])
            return gat(*a)

        propagate.propagate_labels_3d_cuda, gather.gather_rows_cuda = rec_prop, rec_gat
        try:
            for f in rendered[warmup + frames:]:
                last = spin(f)
        finally:
            propagate.propagate_labels_3d_cuda, gather.gather_rows_cuda = prop, gat
    outputs.append(aw.finish_mapping(last))
    tris = [np.concatenate([getattr(o, k) for o in outputs]) for k in
            ("mesh_vertices", "mesh_colors", "mesh_first_ns", "mesh_last_ns", "mesh_labels")]
    tracks = sorted(tuple(o.stamp_ns for o in t.observations) for out in outputs for t in (out.pending_tracks or []))
    result = dict(
        ms_per_frame=dt / frames * 1e3, devices=[str(d) for d in aw.devices], slabs=[i for i, _ in aw.state.local],
        launches=launches, collectives_per_frame=calls / frames, gathered_bytes_per_frame=gathered / frames,
        collective_ms_per_frame=seconds / frames * 1e3, packed=[digest(p) for _, _, p in per_frame],
        images=[digest(d, o) for d, o, _ in per_frame],
        triangles=len(tris[0]), triangles_digest=digest(*tris), tracks=len(tracks),
        tracks_digest=digest(np.asarray([s for t in tracks for s in t], np.int64)),
        dynamic_ids=int(sum(int(d.max()) for d, _, _ in per_frame)),
        slab_digests={str(i): volume_digests(s) for i, s in aw.state.local},
    )
    if record is not None and dev.type == "cuda":  # CPU tensors take the plain versions
        result["recorded"] = _record_kernels(captured, record, 0 if group is None else group.rank)
    return result


def _record_kernels(captured, directory, rank) -> dict:
    """Check every recorded call of A and B against its plain version, bit
    for bit, and save the A call with the most growable voxels and the first
    B call to `directory`."""
    from khronos_tpu_torch.ops import gather, propagate

    bad = [k for k, (lab, grow, it) in enumerate(captured["propagate"])
           if not torch.equal(propagate.propagate_labels_3d_cuda(lab, grow, it),
                              propagate.propagate_labels_3d_plain(lab, grow, it))]
    bad += [f"B{k}" for k, (img, idx) in enumerate(captured["gather"])
            if not torch.equal(gather.gather_rows_cuda(img, idx).view(torch.int32),
                               gather.gather_rows_plain(img, idx).view(torch.int32))]
    if bad:
        raise RuntimeError(f"rank {rank}: kernel A or B differs from its plain version on recorded calls {bad}")
    a = max(captured["propagate"], key=lambda c: int(c[1].sum()))
    b = captured["gather"][0]
    path = Path(directory) / f"kernels_rank{rank}.pt"
    torch.save({"propagate": [x.cpu() if torch.is_tensor(x) else x for x in a], "gather": [x.cpu() for x in b]},
               path)
    return {"path": str(path), "propagate_calls": len(captured["propagate"]), "gather_calls": len(captured["gather"]),
            "bit_exact": True}


def run_config(group=None, device="cuda", config="configs/office_synthetic.yaml", overrides=(),
               out_dir="build/run_config") -> dict:
    """A config's pipeline through `run.main` (as users run it, the group
    passed on), in the earliest host-pull schedule, into out_dir/rank{r};
    ranks other than 0 export no viewer and evaluate nothing. Returns the
    frames, frames/s over the pipeline's own "pipeline/frame" spans
    (utils/timing.py: one rank a process, as `launch` runs it), the final
    map's digest (every array of the saved 4D map's last snapshot) and the
    output directory."""
    from khronos_tpu_torch import run as trun
    from khronos_tpu_torch.stm import serialization
    from khronos_tpu_torch.stm.spatio_temporal_map import SpatioTemporalMap
    from khronos_tpu_torch.utils.timing import TimingRecorder

    rank = 0 if group is None else group.rank
    out = Path(out_dir) / f"rank{rank}"
    extra = [] if rank == 0 else ["run.evaluate=false", "run.export_viewer=false"]
    spans = len(TimingRecorder.instance().samples("pipeline/frame"))
    trun.main(["--device", str(device), "--config", str(config), *overrides, *extra, f"run.output_dir={out}"],
              group=group, earliest_pulls=True)
    times = TimingRecorder.instance().samples("pipeline/frame")[spans:]
    smap = SpatioTemporalMap.load(str(out / "final.4dmap.npz"))
    final = serialization.scene_graph_arrays(smap.get_dsg(smap.latest_ns()))
    return {"frames": len(times), "fps": len(times) / sum(times), "snapshots": smap.num_snapshots,
            "map_digest": digest(*(final[k] for k in sorted(final))), "map_keys": len(final), "out_dir": str(out)}


def several(group=None, calls=(), device="cuda") -> list:
    """Each [name, kwargs] of `calls` in order, in one process a rank."""
    return [FUNCTIONS[name](group, device=device, **kwargs) for name, kwargs in calls]


FUNCTIONS = {
    "sharded_step_checksums": sharded_step_checksums,
    "run_pipeline": run_pipeline,
    "run_window": run_window,
    "run_config": run_config,
    "several": several,
}


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


def _tail(path: Path, n: int = 3000) -> str:
    try:
        return path.read_text(errors="replace")[-n:]
    except OSError:
        return "(no file)"


def launch(world: int, backend: str, fn: str, args: dict, out_dir, timeout_s: float = 600.0,
           device: str = "cuda") -> list:
    """Run FUNCTIONS[fn](group, device=device, **args) in `world` fresh
    interpreters, one a rank of a `backend` group ("gloo" or "nccl") that
    meets at a file in out_dir; each rank's stdout and stderr go to
    out_dir/rank{r}.out and .err, its result to out_dir/rank{r}.json. Waits
    for all; on the first rank that fails, or at timeout_s, kills the rest
    and raises with every rank's stderr tail. Returns the results in rank
    order."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    rendezvous = out_dir / "rendezvous"
    if rendezvous.exists():
        rendezvous.unlink()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    procs, files = [], []
    for r in range(world):
        res = out_dir / f"rank{r}.json"
        if res.exists():
            res.unlink()
        out_f, err_f = open(out_dir / f"rank{r}.out", "w"), open(out_dir / f"rank{r}.err", "w")
        files += [out_f, err_f]
        cmd = [sys.executable, "-m", "khronos_tpu_torch.parallel.workers", "--rank", str(r), "--world", str(world),
               "--backend", backend, "--init", f"file://{rendezvous}", "--device", device, "--fn", fn,
               "--args", json.dumps(args), "--out", str(res), "--timeout", str(timeout_s)]
        procs.append(subprocess.Popen(cmd, cwd=ROOT, env=env, stdin=subprocess.DEVNULL, stdout=out_f, stderr=err_f))
    deadline = time.monotonic() + timeout_s
    failed = None
    try:
        while True:
            codes = [p.poll() for p in procs]
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                failed = f"rank {bad[0]} exited with code {codes[bad[0]]}"
                break
            if all(c == 0 for c in codes):
                break
            if time.monotonic() > deadline:
                failed = f"timed out after {timeout_s} s (exit codes {codes})"
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
        for f in files:
            f.close()
    if failed is not None:
        tails = "\n".join(f"--- rank {r} stderr ---\n{_tail(out_dir / f'rank{r}.err')}" for r in range(world))
        raise RuntimeError(f"launch of {world} {backend} ranks running {fn}: {failed}\n{tails}")
    return [json.loads((out_dir / f"rank{r}.json").read_text()) for r in range(world)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="one rank of a launch (see launch)")
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--backend", choices=("gloo", "nccl"), required=True)
    ap.add_argument("--init", required=True, help="the rendezvous, file:///path")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--fn", required=True, choices=sorted(FUNCTIONS))
    ap.add_argument("--args", default="{}", help="JSON keyword arguments of fn")
    ap.add_argument("--out", required=True, help="where the JSON result goes")
    ap.add_argument("--timeout", type=float, default=distributed.DEFAULT_TIMEOUT_S)
    args = ap.parse_args(argv)
    if args.device == "cpu":
        torch.set_num_threads(1)  # ranks share the host's cores
    group = distributed.initialize(args.rank, args.world, args.init, args.backend, args.timeout, args.device)
    try:
        result = FUNCTIONS[args.fn](group, device=args.device, **json.loads(args.args))
        group.barrier()  # no rank leaves while another may still exchange with it
    finally:
        group.destroy()
    tmp = Path(args.out + ".tmp")
    tmp.write_text(json.dumps(result))
    os.replace(tmp, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
