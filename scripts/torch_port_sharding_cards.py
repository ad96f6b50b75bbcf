"""The sharded frame step with its slabs on several cards.

Runs the fused step of `khronos_tpu_torch` over a device mesh
(`parallel/sharding.py`, cropping off) at chip_smoke.py's sharding_path
widths (480x640, a 160x160x48 grid at 0.1 m, detection stride 2, the bench
detectors), with the slabs round-robin over every visible card, and holds it
against the one-grid step with cropping off on the first card, as
chip_smoke.py's `sharded_step_parity` does: id images, cluster counts and
ids, labels and the volume's integer fields bit for bit; packed stats within
atol 2e-3 / rtol 1e-5 and the float fields within 1e-5. Kernels A and B
must launch once a slab a frame, and every card must hold memory.

Then it times the step a frame (host clock, every card synchronised after
the frames) for one grid, N shards on the first card and N shards over N
cards, in turns (one grid, one card, N cards, N cards, one card, one grid).

    python3 scripts/torch_port_sharding_cards.py     # on a host with 2+ cards

The last line of its output is one JSON object with the results.
"""

from __future__ import annotations

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


def _sync(devices) -> None:
    for d in {str(d): d for d in devices}.values():
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def step_ms(step, start, frames, devices) -> float:
    """ms a frame of `step` over the frames after WARMUP, from `start`."""
    state = start
    for f in frames[:WARMUP]:
        state = step(state, f["depth"], f["color"], f["labels"], f["R_w_c"], f["t_w_c"], f["t"])[0]
    _sync(devices)
    t0 = time.perf_counter()
    for f in frames[WARMUP:]:
        state = step(state, f["depth"], f["color"], f["labels"], f["R_w_c"], f["t_w_c"], f["t"])[0]
    _sync(devices)
    return (time.perf_counter() - t0) / (len(frames) - WARMUP) * 1e3


def run(cards, size=(480, 640), grid=(160, 160, 48)):
    """The check and the times over the devices `cards` (the first one holds
    the images and the one-grid step); `size` and `grid` are cut for a
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


def main() -> int:
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        print("torch_port_sharding_cards: needs two or more CUDA devices", file=sys.stderr)
        return 1
    from khronos_tpu_torch.ops import native

    native.load_library()
    smi = cs.subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                            capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()
    cs.log(f"torch {torch.__version__}, CUDA {torch.version.cuda}; cards: {smi}")
    result = run([torch.device("cuda", k) for k in range(torch.cuda.device_count())])
    result["card"] = smi
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
