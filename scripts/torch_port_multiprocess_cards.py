"""The window over several processes, one rank a card (NCCL), on four cards.

At chip_smoke.py's main-path widths (480x640, a 160x160x48 grid at 0.1 m,
detection stride 2, the bench detectors), on a host with 4 cards:

1. the window (`parallel/workers.py::run_window`) over W = 1, 2 and 4 NCCL
   ranks, one slab a rank (n_devices = W), each rank a fresh interpreter on
   its own card (`workers.launch`): every rank's packed stats and id images
   of every frame, the emitted triangles in emission order, the finished
   tracks and its slab bit for bit equal to the one-process window with W
   slabs on the first card; A and B once a timed frame in every rank. ms a
   frame in turns: the ranks (the slowest rank's), the one-process window
   with slab i on card i (the one-process layout, `sharding.mesh_for`) twice,
   the ranks again; the ranks' efficiency t(1) / (k t(k));
2. A and B on rank 3's recorded slab inputs (W = 4): bit for bit against
   their plain versions and timed on card 3 (chip_smoke.py's rows);
3. configs/office_synthetic.yaml as chip_smoke.py's pipeline_path runs it
   (drift 0.1) with pipeline.active_window.n_devices=4, through run.main in
   4 NCCL ranks (`workers.run_config`) and in one process (slab i on card
   i), both in the earliest host-pull schedule: every rank's final map
   equal to the one process's bit for bit; rank 0's evaluation within
   chip_smoke.py's REFERENCE_QUALITY; frames/s.

    python3 scripts/torch_port_multiprocess_cards.py     # on a host with 4 cards

The last line of its output is one JSON object with the results (printed
also when a part fails, with the error; also written to
build/multiprocess_cards/results.json).
"""

from __future__ import annotations

import contextlib
import json
import statistics
import sys
import time
import traceback
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (the repo's root on the path first)

WORLDS = (1, 2, 4)
SIZE, GRID = (480, 640), (160, 160, 48)
OFFICE_OVERRIDES = cs.PIPELINE_OVERRIDES + ("pipeline.active_window.n_devices=4",)
OUT = ROOT / "build" / "multiprocess_cards"
WINDOW_KEYS = ("packed", "images", "triangles", "triangles_digest", "tracks", "tracks_digest", "dynamic_ids")
TIMEOUT_S = 900.0


@contextlib.contextmanager
def cards_seen(k: int):
    """While the block runs, torch reports only the first k cards: a window
    built here takes its mesh over those (`sharding.mesh_for`)."""
    count = torch.cuda.device_count
    torch.cuda.device_count = lambda: min(k, count())
    try:
        yield
    finally:
        torch.cuda.device_count = count


def window_kwargs(n, size=SIZE, grid=GRID):
    """workers.run_window's arguments: chip_smoke.py's main-path window with n slabs."""
    return {**cs.multiprocess_window(size, grid), "n_devices": n}


def ranks_window(world, tag, record=False, device="cuda", size=SIZE, grid=GRID):
    from khronos_tpu_torch.parallel import workers

    out_dir = OUT / f"w{world}_{tag}"
    kw = window_kwargs(world, size, grid)
    if record:
        kw["record"] = str(out_dir)
    backend = "nccl" if device == "cuda" else "gloo"
    return workers.launch(world, backend, "run_window", kw, out_dir, timeout_s=TIMEOUT_S, device=device)


def check_ranks(world, ranks, one, device):
    """Every rank against the one-card window: digests and its slab; the
    launches once a timed frame."""
    for r, got in enumerate(ranks):
        differ = [k for k in WINDOW_KEYS if got[k] != one[k]]
        cs.require(not differ, f"W={world}: rank {r}'s window differs from one card's in {differ}")
        cs.require(got["slabs"] == [r] and got["devices"] == ([f"cuda:{r}"] if device == "cuda" else ["cpu"]),
                   f"W={world}: rank {r} holds slabs {got['slabs']} on {got['devices']}")
        slab = [f for f, d in got["slab_digests"][str(r)].items() if d != one["slab_digests"][str(r)][f]]
        cs.require(not slab, f"W={world}: rank {r}'s slab differs in {slab}")
        if device == "cuda":
            cs.require(got["launches"] == {"propagate": cs.FRAMES, "gather": cs.FRAMES},
                       f"W={world}: rank {r} launched {got['launches']} in {cs.FRAMES} frames")


def windows(results, device="cuda", size=SIZE, grid=GRID):
    from khronos_tpu_torch.parallel import workers

    ms = {}
    for world in WORLDS:
        first = ranks_window(world, "a", record=world == 4, device=device, size=size, grid=grid)
        with cards_seen(1) if device == "cuda" else contextlib.nullcontext():
            one = workers.run_window(None, device=device, **window_kwargs(world, size, grid))
        check_ranks(world, first, one, device)
        spread = [workers.run_window(None, device=device, **window_kwargs(world, size, grid))
                  for _ in range(2)]
        cs.require(all(s["triangles_digest"] == one["triangles_digest"] and s["packed"] == one["packed"]
                       for s in spread), f"W={world}: the window over {world} cards differs from one card's")
        second = ranks_window(world, "b", device=device, size=size, grid=grid)
        check_ranks(world, second, one, device)
        ms[world] = {
            "ranks": [max(r["ms_per_frame"] for r in first), max(r["ms_per_frame"] for r in second)],
            "ranks_each": [[r["ms_per_frame"] for r in first], [r["ms_per_frame"] for r in second]],
            "one_process_over_cards": [s["ms_per_frame"] for s in spread],
            "one_process_one_card": one["ms_per_frame"],
            "ranks_collective_ms": [[r["collective_ms_per_frame"] for r in first],
                                    [r["collective_ms_per_frame"] for r in second]],
        }
        results["windows"] = ms
        if world == 4:
            results["recorded"] = first[3].get("recorded")
        cs.log(f"W={world}: every rank == one process with {world} slab(s) on one card, bit for bit "
               f"({one['triangles']} triangles, {one['tracks']} finished tracks); ms a frame in turns: ranks "
               f"{ms[world]['ranks'][0]:.2f}, over cards {ms[world]['one_process_over_cards'][0]:.2f}, "
               f"{ms[world]['one_process_over_cards'][1]:.2f}, ranks {ms[world]['ranks'][1]:.2f}; one card "
               f"{one['ms_per_frame']:.2f}")
    t = {w: statistics.fmean(ms[w]["ranks"]) for w in WORLDS}
    results["efficiency"] = {str(w): t[1] / (w * t[w]) for w in WORLDS}
    cs.log(f"efficiency t(1) / (k t(k)) of the ranks: {results['efficiency']}")


def kernels(results):
    rec = torch.load(results["recorded"]["path"])
    card = torch.device("cuda", 3)
    lab, grow, iterations = rec["propagate"]
    img, idx = rec["gather"]
    with torch.cuda.device(card):
        launches = {"propagate": cs.FRAMES, "gather": cs.FRAMES}  # checked for every rank in windows()
        results["kernel_rows"] = cs.slab_kernel_rows("NCCL rank 3 on card 3", lab.to(card), grow.to(card),
                                                     iterations, img.to(card), idx.to(card), launches)


def office(results, device="cuda", overrides=()):
    from khronos_tpu_torch.parallel import workers

    ov = list(OFFICE_OVERRIDES) + list(overrides)
    config = str(cs.PIPELINE_CONFIG)
    one = workers.run_config(None, device, config, ov, str(OUT / "office_one"))
    ranks = workers.launch(4, "nccl" if device == "cuda" else "gloo", "run_config",
                           {"config": config, "overrides": ov, "out_dir": str(OUT / "office_ranks")},
                           OUT / "office_launch", timeout_s=TIMEOUT_S, device=device)
    for r, got in enumerate(ranks):
        cs.require(got["map_digest"] == one["map_digest"] and got["frames"] == one["frames"],
                   f"office: rank {r}'s final map differs from one process's")
    quality = {}
    for csv_name, column, ref, slack in cs.REFERENCE_QUALITY:
        got = cs.read_result(Path(ranks[0]["out_dir"]) / "results" / csv_name)[column]
        quality[f"{csv_name[:-4]}/{column}"] = {"ranks": got, "reference": ref, "slack": slack}
        cs.require(got >= ref - slack, f"office: {csv_name} {column} = {got}, the reference {ref} less {slack}")
    results["office"] = {"frames": one["frames"], "fps_ranks": [r["fps"] for r in ranks], "fps_one_process": one["fps"],
                         "snapshots": one["snapshots"], "quality": quality}
    cs.log(f"office at n_devices=4 over 4 ranks: every rank's map == one process's; frames/s ranks "
           f"{[round(r['fps'], 2) for r in ranks]}, one process {one['fps']:.2f}; quality {quality}")


def main() -> int:
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        print("torch_port_multiprocess_cards: needs 4 visible CUDA cards", file=sys.stderr)
        return 1
    from khronos_tpu_torch.ops import native

    card = cs.nvidia_smi()
    results = {"card": card, "cards": torch.cuda.device_count()}
    cs.log(f"cards: {torch.cuda.device_count()} x {card}; compute mode {cs.compute_mode()}")
    native.load_library()  # the ranks find the built library
    ok = True
    for part in (windows, kernels, office):
        ts = time.perf_counter()
        try:
            part(results)
        except Exception:  # noqa: BLE001  (reported, and the run fails below)
            ok = False
            results.setdefault("errors", {})[part.__name__] = traceback.format_exc()[-3000:]
            traceback.print_exc()
            if part is windows:
                break
        results.setdefault("seconds", {})[part.__name__] = round(time.perf_counter() - ts, 1)
    line = json.dumps(results, default=str)
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "results.json").write_text(line)
    print(line, flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
