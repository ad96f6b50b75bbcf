"""Where the active window's per-frame path makes the host wait for the card.

One robot of each benchmark configuration (`benchmark/configs/`) runs the
window as the benchmark's worker runs it: the loop rendered on the card, the
warm-up frames and the warm-up scroll, then `--frames` more frames under
`torch.cuda.set_sync_debug_mode("warn")`. Each warning is a call that
synchronises a CUDA stream (a blocking copy to or from the card, `.item()`,
a device synchronize). It is counted at its innermost frame in the program,
with the chain of program frames from `ActiveWindow.spin_once` down.
`HostCopy`'s event waits, which the debug mode does not see, are counted the
same way where an event had not yet completed.

    python3 scripts/torch_port_sync_census.py                     # on the card
    python3 scripts/torch_port_sync_census.py --device cpu --tiny  # control flow only

Prints one JSON line a configuration; writes every site with its calling
chains to `--out` (build/sync_census.json).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
import warnings

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for p in (ROOT, os.path.join(ROOT, "benchmark"), os.path.join(ROOT, "benchmark", "tests")):
    if p not in sys.path:
        sys.path.insert(0, p)

PROGRAM = os.sep + "khronos_tpu_torch" + os.sep
SYNC = "synchronizing CUDA operation"


def _where(f) -> str:
    return f"{os.path.relpath(f.filename, ROOT)}:{f.lineno} {f.name}"


def _chain():
    """The program's frames of the current stack, outermost first."""
    return [_where(f) for f in traceback.extract_stack()[:-2] if PROGRAM in f.filename]


def census(config: str, n_frames: int, device, tiny: bool) -> dict:
    from harness import manifest, scene, worker
    from khronos_tpu_torch.utils import host_copy
    from khronos_tpu_torch.utils.timing import TimingRecorder

    bench = manifest.load()
    cell = next(w for w in bench["workloads"] if w["config"] == config)
    cfg, traffic = manifest.config(bench, config), manifest.traffic(cell["traffic"])
    if tiny:
        from tiny import shrink

        cfg, traffic = shrink(cfg, traffic)
    hz = float(traffic["stamp_hz"])
    frames = scene.render_loop(cfg["scene"], cfg["sensor"], hz, device)
    robot = worker.Robot(0, frames, 0, int(round(1e9 / hz)), worker.build_engine(cfg, device), {}, None, None)
    for _ in range(int(traffic["warmup_frames"])):
        robot.step()
    worker.warmup_scroll(robot.aw)
    rec = TimingRecorder.instance()
    rec.reset()

    sites = {}
    state = {"frame": 0}

    def count(kind: str, chain) -> None:
        key = chain[-1] if chain else "(outside the program)"
        s = sites.setdefault(key, {"kind": kind, "n": 0, "frames": set(), "output_frames": set(), "chains": {}})
        s["n"] += 1
        s["frames"].add(state["frame"])
        ch = " > ".join(chain)
        s["chains"][ch] = s["chains"].get(ch, 0) + 1

    def on_warning(message, category, filename, lineno, file=None, line=None):
        if SYNC in str(message):
            count("sync_debug", _chain())

    orig_wait = host_copy.HostCopy._wait

    def _wait(self):
        if not all(e.query() for e in self.events):
            count("host_copy_event", _chain())
        orig_wait(self)

    host_copy.HostCopy._wait = _wait
    outputs = []
    t0 = time.perf_counter()
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = on_warning
            if device.type == "cuda":
                torch.cuda.set_sync_debug_mode("warn")
            try:
                for j in range(n_frames):
                    state["frame"] = j
                    before = len(rec.samples("active_window/extract_output"))
                    frame_sites = {k: v["n"] for k, v in sites.items()}
                    robot.step()
                    if len(rec.samples("active_window/extract_output")) > before:
                        outputs.append(j)
                        for k, v in sites.items():
                            if v["n"] > frame_sites.get(k, 0):
                                v["output_frames"].add(j)
            finally:
                if device.type == "cuda":
                    torch.cuda.set_sync_debug_mode(0)
    finally:
        host_copy.HostCopy._wait = orig_wait
    seconds = time.perf_counter() - t0
    extractions = len(rec.samples("object_extraction/all"))
    rows = []
    for key, s in sorted(sites.items(), key=lambda kv: -kv[1]["n"]):
        rows.append(dict(site=key, kind=s["kind"], n=s["n"], per_frame=s["n"] / n_frames, frames=len(s["frames"]),
                         in_output_frames=len(s["output_frames"]),
                         chains=sorted(s["chains"].items(), key=lambda kv: -kv[1])))
    del robot, frames
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return dict(config=config, frames=n_frames, outputs=len(outputs), extractions=extractions, seconds=seconds,
                sites=rows)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=300)
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--tiny", action="store_true", help="benchmark/tests/tiny.py's shrink (CPU rehearsal)")
    ap.add_argument("--configs", nargs="*", default=["synthetic_office", "synthetic_apartment"])
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "sync_census.json"))
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu", "configs": []}
    for config in args.configs:
        res = census(config, args.frames, device, args.tiny)
        out["configs"].append(res)
        print(json.dumps({k: v for k, v in res.items() if k != "sites"}
                         | {"sites": [(r["site"], r["kind"], r["n"], r["frames"], r["in_output_frames"])
                                      for r in res["sites"]]}), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(out, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
