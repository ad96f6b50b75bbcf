"""Where a robot's frame time goes, from the program's per-frame spans, and
which part of the output frames sets the benchmark's `frame_ms_p95`.

Runs one benchmark cell as `benchmark/run.py --trace 0` runs it (a worker
process a robot on the card), with each worker saving its span samples
(`TimingRecorder.save`: stamp, duration, start on perf_counter_ns and parent
of every sample) when its window closes. Then, for each robot, every sample
is put in the frame whose `active_window/all` encloses it, and the frames are
split into their parts: the fused step, the pulls, the output's emission
round (`extract/emit`), its pull consumption, its inline object extraction
(`object_extraction/track`), the rest of the output span, and the host's
waits (`wait/<site>`). For each part it gives the 95th percentile of the
frames' time with that part taken out, beside the percentile as it is. It
also counts, at each output once its pulls are consumed, the emission rounds
of earlier frames still in flight (their copies not landed yet), as
`earlier_rounds_in_flight_at_outputs` (count: outputs).

    python3 scripts/torch_port_output_frames.py --workload office.window.r4 --seed 7   # on the card
    python3 scripts/torch_port_output_frames.py --workload office.window.r4 --device cpu --tiny

Prints one JSON line; writes the split, each robot's too, to
`<--out>/<workload>.json` (build/output_frames).
"""

from __future__ import annotations

import argparse
import bisect
import csv
import json
import os
import shutil
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.dirname(os.path.abspath(__file__))
for p in (HERE, ROOT, os.path.join(ROOT, "benchmark"), os.path.join(ROOT, "benchmark", "tests")):
    if p not in sys.path:
        sys.path.insert(0, p)

DUMP_ENV = "KHRONOS_SPAN_DUMP_DIR"
PARTS = ("active_window/scroll", "active_window/fused_step", "active_window/advance_pulls", "extract/emit",
         "extract/consume_pulls", "object_extraction/track")


def save_samples_at_window_end():
    """Injected into each worker: its one `stats()` call (at the window's
    end) first saves every sample under $KHRONOS_SPAN_DUMP_DIR/pid<pid>,
    with `in_flight.json`: at each output, once `extract/consume_pulls` has
    run, the frame's start and the emission rounds still pending that were
    dispatched before the frame (an earlier output's or scroll's round whose
    copies had not landed)."""
    from khronos_tpu_torch.active_window.active_window import ActiveWindow
    from khronos_tpu_torch.utils.timing import TimingRecorder

    stats, spin, emit, build = (TimingRecorder.stats, ActiveWindow.spin_once, ActiveWindow._emit_mesh,
                                ActiveWindow._build_output)
    frame_start, born, in_flight = [0], {}, []

    def spin_once(self, *args, **kwargs):
        frame_start[0] = time.perf_counter_ns()
        return spin(self, *args, **kwargs)

    def emit_mesh(self, *args, **kwargs):
        emit(self, *args, **kwargs)
        now = time.perf_counter_ns()
        kept = {id(e): born.get(id(e), now) for e in self._pending_mesh_dev}
        born.clear()
        born.update(kept)

    def build_output(self, *args, **kwargs):
        out = build(self, *args, **kwargs)
        in_flight.append((frame_start[0], sum(born.get(id(e), 0) < frame_start[0] for e in self._pending_mesh_dev)))
        return out

    def save_then_stats(self):
        TimingRecorder.stats = stats
        directory = os.path.join(os.environ[DUMP_ENV], f"pid{os.getpid()}")
        self.save(directory)
        with open(os.path.join(directory, "in_flight.json"), "w") as fh:
            json.dump(in_flight, fh)
        return stats(self)

    ActiveWindow.spin_once, ActiveWindow._emit_mesh, ActiveWindow._build_output = spin_once, emit_mesh, build_output
    TimingRecorder.stats = save_then_stats


def in_flight_at_outputs(directory: str, frames):
    """The counts of `in_flight.json` at the outputs inside the saved frames."""
    with open(os.path.join(directory, "in_flight.json")) as fh:
        rows = json.load(fh)
    lo, hi = frames[0]["start"], frames[-1]["end"]
    return [n for start, n in rows if lo <= start <= hi]


def load(directory: str):
    """{name: [(start_ns, end_ns, parent)]} of one robot's saved samples."""
    with open(os.path.join(directory, "stats.csv")) as fh:
        names = [row["name"] for row in csv.DictReader(fh)]
    out = {}
    for name in names:
        with open(os.path.join(directory, name.replace("/", "_") + ".csv")) as fh:
            rows = list(csv.DictReader(fh))
        out[name] = sorted((int(r["start_ns"]), int(r["start_ns"]) + round(float(r["seconds"]) * 1e9), r["parent"])
                           for r in rows)
    return out


def percentile(xs, q):
    s = sorted(xs)
    if not s:
        return float("nan")
    pos = q * (len(s) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (pos - lo)


def frames_of(samples):
    """One dict a frame: its time and each part's, in ms."""
    frames = [dict(start=s, end=e, all=(e - s) * 1e-6) for s, e, _ in samples["active_window/all"]]
    starts = [f["start"] for f in frames]

    def add(name, key):
        for s, e, _ in samples.get(name, []):
            i = bisect.bisect_right(starts, s) - 1
            if i >= 0 and e <= frames[i]["end"]:
                frames[i][key] = frames[i].get(key, 0.0) + (e - s) * 1e-6
                frames[i]["n:" + key] = frames[i].get("n:" + key, 0) + 1

    for name in PARTS + ("active_window/extract_output", "object_extraction/all"):
        add(name, name)
    for name in samples:
        if name.startswith("wait/"):
            add(name, name)
            add(name, "wait/*")
    for f in frames:
        out = f.get("active_window/extract_output", 0.0)
        f["extract/rest"] = out - sum(f.get(k, 0.0) for k in ("extract/emit", "extract/consume_pulls",
                                                              "object_extraction/all"))
        f["object_extraction/rest"] = f.get("object_extraction/all", 0.0) - f.get("object_extraction/track", 0.0)
        f["frame/rest"] = f["all"] - sum(f.get(k, 0.0) for k in ("active_window/scroll", "active_window/fused_step",
                                                                  "active_window/advance_pulls",
                                                                  "active_window/extract_output"))
    return frames


def split(frames):
    """The frames' split and each part's share in setting the 95th percentile."""
    keys = sorted({k for f in frames for k in f if "/" in k and not k.startswith("n:")})
    times = [f["all"] for f in frames]
    p95, lo, hi = (percentile(times, q) for q in (0.95, 0.90, 0.99))
    outputs = [f for f in frames if "active_window/extract_output" in f]
    extracting = [f for f in outputs if f.get("object_extraction/track", 0.0) > 0]
    band = [f for f in frames if lo <= f["all"] <= hi]
    above = [f for f in frames if f["all"] >= p95]
    res = dict(frames=len(frames), outputs=len(outputs), outputs_extracting=len(extracting), p95_ms=p95,
               p50_ms=percentile(times, 0.5),
               output_share_above_p95=sum(1 for f in above if "active_window/extract_output" in f) / max(1, len(above)),
               parts={})
    for k in keys:
        res["parts"][k] = dict(
            mean_ms_per_frame=sum(f.get(k, 0.0) for f in frames) / len(frames),
            mean_ms_per_output=sum(f.get(k, 0.0) for f in outputs) / max(1, len(outputs)),
            mean_ms_in_p90_p99_band=sum(f.get(k, 0.0) for f in band) / max(1, len(band)),
            p95_without_ms=percentile([f["all"] - f.get(k, 0.0) for f in frames], 0.95))
    for name, group in (("outputs", outputs), ("outputs_extracting", extracting),
                        ("outputs_not_extracting", [f for f in outputs if not f.get("object_extraction/track")])):
        res[name + "_ms"] = dict(p50=percentile([f["all"] for f in group], 0.5),
                                 p95=percentile([f["all"] for f in group], 0.95)) if group else None
    if extracting:
        n = [f["n:object_extraction/track"] for f in extracting]
        res["tracks_per_extracting_output"] = dict(p50=percentile(n, 0.5), p95=percentile(n, 0.95), max=max(n))
        res["ms_per_track"] = sum(f["object_extraction/track"] for f in extracting) / sum(n)
    total = sum(f.get("active_window/extract_output", 0.0) for f in frames)
    covered = sum(f.get(k, 0.0) for f in frames for k in ("extract/emit", "extract/consume_pulls",
                                                          "object_extraction/track"))
    res["extract_output_covered"] = covered / total if total else None
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=2**31 + 77)
    ap.add_argument("--seconds", type=float, default=40.0)
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--tiny", action="store_true", help="benchmark/tests/tiny.py's shrink (CPU rehearsal)")
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "output_frames"))
    args = ap.parse_args(argv)
    t_process = time.perf_counter()
    from harness import manifest, runner

    bench = manifest.load()
    cell = manifest.cell(bench, args.workload)
    cfg, traffic = manifest.config(bench, cell["config"]), manifest.traffic(cell["traffic"])
    if args.tiny:
        from tiny import shrink

        cfg, traffic = shrink(cfg, traffic)
    dump = os.path.join(os.path.abspath(args.out), args.workload + ".samples")
    shutil.rmtree(dump, ignore_errors=True)
    os.makedirs(dump)
    os.environ[DUMP_ENV] = dump
    names = manifest.metric_names(bench, args.workload, False)
    res = runner.run(cell, cfg, traffic, args.seed, args.seconds, False, args.device, t_process, names, {},
                     cfg["check_limits"], cfg["check_minimums"],
                     inject="torch_port_output_frames:save_samples_at_window_end")
    dirs = [os.path.join(dump, d) for d in sorted(os.listdir(dump))]
    robots = [frames_of(load(d)) for d in dirs]
    pending = [n for d, r in zip(dirs, robots) for n in in_flight_at_outputs(d, r)]
    out = dict(workload=args.workload, seed=args.seed, correct=res.correct, metrics=res.metrics,
               all_robots=split([f for r in robots for f in r]), robots=[split(r) for r in robots])
    out["all_robots"]["earlier_rounds_in_flight_at_outputs"] = {str(k): pending.count(k) for k in sorted(set(pending))}
    shutil.rmtree(dump, ignore_errors=True)
    with open(os.path.join(os.path.abspath(args.out), args.workload + ".json"), "w") as fh:
        json.dump(out, fh, indent=1)
    print(json.dumps(out["all_robots"] | {"workload": args.workload, "metrics": res.metrics,
                                          "correct": res.correct}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
