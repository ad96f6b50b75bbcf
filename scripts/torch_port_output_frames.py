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
frames' time with that part taken out, beside the percentile as it is.

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
    end) first saves every sample under $KHRONOS_SPAN_DUMP_DIR/pid<pid>."""
    from khronos_tpu_torch.utils.timing import TimingRecorder

    stats = TimingRecorder.stats

    def save_then_stats(self):
        TimingRecorder.stats = stats
        self.save(os.path.join(os.environ[DUMP_ENV], f"pid{os.getpid()}"))
        return stats(self)

    TimingRecorder.stats = save_then_stats


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
    robots = [frames_of(load(os.path.join(dump, d))) for d in sorted(os.listdir(dump))]
    out = dict(workload=args.workload, seed=args.seed, correct=res.correct, metrics=res.metrics,
               all_robots=split([f for r in robots for f in r]), robots=[split(r) for r in robots])
    shutil.rmtree(dump, ignore_errors=True)
    with open(os.path.join(os.path.abspath(args.out), args.workload + ".json"), "w") as fh:
        json.dump(out, fh, indent=1)
    print(json.dumps(out["all_robots"] | {"workload": args.workload, "metrics": res.metrics,
                                          "correct": res.correct}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
