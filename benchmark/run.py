"""The benchmark of khronos_tpu_torch: one run of one cell.

    python3 benchmark/run.py --workload office.window.r4 --seed 7 --seconds 20 --trace 0

Runs from the root of a checkout on a machine with an NVIDIA GPU. Prints one
JSON line on standard output (the cell's end-to-end metrics with --trace 0,
its per-layer metrics with --trace 1), and the numbers the check compared,
each beside its limit, as the last lines on standard error. Each robot of the
cell runs in a worker process of its own on the card (harness/runner.py),
driven by its configuration's driver (drivers/<driver>.py). Exits non-zero
with no result when no card is visible, when the program is missing, when
the configuration names no driver, when a worker fails, or when the port
pulled in JAX or the JAX package in this process or in a worker.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    # every cache the program or its libraries write stays in the checkout, at a fixed path
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR", str(ROOT / "build" / "inductor"))
    for p in (str(HERE), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    from harness import manifest, runner
    from harness.manifest import forbidden_modules

    bench = manifest.load(ROOT)
    cell = manifest.cell(bench, args.workload)
    if not (ROOT / "khronos_tpu_torch").is_dir():
        print("the program (khronos_tpu_torch) is not in this checkout", file=sys.stderr)
        return 3
    cfg = manifest.config(bench, cell["config"], ROOT)
    traffic = manifest.traffic(cell["traffic"])
    names = manifest.metric_names(bench, cell["name"], bool(args.trace))
    readers = {n: manifest.reader(n) for n in names if n not in manifest.BUILT_IN}
    try:
        res = runner.run(cell, cfg, traffic, args.seed, args.seconds, bool(args.trace), "cuda:0", T_PROCESS, names,
                         readers, cfg["check_limits"], cfg["check_minimums"])
    except RuntimeError as exc:  # no card, too few cards, or a worker that failed
        print(f"the run did not complete: {exc}", file=sys.stderr)
        return 5
    bad = sorted(set(forbidden_modules(sys.modules)) | set(res.bad_modules))
    if bad:
        print(f"the run loaded JAX or the JAX package: {bad}", file=sys.stderr)
        return 4
    for note in res.notes:
        print(note, file=sys.stderr)
    for row in res.rows:
        print("checked " + json.dumps(row), file=sys.stderr)
    device_info = {"platform": "gpu", "count": int(cell["chips"])}
    device_info.update(res.device)
    line = {
        "correct": bool(res.correct),
        "attempted": res.attempted,
        "failed": res.failed,
        "metrics": {k: {"value": v, "unit": manifest.unit(bench, k)} for k, v in res.metrics.items()},
        "device": device_info,
    }
    if res.breakdown is not None:
        line["breakdown"] = res.breakdown
    line["check"] = res.check
    for k, v in res.check.items():
        rel = "at least" if v.get("at_least") else "limit"
        print(f"check {k} {v['value']!r} {rel} {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
