"""The readings that the check's limits are set from (not part of a run).

    python3 benchmark/control.py --workload office.window.r4 --seeds 1 2 3 --seconds 5

For each seed: a run of the cell at its own load with a short window, then,
on what the run captured, the numbers the check compares for the program
(the sound reading) and for the control: the reference itself computed in
bfloat16, the precision below the configuration's float32, put in the
program's place. Prints one JSON line a seed; a limit lies above every
sound reading and below every control reading.
"""

from __future__ import annotations

import time

import argparse
import json
import sys

from run import HERE, ROOT


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    for p in (str(HERE), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    from harness import manifest, runner

    bench = manifest.load(ROOT)
    cell = manifest.cell(bench, args.workload)
    cfg = manifest.config(bench, cell["config"], ROOT)
    drv = manifest.driver(manifest.driver_path(cfg))
    traffic = manifest.traffic(cell["traffic"])
    for seed in args.seeds:
        res = runner.run(cell, cfg, traffic, seed, args.seconds, False, "cuda:0", time.perf_counter(),
                         ["frames_per_s"], {}, cfg["check_limits"], cfg["check_minimums"], control=True)
        print(json.dumps({"workload": cell["name"], "seed": seed, "correct": res.correct,
                          "frames_per_s": res.metrics.get("frames_per_s"), "sound": drv.worst(res.rows),
                          "control": drv.worst(res.control_rows), "rows": res.rows,
                          "control_rows": res.control_rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
