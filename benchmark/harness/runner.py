"""One run of one cell: a worker process a robot on the one card, the
common release, the window, the merged trace, the check.

Each robot is its own process with its own CUDA context and its own map,
as each robot's Khronos would be on a base-station card (`worker.py`);
the configuration's driver says what a robot runs and how its captures
are judged (`drivers/window.py`). The parent renders nothing and touches
no device: it starts the workers, waits until every one has set up,
releases them together, and ends the window when the last of them has
synchronised its device work. The loop is closed: a robot's next frame
goes in when its previous call has returned, a bag replayed as fast as the
system takes it.
"""

from __future__ import annotations

import bisect
import dataclasses
import multiprocessing
import time
from typing import Dict, List, Optional

import numpy as np

from harness import entry
from harness.manifest import HERE, driver, driver_path

READY_S = 1100.0  # a checkout's first run builds the kernels
REPLY_S = 300.0


@dataclasses.dataclass
class Result:
    correct: bool
    attempted: int
    failed: int
    metrics: Dict[str, float]
    device: Dict
    check: Dict[str, Dict]
    breakdown: Optional[Dict] = None
    rows: Optional[List[Dict]] = None
    notes: List[str] = dataclasses.field(default_factory=list)
    control_rows: Optional[List[Dict]] = None
    bad_modules: List[str] = dataclasses.field(default_factory=list)


def percentile(xs: List[float], q: float) -> float:
    """The q-quantile (0..1) of xs, linear between order statistics."""
    s = sorted(xs)
    if not s:
        return float("nan")
    pos = q * (len(s) - 1)
    lo = int(np.floor(pos))
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (pos - lo)


class Merged:
    """The robots' traces of one stretch, merged on the shared clock: what
    the per-layer readers take (kernels by name, busy seconds, the stretch's
    length, frames in it, the longest idle gaps)."""

    def __init__(self, traces: List[Dict]):
        lo, hi = max(t["t_on"] for t in traces), min(t["t_off"] for t in traces)
        self.window_s = max(0.0, hi - lo)  # every robot's profiler ran over it
        self.frames = sum(1 for t in traces for s, e, _ in t["spans"] if lo <= (s + e) / 2 < hi)
        self.kernels: Dict[str, List] = {}
        dev = []
        for r, t in enumerate(traces):
            for s, e, n in t["dev"]:
                s, e = max(s, lo), min(e, hi)
                if e <= s:
                    continue
                k = self.kernels.setdefault(n, [0, 0.0])
                k[0] += 1
                k[1] += e - s
                dev.append((s, e, r, n))
        dev.sort()
        busy, gaps = 0.0, []
        cur_s = cur_e = None
        for s, e, r, n in dev:
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                    gaps.append((cur_e, s, r))
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            busy += cur_e - cur_s
        self.busy_s = busy
        hosts = [sorted(t["host"]) for t in traces]
        spans = [sorted(t["spans"]) for t in traces]
        self.gaps = []
        for a, b, r in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
            ht = [h[0] for h in hosts[r]]
            i = bisect.bisect_right(ht, b) - 1
            op = hosts[r][i][1] if i >= 0 else "?"
            st = [s[0] for s in spans[r]]
            j = bisect.bisect_right(st, a) - 1
            who = spans[r][j][2] if j >= 0 and spans[r][j][1] >= a else f"robot{r} between calls"
            self.gaps.append((f"{who}: until {op}", b - a))

    def breakdown(self) -> Dict:
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1][1])[:10]
        return {"device_ops": [[n[:120], t] for n, (c, t) in ops], "idle_gaps": [[n[:120], s] for n, s in self.gaps]}

    def kernel_count(self) -> int:
        return sum(c for c, _ in self.kernels.values())

    def kernel_time(self, needle: str):
        """(launches, device seconds) of the kernels whose name holds needle."""
        c = t = 0
        for n, (cn, tn) in self.kernels.items():
            if needle in n:
                c += cn
                t += tn
        return c, t


def merge_spans(per_robot: List[List[Dict]]) -> Dict[str, Dict]:
    """The program's span rows of every robot, one row a name: count, total
    and mean seconds, and the seconds of every sample (robot after robot)."""
    out: Dict[str, Dict] = {}
    for rows in per_robot:
        for row in rows:
            m = out.setdefault(row["name"], {"name": row["name"], "n_samples": 0, "total_s": 0.0, "seconds": []})
            m["n_samples"] += row["n_samples"]
            m["total_s"] += row["total_s"]
            m["seconds"] += row["seconds"]
    for m in out.values():
        m["mean_s"] = m["total_s"] / max(1, m["n_samples"])
    return out


def _stop_forkserver() -> None:
    """End the server the workers forked from, and wait for it."""
    from multiprocessing import forkserver

    stop = getattr(forkserver._forkserver, "_stop", None)
    if stop is not None:
        stop()


def _recv(conn, proc, timeout: float, what: str):
    if not conn.poll(timeout):
        raise RuntimeError(f"worker {proc.name} sent no {what} within {timeout:.0f} s")
    try:
        msg = conn.recv()
    except EOFError:
        raise RuntimeError(f"worker {proc.name} ended before its {what} (exit code {proc.exitcode})") from None
    if msg[0] == "error":
        raise RuntimeError(f"worker {proc.name} failed:\n{msg[1]}")
    if msg[0] != what:
        raise RuntimeError(f"worker {proc.name} sent {msg[0]!r}, not {what!r}")
    return msg[1]


def run(cell: dict, cfg: dict, traffic: dict, seed: int, seconds: float, trace: bool, device: str,
        t_process: float, metric_names: List[str], readers: Dict, limits: Dict[str, float],
        minimums: Dict[str, float], inject: Optional[str] = None, control: bool = False,
        bench_dir=HERE) -> Result:
    """One run, driven by the configuration's driver (drivers/<driver>.py
    under bench_dir), which the workers load too. device: "cuda:0" or "cpu";
    t_process: the perf_counter reading at process start; limits: the
    largest accepted value of each number that the driver compares;
    minimums: the coverage it needs; inject: "module:function" that every
    worker calls first (a planted fault); control: also judge the reference
    in bfloat16 in the program's place."""
    driver_file = driver_path(cfg, bench_dir)
    drv = driver(driver_file)
    unknown = sorted((set(limits) - set(drv.LIMITS)) | (set(minimums) - set(drv.MINIMUMS)))
    if unknown:
        raise ValueError(f"the driver {driver_file} has no check numbers {unknown}")
    # the workers fork from a server that has imported torch and the harness once; this process loads neither
    ctx = multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload(["harness.worker"])
    n = int(traffic["robots"])
    procs, conns = [], []
    t_spawn = time.perf_counter()
    try:
        for r in range(n):
            parent, child = ctx.Pipe()
            spec = dict(cfg=cfg, driver=str(driver_file), traffic=traffic, seed=seed, robot=r, device=device,
                        trace=trace, inject=inject, control=control, threads=traffic.get("threads", 2),
                        chips=cell["chips"])
            p = ctx.Process(target=entry.main, args=(child, spec), name=f"robot{r}", daemon=True)
            p.start()
            child.close()
            procs.append(p)
            conns.append(parent)
        ready = [_recv(c, p, READY_S, "ready") for c, p in zip(conns, procs)]

        # ---------------- the measured window, every robot released at t0
        t0 = time.perf_counter() + 0.05
        on = t0 + float(traffic["trace_after_s"])
        go = dict(t0=t0, deadline=t0 + seconds, trace_on=on, trace_off=on + float(traffic["trace_seconds"]))
        for c in conns:
            c.send(("go", go))
        win = [_recv(c, p, seconds + REPLY_S, "window") for c, p in zip(conns, procs)]
        checked = [_recv(c, p, REPLY_S, "check") for c, p in zip(conns, procs)]
        for p in procs:
            p.join(60)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
        _stop_forkserver()
    setup_s = t0 - t_process
    t_end = max(w["t_end"] for w in win)
    window_s = t_end - t0
    latencies = [x for w in win for x in w["latencies"]]
    failed = sum(w["failed"] for w in win)
    attempted = len(latencies) + failed
    spans = merge_spans([w["spans"] for w in win])
    launches = tuple(sum(w["launches"][k] for w in win) for k in range(2))
    merged = Merged([w["trace"] for w in win]) if trace else None

    # ---------------- metrics
    values = {"frames_per_s": len(latencies) / window_s, "frame_ms_p95": percentile(latencies, 0.95) * 1e3,
              "setup_s": setup_s}
    ctx_r = dict(cell=cell, cfg=cfg, traffic=traffic, spans=spans, launches=launches, latencies=latencies,
                 window_s=window_s, tracer=merged)
    metrics = {}
    for name in metric_names:
        v = values[name] if name in values else readers[name].read(ctx_r)
        if v is not None:
            metrics[name] = v
    notes = [f"set-up {setup_s:.3f} s; robot 0: imports {ready[0]['imports_s']:.3f} s, rendering "
             f"{ready[0]['frames']} frames {ready[0]['render_s']:.3f} s, engine and warm-up {ready[0]['warmup_s']:.3f} s; "
             f"workers started at {t_spawn - t_process:.3f} s, entered at "
             f"{[round(x['t_entry'] - t_process, 3) for x in ready]} s, ready at "
             f"{[round(x['t_ready'] - t_process, 3) for x in ready]} s",
             f"frames {len(latencies)} in {window_s:.3f} s over {n} robots ({[w['sent'] for w in win]} sent; "
             f"ends {[round(w['t_end'] - t0, 3) for w in win]} s), latency median "
             f"{percentile(latencies, 0.5) * 1e3:.3f} ms" if latencies else "no frame in the window",
             f"kernel A launches {launches[0]}, kernel B launches {launches[1]}; late captures "
             f"{[round(c['late_s'], 3) for c in checked]} s"]
    notes += [f"robot {r} failed:\n{w['error']}" for r, w in enumerate(win) if w["error"]]
    if trace:
        notes += [f"traced from {merged_on - t0:.3f} to {merged_off - t0:.3f} s: {merged.frames} frames, "
                  f"{merged.kernel_count()} device operations" for merged_on, merged_off in
                  [(max(w["trace"]["t_on"] for w in win), min(w["trace"]["t_off"] for w in win))]]
    device_info = {"kind": ready[0]["card"], "memory_peak_bytes": int(sum(c["peak"] for c in checked))}
    breakdown = None
    if merged is not None:
        device_info.update(busy_s=merged.busy_s, window_s=merged.window_s)
        breakdown = merged.breakdown()

    # ---------------- the check, made in each worker once its window closed
    rows = [row for c in checked for row in c["rows"]]
    worst = drv.worst(rows)
    want = n * drv.captures(traffic)
    ok = failed == 0 and len(rows) == want
    ok = ok and all(worst[k] <= v for k, v in limits.items()) and all(worst[k] >= v for k, v in minimums.items())
    checked_nums = {k: {"value": worst[k], "limit": v} for k, v in limits.items()}
    checked_nums.update({k: {"value": worst[k], "limit": v, "at_least": True} for k, v in minimums.items()})
    checked_nums["frames_checked"] = {"value": len(rows), "limit": want, "at_least": True}
    control_rows = [row for c in checked for row in (c["control"] or [])] if control else None
    bad = sorted({m for c in checked for m in c["bad_modules"]})
    return Result(ok, attempted, failed, metrics, device_info, checked_nums, breakdown, rows, notes, control_rows,
                  bad)
