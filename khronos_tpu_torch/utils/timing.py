"""Hierarchical stage timers emitting a stats.csv-compatible schema.

TPU-native equivalent of the reference's hydra::timing::ScopedTimer /
ElapsedTimeRecorder (SURVEY.md §5; reference khronos/src/active_window/
active_window.cpp:121 "active_window/all", khronos_ros/src/experiments/
experiment_manager.cpp:252-258 dumps timing/stats.csv + raw series).

Names are hierarchical with '/' separators ("active_window/all",
"motion_detection/clustering"); plotting can reconstruct the hierarchy the
same way the reference's plotting/timing.py does.

Each sample keeps its duration, its start on `time.perf_counter_ns()` (the
clock a torch.profiler trace can be put on beside a `perf_counter` read),
its stamp and its parent: the innermost span still open on the same thread
when it opened ("" at the top). A span given no stamp takes its parent's, so
every span inside a frame carries that frame's stamp.

`Wait` is the span `wait/<site>` around a point where the host blocks on the
card: its count is the waits, its total the time blocked.

Extends a copy of `khronos_tpu/utils/timing.py`. CUDA work is asynchronous
and no span synchronises the device: a span measures the host's time, and
the host's time in a `Wait` is the time it waited.
"""

from __future__ import annotations

import csv
import os
import threading
import time
from contextlib import contextmanager, nullcontext
from typing import Dict, List, Optional, Tuple


class TimingRecorder:
    """Aggregates named timers; singleton by default (like ElapsedTimeRecorder)."""

    _instance: Optional["TimingRecorder"] = None

    def __init__(self):
        self._samples: Dict[str, List[float]] = {}
        self._stamps: Dict[str, List[int]] = {}
        self._starts: Dict[str, List[int]] = {}
        self._parents: Dict[str, List[str]] = {}
        self._lock = threading.Lock()
        self._open = threading.local()  # .stack: this thread's open spans, [(name, stamp_ns)]
        self.enabled = True

    @classmethod
    def instance(cls) -> "TimingRecorder":
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    def _stack(self) -> List[Tuple[str, int]]:
        stack = getattr(self._open, "stack", None)
        if stack is None:
            stack = self._open.stack = []
        return stack

    def record(self, name: str, seconds: float, stamp_ns: Optional[int] = None, start_ns: Optional[int] = None,
               parent: Optional[str] = None) -> None:
        """One sample. Left out: the parent is the innermost span open on
        this thread, the stamp the parent's (0 at the top), the start
        `seconds` before now."""
        if not self.enabled:
            return
        if parent is None or stamp_ns is None:
            stack = self._stack()
            top_name, top_stamp = stack[-1] if stack else ("", 0)
            parent = top_name if parent is None else parent
            stamp_ns = top_stamp if stamp_ns is None else stamp_ns
        if start_ns is None:
            start_ns = time.perf_counter_ns() - int(seconds * 1e9)
        with self._lock:
            self._samples.setdefault(name, []).append(seconds)
            self._stamps.setdefault(name, []).append(stamp_ns)
            self._starts.setdefault(name, []).append(start_ns)
            self._parents.setdefault(name, []).append(parent)

    @contextmanager
    def scoped(self, name: str, stamp_ns: Optional[int] = None):
        stack = self._stack()
        parent, parent_stamp = stack[-1] if stack else ("", 0)
        stamp = parent_stamp if stamp_ns is None else stamp_ns
        stack.append((name, stamp))
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            t1 = time.perf_counter_ns()
            stack.pop()
            self.record(name, (t1 - t0) * 1e-9, stamp, t0, parent)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._samples)

    def samples(self, name: str) -> List[float]:
        with self._lock:
            return list(self._samples.get(name, []))

    def series(self, name: str) -> List[Tuple[int, float, int, str]]:
        """Every sample of `name` as (start_ns, seconds, stamp_ns, parent),
        in the order the spans closed."""
        with self._lock:
            return list(zip(self._starts.get(name, []), self._samples.get(name, []), self._stamps.get(name, []),
                            self._parents.get(name, [])))

    def reset(self) -> None:
        with self._lock:
            self._samples.clear()
            self._stamps.clear()
            self._starts.clear()
            self._parents.clear()

    def stats(self) -> List[dict]:
        """Per-timer summary rows matching the reference's timing/stats.csv schema:
        name, n_samples, total_s, mean_s, stddev_s, min_s, max_s."""
        rows = []
        with self._lock:
            for name in sorted(self._samples):
                xs = self._samples[name]
                n = len(xs)
                total = sum(xs)
                mean = total / n
                var = sum((x - mean) ** 2 for x in xs) / n if n > 1 else 0.0
                rows.append(
                    {
                        "name": name,
                        "n_samples": n,
                        "total_s": total,
                        "mean_s": mean,
                        "stddev_s": var**0.5,
                        "min_s": min(xs),
                        "max_s": max(xs),
                    }
                )
        return rows

    def save(self, directory: str) -> None:
        """Write timing/stats.csv + per-timer raw sample series (stamp,
        seconds, start on perf_counter_ns, parent)."""
        os.makedirs(directory, exist_ok=True)
        rows = self.stats()
        with open(os.path.join(directory, "stats.csv"), "w", newline="") as fh:
            writer = csv.DictWriter(
                fh,
                fieldnames=[
                    "name",
                    "n_samples",
                    "total_s",
                    "mean_s",
                    "stddev_s",
                    "min_s",
                    "max_s",
                ],
            )
            writer.writeheader()
            writer.writerows(rows)
        with self._lock:
            for name, xs in self._samples.items():
                fname = name.replace("/", "_") + ".csv"
                with open(os.path.join(directory, fname), "w", newline="") as fh:
                    w = csv.writer(fh)
                    w.writerow(["stamp_ns", "seconds", "start_ns", "parent"])
                    w.writerows(zip(self._stamps[name], xs, self._starts[name], self._parents[name]))


def Timer(name: str, stamp_ns: Optional[int] = None):
    """Scoped timer on the global recorder (mirrors the reference's `Timer`)."""
    return TimingRecorder.instance().scoped(name, stamp_ns)


def Wait(site: str, blocks: bool = True):
    """Span `wait/<site>` on the global recorder around a point where the
    host blocks on the card; `blocks=False` (a CPU tensor, a copy that has
    landed) records nothing."""
    return TimingRecorder.instance().scoped("wait/" + site) if blocks else nullcontext()
