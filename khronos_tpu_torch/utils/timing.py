"""Hierarchical stage timers emitting a stats.csv-compatible schema.

TPU-native equivalent of the reference's hydra::timing::ScopedTimer /
ElapsedTimeRecorder (SURVEY.md §5; reference khronos/src/active_window/
active_window.cpp:121 "active_window/all", khronos_ros/src/experiments/
experiment_manager.cpp:252-258 dumps timing/stats.csv + raw series).

Names are hierarchical with '/' separators ("active_window/all",
"motion_detection/clustering"); plotting can reconstruct the hierarchy the
same way the reference's plotting/timing.py does.

Copy of `khronos_tpu/utils/timing.py`. CUDA work is asynchronous: pass a
tensor as `block` to synchronize the device before the timer stops (a CPU
tensor needs no wait), or time whole-step boundaries only.
"""

from __future__ import annotations

import csv
import os
import threading
import time
from contextlib import contextmanager
from typing import Dict, List, Optional

import torch


class TimingRecorder:
    """Aggregates named timers; singleton by default (like ElapsedTimeRecorder)."""

    _instance: Optional["TimingRecorder"] = None

    def __init__(self):
        self._samples: Dict[str, List[float]] = {}
        self._stamps: Dict[str, List[int]] = {}
        self._lock = threading.Lock()
        self.enabled = True

    @classmethod
    def instance(cls) -> "TimingRecorder":
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    def record(self, name: str, seconds: float, stamp_ns: int = 0) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._samples.setdefault(name, []).append(seconds)
            self._stamps.setdefault(name, []).append(stamp_ns)

    @contextmanager
    def scoped(self, name: str, stamp_ns: int = 0, block=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block is not None and block.is_cuda:
                torch.cuda.synchronize(block.device)
            self.record(name, time.perf_counter() - t0, stamp_ns)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._samples)

    def samples(self, name: str) -> List[float]:
        with self._lock:
            return list(self._samples.get(name, []))

    def reset(self) -> None:
        with self._lock:
            self._samples.clear()
            self._stamps.clear()

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
        """Write timing/stats.csv + per-timer raw sample series."""
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
                    w.writerow(["stamp_ns", "seconds"])
                    for s, x in zip(self._stamps[name], xs):
                        w.writerow([s, x])


def Timer(name: str, stamp_ns: int = 0, block=None):
    """Scoped timer on the global recorder (mirrors the reference's `Timer`)."""
    return TimingRecorder.instance().scoped(name, stamp_ns, block=block)


def device_trace(log_dir: str):
    """Context manager wrapping torch.profiler: captures a host + CUDA trace
    (kernel timeline) written to `log_dir` as a Chrome trace viewable in
    Perfetto — the device half of the SURVEY.md §5 observability story (the
    host half is the stats.csv stage timers above).

        with device_trace("/tmp/khronos_trace"):
            aw.spin_once(frame)
    """
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    return profile(
        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
        on_trace_ready=tensorboard_trace_handler(log_dir),
    )
