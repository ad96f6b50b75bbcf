"""Experiment logger with timestamped entries and queryable [FLAG]s.

Equivalent of the reference's ExperimentLogger (khronos_ros/src/experiments/
experiment_logger.{h,cpp}): writes experiment_log.txt lines
"[<iso-stamp>] message" and "[<iso-stamp>] [FLAG] name"; the
"Experiment Finished Cleanly" flag is the de-facto run-validity sentinel
checked by eval tooling (experiment_manager.cpp:279).

Copy of `khronos_tpu/utils/logging.py`.
"""

from __future__ import annotations

import datetime
import os
from typing import List, Optional

FINISHED_CLEANLY = "Experiment Finished Cleanly"

# ---------------------------------------------------------------------------
# CLOG-equivalent verbosity logging (reference common_types.h:133-142):
# level 1 = once-per-run notices, 2 = infrequent, 3 = per-frame, 4+ = debug.
# Set via set_verbosity() or the KHRONOS_VERBOSITY env var.
_verbosity: Optional[int] = None


def get_verbosity() -> int:
    global _verbosity
    if _verbosity is None:
        _verbosity = int(os.environ.get("KHRONOS_VERBOSITY", "1"))
    return _verbosity


def set_verbosity(level: int) -> None:
    global _verbosity
    _verbosity = int(level)


def clog(level: int, message: str) -> None:
    """Print `message` iff the configured verbosity >= level (CLOG parity)."""
    if get_verbosity() >= level:
        import sys

        print(f"[khronos:{level}] {message}", file=sys.stderr)


class ExperimentLogger:
    def __init__(self, directory: str, filename: str = "experiment_log.txt"):
        os.makedirs(directory, exist_ok=True)
        self.path = os.path.join(directory, filename)
        self._fh = open(self.path, "a")

    def _stamp(self) -> str:
        return datetime.datetime.now().isoformat(timespec="milliseconds")

    def log(self, message: str) -> None:
        self._fh.write(f"[{self._stamp()}] {message}\n")
        self._fh.flush()

    def flag(self, name: str) -> None:
        self.log(f"[FLAG] {name}")

    def close(self) -> None:
        self._fh.close()

    @staticmethod
    def has_flag(directory: str, name: str, filename: str = "experiment_log.txt") -> bool:
        path = os.path.join(directory, filename)
        if not os.path.exists(path):
            return False
        with open(path) as fh:
            return any(f"[FLAG] {name}" in line for line in fh)

    @staticmethod
    def read_flags(directory: str, filename: str = "experiment_log.txt") -> List[str]:
        path = os.path.join(directory, filename)
        flags: List[str] = []
        if not os.path.exists(path):
            return flags
        with open(path) as fh:
            for line in fh:
                if "[FLAG] " in line:
                    flags.append(line.split("[FLAG] ", 1)[1].strip())
        return flags


def setup_output_directory(base: str, overwrite: bool = False) -> str:
    """Create an experiment output directory tree (mirrors DataDirectory)."""
    if os.path.exists(base) and not overwrite:
        suffix = 1
        while os.path.exists(f"{base}_{suffix}"):
            suffix += 1
        base = f"{base}_{suffix}"
    for sub in ("", "timing", "results", "maps", "snapshots"):
        os.makedirs(os.path.join(base, sub), exist_ok=True)
    return base
