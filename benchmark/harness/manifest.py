"""BENCHMARK.json and the files it names: a cell is found by its name, its
configuration in configs/<config>.json, the configuration's driver (what
its robots run and how the check judges them) in drivers/<driver>.py, its
traffic in traffic/<traffic>.json, each per-layer metric's reader in
metrics/<metric>.py."""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent  # benchmark/
ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BUILT_IN = ("frames_per_s", "frame_ms_p95", "setup_s")  # runner.py measures them
FORBIDDEN = ("jax", "jaxlib", "flax", "khronos_tpu")  # top-level module names


def forbidden_modules(modules) -> list:
    """Loaded modules whose top-level name (before the first dot) is one of
    FORBIDDEN, compared whole: khronos_tpu_torch is not khronos_tpu."""
    return sorted({m for m in modules if m.split(".")[0] in FORBIDDEN})


def load(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as fh:
        return json.load(fh)


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def _json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def config(bench: dict, name: str, root: Path = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return _json(root / c["file"])
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str, bench_dir: Path = HERE) -> dict:
    return _json(bench_dir / "traffic" / f"{name}.json")


def applies(metric: dict, cell_name: str) -> bool:
    return "workloads" not in metric or cell_name in metric["workloads"]


def metric_names(bench: dict, cell_name: str, trace: bool):
    kind = "per_layer" if trace else "end_to_end"
    return [m["name"] for m in bench[kind] if applies(m, cell_name)]


def _module(prefix: str, path: Path):
    name = prefix + path.stem.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod  # a dataclass in it looks its module up there
    spec.loader.exec_module(mod)
    return mod


def reader(name: str, bench_dir: Path = HERE):
    """The module metrics/<name>.py, with its read(ctx) -> value or None."""
    return _module("bench_metric_", bench_dir / "metrics" / f"{name}.py")


def driver_path(cfg: dict, bench_dir: Path = HERE) -> Path:
    """drivers/<driver>.py of a configuration, which names its driver under
    "driver"; there is no default."""
    name = cfg.get("driver")
    path = bench_dir / "drivers" / f"{name}.py"
    if not isinstance(name, str) or not NAME.match(name) or not path.is_file():
        raise ValueError(f"configuration {cfg.get('name')!r} names the driver {name!r}: no file {path}")
    return path


def driver(path) -> object:
    """The driver module at `path` (drivers/window.py says what it defines)."""
    return _module("bench_driver_", Path(path))


def unit(bench: dict, name: str) -> str:
    for kind in ("end_to_end", "per_layer"):
        for m in bench[kind]:
            if m["name"] == name:
                return m["unit"]
    raise KeyError(name)
