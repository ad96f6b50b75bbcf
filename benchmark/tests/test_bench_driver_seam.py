"""A deployment joins the benchmark as new files only: a configuration that
names its own driver, a traffic, the driver, a per-layer metric's reader,
and entries in BENCHMARK.json. The driver here is `probe_pipeline.py`: the
whole KhronosPipeline a robot, stepped through `process_frame` with the
backend on, the window's captures taken on its active window, and a
capture and a check number of its own.

At this size on the CPU the pipeline runs whole and stays within a
minute: the backend at each output, places at the outputs (the
configuration's default), change detection every 8 frames."""

import hashlib
import json
import shutil

import pytest

from harness import manifest
from tiny import run_tiny

CELL = "office.pipeline.probe"


def _files(root):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def _add_deployment(root):
    bench_dir = root / "benchmark"
    cfg = json.loads((bench_dir / "configs" / "synthetic_office.json").read_text())
    cfg.update(name="probe_pipeline", driver="probe_pipeline",
               pipeline={"run_change_detection_every_n_frames": 8},
               check_minimums=dict(cfg["check_minimums"], backend_outputs=1))
    (bench_dir / "configs" / "probe_pipeline.json").write_text(json.dumps(cfg))
    traffic = json.loads((bench_dir / "traffic" / "window.r4.json").read_text())
    traffic.update(robots=2, backend_check_frames=[12, 16])
    (bench_dir / "traffic" / "pipeline.probe.json").write_text(json.dumps(traffic))
    shutil.copy(manifest.HERE / "tests" / "probe_pipeline.py", bench_dir / "drivers" / "probe_pipeline.py")
    (bench_dir / "metrics" / "backend.probe_ms_p75.py").write_text(
        "from harness.runner import percentile\n\n\ndef read(ctx):\n"
        "    row = ctx['spans'].get('backend/add_output')\n"
        "    return percentile(row['seconds'], 0.75) * 1e3 if row else None\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "probe_pipeline", "source": "https://github.com/MIT-SPARK/Khronos",
                             "file": "benchmark/configs/probe_pipeline.json", "reduced": [], "why": "a probe"})
    bench["workloads"].append({"name": CELL, "config": "probe_pipeline", "traffic": "pipeline.probe", "chips": 1,
                               "why": "the full pipeline, a probe of the driver seam"})
    bench["per_layer"].append({"name": "backend.probe_ms_p75", "unit": "ms", "better": "lower",
                               "source": "program_span", "layer": "backend", "moves": "frames_per_s",
                               "workloads": [CELL]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


def test_a_deployment_joins_as_new_files_and_entries_only(tmp_path):
    bench_dir = tmp_path / "benchmark"
    shutil.copytree(manifest.HERE, bench_dir, ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(manifest.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before, old = _files(tmp_path), manifest.load(tmp_path)
    _add_deployment(tmp_path)
    after, new = _files(tmp_path), manifest.load(tmp_path)
    # no file of the benchmark changed; BENCHMARK.json gained entries and lost or changed none
    assert {p for p in before if after.get(p) != before[p]} == {"BENCHMARK.json"}
    assert len(after) == len(before) + 4
    for key, value in old.items():
        assert new[key][:len(value)] == value if isinstance(value, list) else new[key] == value, key

    res, cfg = run_tiny(CELL, trace=True, root=tmp_path, bench_dir=bench_dir)
    assert res.correct, res.check
    probe = manifest.driver(bench_dir / "drivers" / "probe_pipeline.py")
    owed = res.check["frames_checked"]
    assert owed["value"] == owed["limit"] == 2 * probe.captures(manifest.traffic("pipeline.probe", bench_dir))
    assert {r["kind"] for r in res.rows} == {"step", "mesh", "scroll", "backend"}
    assert res.check["backend_outputs"]["value"] >= 1
    assert res.metrics["backend.probe_ms_p75"] > 0

    res, _ = run_tiny(CELL, root=tmp_path, bench_dir=bench_dir, inject="faults:ids_altered")
    assert not res.correct
    assert res.check["id_mismatch"]["value"] > res.check["id_mismatch"]["limit"], res.check


def test_the_names_from_before_drivers_keep_their_form():
    """Scripts that drive the window by hand (scripts/torch_port_sync_census.py,
    scripts/torch_port_output_frames.py) call runner.run, worker.Robot and
    the warm-up scroll as they were before drivers."""
    import inspect

    from harness import runner, worker

    assert list(inspect.signature(runner.run).parameters)[:12] == [
        "cell", "cfg", "traffic", "seed", "seconds", "trace", "device", "t_process", "metric_names", "readers",
        "limits", "minimums"]
    window = str(manifest.HERE / "drivers" / "window.py")
    assert inspect.getfile(worker.Robot) == inspect.getfile(worker.warmup_scroll) == window
    assert [c.__name__ for c in worker.Robot.__mro__[:2]] == ["GivenEngine", "Robot"]
    assert list(inspect.signature(worker.Robot).parameters) == [
        "index", "frames", "start", "stamp_ns", "engine", "step_at", "mesh_from", "scroll_from"]
    assert callable(worker.build_engine)
    with pytest.raises(AttributeError):
        worker.no_such_name
