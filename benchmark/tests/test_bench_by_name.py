"""A later change adds a cell and a per-layer metric as new files and
entries only: the harness finds and runs them by name."""

import json
import shutil

from harness import manifest
from tiny import run_tiny


def test_a_new_cell_and_metric_from_new_files_only(tmp_path):
    bench_dir = tmp_path / "benchmark"
    shutil.copytree(manifest.HERE, bench_dir, ignore=shutil.ignore_patterns("__pycache__"))
    bench = manifest.load()
    bench["workloads"].append({"name": "office.window.r2", "config": "synthetic_office", "traffic": "window.r2",
                               "chips": 1, "why": "two robots"})
    for m in bench["end_to_end"]:
        if "workloads" in m and "office.window.r4" in m["workloads"]:
            m["workloads"].append("office.window.r2")
    bench["per_layer"].append({"name": "window.outputs", "unit": "outputs", "better": "higher",
                               "source": "program_span", "layer": "window", "moves": "frames_per_s",
                               "workloads": ["office.window.r2"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    traffic = json.loads((bench_dir / "traffic" / "window.r4.json").read_text())
    (bench_dir / "traffic" / "window.r2.json").write_text(json.dumps(dict(traffic, robots=2)))
    (bench_dir / "metrics" / "window.outputs.py").write_text(
        "def read(ctx):\n    row = ctx['spans'].get('active_window/extract_output')\n"
        "    return row['n_samples'] if row else None\n")
    res, _ = run_tiny("office.window.r2", trace=True, root=tmp_path, bench_dir=bench_dir)
    assert res.correct and res.metrics["window.outputs"] > 0
    assert res.check["frames_checked"]["value"] == res.check["frames_checked"]["limit"]
    res, _ = run_tiny("office.window.r2", trace=False, root=tmp_path, bench_dir=bench_dir)
    assert set(res.metrics) == {"frames_per_s", "frame_ms_p95", "setup_s"}
