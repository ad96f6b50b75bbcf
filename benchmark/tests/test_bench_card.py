"""On a card: one short run of each cell through the command a check runs,
its result line as the driver reads it."""

import json
import subprocess
import sys

import pytest
import torch

from harness import manifest


@pytest.mark.gpu
@pytest.mark.parametrize("name", [w["name"] for w in manifest.load()["workloads"]])
def test_cell_runs_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", name, "--seed", str(2**31 + 77),
                          "--seconds", "5", "--trace", "0"], capture_output=True, text=True, timeout=360,
                         cwd=manifest.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert set(line["metrics"]) == set(manifest.metric_names(manifest.load(), name, False))


def test_no_result_without_a_card_or_without_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and benchmark/, a run
    exits non-zero and prints no result."""
    import shutil

    shutil.copytree(manifest.HERE, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(manifest.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "office.window.r4", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], capture_output=True, text=True, timeout=300,
                         cwd=tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
