"""bench_torch.py against bench.py: the port's benchmark of the JAX
package's benchmark.

bench.py's flags and defaults, its active-window config and its pipeline
config are taken from its own source (ast, as tests/test_torch_endurance.py
takes scripts/endurance.py's) and bench_torch.py's are held to them, equal.
Both modes then run on the CPU at a small size (48x64 frames, a 48x48x32
grid: the smallest here whose warm-up scroll pair meets surface): one JSON
line with bench.py's keys and metric name on stdout, and triangles from
the warm-up scroll's forced emission. In process; no subprocess."""

import argparse
import ast
import json
import os
import sys

import pytest
import torch

import torch_parity  # noqa: F401  (one PyTorch thread)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import bench_torch as bt  # noqa: E402

SMALL = ["--device", "cpu", "--frames", "3", "--warmup", "2", "--height", "48", "--width", "64",
         "--grid", "48", "48", "32", "--repeats", "1"]
LINE_KEYS = {"metric", "value", "unit", "vs_baseline"}


def _reference_main():
    """From bench.py's main: (parser(), its add_argument calls on a fresh
    ArgumentParser; aw_dict(args); pipeline_dict(args, aw_dict), the dict it
    passes to build)."""
    with open(os.path.join(ROOT, "bench.py")) as fh:
        main = next(n for n in ast.parse(fh.read()).body if isinstance(n, ast.FunctionDef) and n.name == "main")
    flags = [ast.unparse(n) for n in ast.walk(main) if isinstance(n, ast.Call)
             and isinstance(n.func, ast.Attribute) and n.func.attr == "add_argument"]
    aw = next(n.value for n in ast.walk(main) if isinstance(n, ast.Assign)
              and any(getattr(t, "id", None) == "aw_dict" for t in n.targets))
    pipe = next(n for n in ast.walk(main) if isinstance(n, ast.Call) and getattr(n.func, "id", None) == "build"
                and getattr(n.args[0], "id", None) == "PipelineConfig").args[1]

    def parser():
        ap = argparse.ArgumentParser()
        for call in flags:
            eval(call, {}, {"ap": ap})
        return ap

    def aw_dict(args):
        return eval(ast.unparse(aw), {}, {"args": args})

    def pipeline_dict(args):
        return eval(ast.unparse(pipe), {}, {"args": args, "aw_dict": aw_dict(args)})

    return parser, aw_dict, pipeline_dict


REF_PARSER, REF_AW, REF_PIPELINE = _reference_main()


def _actions(ap):
    return {a.dest: (tuple(a.option_strings), a.type, a.nargs, a.default, a.const, type(a).__name__)
            for a in ap._actions if a.dest != "help"}


def test_flags_and_defaults_match_bench():
    ref, port = _actions(REF_PARSER()), _actions(bt.parser())
    assert len(ref) == 9 and "aw_only" in ref and "repeats" in ref
    device = port.pop("device")
    assert port == ref
    assert device[0] == ("--device",) and device[3] == "cuda"


@pytest.mark.parametrize("argv", [[], SMALL[2:] + ["--det-stride", "4"]], ids=["defaults", "small"])
def test_configs_match_bench(argv):
    """The active-window config and the full pipeline's config, from the
    same parsed flags."""
    args = REF_PARSER().parse_args(argv)
    assert bt.aw_config(args) == REF_AW(args)
    assert bt.pipeline_config(args) == REF_PIPELINE(args)
    assert bt.pipeline_config(args)["run_change_detection_every_n_frames"] == 50


@pytest.mark.parametrize("mode", [["--aw-only"], []], ids=["aw_only", "full_pipeline"])
def test_bench_runs_on_the_cpu(mode, monkeypatch, capsys):
    """One JSON line on stdout with bench.py's keys and metric name; the
    warm-up scroll emitted triangles."""
    results = []
    run = bt.run
    monkeypatch.setattr(bt, "run", lambda argv=None: results.append(run(argv)) or results[-1])
    assert bt.main(SMALL + mode) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert set(line) == LINE_KEYS and line["unit"] == "frames/s"
    name = "active_window" if mode else "full_pipeline"
    assert line["metric"] == f"{name}_fps_1chip_office_synthetic_48x64"
    assert line["value"] > 0 and line["vs_baseline"] == pytest.approx(line["value"] / 25.0, abs=1e-3)
    (result,) = results
    assert result["device"] == "cpu" and len(result["fps_runs"]) == 1
    assert result["warmup_triangles"][0] > 0
    # CPU tensors take the kernels' plain versions, which count no launch
    assert result["launches"] == [{"propagate": 0, "gather": 0}]


def test_bench_needs_a_gpu_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bt.run(["--frames", "1", "--warmup", "0", "--repeats", "1"])

