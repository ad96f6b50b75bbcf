"""The check fails what it has to: the control (the reference in bfloat16
in the program's place), and runs whose timed path is broken underneath
(`faults.py`): a step that returns its state unchanged, half of each frame
left out, an answer altered where it is produced (the id images, the
statistics handed to the tracker, the emitted mesh), a recentring that
moves the voxels the wrong way."""

import pytest

from harness import manifest
from tiny import run_tiny


def test_the_control_fails_the_check():
    res, cfg = run_tiny("office.window.r4", control=True)
    assert res.correct, res.check
    control = manifest.driver(manifest.driver_path(cfg)).worst(res.control_rows)
    assert any(control[k] > v for k, v in cfg["check_limits"].items()), control


@pytest.mark.parametrize("fault,number", [
    ("state_unchanged", "volume_mismatch"),
    ("half_frame", "volume_mismatch"),
    ("ids_altered", "id_mismatch"),
    ("stats_altered", "cluster_mismatch"),
    ("mesh_shifted", "mesh_mismatch"),
    ("scroll_reversed", "scroll_mismatch"),
])
def test_a_broken_timed_path_fails_the_check(fault, number):
    res, _ = run_tiny("office.window.r4", inject=f"faults:{fault}")
    assert not res.correct
    assert res.check[number]["value"] > res.check[number]["limit"], res.check
