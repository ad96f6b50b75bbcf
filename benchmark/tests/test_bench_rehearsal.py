"""Each cell's code path end to end on the CPU at a tiny size: set-up,
the window, the trace's reduction, the metric readers, the check."""

import pytest

from harness import manifest
from tiny import run_tiny

CELLS = [w["name"] for w in manifest.load()["workloads"]]


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("name", CELLS)
def test_cell_rehearses_on_the_cpu(name, trace):
    res, _ = run_tiny(name, trace=trace)
    assert res.correct, res.check
    assert res.failed == 0 and res.attempted > 0
    names = manifest.metric_names(manifest.load(), name, trace)
    if not trace:
        assert set(res.metrics) == set(names)
    else:
        # the device readings need a card; the program's spans do not
        assert any(k.endswith("_ms") or "host_ms" in k for k in res.metrics), res.metrics
        assert res.device["window_s"] > 0
    assert res.check["frames_checked"]["value"] == res.check["frames_checked"]["limit"]
