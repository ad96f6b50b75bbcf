"""BENCHMARK.json against the rules the harness and its checker rely on."""

import json
import re

import pytest

from harness import manifest

BENCH = manifest.load()
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_names_and_units_use_the_allowed_characters():
    names = [m["name"] for m in METRICS] + CELLS + [c["name"] for c in BENCH["configs"]]
    names += [w["traffic"] for w in BENCH["workloads"]] + [w["config"] for w in BENCH["workloads"]]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    for n in names:
        assert manifest.NAME.match(n), n
    for m in METRICS:
        assert manifest.UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    assert len(set(m["name"] for m in METRICS)) == len(METRICS)
    assert len(set(CELLS)) == len(CELLS)


def test_every_per_layer_metric_moves_a_metric_its_cells_report():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", CELLS):
            assert cell in CELLS
            assert manifest.applies(moved, cell), (m["name"], cell)


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    for cell in CELLS:
        e2e = manifest.metric_names(BENCH, cell, trace=False)
        assert "setup_s" in e2e and len(e2e) >= 2, cell
        assert manifest.metric_names(BENCH, cell, trace=True), cell


def test_every_configuration_has_a_cell_and_its_files():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        cfg = manifest.config(BENCH, c["name"])
        assert cfg["name"] == c["name"] and cfg["source"]
        for key in c["reduced"]:
            assert key in cfg and key in cfg["assumed"], key
        path = manifest.driver_path(cfg)
        assert path.is_file()
        drv = manifest.driver(path)
        assert set(cfg["check_limits"]) <= set(drv.LIMITS)
        assert set(cfg["check_minimums"]) <= set(drv.MINIMUMS)
    for w in BENCH["workloads"]:
        assert manifest.traffic(w["traffic"])["robots"] >= 1
        assert w["chips"] == 1


@pytest.mark.parametrize("driver", [None, "nosuch", "../harness/runner"])
def test_a_configuration_without_a_known_driver_is_refused(driver):
    cfg = {"name": "c"} if driver is None else {"name": "c", "driver": driver}
    with pytest.raises(ValueError, match=r"drivers/"):
        manifest.driver_path(cfg)


@pytest.mark.parametrize("name", [m["name"] for m in BENCH["per_layer"]])
def test_every_per_layer_metric_has_a_reader(name):
    assert callable(manifest.reader(name).read)


def test_bounds_and_run_length():
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    # no more than eight times the widest spread of frames_per_s's runs on the H100 (PERF.md, section 2)
    assert next(m for m in BENCH["end_to_end"] if m["name"] == "frames_per_s")["bound"] <= 0.083
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024
    for w in BENCH["workloads"]:
        assert len(w["why"]) <= 200 and not re.search(r"[\t\n]", w["why"])
