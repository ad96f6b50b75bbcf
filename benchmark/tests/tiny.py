"""A cell cut to a size the CPU runs in seconds, for the rehearsals."""

import copy
import time

from harness import manifest, runner


def shrink(cfg: dict, traffic: dict):
    cfg = copy.deepcopy(cfg)
    cfg["sensor"].update(height=48, width=64, fx=40.0, fy=40.0, cx=32.0, cy=24.0)
    cfg["scene"]["seconds"] = 4.0
    cfg["active_window"]["volumetric_map"].update(grid_shape=[24, 24, 16], voxel_size=0.4, truncation_distance=0.8,
                                                  recenter_margin=1.2, temporal_window=0.4, temporal_buffer=0.1)
    cfg["active_window"]["motion_detector"]["min_cluster_size"] = 8
    cfg["active_window"]["object_detector"]["min_cluster_size"] = 4
    traffic = dict(traffic, robots=2, warmup_frames=3, step_check_frames=[2, 8], motion_px=20,
                   mesh_check_frames=[8, 12], scroll_check_frames=[0, 4], trace_after_s=0.3, trace_seconds=0.6,
                   threads=1)
    # at this size a walking human is a voxel or two across and grows no motion region
    cfg["check_minimums"].pop("frames_with_motion", None)
    return cfg, traffic


def run_tiny(name: str, trace: bool = False, seed: int = 2**31 + 5, seconds: float = 1.5, root=manifest.ROOT,
             bench_dir=manifest.HERE, **kw):
    """runner.run of cell `name` at the tiny size on the CPU, two robots."""
    bench = manifest.load(root)
    cell = manifest.cell(bench, name)
    cfg, traffic = shrink(manifest.config(bench, cell["config"], root), manifest.traffic(cell["traffic"], bench_dir))
    names = manifest.metric_names(bench, name, trace)
    readers = {n: manifest.reader(n, bench_dir) for n in names if n not in manifest.BUILT_IN}
    return runner.run(cell, cfg, traffic, seed, seconds, trace, "cpu", time.perf_counter(), names, readers,
                      cfg["check_limits"], cfg["check_minimums"], bench_dir=bench_dir, **kw), cfg
