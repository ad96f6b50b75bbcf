"""A probe driver, kept for `test_bench_driver_seam.py`, which copies it
into a copy of the benchmark as drivers/probe_pipeline.py: no cell of the
benchmark names it.

Each robot runs the whole `KhronosPipeline` of its configuration (the
window, the backend and, where the configuration's "pipeline" group turns
them on, change detection and places), fed through `process_frame`. The
window's captures are hooked onto the pipeline's `active_window` and judged
by the window's judge. Besides, a capture of the probe's own kind,
"backend", at a frame drawn from the seed: the outputs the backend has
taken by then, held to the probe's own check number `backend_outputs`.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List

from harness import manifest

window = manifest.driver(Path(__file__).with_name("window.py"))

LIMITS = window.LIMITS
MINIMUMS = window.MINIMUMS + ("backend_outputs",)
frames = window.frames


def plan(seed: int, robot: int, n_robots: int, cfg: dict, traffic: dict, frames) -> Dict:
    """The window's plan, and the frame of the backend's capture."""
    lo, hi = traffic["backend_check_frames"]
    at = int(traffic["warmup_frames"]) + int(window._rng(seed, 3, robot).integers(lo, hi))
    return dict(window.plan(seed, robot, n_robots, cfg, traffic, frames), backend_at=at)


def build_engine(cfg: dict, device):
    """The configuration's KhronosPipeline: its "pipeline" group over the
    window's configuration."""
    from khronos_tpu_torch.config import build
    from khronos_tpu_torch.geometry.camera import Camera
    from khronos_tpu_torch.pipeline.pipeline import KhronosPipeline, PipelineConfig

    sn = cfg["sensor"]
    camera = Camera(sn["height"], sn["width"], sn["fx"], sn["fy"], sn["cx"], sn["cy"], sn["min_range"],
                    sn["max_range"])
    config = build(PipelineConfig, dict(cfg["pipeline"], active_window=cfg["active_window"],
                                        label_space=cfg["label_space"]))
    return KhronosPipeline(config, camera, device=device)


class Robot(window.Robot):
    def __init__(self, index: int, frames, plan: Dict, cfg: dict, traffic: dict, device):
        self.backend_at = plan["backend_at"]
        super().__init__(index, frames, plan, cfg, traffic, device)

    def build(self, cfg: dict, device):
        self.pipeline = build_engine(cfg, device)
        return self.pipeline.active_window

    def feed(self, frame) -> None:
        self.pipeline.process_frame(frame)
        if self.backend_at is not None and self.count >= self.backend_at:
            self.samples.append(dict(kind="backend", robot=self.index, frame=self.count,
                                     outputs=len(self.pipeline.backend.agents)))
            self.backend_at = None

    @property
    def due(self) -> bool:
        return super().due or self.backend_at is not None

    def release(self) -> List[Dict]:
        self.pipeline = None
        return super().release()


def captures(traffic: dict) -> int:
    """The window's captures and the backend's."""
    return window.captures(traffic) + 1


def judge(samples: List[Dict], cfg: dict, dtype) -> List[Dict]:
    rows = window.judge([s for s in samples if s["kind"] != "backend"], cfg, dtype)
    return rows + [dict(kind="backend", robot=s["robot"], frame=s["frame"], backend_outputs=s["outputs"])
                   for s in samples if s["kind"] == "backend"]


def worst(rows: List[Dict]) -> Dict[str, float]:
    out = window.worst(rows)
    out["backend_outputs"] = min((r["backend_outputs"] for r in rows if r["kind"] == "backend"), default=0)
    return out
