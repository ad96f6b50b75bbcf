"""The driver of a configuration whose robots run the active window alone:
each robot is an `ActiveWindow` fed frame after frame through `spin_once`.

A driver is what one kind of deployment runs and checks; the configuration
names it (`"driver": "window"`) and the harness loads this file by path
(`harness/manifest.py`). What a driver defines:

- `LIMITS`, `MINIMUMS`: the names of the check's numbers that a
  configuration's `check_limits` may bound from above and its
  `check_minimums` from below;
- `frames(cfg, traffic, device)`: the loop of frames a robot replays;
- `plan(seed, robot, n_robots, cfg, traffic, frames)`: where the robot
  starts in the loop and what it captures, drawn from the seed;
- `build_engine(cfg, device)`: the engine a robot runs;
- `Robot(index, frames, plan, cfg, traffic, device)`: the robot's engine
  and its captures, with `warm_up()`, `step()` (the next frame, returning
  when the call has), `count` (frames sent), `due` (a capture is still to
  be made) and `release()` (drops the engine, returns the captures);
- `captures(traffic)`: the captures a robot owes;
- `judge(samples, cfg, dtype)`: one row of numbers a capture, against the
  plain reference (`dtype` float32), or the reference in a lower precision
  judged in the program's place (the control);
- `worst(rows)`: every name of `LIMITS` and `MINIMUMS` over a run's rows.

Only this driver has `WORKER_NAMES`: the names `harness/worker.py` gave the
window's robot and warm-up before drivers (scripts that drive one robot
by hand still take them from there).

The harness's parent process loads the driver too (for `captures`, `worst`
and the names), and it loads no torch: this file imports torch and the
program only inside what the workers call.

Here the window's frames are the configuration's scene rendered on the card
(`harness/scene.py`), the captures and their judge are `harness/check.py`'s
against `harness/reference.py`.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

LIMITS = ("volume_mismatch", "id_mismatch", "cluster_mismatch", "mesh_mismatch", "scroll_mismatch")
MINIMUMS = ("frames_with_motion", "mesh_triangles")


def _rng(seed: int, *salt: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([int(seed) % (1 << 64), *salt]))


def _snapshot(state) -> Dict:
    from harness import reference

    out = {f: getattr(state, f).clone() for f in reference.FIELDS}
    out["origin"] = np.asarray(state.origin.tolist(), np.int64)
    return out


def frames(cfg: dict, traffic: dict, device):
    """Every frame of one loop of the configuration's scene, at the
    traffic's stamp rate, rendered on `device`."""
    from harness import scene

    return scene.render_loop(cfg["scene"], cfg["sensor"], float(traffic["stamp_hz"]), device)


def build_engine(cfg: dict, device):
    """The configuration's ActiveWindow."""
    from khronos_tpu_torch.active_window.active_window import ActiveWindow, ActiveWindowConfig
    from khronos_tpu_torch.active_window.object_detection import LabelSpace
    from khronos_tpu_torch.config import build
    from khronos_tpu_torch.geometry.camera import Camera

    sn, ls = cfg["sensor"], cfg["label_space"]
    camera = Camera(sn["height"], sn["width"], sn["fx"], sn["fy"], sn["cx"], sn["cy"], sn["min_range"],
                    sn["max_range"])
    label_space = LabelSpace(num_classes=ls["num_classes"], object_labels=tuple(ls["object_labels"]),
                             dynamic_labels=tuple(ls["dynamic_labels"]))
    return ActiveWindow(build(ActiveWindowConfig, cfg["active_window"]), camera, label_space, device=device)


def warmup_scroll(aw) -> None:
    """Scroll the volume by +1 and then -1 voxel along x, emitting the mesh
    of the cells each scroll drops: the first camera-driven scroll's work,
    done in set-up (bench_torch.py's warm-up scroll)."""
    from khronos_tpu_torch.map import active_volume as av
    from khronos_tpu_torch.map import meshing

    vol_cfg = aw.config.volumetric_map
    for shift in (np.array([1, 0, 0], np.int32), np.array([-1, 0, 0], np.int32)):
        out_mask = av.scroll_out_mask(aw.state, shift)
        aw._emit_mesh(meshing.forced_emission_mask(aw.state, out_mask))
        aw.state = av.scroll(vol_cfg, aw.state, shift)
        aw._origin_np = aw._origin_np + shift
    aw.synchronize()


class Robot:
    """The robot's engine, its replay of the loop and what it captures for
    the check: the fused step at chosen frames (`step_at`: frame -> whether
    the volume before it is wanted), the first emission round of an output
    frame from `mesh_from` on, the first recentring from `scroll_from` on.

    A driver whose engine holds an active window elsewhere (a pipeline)
    can take these captures over: it overrides `build` (returns the
    window) and `feed` (sends one frame)."""

    def __init__(self, index: int, frames, plan: Dict, cfg: dict, traffic: dict, device):
        self.index, self.frames, self.start, self.traffic = index, frames, plan["start"], traffic
        self.stamp_ns = int(round(1e9 / float(traffic["stamp_hz"])))
        self.aw = self.build(cfg, device)
        self.step_at, self.mesh_from, self.scroll_from = dict(plan["step_at"]), plan["mesh_from"], plan["scroll_from"]
        self.count = 0
        self.samples: List[Dict] = []
        self._hook_mesh()
        self._hook_scroll()

    def build(self, cfg: dict, device):
        """The engine; returns the active window the captures hook."""
        return build_engine(cfg, device)

    def feed(self, frame) -> None:
        """One frame through the engine's call."""
        self.aw.spin_once(frame)

    # -- captures
    def _hook_mesh(self):
        aw, grid = self.aw, self.aw.grid
        orig_out, orig_mesh = aw._extract_output, grid.extract_mesh_async
        armed = {"on": False}

        def extract_output(frame):
            armed["on"] = self.mesh_from is not None and self.count >= self.mesh_from
            try:
                return orig_out(frame)
            finally:
                armed["on"] = False

        def extract_mesh_async(state, mask, vol_cfg, max_cells):
            if not armed["on"]:
                return orig_mesh(state, mask, vol_cfg, max_cells)
            pre = _snapshot(state)
            new_state, packed, meta = orig_mesh(state, mask, vol_cfg, max_cells)
            self.samples.append(dict(kind="mesh", robot=self.index, frame=self.count, pre=pre, packed=packed.clone(),
                                     meta=meta.clone(), meshed=new_state.cell_meshed.clone()))
            self.mesh_from = None
            armed["on"] = False
            return new_state, packed, meta

        aw._extract_output, grid.extract_mesh_async = extract_output, extract_mesh_async

    def _hook_scroll(self):
        aw, grid = self.aw, self.aw.grid
        orig = grid.scroll

        def scroll(vol_cfg, state, shift):
            out = orig(vol_cfg, state, shift)
            if self.scroll_from is not None and self.count >= self.scroll_from:
                i = (self.start + self.count) % len(self.frames)
                self.samples.append(dict(kind="scroll", robot=self.index, frame=self.count, pre=_snapshot(state),
                                         post=_snapshot(out), shift=np.asarray(shift, np.int64),
                                         cam=np.asarray(self.frames.t[i], np.float64)))
                self.scroll_from = None
            return out

        grid.scroll = scroll

    def _hook_step(self, i: int, want_pre: bool):
        aw = self.aw
        orig = aw._fused_step
        f = self.frames
        j = self.count

        def step(state, depth, color, labels, R, t, t_now):
            pre = _snapshot(state) if want_pre else None
            out = orig(state, depth, color, labels, R, t, t_now)
            post = _snapshot(out[0])
            post["dynamic_image"], post["object_image"], post["packed"] = (x.clone() for x in out[1:4])
            self.samples.append(dict(kind="step", robot=self.index, frame=j, pre=pre, post=post, depth=f.depth[i],
                                     color=f.color[i], labels=f.labels[i], R=f.R[i], t=f.t[i],
                                     t_now=j * self.stamp_ns * 1e-9))
            aw._fused_step = orig
            return out

        aw._fused_step = step

    @property
    def due(self) -> bool:
        """A capture is still to be made."""
        return (any(j >= self.count for j in self.step_at) or self.mesh_from is not None
                or self.scroll_from is not None)

    def step(self) -> None:
        """Send the robot's next frame and wait for the call to return."""
        from khronos_tpu_torch.active_window.frame_data import FrameData

        j = self.count
        i = (self.start + j) % len(self.frames)
        f = self.frames
        if j in self.step_at:
            self._hook_step(i, self.step_at[j])
        self.feed(FrameData(stamp_ns=j * self.stamp_ns, depth=f.depth[i], color=f.color[i], labels=f.labels[i],
                            R_w_c=f.R[i], t_w_c=f.t[i]))
        self.count += 1

    def warm_up(self) -> None:
        """The traffic's warm-up frames, then the warm-up scroll."""
        for _ in range(int(self.traffic["warmup_frames"])):
            self.step()
        warmup_scroll(self.aw)

    def release(self) -> List[Dict]:
        """Drop the engine, so that the reference finds the card's memory
        free; the captures."""
        self.aw = None
        return self.samples


class GivenEngine(Robot):
    """A Robot in the form `harness/worker.Robot` had before drivers: an
    engine built by the caller, frames `stamp_ns` apart, the plan's parts
    one by one."""

    def __init__(self, index, frames, start, stamp_ns, engine, step_at, mesh_from, scroll_from):
        self.engine = engine
        plan = dict(start=start, step_at=step_at, mesh_from=mesh_from, scroll_from=scroll_from)
        super().__init__(index, frames, plan, None, dict(stamp_hz=1e9 / stamp_ns), None)
        self.stamp_ns = stamp_ns

    def build(self, cfg: dict, device):
        return self.engine


def plan(seed: int, robot: int, n_robots: int, cfg: dict, traffic: dict, frames) -> Dict:
    """Where the robot starts in the loop and what it captures, from the
    seed: every robot replays the same loop, a 1/n_robots of it apart from
    the next; its first frame is checked from an empty volume, and
    `step_checks` window frames drawn among those whose loop frame shows at
    least `motion_px` pixels of a dynamic label (any frame of the range
    where the scene shows none)."""
    import torch

    L = len(frames)
    first = int(_rng(seed, 1).integers(L))
    start = (first + robot * L // n_robots) % L
    rng = _rng(seed, 2, robot)
    w = int(traffic["warmup_frames"])
    lo, hi = traffic["step_check_frames"]
    pos = np.arange(w + lo, w + hi)
    dyn = torch.tensor(list(cfg["label_space"]["dynamic_labels"]), device=frames.labels.device)
    px = torch.stack([torch.isin(frames.labels[(start + j) % L], dyn).sum() for j in pos]).cpu().numpy()
    cand = pos[px >= int(traffic["motion_px"])]
    if len(cand) < int(traffic["step_checks"]):
        cand = pos
    steps = {0: False}
    steps.update({int(j): True for j in rng.choice(cand, size=int(traffic["step_checks"]), replace=False)})
    mlo, mhi = traffic["mesh_check_frames"]
    slo, shi = traffic["scroll_check_frames"]
    return dict(start=start, step_at=steps, mesh_from=w + int(rng.integers(mlo, mhi)),
                scroll_from=w + int(rng.integers(slo, shi)))


def captures(traffic: dict) -> int:
    """A robot's first frame, its window frames, a mesh round, a scroll."""
    return 1 + int(traffic["step_checks"]) + 2


def judge(samples: List[Dict], cfg: dict, dtype) -> List[Dict]:
    """`harness/check.py`'s judge of the window's captures."""
    from harness import check

    return check.judge(samples, cfg, dtype=dtype)


def worst(rows: List[Dict]) -> Dict[str, float]:
    """The check's numbers over the captures' rows: each mismatch at its
    worst, and the coverage counts."""
    out = {k: max((r[k] for r in rows if k in r), default=0.0) for k in LIMITS}
    out["frames_with_motion"] = sum(1 for r in rows if r.get("dynamic_px", 0) > 0)
    out["mesh_triangles"] = sum(r.get("mesh_triangles", 0) for r in rows)
    return out


# what `harness/worker.py` defined for the window before drivers, in that form
WORKER_NAMES = {"Robot": GivenEngine, "warmup_scroll": warmup_scroll}
