"""One robot of a run, in a process of its own on the card.

The parent (`runner.py`) starts one worker a robot and talks to each over
a pipe. A worker renders the loop of frames on the device, builds its
engine, warms it up and says it is ready; it waits for the common release,
feeds its robot frame after frame until the window closes (each frame goes
in when the previous call has returned), synchronises the device and
reports; then it makes any capture still due, frees the program's state,
and judges its captures against the plain reference.

Messages, worker to parent: ("ready", info), ("window", info), ("check",
info), or ("error", text) after which the worker exits. Parent to worker:
("go", times): the release, the window's end and the traced stretch.
"""

from __future__ import annotations

import importlib
import sys
import time
import traceback
from typing import Dict, List

import numpy as np
import torch

from harness.manifest import forbidden_modules


def _rng(seed: int, *salt: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([int(seed) % (1 << 64), *salt]))


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _snapshot(state) -> Dict:
    from harness import reference

    out = {f: getattr(state, f).clone() for f in reference.FIELDS}
    out["origin"] = np.asarray(state.origin.tolist(), np.int64)
    return out


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
    frame from `mesh_from` on, the first recentring from `scroll_from` on."""

    def __init__(self, index, frames, start, stamp_ns, engine, step_at, mesh_from, scroll_from):
        self.index, self.frames, self.start, self.stamp_ns, self.aw = index, frames, start, stamp_ns, engine
        self.step_at, self.mesh_from, self.scroll_from = dict(step_at), mesh_from, scroll_from
        self.count = 0
        self.samples: List[Dict] = []
        self._hook_mesh()
        self._hook_scroll()

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
        self.aw.spin_once(FrameData(stamp_ns=j * self.stamp_ns, depth=f.depth[i], color=f.color[i],
                                    labels=f.labels[i], R_w_c=f.R[i], t_w_c=f.t[i]))
        self.count += 1


def plan(seed: int, robot: int, n_robots: int, traffic: dict, frames, dynamic_labels) -> Dict:
    """Where the robot starts in the loop and what it captures, from the
    seed: every robot replays the same loop, a 1/n_robots of it apart from
    the next; its first frame is checked from an empty volume, and
    `step_checks` window frames drawn among those whose loop frame shows at
    least `motion_px` pixels of a dynamic label (any frame of the range
    where the scene shows none)."""
    L = len(frames)
    first = int(_rng(seed, 1).integers(L))
    start = (first + robot * L // n_robots) % L
    rng = _rng(seed, 2, robot)
    w = int(traffic["warmup_frames"])
    lo, hi = traffic["step_check_frames"]
    pos = np.arange(w + lo, w + hi)
    dyn = torch.tensor(list(dynamic_labels), device=frames.labels.device)
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


class Trace:
    """torch.profiler over the traced stretch, its events put on the host's
    monotonic clock (perf_counter, shared by every process) so that the
    parent can merge the robots' traces."""

    SPAN = "bench:"

    def __init__(self, device):
        from torch.profiler import ProfilerActivity, profile

        self.acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
        self.profile = profile
        self.device = device
        self.running = False
        # the profiler's first start sets up its tracing of the device, which takes seconds: pay it in set-up
        warm = profile(activities=self.acts)
        warm.start()
        torch.ones(1, device=device).add_(1)
        _sync(device)
        warm.stop()
        self.prof = profile(activities=self.acts)

    def start(self):
        _sync(self.device)
        self.prof.start()
        self.t_mark = time.perf_counter()
        with torch.profiler.record_function(self.SPAN + "mark"):
            pass
        self.t_on = time.perf_counter()
        self.running = True

    def stop(self):
        _sync(self.device)
        self.t_off = time.perf_counter()
        self.prof.stop()
        self.running = False

    def span(self, name):
        return torch.profiler.record_function(self.SPAN + name)

    def events(self) -> Dict:
        """Kernels [(start, end, name)], host operators [(start, name)] and
        the robot's calls [(start, end, name)], in perf_counter seconds,
        with the stretch the profiler ran over."""
        from torch.autograd import DeviceType

        evs = self.prof.events()
        mark = next(e.time_range.start for e in evs if e.name == self.SPAN + "mark")
        off = self.t_mark - mark * 1e-6
        dev, host, spans = [], [], []
        for e in evs:
            s, t = e.time_range.start * 1e-6 + off, e.time_range.end * 1e-6 + off
            if e.name.startswith(self.SPAN):
                if e.device_type != DeviceType.CUDA and e.name != self.SPAN + "mark":
                    spans.append((s, t, e.name[len(self.SPAN):]))
            elif e.device_type == DeviceType.CUDA:
                dev.append((s, t, e.name))
            elif not e.name.startswith("cu"):  # operators, not the runtime calls they make
                host.append((s, e.name))
        return dict(dev=dev, host=host, spans=spans, t_on=self.t_on, t_off=self.t_off)


def main(conn, spec: dict) -> None:
    """The worker's life; spec: the cell, its configuration and traffic,
    the seed, the robot's index, the device, the trace flag, and
    optionally `inject` ("module:function", called first: a planted fault)
    and `control` (judge the reference in bfloat16 too)."""
    spec["t_entry"] = time.perf_counter()
    try:
        _main(conn, spec)
    except BaseException:  # noqa: B036 - anything that stops the robot goes to the parent
        conn.send(("error", traceback.format_exc()))
        conn.close()
        sys.exit(1)


def _main(conn, spec: dict) -> None:
    t_start = time.perf_counter()
    torch.set_num_threads(int(spec.get("threads", 2)))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if spec.get("inject"):
        mod, fn = spec["inject"].split(":")
        getattr(importlib.import_module(mod), fn)()
    from harness import check, scene
    from khronos_tpu_torch.ops import gather, propagate
    from khronos_tpu_torch.utils.timing import TimingRecorder

    cfg, traffic, r = spec["cfg"], spec["traffic"], int(spec["robot"])
    device = torch.device(spec["device"])
    card = None
    if device.type == "cuda":
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n < int(spec["chips"]):
            raise RuntimeError(f"need {spec['chips']} CUDA device(s); torch sees {n}")
        torch.cuda.set_device(device)
        card = torch.cuda.get_device_name(device)
    hz = float(traffic["stamp_hz"])
    t_a = time.perf_counter()
    frames = scene.render_loop(cfg["scene"], cfg["sensor"], hz, device)
    p = plan(spec["seed"], r, int(traffic["robots"]), traffic, frames, cfg["label_space"]["dynamic_labels"])
    _sync(device)
    t_b = time.perf_counter()
    robot = Robot(r, frames, p["start"], int(round(1e9 / hz)), build_engine(cfg, device), p["step_at"],
                  p["mesh_from"], p["scroll_from"])
    for _ in range(int(traffic["warmup_frames"])):
        robot.step()
    warmup_scroll(robot.aw)
    _sync(device)
    tracer = Trace(device) if spec["trace"] else None
    t_c = time.perf_counter()
    TimingRecorder.instance().reset()
    launches0 = propagate.launches, gather.launches
    conn.send(("ready", dict(start=p["start"], imports_s=t_a - t_start, render_s=t_b - t_a, warmup_s=t_c - t_b,
                             frames=len(frames), t_entry=spec["t_entry"], t_ready=time.perf_counter(), card=card)))

    # ---------------- the measured window
    msg = conn.recv()
    if msg[0] != "go":
        return
    go = msg[1]
    latencies: List[float] = []
    failed, error = 0, None
    while time.perf_counter() < go["t0"]:
        pass
    while True:
        now = time.perf_counter()
        if now >= go["deadline"]:
            break
        if tracer is not None:
            if not tracer.running and go["trace_on"] <= now < go["trace_off"]:
                tracer.start()
            elif tracer.running and now >= go["trace_off"]:
                tracer.stop()
                TimingRecorder.instance().reset()  # the spans leave out the profiled stretch
        try:
            a = time.perf_counter()
            if tracer is not None and tracer.running:
                with tracer.span(f"robot{r}"):
                    robot.step()
            else:
                robot.step()
            latencies.append(time.perf_counter() - a)
        except Exception:  # the robot stops; the run is not correct
            failed, error = 1, traceback.format_exc()
            break
    if tracer is not None and tracer.running:
        tracer.stop()
    _sync(device)
    t_end = time.perf_counter()
    launches = propagate.launches - launches0[0], gather.launches - launches0[1]
    spans = TimingRecorder.instance().stats()
    trace = tracer.events() if tracer is not None else None
    conn.send(("window", dict(latencies=latencies, t_end=t_end, failed=failed, error=error, spans=spans,
                              launches=launches, trace=trace, sent=robot.count)))

    # ---------------- captures still due, then the check
    t_late = time.perf_counter()
    while not failed and robot.due and time.perf_counter() < t_late + 60:
        robot.step()
    _sync(device)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    samples = robot.samples
    robot.aw = None
    del robot
    if device.type == "cuda":
        torch.cuda.empty_cache()
    with torch.no_grad():
        rows = check.judge(samples, cfg)
        control = check.judge(samples, cfg, dtype=torch.bfloat16) if spec.get("control") else None
    conn.send(("check", dict(rows=rows, control=control, peak=int(peak), late_s=time.perf_counter() - t_late,
                             bad_modules=forbidden_modules(sys.modules))))
    conn.close()
