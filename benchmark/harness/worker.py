"""One robot of a run, in a process of its own on the card.

The parent (`runner.py`) starts one worker a robot and talks to each over
a pipe. A worker loads its configuration's driver (`drivers/<driver>.py`),
which makes the loop of frames on the device, plans the robot's captures
from the seed, builds its engine and warms it up; then the worker says it
is ready. It waits for the common release, steps its robot frame after
frame until the window closes (each frame goes in when the previous call
has returned), synchronises the device and reports; then it steps on while
a capture is still due, frees the program's state, and has the driver
judge the captures against the plain reference.

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

import torch

from harness.manifest import HERE, driver, driver_path, forbidden_modules


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build_engine(cfg: dict, device):
    """The configuration's engine, built by its driver, for code that drives
    it outside a run."""
    return driver(driver_path(cfg)).build_engine(cfg, device)


def __getattr__(name: str):
    """The names this module gave the window's robot and warm-up before
    drivers, in their old form, for scripts that drive one robot by hand:
    the window driver's `WORKER_NAMES`."""
    names = {} if name.startswith("_") else driver(HERE / "drivers" / "window.py").WORKER_NAMES
    if name not in names:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return names[name]


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
    """The worker's life; spec: the cell, its configuration, the path of
    its driver and its traffic, the seed, the robot's index, the device,
    the trace flag, and optionally `inject` ("module:function", called
    first: a planted fault) and `control` (judge the reference in bfloat16
    too)."""
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
    from khronos_tpu_torch.ops import gather, propagate
    from khronos_tpu_torch.utils.timing import TimingRecorder

    drv = driver(spec["driver"])
    cfg, traffic, r = spec["cfg"], spec["traffic"], int(spec["robot"])
    device = torch.device(spec["device"])
    card = None
    if device.type == "cuda":
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n < int(spec["chips"]):
            raise RuntimeError(f"need {spec['chips']} CUDA device(s); torch sees {n}")
        torch.cuda.set_device(device)
        card = torch.cuda.get_device_name(device)
    t_a = time.perf_counter()
    frames = drv.frames(cfg, traffic, device)
    p = drv.plan(spec["seed"], r, int(traffic["robots"]), cfg, traffic, frames)
    _sync(device)
    t_b = time.perf_counter()
    robot = drv.Robot(r, frames, p, cfg, traffic, device)
    robot.warm_up()
    _sync(device)
    tracer = Trace(device) if spec["trace"] else None
    t_c = time.perf_counter()
    TimingRecorder.instance().reset()
    launches0 = propagate.launches, gather.launches
    conn.send(("ready", dict(imports_s=t_a - t_start, render_s=t_b - t_a, warmup_s=t_c - t_b,
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
    rec = TimingRecorder.instance()
    spans = [dict(row, seconds=[x[1] for x in rec.series(row["name"])]) for row in rec.stats()]
    trace = tracer.events() if tracer is not None else None
    conn.send(("window", dict(latencies=latencies, t_end=t_end, failed=failed, error=error, spans=spans,
                              launches=launches, trace=trace, sent=robot.count)))

    # ---------------- captures still due, then the check
    t_late = time.perf_counter()
    while not failed and robot.due and time.perf_counter() < t_late + 60:
        robot.step()
    _sync(device)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    samples = robot.release()
    del robot
    if device.type == "cuda":
        torch.cuda.empty_cache()
    with torch.no_grad():
        rows = drv.judge(samples, cfg, torch.float32)
        control = drv.judge(samples, cfg, torch.bfloat16) if spec.get("control") else None
    conn.send(("check", dict(rows=rows, control=control, peak=int(peak), late_s=time.perf_counter() - t_late,
                             bad_modules=forbidden_modules(sys.modules))))
    conn.close()
