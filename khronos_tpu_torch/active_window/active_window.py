"""ActiveWindow orchestrator: the per-frame hot path (L1).

Port of `khronos_tpu/active_window/active_window.py` (khronos::ActiveWindow,
active_window.cpp:118-174 spinOnce): detect + integrate -> track -> buffer
frames -> (every min_output_separation) mesh the archived surface -> extract
objects from finished tracks -> push ActiveWindowOutput. finish_mapping()
deactivates everything and flushes (cpp:176-189).

All grid work runs on the device: by default in one fused step per frame
(`fused_step`), else stage by stage (the modular path: `fused=False`, or an
open-set detector whose `max_instances` exceeds the fused cap `MC`). Host
code orchestrates, tracks and accumulates outputs.

The small results the host needs ride the reference's "bus": each frame's
packed tracker stats wait in the window, and every `stats_batch_frames`
frames (or when emission metas wait and no stats do) ONE buffer carries the
batch and up to `BUS_META_CAPACITY` pending mesh-emission metas in one
non-blocking copy into pinned memory with a CUDA event behind it
(`utils/host_copy.py`). The tracker runs over a whole batch, and the metas
start their body pulls, only when that copy has landed, oldest bus first; so
in which output a finished track or a mesh delta lands follows the
reference's schedule. On the CPU every copy is ready at once: the port then
follows the reference's earliest schedule, and with `earliest_pulls` set it
does so on the card too (each pull waited for at its first poll), so that
runs compare bit for bit. `max_inflight_pulls` bounds the
buses and emission rounds in flight before the oldest is consumed waiting.

Object extraction runs inline when an output is built, unless
`defer_object_extraction` is set: then the output carries the finished
tracks on `pending_tracks` and a later `finalize_output` extracts them (the
reference's backend-thread extraction); `_inflight_tracks` keeps their frames
in the frame buffer until then. `finish_mapping` always extracts inline.

With `n_devices >= 1` the voxel grid is split into slabs along x over a
device mesh, one slab a visible card as the reference's `devices[:n]`
(`parallel/sharding.py`): the fused step runs on every slab with
halo exchange (cropping off), and the scroll and the mesh emission run per
slab too; the modular path gathers the grid onto the first device for its
stages. `n_devices=1` is the one-shard mesh. With a `group`
(`parallel/distributed.py`) the window is one rank of several processes,
the reference's window over a global mesh: every rank runs the window on
the same frames, with the host state, the pixel side and the pulls on its
own device, and computes its own slabs only.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import List, Optional

import numpy as np
import torch

from khronos_tpu_torch import resolve_device
from khronos_tpu_torch.config import Plugin, plugin_field
from khronos_tpu_torch.geometry.camera import Camera
from khronos_tpu_torch.map import active_volume as av
from khronos_tpu_torch.map import meshing
from khronos_tpu_torch.parallel import sharding
from khronos_tpu_torch.stm.scene_graph import KhronosObject
from khronos_tpu_torch.utils.host_copy import HostCopy
from khronos_tpu_torch.utils.logging import clog
from khronos_tpu_torch.utils.timing import Timer
from khronos_tpu_torch.active_window import fused_step as fs
from khronos_tpu_torch.active_window.frame_data import (
    FrameData,
    FrameDataBuffer,
    FrameDataBufferConfig,
)
from khronos_tpu_torch.active_window.object_detection import LabelSpace

# register plugins
from khronos_tpu_torch.active_window import motion_detection as _md  # noqa: F401
from khronos_tpu_torch.active_window import object_detection as _od  # noqa: F401
from khronos_tpu_torch.active_window import instance_forwarding as _if  # noqa: F401
from khronos_tpu_torch.active_window import tracking as _tk  # noqa: F401
from khronos_tpu_torch.active_window import object_extraction as _oe  # noqa: F401


@dataclasses.dataclass
class ActiveWindowConfig:
    min_output_separation: float = 0.4  # s (uHumans2.yaml:38)
    # fused mode: the whole per-frame hot path as one step (fused_step.py);
    # the modular path keeps each stage separately inspectable
    fused: bool = True
    # run detection (motion/object clustering) on an s-strided image; TSDF
    # integration stays full-res. Must divide height and width.
    detection_stride: int = 1
    # host-pull batching (fused mode): per-frame packed tracker stats and
    # emission metas ride ONE shared buffer (the "bus") flushed every
    # `stats_batch_frames` frames; the tracker lags by up to that many
    # frames (the device-side dynamic-integration mask is unaffected)
    stats_batch_frames: int = 4
    # max in-flight host pulls (stats buses / emission rounds) before the
    # oldest is consumed blocking
    max_inflight_pulls: int = 4
    # scroll emission: fraction of the scroll-out slab assumed to hold
    # UNMESHED surface cells when sizing the sync-free emission rounds (see
    # _emit_mesh rounds=...). 0 falls back to the blocking drain.
    scroll_surface_fraction: float = 0.02
    volumetric_map: av.VolumeConfig = dataclasses.field(default_factory=av.VolumeConfig)
    frame_data_buffer: FrameDataBufferConfig = dataclasses.field(
        default_factory=FrameDataBufferConfig
    )
    motion_detector: Plugin = plugin_field("motion_detector", "FreeSpaceMotionDetector")
    object_detector: Plugin = plugin_field("object_detector", "ConnectedSemantics")
    tracker: Plugin = plugin_field("tracker", "MaxIouTracker")
    object_extractor: Plugin = plugin_field("object_extractor", "MeshObjectExtractor")
    mesh_max_cells: int = 8192
    # device-mesh mode: the voxel grid split into n_devices slabs along x
    # (parallel/sharding.py), one per shard, one shard a visible card
    # (round-robin when fewer are visible). 0 = the plain single-device path
    # (with frustum cropping); 1 = a one-shard mesh (the mesh code path
    # without fan-out). Needs grid_shape[0] % n_devices == 0; cropping is off
    # under sharding (a camera-dependent crop does not fit a static slab
    # layout).
    n_devices: int = 0


@dataclasses.dataclass
class ActiveWindowOutput:
    """Map delta pushed downstream (ActiveWindowOutput equivalent)."""

    stamp_ns: int
    R_w_b: np.ndarray
    t_w_b: np.ndarray
    # newly archived background surface (triangle soup with stamps)
    mesh_vertices: np.ndarray  # [T, 3, 3]
    mesh_colors: np.ndarray
    mesh_first_ns: np.ndarray  # [T, 3] int64
    mesh_last_ns: np.ndarray
    mesh_labels: np.ndarray
    # objects extracted from tracks that left the window
    objects: List[KhronosObject] = dataclasses.field(default_factory=list)
    # deferred extraction (defer_object_extraction): finished tracks whose
    # object extraction finalize_output runs
    pending_tracks: Optional[List] = None


BUS_META_CAPACITY = 8  # emission metas per bus flush (overflow rides the next)
META_LEN = 9  # floats in an emission round's meta


def _empty_mesh_delta():
    return dict(
        mesh_vertices=np.zeros((0, 3, 3), np.float32),
        mesh_colors=np.zeros((0, 3, 3), np.float32),
        mesh_first_ns=np.zeros((0, 3), np.int64),
        mesh_last_ns=np.zeros((0, 3), np.int64),
        mesh_labels=np.zeros((0, 3), np.int32),
    )


class ActiveWindow:
    group = None  # the ranks' group (parallel/distributed.py); None: one process
    # every host pull waits for itself the first time it is polled
    # (utils/host_copy.py): outputs then do not depend on the card's timing
    earliest_pulls = False

    def __init__(
        self, config: ActiveWindowConfig, camera: Camera, label_space: LabelSpace, device=None, group=None
    ):
        """device: where the volume and every frame's work live; CUDA unless
        the caller passes device="cpu" (raises when no GPU is visible). With
        n_devices >= 1 the slabs go one a card over the visible cards from
        that one on (`sharding.mesh_for`; "cuda": the current card), and the
        pixel side stays on the first. group (`parallel.distributed`): this
        window is one of the group's ranks, n_devices slabs over all of them
        (process-major), the pixel side on this rank's device."""
        self.device = resolve_device(device)
        self.group = group
        self.config = config
        self.camera = camera
        self.label_space = label_space
        vol_cfg = config.volumetric_map
        self._build_grid()
        self.state = self.grid.place(av.create(vol_cfg, device=self.device))
        self._origin_np = self.state.origin.numpy().copy()
        self._initialized_origin = False
        self.motion_detector = config.motion_detector.create(vol_cfg, camera)
        self.object_detector = config.object_detector.create(vol_cfg, camera, label_space)
        self.tracker = config.tracker.create()
        if hasattr(self.tracker, "set_camera"):
            self.tracker.set_camera(camera)
        self.object_extractor = config.object_extractor.create(camera, device=self.device)
        self.frame_buffer = FrameDataBuffer(config.frame_data_buffer)
        self._last_output_s: float = -np.inf
        # time base: device work consumes float32 seconds RELATIVE to the
        # first frame's stamp; host int64 ns stamps stay absolute
        self._t0_ns: Optional[int] = None
        self._pending_mesh: List[dict] = []  # unpacked mesh deltas
        # emission rounds in flight, FIFO: [body, meta, tag, stage] with
        # stage "meta_bus" (meta rides the next bus), "meta_copy" (meta in
        # its own HostCopy) or "body" (meta on the host, body HostCopy or None)
        self._pending_mesh_dev: List[list] = []
        self._pending_tracks = []
        # deferred extraction: when True, outputs carry their finished tracks
        # and finalize_output extracts them; _inflight_tracks keeps the frames
        # of handed-out tracks alive across the trim until then
        self.defer_object_extraction = False
        self._inflight_tracks: List[List] = []
        self.frame_count = 0
        # --- the bus (see ActiveWindowConfig.stats_batch_frames)
        self._track_queue = collections.deque()  # (frame, packed stats), oldest first
        self._bus_unflushed: List[torch.Tensor] = []  # packed stats not yet on a bus
        self._bus_metas: List[list] = []  # emission entries whose meta rides the next bus
        self._bus_pending = collections.deque()  # (n_stats, entries, HostCopy)
        self._sinks: List = []  # per-frame debug sinks (addKhronosSink parity)
        self._build_fused_step()

    def add_sink(self, sink) -> None:
        """Register a per-frame sink called as sink(frame, aw, output) after
        each spin_once (reference ActiveWindow::addKhronosSink,
        active_window.h:116; used by eval.visualizers.ActiveWindowVisualizer)."""
        self._sinks.append(sink)

    def _build_grid(self) -> None:
        """The volume's layout: one grid, or with n_devices >= 1 that many
        slabs over the mesh `sharding.mesh_for` gives self.device."""
        shape = self.config.volumetric_map.grid_shape
        self.mesh = None
        self.grid = fs.DenseGrid(shape)
        if self.config.n_devices >= 1:
            self.mesh = sharding.mesh_for(self.config.n_devices, self.device, self.group)
            self.device = self.mesh.devices[self.mesh.local[0]]
            self.grid = sharding.SlabGrid(self.mesh, shape)
        elif self.group is not None:
            raise ValueError("ActiveWindow: a window over several ranks needs n_devices >= 1")

    @property
    def devices(self):
        """Every device this process's window work runs on, the first
        holding the pixel side: the mesh's cards (this rank's slabs' over
        several ranks), or the window's one device."""
        return tuple(self.mesh.devices[i] for i in self.mesh.local) if self.mesh is not None else (self.device,)

    def synchronize(self) -> None:
        """Wait for the window's queued work on every card it uses."""
        sharding.synchronize(self.devices)

    def __getstate__(self):
        """Checkpoint support: the built step is session-local (rebuilt on
        restore), and so are the sinks and the device mesh. Host copies in
        flight pickle as landed copies (utils/host_copy.py). A window over
        several ranks has no checkpoint (its slabs live in several
        processes)."""
        if self.group is not None:
            raise NotImplementedError("ActiveWindow: a checkpoint of a window over several ranks is not supported")
        state = self.__dict__.copy()
        state.pop("_fused_step", None)
        state.pop("mesh", None)
        state.pop("grid", None)
        state["_sinks"] = []
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        # slabs come back on the restoring device: rebuild the mesh over
        # the restoring host's cards and put each slab on its shard's card
        self._build_grid()
        self.state = self.grid.place(self.state)
        self._build_fused_step()

    def _build_fused_step(self) -> None:
        """Build the fused per-frame step, or leave it None for the modular
        path: fused=False, or an InstanceForwarding detector asking for more
        instances than the fused packed layout holds (fused_step.MC)."""
        config, od = self.config, self.config.object_detector
        self._fused_step = None
        self._openset_fused = False
        fused_ok = od.type in (None, "ConnectedSemantics", "InstanceForwarding")
        if od.type == "InstanceForwarding":
            fused_ok = od.config.max_instances <= fs.MC
        if not (config.fused and fused_ok):
            return
        od_cfg = od.config if od.enabled else None
        md = config.motion_detector
        self._openset_fused = od.type == "InstanceForwarding"
        bg_emb = getattr(self.object_detector, "background_embeddings", None)
        self._fused_step = fs.make_frame_step(
            config.volumetric_map,
            self.camera,
            md.config if md.enabled else None,
            od_cfg,
            self.label_space,
            detection_stride=config.detection_stride,
            crop=self.mesh is None,
            background_embeddings=bg_emb if self._openset_fused else None,
            mesh=self.mesh,
        )
        if self._openset_fused:
            # the step's feature rows: the prompts' width, else the config's
            self._feature_dim = (
                bg_emb.shape[1] if bg_emb is not None and len(bg_emb) else max(int(od_cfg.feature_dim), 1)
            )

    def set_background_embeddings(self, embeddings) -> None:
        """Set the open-set background-prompt embedding group and rebuild the
        fused step with the on-device background filter."""
        if hasattr(self.object_detector, "set_background_embeddings"):
            self.object_detector.set_background_embeddings(embeddings)
        self._build_fused_step()

    # ------------------------------------------------------------------
    def _on_device(self, x, dtype):
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        return x.to(device=self.device, dtype=dtype)

    def set_time_base(self, t0_ns: int) -> None:
        """Fix the device time origin (called once by the pipeline so every
        stage shares one t0). Must precede the first spin_once."""
        if self._t0_ns is not None and self._t0_ns != t0_ns:
            raise ValueError("time base already set from a processed frame")
        self._t0_ns = int(t0_ns)

    def spin_once(self, frame: FrameData) -> Optional[ActiveWindowOutput]:
        cfg = self.config
        vol_cfg = cfg.volumetric_map
        if self._t0_ns is None:
            self._t0_ns = frame.stamp_ns
        t_now = (frame.stamp_ns - self._t0_ns) * 1e-9
        cam_pos = np.asarray(frame.t_w_c)

        with Timer("active_window/all", frame.stamp_ns):
            # 0) scroll the volume if the camera approaches the grid boundary
            # (origin cached on the host)
            if not self._initialized_origin:
                shape = np.asarray(vol_cfg.grid_shape)
                origin = np.floor(cam_pos / vol_cfg.voxel_size - shape / 2.0).astype(np.int32)
                self.state = self.grid.with_origin(self.state, origin)
                self._origin_np = origin
                self._initialized_origin = True
            elif av.needs_recenter(vol_cfg, self.state, cam_pos, self._origin_np):
                with Timer("active_window/scroll", frame.stamp_ns):
                    shift = av.recenter_shift(vol_cfg, self.state, cam_pos, self._origin_np)
                    fmask = self.grid.emission_mask(self.state, "forced", shift)
                    self._emit_mesh(fmask, rounds=self._scroll_rounds(shift))
                    self.state = self.grid.scroll(vol_cfg, self.state, shift)
                    self._origin_np = self._origin_np + np.asarray(shift, np.int32)

            frame.depth = self._on_device(frame.depth, torch.float32)
            frame.color = self._on_device(frame.color, torch.float32)
            frame.labels = self._on_device(frame.labels, torch.int32)
            if frame.instances is not None:
                frame.instances = self._on_device(frame.instances, torch.int32)
            if self._fused_step is not None:
                # 1-4) detect + track-stats + integrate + archive in one step;
                # the packed stats wait for the next bus
                with Timer("active_window/fused_step", frame.stamp_ns):
                    if self._openset_fused:
                        self.state, dyn_img, obj_img, packed = self._fused_step(
                            self.state, frame.depth, frame.color, frame.labels,
                            self._instances(frame), self._feature_rows(frame),
                            frame.R_w_c, frame.t_w_c, t_now,
                        )
                    else:
                        self.state, dyn_img, obj_img, packed = self._fused_step(
                            self.state, frame.depth, frame.color, frame.labels,
                            frame.R_w_c, frame.t_w_c, t_now,
                        )
                    frame.dynamic_image = dyn_img
                    frame.object_image = obj_img
                self._track_frame(frame, packed)
            else:
                self._modular_step(frame, t_now)

            # 4.5) pump the host pulls: flush the bus on cadence, deliver any
            # landed bus (tracker stats + emission metas), advance the
            # emission body pulls; no wait unless the backlog is over its cap
            with Timer("active_window/advance_pulls", frame.stamp_ns):
                if len(self._bus_unflushed) >= max(1, cfg.stats_batch_frames) or (
                    self._bus_metas and not self._bus_unflushed
                ):
                    self._flush_bus()
                self._poll_bus()
                self._advance_mesh_pulls()
                cap = max(1, cfg.max_inflight_pulls)
                if len(self._bus_pending) > cap:
                    self._poll_bus(min_drain=len(self._bus_pending) - cap)
                if len(self._pending_mesh_dev) > cap:
                    if self._pending_mesh_dev[0][3] == "meta_bus":
                        # the head round's meta rides a bus not yet flushed:
                        # flush and consume one bus so the force below can act
                        self._flush_bus()
                        self._poll_bus(min_drain=1)
                    self._advance_mesh_pulls(force=len(self._pending_mesh_dev) - cap)

            # 5) frame buffer: keep only what object extraction consumes
            # (depth + object_image + pose). Frames not yet seen by the
            # tracker, or referenced by a live track, one waiting for the
            # next output or one handed out for deferred extraction, survive
            # the trim.
            self.frame_buffer.store(dataclasses.replace(
                frame, color=None, labels=None, instances=None, dynamic_image=None,
            ))
            if self.tracker is not None:
                referenced = set(self.tracker.referenced_stamps())
                referenced.add(frame.stamp_ns)
                referenced.update(f.stamp_ns for f, _ in self._track_queue)
                for t in self._pending_tracks:
                    referenced.update(o.stamp_ns for o in t.observations)
                for tracks in self._inflight_tracks:
                    for t in tracks:
                        referenced.update(o.stamp_ns for o in t.observations)
                self.frame_buffer.trim(referenced)

            self.frame_count += 1

            # 6) periodic output extraction
            output = None
            if t_now - self._last_output_s >= cfg.min_output_separation:
                self._last_output_s = t_now
                with Timer("active_window/extract_output", frame.stamp_ns):
                    output = self._extract_output(frame)
        for sink in self._sinks:
            sink(frame, self, output)
        return output

    def _instances(self, frame: FrameData) -> torch.Tensor:
        if frame.instances is not None:
            return frame.instances
        return torch.zeros(frame.depth.shape, dtype=torch.int32, device=self.device)

    def _feature_rows(self, frame: FrameData) -> torch.Tensor:
        """The fused open-set step's [MC, D] feature input: the frame's first
        MC label features, zero padded."""
        D = self._feature_dim
        feats = np.zeros((fs.MC, D), np.float32)
        lf = frame.label_features
        if lf is not None and len(lf):
            lf = np.asarray(lf, np.float32)
            n = min(len(lf), fs.MC)
            feats[:n, : min(lf.shape[1], D)] = lf[:n, :D]
        return torch.from_numpy(feats).to(self.device)

    def _modular_step(self, frame: FrameData, t_now: float) -> None:
        """Steps 1-4 stage by stage: motion detection on the pre-integration
        volume, object detection, tracking on the frame's full vertex image,
        then integration (dynamic pixels masked out) and archival. A sharded
        grid is gathered onto the first device for the stages and split
        again after them."""
        self.state = self.grid.whole(self.state)
        try:
            self._modular_stages(frame, t_now)
        finally:
            self.state = self.grid.place(self.state)

    def _modular_stages(self, frame: FrameData, t_now: float) -> None:
        vol_cfg = self.config.volumetric_map
        zeros = torch.zeros(frame.depth.shape, dtype=torch.int32, device=self.device)
        if self.motion_detector is not None:
            with Timer("motion_detection/all", frame.stamp_ns):
                self.motion_detector.process(self.state, frame)
        if frame.dynamic_image is None:
            frame.dynamic_image = zeros
        if self.object_detector is not None:
            with Timer("object_detection/all", frame.stamp_ns):
                self.object_detector.process(self.state, frame)
        if frame.object_image is None:
            frame.object_image = zeros
        if self.tracker is not None:
            with Timer("tracking/all", frame.stamp_ns):
                # the host tracker reads the id images and the vertex image
                # as numpy (the reference pulls them from the device too)
                points_w = self.camera.vertex_image_world(frame.depth, frame.R_w_c, frame.t_w_c)
                host = dataclasses.replace(
                    frame,
                    dynamic_image=frame.dynamic_image.cpu().numpy(),
                    object_image=frame.object_image.cpu().numpy(),
                )
                self._pending_tracks.extend(self.tracker.process(host, points_w.cpu().numpy()))
        with Timer("integration/all", frame.stamp_ns):
            # the reference calls both outside jit: their eager rounding
            self.state = av.integrate_frame(
                vol_cfg, self.camera, self.state, frame.depth, frame.color, frame.labels,
                frame.dynamic_image > 0, frame.R_w_c, frame.t_w_c, t_now, eager=True,
            )
            self.state = av.update_archival(vol_cfg, self.state, t_now, eager=True)

    # ------------------------------------------------------------------
    def _track_frame(self, frame: FrameData, packed: torch.Tensor) -> None:
        """Queue (frame, packed stats) for the bus; the tracker runs when the
        bus carrying this frame's stats lands on the host."""
        self._track_queue.append((frame, packed))
        self._bus_unflushed.append(packed)

    def _flush_bus(self) -> None:
        """Start ONE host copy carrying every unflushed frame's packed stats
        and up to BUS_META_CAPACITY pending emission metas (the rest ride the
        next bus)."""
        if not self._bus_unflushed and not self._bus_metas:
            return
        metas = self._bus_metas[:BUS_META_CAPACITY]
        items = self._bus_unflushed + [e[1] for e in metas]
        buf = torch.cat([x.reshape(-1).to(torch.float32) for x in items])
        copy = HostCopy(buf, earliest=self.earliest_pulls, site="bus")
        self._bus_pending.append((len(self._bus_unflushed), metas, copy))
        self._bus_unflushed = []
        self._bus_metas = self._bus_metas[BUS_META_CAPACITY:]

    def _poll_bus(self, block: bool = False, min_drain: int = 0) -> None:
        """Deliver landed buses in FIFO order: run the tracker over each
        carried frame's stats and hand each carried emission meta to its
        round (starting the used-rows body pull). `min_drain` consumes at
        least that many oldest buses, waiting for them; `block` all."""
        drained = 0
        while self._bus_pending:
            n_stats, entries, copy = self._bus_pending[0]
            if not block and drained >= min_drain and not copy.ready():
                return
            arr = copy.numpy(0)
            off = 0
            for _ in range(n_stats):
                frame, packed = self._track_queue.popleft()
                n = packed.shape[0]
                self._run_tracker(frame, arr[off : off + n])
                off += n
            for ent in entries:
                meta = arr[off : off + META_LEN]
                off += META_LEN
                ent[1] = meta
                ent[0] = meshing.start_body_pull(ent[0], int(meta[0]), self.earliest_pulls)
                ent[3] = "body"
            self._bus_pending.popleft()
            drained += 1

    def _run_tracker(self, frame: FrameData, packed: np.ndarray) -> None:
        dyn_c, sem_c, dyn_p, sem_p = fs.unpack_stats(
            packed,
            features=frame.label_features if self._openset_fused else None,
            openset=self._openset_fused,
        )
        frame.dynamic_clusters = dyn_c
        frame.semantic_clusters = sem_c
        if self.tracker is not None:
            with Timer("tracking/all", frame.stamp_ns):
                finished = self.tracker.process(frame, cluster_points=(dyn_p, sem_p))
            self._pending_tracks.extend(finished)

    def _flush_tracker_queue(self) -> None:
        """Force every queued frame through the tracker: flush the bus and
        consume it, waiting."""
        self._flush_bus()
        self._poll_bus(block=True)

    # ------------------------------------------------------------------
    def finish_mapping(self, frame: Optional[FrameData] = None) -> ActiveWindowOutput:
        """Deactivate everything and flush (finishMapping, cpp:176-189)."""
        self._flush_tracker_queue()
        if self.tracker is not None:
            self._pending_tracks.extend(self.tracker.finish())
        self._emit_mesh(self.grid.emission_mask(self.state, "finish"))
        stamp = frame.stamp_ns if frame is not None else 0
        R = np.asarray(frame.R_w_c) if frame is not None else np.eye(3, dtype=np.float32)
        t = np.asarray(frame.t_w_c) if frame is not None else np.zeros(3, np.float32)
        return self._build_output(stamp, R, t, flush=True)

    def finalize_output(self, out: ActiveWindowOutput) -> ActiveWindowOutput:
        """Run the deferred object extraction for `out` (the backend stage).
        The tracks' frames are pinned via _inflight_tracks until this runs;
        extraction only reads the frame buffer."""
        if out.pending_tracks:
            with Timer("object_extraction/all", out.stamp_ns):
                out.objects = self.object_extractor.extract_all(out.pending_tracks, self.frame_buffer)
            self._inflight_tracks = [t for t in self._inflight_tracks if t is not out.pending_tracks]
            out.pending_tracks = None
        return out

    # ------------------------------------------------------------------
    def _extract_output(self, frame: FrameData) -> ActiveWindowOutput:
        # one round: leftover cells stay unmeshed and re-emit at the next
        # output; its meta rides the next bus
        with Timer("extract/emit"):
            self._emit_mesh(self.grid.emission_mask(self.state, "archived"), drain=False)
        return self._build_output(frame.stamp_ns, np.asarray(frame.R_w_c), np.asarray(frame.t_w_c))

    def _scroll_rounds(self, shift) -> int:
        """Host-side estimate of the emission rounds needed to cover a
        scroll-out slab: slab voxel count x scroll_surface_fraction surface
        cells, each round consuming up to mesh_max_cells of them. 0 means
        'use the blocking drain' (scroll_surface_fraction <= 0)."""
        frac = self.config.scroll_surface_fraction
        if frac <= 0:
            return 0
        X, Y, Z = self.config.volumetric_map.grid_shape
        sx, sy, sz = (abs(int(s)) for s in np.asarray(shift))
        slab = min(sx, X) * Y * Z + sy * X * Z + sz * X * Y
        est_cells = max(1.0, slab * frac)
        return int(np.clip(-(-est_cells // self.config.mesh_max_cells), 1, 6))

    def _emit_mesh(self, emit_mask, drain: bool = True, rounds: int = 0) -> None:
        """Emit surface cells as emission rounds (`_pending_mesh_dev`).

        drain=False dispatches ONE round; leftover cells re-emit at the next
        output. rounds=n > 0 dispatches n rounds back to back with no wait
        (each round excludes already-meshed cells, so rounds are
        incremental); the last round is audited for dropped cells when it is
        unpacked. Both send their metas over the bus. drain=True (finish)
        emits EVERY cell in the mask with one wait: each drain round's meta
        has its own host copy, round 1's says how many cells are wanted, and
        each round consumes at least min_cells_per_round of them."""
        vol_cfg = self.config.volumetric_map
        max_cells = self.config.mesh_max_cells

        def one_round(own_meta_copy: bool):
            self.state, packed, meta = self.grid.extract_mesh_async(self.state, emit_mask, vol_cfg, max_cells)
            if own_meta_copy:
                ent = [packed, HostCopy(meta, earliest=self.earliest_pulls, site="mesh_meta"), None, "meta_copy"]
            else:
                ent = [packed, meta, None, "meta_bus"]
                self._bus_metas.append(ent)
            self._pending_mesh_dev.append(ent)
            return ent

        ent = one_round(drain and rounds == 0)
        if rounds > 0:
            for _ in range(rounds - 1):
                ent = one_round(False)
            ent[2] = "scroll_final"  # its meta is audited on unpack
            return
        if not drain:
            return
        meta = ent[1].numpy(0)
        n_remaining = max(0, int(meta[1]) - int(meta[2]))
        per_round = meshing.min_cells_per_round(max_cells)
        for _ in range(-(-n_remaining // per_round)):
            one_round(True)

    def _advance_mesh_pulls(self, force: int = 0) -> None:
        """Per pending round, in FIFO order: once its meta is on the host
        (delivered by a bus, or its own copy has landed) start the copy of
        only its used body rows; once those have landed, unpack it into the
        pending mesh deltas. Stops at the first round that is not ready, so
        deltas keep their order; `force` consumes at least that many of the
        oldest rounds whose metas are not on a bus still to land, waiting."""
        done = 0
        for ent in self._pending_mesh_dev:
            forced = done < force
            if ent[3] == "meta_bus":
                break  # its meta rides a bus that has not landed yet
            if ent[3] == "meta_copy":
                if not forced and not ent[1].ready():
                    break
                ent[1] = ent[1].numpy(0)
                ent[0] = meshing.start_body_pull(ent[0], int(ent[1][0]), self.earliest_pulls)
                ent[3] = "body"
            if not forced and ent[0] is not None and not ent[0].ready():
                break
            self._finalize_pull(ent)
            done += 1
        del self._pending_mesh_dev[:done]

    def _finalize_pull(self, ent) -> None:
        """Unpack a round whose copies have landed (or wait for them) and
        append its triangles to the pending mesh deltas. Callers resolve
        "meta_bus" rounds (drain the bus) before forcing this."""
        body, meta, tag, stage = ent
        if stage != "body":  # flush path: take the meta and start the body pull now
            meta = meta.numpy(0)
            body = meshing.start_body_pull(body, int(meta[0]))
        tris, n_remaining = meshing.unpack_mesh(meshing.body_rows(body), meta)
        if tag == "scroll_final" and n_remaining > 0:
            clog(
                2,
                f"scroll emission under-provisioned: {n_remaining} "
                "surface cells dropped (raise scroll_surface_fraction)",
            )
        self._append_mesh_delta(tris)

    def _append_mesh_delta(self, tris) -> None:
        if len(tris["vertices"]):
            t0 = self._t0_ns or 0  # voxel obs times are t0-relative seconds
            self._pending_mesh.append(
                dict(
                    mesh_vertices=tris["vertices"],
                    mesh_colors=tris["colors"],
                    mesh_first_ns=(tris["first_obs"].astype(np.float64) * 1e9).astype(np.int64) + t0,
                    mesh_last_ns=(tris["last_obs"].astype(np.float64) * 1e9).astype(np.int64) + t0,
                    mesh_labels=tris["labels"],
                )
            )

    def _build_output(self, stamp_ns, R, t, flush: bool = False) -> ActiveWindowOutput:
        # Collect landed copies without waiting; anything still in flight
        # joins the NEXT output's delta. `flush` (finish) waits for all.
        with Timer("extract/consume_pulls", stamp_ns):
            self._poll_bus()
            self._advance_mesh_pulls()
            if flush:
                # drain the bus so every "meta_bus" round has its meta, then
                # consume every round, waiting
                self._flush_bus()
                self._poll_bus(block=True)
                for ent in self._pending_mesh_dev:
                    self._finalize_pull(ent)
                self._pending_mesh_dev = []
        if self._pending_mesh:
            delta = {
                k: np.concatenate([d[k] for d in self._pending_mesh])
                for k in self._pending_mesh[0]
            }
        else:
            delta = _empty_mesh_delta()
        self._pending_mesh = []

        objects: List[KhronosObject] = []
        pending: Optional[List] = None
        if self.object_extractor is not None and self._pending_tracks:
            if self.defer_object_extraction and not flush:
                pending = self._pending_tracks
                self._inflight_tracks.append(pending)
            else:
                with Timer("object_extraction/all", stamp_ns):
                    objects = self.object_extractor.extract_all(self._pending_tracks, self.frame_buffer)
        self._pending_tracks = []
        return ActiveWindowOutput(
            stamp_ns=stamp_ns, R_w_b=R, t_w_b=t, objects=objects, pending_tracks=pending, **delta,
        )
