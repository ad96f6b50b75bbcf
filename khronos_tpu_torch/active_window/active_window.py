"""ActiveWindow orchestrator: the per-frame hot path (L1).

Port of `khronos_tpu/active_window/active_window.py` (khronos::ActiveWindow,
active_window.cpp:118-174 spinOnce): fused detect + integrate step -> track ->
buffer frames -> (every min_output_separation) mesh the archived surface ->
extract objects from finished tracks -> push ActiveWindowOutput.
finish_mapping() deactivates everything and flushes (cpp:176-189).

All grid work runs on the device in `fused_step`; host code orchestrates,
tracks and accumulates outputs. The results the host needs (the packed
tracker stats of each frame, each mesh emission round) come back as
non-blocking copies into pinned memory with a CUDA event behind them
(`utils/host_copy.py`): the frame loop polls the events and never waits for
the device, except to keep the tracker at most `stats_batch_frames` frames
behind and the mesh rounds in flight at most `max_inflight_pulls`.

Object extraction runs inline when an output is built, unless
`defer_object_extraction` is set: then the output carries the finished
tracks on `pending_tracks` and a later `finalize_output` extracts them (the
reference's backend-thread extraction); `_inflight_tracks` keeps their frames
in the frame buffer until then. `finish_mapping` always extracts inline.

What the port leaves out, each raising NotImplementedError: the modular
(`fused=False`) path, device-mesh sharding (`n_devices >= 1`), and object
detectors other than ConnectedSemantics.
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
from khronos_tpu_torch.active_window import tracking as _tk  # noqa: F401
from khronos_tpu_torch.active_window import object_extraction as _oe  # noqa: F401


@dataclasses.dataclass
class ActiveWindowConfig:
    min_output_separation: float = 0.4  # s (uHumans2.yaml:38)
    # fused mode: the whole per-frame hot path as one step (fused_step.py);
    # the modular path is a later slice of the port
    fused: bool = True
    # run detection (motion/object clustering) on an s-strided image; TSDF
    # integration stays full-res. Must divide height and width.
    detection_stride: int = 1
    # the tracker runs on each frame's stats once their host copy has
    # landed, at most this many frames behind the device
    stats_batch_frames: int = 4
    # max mesh emission rounds whose host copies are in flight before the
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
    # device-mesh sharding of the grid (a later slice of the port); 0 = one device
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


def _empty_mesh_delta():
    return dict(
        mesh_vertices=np.zeros((0, 3, 3), np.float32),
        mesh_colors=np.zeros((0, 3, 3), np.float32),
        mesh_first_ns=np.zeros((0, 3), np.int64),
        mesh_last_ns=np.zeros((0, 3), np.int64),
        mesh_labels=np.zeros((0, 3), np.int32),
    )


class ActiveWindow:
    def __init__(
        self, config: ActiveWindowConfig, camera: Camera, label_space: LabelSpace, device=None
    ):
        """device: where the volume and every frame's work live; CUDA unless
        the caller passes device="cpu" (raises when no GPU is visible)."""
        if config.n_devices >= 1:
            raise NotImplementedError(
                "device-mesh sharding (n_devices >= 1) is not ported yet (a later "
                "slice: parallel/sharding.py)"
            )
        if not config.fused:
            raise NotImplementedError(
                "the modular active window (fused=False) is not ported yet (a later "
                "slice: the modular detectors)"
            )
        if config.object_detector.type not in (None, "ConnectedSemantics"):
            raise NotImplementedError(
                f"object detector {config.object_detector.type} is not ported yet "
                "(open-set InstanceForwarding is a later slice)"
            )
        self.device = resolve_device(device)
        self.config = config
        self.camera = camera
        self.label_space = label_space
        vol_cfg = config.volumetric_map
        self.state = av.create(vol_cfg, device=self.device)
        self._origin_np = self.state.origin.numpy().copy()
        self._initialized_origin = False
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
        self._pending_mesh_dev: List[HostCopy] = []  # emission rounds in flight, FIFO
        self._pending_tracks = []
        # deferred extraction: when True, outputs carry their finished tracks
        # and finalize_output extracts them; _inflight_tracks keeps the frames
        # of handed-out tracks alive across the trim until then
        self.defer_object_extraction = False
        self._inflight_tracks: List[List] = []
        self._track_queue = collections.deque()  # (frame, HostCopy of stats), oldest first
        self.frame_count = 0
        md = config.motion_detector
        od = config.object_detector
        self._fused_step = fs.make_frame_step(
            vol_cfg,
            camera,
            md.config if md.enabled else None,
            od.config if od.enabled else None,
            label_space,
            detection_stride=config.detection_stride,
        )

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
                self.state = self.state._replace(origin=torch.from_numpy(origin))
                self._origin_np = origin
                self._initialized_origin = True
            elif av.needs_recenter(vol_cfg, self.state, cam_pos, self._origin_np):
                with Timer("active_window/scroll", frame.stamp_ns):
                    shift = av.recenter_shift(vol_cfg, self.state, cam_pos, self._origin_np)
                    out_mask = av.scroll_out_mask(self.state, shift)
                    fmask = meshing.forced_emission_mask(self.state, out_mask)
                    self._emit_mesh(fmask, rounds=self._scroll_rounds(shift))
                    self.state = av.scroll(vol_cfg, self.state, shift)
                    self._origin_np = self._origin_np + np.asarray(shift, np.int32)

            # 1-4) detect + track-stats + integrate + archive in one step
            with Timer("active_window/fused_step", frame.stamp_ns):
                frame.depth = self._on_device(frame.depth, torch.float32)
                frame.color = self._on_device(frame.color, torch.float32)
                frame.labels = self._on_device(frame.labels, torch.int32)
                self.state, dyn_img, obj_img, packed = self._fused_step(
                    self.state, frame.depth, frame.color, frame.labels,
                    frame.R_w_c, frame.t_w_c, t_now,
                )
                frame.dynamic_image = dyn_img
                frame.object_image = obj_img
            self._track_queue.append((frame, HostCopy(packed)))

            # 4.5) consume landed host copies: tracker stats in frame order
            # (at most stats_batch_frames behind), then mesh rounds
            with Timer("active_window/advance_pulls", frame.stamp_ns):
                self._poll_tracker()
                while len(self._track_queue) > max(1, cfg.stats_batch_frames):
                    self._consume_tracker_head()
                self._advance_mesh_pulls()
                cap = max(1, cfg.max_inflight_pulls)
                if len(self._pending_mesh_dev) > cap:
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
        return output

    # ------------------------------------------------------------------
    def _consume_tracker_head(self) -> None:
        frame, copy = self._track_queue.popleft()
        self._run_tracker(frame, copy.numpy(0))

    def _poll_tracker(self, block: bool = False) -> None:
        """Run the tracker over every queued frame whose stats have landed,
        in frame order (all of them, waiting, when `block`)."""
        while self._track_queue and (block or self._track_queue[0][1].ready()):
            self._consume_tracker_head()

    def _run_tracker(self, frame: FrameData, packed: np.ndarray) -> None:
        dyn_c, sem_c, dyn_p, sem_p = fs.unpack_stats(packed)
        frame.dynamic_clusters = dyn_c
        frame.semantic_clusters = sem_c
        if self.tracker is not None:
            with Timer("tracking/all", frame.stamp_ns):
                finished = self.tracker.process(frame, cluster_points=(dyn_p, sem_p))
            self._pending_tracks.extend(finished)

    # ------------------------------------------------------------------
    def finish_mapping(self, frame: Optional[FrameData] = None) -> ActiveWindowOutput:
        """Deactivate everything and flush (finishMapping, cpp:176-189)."""
        self._poll_tracker(block=True)
        if self.tracker is not None:
            self._pending_tracks.extend(self.tracker.finish())
        self._emit_mesh(meshing.finish_emission_mask(self.state))
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
        # output; the copy overlaps the next frames' device work
        self._emit_mesh(meshing.archived_emission_mask(self.state), drain=False)
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
        """Emit surface cells as emission rounds whose host copies are in
        flight (`_pending_mesh_dev`).

        drain=False dispatches ONE round; leftover cells re-emit at the next
        output. rounds=n > 0 dispatches n rounds back to back with no wait
        (each round excludes already-meshed cells, so rounds are
        incremental); the last round is audited for dropped cells when it is
        unpacked. drain=True (finish) emits EVERY cell in the mask with one
        wait: round 1's meta says how many cells are wanted, and each round
        consumes at least min_cells_per_round of them."""
        vol_cfg = self.config.volumetric_map
        max_cells = self.config.mesh_max_cells

        def one_round():
            self.state, copy = meshing.extract_mesh_async(
                self.state, emit_mask, vol_cfg, max_cells=max_cells
            )
            self._pending_mesh_dev.append(copy)
            return copy

        copy = one_round()
        if rounds > 0:
            for _ in range(rounds - 1):
                copy = one_round()
            copy.tag = "scroll_final"
            return
        if not drain:
            return
        meta = copy.numpy(1)
        n_remaining = max(0, int(meta[1]) - int(meta[2]))
        per_round = meshing.min_cells_per_round(max_cells)
        for _ in range(-(-n_remaining // per_round)):
            one_round()

    def _advance_mesh_pulls(self, force: int = 0) -> None:
        """Unpack landed emission rounds in FIFO order, stopping at the first
        that has not landed; `force` consumes at least that many of the
        oldest, waiting for them."""
        done = 0
        for copy in self._pending_mesh_dev:
            if done >= force and not copy.ready():
                break
            tris, n_remaining = meshing.pull_mesh(copy)
            if copy.tag == "scroll_final" and n_remaining > 0:
                clog(
                    2,
                    f"scroll emission under-provisioned: {n_remaining} "
                    "surface cells dropped (raise scroll_surface_fraction)",
                )
            self._append_mesh_delta(tris)
            done += 1
        del self._pending_mesh_dev[:done]

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
            self._poll_tracker(block=flush)
            self._advance_mesh_pulls(force=len(self._pending_mesh_dev) if flush else 0)
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
