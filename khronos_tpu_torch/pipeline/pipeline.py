"""KhronosPipeline: full online pipeline L0->L5 plus the experiment harness.

Port of `khronos_tpu/pipeline/pipeline.py`, the equivalent of
khronos::KhronosPipeline + ExperimentManager (khronos_ros/src/
khronos_pipeline.cpp, experiments/experiment_manager.cpp): wires the active
window, backend, change detection, reconciliation, and the 4D map; runs the
sequence; saves the output-directory contract (config.txt, timing/,
dsg.npz, final.4dmap.npz, object/background change CSVs, objects.csv,
experiment_log.txt with the "Experiment Finished Cleanly" flag).

Each frame runs the stages inline by default: active window, backend, the
places layer (per output by default), and every
`run_change_detection_every_n_frames` frames and on each loop closure,
change detection on a freshly built DSG copy, reconciliation and a 4D-map
snapshot. The async stage mode (`start_async` / `submit_frame` /
`finish_async`, and `ExperimentManager.run(async_stages=True)` on the native
stage executor) runs the reference's thread topology instead: the frame loop
runs the active window only, a backend worker consumes its outputs and a
detached change-detection worker runs the passes, with adaptive cadence.
Every stage launches on the one default CUDA stream, so their device work
serialises on the card while their host work overlaps. `checkpoint` /
`restore` write and read the full live state (`pipeline/checkpoint.py`).
The device work runs on `device`: CUDA unless the caller passes
device="cpu".
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Tuple

import numpy as np

from khronos_tpu_torch import resolve_device
from khronos_tpu_torch.active_window.active_window import ActiveWindow, ActiveWindowConfig
from khronos_tpu_torch.active_window.frame_data import FrameData
from khronos_tpu_torch.active_window.object_detection import LabelSpace
from khronos_tpu_torch.backend.backend import Backend, BackendConfig
from khronos_tpu_torch.changes.detectors import (
    SequentialChangeDetector,
    SequentialChangeDetectorConfig,
)
from khronos_tpu_torch.changes.reconciler import Reconciler, ReconcilerConfig
from khronos_tpu_torch.config import format_config
from khronos_tpu_torch.geometry.camera import Camera
from khronos_tpu_torch.stm import serialization
from khronos_tpu_torch.stm.places import PlacesConfig, PlacesExtractor
from khronos_tpu_torch.stm.spatio_temporal_map import SpatioTemporalMap
from khronos_tpu_torch.utils.logging import FINISHED_CLEANLY, ExperimentLogger, setup_output_directory
from khronos_tpu_torch.utils.timing import Timer, TimingRecorder


@dataclasses.dataclass
class LabelSpaceConfig:
    num_classes: int = 32
    object_labels: Tuple[int, ...] = ()
    dynamic_labels: Tuple[int, ...] = ()

    def create(self) -> LabelSpace:
        return LabelSpace(self.num_classes, tuple(self.object_labels), tuple(self.dynamic_labels))


@dataclasses.dataclass
class PipelineConfig:
    active_window: ActiveWindowConfig = dataclasses.field(default_factory=ActiveWindowConfig)
    backend: BackendConfig = dataclasses.field(default_factory=BackendConfig)
    change_detection: SequentialChangeDetectorConfig = dataclasses.field(
        default_factory=SequentialChangeDetectorConfig
    )
    reconciler: ReconcilerConfig = dataclasses.field(default_factory=ReconcilerConfig)
    label_space: LabelSpaceConfig = dataclasses.field(default_factory=LabelSpaceConfig)
    # -1: off, 0: only on loop closure, n: every n frames (+ on LC)
    # (reference map_update_frequency, uHumans2.yaml:7)
    run_change_detection_every_n_frames: int = 50
    # free-space places layer (hydra GVD frontend equivalent); None disables
    places: Optional[PlacesConfig] = dataclasses.field(default_factory=PlacesConfig)
    # places cadence (reference builds scene-graph layers incrementally per
    # backend input, uHumans2.yaml:103-150):
    #   "output"   — incremental: occupancy fed per ActiveWindowOutput mesh
    #                delta, windowed re-extraction around the robot (default)
    #   "snapshot" — full re-extraction at every change-detection snapshot
    #   "finish"   — full extraction only at finishMapping
    places_mode: str = "output"

    def check(self):
        assert self.places_mode in ("output", "snapshot", "finish"), self.places_mode


class KhronosPipeline:
    def __init__(self, config: PipelineConfig, camera: Camera, device=None, group=None):
        """device: where the active window, the backend's solve, the places
        layer, change detection and the reconciler's distances run; CUDA
        unless the caller passes device="cpu" (raises when no GPU is
        visible). group (`parallel.distributed`): this pipeline is one rank
        of several processes on the same frames (the reference's pipeline
        over a global mesh): the window's slabs spread over the ranks, and
        everything else runs in every rank, on the rank's device."""
        self.config = config
        self.camera = camera
        self.device = resolve_device(device)
        if group is not None:
            if self.device.type != group.device.type:
                raise ValueError(f"KhronosPipeline: device {self.device} for rank {group.rank} on {group.device}")
            self.device = group.device
        self.label_space = config.label_space.create()
        self.active_window = ActiveWindow(config.active_window, camera, self.label_space, device=self.device,
                                          group=group)
        self.backend = Backend(config.backend, device=self.device)
        if config.change_detection.verificator.max_ray_length <= 0:
            # physical plausibility: rays longer than the sensor range
            # cannot have been observed (see RayVerificatorConfig)
            config.change_detection.verificator.max_ray_length = (
                camera.max_range * 1.05
            )
        if config.change_detection.verificator.max_ray_angle_deg <= 0:
            # ... nor can targets outside the camera frustum (diagonal
            # half-FOV + slack)
            half_diag = np.degrees(
                np.arctan(np.hypot(camera.cx / camera.fx, camera.cy / camera.fy))
            )
            config.change_detection.verificator.max_ray_angle_deg = (
                float(half_diag) * 1.05
            )
        self.change_detector = SequentialChangeDetector(config.change_detection, device=self.device)
        self.reconciler = Reconciler(config.reconciler, device=self.device)
        self.places_extractor = (
            PlacesExtractor(config.places, device=self.device) if config.places is not None else None
        )
        if self.places_extractor is not None and getattr(self.backend.lcd, "needs_places", False):
            # hydra-LCD places tier: keyframes get a clearance-histogram
            # descriptor of the local places layer as a candidate gate
            self.backend.places_provider = self.places_extractor.lcd_snapshot
        self.map = SpatioTemporalMap()
        # one time base for the whole run, fixed at the first frame: device
        # programs (active window) and the change-detection evidence bins
        # work in t0-relative float32 seconds, so epoch-scale bag stamps
        # (~1.7e18 ns) lose no precision. Host int64 ns stamps stay absolute.
        self.t0_ns: Optional[int] = None
        self.frame_count = 0
        self._finishing = False
        self._frames_since_cd = 0
        self._last_stamp_ns = 0
        self._last_places_ns = -(10**18)
        self._places_due: Optional[Tuple[np.ndarray, int]] = None
        self._last_frame: Optional[FrameData] = None
        self._change_sinks: List = []
        # adaptive CD cadence: an optional callable; when it returns False on
        # a periodic (non-LC) trigger, the pass is DEFERRED — frames_since_cd
        # keeps counting, so it re-triggers on the next frame once the gate
        # opens. LC-triggered passes always run.
        self.cd_gate = None
        self.cd_deferred_triggers = 0

    def add_change_sink(self, sink) -> None:
        """Register sink(dsg, changes, stamp_ns) called after every change-
        detection pass (reference Backend::addChangeSink, backend.h:116)."""
        self._change_sinks.append(sink)

    def __getstate__(self):
        state = self.__dict__.copy()
        state["_change_sinks"] = []  # session-local
        for key in ("_bq", "_cdq", "_backend_thread", "_cd_thread"):  # the async mode's threads and queues
            state.pop(key, None)
        return state

    # ------------------------------------------------------------------
    def process_frame(
        self,
        frame: FrameData,
        gt_pose: Optional[Tuple[np.ndarray, np.ndarray]] = None,
        defer_cd: bool = False,
    ):
        """Run one frame through AW + backend (+ the incremental places
        layer). When change detection is due: inline by default; with
        defer_cd=True return a snapshot request (dsg, stamp_ns, had_lc,
        merges) for a detached CD stage instead (the reference's
        detached-thread semantics, backend.cpp:189-216); the places
        re-extraction is then handed to that stage too (take_places_update)."""
        if self.t0_ns is None:
            self.t0_ns = frame.stamp_ns
            self.active_window.set_time_base(self.t0_ns)
        with Timer("pipeline/frame", frame.stamp_ns):
            out = self.active_window.spin_once(frame)
            had_lc = False
            if out is not None:
                lcd_frame = self._prepare_lcd_frame(frame)
                had_lc = self.backend.add_output(out, gt_pose=gt_pose, lcd_frame=lcd_frame)
                if self.places_extractor is not None and self.config.places_mode == "output":
                    # incremental frontend: archived mesh delta -> occupancy,
                    # windowed place re-extraction around the robot
                    with Timer("pipeline/places_incremental"):
                        self.places_extractor.add_mesh_delta(out.mesh_vertices)
                        gap = self.config.places.min_update_interval_s
                        if frame.stamp_ns - self._last_places_ns >= int(gap * 1e9):
                            self._last_places_ns = frame.stamp_ns
                            if defer_cd:
                                self._places_due = (np.asarray(out.t_w_b), out.stamp_ns)
                            else:
                                self.places_extractor.update_local(out.t_w_b, stamp_ns=out.stamp_ns)
            self.frame_count += 1
            self._frames_since_cd += 1
            self._last_stamp_ns = frame.stamp_ns
            self._last_frame = frame

            n = self.config.run_change_detection_every_n_frames
            if n >= 0 and (had_lc or (n > 0 and self._frames_since_cd >= n)):
                if not had_lc and self.cd_gate is not None and not self.cd_gate():
                    # adaptive cadence: defer, and re-trigger on the next
                    # frame once the gate opens
                    self.cd_deferred_triggers += 1
                elif defer_cd:
                    return self.make_cd_request(had_loop_closure=had_lc)
                else:
                    self.run_change_detection(had_loop_closure=had_lc)
        return None

    def _prepare_lcd_frame(self, frame: FrameData):
        """Sensor-frame payload for LCDs with needs_frame: camera-frame
        vertex image at stride 4 (+ downsampled color for the appearance
        stream), strided on the device before the pull."""
        if not getattr(self.backend.lcd, "needs_frame", False):
            return None
        depth = frame.depth[::4, ::4].cpu().numpy()
        pts = self.camera.back_project(frame.depth)[::4, ::4].cpu().numpy()
        valid = (depth > 0.1) & (depth < self.camera.max_range)
        lcd_frame = (pts.astype(np.float32), valid)
        if getattr(self.backend.lcd, "needs_color", False):
            color = frame.color[::4, ::4].cpu().numpy()
            lcd_frame = lcd_frame + (color.astype(np.float32),)
        return lcd_frame

    def take_places_update(self):
        """Deferred incremental places work (set by process_frame under
        defer_cd): a callable for the detached stage, or None. Safe to run
        concurrently with the frame loop (the extractor's own lock)."""
        if self._places_due is None or self.places_extractor is None:
            return None
        center, stamp_ns = self._places_due
        self._places_due = None
        return lambda: self.places_extractor.update_local(center, stamp_ns=stamp_ns)

    # ------------------------------------------------------------------
    def make_cd_request(self, had_loop_closure: bool = False):
        """Snapshot backend state for a change-detection pass (snapshot
        isolation: get_dsg() builds a fresh deformed copy)."""
        self._frames_since_cd = 0
        with Timer("pipeline/cd_snapshot", self._last_stamp_ns):
            dsg = self.backend.get_dsg()
            merges = self.backend.validated_merges()
            if self.places_extractor is not None and self.config.places_mode == "output":
                dsg.places = self.places_extractor.snapshot_layer()
        return (dsg, self._last_stamp_ns, had_loop_closure, merges)

    def run_change_detection_on(self, dsg, stamp_ns, had_loop_closure, merges) -> None:
        """Detect + reconcile + 4D snapshot on an isolated DSG copy. Touches
        only CD-owned state (change_detector, map)."""
        with Timer("pipeline/change_detection", stamp_ns):
            changes = self.change_detector.detect_changes(dsg, had_loop_closure, merges)
            # keep the PRE-reconcile mesh (shared arrays; the reconciler
            # rebinds, not mutates): it is the append-only canonical stream
            # the 4D map's union store extends from
            canonical = dsg.mesh.clone(share_arrays=True)
            dsg = self.reconciler.reconcile(dsg, changes, merges)
            mode = self.config.places_mode
            if self.places_extractor is not None and (
                mode == "snapshot" or (self._finishing and mode != "output")
            ):
                with Timer("pipeline/places"):
                    dsg.places = self.places_extractor.extract(dsg.mesh.vertices)
            elif self.places_extractor is not None and mode == "output" and had_loop_closure:
                # loop-closure passes rewrite/deform geometry wholesale:
                # rebuild the places occupancy store from the reconciled
                # scene (background + static object meshes: objects are
                # obstacles for clearance) so removed geometry stops carving
                # free space
                with Timer("pipeline/places_reset"):
                    parts = [np.asarray(dsg.mesh.vertices).reshape(-1, 3)]
                    for o in dsg.objects.values():
                        if not o.is_dynamic and len(o.mesh_vertices):
                            parts.append(np.asarray(o.mesh_vertices) + o.bbox_min)
                    self.places_extractor.reset_occupancy(np.concatenate(parts))
            with Timer("pipeline/map_update"):
                self.map.update(dsg, stamp_ns, canonical_mesh=canonical)
        for sink in self._change_sinks:
            sink(dsg, changes, stamp_ns)

    def run_change_detection(self, had_loop_closure: bool = False) -> None:
        """Snapshot the DSG, detect changes, reconcile, store a 4D snapshot
        (backend.cpp:189-216 runChangeDetection)."""
        req = self.make_cd_request(had_loop_closure)
        self.run_change_detection_on(*req)

    # ------------------------------------------------------------------
    # Async stage mode: the reference's thread topology (SURVEY.md §2.7).
    # Frame loop = active window ONLY; a backend worker consumes outputs
    # (deferred object extraction, mesh accumulation, LCD + gated optimize,
    # incremental places) behind a bounded queue; a CD worker runs detached
    # change detection with snapshot isolation and adaptive cadence.
    # Ownership: the backend worker owns all backend state (including CD
    # snapshots); the CD worker owns change_detector + map; the frame loop
    # owns the active window minus deferred extraction.
    # ------------------------------------------------------------------
    def start_async(self, backend_queue: int = 8) -> None:
        import queue
        import threading

        self.active_window.defer_object_extraction = True
        self._bq = queue.Queue(maxsize=backend_queue)
        self._cdq = queue.Queue(maxsize=1)
        self._cd_busy = False
        self._cd_pending = False
        self._async_errors: List[BaseException] = []
        self._backend_thread = threading.Thread(target=self._backend_worker, daemon=True)
        self._cd_thread = threading.Thread(target=self._cd_worker, daemon=True)
        self._backend_thread.start()
        self._cd_thread.start()

    def submit_frame(self, frame: FrameData, gt_pose=None) -> None:
        """Async-mode frame entry: active window + handoff. Blocks only when
        the backend queue is full (bounded-queue backpressure)."""
        if self.t0_ns is None:
            self.t0_ns = frame.stamp_ns
            self.active_window.set_time_base(self.t0_ns)
        with Timer("pipeline/frame", frame.stamp_ns):
            out = self.active_window.spin_once(frame)
            self.frame_count += 1
            self._frames_since_cd += 1
            self._last_stamp_ns = frame.stamp_ns
            self._last_frame = frame
            n = self.config.run_change_detection_every_n_frames
            if n > 0 and self._frames_since_cd >= n:
                self._frames_since_cd = 0
                self._cd_pending = True
            if out is not None:
                self._bq.put((out, frame, gt_pose))
        if self._async_errors:
            raise self._async_errors[0]

    def _backend_worker(self) -> None:
        while True:
            item = self._bq.get()
            if item is None:
                return
            out, frame, gt_pose = item
            try:
                with Timer("backend/stage", out.stamp_ns):
                    self.active_window.finalize_output(out)
                    lcd_frame = self._prepare_lcd_frame(frame)
                    had_lc = self.backend.add_output(out, gt_pose=gt_pose, lcd_frame=lcd_frame)
                    if self.places_extractor is not None and self.config.places_mode == "output":
                        with Timer("pipeline/places_incremental"):
                            self.places_extractor.add_mesh_delta(out.mesh_vertices)
                            gap = self.config.places.min_update_interval_s
                            if out.stamp_ns - self._last_places_ns >= int(gap * 1e9):
                                self._last_places_ns = out.stamp_ns
                                self.places_extractor.update_local(out.t_w_b, stamp_ns=out.stamp_ns)
                    if had_lc or self._cd_pending:
                        if not self._cd_busy and self._cdq.empty():
                            self._cd_pending = False
                            self._cdq.put(self.make_cd_request(had_loop_closure=had_lc))
                        else:
                            # adaptive cadence: CD still busy, fold this
                            # trigger into the next one (an LC trigger stays
                            # pending so its pass eventually runs)
                            self._cd_pending = True
                            self.cd_deferred_triggers += 1
            except BaseException as e:  # surfaced on the next submit_frame
                self._async_errors.append(e)
            finally:
                self._bq.task_done()  # _bq.join() waits for the stage to go idle

    def _cd_worker(self) -> None:
        while True:
            req = self._cdq.get()
            if req is None:
                return
            self._cd_busy = True
            try:
                self.run_change_detection_on(*req)
            except BaseException as e:
                self._async_errors.append(e)
            finally:
                self._cd_busy = False
                self._cdq.task_done()

    def finish_async(self) -> None:
        """Drain both stages, then run the standard finish flush inline."""
        self._bq.put(None)
        self._backend_thread.join(timeout=3600)
        self._cdq.put(None)
        self._cd_thread.join(timeout=3600)
        self.active_window.defer_object_extraction = False
        if self._async_errors:
            raise self._async_errors[0]
        self.finish()

    def finish(self) -> None:
        """Flush everything (finishMapping + finishProcessing + final CD)."""
        self._finishing = True
        with Timer("pipeline/finish"):
            out = self.active_window.finish_mapping(self._last_frame)
            self.backend.add_output(out)
            if self.places_extractor is not None and self.config.places_mode == "output":
                if out is not None:
                    self.places_extractor.add_mesh_delta(out.mesh_vertices)
                    self.places_extractor.update_local(out.t_w_b, stamp_ns=out.stamp_ns)
                # final room labels must come from the full eroded-free-space
                # segmentation, not the interim between-refresh graph fallback
                self.places_extractor.refresh_rooms()
            self.backend.finish_processing()
            if self.config.run_change_detection_every_n_frames >= 0:
                self.run_change_detection(had_loop_closure=False)
            elif self.map.num_snapshots == 0:
                # always leave at least one snapshot for consumers
                self.map.update(self.backend.get_dsg(), self._last_stamp_ns)

    # ------------------------------------------------------------------
    def checkpoint(self, directory: str) -> str:
        """Write a full resumable state checkpoint (beyond the reference
        system, which loses its in-memory state on a crash)."""
        from khronos_tpu_torch.pipeline import checkpoint as ckpt

        with Timer("pipeline/checkpoint"):
            return ckpt.save(self, directory)

    @staticmethod
    def restore(directory: str, device=None) -> "KhronosPipeline":
        """Load a pipeline saved with checkpoint(), its device state on
        `device` (CUDA unless the caller passes device="cpu")."""
        from khronos_tpu_torch.pipeline import checkpoint as ckpt

        pipe = ckpt.load(directory, resolve_device(device))
        if not isinstance(pipe, KhronosPipeline):
            raise TypeError(f"checkpoint holds {type(pipe)}")
        return pipe

    # ------------------------------------------------------------------
    def save(self, directory: str) -> None:
        os.makedirs(directory, exist_ok=True)
        if self.t0_ns is not None:  # run time base (provenance for re-eval)
            with open(os.path.join(directory, "t0_ns.txt"), "w") as fh:
                fh.write(f"{self.t0_ns}\n")
        self.backend.save(directory)
        dsg = self.map.snapshots[-1] if self.map.num_snapshots else self.backend.get_dsg()
        serialization.save_mesh_ply(dsg.mesh, os.path.join(directory, "mesh.ply"))
        self.map.save(os.path.join(directory, "final.4dmap.npz"))
        self.change_detector.changes.save(directory)
        # reconciled-object summary (for quick inspection)
        import csv

        with open(os.path.join(directory, "objects.csv"), "w", newline="") as fh:
            w = csv.writer(fh)
            w.writerow(
                ["node_id", "category", "is_dynamic", "first_observed_ns",
                 "last_observed_ns", "cx", "cy", "cz"]
            )
            for oid, o in sorted(dsg.objects.items()):
                c = o.position()
                w.writerow(
                    [oid, o.semantic_category, int(o.is_dynamic),
                     o.first_observed_ns[0], o.last_observed_ns[-1],
                     f"{c[0]:.3f}", f"{c[1]:.3f}", f"{c[2]:.3f}"]
                )


@dataclasses.dataclass
class ExperimentConfig:
    output_dir: str = "/tmp/khronos_experiment"
    overwrite: bool = True
    log_timing: bool = True
    save_every_n_frames: int = 0  # 0 = no periodic snapshots
    # full resumable state checkpoints (crash recovery); 0 = off
    checkpoint_every_n_frames: int = 0


class ExperimentManager:
    """Runs a pipeline over a frame source with the reference's output-dir
    contract (experiment_manager.cpp:96-169)."""

    def __init__(
        self,
        config: ExperimentConfig,
        pipeline: KhronosPipeline,
        pipeline_config: Optional[PipelineConfig] = None,
    ):
        self.config = config
        self.pipeline = pipeline
        self.output_dir = setup_output_directory(config.output_dir, config.overwrite)
        self.logger = ExperimentLogger(self.output_dir)
        if pipeline_config is not None:
            with open(os.path.join(self.output_dir, "config.txt"), "w") as fh:
                fh.write(format_config(pipeline_config, "pipeline"))
        self._log_code_version()
        self.logger.log("Experiment initialized")

    def _log_code_version(self) -> None:
        """git_hash.txt for reproducibility (reference logs the repo hash +
        dirty status, experiment_manager.cpp:285-354)."""
        import subprocess

        repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        try:
            head = subprocess.run(
                ["git", "-C", repo, "rev-parse", "HEAD"],
                capture_output=True, text=True, timeout=10,
            ).stdout.strip()
            dirty = subprocess.run(
                ["git", "-C", repo, "status", "--porcelain"],
                capture_output=True, text=True, timeout=10,
            ).stdout.strip()
        except (OSError, subprocess.SubprocessError):
            return
        if head:
            with open(os.path.join(self.output_dir, "git_hash.txt"), "w") as fh:
                fh.write(head + (" (dirty)\n" if dirty else "\n"))

    def run(self, frames, gt_poses=None, async_stages: bool = False) -> str:
        """frames: iterable of FrameData; gt_poses: optional parallel list.

        async_stages=True runs ingest / frame processing / change detection
        on the native stage executor (stage threads + bounded queues, the
        reference's module threading model with its detached CD thread)
        instead of inline; change detection overlaps the per-frame path. A
        pipeline restored from a checkpoint resumes at its frame_count."""
        self.logger.flag("Experiment Started")
        try:
            if async_stages:
                self._run_async(frames, gt_poses)
            else:
                start = self.pipeline.frame_count  # > 0 when resumed from a checkpoint
                for i, frame in enumerate(frames):
                    if i < start:
                        continue
                    gt = gt_poses[i] if gt_poses is not None else None
                    self.pipeline.process_frame(frame, gt_pose=gt)
                    self._maybe_snapshot(i)
                    n = self.config.checkpoint_every_n_frames
                    if n > 0 and (i + 1) % n == 0:
                        self.pipeline.checkpoint(os.path.join(self.output_dir, "checkpoint"))
                        self.logger.log(f"Checkpoint written at frame {i + 1}")
        except Exception as exc:
            # beyond the reference system (which loses its in-memory state on
            # a crash): dump a resumable checkpoint and a [FLAG], then re-raise
            try:
                path = self.pipeline.checkpoint(os.path.join(self.output_dir, "checkpoint_crash"))
                self.logger.flag(f"Experiment Crashed: {exc!r}; checkpoint at {path}")
                self.logger.close()
            except Exception:
                pass
            raise
        self.pipeline.finish()
        self.pipeline.save(self.output_dir)
        if self.config.log_timing:
            TimingRecorder.instance().save(os.path.join(self.output_dir, "timing"))
        self.logger.flag(FINISHED_CLEANLY)
        self.logger.close()
        return self.output_dir

    def _maybe_snapshot(self, i: int) -> None:
        if (
            self.config.save_every_n_frames > 0
            and (i + 1) % self.config.save_every_n_frames == 0
        ):
            snap_dir = os.path.join(self.output_dir, "snapshots", f"{i + 1:05d}")
            os.makedirs(snap_dir, exist_ok=True)
            dsg = self.pipeline.backend.get_dsg()
            serialization.save_scene_graph(dsg, os.path.join(snap_dir, "dsg.npz"))

    def _run_async(self, frames, gt_poses) -> None:
        import threading

        from khronos_tpu_torch import native

        frame_iter = iter(frames)
        slots = {}
        cd_slots = {}
        lock = threading.Lock()
        INGEST, PROCESS, CD = 0, 1, 2

        def ingest(i: int) -> None:
            # one worker pulls the (not thread-safe) frame iterator and chains
            # the next index; prefetch depth = the PROCESS queue's capacity
            try:
                frame = next(frame_iter)
            except StopIteration:
                return
            gt = gt_poses[i] if gt_poses is not None else None
            with lock:
                slots[i] = (frame, gt)
            ex.push(PROCESS, i)  # blocks while the process queue is full
            ex.push(INGEST, i + 1)

        def process(i: int) -> None:
            with lock:
                frame, gt = slots.pop(i)
            req = self.pipeline.process_frame(frame, gt_pose=gt, defer_cd=True)
            # the detached stage runs both the CD passes and the incremental
            # places updates (slot key: even = CD, odd = places)
            pu = self.pipeline.take_places_update()
            if req is not None:
                with lock:
                    cd_slots[2 * i] = ("cd", req)
                ex.push(CD, 2 * i)
            if pu is not None:
                with lock:
                    cd_slots[2 * i + 1] = ("places", pu)
                ex.push(CD, 2 * i + 1)
            self._maybe_snapshot(i)

        def change_detection(j: int) -> None:
            with lock:
                kind, payload = cd_slots.pop(j)
            if kind == "cd":
                self.pipeline.run_change_detection_on(*payload)
            else:
                payload()

        ex = native.make_pipeline_executor([ingest, process, change_detection], capacity=4)
        try:
            ex.push(INGEST, 0)
            ex.drain()
            self._async_stats = {"frames": ex.processed(PROCESS), "cd_runs": ex.processed(CD)}
            ex.stop()
        finally:
            ex.close()
