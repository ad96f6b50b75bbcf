"""Object + background change detectors and the sequential orchestrator.

Port of `khronos_tpu/changes/detectors.py`, the equivalents of the reference
RayObjectChangeDetector (khronos/src/backend/change_detection/objects/
ray_object_change_detector.cpp:62-163: per (re-)observed static object, query
subsampled mesh vertices before first_seen and after last_seen through the
verificator, merge evidence, run the windowed detector both directions),
RayBackgroundChangeDetector (background/ray_background_change_detector.cpp:
59-103: per background vertex, rays after last-seen -> {Unobserved,
Persistent, Absent}), and SequentialChangeDetector
(sequential_change_detector.cpp:76-102: composes verificator + detectors,
full recompute on loop closure, incremental otherwise).

ALL objects' subsampled vertices go through ONE verificator query (object
ids are a segment vector); the per-object vote histograms come from an
integer segment sum on the device; the windowed scans run batched over
objects and over all background vertices at once. The device work runs on
`device`: CUDA unless the caller passes device="cpu".
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from khronos_tpu_torch import resolve_device
from khronos_tpu_torch.changes.change_detector import RayChangeDetector, RayChangeDetectorConfig
from khronos_tpu_torch.changes.change_state import ABSENT, PERSISTENT, UNOBSERVED, Changes, ObjectChange
from khronos_tpu_torch.changes.ray_verificator import RayVerificator, RayVerificatorConfig
from khronos_tpu_torch.geometry.bbox import BboxGrid
from khronos_tpu_torch.utils.timing import Timer


@dataclasses.dataclass
class ObjectChangeDetectionConfig:
    vertex_subsample: int = 32  # mesh vertices queried per object
    time_filtering_threshold: float = 1.0  # s slack around first/last seen
    # pull query points toward the object centroid (m): surface vertices sit
    # up to a voxel OUTSIDE the true surface (marching-cubes bias), where
    # rays grazing the silhouette edge within radial_tolerance read as
    # phantom absence. A true removal still puts every inset point on ray
    # paths. Capped at 40% of each vertex's distance to the centroid.
    query_inset: float = 0.1
    # identity-split veto: an absent verdict is suppressed when a
    # same-class object spatially coincident with the scanned one was
    # observed during the claimed absence — the "absence" is then an
    # unmerged re-extraction twin (fragment/whole pairs fail the merge-IoU
    # gate), not a physical change. Mirrors the reference's merge-record
    # presence semantics (reconciler.cpp:250-318) without adding merge
    # factors to the graph. Overlap = bbox intersection over the SMALLER
    # box's volume, so a fragment contained in the whole scores ~1.
    # An APPEARANCE claim ("absent at time T, first seen later") is only
    # vetoed by a twin whose observation interval reaches T itself; a
    # DISAPPEARANCE claim covers [T, inf), so a twin observed at ANY t >= T
    # contradicts it. Overlap threshold 0.5 so adjacent same-class
    # neighbors do not read as identity twins.
    twin_presence_veto: bool = True
    twin_overlap_threshold: float = 0.5
    # per-object radial tolerance bounded by the object's own thinnest
    # extent (floor 3 cm): with the global tolerance (0.1 m) alone, rays
    # that genuinely MISS a 5 cm pole or shelf board but pass within 0.1 m
    # of its surface points read phantom absence through PRESENT geometry
    adaptive_radial_tolerance: bool = True


@dataclasses.dataclass
class BackgroundChangeDetectionConfig:
    time_filtering_threshold: float = 1.0  # s after last_seen


def _votes_device(ev: torch.Tensor, seg: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Per-object vote aggregation on device: [chunk, B, 2] evidence ->
    [num_segments, B, 2] point-vote counts (a point votes once per bin/class
    when it has ANY evidence there), an integer segment sum. Padding rows
    carry segment id num_segments-1 and are dropped by the caller."""
    votes = (ev > 0).to(torch.int32)
    out = torch.zeros((num_segments,) + tuple(votes.shape[1:]), dtype=torch.int32, device=ev.device)
    return out.index_add_(0, seg.long(), votes)


@dataclasses.dataclass
class SequentialChangeDetectorConfig:
    verificator: RayVerificatorConfig = dataclasses.field(default_factory=RayVerificatorConfig)
    detector: RayChangeDetectorConfig = dataclasses.field(default_factory=RayChangeDetectorConfig)
    objects: ObjectChangeDetectionConfig = dataclasses.field(default_factory=ObjectChangeDetectionConfig)
    background: BackgroundChangeDetectionConfig = dataclasses.field(default_factory=BackgroundChangeDetectionConfig)
    detect_object_changes: bool = True
    detect_background_changes: bool = True
    # Incremental background pass (reference ray_background_change_detector
    # cpp:59-103: recompute only new + re-observed vertices; full recompute on
    # loop closure). Valid because the backend mesh is append-only with frozen
    # per-vertex stamps between optimizations; any optimization (dsg.opt_epoch
    # change) or loop closure forces the full pass.
    incremental_background: bool = True


class SequentialChangeDetector:
    """Runs change detection over a DSG snapshot; holds the Changes state.

    device: where the ray library, the queries and the scans live; CUDA
    unless the caller passes device="cpu" (raises when no GPU is visible)."""

    def __init__(self, config: SequentialChangeDetectorConfig, device=None):
        self.config = config
        self.device = resolve_device(device)
        self.verificator = RayVerificator(config.verificator, device=self.device)
        self.detector = RayChangeDetector(
            config.detector, config.verificator.temporal_resolution, device=self.device
        )
        self.changes = Changes()
        # incremental-background cache: states of the previous pass, the
        # vertex count they cover, and the optimization epoch they were
        # computed under (epoch change => vertex positions moved => full pass)
        self._bg_states: Optional[np.ndarray] = None
        self._bg_epoch = None
        # incremental-object cache (reference updateDsg re-observed-object
        # reporting, ray_verificator.cpp:163-182): per object, the
        # observation envelope it was last scanned with, plus the vertex
        # count and epoch of the previous pass. An object re-runs detection
        # only if new rays touched its hash cells or its envelope changed.
        self._obj_known: Dict[int, tuple] = {}
        self._obj_prev_V: Optional[int] = None
        self._obj_epoch = None
        # full-rebuild counter the incremental gates key on: after a full
        # library (re)build, "rays targeting new vertices" no longer covers
        # what changed — EVERY ray is new — so incremental gating must reset
        self._gate_builds = -1

    # ------------------------------------------------------------------
    def detect_changes(self, dsg, had_loop_closure: bool = True, merges=None) -> Changes:
        """Pass over the snapshot: hash rebuild + object pass are always full
        (the build is one device sort; objects are few); the background pass
        is incremental between loop closures / optimizations, matching the
        reference (sequential_change_detector.cpp:76-102: full recompute on
        LC, incremental otherwise). `merges` are GNC-validated proposals the
        object pass adopts (ray_object_change_detector.cpp:104-115)."""
        with Timer("change_detection/all"):
            with Timer("change_detection/update_verificator"):
                # incremental updateDsg between loop closures (delta index
                # over new-vertex rays); full recomputeHash on LC/epoch
                # change (ray_verificator.cpp:163-182, 316-325)
                self.verificator.update(dsg, had_loop_closure)
            epoch = getattr(dsg, "opt_epoch", None)
            rebuilt = self.verificator.n_full_builds != self._gate_builds
            if self.config.detect_object_changes:
                with Timer("change_detection/objects"):
                    self._adopt_merges(merges)
                    # LC is advisory: the geometry epoch is the real
                    # "geometry moved" signal (see ray_verificator.update)
                    full_obj = (
                        rebuilt
                        or (had_loop_closure and epoch is None)
                        or self._obj_prev_V is None
                        or epoch is None
                        or epoch != self._obj_epoch
                        or dsg.mesh.num_vertices < self._obj_prev_V
                    )
                    self._detect_object_changes(dsg, full=full_obj)
                    self._obj_epoch = epoch
            if self.config.detect_background_changes:
                with Timer("change_detection/background"):
                    self._detect_background_changes(
                        dsg, had_loop_closure, force_full=rebuilt
                    )
            self._obj_prev_V = dsg.mesh.num_vertices
            self._gate_builds = self.verificator.n_full_builds
        return self.changes

    # ------------------------------------------------------------------
    def _adopt_merges(self, merges) -> None:
        """Adopt validated merges: record merged_id on the absorbed object's
        change record; detection then skips it (the surviving object carries
        the evidence) — reference ray_object_change_detector.cpp:104-115.
        The survivor also inherits the absorbed twins' observation intervals
        (`_merge_sources`): its pre/post scan windows must exclude any time
        the merged-set was observed, else rays cast through the twin's
        occupied space read as absence and hallucinate a change (reference
        merge-record union semantics, reconciler.cpp:250-318)."""
        self._merged_away = set()
        self._merge_sources: Dict[int, List[int]] = {}
        for m in merges or ():
            if not getattr(m, "is_valid", True):
                continue
            oc = self.changes.object_changes.get(m.from_id) or ObjectChange(m.from_id)
            oc.merged_id = m.into_id
            self.changes.object_changes[m.from_id] = oc
            self._merged_away.add(m.from_id)
            self._merge_sources.setdefault(m.into_id, []).append(m.from_id)

    def _object_points(self, o, cfg) -> np.ndarray:
        """Subsampled world-frame query points for one object."""
        verts = o.world_mesh_vertices()
        if len(verts) == 0:
            # fall back to bbox corners + center
            mn, mx = o.bbox_min, o.bbox_max
            verts = np.stack(
                [mn, mx, [mn[0], mn[1], mx[2]], [mn[0], mx[1], mn[2]],
                 [mx[0], mn[1], mn[2]], 0.5 * (mn + mx)]
            ).astype(np.float32)
        if len(verts) > cfg.vertex_subsample:
            sel = np.linspace(0, len(verts) - 1, cfg.vertex_subsample).astype(int)
            verts = verts[sel]
        verts = np.asarray(verts, np.float32)
        if cfg.query_inset > 0 and len(verts) > 1:
            c = verts.mean(axis=0)
            d = verts - c
            n = np.linalg.norm(d, axis=1, keepdims=True)
            shrink = np.minimum(cfg.query_inset, 0.4 * n)
            verts = verts - d / np.maximum(n, 1e-6) * shrink
        return verts

    def _detect_object_changes(self, dsg, full: bool = True) -> None:
        cfg = self.config.objects
        merged_away = getattr(self, "_merged_away", set())
        merge_sources = getattr(self, "_merge_sources", {})
        objs = [
            o for o in dsg.objects.values()
            if not o.is_dynamic and o.node_id not in merged_away
        ]
        if not objs:
            return
        # observation envelope over each object AND its absorbed twins:
        # the merged set is one physical object, so scan windows start
        # before the EARLIEST first-seen / after the LATEST last-seen
        env: Dict[int, tuple] = {}
        for o in objs:
            first_ns = o.first_observed_ns[0]
            last_ns = o.last_observed_ns[-1]
            for sid in merge_sources.get(o.node_id, ()):
                s = dsg.objects.get(sid)
                if s is not None:
                    first_ns = min(first_ns, s.first_observed_ns[0])
                    last_ns = max(last_ns, s.last_observed_ns[-1])
            env[o.node_id] = (first_ns, last_ns)

        with Timer("change_detection/objects_points"):
            obj_pts = {o.node_id: self._object_points(o, cfg) for o in objs}

        # incremental re-detection (reference ray_verificator.cpp:163-182):
        # between loop closures / optimizations only objects whose hash
        # cells were touched by rays targeting NEW vertices — or whose
        # envelope changed — can gain evidence; everything else keeps its
        # previous ObjectChange record.
        if full or self._obj_prev_V is None:
            scan = objs
        else:
            touched = self.verificator.touched_cells_for_new_targets(self._obj_prev_V)
            scan = []
            for o in objs:
                if self._obj_known.get(o.node_id) != env[o.node_id]:
                    scan.append(o)
                    continue
                cells = self.verificator.point_cells(obj_pts[o.node_id])
                ok = cells >= 0
                if len(touched) and ok.any() and touched[cells[ok]].any():
                    scan.append(o)
        if not scan:
            return

        pts_all = [obj_pts[o.node_id] for o in scan]
        seg = np.concatenate(
            [np.full(len(p), k) for k, p in enumerate(pts_all)]
        )
        points = np.concatenate(pts_all).astype(np.float32)
        tol = None
        if cfg.adaptive_radial_tolerance:
            base = self.verificator.config.radial_tolerance
            tol = np.concatenate([
                np.full(
                    len(p),
                    np.clip(
                        0.5 * float(
                            np.min(np.asarray(o.bbox_max) - np.asarray(o.bbox_min))
                        ),
                        0.03, base,
                    ),
                    np.float32,
                )
                for o, p in zip(scan, pts_all)
            ])
        with Timer("change_detection/objects_query"):
            ev_chunks, n_pts = self.verificator.query(
                points, radial_tol=tol, as_chunks=True
            )
        if not ev_chunks:
            # zero evidence (library unbuilt): still RECORD fresh empty
            # records, mirroring the zero-evidence recompute of a populated
            # pass — an early return would preserve stale decisions.
            # _obj_known is NOT updated: marking envelopes as scanned while
            # the library is unbuilt would let the incremental gate skip
            # these objects after the first real build (the rebuild counter
            # also forces the next pass full).
            for o in scan:
                prev = self.changes.object_changes.get(o.node_id)
                oc = ObjectChange(o.node_id)
                if prev is not None:
                    oc.merged_id = prev.merged_id
                self.changes.object_changes[o.node_id] = oc
            return
        B = ev_chunks[0].shape[1]
        # per-object evidence: each query POINT casts at most one vote per
        # bin and class, and the scan thresholds are fractions of VOTING
        # POINTS (a couple of silhouette-grazing rays through one edge
        # point must not dominate). Aggregation runs ON DEVICE per chunk
        # (an integer segment sum over a pow2-bucketed object count).
        n_bucket = max(64, 1 << int(np.ceil(np.log2(max(len(scan), 1)))))
        chunk = int(ev_chunks[0].shape[0])  # query() sizes chunks by workload
        seg_pad = np.full(len(ev_chunks) * chunk, n_bucket, np.int32)
        seg_pad[:n_pts] = seg
        seg_dev = torch.from_numpy(seg_pad).to(self.device)
        with Timer("change_detection/objects_votes"):
            votes = sum(
                _votes_device(ev_c, seg_dev[k * chunk: (k + 1) * chunk], n_bucket + 1)
                for k, ev_c in enumerate(ev_chunks)
            )
            obj_ev = votes[: len(scan)].cpu().numpy().astype(np.int64)  # one pull

        origin = self.verificator.bin_origin_s
        thr = cfg.time_filtering_threshold
        first_s = np.asarray([env[o.node_id][0] for o in scan]) * 1e-9
        last_s = np.asarray([env[o.node_id][1] for o in scan]) * 1e-9
        # ONE batched device scan per direction for ALL scanned objects
        # (per-row valid masks)
        with Timer("change_detection/objects_scan"):
            pre = self.detector.scan(
                obj_ev, -np.inf, first_s - thr, origin_s=origin
            )
            post = self.detector.scan(
                obj_ev, last_s + thr, np.inf, origin_s=origin
            )
        # spatial bucket over ALL candidate twins: per-object veto cost is
        # O(neighbors-in-cell), flat as object counts grow
        twin_grid = None
        if cfg.twin_presence_veto:
            with Timer("change_detection/objects_veto_grid"):
                mns = np.stack([obj_pts[q.node_id].min(axis=0) for q in objs])
                mxs = np.stack([obj_pts[q.node_id].max(axis=0) for q in objs])
                twin_grid = BboxGrid(mns, mxs)
        for k, o in enumerate(scan):
            self._obj_known[o.node_id] = env[o.node_id]
            # each (re)scan RECOMPUTES the record from the full evidence
            # history (reference rebuilds the ObjectChange per pass,
            # ray_object_change_detector.cpp:62-163). merged_id survives.
            prev = self.changes.object_changes.get(o.node_id)
            oc = ObjectChange(o.node_id)
            if prev is not None:
                oc.merged_id = prev.merged_id
            # BEFORE window: latest absent window before first seen; the
            # persistent time must come AFTER it (reference ObjectChange
            # ordering first_absent -> first_persistent -> first_seen,
            # change_state.h:76-103)
            if not np.isnan(pre["last_absent_s"][k]):
                oc.first_absent_ns = int(pre["last_absent_s"][k] * 1e9)
            if not np.isnan(pre["first_persistent_after_absent_s"][k]):
                oc.first_persistent_ns = int(
                    pre["first_persistent_after_absent_s"][k] * 1e9
                )
            # AFTER window: earliest absent window after last seen; the
            # persistent time must come BEFORE it (... last_seen ->
            # last_persistent -> last_absent)
            if not np.isnan(post["first_absent_s"][k]):
                oc.last_absent_ns = int(post["first_absent_s"][k] * 1e9)
            if not np.isnan(post["last_persistent_before_absent_s"][k]):
                oc.last_persistent_ns = int(
                    post["last_persistent_before_absent_s"][k] * 1e9
                )
            if cfg.twin_presence_veto and (
                oc.first_absent_ns >= 0 or oc.last_absent_ns >= 0
            ):
                self._veto_identity_splits(
                    o, oc, objs, env, obj_pts, cfg, twin_grid
                )
            self.changes.object_changes[o.node_id] = oc

    def _veto_identity_splits(self, o, oc, objs, env, obj_pts, cfg, grid=None) -> None:
        """Suppress absent verdicts contradicted by a same-class, spatially
        coincident object observed during the claimed absence (see
        twin_presence_veto). `grid` is an optional BboxGrid over `objs`
        limiting the scan to spatial-neighbor candidates."""
        pts_o = obj_pts[o.node_id]
        mn_o, mx_o = pts_o.min(axis=0), pts_o.max(axis=0)
        vol_o = float(np.prod(np.maximum(mx_o - mn_o, 1e-3)))
        thr_ns = int(cfg.time_filtering_threshold * 1e9)
        if grid is not None:
            cand = [objs[i] for i in grid.candidates(mn_o, mx_o)]
        else:
            cand = objs
        for p in cand:
            if p.node_id == o.node_id or p.semantic_category != o.semantic_category:
                continue
            pf, pl = env[p.node_id]
            pts_p = obj_pts[p.node_id]
            mn_p, mx_p = pts_p.min(axis=0), pts_p.max(axis=0)
            inter = np.maximum(
                np.minimum(mx_o, mx_p) - np.maximum(mn_o, mn_p), 0.0
            )
            vol_p = float(np.prod(np.maximum(mx_p - mn_p, 1e-3)))
            if float(np.prod(inter)) / min(vol_o, vol_p) < cfg.twin_overlap_threshold:
                continue
            # disappearance claimed from last_absent_ns ON (the claim covers
            # [T, inf)): a twin observed at ANY t >= T - thr contradicts it
            if oc.last_absent_ns >= 0 and pl >= oc.last_absent_ns - thr_ns:
                oc.last_absent_ns = -1
            # appearance claimed (absent until first_absent_ns), but only a
            # twin whose presence REACHES the claimed absence time accounts
            # for it
            if (
                oc.first_absent_ns >= 0
                and pf <= oc.first_absent_ns + thr_ns
                and pl >= oc.first_absent_ns - thr_ns
            ):
                oc.first_absent_ns = -1
            if oc.first_absent_ns < 0 and oc.last_absent_ns < 0:
                return

    # ------------------------------------------------------------------
    def _detect_background_changes(
        self, dsg, had_loop_closure: bool = True, force_full: bool = False
    ) -> None:
        cfg = self.config.background
        mesh = dsg.mesh
        V = mesh.num_vertices
        if V == 0:
            self.changes.background_states = np.zeros((0,), np.int8)
            return
        epoch = getattr(dsg, "opt_epoch", None)
        prev = self._bg_states
        full = (
            force_full
            or not self.config.incremental_background
            or (had_loop_closure and epoch is None)
            or prev is None
            or epoch is None
            or epoch != self._bg_epoch
            or V < len(prev)
        )
        if full:
            sel = np.arange(V)
            states = np.full(V, UNOBSERVED, np.int8)
        else:
            # incremental: previous states stay valid except for (a) new
            # vertices and (b) old vertices in hash cells traversed by rays
            # targeting new vertices (the only new rays between passes)
            Vp = len(prev)
            touched = self.verificator.touched_cells_for_new_targets(Vp)
            cells = self.verificator.point_cells(mesh.vertices[:Vp])
            re_obs = np.zeros(Vp, bool)
            ok = cells >= 0
            re_obs[ok] = touched[cells[ok]]
            sel = np.concatenate([np.nonzero(re_obs)[0], np.arange(Vp, V)])
            states = np.concatenate([prev, np.full(V - Vp, UNOBSERVED, np.int8)])
            if len(sel) == 0:
                self.changes.background_states = states
                self._bg_states = states
                return
        with Timer("change_detection/background_query"):
            # evidence stays ON DEVICE between query and scan (chunk lists)
            ev_chunks, n_pts = self.verificator.query(
                mesh.vertices[sel], as_chunks=True
            )
        if not ev_chunks:
            self.changes.background_states = states
            self._bg_states = states
            self._bg_epoch = epoch
            return
        origin = self.verificator.bin_origin_s
        last_seen_s = mesh.last_seen_ns[sel].astype(np.float64) * 1e-9
        # per-vertex window: only bins after each vertex's last_seen (+
        # slack) — expressed as per-row scan bounds (one device call)
        with Timer("change_detection/background_scan"):
            res = self.detector.scan(
                ev_chunks,
                last_seen_s + cfg.time_filtering_threshold,
                np.inf,
                origin_s=origin,
                n_valid=n_pts,
            )
        sel_states = np.full(len(sel), UNOBSERVED, np.int8)
        has_absent = res["first_absent_bin"] >= 0
        has_persist = res["first_persistent_bin"] >= 0
        sel_states[has_persist] = PERSISTENT
        sel_states[has_absent] = ABSENT  # absence evidence wins (vertex is gone)
        states[sel] = sel_states
        self.changes.background_states = states
        self._bg_states = states
        self._bg_epoch = epoch
