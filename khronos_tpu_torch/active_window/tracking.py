"""Frame-to-frame multi-object tracking (max-IoU association).

Equivalent of the reference MaxIoUTracker (khronos/src/active_window/tracking/
max_iou_tracker.cpp): dynamic tracks associate by nearest centroid within
`max_dynamic_distance` (cpp:230-279); semantic clusters first match dynamic
tracks by cross-IoU >= min_cross_iou (cpp:281-333), the rest greedily by
max IoU >= min_semantic_iou with a same-category gate (cpp:100-130); IoU over
voxelized cluster points at the tracker voxel size (cpp:551-562); confidence
= min(n_obs / (2 * min_num_observations), 1) (cpp:514-515); tracks go inactive
after `temporal_window` without observation (cpp:518-524).

Also provides ExternalTracker (external_tracker.cpp:85-114): trivial exact-id
association when upstream supplies stable instance ids.

Host-side bookkeeping over small per-frame cluster sets (the device produced
the clusters; tracking is pointer-chasing the reference also does on CPU).

Unchanged host-numpy copy of `khronos_tpu/active_window/tracking.py`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from khronos_tpu_torch.config import check_ge, check_gt, register


@dataclasses.dataclass
class Observation:
    stamp_ns: int
    semantic_cluster_id: int = 0  # 0 = none (ids are 1-based in images)
    dynamic_cluster_id: int = 0
    centroid: Optional[np.ndarray] = None  # [3] world
    bbox_min: Optional[np.ndarray] = None
    bbox_max: Optional[np.ndarray] = None


@dataclasses.dataclass
class Track:
    """Mirrors khronos::Track (track.h:74-112)."""

    track_id: int
    first_seen_ns: int
    last_seen_ns: int
    observations: List[Observation] = dataclasses.field(default_factory=list)
    last_voxels: Set[int] = dataclasses.field(default_factory=set)
    last_points: Optional[np.ndarray] = None  # [K, 3] subsample
    last_bbox_min: Optional[np.ndarray] = None
    last_bbox_max: Optional[np.ndarray] = None
    last_centroid: Optional[np.ndarray] = None
    semantic_category: int = -1
    category_votes: Dict[int, int] = dataclasses.field(default_factory=dict)
    feature: Optional[np.ndarray] = None  # open-set embedding
    is_dynamic: bool = False
    is_active: bool = True
    velocity: Optional[np.ndarray] = None  # [3] m/s EMA (dynamic tracks)

    def predicted_centroid(self, stamp_ns: int) -> Optional[np.ndarray]:
        """Constant-velocity extrapolation of the centroid to stamp_ns."""
        if self.last_centroid is None:
            return None
        if self.velocity is None:
            return self.last_centroid
        dt = (stamp_ns - self.last_seen_ns) * 1e-9
        return self.last_centroid + self.velocity * dt

    def confidence(self, min_num_observations: int) -> float:
        n = len(self.observations)
        return min(n / max(2.0 * min_num_observations, 1.0), 1.0)

    def vote_category(self, category: int):
        if category < 0:
            return
        self.category_votes[category] = self.category_votes.get(category, 0) + 1
        self.semantic_category = max(self.category_votes.items(), key=lambda kv: kv[1])[0]


def encode_voxels(points: np.ndarray, voxel_size: float) -> Set[int]:
    """Quantize points [N,3] to a set of packed int64 voxel keys."""
    if len(points) == 0:
        return set()
    q = np.floor(points / voxel_size).astype(np.int64) + (1 << 20)
    keys = (q[:, 0] << 42) | (q[:, 1] << 21) | q[:, 2]
    return set(keys.tolist())


def voxel_iou(a: Set[int], b: Set[int]) -> float:
    if not a or not b:
        return 0.0
    inter = len(a & b)
    union = len(a) + len(b) - inter
    return inter / union if union else 0.0


@register("tracker", "MaxIouTracker")
@dataclasses.dataclass
class MaxIouTrackerConfig:
    # 'pixels' reprojects both geometries' points into the current frame
    # (reference max_iou_tracker.cpp:564-587); needs a camera (set by the
    # active window) and a valid frame pose.
    track_by: str = "voxels"  # 'voxels' | 'bounding_box' | 'pixels'
    # greedy association order for semantic clusters (cpp:323-332):
    #   'global'         best pair first over all (track, cluster) pairs
    #   'assign_cluster' per track (ascending id), best remaining cluster
    #   'assign_track'   per cluster (ascending id), best remaining track
    assignment_strategy: str = "global"
    min_semantic_iou: float = 0.25
    min_cross_iou: float = 0.1
    voxel_size: float = 0.2  # m (tracker re-voxelization, uHumans2.yaml:75)
    temporal_window: float = 3.0  # s
    min_num_observations: int = 15
    max_dynamic_distance: float = 1.0  # m
    min_cosine_sim: float = 0.8  # open-set gate
    max_track_points: int = 512  # subsample cap per track
    pixel_cell: int = 4  # px quantization for the 'pixels' IoU mode
    # beyond-reference: match dynamic clusters against the constant-velocity
    # PREDICTED track centroid instead of the stale last position — a human
    # at ~1 m/s exits the reference's 1 m gate within a second of occlusion,
    # fragmenting trajectories (measured on the synthetic office)
    predict_dynamic_motion: bool = True

    def check(self):
        check_gt(self.voxel_size, 0.0, "voxel_size")
        check_ge(self.min_semantic_iou, 0.0, "min_semantic_iou")
        if self.track_by not in ("voxels", "bounding_box", "pixels"):
            raise ValueError(f"track_by={self.track_by} not supported")
        if self.assignment_strategy not in ("global", "assign_cluster", "assign_track"):
            raise ValueError(f"assignment_strategy={self.assignment_strategy}")

    def create(self):
        return MaxIouTracker(self)


def _bbox_iou(amin, amax, bmin, bmax) -> float:
    lo = np.maximum(amin, bmin)
    hi = np.minimum(amax, bmax)
    inter = float(np.prod(np.clip(hi - lo, 0, None)))
    va = float(np.prod(np.clip(amax - amin, 0, None)))
    vb = float(np.prod(np.clip(bmax - bmin, 0, None)))
    union = va + vb - inter
    return inter / union if union > 0 else 0.0


class MaxIouTracker:
    def __init__(self, config: MaxIouTrackerConfig):
        self.config = config
        self.tracks: List[Track] = []
        self._next_id = 1

    # ------------------------------------------------------------------
    def process(self, frame, points_w: np.ndarray = None, cluster_points=None) -> List[Track]:
        """Associate this frame's clusters with tracks; returns tracks that
        just went inactive (ready for object extraction).

        Either points_w ([H, W, 3] numpy vertex image; per-cluster points are
        pulled from the id images) or cluster_points ((dyn_points, sem_points)
        dicts id -> [K, 3] device-subsampled points from the fused step — the
        zero-image-pull fast path) must be provided.
        """
        cfg = self.config
        stamp_ns = frame.stamp_ns
        self._cur_pose = (np.asarray(frame.R_w_c), np.asarray(frame.t_w_c))
        if cluster_points is not None:
            dyn_pts, sem_pts = cluster_points
            dyn_data = self._cluster_geometry_from_points(frame.dynamic_clusters, dyn_pts)
            sem_data = self._cluster_geometry_from_points(frame.semantic_clusters, sem_pts)
        else:
            dyn_img = np.asarray(frame.dynamic_image) if frame.dynamic_image is not None else None
            obj_img = np.asarray(frame.object_image) if frame.object_image is not None else None
            dyn_data = self._cluster_geometry(dyn_img, frame.dynamic_clusters, points_w)
            sem_data = self._cluster_geometry(obj_img, frame.semantic_clusters, points_w)

        # 1) dynamic clusters <-> dynamic tracks by nearest centroid
        assigned_dyn_tracks: Dict[int, int] = {}  # cluster_id -> track idx
        free_dyn = set(d.cluster_id for d in frame.dynamic_clusters)
        pairs = []
        for ti, tr in enumerate(self.tracks):
            if not (tr.is_active and tr.is_dynamic) or tr.last_centroid is None:
                continue
            ref_c = (
                tr.predicted_centroid(stamp_ns)
                if cfg.predict_dynamic_motion
                else tr.last_centroid
            )
            for d in frame.dynamic_clusters:
                dist = float(np.linalg.norm(d.centroid - ref_c))
                if dist <= cfg.max_dynamic_distance:
                    pairs.append((dist, ti, d.cluster_id))
        used_tracks = set()
        for dist, ti, cid in sorted(pairs):
            if ti in used_tracks or cid not in free_dyn:
                continue
            used_tracks.add(ti)
            free_dyn.discard(cid)
            assigned_dyn_tracks[cid] = ti
            self._update_track(self.tracks[ti], stamp_ns, dyn_data[cid], dynamic_cluster_id=cid)

        # 2) unassigned dynamic clusters -> new dynamic tracks — UNLESS the
        # cluster sits within max_dynamic_distance of an agent already
        # claimed this frame: the detector can split one body across depth
        # edges into several clusters, and a fresh track per fragment rides
        # along as a concurrent duplicate trajectory of the same human
        # (r5 office bench: 24 of 25 dynamic objects were 3-6x duplicate
        # tracks of the 2 humans, dynamic precision 0.47). Association is
        # one-to-one, so only the nearest fragment feeds the track; the
        # rest are absorbed here, mirroring the reference's pairwise
        # cluster merging (free_space_motion_detector.cpp:274-355).
        # claimed agents this frame: (centroid, bbox_min, bbox_max) of the
        # cluster each updated track consumed
        claimed = [
            (dyn_data[cid][4], dyn_data[cid][2], dyn_data[cid][3])
            for cid, ti in assigned_dyn_tracks.items()
        ]
        # biggest fragment first becomes the track; dyn_data rows are
        # (voxels, points, bbox_min, bbox_max, centroid)
        order = sorted(free_dyn, key=lambda cid: -len(dyn_data[cid][1]))
        margin = 0.1  # m bbox slack for abutting fragments
        for cid in order:
            c, bmin, bmax = dyn_data[cid][4], dyn_data[cid][2], dyn_data[cid][3]
            absorbed = False
            if c is not None and bmin is not None:
                for qc, qmin, qmax in claimed:
                    if qc is None or qmin is None:
                        continue
                    # fragment = near AND spatially overlapping the claimed
                    # agent's extent; centroid distance alone also swallowed
                    # a genuinely separate agent walking < 1 m alongside
                    # (r5 review finding)
                    near = float(np.linalg.norm(c - qc)) <= cfg.max_dynamic_distance
                    overlap = bool(
                        np.all(bmin <= np.asarray(qmax) + margin)
                        and np.all(np.asarray(qmin) <= bmax + margin)
                    )
                    if near and overlap:
                        absorbed = True
                        break
            if absorbed:
                continue  # fragment of an already-tracked agent
            tr = self._new_track(stamp_ns, dyn_data[cid], is_dynamic=True, dynamic_cluster_id=cid)
            assigned_dyn_tracks[cid] = self.tracks.index(tr)
            claimed.append((c, bmin, bmax))

        # 3) semantic clusters vs dynamic tracks (cross-IoU)
        free_sem = set(s.cluster_id for s in frame.semantic_clusters)
        for s in frame.semantic_clusters:
            best_iou, best_ti = 0.0, -1
            for cid, ti in assigned_dyn_tracks.items():
                iou = self._iou(sem_data[s.cluster_id], dyn_data[cid])
                if iou > best_iou:
                    best_iou, best_ti = iou, ti
            if best_ti >= 0 and best_iou >= cfg.min_cross_iou:
                tr = self.tracks[best_ti]
                if tr.observations and tr.observations[-1].stamp_ns == stamp_ns:
                    tr.observations[-1].semantic_cluster_id = s.cluster_id
                tr.vote_category(s.category_id)
                if s.feature is not None:
                    tr.feature = s.feature
                free_sem.discard(s.cluster_id)

        # 4) remaining semantic clusters vs static semantic tracks (max IoU);
        # greedy order per assignment_strategy (reference cpp:323-332)
        sem_pairs = []
        sem_by_id = {s.cluster_id: s for s in frame.semantic_clusters}
        for ti, tr in enumerate(self.tracks):
            if not tr.is_active or tr.is_dynamic:
                continue
            for cid in free_sem:
                s = sem_by_id[cid]
                if not self._category_match(tr, s):
                    continue
                iou = self._iou(sem_data[cid], self._track_geometry(tr))
                if iou >= cfg.min_semantic_iou:
                    sem_pairs.append((iou, ti, cid))
        if cfg.assignment_strategy == "global":
            order = sorted(sem_pairs, reverse=True)
        elif cfg.assignment_strategy == "assign_cluster":
            # per track (ascending id): its best remaining cluster first
            order = sorted(sem_pairs, key=lambda p: (p[1], -p[0]))
        else:  # assign_track: per cluster (ascending id), best track first
            order = sorted(sem_pairs, key=lambda p: (p[2], -p[0]))
        used_tracks = set()
        for iou, ti, cid in order:
            if ti in used_tracks or cid not in free_sem:
                continue
            used_tracks.add(ti)
            free_sem.discard(cid)
            s = sem_by_id[cid]
            self._update_track(self.tracks[ti], stamp_ns, sem_data[cid], semantic_cluster_id=cid)
            self.tracks[ti].vote_category(s.category_id)
            if s.feature is not None:
                self.tracks[ti].feature = s.feature

        # 5) unassigned semantic clusters -> new static tracks
        for cid in sorted(free_sem):
            s = sem_by_id[cid]
            tr = self._new_track(stamp_ns, sem_data[cid], is_dynamic=False, semantic_cluster_id=cid)
            tr.vote_category(s.category_id)
            if s.feature is not None:
                tr.feature = s.feature

        # 6) deactivate stale tracks
        finished = []
        horizon_ns = int(cfg.temporal_window * 1e9)
        for tr in self.tracks:
            if tr.is_active and stamp_ns - tr.last_seen_ns > horizon_ns:
                tr.is_active = False
                finished.append(tr)
        return finished

    def finish(self) -> List[Track]:
        """Deactivate everything (finishMapping flush)."""
        finished = [t for t in self.tracks if t.is_active]
        for t in finished:
            t.is_active = False
        return finished

    def active_tracks(self) -> List[Track]:
        return [t for t in self.tracks if t.is_active]

    def referenced_stamps(self) -> set:
        """Frame stamps any active track references (frame buffer trimming)."""
        out = set()
        for t in self.tracks:
            if t.is_active:
                out.update(o.stamp_ns for o in t.observations)
        return out

    # ------------------------------------------------------------------
    def _cluster_geometry(self, id_image, clusters, points_w):
        """Per-cluster (voxels, points, bbox, centroid) from the id image."""
        out = {}
        for c in clusters:
            if id_image is None:
                out[c.cluster_id] = (set(), np.zeros((0, 3)), c.bbox_min, c.bbox_max, c.centroid)
                continue
            mask = id_image == c.cluster_id
            pts = points_w[mask]
            if len(pts) > self.config.max_track_points:
                sel = np.linspace(0, len(pts) - 1, self.config.max_track_points).astype(int)
                pts = pts[sel]
            vox = encode_voxels(pts, self.config.voxel_size)
            out[c.cluster_id] = (vox, pts, c.bbox_min, c.bbox_max, c.centroid)
        return out

    def _cluster_geometry_from_points(self, clusters, points_by_id):
        """Cluster geometry from device-subsampled points (fused path)."""
        out = {}
        for c in clusters:
            pts = np.asarray(points_by_id.get(c.cluster_id, np.zeros((0, 3))))
            vox = encode_voxels(pts, self.config.voxel_size)
            out[c.cluster_id] = (vox, pts, c.bbox_min, c.bbox_max, c.centroid)
        return out

    def _track_geometry(self, tr: Track):
        return (tr.last_voxels, tr.last_points, tr.last_bbox_min, tr.last_bbox_max, tr.last_centroid)

    def _iou(self, a, b) -> float:
        if self.config.track_by == "voxels":
            return voxel_iou(a[0], b[0])
        if self.config.track_by == "pixels":
            return voxel_iou(self._pixel_keys(a[1]), self._pixel_keys(b[1]))
        return _bbox_iou(a[2], a[3], b[2], b[3])

    def set_camera(self, camera) -> None:
        """Needed only by track_by='pixels' (reprojection IoU)."""
        self._camera = camera

    def _pixel_keys(self, pts_w: np.ndarray) -> Set[int]:
        """Project world points into the CURRENT frame; quantized pixel keys
        (reference pixel-IoU: reproject last points, cpp:564-587)."""
        cam = getattr(self, "_camera", None)
        pose = getattr(self, "_cur_pose", None)
        if cam is None or pose is None or len(pts_w) == 0:
            return set()
        R, t = pose
        pc = (np.asarray(pts_w) - t) @ R  # world -> camera (R column-major^T)
        z = pc[:, 2]
        ok = z > 1e-6
        if not ok.any():
            return set()
        cell = max(1, self.config.pixel_cell)
        u = (pc[ok, 0] / z[ok] * cam.fx + cam.cx).astype(np.int64) // cell
        v = (pc[ok, 1] / z[ok] * cam.fy + cam.cy).astype(np.int64) // cell
        inb = (u >= 0) & (u < cam.width // cell + 1) & (v >= 0) & (v < cam.height // cell + 1)
        return set((v[inb] * 4096 + u[inb]).tolist())

    def _category_match(self, tr: Track, cluster) -> bool:
        if tr.feature is not None and cluster.feature is not None:
            na = np.linalg.norm(tr.feature)
            nb = np.linalg.norm(cluster.feature)
            if na > 0 and nb > 0:
                cos = float(np.dot(tr.feature, cluster.feature) / (na * nb))
                return cos >= self.config.min_cosine_sim
        if tr.semantic_category < 0 or cluster.category_id < 0:
            return True
        return tr.semantic_category == cluster.category_id

    def _update_track(self, tr: Track, stamp_ns, geom, semantic_cluster_id=0, dynamic_cluster_id=0):
        vox, pts, bmin, bmax, centroid = geom
        if tr.is_dynamic and tr.last_centroid is not None and stamp_ns > tr.last_seen_ns:
            dt = (stamp_ns - tr.last_seen_ns) * 1e-9
            v = (np.asarray(centroid) - tr.last_centroid) / dt
            tr.velocity = v if tr.velocity is None else 0.5 * tr.velocity + 0.5 * v
        tr.last_seen_ns = stamp_ns
        tr.observations.append(
            Observation(
                stamp_ns,
                semantic_cluster_id,
                dynamic_cluster_id,
                centroid=np.asarray(centroid),
                bbox_min=np.asarray(bmin),
                bbox_max=np.asarray(bmax),
            )
        )
        tr.last_voxels = vox
        tr.last_points = pts
        tr.last_bbox_min = np.asarray(bmin)
        tr.last_bbox_max = np.asarray(bmax)
        tr.last_centroid = np.asarray(centroid)

    def _new_track(self, stamp_ns, geom, is_dynamic, semantic_cluster_id=0, dynamic_cluster_id=0) -> Track:
        tr = Track(
            track_id=self._next_id,
            first_seen_ns=stamp_ns,
            last_seen_ns=stamp_ns,
            is_dynamic=is_dynamic,
        )
        self._next_id += 1
        self._update_track(tr, stamp_ns, geom, semantic_cluster_id, dynamic_cluster_id)
        self.tracks.append(tr)
        return tr


@register("tracker", "ExternalTracker")
@dataclasses.dataclass
class ExternalTrackerConfig:
    temporal_window: float = 3.0
    min_num_observations: int = 15
    voxel_size: float = 0.2
    max_track_points: int = 512

    def create(self):
        return ExternalTracker(self)


class ExternalTracker(MaxIouTracker):
    """Associate by exact upstream instance id (external_tracker.cpp:85-114).

    Semantic cluster ids are assumed stable across frames (frame.instances
    forwarded by the InstanceForwarding detector)."""

    def __init__(self, config: ExternalTrackerConfig):
        mcfg = MaxIouTrackerConfig(
            temporal_window=config.temporal_window,
            min_num_observations=config.min_num_observations,
            voxel_size=config.voxel_size,
            max_track_points=config.max_track_points,
        )
        super().__init__(mcfg)
        self._id_to_track: Dict[int, Track] = {}

    def process(self, frame, points_w: np.ndarray) -> List[Track]:
        stamp_ns = frame.stamp_ns
        obj_img = np.asarray(frame.object_image) if frame.object_image is not None else None
        sem_data = self._cluster_geometry(obj_img, frame.semantic_clusters, points_w)
        for s in frame.semantic_clusters:
            ext_id = s.cluster_id
            tr = self._id_to_track.get(ext_id)
            if tr is None or not tr.is_active:
                tr = self._new_track(stamp_ns, sem_data[ext_id], is_dynamic=False, semantic_cluster_id=ext_id)
                self._id_to_track[ext_id] = tr
            else:
                self._update_track(tr, stamp_ns, sem_data[ext_id], semantic_cluster_id=ext_id)
            tr.vote_category(s.category_id)
            if s.feature is not None:
                tr.feature = s.feature
        finished = []
        horizon_ns = int(self.config.temporal_window * 1e9)
        for tr in self.tracks:
            if tr.is_active and stamp_ns - tr.last_seen_ns > horizon_ns:
                tr.is_active = False
                finished.append(tr)
        return finished
