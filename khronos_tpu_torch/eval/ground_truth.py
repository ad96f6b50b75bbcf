"""Ground-truth builders: labeled scene clouds -> GT DSG + change annotations.

Equivalents of the reference khronos_eval/ground_truth/ suite:
  TesseGroundTruthBuilder (tesse_ground_truth_builder.h:37-110): color->label
    mapping, euclidean clustering of object-labeled points into GT instances,
    background cloud extraction, prune-to-observed via the observed DSG.
  TesseDynamicObjectGtBuilder / RealDynamicObjectGtBuilder: dynamic-object GT
    trajectories from per-time human point sets (sim) or annotation CSVs (real).
  GtConsolidator (gt_consolidator.{h,cpp}): merges per-change-time GT maps into
    one consolidated map with appear/disappear times + gt_changes.csv.

Port of `khronos_tpu/eval/ground_truth.py`: clustering is voxel-hash
union-find on the host (GT building is offline, pointer-heavy, and small),
while the point-to-point distance work (prune-to-observed) runs as batched
nearest distances through eval.evaluators.min_distances on `device` (CUDA
unless the caller passes device="cpu").
"""

from __future__ import annotations

import csv
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from khronos_tpu_torch.eval.evaluators import GtObject, min_distances
from khronos_tpu_torch.stm.scene_graph import KhronosObject, Mesh, SceneGraph

T_NEVER_APPEARED = -(1 << 62)
T_NEVER_DISAPPEARED = 1 << 62


# ----------------------------------------------------------------------------
# color -> label mapping (tesse_ground_truth_builder color map)
# ----------------------------------------------------------------------------


class ColorLabelMap:
    """Maps RGB colors (uint8 or [0,1] float) to semantic label ids.

    Exact match against the registered palette by default; `nearest=True`
    assigns the closest palette color (robust to compression artifacts in
    exported simulator clouds)."""

    def __init__(self, colors: np.ndarray, labels: Sequence[int], nearest: bool = False):
        colors = np.asarray(colors)
        if colors.dtype != np.uint8:
            colors = np.clip(np.round(colors * 255.0), 0, 255).astype(np.uint8)
        self.palette = colors.reshape(-1, 3)
        self.labels = np.asarray(labels, np.int32)
        if len(self.palette) != len(self.labels):
            raise ValueError("palette/label length mismatch")
        self.nearest = nearest
        self._lut = {tuple(c): int(l) for c, l in zip(self.palette, self.labels)}

    def __call__(self, colors: np.ndarray) -> np.ndarray:
        colors = np.asarray(colors)
        if colors.dtype != np.uint8:
            colors = np.clip(np.round(colors * 255.0), 0, 255).astype(np.uint8)
        colors = colors.reshape(-1, 3)
        if self.nearest:
            d = np.linalg.norm(
                colors[:, None, :].astype(np.int32) - self.palette[None, :, :].astype(np.int32),
                axis=-1,
            )
            return self.labels[np.argmin(d, axis=1)]
        out = np.full(len(colors), -1, np.int32)
        for i, c in enumerate(colors):
            out[i] = self._lut.get(tuple(c), -1)
        return out


# ----------------------------------------------------------------------------
# euclidean clustering (voxel-hash union-find)
# ----------------------------------------------------------------------------


def euclidean_cluster(points: np.ndarray, tolerance: float, min_size: int = 1) -> np.ndarray:
    """Cluster points with single-linkage at `tolerance` via voxel hashing.

    Points in the same or 26-adjacent voxels of a `tolerance`-sized grid are
    connected (slight over-merge vs exact euclidean clustering, same behavior
    class as the reference's PCL EuclideanClusterExtraction at this grid).
    Returns per-point cluster ids (0..K-1), -1 for dropped (< min_size)."""
    n = len(points)
    if n == 0:
        return np.zeros((0,), np.int32)
    vox = np.floor(np.asarray(points, np.float64) / float(tolerance)).astype(np.int64)
    vox -= vox.min(axis=0)  # non-negative for key packing
    key = (vox[:, 0] << 42) | (vox[:, 1] << 21) | vox[:, 2]
    uniq, inv = np.unique(key, return_inverse=True)
    m = len(uniq)

    parent = np.arange(m, dtype=np.int64)

    def find(i):
        root = i
        while parent[root] != root:
            root = parent[root]
        while parent[i] != root:  # path compression
            parent[i], i = root, parent[i]
        return root

    # connect each occupied voxel to occupied neighbors (13 of 26 directions —
    # the symmetric half covers all pairs)
    lut = {int(k): i for i, k in enumerate(uniq)}
    offsets = []
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                if (dx, dy, dz) > (0, 0, 0):
                    offsets.append((dx << 42) | (dy << 21) | dz)
    for off in offsets:
        neigh = uniq + off
        for i, nk in enumerate(neigh):
            j = lut.get(int(nk))
            if j is not None:
                ri, rj = find(i), find(j)
                if ri != rj:
                    parent[ri] = rj
    roots = np.asarray([find(i) for i in range(m)], np.int64)
    _, comp = np.unique(roots, return_inverse=True)
    ids = comp[inv].astype(np.int32)
    # min-size filter + renumber
    counts = np.bincount(ids)
    keep = counts >= min_size
    remap = np.full(len(counts), -1, np.int32)
    remap[keep] = np.arange(int(keep.sum()), dtype=np.int32)
    return remap[ids]


# ----------------------------------------------------------------------------
# GT map model
# ----------------------------------------------------------------------------


@dataclasses.dataclass
class GroundTruthMap:
    """One GT map: background cloud + static object instances."""

    background_points: np.ndarray  # [N, 3]
    objects: List[GtObject]
    stamp_ns: int = 0

    def to_scene_graph(self) -> SceneGraph:
        """DSG view for serialization/visualization (background as mesh
        vertices; objects as KhronosObject nodes with point 'meshes')."""
        dsg = SceneGraph()
        n = len(self.background_points)
        dsg.mesh = Mesh(
            vertices=self.background_points.astype(np.float32),
            colors=np.full((n, 3), 0.6, np.float32),
            labels=np.zeros((n,), np.int32),
            first_seen_ns=np.zeros((n,), np.int64),
            last_seen_ns=np.full((n,), T_NEVER_DISAPPEARED, np.int64),
            faces=np.zeros((0, 3), np.int64),
        )
        for g in self.objects:
            pts = g.surface_points if g.surface_points is not None else g.center[None]
            dsg.add_object(
                KhronosObject(
                    node_id=g.gt_id,
                    semantic_category=g.label,
                    bbox_min=g.bbox_min,
                    bbox_max=g.bbox_max,
                    first_observed_ns=[max(g.t_appear_ns, 0)],
                    last_observed_ns=[min(g.t_disappear_ns, (1 << 62) - 1)],
                    mesh_vertices=(pts - g.bbox_min).astype(np.float32),
                    mesh_faces=np.zeros((0, 3), np.int64),
                    mesh_colors=np.full((len(pts), 3), 0.5, np.float32),
                )
            )
        return dsg


@dataclasses.dataclass
class GtBuilderConfig:
    """tesse_ground_truth_builder.h parameters (clustering + filters)."""

    cluster_tolerance: float = 0.25  # m, single-linkage distance
    min_cluster_size: int = 20  # points
    max_cluster_size: int = 0  # 0 = unbounded
    surface_subsample: int = 256  # stored surface points per object
    object_labels: Tuple[int, ...] = ()  # labels that form instances
    background_labels: Tuple[int, ...] = ()  # () = everything non-object


def build_gt_map(
    points: np.ndarray,
    labels: np.ndarray,
    config: GtBuilderConfig,
    stamp_ns: int = 0,
    colors: Optional[np.ndarray] = None,
    color_map: Optional[ColorLabelMap] = None,
) -> GroundTruthMap:
    """TesseGroundTruthBuilder equivalent: labeled (or colored) scene cloud ->
    background cloud + euclidean-clustered GT object instances."""
    points = np.asarray(points, np.float32).reshape(-1, 3)
    if labels is None:
        if colors is None or color_map is None:
            raise ValueError("need labels, or colors + color_map")
        labels = color_map(colors)
    labels = np.asarray(labels, np.int32).reshape(-1)
    if len(labels) != len(points):
        raise ValueError("points/labels length mismatch")

    obj_set = set(int(l) for l in config.object_labels)
    is_obj = np.isin(labels, list(obj_set)) if obj_set else np.zeros(len(points), bool)
    if config.background_labels:
        is_bg = np.isin(labels, list(config.background_labels))
    else:
        is_bg = ~is_obj
    background = points[is_bg]

    objects: List[GtObject] = []
    next_id = 0
    for lab in sorted(obj_set):
        sel = labels == lab
        pts = points[sel]
        if len(pts) == 0:
            continue
        ids = euclidean_cluster(pts, config.cluster_tolerance, config.min_cluster_size)
        for k in range(ids.max() + 1 if len(ids) else 0):
            cluster = pts[ids == k]
            if config.max_cluster_size and len(cluster) > config.max_cluster_size:
                continue
            sub = cluster
            if len(sub) > config.surface_subsample:
                sel_idx = np.linspace(0, len(sub) - 1, config.surface_subsample).astype(int)
                sub = sub[sel_idx]
            objects.append(
                GtObject(
                    gt_id=next_id,
                    label=int(lab),
                    center=cluster.mean(axis=0).astype(np.float32),
                    bbox_min=cluster.min(axis=0).astype(np.float32),
                    bbox_max=cluster.max(axis=0).astype(np.float32),
                    surface_points=sub.astype(np.float32),
                )
            )
            next_id += 1
    return GroundTruthMap(background_points=background, objects=objects, stamp_ns=stamp_ns)


def prune_to_observed(
    gt: GroundTruthMap,
    observed_points: np.ndarray,
    max_distance: float = 0.3,
    min_observed_fraction: float = 0.2,
    device=None,
) -> GroundTruthMap:
    """Keep only GT geometry near the observed map (prune-to-observed-DSG,
    tesse_ground_truth_builder.h:37-110): completeness should not punish
    regions the robot never saw."""
    observed = np.asarray(observed_points, np.float32).reshape(-1, 3)
    bg = gt.background_points
    if len(bg) and len(observed):
        d = min_distances(bg, observed, device=device)
        bg = bg[d <= max_distance]
    elif len(observed) == 0:
        bg = np.zeros((0, 3), np.float32)
    objects = []
    for g in gt.objects:
        pts = g.surface_points if g.surface_points is not None else g.center[None]
        if len(observed) == 0:
            continue
        frac = float((min_distances(pts, observed, device=device) <= max_distance).mean())
        if frac >= min_observed_fraction:
            objects.append(g)
    return GroundTruthMap(background_points=bg, objects=objects, stamp_ns=gt.stamp_ns)


# ----------------------------------------------------------------------------
# dynamic-object GT (tesse_dynamic_object_gt_builder / real_..._gt_builder)
# ----------------------------------------------------------------------------


def dynamic_gt_from_point_sequences(
    sequences: Dict[int, List[Tuple[int, np.ndarray]]],
) -> Dict[int, Tuple[np.ndarray, np.ndarray]]:
    """Sim path: per-id list of (stamp_ns, human/mesh points) -> centroid
    trajectories {id: (stamps_ns [K], positions [K,3])}."""
    out = {}
    for gid, frames in sequences.items():
        frames = sorted(frames, key=lambda x: x[0])
        stamps = np.asarray([s for s, _ in frames], np.int64)
        pos = np.stack(
            [np.asarray(p, np.float32).reshape(-1, 3).mean(axis=0) for _, p in frames]
        ).astype(np.float32)
        out[gid] = (stamps, pos)
    return out


def save_dynamic_gt_csv(path: str, trajectories: Dict[int, Tuple[np.ndarray, np.ndarray]]):
    """Real path interchange format: stamp_ns,id,x,y,z (annotation CSV)."""
    with open(path, "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(["stamp_ns", "id", "x", "y", "z"])
        for gid, (stamps, pos) in sorted(trajectories.items()):
            for s, p in zip(stamps, pos):
                w.writerow([int(s), int(gid), f"{p[0]:.4f}", f"{p[1]:.4f}", f"{p[2]:.4f}"])


def load_dynamic_gt_csv(path: str) -> Dict[int, Tuple[np.ndarray, np.ndarray]]:
    rows: Dict[int, List[Tuple[int, np.ndarray]]] = {}
    with open(path) as fh:
        for row in csv.DictReader(fh):
            rows.setdefault(int(row["id"]), []).append(
                (int(row["stamp_ns"]), np.asarray([row["x"], row["y"], row["z"]], np.float32))
            )
    out = {}
    for gid, lst in rows.items():
        lst.sort(key=lambda x: x[0])
        out[gid] = (
            np.asarray([s for s, _ in lst], np.int64),
            np.stack([p for _, p in lst]).astype(np.float32),
        )
    return out


# ----------------------------------------------------------------------------
# consolidation across change times (gt_consolidator.{h,cpp})
# ----------------------------------------------------------------------------


@dataclasses.dataclass
class ConsolidatorConfig:
    match_distance: float = 0.5  # m centroid distance for cross-map identity
    match_labels: bool = True


def consolidate_gt_maps(
    maps: Sequence[GroundTruthMap],
    config: ConsolidatorConfig = None,
) -> GroundTruthMap:
    """Merge per-change-time GT maps (sorted by stamp) into one map whose
    objects carry appear/disappear times.

    An instance present in map i but unmatched in map i+1 disappeared at
    map[i+1].stamp; one first matched in map i>0 appeared at map[i].stamp.
    Background clouds are concatenated (deduplication left to voxel density
    of the source maps)."""
    config = config or ConsolidatorConfig()
    maps = sorted(maps, key=lambda m: m.stamp_ns)
    if not maps:
        return GroundTruthMap(np.zeros((0, 3), np.float32), [])

    # consolidated track: (GtObject template, first_map_idx, last_map_idx)
    tracks: List[List] = [[dataclasses.replace(g), 0, 0] for g in maps[0].objects]
    for mi in range(1, len(maps)):
        cur = maps[mi].objects
        used = set()
        for tr in tracks:
            tmpl, _, last = tr
            if last != mi - 1:
                continue  # already gone
            best = None
            for gi, g in enumerate(cur):
                if gi in used:
                    continue
                if config.match_labels and g.label != tmpl.label:
                    continue
                d = float(np.linalg.norm(g.center - tmpl.center))
                if d <= config.match_distance and (best is None or d < best[0]):
                    best = (d, gi)
            if best is not None:
                used.add(best[1])
                tr[2] = mi
        for gi, g in enumerate(cur):
            if gi not in used:
                tracks.append([dataclasses.replace(g), mi, mi])

    objects: List[GtObject] = []
    for nid, (tmpl, first, last) in enumerate(tracks):
        tmpl.gt_id = nid
        tmpl.t_appear_ns = maps[first].stamp_ns if first > 0 else T_NEVER_APPEARED
        tmpl.t_disappear_ns = (
            maps[last + 1].stamp_ns if last + 1 < len(maps) else T_NEVER_DISAPPEARED
        )
        objects.append(tmpl)
    background = (
        np.concatenate([m.background_points for m in maps])
        if any(len(m.background_points) for m in maps)
        else np.zeros((0, 3), np.float32)
    )
    return GroundTruthMap(background_points=background, objects=objects, stamp_ns=maps[0].stamp_ns)


# ----------------------------------------------------------------------------
# persistence (gt dsg + gt_changes.csv, SceneGroundTruth-compatible schema)
# ----------------------------------------------------------------------------


def save_gt_changes_csv(path: str, objects: Sequence[GtObject]) -> None:
    with open(path, "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(["gt_id", "label", "t_appear_ns", "t_disappear_ns"])
        for g in objects:
            w.writerow([g.gt_id, g.label, g.t_appear_ns, g.t_disappear_ns])


def load_gt_changes_csv(path: str) -> List[Tuple[int, int, int, int]]:
    out = []
    with open(path) as fh:
        for row in csv.DictReader(fh):
            out.append(
                (int(row["gt_id"]), int(row["label"]),
                 int(row["t_appear_ns"]), int(row["t_disappear_ns"]))
            )
    return out


def save_gt_map(gt: GroundTruthMap, directory: str) -> None:
    """GT output-dir contract: gt_dsg.npz + gt_background.npy + gt_changes.csv."""
    import os

    from khronos_tpu_torch.stm import serialization

    os.makedirs(directory, exist_ok=True)
    serialization.save_scene_graph(gt.to_scene_graph(), os.path.join(directory, "gt_dsg.npz"))
    np.save(os.path.join(directory, "gt_background.npy"), gt.background_points)
    save_gt_changes_csv(os.path.join(directory, "gt_changes.csv"), gt.objects)


def load_gt_map(directory: str) -> GroundTruthMap:
    import os

    from khronos_tpu_torch.stm import serialization

    dsg = serialization.load_scene_graph(os.path.join(directory, "gt_dsg.npz"))
    background = np.load(os.path.join(directory, "gt_background.npy"))
    changes = {
        gid: (ta, td)
        for gid, _, ta, td in load_gt_changes_csv(os.path.join(directory, "gt_changes.csv"))
    }
    objects = []
    for oid, o in sorted(dsg.objects.items()):
        ta, td = changes.get(oid, (T_NEVER_APPEARED, T_NEVER_DISAPPEARED))
        surface = o.world_mesh_vertices()
        objects.append(
            GtObject(
                gt_id=oid,
                label=o.semantic_category,
                center=surface.mean(axis=0).astype(np.float32) if len(surface) else o.position(),
                bbox_min=o.bbox_min,
                bbox_max=o.bbox_max,
                t_appear_ns=ta,
                t_disappear_ns=td,
                surface_points=o.world_mesh_vertices(),
            )
        )
    return GroundTruthMap(background_points=background, objects=objects)
