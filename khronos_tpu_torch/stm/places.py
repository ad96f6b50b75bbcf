"""Free-space places graph + room segmentation (hydra GVD-frontend parity).

Port of `khronos_tpu/stm/places.py`, the equivalent of hydra's
freespace_places GVD extraction and room finder (SURVEY.md §2.3; mapper
config uHumans2.yaml:113-150: gvd max/min_distance, compression_distance_m
1.5, min_node_distance, room_finder):

1. Occupancy grid from the background mesh (scatter vertices).
2. Euclidean-ish distance field via chamfer propagation: K iterations of
   axis-separable min-propagation with metric edge costs.
3. Place candidates = local maxima of the distance field with clearance in
   [min_distance, max_distance] (the medial axis / Voronoi ridge).
4. Graph: candidates compressed on a `compression_distance` grid; edges
   between nearby places whose connecting segment keeps `min_edge_clearance`.
5. Rooms: connected components of free space ERODED by `room_clearance`
   (restricted to the z-slab, and to columns with floor support so
   unobserved exterior space cannot merge rooms); places take the label of
   their containing/nearest blob. Graph-edge union-find remains as a
   fallback when no occupancy is available.

The device functions (`chamfer_distance_field`, `_candidate_field`,
`_room_blobs`) run on the extractor's `device` (CUDA unless the caller
passes device="cpu") and match the reference bit for bit: the field adds a
float32 constant (no product, so nothing to contract), comparisons are made
against float32 0-dim tensors, and the ball dilation sums 0/1 products
(integers far below 2^24) against a 0.5 threshold. The components run to
their fixpoint through `ops/propagate.propagate_labels_3d_fixpoint`: kernel A
in one launch on CUDA. Everything else is a host numpy copy of the
reference. The reference pads scatter indices to pow2 row counts for its
compile cache (`_pad_idx_pow2`); a repeated row scatters the same True, so
the port pads nothing.
"""

from __future__ import annotations

import copy
import dataclasses
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from khronos_tpu_torch import resolve_device
from khronos_tpu_torch.ops.dense import max_pool3
from khronos_tpu_torch.ops.propagate import propagate_labels_3d_fixpoint
from khronos_tpu_torch.utils.timing import Timer


@dataclasses.dataclass
class PlacesConfig:
    voxel_size: float = 0.2  # m (coarser than the map voxel)
    min_distance: float = 0.3  # m clearance for a place (gvd min_distance)
    max_distance: float = 4.5  # m (gvd max_distance)
    compression_distance: float = 1.5  # m between place nodes
    edge_radius: float = 3.0  # m max edge length
    min_edge_clearance: float = 0.25  # m along an edge
    room_clearance: float = 0.8  # m: edges narrower than this split rooms
    chamfer_iterations: int = 24
    z_slab: Tuple[float, float] = (0.1, 2.2)  # m band used for places
    # incremental (per-output) mode: half-extent of the local extraction
    # window around the robot, and the interior margin inside which freshly
    # computed nodes replace persistent ones (border clearances are
    # underinformed, so the outer ring only contributes obstacles)
    window_radius: float = 6.4  # m
    window_margin: float = 1.0  # m
    # min seconds between incremental windowed re-extractions (deltas still
    # accumulate every output; only the chamfer/splice is rate-limited)
    min_update_interval_s: float = 1.0
    # room segmentation grid (coarser than the places grid): rooms are
    # connected components of free space ERODED by room_clearance, so
    # furniture clutter cannot split a room but a doorway narrower than
    # 2*room_clearance does (role of hydra's room finder)
    room_voxel_size: float = 0.4
    # a room blob must hold at least this much eroded free volume (m^3) to
    # count as a room; smaller blobs (observation slivers) are unlabeled
    # and their places adopt a neighbor's room instead of minting phantom
    # rooms
    min_room_volume: float = 2.0
    # horizontal dilation (m) of the floor-support mask: patchily observed
    # floor must not fragment one room into several blobs
    floor_dilation: float = 0.8
    # min seconds between full room re-segmentations in update_local: rooms
    # are a map-wide connected-components pass over ALL occupancy, the one
    # O(map)-per-update term of the incremental path. Node room ids persist
    # between refreshes; snapshot/finish always refresh.
    room_update_interval_s: float = 15.0


@dataclasses.dataclass
class PlaceNode:
    place_id: int
    position: np.ndarray  # [3]
    distance: float  # clearance (m)
    room_id: int = -1


@dataclasses.dataclass
class PlacesLayer:
    nodes: List[PlaceNode] = dataclasses.field(default_factory=list)
    edges: List[Tuple[int, int, float]] = dataclasses.field(default_factory=list)
    # (place_id, place_id, min clearance along edge)

    @property
    def num_rooms(self) -> int:
        return len({n.room_id for n in self.nodes if n.room_id >= 0})


def _f32(value: float, device) -> torch.Tensor:
    """A float32 0-dim tensor: arithmetic and comparisons stay in float32, as
    the reference's traced scalars do."""
    return torch.full((), value, dtype=torch.float32, device=device)


def _scatter_occupancy(occ_idx: torch.Tensor, dims) -> torch.Tensor:
    """bool grid of `dims`, True at the [N, 3] int64 cell indices (in range)."""
    occ = torch.zeros(tuple(dims), dtype=torch.bool, device=occ_idx.device)
    occ[occ_idx[:, 0], occ_idx[:, 1], occ_idx[:, 2]] = True
    return occ


def chamfer_distance_field(occupied: torch.Tensor, voxel: float, iterations: int) -> torch.Tensor:
    """Distance-to-obstacle field via separable chamfer propagation.

    Each of the `iterations` rounds passes x, y, z in turn, each pass reading
    the field as the previous one left it: d = min(d, min(d[i-1], d[i+1]) +
    voxel), a neighbour beyond the border counting as 1e6."""
    big = _f32(1e6, occupied.device)
    step = _f32(voxel, occupied.device)
    d = torch.where(occupied, _f32(0.0, occupied.device), big)
    for _ in range(iterations):
        for axis in range(3):
            n = d.shape[axis]
            shape = list(d.shape)
            shape[axis] = 1
            pad = big.expand(shape)
            lo = torch.cat([pad, d.narrow(axis, 0, n - 1)], dim=axis)
            hi = torch.cat([d.narrow(axis, 1, n - 1), pad], dim=axis)
            d = torch.minimum(d, torch.minimum(lo, hi) + step)
    return d


def _local_maxima(d: torch.Tensor) -> torch.Tensor:
    return d >= max_pool3(d) - _f32(1e-6, d.device)


def _candidate_field(occ_idx: torch.Tensor, dims, voxel: float, iterations: int, min_d: float, max_d: float):
    """Occupancy scatter + chamfer + local-maxima band filter on the device:
    (field [X, Y, Z] float32, candidates [X, Y, Z] bool)."""
    occ = _scatter_occupancy(occ_idx, dims)
    d = chamfer_distance_field(occ, voxel, iterations)
    cand = _local_maxima(d) & (d >= _f32(min_d, d.device)) & (d <= _f32(max_d, d.device))
    return d, cand


def _ball(voxel: float, clearance: float):
    """(R, [2R+1]^3 float32 ball of radius `clearance`), as the reference builds it."""
    R = int(np.floor(clearance / voxel + 1e-6))
    zz, yy, xx = np.meshgrid(*([np.arange(-R, R + 1)] * 3), indexing="ij")
    ball = (((xx**2 + yy**2 + zz**2) * voxel * voxel) <= clearance * clearance + 1e-9).astype(np.float32)
    return R, ball


def _room_blobs(occ_idx: torch.Tensor, zmask: torch.Tensor, dims, voxel: float, clearance: float, floor_cells: int):
    """Connected-component labels of room space: free cells ERODED by
    `clearance`, restricted to the z-slab AND to columns with occupancy
    below (floor support: unobserved space outside the building has no floor
    and must not merge rooms through the exterior).

    Erosion is an exact Euclidean ball dilation of the occupancy (one conv3d
    with a spherical kernel, TF32 off). Floor support is closed horizontally
    by `floor_cells` (a max-pool with its implicit -inf padding, then a
    min-pool over explicit zero padding) so patchily observed floor does not
    fragment one room into many. Components via 26-neighbour max-label
    propagation run to the fixpoint (kernel A on CUDA). Returns an int32
    label grid (0 = not in any blob)."""
    occ = _scatter_occupancy(occ_idx, dims)
    R, ball = _ball(voxel, clearance)
    kernel = torch.from_numpy(ball)[None, None].to(occ.device)
    blocked = F.conv3d(occ.to(torch.float32)[None, None], kernel, padding=R)[0, 0] > 0.5
    has_floor = (occ.cumsum(dim=2) > 0).to(torch.float32)
    if floor_cells > 0:
        # morphological CLOSING (dilate then erode): bridges interior
        # observation gaps up to 2*floor_cells wide WITHOUT extending floor
        # support outward past the walls
        fc = floor_cells
        win = (2 * fc + 1, 2 * fc + 1, 1)
        has_floor = F.max_pool3d(has_floor[None, None], win, stride=1, padding=(fc, fc, 0))
        # erode over explicit zero padding (a border padded with +inf would
        # keep floor support alive along the grid border)
        has_floor = -F.max_pool3d(-F.pad(has_floor, (0, 0, fc, fc, fc, fc)), win, stride=1)
        has_floor = has_floor[0, 0]
    eroded = ~blocked & zmask[None, None, :] & (has_floor > 0.5)
    n = int(np.prod(dims))
    seeds = torch.arange(1, n + 1, dtype=torch.int32, device=occ.device).view(tuple(dims))
    labels = propagate_labels_3d_fixpoint(torch.where(eroded, seeds, -1), eroded)
    return labels.clamp_min(0)


def _pull_field(d: torch.Tensor, cand: torch.Tensor):
    """The field and the candidate mask in one copy to the host."""
    n = d.numel()
    words = torch.cat([d.reshape(-1).view(torch.int32), cand.reshape(-1).to(torch.int32)]).cpu().numpy()
    return words[:n].view(np.float32).reshape(d.shape), words[n:].astype(bool).reshape(d.shape)


_KEY_OFF = 1 << 20  # packed-cell offset: 21 bits/axis, +-1M cells


def _pack_cells(idx: np.ndarray) -> np.ndarray:
    """[N,3] int cell indices -> packed int64 keys."""
    i = idx.astype(np.int64) + _KEY_OFF
    return (i[:, 0] << 42) | (i[:, 1] << 21) | i[:, 2]


def _unpack_cells(keys: np.ndarray) -> np.ndarray:
    k = keys.astype(np.int64)
    return (
        np.stack([(k >> 42) & 0x1FFFFF, (k >> 21) & 0x1FFFFF, k & 0x1FFFFF], axis=1)
        - _KEY_OFF
    )


class PlacesExtractor:
    """Global (`extract`) and incremental per-output (`add_mesh_delta` +
    `update_local`) free-space place extraction.

    Incremental mode mirrors hydra's per-backend-input GVD frontend
    (uHumans2.yaml:103-150): each ActiveWindowOutput's archived mesh delta
    scatters into a persistent occupancy store (coarse-block dict of packed
    voxel keys); `update_local` runs the chamfer field only in a window
    around the robot and splices the fresh nodes into the persistent layer.

    device: where the field and the room segmentation run; CUDA unless the
    caller passes device="cpu"."""

    def __init__(self, config: PlacesConfig = None, device=None):
        self.config = config or PlacesConfig()
        self.device = resolve_device(device)
        # persistent occupancy: coarse block (16^3 cells) -> set of packed keys
        self._blocks: Dict[int, set] = {}
        self.layer = PlacesLayer()
        # update_local may run on a detached stage while the frame loop
        # feeds deltas
        self._lock = threading.RLock()
        # last full room re-segmentation (see room_update_interval_s);
        # -inf so the FIRST update always labels rooms
        self._last_room_update_s = float("-inf")

    def __getstate__(self):
        state = self.__dict__.copy()
        state.pop("_lock")
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._lock = threading.RLock()
        self.__dict__.setdefault("_last_room_update_s", float("-inf"))

    def snapshot_layer(self) -> PlacesLayer:
        with self._lock:
            return copy.deepcopy(self.layer)

    def lcd_snapshot(self):
        """Cheap (positions [P,3], clearances [P]) arrays of the current
        layer for the LCD places-descriptor tier; None while empty."""
        with self._lock:
            nodes = self.layer.nodes
            if not nodes:
                return None
            pos = np.stack([n.position for n in nodes]).astype(np.float32)
            clr = np.asarray([n.distance for n in nodes], np.float32)
        return pos, clr

    # -- occupancy store ------------------------------------------------
    _BLOCK = 16  # cells per block side

    def _scatter(self, vertices: np.ndarray) -> None:
        if len(vertices) == 0:
            return
        cells = np.unique(
            _pack_cells(np.floor(vertices / self.config.voxel_size).astype(np.int64))
        )
        blocks = _pack_cells(_unpack_cells(cells) // self._BLOCK)
        order = np.argsort(blocks)
        blocks, cells = blocks[order], cells[order]
        starts = np.searchsorted(blocks, np.unique(blocks))
        for s, e in zip(starts, np.r_[starts[1:], len(blocks)]):
            self._blocks.setdefault(int(blocks[s]), set()).update(cells[s:e].tolist())

    def add_mesh_delta(self, vertices: np.ndarray) -> None:
        """Accumulate newly archived background geometry (per-output feed)."""
        with self._lock:
            self._scatter(np.asarray(vertices, np.float32).reshape(-1, 3))

    def reset_occupancy(self, vertices: np.ndarray) -> None:
        """Rebuild the occupancy store from a full (e.g. freshly reconciled)
        mesh: purges geometry removed by reconciliation."""
        with self._lock:
            self._blocks = {}
            self._scatter(np.asarray(vertices, np.float32).reshape(-1, 3))

    def _occupied_cell_centers(self) -> np.ndarray:
        """Centers of every occupied cell in the persistent store (room
        segmentation input). Callers hold the lock."""
        keys = [k for s in self._blocks.values() for k in s]
        if not keys:
            return np.zeros((0, 3), np.float32)
        return (
            (_unpack_cells(np.asarray(keys, np.int64)) + 0.5) * self.config.voxel_size
        ).astype(np.float32)

    def _window_cells(self, lo_cell: np.ndarray, dims: np.ndarray) -> np.ndarray:
        """Occupied cell indices (relative to lo_cell) inside the window."""
        b0 = lo_cell // self._BLOCK
        b1 = (lo_cell + dims - 1) // self._BLOCK
        keys: List[int] = []
        for bx in range(int(b0[0]), int(b1[0]) + 1):
            for by in range(int(b0[1]), int(b1[1]) + 1):
                for bz in range(int(b0[2]), int(b1[2]) + 1):
                    bkey = int(_pack_cells(np.array([[bx, by, bz]]))[0])
                    s = self._blocks.get(bkey)
                    if s:
                        keys.extend(s)
        if not keys:
            return np.zeros((0, 3), np.int64)
        idx = _unpack_cells(np.asarray(keys, np.int64)) - lo_cell
        ok = ((idx >= 0) & (idx < dims)).all(axis=1)
        return idx[ok]

    def _on_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # -- field + candidates (shared by global and windowed paths) -------
    def _candidates(self, idx: np.ndarray, lo: np.ndarray, dims: np.ndarray):
        """Chamfer field + compressed place candidates on a dense grid.
        Returns (d_np, positions [N,3], dists [N])."""
        cfg = self.config
        vs = cfg.voxel_size
        d_dev, cand_dev = _candidate_field(
            self._on_device(idx.astype(np.int64)), tuple(int(x) for x in dims), vs,
            cfg.chamfer_iterations, cfg.min_distance, cfg.max_distance,
        )
        d_np, cand = _pull_field(d_dev, cand_dev)
        zs = lo[2] + (np.arange(dims[2]) + 0.5) * vs
        slab = (zs >= cfg.z_slab[0]) & (zs <= cfg.z_slab[1])
        cand = cand & slab[None, None, :]
        coords = np.argwhere(cand)
        if len(coords) == 0:
            return d_np, np.zeros((0, 3), np.float32), np.zeros((0,), np.float32)
        dists = d_np[cand]
        positions = lo + (coords + 0.5) * vs
        # compression: keep the highest-clearance candidate per coarse cell
        keys = np.floor(positions / cfg.compression_distance).astype(np.int64)
        best: Dict[tuple, int] = {}
        for i, k in enumerate(map(tuple, keys)):
            if k not in best or dists[i] > dists[best[k]]:
                best[k] = i
        chosen = sorted(best.values())
        return d_np, positions[chosen].astype(np.float32), dists[chosen]

    def _edges_from_field(
        self, P: np.ndarray, pairs, d_np: np.ndarray, lo: np.ndarray, dims: np.ndarray
    ) -> List[Tuple[int, int, float]]:
        """Clearance-sampled edges for the given (a, b) index pairs."""
        cfg = self.config
        vs = cfg.voxel_size
        out: List[Tuple[int, int, float]] = []
        for a, b in pairs:
            seg = P[b] - P[a]
            length = np.linalg.norm(seg)
            if length > cfg.edge_radius:
                continue
            n_samples = max(int(length / vs), 2)
            ts = np.linspace(0, 1, n_samples)
            pts = P[a] + ts[:, None] * seg
            cells = np.clip(((pts - lo) / vs).astype(int), 0, np.asarray(dims) - 1)
            clear = d_np[cells[:, 0], cells[:, 1], cells[:, 2]].min()
            if clear >= cfg.min_edge_clearance:
                out.append((a, b, float(clear)))
        return out

    # ------------------------------------------------------------------
    def extract(self, mesh_vertices: np.ndarray) -> PlacesLayer:
        """Build the places layer from scratch over all mesh vertices."""
        cfg = self.config
        layer = PlacesLayer()
        if len(mesh_vertices) < 10:
            return layer
        vs = cfg.voxel_size
        lo = mesh_vertices.min(axis=0) - 2 * vs
        hi = mesh_vertices.max(axis=0) + 2 * vs
        dims = np.maximum(((hi - lo) / vs).astype(int) + 1, 4)
        dims = np.minimum(dims, 256)

        idx = ((mesh_vertices - lo) / vs).astype(int)
        ok = ((idx >= 0) & (idx < dims)).all(axis=1)
        d_np, positions, dists = self._candidates(idx[ok], lo, dims)
        for pid in range(len(positions)):
            layer.nodes.append(
                PlaceNode(place_id=pid, position=positions[pid], distance=float(dists[pid]))
            )
        if layer.nodes:
            P = np.stack([n.position for n in layer.nodes])
            pairs = [
                (a, b) for a in range(len(P)) for b in range(a + 1, len(P))
            ]
            layer.edges = self._edges_from_field(P, pairs, d_np, lo, dims)
        self._assign_rooms(layer, occupied_points=mesh_vertices[:: max(len(mesh_vertices) // 200000, 1)])
        return layer

    # ------------------------------------------------------------------
    def update_local(
        self, center: np.ndarray, stamp_ns: Optional[int] = None
    ) -> PlacesLayer:
        """Incremental update: recompute places in a window around `center`
        from the persistent occupancy store and splice them into the
        persistent layer (old nodes inside the inner window are replaced;
        clearances/edges re-sampled for every pair touching the window).

        `stamp_ns` (sequence time) gates the room re-segmentation cadence;
        without it the gate falls back to wall clock."""
        cfg = self.config
        vs = cfg.voxel_size
        center = np.asarray(center, np.float32)
        r = cfg.window_radius
        lo_cell = np.floor((center - r) / vs).astype(np.int64)
        dims = np.full(3, int(np.ceil(2 * r / vs)), np.int64)
        dims = np.minimum(dims, 256)
        lo = lo_cell * vs
        hi = lo + dims * vs

        with self._lock:
            with Timer("places/window_cells"):
                idx = self._window_cells(lo_cell, dims)
        if len(idx) < 10:
            return self.layer
        with Timer("places/candidates"):
            d_np, new_pos, new_dist = self._candidates(idx, lo, dims)

        inner_lo = lo + cfg.window_margin
        inner_hi = hi - cfg.window_margin
        in_inner = lambda p: bool(((p >= inner_lo) & (p <= inner_hi)).all())  # noqa: E731
        keep_new = [i for i in range(len(new_pos)) if in_inner(new_pos[i])]

        old = self.layer
        survivors = [n for n in old.nodes if not in_inner(n.position)]
        old_index = {id(n): i for i, n in enumerate(old.nodes)}
        remap = {}  # old node list index -> new index
        merged = PlacesLayer()
        for n in survivors:
            remap[old_index[id(n)]] = len(merged.nodes)
            # COPY survivors instead of mutating in place: the published
            # self.layer shares these node objects with concurrent
            # snapshot_layer() deepcopies; the splice-and-swap below
            # publishes the new layer atomically under the lock.
            merged.nodes.append(dataclasses.replace(n, place_id=len(merged.nodes)))
        for i in keep_new:
            merged.nodes.append(
                PlaceNode(
                    place_id=len(merged.nodes),
                    position=new_pos[i],
                    distance=float(new_dist[i]),
                )
            )
        if not merged.nodes:
            self.layer = merged
            return merged

        P = np.stack([n.position for n in merged.nodes])
        in_window = ((P >= lo) & (P < hi)).all(axis=1)
        # carry over old-old edges with BOTH endpoints outside the window
        # (their geometry did not change); everything touching the window is
        # re-sampled below
        for a, b, c in old.edges:
            if a in remap and b in remap:
                na, nb = remap[a], remap[b]
                if not (in_window[na] or in_window[nb]):
                    merged.edges.append((min(na, nb), max(na, nb), c))
        # only pairs touching the window need re-sampling: scan from
        # in-window nodes only
        pairs_in, pairs_cross = [], []
        seen_pairs = set()
        for a in np.nonzero(in_window)[0]:
            nb = np.nonzero(
                np.linalg.norm(P - P[a], axis=1) <= cfg.edge_radius
            )[0]
            for b in nb:
                if b == a:
                    continue
                key = (min(a, b), max(a, b))
                if key in seen_pairs:
                    continue
                seen_pairs.add(key)
                if in_window[b]:
                    pairs_in.append(key)
                else:
                    pairs_cross.append(key)
        with Timer("places/edges"):
            merged.edges.extend(self._edges_from_field(P, pairs_in, d_np, lo, dims))
        # cross-window pairs: sample only the in-window part of the segment;
        # the out-of-window part is bounded by the outside node's own
        # clearance
        for a, b in pairs_cross:
            seg = P[b] - P[a]
            length = np.linalg.norm(seg)
            n_samples = max(int(length / vs), 2)
            ts = np.linspace(0, 1, n_samples)
            pts = P[a] + ts[:, None] * seg
            inside = ((pts >= lo) & (pts < hi)).all(axis=1)
            if not inside.any():
                continue
            cells = np.clip(
                ((pts[inside] - lo) / vs).astype(int), 0, np.asarray(dims) - 1
            )
            clear_in = float(d_np[cells[:, 0], cells[:, 1], cells[:, 2]].min())
            out_node = merged.nodes[b if in_window[a] else a]
            clear = min(clear_in, out_node.distance)
            if clear >= cfg.min_edge_clearance:
                merged.edges.append((a, b, clear))
        # sequence time and wall clock are separate gates
        if stamp_ns is not None:
            now_s = stamp_ns * 1e-9
            gate_attr = "_last_room_update_s"
        else:
            now_s = time.monotonic()
            gate_attr = "_last_room_update_mono_s"
        last = getattr(self, gate_attr, float("-inf"))
        if now_s - last >= cfg.room_update_interval_s:
            setattr(self, gate_attr, now_s)
            with self._lock:
                occ_pts = self._occupied_cell_centers()
            with Timer("places/rooms"):
                self._assign_rooms(merged, occupied_points=occ_pts)
        else:
            # between refreshes, label rooms from the place GRAPH: union-find
            # over wide edges (clearance >= room_clearance). Components
            # holding surviving labelled nodes adopt their label; brand-new
            # components stay unlabeled (-1) until the next timed refresh.
            parent = list(range(len(merged.nodes)))

            def find(x):
                while parent[x] != x:
                    parent[x] = parent[parent[x]]
                    x = parent[x]
                return x

            for a, b, clear in merged.edges:
                if clear >= cfg.room_clearance:
                    ra, rb = find(a), find(b)
                    if ra != rb:
                        parent[ra] = rb
            root_label: Dict[int, int] = {}
            for i, n in enumerate(merged.nodes):
                if n.room_id >= 0:
                    root_label.setdefault(find(i), n.room_id)
            for i, n in enumerate(merged.nodes):
                n.room_id = root_label.get(find(i), -1)
        with self._lock:
            self.layer = merged
        return merged

    # ------------------------------------------------------------------
    def refresh_rooms(self) -> None:
        """Force a full eroded-free-space room re-segmentation of the
        persistent layer (the timed refresh, on demand). The pipeline calls
        this at finishMapping so the FINAL layer's room ids always come from
        the occupancy blobs, never the interim graph fallback."""
        with self._lock:
            occ_pts = self._occupied_cell_centers()
            layer = self.layer
        if layer.nodes:
            with Timer("places/rooms"):
                self._assign_rooms(layer, occupied_points=occ_pts)
            self._last_room_update_s = float("-inf")  # re-gate from data time

    # ------------------------------------------------------------------
    def _assign_rooms(
        self, layer: PlacesLayer, occupied_points: np.ndarray = None
    ) -> None:
        """Room segmentation. With geometry available: rooms are connected
        components of free space ERODED by `room_clearance`. Falls back to
        wide-edge union-find when no occupancy is supplied."""
        if occupied_points is None or len(occupied_points) < 10 or not layer.nodes:
            self._assign_rooms_graph(layer)
            return
        cfg = self.config
        vs2 = cfg.room_voxel_size
        # exact integer cell arithmetic: float `(p - lo)/vs` truncation
        # jitters points by one cell and fragments the field
        cells = np.floor(
            occupied_points.astype(np.float64) / vs2
        ).astype(np.int64)
        # the grid is bounded (144^3 cells) and CENTERED on the place nodes'
        # extent when the occupancy is larger; dims are multiples of 16
        node_cells = np.floor(
            np.stack([n.position for n in layer.nodes]).astype(np.float64) / vs2
        ).astype(np.int64)
        lo_cell = cells.min(axis=0) - 2
        hi_cell = cells.max(axis=0) + 3
        dims = hi_cell - lo_cell
        over = dims > 144
        if over.any():
            mid = (node_cells.min(axis=0) + node_cells.max(axis=0)) // 2
            lo_cell = np.where(over, mid - 72, lo_cell)
            dims = np.minimum(dims, 144)
        dims = np.minimum(((dims + 15) // 16) * 16, 144)
        idx = cells - lo_cell
        ok = ((idx >= 0) & (idx < dims)).all(axis=1)
        n_drop = int((~ok).sum())
        if n_drop:
            from khronos_tpu_torch.utils.logging import clog

            clog(
                2,
                f"room grid truncated: {n_drop}/{len(ok)} occupancy cells "
                f"outside the {dims.tolist()}-cell box around the place nodes",
            )
        zs = (lo_cell[2] + np.arange(dims[2]) + 0.5) * vs2
        zmask = (zs >= cfg.z_slab[0]) & (zs <= cfg.z_slab[1])
        labels = _room_blobs(
            self._on_device(idx[ok]),
            self._on_device(zmask),
            tuple(int(x) for x in dims),
            vs2,
            cfg.room_clearance,
            int(round(cfg.floor_dilation / vs2)),
        ).cpu().numpy()
        # resolution-normalized room filter: a blob below min_room_volume is
        # an observation sliver, not a room
        uniq, counts = np.unique(labels[labels > 0], return_counts=True)
        min_cells = max(1, int(round(cfg.min_room_volume / vs2**3)))
        valid_blobs = set(uniq[counts >= min_cells].tolist())
        node_lbl = np.full(len(layer.nodes), -1, np.int64)
        for i, n in enumerate(layer.nodes):
            c = np.clip(
                np.floor(n.position.astype(np.float64) / vs2).astype(np.int64)
                - lo_cell,
                0,
                dims - 1,
            )
            lbl = int(labels[c[0], c[1], c[2]])
            if lbl <= 0 or lbl not in valid_blobs:
                # narrow spot / sliver: nearest VALID blob in a small
                # neighborhood (places sit on the medial axis, which the
                # erosion can pinch off)
                r = 2
                sl = tuple(
                    slice(max(c[i] - r, 0), min(c[i] + r + 1, dims[i]))
                    for i in range(3)
                )
                patch = labels[sl]
                cand = [int(v) for v in np.unique(patch[patch > 0]) if int(v) in valid_blobs]
                lbl = cand[0] if cand else -1
            node_lbl[i] = lbl
        # adoption: unlabeled places take the room of the nearest labeled
        # place within edge_radius, never a fresh singleton room
        pos = np.stack([n.position for n in layer.nodes])
        unl = np.nonzero(node_lbl < 0)[0]
        labd = np.nonzero(node_lbl >= 0)[0]
        if len(unl) and len(labd):
            d2 = ((pos[unl, None, :] - pos[None, labd, :]) ** 2).sum(-1)
            nearest = np.argmin(d2, axis=1)
            okn = d2[np.arange(len(unl)), nearest] <= cfg.edge_radius**2
            node_lbl[unl[okn]] = node_lbl[labd[nearest[okn]]]
        rooms: Dict[int, int] = {}
        for i, n in enumerate(layer.nodes):
            lbl = int(node_lbl[i])
            if lbl < 0:
                n.room_id = -1  # no room (hydra: place without a room parent)
                continue
            if lbl not in rooms:
                rooms[lbl] = len(rooms)
            n.room_id = rooms[lbl]

    def _assign_rooms_graph(self, layer: PlacesLayer) -> None:
        """Union-find over wide edges; narrow passages separate rooms."""
        cfg = self.config
        parent = list(range(len(layer.nodes)))

        def find(x):
            while parent[x] != x:
                parent[x] = parent[parent[x]]
                x = parent[x]
            return x

        for a, b, clear in layer.edges:
            if clear >= cfg.room_clearance:
                ra, rb = find(a), find(b)
                if ra != rb:
                    parent[ra] = rb
        roots: Dict[int, int] = {}
        for i, n in enumerate(layer.nodes):
            r = find(i)
            if r not in roots:
                roots[r] = len(roots)
            n.room_id = roots[r]
