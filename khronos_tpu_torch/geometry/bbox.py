"""Axis-aligned bounding boxes with IoU / intersection tests (torch + numpy).

Port of `khronos_tpu/geometry/bbox.py` (spark_dsg::BoundingBox usage in the
reference: tracker IoU gating max_iou_tracker.cpp:589-593, merge proposal
bbox-intersect gate update_khronos_objects_functor.cpp:61-107). Each function
takes numpy arrays or torch tensors and answers in the same kind.

A bbox is a pair (min [..., 3], max [..., 3]); an invalid/empty box has
min > max (+inf/-inf sentinels from `empty()`).
"""

from __future__ import annotations

import numpy as np
import torch


def empty(dtype=np.float32):
    return np.full((3,), np.inf, dtype), np.full((3,), -np.inf, dtype)


def from_points(points, valid=None):
    """Points [..., N, 3] (+ optional bool mask [..., N]) -> (min, max)."""
    if valid is not None:
        if torch.is_tensor(points):
            big = torch.where(valid[..., None], points, float("inf"))
            small = torch.where(valid[..., None], points, float("-inf"))
            return big.amin(dim=-2), small.amax(dim=-2)
        big = np.where(valid[..., None], points, np.inf)
        small = np.where(valid[..., None], points, -np.inf)
        return big.min(axis=-2), small.max(axis=-2)
    if torch.is_tensor(points):
        return points.amin(dim=-2), points.amax(dim=-2)
    return points.min(axis=-2), points.max(axis=-2)


def is_valid(bmin, bmax):
    return (bmin <= bmax).all(-1)


def volume(bmin, bmax):
    ext = (bmax - bmin).clamp_min(0.0) if torch.is_tensor(bmin) else np.clip(bmax - bmin, 0.0, None)
    return ext[..., 0] * ext[..., 1] * ext[..., 2]


def intersects(amin, amax, bmin, bmax):
    return ((amin <= bmax) & (bmin <= amax)).all(-1)


def intersection_volume(amin, amax, bmin, bmax):
    if torch.is_tensor(amin):
        return volume(torch.maximum(amin, bmin), torch.minimum(amax, bmax))
    return volume(np.maximum(amin, bmin), np.minimum(amax, bmax))


def iou(amin, amax, bmin, bmax):
    """Volumetric IoU; broadcasts, so pairwise matrices come from [N,1,3]x[1,M,3]."""
    inter = intersection_volume(amin, amax, bmin, bmax)
    union = volume(amin, amax) + volume(bmin, bmax) - inter
    if torch.is_tensor(amin):
        return torch.where(union > 0, inter / torch.where(union > 0, union, 1.0), 0.0)
    return np.where(union > 0, inter / np.where(union > 0, union, 1.0), 0.0)


def pairwise_iou(amin, amax, bmin, bmax):
    """[N,3] boxes vs [M,3] boxes -> [N, M] IoU matrix."""
    return iou(amin[:, None, :], amax[:, None, :], bmin[None, :, :], bmax[None, :, :])


def merge(amin, amax, bmin, bmax):
    if torch.is_tensor(amin):
        return torch.minimum(amin, bmin), torch.maximum(amax, bmax)
    return np.minimum(amin, bmin), np.maximum(amax, bmax)


def contains(bmin, bmax, points):
    return ((points >= bmin) & (points <= bmax)).all(-1)


class BboxGrid:
    """Uniform-cell spatial bucket over axis-aligned boxes (host numpy).

    Neighbor-candidate generation in O(cells touched) per query instead of
    O(n), the host-side analog of the reference's spatial_hash Grid. Consumer
    here: merge-proposal candidate generation (`backend.Backend._propose_merges`).
    """

    def __init__(self, mins: np.ndarray, maxs: np.ndarray, cell: float = 0.0):
        mins = np.asarray(mins, np.float32).reshape(-1, 3)
        maxs = np.asarray(maxs, np.float32).reshape(-1, 3)
        self.mins, self.maxs = mins, maxs
        if cell <= 0.0:
            # default: median box diagonal (floored) — boxes touch a handful
            # of cells each regardless of scene scale
            if len(mins):
                diag = np.linalg.norm(np.maximum(maxs - mins, 0.0), axis=1)
                cell = float(max(np.median(diag), 0.5))
            else:
                cell = 1.0
        self.cell = cell
        self._buckets: dict = {}
        for i in range(len(mins)):
            for key in self._cells_of(mins[i], maxs[i]):
                self._buckets.setdefault(key, []).append(i)

    def _cells_of(self, mn, mx):
        lo = np.floor(mn / self.cell).astype(np.int64)
        hi = np.floor(mx / self.cell).astype(np.int64)
        for x in range(lo[0], hi[0] + 1):
            for y in range(lo[1], hi[1] + 1):
                for z in range(lo[2], hi[2] + 1):
                    yield (x, y, z)

    def candidates(self, qmn, qmx) -> np.ndarray:
        """Sorted indices of boxes sharing a grid cell with the query box
        (superset of all boxes intersecting it). Sorted so consumers iterate
        pairs in the same deterministic order as a row-major all-pairs scan
        — merge-proposal chains are order-sensitive."""
        out: set = set()
        for key in self._cells_of(np.asarray(qmn, np.float32), np.asarray(qmx, np.float32)):
            b = self._buckets.get(key)
            if b:
                out.update(b)
        return np.sort(np.fromiter(out, np.int64, len(out)))
