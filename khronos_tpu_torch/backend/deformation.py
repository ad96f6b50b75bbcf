"""Deformation graph: mesh + object correction after pose-graph optimization.

Port of `khronos_tpu/backend/deformation.py` (kimera_pgmo's deformation
machinery, SURVEY.md §2.3): control nodes (mesh control points sampled at
`d_graph_resolution`) live in the factor graph; after robust PGO the mesh is
deformed by blending the control-node corrections over the k nearest nodes,
and object/agent positions are corrected by interpolating along the deformed
trajectory (UpdateKhronosObjectsFunctor, update_khronos_objects_functor.cpp:41-59).

On the device: one batched k-NN gather/blend (`_deform_points`) over chunks
of points. The reference padded the control count to multiples of 32 so that
XLA compiled once per bucket, with pads 1e6 m away that the k-NN never
selects; the port has no padding.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from khronos_tpu_torch import resolve_device


@dataclasses.dataclass
class DeformationConfig:
    d_graph_resolution: float = 2.5  # m between mesh control nodes (yaml:108)
    interp_k: int = 4  # control nodes blended per vertex
    max_blend_distance: float = 6.0  # m: beyond this, vertices move rigidly with nearest


def sample_control_points(
    vertices: np.ndarray, resolution: float, existing: np.ndarray = None
) -> np.ndarray:
    """Greedy voxel-grid subsample of mesh vertices as control points
    (pgmo mesh compression at d_graph_resolution)."""
    if len(vertices) == 0:
        return np.zeros((0, 3), np.float32)
    keys = np.floor(vertices / resolution).astype(np.int64)
    seen = set()
    if existing is not None and len(existing):
        for k in np.floor(existing / resolution).astype(np.int64):
            seen.add((int(k[0]), int(k[1]), int(k[2])))
    out = []
    for i, k in enumerate(keys):
        t = (int(k[0]), int(k[1]), int(k[2]))
        if t not in seen:
            seen.add(t)
            out.append(vertices[i])
    return np.asarray(out, np.float32) if out else np.zeros((0, 3), np.float32)


def _deform_points(points, ctrl_old, ctrl_R, ctrl_new, k: int):
    """Embedded-deformation blend: x' = sum_j w_j (R_j (x - g_j) + g'_j).

    points [V, 3], ctrl_old / ctrl_new [C, 3], ctrl_R [C, 3, 3] (tensors on
    one device). |p - g|^2 comes from the matmul identity, which peaks at
    [V, C] instead of a [V, C, 3] difference tensor. Equal distances may
    pick their neighbours in another order than the reference's top_k, and
    the identity rounds differently from a direct difference."""
    d2 = (
        torch.sum(points**2, dim=1)[:, None]
        + torch.sum(ctrl_old**2, dim=1)[None, :]
        - 2.0 * points @ ctrl_old.T
    )  # [V, C]
    neg_d2, idx = torch.topk(-d2, k, dim=1)  # [V, k]
    d = torch.sqrt(torch.clamp_min(-neg_d2, 1e-12))
    # inverse-distance weights (the reference's robust variant of pgmo's
    # (1 - d/d_max)^2)
    w = 1.0 / (d + 1e-6)
    w = w / torch.sum(w, dim=-1, keepdim=True)  # [V, k]
    g_old = ctrl_old[idx]  # [V, k, 3]
    g_new = ctrl_new[idx]
    R = ctrl_R[idx]  # [V, k, 3, 3]
    local = points[:, None, :] - g_old
    moved = torch.einsum("vkij,vkj->vki", R, local) + g_new
    return torch.sum(w[..., None] * moved, dim=1)


class DeformationGraph:
    """Host-side registry of control nodes tied to factor-graph node ids;
    `deform_points` runs on `device` (CUDA unless the caller passes
    device="cpu")."""

    CHUNK = 65536  # points per _deform_points call: bounded [CHUNK, C] memory

    def __init__(self, config: DeformationConfig = None, device=None):
        self.config = config or DeformationConfig()
        self.device = resolve_device(device)
        self.positions: List[np.ndarray] = []  # original positions
        self.graph_ids: List[int] = []  # factor-graph node index per control

    def add_control(self, position: np.ndarray, graph_id: int):
        self.positions.append(np.asarray(position, np.float32))
        self.graph_ids.append(graph_id)

    @property
    def num_controls(self) -> int:
        return len(self.positions)

    def control_positions(self) -> np.ndarray:
        if not self.positions:
            return np.zeros((0, 3), np.float32)
        return np.stack(self.positions)

    def deform_points(
        self, points: np.ndarray, node_R: np.ndarray, node_t: np.ndarray,
        node_R_old: np.ndarray, node_t_old: np.ndarray,
    ) -> np.ndarray:
        """Deform arbitrary points given optimized vs original node poses.

        node_* are the full factor-graph pose arrays; the control nodes'
        corrections are (R_new R_old^{-1}) with translation g_new."""
        if self.num_controls == 0 or len(points) == 0:
            return points
        ids = np.asarray(self.graph_ids)
        R_old = node_R_old[ids]
        R_new = node_R[ids]
        corr_R = np.einsum("cij,ckj->cik", R_new, R_old)  # R_new @ R_old^T
        g_old = np.stack(
            [node_t_old[i] for i in ids]
        )  # original control positions in graph frame
        g_new = node_t[ids]
        # identity short-circuit: with consistent odometry (e.g. GT poses)
        # the optimized controls coincide with the originals — blending
        # through the embedded deformation would still rewrite every vertex
        # with float rounding noise, costing O(V) per snapshot AND breaking
        # the 4D map's exact-row delta sharing for the whole mesh
        eye = np.eye(3, dtype=corr_R.dtype)
        if (
            np.abs(corr_R - eye).max() < 1e-6
            and np.abs(g_new - g_old).max() < 1e-6
        ):
            return points
        k = min(self.config.interp_k, self.num_controls)

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(self.device)

        g_old_d, corr_R_d, g_new_d = dev(g_old), dev(corr_R), dev(g_new)
        pts = np.asarray(points, np.float32)
        outs = [
            _deform_points(dev(pts[s : s + self.CHUNK]), g_old_d, corr_R_d, g_new_d, k).cpu().numpy()
            for s in range(0, len(pts), self.CHUNK)
        ]
        return np.concatenate(outs)


def interpolate_stamped_corrections(
    stamps_ns: np.ndarray,  # [M] query stamps
    key_stamps_ns: np.ndarray,  # [A] agent keyframe stamps (sorted)
    key_t_old: np.ndarray,  # [A, 3]
    key_t_new: np.ndarray,  # [A, 3]
    key_R_old: np.ndarray = None,  # [A, 3, 3]
    key_R_new: np.ndarray = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-stamp correction transform from the deformed agent trajectory.

    Returns (R_corr [M,3,3], t_old [M,3], t_new [M,3]): a point observed at
    stamp s moves as p' = R_corr (p - t_old(s)) + t_new(s). Mirrors the
    reference's DeformationInterpolator for object positions along the
    trajectory."""
    M = len(stamps_ns)
    A = len(key_stamps_ns)
    if A == 0 or M == 0:
        eye = np.tile(np.eye(3, dtype=np.float32), (M, 1, 1))
        zeros = np.zeros((M, 3), np.float32)
        return eye, zeros, zeros
    idx = np.clip(np.searchsorted(key_stamps_ns, stamps_ns), 1, A - 1) if A > 1 else np.zeros(M, int)
    lo = idx - 1 if A > 1 else np.zeros(M, int)
    hi = idx
    t_lo = key_stamps_ns[lo].astype(np.float64)
    t_hi = key_stamps_ns[hi].astype(np.float64)
    denom = np.maximum(t_hi - t_lo, 1)
    a = np.clip((stamps_ns.astype(np.float64) - t_lo) / denom, 0.0, 1.0)[:, None]
    t_old = (1 - a) * key_t_old[lo] + a * key_t_old[hi]
    t_new = (1 - a) * key_t_new[lo] + a * key_t_new[hi]
    if key_R_old is not None and key_R_new is not None:
        # nearest-keyframe rotation correction (interpolation overkill here)
        near = np.where(a[:, 0] < 0.5, lo, hi)
        R_corr = np.einsum("mij,mkj->mik", key_R_new[near], key_R_old[near])
    else:
        R_corr = np.tile(np.eye(3, dtype=np.float32), (M, 1, 1))
    return R_corr.astype(np.float32), t_old.astype(np.float32), t_new.astype(np.float32)
