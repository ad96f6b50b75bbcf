"""Reconciler: apply detected changes + validated merges to the scene graph.

Equivalent of the reference Reconciler (khronos/src/backend/reconciliation/
reconciler.cpp): object presence intervals estimated via the
minimum-expected-risk midpoint between last-absent and first-evidence
(cpp:201-248; conservative vs optimistic via `time_estimates_conservative`);
verified merges executed — clamp overestimated intervals (cpp:379-412), merge
meshes in a common bbox frame or keep the larger (cpp:320-377), concat
trajectories, union presence intervals, merge the ObjectChange records
(cpp:250-318). Background reconciliation runs the configured MeshMerger.

Mesh mergers:
  ChangeMerger (default; mesh/change_merger.cpp:54-99): erase vertices whose
    ChangeState != Unobserved + vertices within `object_proximity_threshold`
    of any object mesh, then drop dangling faces.
  OverwriteMesh (mesh/overwrite_mesh.cpp:59-135): voxel-hash face centers,
    "newest wins" within a cell by > time_threshold.

Host copy of `khronos_tpu/changes/reconciler.py`. Its one device call, the
nearest-object distance of the ChangeMerger (`eval.evaluators.min_distances`),
runs on `device`: CUDA unless the caller passes device="cpu".
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from khronos_tpu_torch import resolve_device
from khronos_tpu_torch.changes.change_state import UNOBSERVED, Changes, ObjectChange
from khronos_tpu_torch.stm.scene_graph import Mesh, SceneGraph
from khronos_tpu_torch.utils import intervals as iv
from khronos_tpu_torch.utils.timing import Timer


@dataclasses.dataclass
class ReconcilerConfig:
    # Reference default AND all shipped pipeline configs are optimistic
    # (reconciler.h:71 `= false`, uHumans2.yaml:199): without absence
    # evidence an object is presumed present [0, inf) — this is what makes
    # a once-seen chair still "present" when you query a later robot time.
    time_estimates_conservative: bool = False
    merge_object_meshes: bool = False  # else: keep the larger mesh
    mesh_merger: str = "ChangeMerger"  # 'ChangeMerger' | 'OverwriteMesh' | 'none'
    object_proximity_threshold: float = 0.08  # m (vertices near objects removed)
    overwrite_voxel_size: float = 0.1
    overwrite_time_threshold_s: float = 2.0


class Reconciler:
    def __init__(self, config: ReconcilerConfig, device=None):
        self.config = config
        self.device = resolve_device(device)

    # ------------------------------------------------------------------
    def reconcile(self, dsg: SceneGraph, changes: Changes, merges=None) -> SceneGraph:
        """Mutates (a clone of) dsg applying changes; returns it."""
        with Timer("reconciliation/all"):
            self._update_presence(dsg, changes)
            if merges:
                self._execute_merges(dsg, changes, merges)
            with Timer("reconciliation/background"):
                if self.config.mesh_merger == "ChangeMerger":
                    self._change_merge_background(dsg, changes)
                elif self.config.mesh_merger == "OverwriteMesh":
                    self._overwrite_background(dsg)
        return dsg

    # ------------------------------------------------------------------
    def _update_presence(self, dsg: SceneGraph, changes: Changes) -> None:
        """Estimate presence intervals from change evidence (cpp:201-248).

        For an object first seen at t_f and last seen at t_l:
          - if absent evidence exists before t_f at t_a: appearance time =
            midpoint (minimum expected risk) of [t_a, first-evidence-or-t_f];
            else appeared at 0 (conservative) / its first_seen (optimistic).
          - symmetric for disappearance after t_l.
        """
        conservative = self.config.time_estimates_conservative
        for oid, obj in dsg.objects.items():
            oc = changes.object_changes.get(oid)
            if oc is None or obj.is_dynamic:
                continue
            t_f = obj.first_observed_ns[0]
            t_l = obj.last_observed_ns[-1]
            # appearance
            if oc.first_absent_ns >= 0:
                lo = oc.first_absent_ns
                hi = oc.first_persistent_ns if 0 <= oc.first_persistent_ns < t_f else t_f
                start = (lo + max(hi, lo)) // 2
            else:
                if oc.first_persistent_ns >= 0:
                    start = min(oc.first_persistent_ns, t_f)
                else:
                    start = t_f if conservative else 0
            # disappearance
            if oc.last_absent_ns >= 0:
                hi = oc.last_absent_ns
                lo = oc.last_persistent_ns if oc.last_persistent_ns > t_l else t_l
                end = (min(lo, hi) + hi) // 2
            else:
                if oc.last_persistent_ns >= 0:
                    end = max(oc.last_persistent_ns, t_l)
                else:
                    end = t_l if conservative else (1 << 62)
            start = min(start, t_f)
            end = max(end, t_l)
            # preserve knowledge time before rewriting presence: get_dsg's
            # robot-time gate must use when the robot FIRST SAW the object,
            # not the estimated presence start (which can be 0)
            if obj.first_detected_ns < 0:
                obj.first_detected_ns = int(t_f)
            obj.first_observed_ns = [int(start)]
            obj.last_observed_ns = [int(end)]

    # ------------------------------------------------------------------
    def _execute_merges(self, dsg: SceneGraph, changes: Changes, merges) -> None:
        """Apply validated merge proposals (cpp:250-318)."""
        for m in merges:
            if not getattr(m, "is_valid", True):
                continue
            src = dsg.objects.get(m.from_id)
            dst = dsg.objects.get(m.into_id)
            if src is None or dst is None or src is dst:
                continue
            # union presence intervals
            f, l = iv.merge_presence(
                dst.first_observed_ns, dst.last_observed_ns,
                src.first_observed_ns, src.last_observed_ns,
            )
            dst.first_observed_ns, dst.last_observed_ns = f, l
            # knowledge time: earliest actual detection across both
            dets = [d for d in (dst.first_detected_ns, src.first_detected_ns) if d >= 0]
            if dets:
                dst.first_detected_ns = min(dets)
            # mesh: keep larger (or merge in common bbox frame)
            if self.config.merge_object_meshes and len(src.mesh_vertices):
                new_min = np.minimum(dst.bbox_min, src.bbox_min)
                new_max = np.maximum(dst.bbox_max, src.bbox_max)
                dst_v = dst.mesh_vertices + (dst.bbox_min - new_min)
                src_v = src.mesh_vertices + (src.bbox_min - new_min)
                off = len(dst_v)
                dst.mesh_vertices = np.concatenate([dst_v, src_v]).astype(np.float32)
                dst.mesh_faces = np.concatenate(
                    [dst.mesh_faces, src.mesh_faces + off]
                )
                dst.mesh_colors = np.concatenate([dst.mesh_colors, src.mesh_colors])
                dst.bbox_min, dst.bbox_max = new_min, new_max
            elif len(src.mesh_vertices) > len(dst.mesh_vertices):
                dst.mesh_vertices = src.mesh_vertices
                dst.mesh_faces = src.mesh_faces
                dst.mesh_colors = src.mesh_colors
                dst.bbox_min, dst.bbox_max = src.bbox_min, src.bbox_max
            # trajectories (dynamic)
            if len(src.trajectory_positions):
                order = np.argsort(
                    np.concatenate([dst.trajectory_stamps_ns, src.trajectory_stamps_ns])
                )
                stamps = np.concatenate(
                    [dst.trajectory_stamps_ns, src.trajectory_stamps_ns]
                )[order]
                pos = np.concatenate(
                    [
                        np.asarray(dst.trajectory_positions).reshape(-1, 3),
                        np.asarray(src.trajectory_positions).reshape(-1, 3),
                    ]
                )[order]
                dst.trajectory_stamps_ns = stamps.tolist()
                dst.trajectory_positions = pos.astype(np.float32)
            # merge change records: mark the absorbed side only. The
            # survivor does NOT inherit the twin's absence evidence — its
            # own scan already runs over the merged-set observation envelope
            # (detectors._detect_object_changes), and the twin's record was
            # computed against its pre-merge envelope (copying it forward
            # hallucinated appearances, e.g. a twin "absent" before a
            # first-seen the merged object does not have).
            oc_src = changes.object_changes.get(m.from_id)
            changes.object_changes.setdefault(m.into_id, ObjectChange(m.into_id))
            if oc_src is not None:
                oc_src.merged_id = m.into_id
            del dsg.objects[m.from_id]

    # ------------------------------------------------------------------
    def _change_merge_background(self, dsg: SceneGraph, changes: Changes) -> None:
        mesh = dsg.mesh
        V = mesh.num_vertices
        if V == 0:
            return
        states = changes.background_states
        keep = np.ones(V, bool)
        if len(states) == V:
            keep &= states == UNOBSERVED
        # remove vertices near object meshes
        prox = self.config.object_proximity_threshold
        obj_pts = [
            o.world_mesh_vertices() for o in dsg.objects.values() if len(o.mesh_vertices)
        ]
        if obj_pts and prox > 0:
            # exact device kNN (change_merger.cpp:54-99 uses a kNN search) —
            # but only for vertices inside an object's prox-expanded bbox.
            # Candidate gating via MERGED INTERVALS per axis + searchsorted
            # (O(V log B)): the r5 per-object bbox loop cost O(V*B) host time
            # (~2 s/pass at a 1.2M-vertex corridor with 60 objects)
            from khronos_tpu_torch.eval.evaluators import min_distances

            verts = mesh.vertices.astype(np.float32)
            # candidate boxes expand by the WIDENED threshold upper bound
            # (prox + subsample cell diagonal; see thr below)
            pad = prox + max(prox * 0.25, 0.02) * np.sqrt(3.0)
            mns = np.stack([p.min(axis=0) for p in obj_pts]) - pad
            mxs = np.stack([p.max(axis=0) for p in obj_pts]) + pad
            cand = np.ones(len(verts), bool)
            for ax in range(3):
                order = np.argsort(mns[:, ax])
                lo, hi = mns[order, ax], mxs[order, ax]
                # merge overlapping intervals
                m_lo, m_hi = [lo[0]], [hi[0]]
                for a, b in zip(lo[1:], hi[1:]):
                    if a <= m_hi[-1]:
                        m_hi[-1] = max(m_hi[-1], b)
                    else:
                        m_lo.append(a)
                        m_hi.append(b)
                edges = np.empty(2 * len(m_lo), np.float32)
                edges[0::2] = m_lo
                edges[1::2] = m_hi
                # odd searchsorted slot <=> inside some merged interval
                cand &= (np.searchsorted(edges, verts[:, ax], "right") % 2) == 1
            if cand.any():
                # exact per-box containment on the (small) candidate set
                v = verts[cand]
                inside = np.zeros(len(v), bool)
                for mn, mx in zip(mns, mxs):
                    inside |= ((v >= mn) & (v <= mx)).all(axis=1)
                idx = np.nonzero(cand)[0]
                cand[:] = False
                cand[idx[inside]] = True
            if cand.any():
                pts = np.concatenate(obj_pts).astype(np.float32)
                thr = prox
                if len(pts) > 20000:
                    # grid-subsample reference points so kNN cost stops
                    # scaling with total object mesh size. A dropped point
                    # sits up to the CELL DIAGONAL from its kept
                    # representative, so widen the removal threshold by that
                    # bound — over-stripping background slightly near objects
                    # is the safe direction (the strip exists to remove
                    # duplicate shell geometry); under-stripping leaves it
                    cell_sz = max(prox * 0.25, 0.02)
                    cell = np.floor(pts / cell_sz).astype(np.int64)
                    _, first = np.unique(cell, axis=0, return_index=True)
                    pts = pts[first]
                    thr = prox + cell_sz * np.sqrt(3.0)
                near_c = min_distances(verts[cand], pts, device=self.device) <= thr
                near = np.zeros(len(verts), bool)
                near[np.nonzero(cand)[0]] = near_c
                keep &= ~near
        self._filter_mesh(mesh, keep, changes)

    def _overwrite_background(self, dsg: SceneGraph) -> None:
        """'Newest wins' per voxel cell (overwrite_mesh.cpp:59-135)."""
        mesh = dsg.mesh
        if mesh.num_faces == 0:
            return
        vs = self.config.overwrite_voxel_size
        centers = mesh.vertices[mesh.faces].mean(axis=1)
        cell = np.floor(centers / vs).astype(np.int64)
        # vectorized group-by: unique cell -> newest face stamp in that cell
        _, inverse = np.unique(cell, axis=0, return_inverse=True)
        face_t = mesh.last_seen_ns[mesh.faces].max(axis=1)
        newest = np.full(inverse.max() + 1, np.iinfo(np.int64).min, np.int64)
        np.maximum.at(newest, inverse, face_t)
        thr = int(self.config.overwrite_time_threshold_s * 1e9)
        face_keep = face_t >= newest[inverse] - thr
        mesh.faces = mesh.faces[face_keep]
        used = np.zeros(mesh.num_vertices, bool)
        used[mesh.faces.reshape(-1)] = True
        self._filter_mesh(mesh, used, None)

    @staticmethod
    def _filter_mesh(mesh: Mesh, keep: np.ndarray, changes: Optional[Changes]) -> None:
        """Compact vertices by mask; drop faces missing a vertex."""
        remap = -np.ones(mesh.num_vertices, np.int64)
        remap[keep] = np.arange(int(keep.sum()))
        mesh.vertices = mesh.vertices[keep]
        mesh.colors = mesh.colors[keep]
        mesh.labels = mesh.labels[keep]
        mesh.first_seen_ns = mesh.first_seen_ns[keep]
        mesh.last_seen_ns = mesh.last_seen_ns[keep]
        if mesh.num_faces:
            f = remap[mesh.faces]
            mesh.faces = f[(f >= 0).all(axis=1)]
        if changes is not None and len(changes.background_states) == len(keep):
            changes.background_states = changes.background_states[keep]
