"""SpatioTemporalMap: the queryable 4D map (scene state at all times).

Equivalent of khronos::SpatioTemporalMap (khronos/src/spatio_temporal_map/
spatio_temporal_map.cpp): stores one reconciled DSG snapshot per
change-detection pass (h:120-123); `finalize` sorts mesh vertices by
first-seen stamp so any time slice is a prefix (cpp:120-135); query
`getDsg(robot_time)` picks the closest snapshot and filters mesh
vertices/faces (all-vertices-present, cpp:646-661), objects by effective
appearance time (cpp:244-293), and trims dynamic trajectories (cpp:295-325);
binary save/load with a version field (cpp:545-640, `.4dmap`).

Storage design (r5): snapshots share ONE CANONICAL UNION mesh per geometry
epoch. The backend accumulator is append-only between optimizations that
move geometry, so every snapshot's reconciled mesh is `union[:L][keep]`
plus per-row value mutations:

  - `_unions[u]` — the canonical mesh chunk in RAW ACCUMULATOR ORDER
    (insertion order is the only genuinely append-only order: first_seen
    can DECREASE when a re-added vertex carries an earlier stamp, so any
    stamp-sorted order reshuffles between passes). Positions are frozen;
    colors / labels / first_seen / last_seen hold the LATEST values; faces
    are the accumulator's, append-only, already in union indexing.
  - per snapshot: union id `u`, covered length `L`, face count `F`, a
    `keep` bitmask over union[:L] (reconciliation removals), and REVERSE
    value-diffs `rev` (the values this snapshot's update overwrote) so any
    older snapshot's values reconstruct by walking the diffs backward.

Earlier rounds deltad each snapshot against the PREVIOUS RECONCILED mesh;
vertices removed by reconciliation reappear from the accumulator on the
next pass and interleave into the prefix, so the prefix check failed and
nearly every snapshot stored a full ~100 MB copy (3.2 GB over a 3,000-frame
endurance run). Against the union the prefix property holds by
construction. A geometry-moving optimization (positions deform) starts a
fresh union chunk — the reference's recomputeHash-on-loop-closure
semantics.

Semantics of query(robot_time): "what the robot KNEW at robot_time" — the
latest snapshot taken at or before robot_time, restricted to geometry first
seen by then. (The reference additionally supports query_time scrubbing
within a snapshot — exposed here via the `query_time_ns` argument using
presence intervals.)

Host copy of `khronos_tpu/stm/spatio_temporal_map.py`: the `.4dmap.npz`
archive is the JAX package's key for key and dtype for dtype (version 4, and
the legacy loader of versions 1-3), so each package reads what the other
writes, places layers included.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from khronos_tpu_torch.stm import serialization
from khronos_tpu_torch.stm.scene_graph import Mesh, SceneGraph
from khronos_tpu_torch.utils import intervals as iv

FORMAT_VERSION = 4

_REV_FIELDS = ("color", "label", "seen", "first")


class _SnapshotView:
    """List-like view over union-shared snapshots (materialized on access)."""

    def __init__(self, stm: "SpatioTemporalMap"):
        self._stm = stm

    def __len__(self) -> int:
        return len(self._stm._stores)

    def __getitem__(self, i):
        n = len(self)
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(n))]
        if i < 0:
            i += n
        return self._stm._materialize(i)

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]


class SpatioTemporalMap:
    def __init__(self):
        self.stamps_ns: List[int] = []
        # canonical union chunks: one per geometry epoch
        # {"mesh": Mesh (faces in union indexing; colors/labels/last_seen =
        #  values as of the LAST snapshot using this union)}
        self._unions: List[Mesh] = []
        # per snapshot: {"u", "L", "F", "keep" (bool[L]), "rev" ({field:
        #  (idx, old_values)}), "graph" (SceneGraph with an EMPTY mesh)}
        self._stores: List[dict] = []

    @property
    def snapshots(self) -> _SnapshotView:
        return _SnapshotView(self)

    # ------------------------------------------------------------------
    @staticmethod
    def _row_keys(mesh: Mesh) -> np.ndarray:
        """int64 POSITION key per vertex: the accumulator dedups on a
        quantization grid, so positions are unique identifiers; stamps are
        mutable (first_seen decreases when a re-added vertex carries an
        earlier stamp) and must not enter identity. Collision mismatches
        are caught by the membership count check."""
        xb = np.ascontiguousarray(mesh.vertices, np.float32).view(np.uint32)
        k = xb[:, 0].astype(np.int64) * np.int64(0x9E3779B1)
        k ^= xb[:, 1].astype(np.int64) * np.int64(0x85EBCA77)
        k ^= xb[:, 2].astype(np.int64) * np.int64(0xC2B2AE3D)
        return k

    @staticmethod
    def _values_of(mesh: Mesh, sel) -> dict:
        return {
            "color": mesh.colors[sel],
            "label": mesh.labels[sel],
            "seen": mesh.last_seen_ns[sel],
            "first": mesh.first_seen_ns[sel],
        }

    def _start_union(
        self, P: Mesh, new: Mesh, graph: SceneGraph, stamp_ns: int
    ) -> None:
        """Begin a fresh canonical chunk holding the canonical mesh `P`
        verbatim; the snapshot's keep mask selects the reconciled `new`
        subset (P is new when no canonical stream is supplied)."""
        self._unions.append(Mesh(
            vertices=P.vertices.copy(),
            colors=P.colors.copy(),
            labels=P.labels.copy(),
            first_seen_ns=P.first_seen_ns.copy(),
            last_seen_ns=P.last_seen_ns.copy(),
            faces=P.faces.copy(),
        ))
        if P is new:
            keep = np.ones(P.num_vertices, bool)
        else:
            keep = np.isin(self._row_keys(P), self._row_keys(new))
            if int(keep.sum()) != new.num_vertices:
                # position-key collision: fall back to storing the
                # RECONCILED mesh verbatim as this chunk (correct, just
                # unshared) — re-running the same colliding isin would bake
                # a wrong keep mask in exactly the case it failed (r5
                # review finding)
                self._unions[-1] = new.clone()
                keep = np.ones(new.num_vertices, bool)
                P = new
        self._stores.append({
            "u": len(self._unions) - 1,
            "L": P.num_vertices,
            "F": P.num_faces,
            "keep": keep,
            "rev": {f: (np.zeros(0, np.int64), None) for f in _REV_FIELDS},
            "graph": graph,
        })
        self.stamps_ns.append(int(stamp_ns))

    def update(
        self,
        dsg: SceneGraph,
        stamp_ns: int,
        canonical_mesh: Optional[Mesh] = None,
    ) -> None:
        """Add a reconciled snapshot. `canonical_mesh` is the
        PRE-reconciliation mesh (raw accumulator order) the union chain
        extends from — reconciliation strips near-object vertices EVERY
        pass, so rows stripped on their very first pass never reach the
        reconciled mesh yet reappear from the accumulator later (r5
        finding: 31 of 33 endurance snapshots forked a fresh union). The
        accumulator stream is append-only IN INSERTION ORDER between
        deformations, so the extension check is a positional compare."""
        snap = dsg.clone(share_arrays=True)
        new = snap.mesh
        P = canonical_mesh if canonical_mesh is not None else new
        snap.mesh = Mesh.empty()  # the union owns the geometry
        if not self._unions or P.num_vertices == 0:
            self._start_union(P, new, snap, stamp_ns)
            return
        union = self._unions[-1]
        Lp, Vp = union.num_vertices, P.num_vertices
        Fp = union.num_faces
        if not (
            Vp >= Lp
            and np.array_equal(P.vertices[:Lp], union.vertices)
            and P.num_faces >= Fp
            and np.array_equal(P.faces[:Fp], union.faces)
        ):
            # geometry moved (deformation) or a non-accumulator stream:
            # fresh canonical chunk
            self._start_union(P, new, snap, stamp_ns)
            return
        # snapshot membership FIRST (before any union mutation): which
        # canonical rows survive in the RECONCILED mesh (all of them when
        # no canonical stream is supplied)
        if P is new:
            keep = np.ones(Vp, bool)
        else:
            keep = np.isin(self._row_keys(P), self._row_keys(new))
            if int(keep.sum()) != new.num_vertices:
                # key collision or mismatch: fall back to a fresh chunk
                self._start_union(P, new, snap, stamp_ns)
                return
        # REVERSE diffs: remember the union values this update overwrites
        rev = {}
        new_vals = self._values_of(P, slice(0, Lp))
        old_vals = self._values_of(union, slice(None))
        for fld in _REV_FIELDS:
            nv, ov = new_vals[fld], old_vals[fld]
            ch = (
                np.nonzero((nv != ov).any(axis=1))[0]
                if nv.ndim == 2 else np.nonzero(nv != ov)[0]
            )
            rev[fld] = (ch.astype(np.int64), ov[ch].copy())
        # write the new values + append the tail
        union.colors = P.colors.copy()
        union.labels = P.labels.copy()
        union.first_seen_ns = P.first_seen_ns.copy()
        union.last_seen_ns = P.last_seen_ns.copy()
        union.vertices = np.concatenate([union.vertices, P.vertices[Lp:]])
        union.faces = np.concatenate([union.faces, P.faces[Fp:]])
        self._stores.append({
            "u": len(self._unions) - 1,
            "L": union.num_vertices,
            "F": union.num_faces,
            "keep": keep,
            "rev": rev,
            "graph": snap,
        })
        self.stamps_ns.append(int(stamp_ns))

    # ------------------------------------------------------------------
    def _materialize(self, i: int) -> SceneGraph:
        """Full SceneGraph for snapshot i (mesh rebuilt from its union)."""
        store = self._stores[i]
        if store.get("_cache") is not None:
            return store["_cache"]
        u = store["u"]
        union = self._unions[u]
        L, F, keep = store["L"], store["F"], store["keep"]
        colors = union.colors[:L].copy()
        labels = union.labels[:L].copy()
        seen = union.last_seen_ns[:L].copy()
        first = union.first_seen_ns[:L].copy()
        # rewind value mutations applied by NEWER snapshots of this union
        for j in range(len(self._stores) - 1, i, -1):
            st = self._stores[j]
            if st["u"] != u:
                continue
            for fld, arr in (
                ("color", colors), ("label", labels),
                ("seen", seen), ("first", first),
            ):
                idx, old = st["rev"][fld]
                if old is None or len(idx) == 0:
                    continue
                m = idx < L
                arr[idx[m]] = old[m]
        sel = np.nonzero(keep)[0]
        remap = -np.ones(L, np.int64)
        remap[keep] = np.arange(len(sel))
        uf = union.faces[:F]
        if len(uf):
            f = remap[uf]
            faces = f[(f >= 0).all(axis=1)]
        else:
            faces = np.zeros((0, 3), np.int64)
        mesh = Mesh(
            vertices=union.vertices[:L][keep],
            colors=colors[keep],
            labels=labels[keep],
            first_seen_ns=first[keep],
            last_seen_ns=seen[keep],
            faces=faces,
        )
        out = store["graph"].clone()
        out.mesh = mesh
        # the union lives in raw accumulator order; queries need the
        # first-seen prefix order (reference finalizeMesh, cpp:120-135)
        self._finalize(out)
        # cache only the most recent materialization (the common access)
        for st in self._stores:
            st.pop("_cache", None)
        store["_cache"] = out
        return out

    @staticmethod
    def _finalize(dsg: SceneGraph) -> None:
        mesh = dsg.mesh
        if mesh.num_vertices == 0:
            return
        if np.all(mesh.first_seen_ns[1:] >= mesh.first_seen_ns[:-1]):
            return  # appended in stamp order + order-preserving filters
        order = np.argsort(mesh.first_seen_ns, kind="stable")
        remap = np.empty(len(order), np.int64)
        remap[order] = np.arange(len(order))
        mesh.vertices = mesh.vertices[order]
        mesh.colors = mesh.colors[order]
        mesh.labels = mesh.labels[order]
        mesh.first_seen_ns = mesh.first_seen_ns[order]
        mesh.last_seen_ns = mesh.last_seen_ns[order]
        if mesh.num_faces:
            mesh.faces = remap[mesh.faces]

    # ------------------------------------------------------------------
    @property
    def num_snapshots(self) -> int:
        return len(self._stores)

    def stamps(self) -> List[int]:
        return list(self.stamps_ns)

    def earliest_ns(self) -> int:
        return self.stamps_ns[0] if self.stamps_ns else 0

    def latest_ns(self) -> int:
        return self.stamps_ns[-1] if self.stamps_ns else 0

    # ------------------------------------------------------------------
    def get_dsg(
        self, robot_time_ns: int, query_time_ns: Optional[int] = None
    ) -> Optional[SceneGraph]:
        """Scene state as known at robot_time (optionally evaluated at
        query_time for presence filtering). Returns a fresh SceneGraph."""
        if not self._stores:
            return None
        idx = int(np.searchsorted(self.stamps_ns, robot_time_ns, side="right")) - 1
        idx = max(idx, 0)
        snap = self._materialize(idx)
        out = SceneGraph()
        q = robot_time_ns if query_time_ns is None else query_time_ns

        # mesh: prefix of vertices first seen by robot_time
        mesh = snap.mesh
        n_vis = int(np.searchsorted(mesh.first_seen_ns, robot_time_ns, side="right"))
        out.mesh = Mesh(
            vertices=mesh.vertices[:n_vis].copy(),
            colors=mesh.colors[:n_vis].copy(),
            labels=mesh.labels[:n_vis].copy(),
            first_seen_ns=mesh.first_seen_ns[:n_vis].copy(),
            last_seen_ns=mesh.last_seen_ns[:n_vis].copy(),
            faces=mesh.faces[(mesh.faces < n_vis).all(axis=1)].copy()
            if mesh.num_faces
            else mesh.faces.copy(),
        )

        # agents: trajectory up to robot_time
        out.agents = [a for a in snap.agents if a.stamp_ns <= robot_time_ns]

        # objects: known by robot_time (gate on DETECTION time, not the
        # reconciled presence start which can be 0 for never-absent objects —
        # reference keys on explicit first-observed, cpp:244-293); presence
        # filtering at query time stays on the intervals
        for oid, o in snap.objects.items():
            if not o.first_observed_ns or o.detected_ns() > robot_time_ns:
                continue
            oc = o.clone()
            if oc.is_dynamic:
                keep = [i for i, s in enumerate(oc.trajectory_stamps_ns) if s <= robot_time_ns]
                if not keep:
                    continue
                oc.trajectory_stamps_ns = [oc.trajectory_stamps_ns[i] for i in keep]
                oc.trajectory_positions = np.asarray(oc.trajectory_positions).reshape(-1, 3)[keep]
            out.objects[oid] = oc
        return out

    def objects_present_at(self, robot_time_ns: int, query_time_ns: int) -> Dict[int, object]:
        """Objects the robot knew at robot_time that were present at query_time."""
        dsg = self.get_dsg(robot_time_ns)
        if dsg is None:
            return {}
        return {
            oid: o
            for oid, o in dsg.objects.items()
            if iv.is_present(o.first_observed_ns, o.last_observed_ns, query_time_ns)
        }

    # ------------------------------------------------------------------
    def save(self, path: str) -> None:
        """Versioned `.4dmap` archive (npz). Version 4 stores the
        union-shared form: canonical mesh chunks + per-snapshot keep masks
        and reverse value-diffs, so the file grows with the changes, not
        O(snapshots x vertices)."""
        arrays = {
            "format_version": np.asarray([FORMAT_VERSION]),
            "stamps_ns": np.asarray(self.stamps_ns, np.int64),
            "n_unions": np.asarray([len(self._unions)]),
            "snap_meta": np.asarray(
                [[s["u"], s["L"], s["F"]] for s in self._stores], np.int64
            ).reshape(len(self._stores), 3),
        }
        for u, mesh in enumerate(self._unions):
            g = SceneGraph(mesh=mesh)
            arrays.update(
                serialization.scene_graph_arrays(g, prefix=f"union/{u}/")
            )
        for i, store in enumerate(self._stores):
            g = store["graph"].clone(share_arrays=True)
            arrays.update(
                serialization.scene_graph_arrays(g, prefix=f"snap/{i}/")
            )
            arrays[f"snap/{i}/keep"] = np.packbits(store["keep"])
            arrays[f"snap/{i}/keep_len"] = np.asarray([len(store["keep"])])
            for fld in _REV_FIELDS:
                idx, old = store["rev"][fld]
                arrays[f"snap/{i}/rev_{fld}_idx"] = idx
                if old is not None and len(idx):
                    arrays[f"snap/{i}/rev_{fld}_val"] = old
        np.savez_compressed(path, **arrays)

    @staticmethod
    def load(path: str) -> "SpatioTemporalMap":
        out = SpatioTemporalMap()
        with np.load(path, allow_pickle=False) as data:
            version = int(data["format_version"][0])
            if version in (1, 2, 3):
                return SpatioTemporalMap._load_legacy(data, version)
            if version != 4:
                raise ValueError(f"unsupported 4dmap version {version}")
            stamps = data["stamps_ns"]
            out.stamps_ns = [int(s) for s in stamps]
            for u in range(int(data["n_unions"][0])):
                out._unions.append(
                    serialization.scene_graph_from_arrays(
                        data, prefix=f"union/{u}/"
                    ).mesh
                )
            meta = data["snap_meta"].reshape(-1, 3)
            for i in range(len(stamps)):
                n = int(data[f"snap/{i}/keep_len"][0])
                keep = np.unpackbits(data[f"snap/{i}/keep"])[:n].astype(bool)
                rev = {}
                for fld in _REV_FIELDS:
                    idx = data[f"snap/{i}/rev_{fld}_idx"]
                    val = (
                        data[f"snap/{i}/rev_{fld}_val"]
                        if f"snap/{i}/rev_{fld}_val" in data
                        else None
                    )
                    rev[fld] = (idx, val)
                out._stores.append({
                    "u": int(meta[i, 0]),
                    "L": int(meta[i, 1]),
                    "F": int(meta[i, 2]),
                    "keep": keep,
                    "rev": rev,
                    "graph": serialization.scene_graph_from_arrays(
                        data, prefix=f"snap/{i}/"
                    ),
                })
        return out

    @staticmethod
    def _load_legacy(data, version: int) -> "SpatioTemporalMap":
        """v1-3 files stored per-snapshot mesh deltas against the previous
        RECONCILED mesh; materialize each and re-ingest into the union form."""
        stamps = data["stamps_ns"]
        bases = (
            data["bases"] if version >= 2 else np.full(len(stamps), -1, np.int64)
        )
        full_meshes: List[Mesh] = []
        graphs: List[SceneGraph] = []
        for i in range(len(stamps)):
            g = serialization.scene_graph_from_arrays(data, prefix=f"snap/{i}/")
            graphs.append(g)
            mesh = g.mesh
            if int(bases[i]) >= 0:
                prev = full_meshes[int(bases[i])]
                n = int(data[f"snap/{i}/keep_len"][0])
                keep = np.unpackbits(data[f"snap/{i}/keep"])[:n].astype(bool)
                sel = np.nonzero(keep)[0]
                n_old = len(sel)
                remap = -np.ones(n, np.int64)
                remap[keep] = np.arange(n_old)
                derived = (
                    remap[prev.faces][(remap[prev.faces] >= 0).all(axis=1)]
                    if prev.num_faces
                    else np.zeros((0, 3), np.int64)
                )
                colors = prev.colors[sel].copy()
                labels = prev.labels[sel].copy()
                seen = prev.last_seen_ns[sel].copy()
                if f"snap/{i}/diff_color_idx" in data:  # v3 sparse diffs
                    colors[data[f"snap/{i}/diff_color_idx"]] = data[f"snap/{i}/diff_color_val"]
                    labels[data[f"snap/{i}/diff_label_idx"]] = data[f"snap/{i}/diff_label_val"]
                    seen[data[f"snap/{i}/diff_seen_idx"]] = data[f"snap/{i}/diff_seen_val"]
                elif f"snap/{i}/last_seen" in data:  # v2 full last_seen
                    seen = data[f"snap/{i}/last_seen"][:n_old]
                tail = mesh
                mesh = Mesh(
                    vertices=np.concatenate([prev.vertices[sel], tail.vertices]),
                    colors=np.concatenate([colors, tail.colors]),
                    labels=np.concatenate([labels, tail.labels]),
                    first_seen_ns=np.concatenate(
                        [prev.first_seen_ns[sel], tail.first_seen_ns]
                    ),
                    last_seen_ns=np.concatenate([seen, tail.last_seen_ns]),
                    faces=np.concatenate([derived, tail.faces]),
                )
            full_meshes.append(mesh)
        out = SpatioTemporalMap()
        for i, (g, mesh) in enumerate(zip(graphs, full_meshes)):
            g.mesh = mesh
            out.update(g, int(stamps[i]))
        return out
