"""Backend orchestrator (L3): factor-graph state, loop closures, deformation,
object merge proposals, and the optimized scene graph.

Port of `khronos_tpu/backend/backend.py`, the equivalent of khronos::Backend
(khronos/src/backend/backend.cpp:125-187): per input — update factor graph from pose-graph increments, copy mesh delta,
consume loop closures, optimize when needed, then update the DSG and run the
update functors (move objects along the deformed trajectory, propose merges —
update_khronos_objects_functor.cpp:41-107). Change detection runs downstream
on the DSG snapshots this module produces (changes/).

Frames: the active window runs in the ODOMETRY frame; this backend stores raw
odometry-frame geometry and produces a corrected SceneGraph by applying the
optimized trajectory corrections (kimera_pgmo-style deformation).

The host logic is the reference's. The device work (the pose-graph solve,
the mesh deformation) runs on `device`: CUDA unless the caller passes
device="cpu". The mesh accumulator is the native one (`native.py`). Only the
dense solver is ported: `solver="schur"` raises until `backend/distributed.py`
is ported.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from khronos_tpu_torch import resolve_device
from khronos_tpu_torch.config import Plugin, plugin_field
from khronos_tpu_torch.active_window.active_window import ActiveWindowOutput
from khronos_tpu_torch.backend import factor_graph as fg
from khronos_tpu_torch.backend.deformation import (
    DeformationConfig,
    DeformationGraph,
    interpolate_stamped_corrections,
    sample_control_points,
)
from khronos_tpu_torch.backend.loop_closure import LoopClosure
from khronos_tpu_torch.geometry import bbox as bbox_util
from khronos_tpu_torch.native import make_mesh_accumulator
from khronos_tpu_torch.stm import serialization
from khronos_tpu_torch.stm.scene_graph import AgentNode, KhronosObject, SceneGraph
from khronos_tpu_torch.utils.intervals import is_present
from khronos_tpu_torch.utils.timing import Timer


@dataclasses.dataclass
class MergeProposal:
    from_id: int
    into_id: int
    iou: float
    is_valid: bool = True
    # add_merge_factor plumbing (reference backend.h:149-155): the proposal's
    # identity between-factor index in the graph, and whether a GNC pass has
    # judged it yet. Only validated+valid proposals reach the reconciler.
    factor_idx: int = -1
    validated: bool = False


@dataclasses.dataclass
class BackendConfig:
    optimize_on_lc: bool = True
    enable_node_merging: bool = True
    merge_min_iou: float = 0.3
    add_merge_factor: bool = True
    fix_input_poses: bool = False  # inject pose priors from provided GT poses
    mesh_resolution: float = 0.02  # vertex dedup grid (pgmo mesh_resolution)
    sigma_odom_trans: float = 0.05
    sigma_odom_rot: float = 0.01
    sigma_lc_trans: float = 0.02
    sigma_lc_rot: float = 0.005
    sigma_control_trans: float = 0.3  # mesh control rigidity
    # object-node covariances (reference backend.h:63-88 pose_object /
    # object_merge): anchor factor keyframe->object, and the identity merge
    # factor GNC judges for proposal validation. Anchors must be STIFF
    # relative to the merge factor — the object's pose relative to its
    # keyframe is a direct observation; if anchors were soft the optimizer
    # could satisfy a wrong merge by bending both anchors to the midpoint,
    # keeping the merge residual (the thing GNC judges) deceptively small.
    sigma_pose_object_trans: float = 0.01
    sigma_pose_object_rot: float = 0.01
    # merge-factor noise reflects CENTROID-EXTRACTION error (two partial
    # views of one object differ by ~0.1-0.3 m), NOT trajectory error: at
    # 0.1 the identity factor was stiff enough to bend a perfectly
    # consistent trajectory by ~9 cm per judging solve (r4 hard-scene
    # finding), forcing full ray-library rebuilds; at 0.2 the distortion is
    # ~4 cm (under the epoch threshold) while the GNC inlier bound (3.26 sigma
    # = 0.65 m) still separates genuine twins (~0.15 m) from adjacent
    # distinct pairs (>= 1 m)
    sigma_object_merge_trans: float = 0.2
    sigma_object_merge_rot: float = 0.2
    # 'dense': single-device dense GN (graphs of 10^2-10^3 nodes).
    # 'schur' (Schur-eliminate the mesh-control block, backend/distributed.py)
    # is not ported yet and raises
    solver: str = "dense"
    # LC consistency gate (r4 endurance finding): on a drift-free stretch
    # every return-leg loop closure triggered a full solve that moved
    # nothing — 8 x 57 s inline in the frame loop collapsed sustained fps
    # to 2. A new LC whose weighted chi2 residual at the CURRENT estimates
    # is already below the GNC inlier gate (gnc_barc2) cannot change the
    # optimum: the factor enters the graph (it still stiffens future
    # solves) but the solve is deferred until an LC actually disagrees
    # with the trajectory. Mirrors incremental RPGO semantics (solve on
    # new information, not on every factor).
    lc_consistency_gate: bool = True
    # with every LC-solve gated away, pending merge proposals would only be
    # GNC-judged at finish_processing; run a judging solve at most this
    # often (s) while unjudged proposals exist
    merge_judging_interval_s: float = 30.0
    # agent/control motion below this (m) does not bump the geometry epoch:
    # judging a merge factor perturbs even a consistent trajectory by a few
    # cm (soft factors distribute the residual), and a 1e-6 gate forced full
    # ray-library rebuilds + full 4D snapshot chunks per CD pass (r4
    # hard-scene finding: update_verificator 39 s/pass). 0.05 m = half the
    # CD radial tolerance: sub-threshold motion cannot flip a ray
    # classification, and the 4D map's delta sharing verifies exact rows
    # anyway (falls back to a full store when geometry actually moved).
    geometry_epoch_threshold: float = 0.05
    optimizer: fg.OptimizerConfig = dataclasses.field(default_factory=fg.OptimizerConfig)
    deformation: DeformationConfig = dataclasses.field(default_factory=DeformationConfig)
    lcd: Plugin = plugin_field("lcd", "GtLoopClosure")


class Backend:
    def __init__(self, config: BackendConfig, device=None):
        """device: where the solve and the deformation run; CUDA unless the
        caller passes device="cpu" (raises when no GPU is visible)."""
        if config.solver != "dense":
            raise NotImplementedError(
                f"solver '{config.solver}' is not ported yet (a later slice: backend/distributed.py)"
            )
        self.config = config
        self.device = resolve_device(device)
        self.graph = fg.FactorGraphData()
        self.deformation = DeformationGraph(config.deformation, device=self.device)
        self.mesh_acc = make_mesh_accumulator(config.mesh_resolution)
        self.objects: Dict[int, KhronosObject] = {}  # raw odometry-frame objects
        self.agents: List[AgentNode] = []  # raw odometry-frame agent nodes
        self.agent_keys: List[int] = []  # graph node id per agent
        self.lcd = config.lcd.create(device=self.device)
        # optional places-layer feed for LCDs with needs_places (the hydra
        # LCD places tier): a callable returning (positions [P,3],
        # clearances [P]) or None; wired by the pipeline when a places
        # extractor is configured
        self.places_provider = None
        self.loop_closures: List[LoopClosure] = []
        self.proposed_merges: List[MergeProposal] = []
        self._geometry_epoch = 0  # bumped only when a solve moves geometry
        self._object_keys: Dict[int, int] = {}  # object node_id -> graph key
        self._opt_result: Optional[fg.OptimizeResult] = None
        self._orig_R: List[np.ndarray] = []  # graph-node initial poses
        self._orig_t: List[np.ndarray] = []
        self._next_object_id = 1
        self.num_optimizations = 0
        self.optimizes_skipped_consistent = 0
        self._last_judge_ns = -(1 << 62)

    # ------------------------------------------------------------------
    def add_output(
        self,
        out: ActiveWindowOutput,
        gt_pose: Optional[Tuple[np.ndarray, np.ndarray]] = None,
        lcd_frame: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    ) -> bool:
        """Consume one active-window output. Returns True if an optimization
        ran (loop closure). `lcd_frame` = (points_c, valid) camera-frame
        vertex image for descriptor LCD (detectors with needs_frame=True)."""
        cfg = self.config
        with Timer("backend/add_output", out.stamp_ns):
            # 1) agent node + odometry factor. The graph node's initial
            # estimate chains the raw odometry increment onto the (possibly
            # already optimized) previous node estimate; the raw odometry pose
            # is kept separately as the deformation reference frame.
            agent = AgentNode(out.stamp_ns, out.R_w_b.copy(), out.t_w_b.copy(), 0)
            if self.agents:
                prev = self.agents[-1]
                prev_key = self.agent_keys[-1]
                Rrel = prev.R_w_b.T @ out.R_w_b
                trel = prev.R_w_b.T @ (out.t_w_b - prev.t_w_b)
                R_est = self.graph.node_R[prev_key] @ Rrel
                t_est = self.graph.node_R[prev_key] @ trel + self.graph.node_t[prev_key]
                key = self._add_node(R_est, t_est, orig=(out.R_w_b, out.t_w_b))
                self.graph.add_between(
                    prev_key, key, Rrel, trel,
                    sigma_rot=cfg.sigma_odom_rot, sigma_trans=cfg.sigma_odom_trans,
                )
            else:
                key = self._add_node(out.R_w_b, out.t_w_b)
                self.graph.add_prior(key, out.R_w_b, out.t_w_b)
            agent.key = key
            if cfg.fix_input_poses and gt_pose is not None:
                self.graph.add_prior(key, gt_pose[0], gt_pose[1],
                                     sigma_rot=0.001, sigma_trans=0.001)
            self.agents.append(agent)
            self.agent_keys.append(key)

            # 2) mesh delta -> accumulator + new control nodes
            if len(out.mesh_vertices):
                with Timer("backend/mesh_accumulate"):
                    self.mesh_acc.add_triangles(
                        out.mesh_vertices, out.mesh_colors, out.mesh_first_ns,
                        out.mesh_last_ns, out.mesh_labels,
                    )
                with Timer("backend/sample_controls"):
                    new_ctrl = sample_control_points(
                        out.mesh_vertices.reshape(-1, 3),
                        cfg.deformation.d_graph_resolution,
                        existing=self.deformation.control_positions(),
                    )
                with Timer("backend/add_controls"):
                    for c in new_ctrl:
                        ckey = self._add_node(np.eye(3, dtype=np.float32), c)
                        self.deformation.add_control(c, ckey)
                        # tie control to the current agent keyframe (valence
                        # edge, measurement in the shared odometry frame)
                        self.graph.add_between(
                            key, ckey, out.R_w_b.T, out.R_w_b.T @ (c - out.t_w_b),
                            sigma_rot=0.05, sigma_trans=cfg.sigma_control_trans,
                        )

            # 3) objects
            for obj in out.objects:
                obj.node_id = self._next_object_id
                self._next_object_id += 1
                self.objects[obj.node_id] = obj

            # 4) loop closures: GT oracle consumes GT poses; descriptor LCD
            # consumes the sensor frame (real-data path, no oracle)
            _t_lc = Timer("backend/lcd_section")
            _t_lc.__enter__()
            lcs: List[LoopClosure] = []
            if self.lcd is not None and hasattr(self.lcd, "on_geometry_epoch"):
                # stale-descriptor invalidation for place-gated LCDs
                self.lcd.on_geometry_epoch(self._geometry_epoch)
            if self.lcd is not None and hasattr(self.lcd, "add_keyframe"):
                if getattr(self.lcd, "needs_frame", False) and getattr(
                    self.lcd, "needs_scene", False
                ):
                    # hybrid constellation + appearance stack: consumes the
                    # sensor frame AND the object layer (+ the places layer
                    # for the descriptor-gate tier when wired)
                    if lcd_frame is not None:
                        kw = {}
                        if (
                            getattr(self.lcd, "needs_places", False)
                            and self.places_provider is not None
                        ):
                            kw["places"] = self.places_provider()
                        lcs = self.lcd.add_keyframe(
                            key, out.stamp_ns, *lcd_frame,
                            out.R_w_b, out.t_w_b, self.objects.values(), **kw,
                        )
                elif getattr(self.lcd, "needs_frame", False):
                    if lcd_frame is not None:
                        lcs = self.lcd.add_keyframe(
                            key, out.stamp_ns, *lcd_frame,
                            out.R_w_b, out.t_w_b,
                        )
                elif getattr(self.lcd, "needs_scene", False):
                    # scene-graph object-descriptor LCD: constellation of
                    # recently detected objects around the keyframe
                    lcs = self.lcd.add_keyframe(
                        key, out.stamp_ns, out.R_w_b, out.t_w_b,
                        self.objects.values(),
                    )
                elif gt_pose is not None:
                    lcs = self.lcd.add_keyframe(key, out.stamp_ns, gt_pose[0], gt_pose[1])
            for lc in lcs:
                self.loop_closures.append(lc)
                self.graph.add_between(
                    lc.from_key, lc.to_key, lc.R, lc.t,
                    sigma_rot=lc.sigma_rot if lc.sigma_rot is not None else cfg.sigma_lc_rot,
                    sigma_trans=lc.sigma_trans if lc.sigma_trans is not None else cfg.sigma_lc_trans,
                    robust=True,
                )
            _t_lc.__exit__(None, None, None)
            if lcs and cfg.optimize_on_lc:
                new_fidx = range(self.graph.num_between - len(lcs), self.graph.num_between)
                if cfg.lc_consistency_gate and all(
                    self._between_chi2(k) <= cfg.optimizer.gnc_barc2 for k in new_fidx
                ):
                    # consistent LCs cannot move the optimum — defer the
                    # solve, but keep the merge machinery alive
                    self.optimizes_skipped_consistent += 1
                    if cfg.enable_node_merging:
                        self._propose_merges()
                    if any(not p.validated for p in self.proposed_merges) and (
                        out.stamp_ns - self._last_judge_ns
                        >= int(cfg.merge_judging_interval_s * 1e9)
                    ):
                        self._last_judge_ns = out.stamp_ns
                        self.optimize()
                else:
                    self._last_judge_ns = out.stamp_ns
                    self.optimize()
                return True
        return False

    def _between_chi2(self, k: int) -> float:
        """Weighted chi2 of between factor k at the current node estimates
        (same formula as fg._between_errors, on the host's CPU for a single
        factor, whatever the backend's device)."""
        g = self.graph

        def t(a):
            return torch.from_numpy(np.asarray(a, np.float32))

        zero = torch.zeros(6)
        r = fg._between_residual(
            zero, zero, t(g.node_R[g.b_i[k]]), t(g.node_t[g.b_i[k]]),
            t(g.node_R[g.b_j[k]]), t(g.node_t[g.b_j[k]]), t(g.b_R[k]), t(g.b_t[k]),
        ).numpy()
        return float(np.sum((r * np.asarray(g.b_sqrt_info[k])) ** 2))

    def add_loop_closure(self, lc: LoopClosure, optimize_now: bool = True) -> None:
        cfg = self.config
        self.loop_closures.append(lc)
        self.graph.add_between(
            lc.from_key, lc.to_key, lc.R, lc.t,
            sigma_rot=lc.sigma_rot if lc.sigma_rot is not None else cfg.sigma_lc_rot,
            sigma_trans=lc.sigma_trans if lc.sigma_trans is not None else cfg.sigma_lc_trans, robust=True,
        )
        if optimize_now and cfg.optimize_on_lc:
            if cfg.lc_consistency_gate and self._between_chi2(
                self.graph.num_between - 1
            ) <= cfg.optimizer.gnc_barc2:
                self.optimizes_skipped_consistent += 1
            else:
                self.optimize()

    # ------------------------------------------------------------------
    def _add_node(self, R, t, orig=None) -> int:
        """Add a graph node with estimate (R, t); `orig` is the raw
        odometry-frame pose kept as the deformation reference (defaults to
        the estimate)."""
        key = self.graph.add_node(R, t)
        oR, ot = orig if orig is not None else (R, t)
        self._orig_R.append(np.asarray(oR, np.float32))
        self._orig_t.append(np.asarray(ot, np.float32))
        return key

    # ------------------------------------------------------------------
    def optimize(self) -> fg.OptimizeResult:
        with Timer("backend/optimize"):
            self._opt_result = fg.optimize(self.graph, self.config.optimizer, device=self.device)
            self.num_optimizations += 1
            # geometry epoch: bump only when the solve actually MOVED the
            # estimates that SHAPE the map — agent and mesh-control nodes
            # (they deform the mesh and the trajectory the ray library is
            # built from). OBJECT nodes are excluded: GNC pulling a merge
            # pair together moves object nodes on every merge-proposal
            # solve, and keying the epoch on them forced a full ray-library
            # rebuild + full 4D snapshot chunk per CD pass (r4 hard-scene
            # finding: update_verificator 39 s/pass, all rebuilds) even
            # though agents and mesh were bit-identical.
            if self.graph.num_nodes:
                obj_keys = set(self._object_keys.values())
                n = min(self.graph.num_nodes, len(self._opt_result.node_t))
                sel = [k for k in range(n) if k not in obj_keys]
                if not sel:
                    self._geometry_epoch += 1
                else:
                    old_t = np.stack([np.asarray(self.graph.node_t[k]) for k in sel])
                    new_t = np.stack(
                        [np.asarray(self._opt_result.node_t[k]) for k in sel]
                    )
                    if np.abs(new_t - old_t).max() > self.config.geometry_epoch_threshold:
                        self._geometry_epoch += 1
            # re-linearize future odometry around the optimized estimates
            self.graph.node_R = [r for r in self._opt_result.node_R]
            self.graph.node_t = [t for t in self._opt_result.node_t]
            # judge pending merge proposals whose factors were in this solve:
            # GNC downweights an identity merge factor to an outlier when the
            # optimized geometry says the two objects cannot coincide
            # (reference: RPGO validates proposed merges, backend.h:149-155)
            mask = self._opt_result.outlier_mask
            for p in self.proposed_merges:
                if 0 <= p.factor_idx < len(mask):
                    p.validated = True
                    p.is_valid = not bool(mask[p.factor_idx])
                    # PROMOTE validated-valid merges to ACTIVE factors: a
                    # judged same-object constraint is genuine trajectory
                    # evidence — under drift it closes the loop like the
                    # reference's inlier merge factors. (Judging itself runs
                    # on shadow factors at the UNBENT optimum; activation
                    # with the soft centroid-noise sigma bends a consistent
                    # trajectory < the geometry-epoch threshold.) GNC keeps
                    # re-judging active robust factors each solve, so a
                    # later-contradicted merge flips back to invalid.
                    if p.is_valid and p.factor_idx < len(self.graph.b_shadow):
                        self.graph.b_shadow[p.factor_idx] = False
            if self.config.enable_node_merging:
                self._propose_merges()
        return self._opt_result

    def validated_merges(self) -> List[MergeProposal]:
        """Proposals cleared for reconciliation. With add_merge_factor, only
        GNC-validated inliers qualify; otherwise every valid proposal does."""
        if self.config.add_merge_factor:
            return [p for p in self.proposed_merges if p.validated and p.is_valid]
        return [p for p in self.proposed_merges if p.is_valid]

    def finish_processing(self):
        """Final optimization (backend.cpp:218-226)."""
        if self.graph.num_nodes:
            n_before = len(self.proposed_merges)
            self.optimize()
            # merge proposals born in that final optimize added identity
            # factors the solve has NOT judged yet; without one more GNC
            # pass, cross-visit twins extracted near the end stay unmerged
            # and both report phantom changes
            if len(self.proposed_merges) > n_before:
                self.optimize()

    # ------------------------------------------------------------------
    def _trajectory_correction(self):
        """(key_stamps, t_old, t_new, R_old, R_new) for stamped interpolation."""
        stamps = np.asarray([a.stamp_ns for a in self.agents], np.int64)
        ids = np.asarray(self.agent_keys)
        R_old = np.stack([self._orig_R[i] for i in ids])
        t_old = np.stack([self._orig_t[i] for i in ids])
        # current graph estimates: optimized values for old nodes, odometry-
        # chained estimates for nodes added since the last optimization
        R_cur = np.stack([np.asarray(r) for r in self.graph.node_R])
        t_cur = np.stack([np.asarray(t) for t in self.graph.node_t])
        return stamps, t_old, t_cur[ids], R_old, R_cur[ids]

    def get_dsg(self) -> SceneGraph:
        """Build the current optimized scene graph (deformed copy)."""
        with Timer("backend/get_dsg"):
            mesh = self.mesh_acc.build()
            dsg = SceneGraph(mesh=mesh)
            # deformation epoch: vertex positions only move when an
            # optimization actually MOVES the graph (identity solves from
            # merge proposals over consistent odometry do not count); the
            # incremental change detectors and the 4D map's delta sharing
            # key on this (detectors.py, stricter than the reference's
            # LC-only wipe)
            dsg.opt_epoch = self._geometry_epoch
            optimized = self._opt_result is not None
            node_R_cur = np.stack([np.asarray(r) for r in self.graph.node_R]) if self.graph.num_nodes else np.zeros((0, 3, 3), np.float32)
            node_t_cur = np.stack([np.asarray(t) for t in self.graph.node_t]) if self.graph.num_nodes else np.zeros((0, 3), np.float32)
            # identity-deformation short-circuit: once ANY solve has run,
            # `optimized` stays true forever — but an identity correction
            # (GT-pinned or drift-free odometry) must not rewrite every
            # vertex through float math on every snapshot: the bit-changed
            # positions broke the 4D map's delta sharing (a full ~100 MB
            # store per CD pass, 3.4 GB over the r5 endurance run) and
            # would force ray-library rebuilds. Same threshold as the
            # geometry epoch.
            moved = False
            if optimized and len(self._orig_t):
                node_t_old = np.stack(self._orig_t)
                node_R_old = np.stack(self._orig_R)
                n = min(len(node_t_old), len(node_t_cur))
                thr = self.config.geometry_epoch_threshold
                moved = bool(
                    np.abs(node_t_cur[:n] - node_t_old[:n]).max() > thr
                    or np.abs(node_R_cur[:n] - node_R_old[:n]).max() > 1e-4
                )
            if optimized and moved and len(mesh.vertices):
                dsg.mesh.vertices = self.deformation.deform_points(
                    mesh.vertices, node_R_cur, node_t_cur,
                    np.stack(self._orig_R), np.stack(self._orig_t),
                ).astype(np.float32)

            optimized = optimized and moved
            stamps, t_old, t_new, R_old, R_new = self._trajectory_correction()
            # agents: current graph estimates
            for i, a in enumerate(self.agents):
                if optimized:
                    k = self.agent_keys[i]
                    dsg.agents.append(
                        AgentNode(a.stamp_ns, node_R_cur[k], node_t_cur[k], a.key)
                    )
                else:
                    dsg.agents.append(AgentNode(a.stamp_ns, a.R_w_b, a.t_w_b, a.key))

            # objects: move along corrected trajectory by first-seen stamp
            for oid, obj in self.objects.items():
                o = obj.clone()
                if optimized and len(stamps):
                    q = np.asarray([o.first_observed_ns[0]], np.int64)
                    R_corr, t_o, t_n = interpolate_stamped_corrections(
                        q, stamps, t_old, t_new, R_old, R_new
                    )
                    delta = t_n[0] - t_o[0]
                    o.bbox_min = o.bbox_min + delta
                    o.bbox_max = o.bbox_max + delta
                    if len(o.trajectory_positions):
                        qs = np.asarray(o.trajectory_stamps_ns, np.int64)
                        Rc, to_, tn_ = interpolate_stamped_corrections(
                            qs, stamps, t_old, t_new, R_old, R_new
                        )
                        o.trajectory_positions = (
                            o.trajectory_positions + (tn_ - to_)
                        ).astype(np.float32)
                dsg.objects[oid] = o
        return dsg

    # ------------------------------------------------------------------
    def _object_graph_key(self, obj: KhronosObject) -> int:
        """Graph node for an object (lazily created when a merge proposal
        needs it): pose (I, centroid), anchored by a between-factor to the
        agent keyframe nearest its first observation — the optimizer then
        carries the object along the corrected trajectory, and merge factors
        between object nodes become judgeable."""
        key = self._object_keys.get(obj.node_id)
        if key is not None:
            return key
        stamps = np.asarray([a.stamp_ns for a in self.agents], np.int64)
        anchor_ns = obj.first_observed_ns[0] if obj.first_observed_ns else 0
        i = int(np.argmin(np.abs(stamps - anchor_ns)))
        akey = self.agent_keys[i]
        c = obj.position().astype(np.float32)
        Ra, ta = self._orig_R[akey], self._orig_t[akey]
        trel = Ra.T @ (c - ta)
        # initial estimate: anchor measurement applied to the CURRENT agent
        # estimate (already optimized if a solve has run)
        R_a_est = np.asarray(self.graph.node_R[akey])
        t_a_est = np.asarray(self.graph.node_t[akey])
        okey = self._add_node(
            R_a_est @ Ra.T, R_a_est @ trel + t_a_est,
            orig=(np.eye(3, dtype=np.float32), c),
        )
        self.graph.add_between(
            akey, okey, Ra.T, trel,
            sigma_rot=self.config.sigma_pose_object_rot,
            sigma_trans=self.config.sigma_pose_object_trans,
        )
        self._object_keys[obj.node_id] = okey
        return okey

    # ------------------------------------------------------------------
    def _propose_merges(self):
        """Merge proposals: same label, no temporal co-visibility, bbox
        intersection with IoU >= merge_min_iou (functor cpp:61-107)."""
        cfg = self.config
        objs = [o for o in self.objects.values() if not o.is_dynamic]
        n = len(objs)
        if n < 2:
            return
        proposed = {(p.from_id, p.into_id) for p in self.proposed_merges}
        # propose on OPTIMIZED geometry: move each bbox by the trajectory
        # correction at its first observation (the reference proposes after
        # the update functor moved objects, functor cpp:41-59) — under drift
        # the raw odometry-frame bboxes are the wrong thing to intersect
        delta = np.zeros((n, 3), np.float32)
        if self._opt_result is not None and self.agents:
            stamps, t_old, t_new, R_old, R_new = self._trajectory_correction()
            q = np.asarray(
                [o.first_observed_ns[0] if o.first_observed_ns else 0 for o in objs],
                np.int64,
            )
            _, t_o, t_n = interpolate_stamped_corrections(
                q, stamps, t_old, t_new, R_old, R_new
            )
            delta = (t_n - t_o).astype(np.float32)
        # candidate pairs from a spatial bbox bucket (grid cells, not the
        # n x n matrix — per-object cost stays flat as object counts grow,
        # VERDICT r3 task 9), then vectorized label + IoU gates over the
        # gathered pair list. The exact interval co-visibility check runs
        # only on survivors.
        mn = np.stack([o.bbox_min for o in objs]).astype(np.float32) + delta
        mx = np.stack([o.bbox_max for o in objs]).astype(np.float32) + delta
        labels = np.asarray([o.semantic_category for o in objs])
        grid = bbox_util.BboxGrid(mn, mx)
        pi, pj = [], []
        for i in range(n):
            js = grid.candidates(mn[i], mx[i])
            js = js[js > i]
            if len(js):
                pi.append(np.full(len(js), i))
                pj.append(js)
        if not pi:
            return
        pi = np.concatenate(pi)
        pj = np.concatenate(pj)
        inter = np.prod(
            np.maximum(np.minimum(mx[pi], mx[pj]) - np.maximum(mn[pi], mn[pj]), 0.0),
            axis=-1,
        )
        vol = np.prod(np.maximum(mx - mn, 0.0), axis=-1)
        union = vol[pi] + vol[pj] - inter
        iou_pair = np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)
        keep = (iou_pair >= cfg.merge_min_iou) & (labels[pi] == labels[pj])
        iou_by_pair = {
            (int(a), int(b)): float(v)
            for a, b, v in zip(pi[keep], pj[keep], iou_pair[keep])
        }
        for i, j in zip(pi[keep], pj[keep]):
            a, b = objs[i], objs[j]
            if (a.node_id, b.node_id) in proposed or (b.node_id, a.node_id) in proposed:
                continue
            # temporal co-visibility: intervals overlap -> distinct objects
            covis = any(
                is_present(b.first_observed_ns, b.last_observed_ns, s)
                for s in list(a.first_observed_ns) + list(a.last_observed_ns)
            ) or any(
                is_present(a.first_observed_ns, a.last_observed_ns, s)
                for s in list(b.first_observed_ns) + list(b.last_observed_ns)
            )
            if covis:
                continue
            iou = iou_by_pair[(int(i), int(j))]
            newer, older = (a, b) if a.first_observed_ns[0] > b.first_observed_ns[0] else (b, a)
            prop = MergeProposal(from_id=newer.node_id, into_id=older.node_id, iou=iou)
            if cfg.add_merge_factor:
                # SHADOW identity factor between the object nodes; the NEXT
                # solve judges it against the GNC inlier gate at the UNBENT
                # optimum (zero weight in the solve: an in-graph factor
                # stiff enough to judge well also bends a consistent
                # trajectory by centimeters per judging solve — r4 finding)
                ka = self._object_graph_key(newer)
                kb = self._object_graph_key(older)
                self.graph.add_between(
                    ka, kb, np.eye(3, dtype=np.float32), np.zeros(3, np.float32),
                    sigma_rot=cfg.sigma_object_merge_rot,
                    sigma_trans=cfg.sigma_object_merge_trans,
                    robust=True, shadow=True,
                )
                prop.factor_idx = self.graph.num_between - 1
                prop.is_valid = False  # until judged
            else:
                prop.validated = True
            self.proposed_merges.append(prop)

    # ------------------------------------------------------------------
    def save(self, directory: str):
        """Write dsg + artifacts (backend.cpp:255-313 layout)."""
        import csv
        import os

        os.makedirs(directory, exist_ok=True)
        dsg = self.get_dsg()
        serialization.save_scene_graph(dsg, os.path.join(directory, "dsg.npz"))
        with open(os.path.join(directory, "proposed_merges.csv"), "w", newline="") as fh:
            w = csv.writer(fh)
            w.writerow(["from_id", "into_id", "iou", "is_valid", "validated"])
            for p in self.proposed_merges:
                w.writerow([p.from_id, p.into_id, p.iou, int(p.is_valid), int(p.validated)])
