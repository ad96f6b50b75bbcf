"""PipelineEvaluator: run the evaluation suite over a saved 4D map.

Equivalent of the reference PipelineEvaluator (khronos_eval/src/
pipeline_evaluator.cpp): loads `final.4dmap`, extracts one reconciled DSG per
snapshot stamp, runs mesh/object/dynamic evaluators over (map stamp, query
time <= stamp) pairs, and writes results/{background_mesh,static_objects,
dynamic_objects}.csv + map_timestamps.txt (cpp:48-178).

Ground truth comes from the synthetic scene oracle (data/synthetic.py's
`sample_scene_surface` is the GT builder — the reference's tesse GT
builders' role).

Port of `khronos_tpu/eval/pipeline_evaluator.py`: host numpy, the nearest
distances on the evaluator's `device` (CUDA unless the caller passes
device="cpu"). For the same map and ground truth, the CSVs are the
reference's byte for byte.
"""

from __future__ import annotations

import csv
import dataclasses
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from khronos_tpu_torch import resolve_device
from khronos_tpu_torch.eval.evaluators import (
    ChangeEvalConfig,
    DynamicEvaluatorConfig,
    GtObject,
    MeshEvaluatorConfig,
    ObjectEvaluatorConfig,
    evaluate_changes,
    evaluate_dynamic,
    evaluate_mesh,
    evaluate_objects,
    evaluate_trajectory,
    min_distances,
)
from khronos_tpu_torch.stm.spatio_temporal_map import SpatioTemporalMap


@dataclasses.dataclass
class PipelineEvaluatorConfig:
    mesh: MeshEvaluatorConfig = dataclasses.field(default_factory=MeshEvaluatorConfig)
    objects: ObjectEvaluatorConfig = dataclasses.field(default_factory=ObjectEvaluatorConfig)
    dynamic: DynamicEvaluatorConfig = dataclasses.field(default_factory=DynamicEvaluatorConfig)
    changes: ChangeEvalConfig = dataclasses.field(default_factory=ChangeEvalConfig)
    only_final: bool = False  # evaluate only the last snapshot
    # Reference GT-builder protocol (tesse_ground_truth_builder.cpp:100-127
    # pruneUnobservedAreas, max_observation_distance 0.1 in
    # config/ground_truth/office.yaml:11): GT background points farther than
    # this from the system's own observed (final) mesh are pruned, so
    # completeness measures observed areas only. <= 0 disables.
    max_observation_distance: float = 0.1


class SceneGroundTruth:
    """GT oracle built from a synthetic Scene (GT-builder equivalent)."""

    def __init__(self, scene, duration_s: float, n_bg_points: int = 20000, seed: int = 0):
        from khronos_tpu_torch.data import synthetic as syn

        self.scene = scene
        self.duration_s = duration_s
        self._syn = syn
        self.n_bg_points = n_bg_points
        self.seed = seed

    def background_points(self, t_s: float) -> np.ndarray:
        pts, labs = self._syn.sample_scene_surface(
            self.scene, t_s, self.n_bg_points, seed=self.seed
        )
        return pts.astype(np.float32)

    def gt_objects(self) -> List[GtObject]:
        """One GT instance per standalone primitive or per `group` of
        primitives (compound shapes -> union bbox); building structure
        (walls/pillars) and background-labeled primitives are excluded —
        they belong to the background cloud, matching the reference GT
        builder's object-labeled clustering
        (tesse_ground_truth_builder.h:37-110)."""
        out = []
        groups: Dict[str, List[Tuple[int, "object"]]] = {}
        for i, p in enumerate(self.scene.primitives):
            if p.is_dynamic or getattr(p, "structure", False):
                continue
            if p.label == self.scene.room_label:
                continue
            if getattr(p, "group", ""):
                groups.setdefault(p.group, []).append((i, p))
                continue
            c = p.center
            h = p.half_extents
            out.append(
                GtObject(
                    gt_id=i,
                    label=p.label,
                    center=np.asarray(c, np.float32),
                    bbox_min=np.asarray(c - h, np.float32),
                    bbox_max=np.asarray(c + h, np.float32),
                    t_appear_ns=int(max(p.t_appear, 0.0) * 1e9)
                    if np.isfinite(p.t_appear)
                    else -(1 << 62),
                    t_disappear_ns=int(p.t_disappear * 1e9)
                    if np.isfinite(p.t_disappear)
                    else (1 << 62),
                )
            )
        for members in groups.values():
            idx, p0 = members[0]
            mn = np.min(np.stack([np.asarray(p.center) - np.asarray(p.half_extents) for _, p in members]), axis=0)
            mx = np.max(np.stack([np.asarray(p.center) + np.asarray(p.half_extents) for _, p in members]), axis=0)
            out.append(
                GtObject(
                    gt_id=idx,
                    label=p0.label,
                    center=(0.5 * (mn + mx)).astype(np.float32),
                    bbox_min=mn.astype(np.float32),
                    bbox_max=mx.astype(np.float32),
                    t_appear_ns=int(max(p0.t_appear, 0.0) * 1e9)
                    if np.isfinite(p0.t_appear)
                    else -(1 << 62),
                    t_disappear_ns=int(p0.t_disappear * 1e9)
                    if np.isfinite(p0.t_disappear)
                    else (1 << 62),
                )
            )
        out.sort(key=lambda g: g.gt_id)
        return out

    def gt_dynamic_trajectories(self, dt_s: float = 0.5):
        out = {}
        for i, p in enumerate(self.scene.primitives):
            if not p.is_dynamic:
                continue
            ts = np.arange(0.0, self.duration_s, dt_s)
            pos = np.stack([p.center_at(t) for t in ts]).astype(np.float32)
            out[i] = ((ts * 1e9).astype(np.int64), pos)
        return out

    def gt_changes_csv(self, path: str):
        with open(path, "w", newline="") as fh:
            w = csv.writer(fh)
            w.writerow(["gt_id", "label", "t_appear_ns", "t_disappear_ns"])
            for g in self.gt_objects():
                w.writerow([g.gt_id, g.label, g.t_appear_ns, g.t_disappear_ns])


def save_ground_truth(gt, path: str, query_times_s: Sequence[float]) -> None:
    """Persist the GT oracle to one `gt.npz` so a saved run can be
    re-evaluated standalone (reference exp_pipeline consumes persisted GT
    DSG + background PLY, khronos_eval/app/exp_pipeline.cpp:44-59)."""
    arrays: Dict[str, np.ndarray] = {
        "duration_s": np.asarray([gt.duration_s], np.float64),
        "bg_times_s": np.asarray(sorted(set(query_times_s)), np.float64),
    }
    for i, t in enumerate(arrays["bg_times_s"]):
        arrays[f"bg/{i}"] = gt.background_points(float(t)).astype(np.float32)
    objs = gt.gt_objects()
    arrays["obj/gt_id"] = np.asarray([g.gt_id for g in objs], np.int64)
    arrays["obj/label"] = np.asarray([g.label for g in objs], np.int64)
    arrays["obj/center"] = (
        np.stack([g.center for g in objs]).astype(np.float32)
        if objs else np.zeros((0, 3), np.float32)
    )
    arrays["obj/bbox_min"] = (
        np.stack([g.bbox_min for g in objs]).astype(np.float32)
        if objs else np.zeros((0, 3), np.float32)
    )
    arrays["obj/bbox_max"] = (
        np.stack([g.bbox_max for g in objs]).astype(np.float32)
        if objs else np.zeros((0, 3), np.float32)
    )
    arrays["obj/t_appear_ns"] = np.asarray([g.t_appear_ns for g in objs], np.int64)
    arrays["obj/t_disappear_ns"] = np.asarray([g.t_disappear_ns for g in objs], np.int64)
    for gid, (stamps, pos) in gt.gt_dynamic_trajectories().items():
        arrays[f"dyn/{gid}/stamps_ns"] = np.asarray(stamps, np.int64)
        arrays[f"dyn/{gid}/pos"] = np.asarray(pos, np.float32)
    np.savez_compressed(path, **arrays)


class FileGroundTruth:
    """GT oracle backed by a persisted `gt.npz` (save_ground_truth). Same
    duck interface as SceneGroundTruth; background_points(t) returns the
    nearest saved query-time cloud."""

    def __init__(self, path: str):
        self._data = dict(np.load(path, allow_pickle=False))
        self.duration_s = float(self._data["duration_s"][0])
        self._bg_times = self._data["bg_times_s"]

    def background_points(self, t_s: float) -> np.ndarray:
        if not len(self._bg_times):
            return np.zeros((0, 3), np.float32)
        i = int(np.argmin(np.abs(self._bg_times - t_s)))
        return self._data[f"bg/{i}"]

    def gt_objects(self) -> List[GtObject]:
        d = self._data
        return [
            GtObject(
                gt_id=int(d["obj/gt_id"][i]),
                label=int(d["obj/label"][i]),
                center=d["obj/center"][i],
                bbox_min=d["obj/bbox_min"][i],
                bbox_max=d["obj/bbox_max"][i],
                t_appear_ns=int(d["obj/t_appear_ns"][i]),
                t_disappear_ns=int(d["obj/t_disappear_ns"][i]),
            )
            for i in range(len(d["obj/gt_id"]))
        ]

    def gt_dynamic_trajectories(self):
        out = {}
        for k in self._data:
            if k.startswith("dyn/") and k.endswith("/stamps_ns"):
                gid = int(k.split("/")[1])
                out[gid] = (self._data[k], self._data[f"dyn/{gid}/pos"])
        return out


class PipelineEvaluator:
    def __init__(self, config: PipelineEvaluatorConfig = None, device=None):
        self.config = config or PipelineEvaluatorConfig()
        self.device = resolve_device(device)

    def evaluate(
        self,
        stm: SpatioTemporalMap,
        gt: SceneGroundTruth,
        results_dir: str,
        query_times_s: Optional[Sequence[float]] = None,
        gt_trajectory: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    ) -> Dict[str, Dict[str, float]]:
        """Writes the CSV suite; returns the final-map summary metrics."""
        os.makedirs(results_dir, exist_ok=True)
        cfg = self.config
        stamps = stm.stamps()
        with open(os.path.join(results_dir, "map_timestamps.txt"), "w") as fh:
            fh.write("\n".join(str(s) for s in stamps))
        if not stamps:
            return {}
        eval_stamps = [stamps[-1]] if cfg.only_final else stamps
        if query_times_s is None:
            query_times_s = [s * 1e-9 for s in eval_stamps]

        mesh_rows, obj_rows, dyn_rows = [], [], []
        summary: Dict[str, Dict[str, float]] = {}
        gt_objs = gt.gt_objects()
        gt_dyn = gt.gt_dynamic_trajectories()
        seq_end_ns = int(gt.duration_s * 1e9)

        observed = None
        if cfg.max_observation_distance > 0:
            observed = stm.get_dsg(stamps[-1]).mesh.vertices

        def prune_to_observed(gt_pts: np.ndarray) -> np.ndarray:
            if observed is None or not len(observed) or not len(gt_pts):
                return gt_pts
            d = min_distances(gt_pts.astype(np.float32), observed.astype(np.float32), device=self.device)
            return gt_pts[d <= cfg.max_observation_distance]

        for robot_ns in eval_stamps:
            dsg = stm.get_dsg(robot_ns)
            for q_s in query_times_s:
                q_ns = int(q_s * 1e9)
                if q_ns > robot_ns:
                    continue
                gt_bg = prune_to_observed(gt.background_points(q_s))
                m = evaluate_mesh(dsg.mesh.vertices, gt_bg, cfg.mesh, device=self.device)
                m.update({"robot_time_ns": robot_ns, "query_time_ns": q_ns})
                mesh_rows.append(m)
                o = evaluate_objects(list(dsg.objects.values()), gt_objs, q_ns, cfg.objects, device=self.device)
                o.update({"robot_time_ns": robot_ns, "query_time_ns": q_ns})
                obj_rows.append(o)
            d = evaluate_dynamic(list(dsg.objects.values()), gt_dyn, cfg.dynamic)
            d.update({"robot_time_ns": robot_ns})
            dyn_rows.append(d)

        # change metrics on the final map
        final = stm.get_dsg(stamps[-1])
        ch = evaluate_changes(
            list(final.objects.values()), gt_objs, 0, seq_end_ns, cfg.changes, cfg.objects
        )

        self._write_csv(os.path.join(results_dir, "background_mesh.csv"), mesh_rows)
        self._write_csv(os.path.join(results_dir, "static_objects.csv"), obj_rows)
        self._write_csv(os.path.join(results_dir, "dynamic_objects.csv"), dyn_rows)
        self._write_csv(os.path.join(results_dir, "changes.csv"), [ch])

        summary["mesh"] = mesh_rows[-1] if mesh_rows else {}
        summary["objects"] = obj_rows[-1] if obj_rows else {}
        summary["dynamic"] = dyn_rows[-1] if dyn_rows else {}
        summary["changes"] = ch
        if gt_trajectory is not None and final.agents:
            traj = evaluate_trajectory(
                np.asarray([a.stamp_ns for a in final.agents], np.int64),
                np.stack([a.t_w_b for a in final.agents]),
                gt_trajectory[0],
                gt_trajectory[1],
            )
            self._write_csv(os.path.join(results_dir, "trajectory.csv"), [traj])
            summary["trajectory"] = traj
        return summary

    @staticmethod
    def _write_csv(path: str, rows: List[dict]):
        if not rows:
            return
        keys = sorted({k for r in rows for k in r})
        with open(path, "w", newline="") as fh:
            w = csv.DictWriter(fh, fieldnames=keys)
            w.writeheader()
            w.writerows(rows)
