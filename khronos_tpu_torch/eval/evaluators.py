"""Offline evaluation suite: mesh, object, dynamic-object, change metrics.

Port of `khronos_tpu/eval/evaluators.py`, the equivalents of the reference
khronos_eval evaluators:
  MeshEvaluator (khronos_eval/src/mesh_evaluator.cpp): bidirectional
    nearest-neighbor mesh-vs-GT-cloud; per-threshold accuracy/completeness/F1,
    RMSE, MAD, Chamfer (h:105-122); the batched nearest distances run on the
    device (`min_distances`, which the reconciler's ChangeMerger uses too).
  ObjectEvaluator (src/object_evaluator.cpp): GT<->estimated association by
    centroid or surface points; presence filtering at query time; detection
    precision/recall (detected/missed/hallucinated); over/under-segmentation;
    change-time accuracy vs gt_changes (appeared/disappeared TP/FP/FN).
  DynamicObjectEvaluator (src/dynamic_object_evaluator.cpp): per-timestamp
    centroid association of dynamic trajectories vs GT -> P/R/F1.

CSV schemas mirror the reference's results/{background_mesh,static_objects,
dynamic_objects}.csv. Everything but `min_distances` is a host numpy copy;
the functions that measure distances take the `device` they run on (CUDA
unless the caller passes device="cpu").
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from khronos_tpu_torch import fma32, resolve_device, sqrt32
from khronos_tpu_torch.stm.scene_graph import KhronosObject
from khronos_tpu_torch.utils import intervals as iv

# elements of one chunk's [rows, |b|] distance table (float64 temporaries of
# 128 MiB): rows per chunk shrink as b grows, so memory stays flat
_CHUNK_ELEMENTS = 1 << 24


def _min_dists_chunk(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [M, 3], b [N, 3] -> per-a min distance to b.

    The difference-of-squares form sum((a - b)^2), summed x, y, z with
    fused multiply-adds as the reference's CPU build does; the
    |a|^2 + |b|^2 - 2ab matmul form cancels, and its result decides a
    proximity threshold."""
    x, y, z = (a[:, None, :] - b[None, :, :]).unbind(-1)
    d2 = fma32(z, z, fma32(y, y, x * x))
    return sqrt32(d2.amin(dim=1))


def min_distances(a: np.ndarray, b: np.ndarray, chunk: int = 4096, device=None) -> np.ndarray:
    """Nearest-neighbor distances from each point in a to the set b.

    The reference pads `a` to whole chunks and `b` to a pow2 bucket of
    far-away sentinels for its compile cache; neither changes a distance, so
    the port pads nothing. Rows go `chunk` at a time, fewer when b is large.
    device: CUDA unless the caller passes device="cpu"."""
    dev = resolve_device(device)
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    if len(a) == 0:
        return np.zeros((0,), np.float32)
    if len(b) == 0:
        return np.full((len(a),), np.inf, np.float32)
    rows = max(1, min(chunk, _CHUNK_ELEMENTS // len(b)))
    at = torch.from_numpy(a).to(dev)
    bt = torch.from_numpy(b).to(dev)
    out = torch.cat([_min_dists_chunk(at[s: s + rows], bt) for s in range(0, len(a), rows)])
    return out.cpu().numpy()


# ----------------------------------------------------------------------------
# mesh metrics
# ----------------------------------------------------------------------------


@dataclasses.dataclass
class MeshEvaluatorConfig:
    thresholds: Tuple[float, ...] = (0.05, 0.1, 0.2, 0.5)  # m (office.yaml:70-72)
    vertex_subsample: int = 20000


def evaluate_mesh(
    est_vertices: np.ndarray, gt_points: np.ndarray, config: MeshEvaluatorConfig = None, device=None
) -> Dict[str, float]:
    """Bidirectional surface metrics (MeshEvaluator equivalents); the
    nearest distances run on `device`."""
    config = config or MeshEvaluatorConfig()

    def sub(x):
        if len(x) > config.vertex_subsample:
            sel = np.linspace(0, len(x) - 1, config.vertex_subsample).astype(int)
            return x[sel]
        return x

    est = sub(np.asarray(est_vertices, np.float32))
    gt = sub(np.asarray(gt_points, np.float32))
    d_est_gt = min_distances(est, gt, device=device)  # accuracy direction
    d_gt_est = min_distances(gt, est, device=device)  # completeness direction
    out: Dict[str, float] = {}
    for tau in config.thresholds:
        acc = float((d_est_gt <= tau).mean()) if len(d_est_gt) else 0.0
        comp = float((d_gt_est <= tau).mean()) if len(d_gt_est) else 0.0
        f1 = 2 * acc * comp / (acc + comp) if acc + comp > 0 else 0.0
        key = f"{tau:g}"
        out[f"accuracy@{key}"] = acc
        out[f"completeness@{key}"] = comp
        out[f"f1@{key}"] = f1
    finite_e = d_est_gt[np.isfinite(d_est_gt)]
    finite_g = d_gt_est[np.isfinite(d_gt_est)]
    out["rmse"] = float(np.sqrt((finite_e**2).mean())) if len(finite_e) else np.inf
    out["mad"] = float(np.median(np.abs(finite_e))) if len(finite_e) else np.inf
    out["chamfer"] = (
        float(finite_e.mean() + finite_g.mean()) if len(finite_e) and len(finite_g) else np.inf
    )
    return out


# ----------------------------------------------------------------------------
# object metrics
# ----------------------------------------------------------------------------


@dataclasses.dataclass
class GtObject:
    gt_id: int
    label: int
    center: np.ndarray
    bbox_min: np.ndarray
    bbox_max: np.ndarray
    t_appear_ns: int = -(1 << 62)
    t_disappear_ns: int = 1 << 62
    surface_points: Optional[np.ndarray] = None

    def present_at(self, t_ns: int) -> bool:
        return self.t_appear_ns <= t_ns <= self.t_disappear_ns


@dataclasses.dataclass
class ObjectEvaluatorConfig:
    association: str = "centroid"  # 'centroid' | 'surface'
    max_match_distance: float = 2.0  # m (office.yaml:74-81)
    surface_subsample: int = 100
    match_labels: bool = False


def associate_objects(
    est_objects: Sequence[KhronosObject],
    gt_objects: Sequence[GtObject],
    query_time_ns: int,
    config: ObjectEvaluatorConfig = None,
    device=None,
):
    """Greedy nearest-first GT<->estimate association at one query time.

    Returns (est_present, gt_present, est_matched {ei->gi},
    gt_matched {gi->[ei,...]}); shared by evaluate_objects and the
    association visualizer (reference EvalVisualizer, eval_visualizer.h:41-56).
    """
    config = config or ObjectEvaluatorConfig()
    est = [
        o
        for o in est_objects
        if not o.is_dynamic
        and iv.is_present(o.first_observed_ns, o.last_observed_ns, query_time_ns)
    ]
    gt = [g for g in gt_objects if g.present_at(query_time_ns)]
    # association matrix
    pairs = []  # (dist, ei, gi)
    for ei, e in enumerate(est):
        ec = e.position()
        for gi, g in enumerate(gt):
            if config.match_labels and e.semantic_category != g.label:
                continue
            if config.association == "surface" and g.surface_points is not None and len(e.mesh_vertices):
                ev = e.world_mesh_vertices()
                if len(ev) > config.surface_subsample:
                    sel = np.linspace(0, len(ev) - 1, config.surface_subsample).astype(int)
                    ev = ev[sel]
                d = float(min_distances(ev, g.surface_points, device=device).min())
            else:
                d = float(np.linalg.norm(ec - g.center))
            if d <= config.max_match_distance:
                pairs.append((d, ei, gi))
    pairs.sort()
    est_matched: Dict[int, int] = {}
    gt_matched: Dict[int, List[int]] = {}
    for d, ei, gi in pairs:
        if ei in est_matched:
            continue
        est_matched[ei] = gi
        gt_matched.setdefault(gi, []).append(ei)
    return est, gt, est_matched, gt_matched


def segmentation_cardinalities(
    est: Sequence[KhronosObject],
    gt: Sequence[GtObject],
    config: ObjectEvaluatorConfig,
):
    """Over/under-segmentation counts (object_evaluator.cpp:287+): each side
    assigns to its NEAREST counterpart within range without a 1-1 constraint.
    A GT object claimed by k>1 estimates is oversegmented by k-1; an estimate
    that is the nearest match of k>1 GT objects undersegments by k-1."""
    if not est or not gt:
        return 0, 0
    ec = np.stack([e.position() for e in est])  # [E,3]
    gc = np.stack([g.center for g in gt])  # [G,3]
    d = np.linalg.norm(ec[:, None, :] - gc[None, :, :], axis=-1)  # [E,G]
    if config.match_labels:
        el = np.asarray([e.semantic_category for e in est])
        gl = np.asarray([g.label for g in gt])
        d = np.where(el[:, None] == gl[None, :], d, np.inf)
    est_to_gt = np.argmin(d, axis=1)  # each estimate's nearest GT
    est_ok = d[np.arange(len(est)), est_to_gt] <= config.max_match_distance
    gt_to_est = np.argmin(d, axis=0)  # each GT's nearest estimate
    gt_ok = d[gt_to_est, np.arange(len(gt))] <= config.max_match_distance
    over = under = 0
    counts = np.bincount(est_to_gt[est_ok], minlength=len(gt))
    over = int(np.maximum(counts - 1, 0).sum())
    counts_e = np.bincount(gt_to_est[gt_ok], minlength=len(est))
    under = int(np.maximum(counts_e - 1, 0).sum())
    return over, under


def evaluate_objects(
    est_objects: Sequence[KhronosObject],
    gt_objects: Sequence[GtObject],
    query_time_ns: int,
    config: ObjectEvaluatorConfig = None,
    device=None,
) -> Dict[str, float]:
    """Detection P/R/F1 + over/under segmentation at one query time."""
    config = config or ObjectEvaluatorConfig()
    est, gt, est_matched, gt_matched = associate_objects(
        est_objects, gt_objects, query_time_ns, config, device=device
    )
    detected = len(gt_matched)
    missed = len(gt) - detected
    hallucinated = len(est) - len(est_matched)
    precision = len(est_matched) / len(est) if est else 0.0
    recall = detected / len(gt) if gt else 0.0
    f1 = 2 * precision * recall / (precision + recall) if precision + recall > 0 else 0.0
    overseg, underseg = segmentation_cardinalities(est, gt, config)
    return {
        "num_est": len(est),
        "num_gt": len(gt),
        "detected": detected,
        "missed": missed,
        "hallucinated": hallucinated,
        "precision": precision,
        "recall": recall,
        "f1": f1,
        "oversegmented": overseg,
        "undersegmented": underseg,
    }


@dataclasses.dataclass
class ChangeEvalConfig:
    time_tolerance_s: float = 10.0


def evaluate_changes(
    est_objects: Sequence[KhronosObject],
    gt_objects: Sequence[GtObject],
    sequence_start_ns: int,
    sequence_end_ns: int,
    config: ChangeEvalConfig = None,
    assoc_config: ObjectEvaluatorConfig = None,
) -> Dict[str, float]:
    """Change detection accuracy: appeared/disappeared TP/FP/FN + time error
    (ObjectEvaluator change metrics, object_evaluator.cpp:321+).

    A GT object with t_appear inside the sequence must be matched by an
    estimated object whose presence starts within tolerance; likewise for
    disappearance."""
    config = config or ChangeEvalConfig()
    assoc_config = assoc_config or ObjectEvaluatorConfig()
    tol_ns = int(config.time_tolerance_s * 1e9)

    # associate in space (ignoring time)
    def associated(gt_obj):
        best = None
        for e in est_objects:
            if e.is_dynamic:
                continue
            d = float(np.linalg.norm(e.position() - gt_obj.center))
            if d <= assoc_config.max_match_distance and (best is None or d < best[0]):
                best = (d, e)
        return best[1] if best else None

    tp_app = fp_app = fn_app = 0
    tp_dis = fn_dis = 0
    app_errors, dis_errors = [], []
    for g in gt_objects:
        e = associated(g)
        gt_appeared = g.t_appear_ns > sequence_start_ns
        gt_disappeared = g.t_disappear_ns < sequence_end_ns
        if gt_appeared:
            if e is not None and e.first_observed_ns[0] > sequence_start_ns:
                est_t = e.first_observed_ns[0]
                if abs(est_t - g.t_appear_ns) <= tol_ns:
                    tp_app += 1
                    app_errors.append(abs(est_t - g.t_appear_ns) * 1e-9)
                else:
                    fn_app += 1
            else:
                fn_app += 1
        if gt_disappeared:
            if e is not None and e.last_observed_ns[-1] < sequence_end_ns:
                est_t = e.last_observed_ns[-1]
                if abs(est_t - g.t_disappear_ns) <= tol_ns:
                    tp_dis += 1
                    dis_errors.append(abs(est_t - g.t_disappear_ns) * 1e-9)
                else:
                    fn_dis += 1
            else:
                fn_dis += 1
    # false-positive changes: estimated objects whose presence interval claims
    # a change but whose associated GT object is static (or none)
    for e in est_objects:
        if e.is_dynamic:
            continue
        claimed_disappear = e.last_observed_ns[-1] < sequence_end_ns - tol_ns
        if not claimed_disappear:
            continue
        near_gt = [
            g
            for g in gt_objects
            if np.linalg.norm(e.position() - g.center) <= assoc_config.max_match_distance
        ]
        if not any(g.t_disappear_ns < sequence_end_ns for g in near_gt):
            fp_app += 1  # hallucinated change
    n_changes = tp_app + tp_dis
    n_gt_changes = tp_app + fn_app + tp_dis + fn_dis
    precision = n_changes / max(n_changes + fp_app, 1)
    recall = n_changes / max(n_gt_changes, 1)
    f1 = 2 * precision * recall / (precision + recall) if precision + recall > 0 else 0.0
    return {
        "appeared_tp": tp_app,
        "appeared_fn": fn_app,
        "disappeared_tp": tp_dis,
        "disappeared_fn": fn_dis,
        "hallucinated_changes": fp_app,
        "change_precision": precision,
        "change_recall": recall,
        "change_f1": f1,
        "mean_appear_error_s": float(np.mean(app_errors)) if app_errors else np.nan,
        "mean_disappear_error_s": float(np.mean(dis_errors)) if dis_errors else np.nan,
    }


# ----------------------------------------------------------------------------
# dynamic objects
# ----------------------------------------------------------------------------


@dataclasses.dataclass
class DynamicEvaluatorConfig:
    max_match_distance: float = 0.5  # m (office.yaml:83-87)


def evaluate_dynamic(
    est_objects: Sequence[KhronosObject],
    gt_trajectories: Dict[int, Tuple[np.ndarray, np.ndarray]],  # id -> (stamps_ns, pos[K,3])
    config: DynamicEvaluatorConfig = None,
) -> Dict[str, float]:
    """Per-timestamp centroid association of dynamic trajectories vs GT."""
    config = config or DynamicEvaluatorConfig()
    est_dyn = [o for o in est_objects if o.is_dynamic]
    tp = fp = fn = 0
    for gid, (stamps, pos) in gt_trajectories.items():
        for k in range(len(stamps)):
            t, p = stamps[k], pos[k]
            hit = False
            for e in est_dyn:
                es = np.asarray(e.trajectory_stamps_ns)
                if len(es) == 0 or t < es[0] or t > es[-1]:
                    continue
                i = np.clip(np.searchsorted(es, t), 0, len(es) - 1)
                ep = np.asarray(e.trajectory_positions).reshape(-1, 3)[i]
                if np.linalg.norm(ep - p) <= config.max_match_distance:
                    hit = True
                    break
            if hit:
                tp += 1
            else:
                fn += 1
    # false positives: estimated trajectory points with no GT nearby
    for e in est_dyn:
        es = np.asarray(e.trajectory_stamps_ns)
        ep = np.asarray(e.trajectory_positions).reshape(-1, 3)
        for k in range(len(es)):
            hit = False
            for gid, (stamps, pos) in gt_trajectories.items():
                if len(stamps) == 0 or es[k] < stamps[0] or es[k] > stamps[-1]:
                    continue
                i = np.clip(np.searchsorted(stamps, es[k]), 0, len(stamps) - 1)
                if np.linalg.norm(pos[i] - ep[k]) <= config.max_match_distance * 2:
                    hit = True
                    break
            if not hit:
                fp += 1
    precision = tp / max(tp + fp, 1)
    recall = tp / max(tp + fn, 1)
    f1 = 2 * precision * recall / (precision + recall) if precision + recall > 0 else 0.0
    return {
        "dynamic_tp": tp,
        "dynamic_fp": fp,
        "dynamic_fn": fn,
        "dynamic_precision": precision,
        "dynamic_recall": recall,
        "dynamic_f1": f1,
    }


# ----------------------------------------------------------------------------
# trajectory metrics (ATE / RPE)
# ----------------------------------------------------------------------------


def evaluate_trajectory(
    est_stamps_ns: np.ndarray,
    est_positions: np.ndarray,  # [N, 3]
    gt_stamps_ns: np.ndarray,
    gt_positions: np.ndarray,  # [M, 3]
    rpe_delta_s: float = 1.0,
) -> Dict[str, float]:
    """Absolute trajectory error + relative pose error of the agent path
    (BASELINE.md north star: 'ATE within the reference bound'; the reference
    relies on Kimera-VIO upstream for this — here the optimized backend
    trajectory is evaluated directly).

    GT is linearly interpolated to the estimate's stamps. No alignment is
    applied (both trajectories live in the same world frame)."""
    est_stamps_ns = np.asarray(est_stamps_ns, np.int64)
    est_positions = np.asarray(est_positions, np.float64).reshape(-1, 3)
    gt_stamps_ns = np.asarray(gt_stamps_ns, np.int64)
    gt_positions = np.asarray(gt_positions, np.float64).reshape(-1, 3)
    if len(est_stamps_ns) == 0 or len(gt_stamps_ns) < 2:
        return {"ate_rmse": np.inf, "ate_mean": np.inf, "ate_max": np.inf,
                "rpe_rmse": np.inf, "n_poses": 0}
    t = est_stamps_ns.astype(np.float64)
    tg = gt_stamps_ns.astype(np.float64)
    keep = (t >= tg[0]) & (t <= tg[-1])
    t, est = t[keep], est_positions[keep]
    if len(t) == 0:
        return {"ate_rmse": np.inf, "ate_mean": np.inf, "ate_max": np.inf,
                "rpe_rmse": np.inf, "n_poses": 0}
    gt_i = np.stack(
        [np.interp(t, tg, gt_positions[:, c]) for c in range(3)], axis=1
    )
    err = np.linalg.norm(est - gt_i, axis=1)
    out = {
        "ate_rmse": float(np.sqrt((err**2).mean())),
        "ate_mean": float(err.mean()),
        "ate_max": float(err.max()),
        "n_poses": int(len(t)),
    }
    # RPE over rpe_delta_s windows (translation drift)
    d_ns = rpe_delta_s * 1e9
    j = np.searchsorted(t, t + d_ns)
    ok = j < len(t)
    i_idx = np.nonzero(ok)[0]
    j_idx = j[ok]
    if len(i_idx):
        d_est = est[j_idx] - est[i_idx]
        d_gt = gt_i[j_idx] - gt_i[i_idx]
        rel = np.linalg.norm(d_est - d_gt, axis=1)
        out["rpe_rmse"] = float(np.sqrt((rel**2).mean()))
    else:
        out["rpe_rmse"] = 0.0
    return out
