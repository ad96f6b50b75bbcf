"""The comparison that decides `correct`: what the program's timed path
produced, against the plain reference (`reference.py`), on what the run
captured at points drawn from the seed. Each capture is judged by itself.

- "step": one frame of the fused step. The reference recomputes the frame
  from the volume the program held before it (for a robot's first frame,
  from its own empty volume). Numbers, the worst over the frames:
  - volume_mismatch: voxels where the volume after the frame differs (tsdf
    or colour by more than 1e-4, any other field at all), over the voxels
    the frame updated;
  - id_mismatch: pixels whose motion-region id or per-class component id
    differs, over the pixels either side puts in a region of either kind;
  - cluster_mismatch: clusters of either kind whose statistics, as the
    tracker is handed them, differ (pixel count or class at all; centroid,
    box or any of the sampled points by more than 1e-3 m), or that one side
    lacks, over the reference's clusters.
- "mesh": one emission round of the archived surface at an output frame,
  from the volume the program held when it emitted. mesh_mismatch:
  triangles that one side emits and the other does not (the vertices as
  the emission layout stores them: position, label, colour), and cells
  whose meshed flag differs after the round, over the reference's
  triangles and cells.
- "scroll": one recentring of the window. scroll_mismatch: voxels whose
  fields differ after the move (exact), over the grid's voxels; 1 when the
  shift is not the one that centres the grid on the camera.

Coverage, each a count that has to reach its limit: frames_checked (every
capture was made), frames_with_motion (step frames in which the reference
finds motion pixels, so that the motion path through kernel A is compared;
in a cell whose scene moves), mesh_triangles (the reference's triangles in
the mesh rounds).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from harness import reference
TOL = 1e-4  # metres of tsdf, or colour in [0, 1]: float32 rounding of the same sums stays far below
POINT_TOL = 1e-3  # metres, a cluster's centroid, box and sampled points
MC, K, STATS_F = 32, 64, 12  # the fused step's packed statistics: clusters a kind, points a cluster, fields


def _differs(a: torch.Tensor, b: torch.Tensor, tol: float) -> torch.Tensor:
    if a.dtype == torch.bool or not a.is_floating_point():
        return a != b
    a, b = a.float(), b.float()
    both_inf = torch.isinf(a) & torch.isinf(b) & (torch.sign(a) == torch.sign(b))
    return ~both_inf & ~((a - b).abs() <= tol)


def _id_gap(prog: Dict, ref: Dict) -> float:
    region = torch.zeros_like(ref["dynamic_image"], dtype=torch.bool)
    wrong = torch.zeros_like(region)
    for k in ("dynamic_image", "object_image"):
        p, r = prog[k].to(ref[k].device), ref[k]
        region |= (p > 0) | (r > 0)
        wrong |= p != r
    n = int(region.sum())
    return 0.0 if n == 0 else int(wrong.sum()) / n


def unpack_clusters(packed: torch.Tensor) -> Dict[str, Dict[int, Dict]]:
    """The fused step's packed statistics (its documented layout: dynamic
    then semantic [MC, 12] rows of centroid sums, box min, box max, pixels,
    voxels or class, output id; then [MC, K, 3] sampled points of each kind)
    -> {"dyn": {id: row}, "obj": {id: row}} of the kept clusters."""
    x = packed.detach().float().cpu().reshape(-1)
    n = MC * STATS_F
    stats = (x[:n].view(MC, STATS_F), x[n:2 * n].view(MC, STATS_F))
    pts = x[2 * n:].view(2, MC, K, 3)
    out = {}
    for kind, st, pt in (("dyn", stats[0], pts[0]), ("obj", stats[1], pts[1])):
        rows = {}
        for k in range(MC):
            oid = int(st[k, 11])
            if oid > 0:
                cnt = int(st[k, 9])
                row = dict(count=cnt, centroid=st[k, 0:3] / max(cnt, 1), bmin=st[k, 3:6], bmax=st[k, 6:9],
                           samples=pt[k, :min(cnt, K)])
                if kind == "obj":
                    row["category"] = int(st[k, 10])
                rows[oid] = row
        out[kind] = rows
    return out


def _cluster_gap(prog: Dict[int, Dict], ref: Dict[int, Dict]) -> int:
    bad = 0
    for k in set(prog) | set(ref):
        p, r = prog.get(k), ref.get(k)
        if p is None or r is None or p["count"] != r["count"] or p.get("category") != r.get("category"):
            bad += 1
            continue
        gap = max(float((p[f].float().cpu() - r[f].float().cpu()).abs().max())
                  for f in ("centroid", "bmin", "bmax", "samples"))
        bad += int(not gap <= POINT_TOL)
    return bad


def compare_step(prog: Dict, ref: Dict) -> Dict[str, float]:
    """The numbers for one frame: prog and ref are volume dicts with the id
    images and the clusters ({"dyn": ..., "obj": ...} or the reference's
    dyn_stats / obj_stats)."""
    bad = torch.zeros(ref["tsdf"].shape, dtype=torch.bool, device=ref["tsdf"].device)
    for f in reference.FIELDS:
        d = _differs(prog[f].to(ref[f].device), ref[f], TOL)
        bad |= d.any(dim=-1) if d.dim() == 4 else d
    n_ref = len(ref["dyn_stats"]) + len(ref["obj_stats"])
    wrong = _cluster_gap(prog["clusters"]["dyn"], ref["dyn_stats"]) + _cluster_gap(prog["clusters"]["obj"],
                                                                                  ref["obj_stats"])
    return {
        "volume_mismatch": int(bad.sum()) / max(1, ref["updated"]),
        "id_mismatch": _id_gap(prog, ref),
        "cluster_mismatch": wrong / max(1, n_ref),
    }


def _clusters_of(ref: Dict) -> Dict:
    return {"dyn": ref["dyn_stats"], "obj": ref["obj_stats"]}


def decode_rows(words: np.ndarray) -> np.ndarray:
    """Emission rows (uint32 [T, 12]: nine 16-bit vertex coordinates, nine
    8-bit colours and three 8-bit labels, then stamps) -> reference rows."""
    w = words.astype(np.uint32)
    u16 = lambda col, hi: (w[:, col] >> 16) if hi else (w[:, col] & 0xFFFF)  # noqa: E731
    vq = np.stack([u16(0, 0), u16(0, 1), u16(1, 0), u16(1, 1), u16(2, 0), u16(2, 1), u16(3, 0), u16(3, 1),
                   u16(4, 0)], axis=1).reshape(-1, 3, 3)
    cb = np.stack([(w[:, 5] >> s) & 0xFF for s in (0, 8, 16, 24)] + [(w[:, 6] >> s) & 0xFF for s in (0, 8, 16, 24)]
                  + [w[:, 7] & 0xFF], axis=1).reshape(-1, 3, 3)
    lb = np.stack([(w[:, 7] >> s) & 0xFF for s in (8, 16, 24)], axis=1)[..., None]
    vtx = np.concatenate([vq, lb, cb], axis=2).astype(np.int64)
    return reference.sort_rows(vtx)


def _multiset_gap(a: np.ndarray, b: np.ndarray) -> int:
    """Rows in one of a, b and not matched in the other."""
    if len(a) == 0 or len(b) == 0:
        return len(a) + len(b)
    both = np.concatenate([a, b])
    uniq, inv = np.unique(both, axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    ca = np.bincount(inv[:len(a)], minlength=len(uniq))
    cb = np.bincount(inv[len(a):], minlength=len(uniq))
    return int(np.abs(ca - cb).sum())


def compare_mesh(prog_rows: np.ndarray, prog_meshed: torch.Tensor, ref: Dict) -> Dict[str, float]:
    gap = _multiset_gap(prog_rows, ref["rows"])
    flags = prog_meshed.to(ref["meshed"].device) != ref["meshed"]
    flags.view(-1)[0] = False  # cell (0, 0, 0) takes the last write of the round's padding
    cells = int(flags.sum())
    return {"mesh_mismatch": (gap + cells) / max(1, len(ref["rows"]) + ref["cells"]),
            "mesh_triangles": len(ref["rows"])}


def emitted_rows(sample: Dict) -> np.ndarray:
    """The program's emitted triangles of a mesh capture, as reference rows:
    the first meta[0] rows of its emission buffer."""
    n = int(sample["meta"][0])
    words = sample["packed"][:n].cpu().numpy().view(np.uint32)
    return decode_rows(words)


def compare_scroll(sample: Dict, ref: Dict, shift_ok: bool) -> Dict[str, float]:
    if not shift_ok:
        return {"scroll_mismatch": 1.0}
    post = sample["post"]
    bad = torch.zeros(ref["tsdf"].shape, dtype=torch.bool, device=ref["tsdf"].device)
    for f in reference.FIELDS:
        d = _differs(post[f].to(ref[f].device), ref[f], 0.0)
        bad |= d.any(dim=-1) if d.dim() == 4 else d
    same_origin = np.array_equal(np.asarray(post["origin"]), np.asarray(ref["origin"]))
    return {"scroll_mismatch": int(bad.sum()) / bad.numel() if same_origin else 1.0}


def _shift_ok(s: Dict, cfg: dict) -> bool:
    """The shift centres the grid on the camera, and the camera had left the
    margin about the grid's centre."""
    vm = cfg["active_window"]["volumetric_map"]
    voxel, shape = float(vm["voxel_size"]), np.asarray(vm["grid_shape"])
    margin = float(vm.get("recenter_margin", 3.0))
    origin, cam = np.asarray(s["pre"]["origin"], np.int64), np.asarray(s["cam"], np.float64)
    cam_vox = (np.asarray(cam, np.float32) / np.float32(voxel)).astype(np.float64)  # the camera's voxel in float32
    target = np.floor(cam_vox - shape / 2.0).astype(np.int64)
    centre = (origin + shape / 2.0) * voxel
    return bool(np.any(np.abs(cam - centre) > margin)) and np.array_equal(target - origin, np.asarray(s["shift"]))


def judge(samples: List[Dict], cfg: dict, dtype=torch.float32) -> List[Dict]:
    """One row of numbers a capture. A "step" capture holds the frame
    ("depth", "color", "labels", "R", "t", "t_now"), the volume before it
    ("pre", None for a robot's first frame) and the program's volume after
    it with its id images and packed statistics ("post"); a "mesh" capture
    the volume at emission ("pre") and the program's emitted rows and flags;
    a "scroll" capture the volumes before and after, the shift and the
    camera. With dtype=bfloat16 the reference's own output in that
    precision is judged in the program's place (the control)."""
    vm = cfg["active_window"]["volumetric_map"]
    trunc = float(vm.get("truncation_distance", 0.2))
    rows = []
    for s in samples:
        kind = s.get("kind", "step")
        if kind == "step":
            pre = s["pre"]
            if pre is None:
                pre = reference.fresh_volume(vm["grid_shape"], s["t"], vm["voxel_size"], trunc, s["depth"].device)
            args = (pre, s["depth"], s["color"], s["labels"], s["R"], s["t"], s["t_now"], cfg)
            ref = reference.step(*args)
            if dtype != torch.float32:
                out = reference.step(*args, dtype=dtype)
                out["clusters"] = _clusters_of(out)
            else:
                out = dict(s["post"], clusters=unpack_clusters(s["post"]["packed"]))
            row = compare_step(out, ref)
            row.update(dynamic_px=int((ref["dynamic_image"] > 0).sum()),
                       object_px=int((ref["object_image"] > 0).sum()), updated=ref["updated"])
        elif kind == "mesh":
            ref = reference.mesh_round(s["pre"], cfg)
            if dtype != torch.float32:
                ctl = reference.mesh_round(s["pre"], cfg, dtype=dtype)
                row = compare_mesh(ctl["rows"], ctl["meshed"], ref)
            else:
                row = compare_mesh(emitted_rows(s), s["meshed"], ref)
        else:
            ref = reference.scroll(s["pre"], s["shift"], trunc)
            sample = s
            if dtype != torch.float32:
                sample = dict(s, post=reference.scroll(s["pre"], s["shift"], trunc, dtype=dtype))
            row = compare_scroll(sample, ref, _shift_ok(s, cfg))
        row.update(kind=kind, robot=s["robot"], frame=s["frame"])
        rows.append(row)
    return rows
