"""Debug visualizers: active-window frame sink, change-detection ray
inspector, and evaluation association viewer.

Port of `khronos_tpu/eval/visualizers.py`, the file-based equivalents of the
reference's RViz tooling (SURVEY.md §2.4/§2.5):

  - ActiveWindowVisualizer (khronos_ros/src/visualization/
    active_window_visualizer.cpp:620, topics active_window_visualizer.h:
    132-143: dynamic/object/semantic/tracking images, detection and track
    bboxes) -> a per-frame sink writing tiled debug PNGs + an index.html.
  - CdVisualizer (khronos_eval/src/cd_visualizer.cpp:299, "ray classifications
    for a clicked point", cd_visualizer.h:50-75) -> `inspect_point` returning
    per-ray classifications (match / absent / occluded / no_overlap) and an
    HTML/JSON export.
  - EvalVisualizer (khronos_eval/src/eval_visualizer.cpp:505, GT vs estimated
    centroids/bboxes colored by association state) -> a top-down SVG scene.

Everything renders on the host: device tensors (the frame's images, the ray
library) are copied to numpy first. The PNG writer imports PIL only when it
writes.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Optional

import numpy as np
import torch


def _host(x) -> np.ndarray:
    """A tensor (on any device) or array as numpy."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ----------------------------------------------------------------------------
# small colormaps (no matplotlib dependency on the hot path)
# ----------------------------------------------------------------------------

def depth_colormap(depth: np.ndarray, max_range: float = 6.0) -> np.ndarray:
    """[H, W] depth (m) -> [H, W, 3] uint8 (near=warm, far=cool, invalid=black)."""
    d = np.asarray(depth, np.float32)
    valid = np.isfinite(d) & (d > 0)
    x = np.clip(d / max_range, 0.0, 1.0)
    r = np.clip(1.5 - np.abs(2.5 * x - 0.5), 0, 1)
    g = np.clip(1.5 - np.abs(2.5 * x - 1.25), 0, 1)
    b = np.clip(1.5 - np.abs(2.5 * x - 2.0), 0, 1)
    img = (np.stack([r, g, b], -1) * 255).astype(np.uint8)
    img[~valid] = 0
    return img


def id_colormap(ids: np.ndarray) -> np.ndarray:
    """[H, W] int ids (0 = background) -> [H, W, 3] uint8 hashed palette."""
    ids = np.asarray(ids, np.int64)
    r = (ids * 73856093) % 255
    g = (ids * 19349669) % 255
    b = (ids * 83492791) % 255
    img = np.stack([r, g, b], -1).astype(np.uint8)
    img[ids == 0] = 0
    return img


def _tile(panels: List[np.ndarray], cols: int = 2) -> np.ndarray:
    h = max(p.shape[0] for p in panels)
    w = max(p.shape[1] for p in panels)
    rows = (len(panels) + cols - 1) // cols
    canvas = np.zeros((rows * h, cols * w, 3), np.uint8)
    for i, p in enumerate(panels):
        r, c = divmod(i, cols)
        canvas[r * h : r * h + p.shape[0], c * w : c * w + p.shape[1]] = p
    return canvas


# ----------------------------------------------------------------------------
# Active-window visualizer sink
# ----------------------------------------------------------------------------


@dataclasses.dataclass
class ActiveWindowVisualizerConfig:
    output_dir: str = "/tmp/khronos_aw_vis"
    every_n_frames: int = 5
    max_frames: int = 200
    max_range: float = 6.0


class ActiveWindowVisualizer:
    """Per-frame debug sink: register via ActiveWindow.add_sink(vis).

    Writes frame_%05d.png panels (depth | semantics | dynamic clusters |
    object instances, with track bbox overlays) and an index.html contact
    sheet — the file-based analog of the reference's debug image topics.
    """

    def __init__(self, config: ActiveWindowVisualizerConfig = None):
        self.config = config or ActiveWindowVisualizerConfig()
        os.makedirs(self.config.output_dir, exist_ok=True)
        self._written: List[str] = []
        self._count = 0

    def __call__(self, frame, aw, output) -> None:
        self._count += 1
        if (self._count - 1) % self.config.every_n_frames:
            return
        if len(self._written) >= self.config.max_frames:
            return
        depth = _host(frame.depth)
        labels = _host(frame.labels)
        dyn = (
            _host(frame.dynamic_image)
            if frame.dynamic_image is not None
            else np.zeros_like(labels)
        )
        obj = (
            _host(frame.object_image)
            if frame.object_image is not None
            else np.zeros_like(labels)
        )
        panels = [
            depth_colormap(depth, self.config.max_range),
            id_colormap(labels + 1),  # shift: label 0 is a real class
            id_colormap(dyn),
            self._objects_with_tracks(obj, aw, frame),
        ]
        img = _tile(panels)
        name = f"frame_{self._count - 1:05d}.png"
        self._write_png(os.path.join(self.config.output_dir, name), img)
        self._written.append(name)
        self._write_index()

    def _objects_with_tracks(self, obj_img: np.ndarray, aw, frame) -> np.ndarray:
        """Object-instance panel with active-track world bboxes projected
        into the image (red = dynamic, green = static)."""
        img = id_colormap(obj_img)
        tracker = getattr(aw, "tracker", None)
        camera = getattr(aw, "camera", None)
        if tracker is None or camera is None:
            return img
        H, W = img.shape[:2]
        R_cw = np.asarray(frame.R_w_c).T
        t_wc = np.asarray(frame.t_w_c)
        for tr in getattr(tracker, "tracks", []):
            bmin, bmax = getattr(tr, "last_bbox_min", None), getattr(tr, "last_bbox_max", None)
            if bmin is None or bmax is None or not getattr(tr, "is_active", True):
                continue
            corners = np.array(
                [[x, y, z] for x in (bmin[0], bmax[0])
                 for y in (bmin[1], bmax[1]) for z in (bmin[2], bmax[2])]
            )
            pc = (corners - t_wc) @ R_cw.T
            if np.all(pc[:, 2] <= 0.1):
                continue
            pc[:, 2] = np.maximum(pc[:, 2], 0.1)
            u, v, _ = camera.project(torch.from_numpy(pc))
            u, v = _host(u), _host(v)
            u0, u1 = int(np.clip(u.min(), 0, W - 1)), int(np.clip(u.max(), 0, W - 1))
            v0, v1 = int(np.clip(v.min(), 0, H - 1)), int(np.clip(v.max(), 0, H - 1))
            if u1 <= u0 or v1 <= v0:
                continue
            color = (
                np.array([255, 64, 64], np.uint8)
                if getattr(tr, "is_dynamic", False)
                else np.array([64, 255, 64], np.uint8)
            )
            img[v0, u0:u1] = color
            img[v1, u0:u1] = color
            img[v0:v1, u0] = color
            img[v0:v1, u1] = color
        return img

    @staticmethod
    def _write_png(path: str, img: np.ndarray) -> None:
        from PIL import Image

        Image.fromarray(img).save(path)

    def _write_index(self) -> None:
        rows = "\n".join(
            f'<div><h4>{n}</h4><img src="{n}" style="image-rendering:pixelated;width:640px"/></div>'
            for n in self._written
        )
        html = (
            "<html><head><title>active window debug</title></head>"
            "<body style='background:#111;color:#eee;font-family:monospace'>"
            "<h2>panels: depth | semantics | dynamic clusters | object instances+tracks</h2>"
            f"{rows}</body></html>"
        )
        with open(os.path.join(self.config.output_dir, "index.html"), "w") as fh:
            fh.write(html)


# ----------------------------------------------------------------------------
# Change-detection ray inspector
# ----------------------------------------------------------------------------


def inspect_point(verificator, point: np.ndarray) -> List[dict]:
    """Classify every candidate ray through `point`'s hash cell, like the
    reference's clicked-point inspector (cd_visualizer.h:50-75).

    Returns [{ray, stamp_s, cls, depth, radial, ray_len, origin, target}]
    with cls in {"match", "absent", "occluded", "no_overlap"}.
    """
    if not getattr(verificator, "_built", False):
        return []
    cfg = verificator.config
    point = np.asarray(point, np.float32)
    rays_idx = _host(verificator.sorted_rays)
    cell_start = _host(verificator.cell_start)
    origins = _host(verificator.origins)
    targets = _host(verificator.targets)
    stamps = _host(verificator.stamps_s)
    lin = int(verificator.point_cells(point[None])[0])
    cand = rays_idx[cell_start[lin] : cell_start[lin + 1]]
    out = []
    for r in np.unique(cand):
        o, tgt = origins[r], targets[r]
        d = tgt - o
        ray_len = float(np.linalg.norm(d))
        dir_ = d / max(ray_len, 1e-6)
        rel = point - o
        depth = float(rel @ dir_)
        radial = float(np.linalg.norm(rel - depth * dir_))
        if depth <= 0.0 or radial > cfg.radial_tolerance:
            cls = "no_overlap"
        elif abs(ray_len - depth) <= cfg.depth_tolerance:
            cls = "match"
        elif ray_len > depth + cfg.depth_tolerance:
            cls = "absent"
        else:
            cls = "occluded"
        out.append(
            {
                "ray": int(r),
                "stamp_s": float(stamps[r]),
                "cls": cls,
                "depth": depth,
                "radial": radial,
                "ray_len": ray_len,
                "origin": o.tolist(),
                "target": tgt.tolist(),
            }
        )
    out.sort(key=lambda e: e["stamp_s"])
    return out


_CD_COLORS = {"match": "#4caf50", "absent": "#f44336",
              "occluded": "#9e9e9e", "no_overlap": "#3f51b5"}


def export_point_inspection(verificator, point: np.ndarray, path: str) -> List[dict]:
    """Write a self-contained HTML inspection (top-down SVG of the candidate
    rays colored by classification + the evidence table) and return the
    classifications."""
    rays = inspect_point(verificator, point)
    point = np.asarray(point, np.float32)
    # top-down extent
    pts = [point[:2]]
    for e in rays:
        pts.append(np.asarray(e["origin"][:2]))
        pts.append(np.asarray(e["target"][:2]))
    pts = np.asarray(pts)
    lo = pts.min(0) - 0.5
    hi = pts.max(0) + 0.5
    span = np.maximum(hi - lo, 1e-3)
    W = 640

    def sxy(p):
        q = (np.asarray(p[:2]) - lo) / span * (W - 20) + 10
        return float(q[0]), float(W - q[1])

    segs = []
    for e in rays:
        x1, y1 = sxy(e["origin"])
        x2, y2 = sxy(e["target"])
        c = _CD_COLORS[e["cls"]]
        segs.append(
            f'<line x1="{x1:.1f}" y1="{y1:.1f}" x2="{x2:.1f}" y2="{y2:.1f}" '
            f'stroke="{c}" stroke-width="1.2" opacity="0.8">'
            f'<title>ray {e["ray"]} t={e["stamp_s"]:.2f}s {e["cls"]}</title></line>'
        )
    px, py = sxy(point)
    segs.append(f'<circle cx="{px:.1f}" cy="{py:.1f}" r="5" fill="#ffeb3b"/>')
    table = "".join(
        f'<tr><td>{e["ray"]}</td><td>{e["stamp_s"]:.2f}</td>'
        f'<td style="color:{_CD_COLORS[e["cls"]]}">{e["cls"]}</td>'
        f'<td>{e["depth"]:.2f}</td><td>{e["radial"]:.3f}</td><td>{e["ray_len"]:.2f}</td></tr>'
        for e in rays
    )
    html = (
        "<html><body style='background:#111;color:#eee;font-family:monospace'>"
        f"<h2>ray inspection @ {point.tolist()}</h2>"
        f'<svg width="{W}" height="{W}" style="background:#1b1b1b">{"".join(segs)}</svg>'
        "<table border=1 cellpadding=3><tr><th>ray</th><th>t (s)</th><th>class</th>"
        f"<th>depth</th><th>radial</th><th>ray len</th></tr>{table}</table>"
        f"<script>var data = {json.dumps(rays)};</script></body></html>"
    )
    with open(path, "w") as fh:
        fh.write(html)
    return rays


# ----------------------------------------------------------------------------
# Evaluation association visualizer
# ----------------------------------------------------------------------------


def export_association_svg(
    est_objects,
    gt_objects,
    query_time_ns: int,
    path: str,
    config=None,
) -> dict:
    """Top-down SVG of GT vs estimated objects at a query time, colored by
    association state (detected / missed / hallucinated), with match lines —
    the reference EvalVisualizer's centroid/bbox view as a file."""
    from khronos_tpu_torch.eval.evaluators import ObjectEvaluatorConfig, associate_objects

    config = config or ObjectEvaluatorConfig()
    est, gt, est_matched, gt_matched = associate_objects(
        est_objects, gt_objects, query_time_ns, config
    )
    boxes = []
    for g in gt:
        boxes.append((g.bbox_min[:2], g.bbox_max[:2]))
    for e in est:
        boxes.append((e.bbox_min[:2], e.bbox_max[:2]))
    if boxes:
        lo = np.min([b[0] for b in boxes], axis=0) - 0.5
        hi = np.max([b[1] for b in boxes], axis=0) + 0.5
    else:
        lo, hi = np.zeros(2), np.ones(2)
    span = np.maximum(hi - lo, 1e-3)
    W = 720

    def sxy(p):
        q = (np.asarray(p[:2], np.float64) - lo) / span * (W - 20) + 10
        return float(q[0]), float(W - q[1])

    def rect(bmin, bmax, color, dash=""):
        x1, y1 = sxy(bmin)
        x2, y2 = sxy(bmax)
        x, y = min(x1, x2), min(y1, y2)
        w, h = abs(x2 - x1), abs(y2 - y1)
        return (
            f'<rect x="{x:.1f}" y="{y:.1f}" width="{w:.1f}" height="{h:.1f}" '
            f'fill="none" stroke="{color}" stroke-width="2" {dash}/>'
        )

    parts = []
    for gi, g in enumerate(gt):
        color = "#4caf50" if gi in gt_matched else "#f44336"  # detected / missed
        parts.append(rect(g.bbox_min, g.bbox_max, color, 'stroke-dasharray="6,3"'))
        x, y = sxy(g.center)
        parts.append(f'<circle cx="{x:.1f}" cy="{y:.1f}" r="4" fill="{color}"/>')
    for ei, e in enumerate(est):
        color = "#2196f3" if ei in est_matched else "#ff9800"  # matched / hallucinated
        parts.append(rect(e.bbox_min, e.bbox_max, color))
        x, y = sxy(e.position())
        parts.append(f'<circle cx="{x:.1f}" cy="{y:.1f}" r="3" fill="{color}"/>')
        if ei in est_matched:
            gx, gy = sxy(gt[est_matched[ei]].center)
            parts.append(
                f'<line x1="{x:.1f}" y1="{y:.1f}" x2="{gx:.1f}" y2="{gy:.1f}" '
                'stroke="#eeeeee" stroke-width="1" opacity="0.6"/>'
            )
    legend = (
        "<p>GT: <span style='color:#4caf50'>detected</span> / "
        "<span style='color:#f44336'>missed</span> (dashed) — Est: "
        "<span style='color:#2196f3'>matched</span> / "
        "<span style='color:#ff9800'>hallucinated</span></p>"
    )
    html = (
        "<html><body style='background:#111;color:#eee;font-family:monospace'>"
        f"<h2>object associations @ t={query_time_ns * 1e-9:.2f}s</h2>{legend}"
        f'<svg width="{W}" height="{W}" style="background:#1b1b1b">{"".join(parts)}</svg>'
        "</body></html>"
    )
    with open(path, "w") as fh:
        fh.write(html)
    return {
        "num_est": len(est),
        "num_gt": len(gt),
        "detected": len(gt_matched),
        "missed": len(gt) - len(gt_matched),
        "hallucinated": len(est) - len(est_matched),
    }
