"""Result tables + timing breakdown plots.

Copy of `khronos_tpu/eval/plotting.py` (host only; `plot_timing` imports
matplotlib when called). Equivalent of the reference's khronos_eval/plotting (tables.py: metric tables
over Accuracy/Completeness/F1@tau and Object/Dynamic/Change P/R/F1 with
4D/Robot/Query/Online data slices, tables.py:29-42; timing.py: per-stage
breakdowns reconstructed from the hierarchical timer names in
timing/stats.csv, timing.py:18-33).
"""

from __future__ import annotations

import csv
import os
from typing import Dict, List, Optional


def _read_csv(path: str) -> List[dict]:
    if not os.path.exists(path):
        return []
    with open(path) as fh:
        return list(csv.DictReader(fh))


def _fmt(v, pct=True) -> str:
    try:
        x = float(v)
    except (TypeError, ValueError):
        return str(v)
    return f"{100 * x:5.1f}" if pct else f"{x:8.3f}"


def results_table(results_dir: str, thresholds=(0.05, 0.1, 0.2, 0.5)) -> str:
    """Text table over the evaluation CSV suite (tables.py equivalent)."""
    lines: List[str] = []
    mesh = _read_csv(os.path.join(results_dir, "background_mesh.csv"))
    if mesh:
        lines.append("Background mesh (final row; values in %):")
        hdr = "  tau    acc   comp     f1"
        lines.append(hdr)
        row = mesh[-1]
        for tau in thresholds:
            k = f"{tau:g}"
            if f"accuracy@{k}" in row:
                lines.append(
                    f"  {tau:4.2f}  {_fmt(row[f'accuracy@{k}'])}  {_fmt(row[f'completeness@{k}'])}  {_fmt(row[f'f1@{k}'])}"
                )
        lines.append(f"  rmse={float(row.get('rmse', 'nan')):.3f} m  chamfer={float(row.get('chamfer', 'nan')):.3f} m")
        lines.append("")
    objs = _read_csv(os.path.join(results_dir, "static_objects.csv"))
    if objs:
        row = objs[-1]
        lines.append(
            "Objects:  P={} R={} F1={}  (est={} gt={} missed={} hallucinated={})".format(
                _fmt(row["precision"]), _fmt(row["recall"]), _fmt(row["f1"]),
                row["num_est"], row["num_gt"], row["missed"], row["hallucinated"],
            )
        )
    dyn = _read_csv(os.path.join(results_dir, "dynamic_objects.csv"))
    if dyn:
        row = dyn[-1]
        lines.append(
            "Dynamic:  P={} R={} F1={}".format(
                _fmt(row["dynamic_precision"]), _fmt(row["dynamic_recall"]), _fmt(row["dynamic_f1"])
            )
        )
    ch = _read_csv(os.path.join(results_dir, "changes.csv"))
    if ch:
        row = ch[-1]
        lines.append(
            "Changes:  P={} R={} F1={}  (app tp/fn={}/{} dis tp/fn={}/{})".format(
                _fmt(row["change_precision"]), _fmt(row["change_recall"]), _fmt(row["change_f1"]),
                row["appeared_tp"], row["appeared_fn"], row["disappeared_tp"], row["disappeared_fn"],
            )
        )
    return "\n".join(lines)


# ----------------------------------------------------------------------------
# timing
# ----------------------------------------------------------------------------


def load_timing(timing_dir: str) -> List[dict]:
    return _read_csv(os.path.join(timing_dir, "stats.csv"))


def timing_table(timing_dir: str, top: int = 20) -> str:
    """Per-stage summary sorted by total time (timing.py equivalent)."""
    rows = load_timing(timing_dir)
    for r in rows:
        r["total_s"] = float(r["total_s"])
        r["mean_s"] = float(r["mean_s"])
    rows.sort(key=lambda r: -r["total_s"])
    out = [f"{'timer':44s} {'n':>6s} {'total[s]':>9s} {'mean[ms]':>9s}"]
    for r in rows[:top]:
        out.append(
            f"{r['name']:44s} {r['n_samples']:>6s} {r['total_s']:>9.2f} {1e3 * r['mean_s']:>9.1f}"
        )
    return "\n".join(out)


def timing_hierarchy(timing_dir: str) -> Dict[str, dict]:
    """Reconstruct the '/'-separated timer hierarchy (timing.py:18-33)."""
    tree: Dict[str, dict] = {}
    for r in load_timing(timing_dir):
        node = tree
        for part in r["name"].split("/"):
            node = node.setdefault("children", {}).setdefault(part, {})
        node["total_s"] = float(r["total_s"])
        node["mean_s"] = float(r["mean_s"])
        node["n"] = int(r["n_samples"])
    return tree.get("children", {})


def plot_timing(timing_dir: str, out_path: Optional[str] = None, top: int = 12):
    """Horizontal bar chart of total per-stage time (saved as PNG)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rows = load_timing(timing_dir)
    rows.sort(key=lambda r: -float(r["total_s"]))
    rows = rows[:top][::-1]
    names = [r["name"] for r in rows]
    totals = [float(r["total_s"]) for r in rows]
    fig, ax = plt.subplots(figsize=(9, 0.4 * len(rows) + 1.5))
    ax.barh(names, totals, color="#4878cf")
    ax.set_xlabel("total time [s]")
    ax.set_title("khronos_tpu stage timing")
    fig.tight_layout()
    out_path = out_path or os.path.join(timing_dir, "timing.png")
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path
