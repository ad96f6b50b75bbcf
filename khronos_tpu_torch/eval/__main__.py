"""Standalone re-evaluation CLI over a saved run.

Equivalent of the reference exp_pipeline
(khronos_eval/app/exp_pipeline.cpp:44-59: `exp_pipeline <config>
[experiment_dir] [force_recompute] [run_evaluation] [only_final]`): load a
saved `final.4dmap.npz` + persisted ground truth and re-run the full
evaluation suite without re-running the pipeline. Port of
`khronos_tpu/eval/__main__.py`; the nearest distances run on CUDA unless
`--device cpu`.

    python -m khronos_tpu_torch.eval --map <run_dir>/final.4dmap.npz \
        [--gt <run_dir>/gt.npz] [--out <run_dir>/results] [--only-final] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--map", required=True, help="saved final.4dmap.npz")
    ap.add_argument("--gt", default=None,
                    help="persisted gt.npz (default: gt.npz next to --map)")
    ap.add_argument("--out", default=None,
                    help="results directory (default: results/ next to --map)")
    ap.add_argument("--only-final", action="store_true",
                    help="evaluate only the last snapshot")
    ap.add_argument("--query-times", type=float, nargs="*", default=None,
                    help="query times in seconds (default: snapshot stamps)")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    from khronos_tpu_torch import resolve_device
    from khronos_tpu_torch.eval.pipeline_evaluator import (
        FileGroundTruth,
        PipelineEvaluator,
        PipelineEvaluatorConfig,
    )
    from khronos_tpu_torch.eval.plotting import results_table
    from khronos_tpu_torch.stm.spatio_temporal_map import SpatioTemporalMap

    device = resolve_device(args.device)

    run_dir = os.path.dirname(os.path.abspath(args.map))
    gt_path = args.gt or os.path.join(run_dir, "gt.npz")
    out_dir = args.out or os.path.join(run_dir, "results")
    if not os.path.exists(gt_path):
        print(f"no ground truth at {gt_path} (pass --gt)", file=sys.stderr)
        return 2

    stm = SpatioTemporalMap.load(args.map)
    gt = FileGroundTruth(gt_path)
    ev = PipelineEvaluator(PipelineEvaluatorConfig(only_final=args.only_final), device=device)
    ev.evaluate(stm, gt, out_dir, query_times_s=args.query_times)
    print(results_table(out_dir))
    return 0


if __name__ == "__main__":
    sys.exit(main())
