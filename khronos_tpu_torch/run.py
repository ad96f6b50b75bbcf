"""CLI entrypoint: run the full pipeline from a YAML config.

Port of `khronos_tpu/run.py`, the equivalent of the reference khronos_node
(khronos_ros/app/khronos_node.cpp:46-74: config context from argv, build
pipeline + experiment manager, run) with config_utilities-style layering:
`--config a.yaml [b.yaml ...]` merge in order, trailing `key.path=value`
overrides apply last. The same YAML builds both packages.

    python -m khronos_tpu_torch.run --config configs/office_synthetic.yaml \
        run.output_dir=/tmp/office [--device cpu]

Runs on CUDA unless `--device cpu`: the pipeline (places layer included),
then the 4D viewer export (`run.export_viewer`) and, for synthetic data, the
evaluation against the scene's ground truth (`run.evaluate`, which also
writes gt.npz for `python -m khronos_tpu_torch.eval`). Every dataset kind of
the reference is ported (`data/datasets.py::make_dataset`): synthetic,
directory, tum and rosbag2; only a synthetic run is evaluated.

Top-level YAML keys:
  pipeline: PipelineConfig tree
  dataset:  {kind: synthetic | directory | tum | rosbag2, ...adapter kwargs}
  run:      {output_dir, max_frames, evaluate, export_viewer, save_every_n_frames}
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

from khronos_tpu_torch import resolve_device
from khronos_tpu_torch.config import build, load_mapping
from khronos_tpu_torch.pipeline.pipeline import (
    ExperimentConfig,
    ExperimentManager,
    KhronosPipeline,
    PipelineConfig,
)


@dataclasses.dataclass
class RunConfig:
    output_dir: str = "/tmp/khronos_run"
    max_frames: int = 0  # 0 = all
    evaluate: bool = True  # only possible for synthetic datasets (GT oracle)
    export_viewer: bool = True
    save_every_n_frames: int = 0
    overwrite: bool = True


def main(argv=None, group=None, earliest_pulls=False):
    """The CLI. group (`parallel.distributed`): run as one rank of several
    processes on the rank's device, every rank on the same frames
    (`parallel/workers.py` starts them). earliest_pulls: the window waits
    for each host pull at its first poll (`ActiveWindow.earliest_pulls`), so
    that runs compare bit for bit. Neither is a flag."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", nargs="+", required=True, help="YAML config file(s)")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    ap.add_argument("overrides", nargs="*", help="key.path=value overrides")
    args = ap.parse_args(argv)

    # argparse's greedy nargs swallows trailing overrides into --config;
    # anything containing '=' is an override regardless of position
    files = [c for c in args.config if "=" not in c]
    overrides = [c for c in args.config if "=" in c] + list(args.overrides)

    data = load_mapping(files, overrides)
    pipe_cfg = build(PipelineConfig, data.get("pipeline", {}))
    run_cfg = build(RunConfig, data.get("run", {}))
    ds_spec = dict(data.get("dataset", {"kind": "synthetic"}))
    kind = ds_spec.pop("kind", "synthetic")
    device = resolve_device(args.device) if group is None else group.device

    from khronos_tpu_torch.data.datasets import make_dataset

    dataset = make_dataset(kind, device=device, **ds_spec)

    pipeline = KhronosPipeline(pipe_cfg, dataset.camera, device=device, group=group)
    pipeline.active_window.earliest_pulls = earliest_pulls
    manager = ExperimentManager(
        ExperimentConfig(
            output_dir=run_cfg.output_dir,
            overwrite=run_cfg.overwrite,
            save_every_n_frames=run_cfg.save_every_n_frames,
        ),
        pipeline,
        pipe_cfg,
    )

    frames, gts = [], []
    for i, (frame, gt) in enumerate(dataset):
        if run_cfg.max_frames and i >= run_cfg.max_frames:
            break
        frames.append(frame)
        gts.append(gt)
    print(f"running {len(frames)} frames on {device} ...", file=sys.stderr)
    out_dir = manager.run(frames, gts)
    print(f"outputs in {out_dir}", file=sys.stderr)

    if run_cfg.export_viewer:
        from khronos_tpu_torch.eval.viewer import export_html

        html = os.path.join(out_dir, "viewer.html")
        export_html(pipeline.map, html)
        print(f"4D viewer: {html}", file=sys.stderr)

    if run_cfg.evaluate and kind == "synthetic":
        from khronos_tpu_torch.eval.pipeline_evaluator import (
            PipelineEvaluator,
            PipelineEvaluatorConfig,
            SceneGroundTruth,
            save_ground_truth,
        )
        from khronos_tpu_torch.eval.plotting import results_table, timing_table

        gt_oracle = SceneGroundTruth(dataset.scene, dataset.duration)
        # persist GT so `python -m khronos_tpu_torch.eval --map ...` can
        # re-evaluate the saved run standalone (exp_pipeline.cpp analog)
        save_ground_truth(
            gt_oracle,
            os.path.join(out_dir, "gt.npz"),
            [s * 1e-9 for s in pipeline.map.stamps()],
        )
        ev = PipelineEvaluator(PipelineEvaluatorConfig(only_final=True), device=device)
        ev.evaluate(pipeline.map, gt_oracle, os.path.join(out_dir, "results"))
        print(results_table(os.path.join(out_dir, "results")))
        print()
        print(timing_table(os.path.join(out_dir, "timing")))
    return out_dir


if __name__ == "__main__":
    main()
