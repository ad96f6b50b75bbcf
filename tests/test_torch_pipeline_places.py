"""Port parity for the pipeline's places paths and its evaluation: the
reference KhronosPipeline with the places layer on (places_mode 'output'),
its recorded extractor calls and change-detection requests replayed through
the port, the evaluation of its saved run in both packages, and the port's
CLI with places, evaluation and the viewer on.

The JAX renderer's small office frames of tests/test_torch_pipeline_cd.py
(48x64 at 4 fps, 6 s, two orbits, drifted odometry, GT loop closure, change
detection every 6 frames) go through the reference pipeline. The output a
mesh delta lands in depends on when the reference's host pulls land
(tests/test_torch_bus.py), so the strict comparisons replay what the
reference's extractor and change detection received. Tolerance: none (layers, archives and CSVs bit for bit,
byte for byte)."""

import copy
import os

import jax.numpy as jnp
import numpy as np
import pytest
import yaml

from khronos_tpu.active_window.frame_data import FrameData as JFrame
from khronos_tpu.config import build as jbuild
from khronos_tpu.data import synthetic as jsyn
from khronos_tpu.eval import pipeline_evaluator as jpe
from khronos_tpu.eval.__main__ import main as jeval_main
from khronos_tpu.pipeline.pipeline import ExperimentConfig as JExperimentConfig
from khronos_tpu.pipeline.pipeline import ExperimentManager as JManager
from khronos_tpu.pipeline.pipeline import KhronosPipeline as JPipeline
from khronos_tpu.pipeline.pipeline import PipelineConfig as JPipelineConfig
from khronos_tpu.stm.spatio_temporal_map import SpatioTemporalMap as JMap
from khronos_tpu.utils.logging import ExperimentLogger
from khronos_tpu.config import to_dict as jto_dict
from khronos_tpu_torch import run as trun
from khronos_tpu_torch.config import build as tbuild
from khronos_tpu_torch.config import to_dict as tto_dict
from khronos_tpu_torch.data import synthetic as tsyn
from khronos_tpu_torch.eval import pipeline_evaluator as tpe
from khronos_tpu_torch.eval.__main__ import main as teval_main
from khronos_tpu_torch.pipeline.pipeline import KhronosPipeline as TPipeline
from khronos_tpu_torch.pipeline.pipeline import PipelineConfig as TPipelineConfig
from khronos_tpu_torch.stm import places as tplaces
from khronos_tpu_torch.stm.spatio_temporal_map import SpatioTemporalMap as TMap

from test_torch_pipeline_cd import DURATION, PIPELINE as CD_PIPELINE, _sequence_and_frames
from test_torch_places import assert_layers_equal
from torch_parity import torch_camera, torch_cd_request

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the reference's places defaults, with a room refresh every 2 s of data so
# that a 6 s run crosses the gate both ways
PIPELINE = {**CD_PIPELINE, "places": {"room_update_interval_s": 2.0}, "places_mode": "output"}
CALLS = ("add_mesh_delta", "update_local", "reset_occupancy", "refresh_rooms", "extract")
GT_POINTS = 4000  # ground-truth surface samples (the CLI runs use the default, 20,000)
RESULTS = ("background_mesh.csv", "static_objects.csv", "dynamic_objects.csv", "changes.csv", "map_timestamps.txt")


def record_calls(extractor, calls):
    """Wrap an extractor's public methods: each call's arguments, and the
    layer it leaves (or returns, for extract), appended to `calls`."""
    for name in CALLS:
        fn = getattr(extractor, name)

        def wrapped(*args, _fn=fn, _name=name, **kwargs):
            rec = (_name, copy.deepcopy(args), copy.deepcopy(kwargs))
            out = _fn(*args, **kwargs)
            calls.append(rec + (copy.deepcopy(out if _name == "extract" else extractor.layer),))
            return out

        setattr(extractor, name, wrapped)


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    cam, frames = _sequence_and_frames()
    jcfg = jbuild(JPipelineConfig, PIPELINE)
    pipe = JPipeline(jcfg, cam)
    calls, requests = [], []
    record_calls(pipe.places_extractor, calls)
    run_cd = pipe.run_change_detection_on

    def record(*req):
        requests.append(copy.deepcopy(req))
        return run_cd(*req)

    pipe.run_change_detection_on = record
    run_frames = [JFrame(stamp_ns=f["stamp_ns"], depth=jnp.asarray(f["depth"]), color=jnp.asarray(f["color"]),
                         labels=jnp.asarray(f["labels"]), R_w_c=R, t_w_c=t) for f, R, t in frames]
    out_dir = str(tmp_path_factory.mktemp("office_places_j"))
    JManager(JExperimentConfig(output_dir=out_dir), pipe, jcfg).run(run_frames, [(f["R_gt"], f["t_gt"]) for f, _, _ in frames])
    # the reference run.py's evaluation, on the saved run
    gt = jpe.SceneGroundTruth(jsyn.office_scene(DURATION), DURATION, n_bg_points=GT_POINTS)
    jpe.save_ground_truth(gt, os.path.join(out_dir, "gt.npz"), [s * 1e-9 for s in pipe.map.stamps()])
    jpe.PipelineEvaluator(jpe.PipelineEvaluatorConfig(only_final=True)).evaluate(
        pipe.map, gt, os.path.join(out_dir, "results"))
    return {"cam": cam, "pipe": pipe, "calls": calls, "requests": requests, "dir": out_dir}


def test_config_and_the_reference_run(reference_run):
    assert jto_dict(jbuild(JPipelineConfig, PIPELINE)) == tto_dict(tbuild(TPipelineConfig, PIPELINE))
    assert tto_dict(TPipelineConfig())["places"] == jto_dict(JPipelineConfig())["places"]
    assert isinstance(TPipelineConfig().places, tplaces.PlacesConfig)
    names = [c[0] for c in reference_run["calls"]]
    # the run went through every places path of 'output' mode
    assert {"add_mesh_delta", "update_local", "reset_occupancy", "refresh_rooms"} <= set(names)
    snaps = reference_run["pipe"].map.snapshots
    assert snaps[len(snaps) // 2].places is not None and snaps[-1].places.nodes


def test_recorded_places_calls_give_the_reference_layers(reference_run):
    ex = tplaces.PlacesExtractor(tbuild(TPipelineConfig, PIPELINE).places, device="cpu")
    rooms = 0
    for i, (name, args, kwargs, want) in enumerate(reference_run["calls"]):
        out = getattr(ex, name)(*copy.deepcopy(args), **copy.deepcopy(kwargs))
        assert_layers_equal(out if name == "extract" else ex.layer, want, f"call {i} ({name})")
        rooms = max(rooms, want.num_rooms)
    assert rooms >= 1
    assert_layers_equal(ex.layer, reference_run["pipe"].places_extractor.layer, "final")


def test_recorded_cd_requests_give_the_reference_map(reference_run, tmp_path):
    """The reference's change-detection requests (their DSGs carrying the
    places snapshots) through the port: the .4dmap.npz key for key, dtype for
    dtype, bit for bit, places keys included."""
    requests = reference_run["requests"]
    assert any(r[2] for r in requests) and all(r[0].places is not None for r in requests)
    tp = TPipeline(tbuild(TPipelineConfig, PIPELINE), torch_camera(reference_run["cam"]), device="cpu")
    for req in requests:
        tp.run_change_detection_on(*torch_cd_request(req))
    path = str(tmp_path / "final.4dmap.npz")
    tp.map.save(path)
    with np.load(os.path.join(reference_run["dir"], "final.4dmap.npz")) as j, np.load(path) as t:
        assert sorted(j.files) == sorted(t.files)
        assert any(k.endswith("places/room_ids") for k in j.files)
        for k in j.files:
            assert j[k].dtype == t[k].dtype, k
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)


def _read(directory, names=RESULTS):
    return {n: open(os.path.join(directory, n), "rb").read() for n in names}


def test_the_reference_run_evaluates_the_same_in_both_packages(reference_run, tmp_path):
    """The port's PipelineEvaluator and both packages' eval CLIs on the
    reference's saved final.4dmap.npz + gt.npz: the reference's CSVs."""
    run_dir = reference_run["dir"]
    want = _read(os.path.join(run_dir, "results"))
    stm = TMap.load(os.path.join(run_dir, "final.4dmap.npz"))
    tpe.PipelineEvaluator(tpe.PipelineEvaluatorConfig(only_final=True), device="cpu").evaluate(
        stm, tpe.FileGroundTruth(os.path.join(run_dir, "gt.npz")), str(tmp_path / "t"))
    assert _read(str(tmp_path / "t")) == want
    gt = tpe.SceneGroundTruth(tsyn.office_scene(DURATION), DURATION, n_bg_points=GT_POINTS)
    tpe.PipelineEvaluator(tpe.PipelineEvaluatorConfig(only_final=True), device="cpu").evaluate(
        stm, gt, str(tmp_path / "oracle"))
    assert _read(str(tmp_path / "oracle")) == want
    args = ["--map", os.path.join(run_dir, "final.4dmap.npz"), "--only-final"]
    assert teval_main(args + ["--out", str(tmp_path / "cli_t"), "--device", "cpu"]) == 0
    assert jeval_main(args + ["--out", str(tmp_path / "cli_j")]) == 0
    assert _read(str(tmp_path / "cli_t")) == _read(str(tmp_path / "cli_j")) == want


def test_cli_runs_with_places_evaluation_and_viewer(tmp_path, capsys):
    """python -m khronos_tpu_torch.run --device cpu on a small version of the
    office config (4 s of 48x64 frames on a 48x48x32 grid), nothing turned
    off: every output file, the printed tables, the places spans, a places
    layer in the final 4D-map snapshot, and the standalone evaluation CLI
    (this package's and the reference's) reproducing the results byte for
    byte."""
    small = str(tmp_path / "small.yaml")
    with open(small, "w") as fh:
        yaml.safe_dump({"pipeline": {"active_window": {"volumetric_map": {"grid_shape": [48, 48, 32]}},
                                     "run_change_detection_every_n_frames": 10},
                        "dataset": {"duration": 4.0, "height": 48, "width": 64}}, fh)
    out_dir = str(tmp_path / "run")
    got = trun.main(["--device", "cpu", "--config", os.path.join(ROOT, "configs", "office_synthetic.yaml"), small,
                     f"run.output_dir={out_dir}"])
    printed = capsys.readouterr().out
    assert got == out_dir and ExperimentLogger.has_flag(out_dir, "Experiment Finished Cleanly")
    for f in ("viewer.html", "gt.npz", "dsg.npz", "final.4dmap.npz", *(os.path.join("results", r) for r in RESULTS)):
        assert os.path.exists(os.path.join(out_dir, f)), f
    assert "Background mesh (final row; values in %):" in printed and "pipeline/frame" in printed
    with open(os.path.join(out_dir, "timing", "stats.csv")) as fh:
        spans = {line.split(",")[0] for line in fh}
    assert {"pipeline/places_incremental", "places/window_cells", "places/candidates", "places/rooms"} <= spans
    stm = TMap.load(os.path.join(out_dir, "final.4dmap.npz"))
    assert stm.snapshots[-1].places is not None and JMap.load(os.path.join(out_dir, "final.4dmap.npz")).num_snapshots >= 2
    want = _read(os.path.join(out_dir, "results"))
    args = ["--map", os.path.join(out_dir, "final.4dmap.npz"), "--only-final"]
    assert teval_main(args + ["--out", str(tmp_path / "again"), "--device", "cpu"]) == 0
    assert jeval_main(args + ["--out", str(tmp_path / "reference")]) == 0
    assert _read(str(tmp_path / "again")) == _read(str(tmp_path / "reference")) == want


def test_deferred_places_updates_raise():
    """Deferred places updates (`defer_cd` with the incremental places layer):
    they used to raise in the port; now, as in the reference, process_frame
    defers the re-extraction and take_places_update hands it over once, with
    the reference's centre and stamp on the same frames, and running it
    gives the reference's layer."""
    cam, frames = _sequence_and_frames()
    spec = {**copy.deepcopy(CD_PIPELINE), "places": {}}
    jpipe = JPipeline(jbuild(JPipelineConfig, spec), cam)
    tpipe = TPipeline(tbuild(TPipelineConfig, spec), torch_camera(cam), device="cpu")
    f, R, t = frames[0]
    jpipe.process_frame(JFrame(stamp_ns=f["stamp_ns"], depth=jnp.asarray(f["depth"]), color=jnp.asarray(f["color"]),
                               labels=jnp.asarray(f["labels"]), R_w_c=R, t_w_c=t), defer_cd=True)
    import torch

    from khronos_tpu_torch.active_window.frame_data import FrameData as TFrame

    tpipe.process_frame(TFrame(stamp_ns=f["stamp_ns"], depth=torch.from_numpy(f["depth"]),
                               color=torch.from_numpy(f["color"]), labels=torch.from_numpy(f["labels"]),
                               R_w_c=R, t_w_c=t), defer_cd=True)
    np.testing.assert_array_equal(tpipe._places_due[0], np.asarray(jpipe._places_due[0]))
    assert tpipe._places_due[1] == jpipe._places_due[1]
    jjob, tjob = jpipe.take_places_update(), tpipe.take_places_update()
    assert tjob is not None and tpipe.take_places_update() is None
    jjob()
    tjob()
    assert_layers_equal(jpipe.places_extractor.snapshot_layer(), tpipe.places_extractor.snapshot_layer())
