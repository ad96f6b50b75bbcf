"""Port parity for the evaluation suite (eval/): the evaluators, the
ground-truth oracle and its gt.npz, the pipeline evaluator and its CLI, the
result and timing tables, the 4D viewer and the GT-builder toolkit.

Seeded numpy inputs go through both packages on the CPU. Tolerance: none.
The nearest distances are the reference's bit for bit (the port's
`min_distances`, tests/test_torch_changes.py), and everything downstream is
the same numpy, so metrics are compared with == (NaN where the reference has
NaN), CSVs, tables and viewer.html byte for byte."""

import math
import os

import numpy as np
import pytest

from khronos_tpu.data import synthetic as jsyn
from khronos_tpu.eval import evaluators as jev
from khronos_tpu.eval import ground_truth as jgt
from khronos_tpu.eval import pipeline_evaluator as jpe
from khronos_tpu.eval import plotting as jplot
from khronos_tpu.eval import viewer as jviewer
from khronos_tpu.eval.__main__ import main as jeval_main
from khronos_tpu.stm import places as jplaces
from khronos_tpu.stm import scene_graph as jsg
from khronos_tpu.stm.spatio_temporal_map import SpatioTemporalMap as JMap
from khronos_tpu_torch.data import synthetic as tsyn
from khronos_tpu_torch.eval import evaluators as tev
from khronos_tpu_torch.eval import ground_truth as tgt
from khronos_tpu_torch.eval import pipeline_evaluator as tpe
from khronos_tpu_torch.eval import plotting as tplot
from khronos_tpu_torch.eval import viewer as tviewer
from khronos_tpu_torch.eval.__main__ import main as teval_main
from khronos_tpu_torch.stm import places as tplaces
from khronos_tpu_torch.stm import scene_graph as tsg
from khronos_tpu_torch.stm.spatio_temporal_map import SpatioTemporalMap as TMap

DURATION = 30.0
S = int(1e9)
PKGS = {"j": (jsg, jplaces, JMap), "t": (tsg, tplaces, TMap)}


def assert_same(got, want):
    """Dicts (or scalars) equal, NaN where the reference has NaN."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            assert_same(got[k], want[k])
    elif isinstance(want, float) and math.isnan(want):
        assert math.isnan(got)
    else:
        assert got == want and type(got) is type(want), (got, want)


def make_objects(sg, seed=0):
    """The same estimated objects in one package's types: static boxes near
    the office's furniture (one disappearing at 15 s, one appearing, one
    hallucinated), and a dynamic track."""
    rng = np.random.default_rng(seed)
    out = []
    specs = [(2, [4.0, 2.4, 0.4], 0, None), (2, [-4.1, -2.3, 0.4], 0, None), (6, [0.1, 3.4, 0.9], 0, None),
             (5, [-4.2, 2.9, 0.3], 0, None), (3, [3.7, -2.6, 0.35], 0, 15.4), (4, [-0.4, -3.3, 0.5], 15.8, None),
             (3, [1.0, 1.0, 0.4], 2.0, 9.0)]
    for i, (cat, c, t0, t1) in enumerate(specs):
        c = np.asarray(c, np.float32)
        verts = rng.uniform(0, 0.5, (40, 3)).astype(np.float32)
        out.append(sg.KhronosObject(
            node_id=i + 1, semantic_category=cat, bbox_min=c - 0.25, bbox_max=c + 0.25,
            first_observed_ns=[int(t0 * S)], last_observed_ns=[int((t1 if t1 is not None else DURATION) * S)],
            mesh_vertices=verts, mesh_faces=np.zeros((0, 3), np.int64), mesh_colors=np.full((40, 3), 0.5, np.float32)))
    ts = np.arange(0, 20 * S, S // 2, dtype=np.int64)
    pos = np.stack([np.linspace(1.5, -1.4, len(ts)), np.linspace(-1.5, 1.4, len(ts)), np.full(len(ts), 0.85)], 1)
    out.append(sg.KhronosObject(
        node_id=20, semantic_category=1, bbox_min=np.zeros(3, np.float32), bbox_max=np.ones(3, np.float32),
        first_observed_ns=[0], last_observed_ns=[int(20 * S)], mesh_vertices=np.zeros((0, 3), np.float32),
        mesh_faces=np.zeros((0, 3), np.int64), mesh_colors=np.zeros((0, 3), np.float32),
        trajectory_stamps_ns=ts.tolist(), trajectory_positions=(pos + rng.normal(0, 0.1, pos.shape)).astype(np.float32)))
    return out


def make_map(pkg, n_snapshots=3, seed=0):
    """A 4D map of the office in one package: each snapshot a noisy sample
    of the scene's surface as the background mesh, the objects, an agent
    path and a places layer."""
    sg, places, Map = PKGS[pkg]
    syn = jsyn if pkg == "j" else tsyn
    scene = syn.office_scene(DURATION)
    stm = Map()
    rng = np.random.default_rng(seed)
    for k in range(n_snapshots):
        t = (k + 1) * DURATION / n_snapshots - 0.1
        pts, labels = syn.sample_scene_surface(scene, t, 3000, seed=k)
        pts = (pts + rng.normal(0, 0.03, pts.shape)).astype(np.float32)
        n = len(pts)
        dsg = sg.SceneGraph()
        dsg.mesh = sg.Mesh(vertices=pts, colors=rng.random((n, 3)).astype(np.float32),
                           labels=labels.astype(np.int32), first_seen_ns=np.sort(rng.integers(0, int(t * S), n)),
                           last_seen_ns=np.full(n, int(t * S), np.int64), faces=np.zeros((0, 3), np.int64))
        for o in make_objects(sg, seed):
            dsg.add_object(o)
        for j in range(5):
            dsg.agents.append(sg.AgentNode(int(j * t / 5 * S), np.eye(3, dtype=np.float32),
                                           np.asarray([j * 0.5, 0.1 * j, 1.4], np.float32), j))
        layer = places.PlacesLayer()
        for j in range(4):
            layer.nodes.append(places.PlaceNode(j, np.asarray([j, -j, 1.0], np.float32), 0.5 + 0.25 * j, j % 2))
        layer.edges = [(0, 1, 0.5), (1, 2, 0.75)]
        dsg.places = layer
        stm.update(dsg, int(t * S))
    return scene, stm


# ----------------------------------------------------------------------------
# evaluators
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("sub", [20000, 500])
def test_evaluate_mesh(sub):
    rng = np.random.default_rng(sub)
    gt = rng.uniform(-3, 3, (2500, 3)).astype(np.float32)
    est = (gt[rng.permutation(2500)[:1800]] + rng.normal(0, 0.08, (1800, 3))).astype(np.float32)
    cfg = dict(thresholds=(0.05, 0.1, 0.2, 0.5), vertex_subsample=sub)
    want = jev.evaluate_mesh(est, gt, jev.MeshEvaluatorConfig(**cfg))
    assert_same(tev.evaluate_mesh(est, gt, tev.MeshEvaluatorConfig(**cfg), device="cpu"), want)
    assert 0 < want["accuracy@0.1"] < 1
    empty = np.zeros((0, 3), np.float32)
    assert_same(tev.evaluate_mesh(empty, gt, device="cpu"), jev.evaluate_mesh(empty, gt))


GTS = [(0, 2, [4.0, 2.4, 0.4], 0, None), (1, 3, [3.8, -2.6, 0.35], None, 15.0), (2, 4, [-0.5, -3.4, 0.5], 15.0, None),
       (3, 6, [0.0, 3.5, 0.9], None, None), (4, 5, [-4.2, 2.8, 0.3], None, None), (5, 2, [-4.0, -2.4, 0.4], None, None)]


def make_gts(ev, surface=False):
    out = []
    rng = np.random.default_rng(7)
    for gid, label, c, ta, td in GTS:
        c = np.asarray(c, np.float32)
        out.append(ev.GtObject(gid, label, c, c - 0.3, c + 0.3,
                               t_appear_ns=int(ta * S) if ta is not None else -(1 << 62),
                               t_disappear_ns=int(td * S) if td is not None else 1 << 62,
                               surface_points=(c + rng.uniform(-0.3, 0.3, (30, 3))).astype(np.float32) if surface else None))
    return out


@pytest.mark.parametrize("association,match_labels", [("centroid", False), ("centroid", True), ("surface", False)])
@pytest.mark.parametrize("query_s", [5.0, 20.0])
def test_associate_and_evaluate_objects(association, match_labels, query_s):
    cfg = dict(association=association, max_match_distance=2.0, surface_subsample=16, match_labels=match_labels)
    jcfg, tcfg = jev.ObjectEvaluatorConfig(**cfg), tev.ObjectEvaluatorConfig(**cfg)
    jobj, tobj = make_objects(jsg), make_objects(tsg)
    jgts, tgts = make_gts(jev, association == "surface"), make_gts(tev, association == "surface")
    q = int(query_s * S)
    je, jg, jm, jgm = jev.associate_objects(jobj, jgts, q, jcfg)
    te, tg, tm, tgm = tev.associate_objects(tobj, tgts, q, tcfg, device="cpu")
    assert [o.node_id for o in te] == [o.node_id for o in je] and [g.gt_id for g in tg] == [g.gt_id for g in jg]
    assert tm == jm and tgm == jgm and len(jm) >= 3
    assert_same(tev.evaluate_objects(tobj, tgts, q, tcfg, device="cpu"), jev.evaluate_objects(jobj, jgts, q, jcfg))
    assert tev.segmentation_cardinalities(te, tg, tcfg) == jev.segmentation_cardinalities(je, jg, jcfg)


@pytest.mark.parametrize("tol", [10.0, 0.3])
def test_evaluate_changes(tol):
    want = jev.evaluate_changes(make_objects(jsg), make_gts(jev), 0, int(DURATION * S), jev.ChangeEvalConfig(tol))
    got = tev.evaluate_changes(make_objects(tsg), make_gts(tev), 0, int(DURATION * S), tev.ChangeEvalConfig(tol))
    assert_same(got, want)
    assert want["appeared_tp"] + want["disappeared_tp"] + want["appeared_fn"] + want["disappeared_fn"] == 2


@pytest.mark.parametrize("radius", [0.5, 0.15])
def test_evaluate_dynamic(radius):
    scene = jsyn.office_scene(DURATION)
    gt = jpe.SceneGroundTruth(scene, DURATION).gt_dynamic_trajectories()
    want = jev.evaluate_dynamic(make_objects(jsg), gt, jev.DynamicEvaluatorConfig(radius))
    got = tev.evaluate_dynamic(make_objects(tsg), gt, tev.DynamicEvaluatorConfig(radius))
    assert_same(got, want)
    assert want["dynamic_tp"] > 0 and want["dynamic_fn"] > 0


@pytest.mark.parametrize("case", ["drift", "outside", "empty"])
def test_evaluate_trajectory(case):
    rng = np.random.default_rng(3)
    gt_t = np.arange(0, 10 * S, S // 10, dtype=np.int64)
    gt_p = np.cumsum(rng.normal(0, 0.05, (len(gt_t), 3)), axis=0)
    est_t = np.arange(S // 20, 9 * S, S // 4, dtype=np.int64)
    if case == "outside":
        est_t = est_t + 20 * S
    if case == "empty":
        est_t = est_t[:0]
    est_p = np.cumsum(rng.normal(0, 0.05, (len(est_t), 3)), axis=0).astype(np.float32)
    assert_same(tev.evaluate_trajectory(est_t, est_p, gt_t, gt_p), jev.evaluate_trajectory(est_t, est_p, gt_t, gt_p))


@pytest.mark.parametrize("t,seed", [(0.0, 0), (16.0, 3), (29.9, 11)])
def test_sample_scene_surface_bit_for_bit(t, seed):
    jp_, jl = jsyn.sample_scene_surface(jsyn.office_scene(DURATION), t, 20000, seed=seed)
    tp_, tl = tsyn.sample_scene_surface(tsyn.office_scene(DURATION), t, 20000, seed=seed)
    assert tp_.dtype == jp_.dtype and tl.dtype == jl.dtype
    np.testing.assert_array_equal(tp_, jp_)
    np.testing.assert_array_equal(tl, jl)
    assert len(jp_) > 15000


# ----------------------------------------------------------------------------
# ground truth, the pipeline evaluator, its CLI, tables and the viewer
# ----------------------------------------------------------------------------


def test_ground_truth_oracle_and_gt_npz_across_packages(tmp_path):
    jo = jpe.SceneGroundTruth(jsyn.office_scene(DURATION), DURATION, n_bg_points=3000)
    to = tpe.SceneGroundTruth(tsyn.office_scene(DURATION), DURATION, n_bg_points=3000)
    for a, b in zip(to.gt_objects(), jo.gt_objects()):
        assert (a.gt_id, a.label, a.t_appear_ns, a.t_disappear_ns) == (b.gt_id, b.label, b.t_appear_ns, b.t_disappear_ns)
        for f in ("center", "bbox_min", "bbox_max"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    times = [4.9, 14.9, 29.9, 14.9]
    jpe.save_ground_truth(jo, str(tmp_path / "j.npz"), times)
    tpe.save_ground_truth(to, str(tmp_path / "t.npz"), times)
    with np.load(tmp_path / "j.npz") as a, np.load(tmp_path / "t.npz") as b:
        assert sorted(a.files) == sorted(b.files) and "dyn/7/pos" in a.files
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    # each package's FileGroundTruth reads the other's file
    fj, ft = jpe.FileGroundTruth(str(tmp_path / "t.npz")), tpe.FileGroundTruth(str(tmp_path / "j.npz"))
    assert ft.duration_s == fj.duration_s == DURATION
    np.testing.assert_array_equal(ft.background_points(15.3), fj.background_points(15.3))
    assert [g.gt_id for g in ft.gt_objects()] == [g.gt_id for g in fj.gt_objects()]
    assert sorted(ft.gt_dynamic_trajectories()) == sorted(fj.gt_dynamic_trajectories())


def _read(directory):
    return {f: open(os.path.join(directory, f), "rb").read() for f in sorted(os.listdir(directory))}


@pytest.mark.parametrize("only_final", [True, False])
def test_pipeline_evaluator_csvs_equal(tmp_path, only_final):
    scene, jmap = make_map("j")
    _, tmap = make_map("t")
    cfg = dict(only_final=only_final)
    jo = jpe.SceneGroundTruth(scene, DURATION, n_bg_points=4000)
    to = tpe.SceneGroundTruth(tsyn.office_scene(DURATION), DURATION, n_bg_points=4000)
    gt_traj = (np.arange(0, 30 * S, S, dtype=np.int64), np.zeros((30, 3)))
    js = jpe.PipelineEvaluator(jpe.PipelineEvaluatorConfig(**cfg)).evaluate(jmap, jo, str(tmp_path / "j"),
                                                                           gt_trajectory=gt_traj)
    ts = tpe.PipelineEvaluator(tpe.PipelineEvaluatorConfig(**cfg), device="cpu").evaluate(
        tmap, to, str(tmp_path / "t"), gt_trajectory=gt_traj)
    assert_same(ts, js)
    got, want = _read(tmp_path / "t"), _read(tmp_path / "j")
    assert sorted(want) == ["background_mesh.csv", "changes.csv", "dynamic_objects.csv", "map_timestamps.txt",
                            "static_objects.csv", "trajectory.csv"]
    assert got == want
    assert js["objects"]["detected"] >= 3 and 0 < js["mesh"]["accuracy@0.1"] <= 1
    # the result tables read the same directory the same way
    assert tplot.results_table(str(tmp_path / "j")) == jplot.results_table(str(tmp_path / "j"))


def test_eval_cli_across_packages(tmp_path):
    """Each package's `python -m ... .eval` on one saved map + gt.npz (written
    by the reference) gives the same CSVs as the pipeline evaluator."""
    scene, jmap = make_map("j", n_snapshots=2)
    run = tmp_path / "run"
    run.mkdir()
    jmap.save(str(run / "final.4dmap.npz"))
    jpe.save_ground_truth(jpe.SceneGroundTruth(scene, DURATION, n_bg_points=3000), str(run / "gt.npz"),
                          [s * 1e-9 for s in jmap.stamps()])
    assert jeval_main(["--map", str(run / "final.4dmap.npz"), "--out", str(tmp_path / "j"), "--only-final"]) == 0
    assert teval_main(["--map", str(run / "final.4dmap.npz"), "--out", str(tmp_path / "t"), "--only-final",
                       "--device", "cpu"]) == 0
    assert _read(tmp_path / "t") == _read(tmp_path / "j")
    assert teval_main(["--map", str(run / "final.4dmap.npz"), "--gt", str(tmp_path / "none.npz"),
                       "--device", "cpu"]) == 2
    # and the default directory, all snapshots: (map stamp, query time <= it) pairs
    assert teval_main(["--map", str(run / "final.4dmap.npz"), "--device", "cpu"]) == 0
    assert (run / "results" / "background_mesh.csv").read_text().count("\n") == 1 + 3


def test_tables_on_a_fixed_directory(tmp_path):
    res, timing = tmp_path / "results", tmp_path / "timing"
    res.mkdir()
    timing.mkdir()
    (res / "background_mesh.csv").write_text(
        "accuracy@0.05,accuracy@0.1,accuracy@0.2,accuracy@0.5,chamfer,completeness@0.05,completeness@0.1,"
        "completeness@0.2,completeness@0.5,f1@0.05,f1@0.1,f1@0.2,f1@0.5,rmse\n"
        "0.1,0.5,0.9,1.0,0.17,0.2,0.8,0.99,1.0,0.13,0.61,0.94,1.0,0.13\n")
    (res / "static_objects.csv").write_text("precision,recall,f1,num_est,num_gt,missed,hallucinated\n1.0,0.8,0.88,6,5,1,0\n")
    (res / "dynamic_objects.csv").write_text("dynamic_precision,dynamic_recall,dynamic_f1\n0.93,0.35,0.51\n")
    (res / "changes.csv").write_text("change_precision,change_recall,change_f1,appeared_tp,appeared_fn,disappeared_tp,"
                                     "disappeared_fn\n0.5,1.0,0.66,1,0,1,0\n")
    (timing / "stats.csv").write_text("name,n_samples,total_s,mean_s,stddev_s,min_s,max_s\n"
                                      "pipeline/frame,300,19.5,0.065,0.01,0.02,0.9\n"
                                      "places/rooms,3,0.4,0.13,0.01,0.1,0.2\n"
                                      "pipeline/places_incremental,63,3.1,0.05,0.01,0.01,0.3\n")
    assert tplot.results_table(str(res)) == jplot.results_table(str(res))
    assert "Changes:  P= 50.0" in tplot.results_table(str(res))
    assert tplot.timing_table(str(timing)) == jplot.timing_table(str(timing))
    assert tplot.timing_table(str(timing), top=1) == jplot.timing_table(str(timing), top=1)
    assert tplot.load_timing(str(timing)) == jplot.load_timing(str(timing))
    assert tplot.timing_hierarchy(str(timing)) == jplot.timing_hierarchy(str(timing))
    assert tplot.results_table(str(tmp_path / "missing")) == ""


@pytest.mark.parametrize("max_points", [120000, 1000])
def test_viewer_html_bytes(tmp_path, max_points):
    _, jmap = make_map("j")
    _, tmap = make_map("t")
    jviewer.export_html(jmap, str(tmp_path / "j.html"), max_points=max_points)
    tviewer.export_html(tmap, str(tmp_path / "t.html"), max_points=max_points)
    want = (tmp_path / "j.html").read_bytes()
    assert (tmp_path / "t.html").read_bytes() == want and b'"room": 1' in want
    # from each package's reload of the other's archive, too
    jmap.save(str(tmp_path / "j.4dmap.npz"))
    tviewer.export_html(TMap.load(str(tmp_path / "j.4dmap.npz")), str(tmp_path / "t2.html"), max_points=max_points)
    assert (tmp_path / "t2.html").read_bytes() == want


# ----------------------------------------------------------------------------
# GT-builder toolkit
# ----------------------------------------------------------------------------


def _blobs(seed=0):
    rng = np.random.default_rng(seed)
    centers = [[0, 0, 0], [0.2, 0, 0], [3, 0, 0], [0, 5, 1], [6, 6, 0]]
    pts = np.concatenate([np.asarray(c) + rng.normal(0, 0.05, (30 + 10 * i, 3)) for i, c in enumerate(centers)])
    labels = np.concatenate([np.full(30 + 10 * i, [2, 2, 3, 0, 3][i]) for i in range(5)])
    return pts.astype(np.float32), labels.astype(np.int32)


@pytest.mark.parametrize("tolerance,min_size", [(0.25, 1), (0.25, 45), (1.0, 20)])
def test_euclidean_cluster(tolerance, min_size):
    pts, _ = _blobs()
    want = jgt.euclidean_cluster(pts, tolerance, min_size)
    got = tgt.euclidean_cluster(pts, tolerance, min_size)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_color_map_build_prune_consolidate(tmp_path):
    pts, labels = _blobs(1)
    palette = np.asarray([[0, 0, 0], [255, 0, 0], [0, 255, 0], [0, 0, 255]], np.uint8)
    colors = palette[np.clip(labels, 0, 3)]
    for nearest in (False, True):
        jm, tm = jgt.ColorLabelMap(palette, [0, 1, 2, 3], nearest), tgt.ColorLabelMap(palette, [0, 1, 2, 3], nearest)
        np.testing.assert_array_equal(tm(colors + (5 if nearest else 0)), jm(colors + (5 if nearest else 0)))
    maps = []
    for k, (jmod, ev) in enumerate(((jgt, jev), (tgt, tev))):
        cfg = jmod.GtBuilderConfig(cluster_tolerance=0.25, min_cluster_size=20, object_labels=(2, 3), surface_subsample=16)
        by_label = jmod.build_gt_map(pts, labels, cfg, stamp_ns=S)
        by_color = jmod.build_gt_map(pts, None, cfg, stamp_ns=S, colors=colors,
                                     color_map=jmod.ColorLabelMap(palette, [0, 1, 2, 3]))
        kw = {} if jmod is jgt else {"device": "cpu"}
        pruned = jmod.prune_to_observed(by_label, pts[labels != 3], max_distance=0.3, **kw)
        later = jmod.build_gt_map(pts[labels != 3], labels[labels != 3], cfg, stamp_ns=5 * S)
        merged = jmod.consolidate_gt_maps([later, by_label])
        maps.append((by_label, by_color, pruned, merged))
    for jm_, tm_ in zip(*maps):
        np.testing.assert_array_equal(tm_.background_points, jm_.background_points)
        assert tm_.stamp_ns == jm_.stamp_ns and len(tm_.objects) == len(jm_.objects) >= 1
        for a, b in zip(tm_.objects, jm_.objects):
            assert (a.gt_id, a.label, a.t_appear_ns, a.t_disappear_ns) == (b.gt_id, b.label, b.t_appear_ns, b.t_disappear_ns)
            for f in ("center", "bbox_min", "bbox_max", "surface_points"):
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert any(g.t_disappear_ns == 5 * S for g in maps[1][3].objects)
    # the GT map and the dynamic-GT CSVs, written by one package, read by the other
    tgt.save_gt_map(maps[1][3], str(tmp_path / "t"))
    jgt.save_gt_map(maps[0][3], str(tmp_path / "j"))
    for f in ("gt_changes.csv",):
        assert (tmp_path / "t" / f).read_bytes() == (tmp_path / "j" / f).read_bytes()
    back_t, back_j = tgt.load_gt_map(str(tmp_path / "j")), jgt.load_gt_map(str(tmp_path / "t"))
    assert [g.gt_id for g in back_t.objects] == [g.gt_id for g in back_j.objects]
    for a, b in zip(back_t.objects, back_j.objects):
        np.testing.assert_array_equal(a.center, b.center)
        np.testing.assert_array_equal(a.surface_points, b.surface_points)
    seqs = {3: [(2 * S, pts[:5]), (S, pts[5:9])], 1: [(0, pts[9:12])]}
    traj = tgt.dynamic_gt_from_point_sequences(seqs)
    want = jgt.dynamic_gt_from_point_sequences(seqs)
    tgt.save_dynamic_gt_csv(str(tmp_path / "t.csv"), traj)
    jgt.save_dynamic_gt_csv(str(tmp_path / "j.csv"), want)
    assert (tmp_path / "t.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()
    back = tgt.load_dynamic_gt_csv(str(tmp_path / "j.csv"))
    assert sorted(back) == [1, 3] and back[3][0].tolist() == [S, 2 * S]
    assert tgt.load_gt_changes_csv(str(tmp_path / "j" / "gt_changes.csv")) == jgt.load_gt_changes_csv(
        str(tmp_path / "t" / "gt_changes.csv"))
