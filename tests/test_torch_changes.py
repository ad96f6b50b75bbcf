"""Port parity for change detection, the reconciler and the 4D map: the
scenes of tests/test_changes.py (plus a few that reach the int32 corners)
through the JAX package and the port on the CPU, from the same numpy inputs.

Tolerances: the ray index (sorted cells, sorted rays, cell starts, the
packed ray table) and every integer output (evidence counts, scan bins,
vote counts, touched cells, background states, ObjectChange stamps, keep
masks) are compared bit for bit; so are the float arrays of the reconciled
scene graphs and 4D-map archives, which the port copies from its inputs
without arithmetic. Nearest distances agree bit for bit (the port computes
the reference's fused multiply-adds). The evidence tolerance is 0 on every
scene here."""

import dataclasses
import filecmp

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from khronos_tpu.backend.backend import MergeProposal as JMerge
from khronos_tpu.changes import change_detector as jcd
from khronos_tpu.changes import detectors as jdet
from khronos_tpu.changes import ray_verificator as jrv
from khronos_tpu.changes.change_state import Changes as JChanges
from khronos_tpu.changes.change_state import ObjectChange as JObjectChange
from khronos_tpu.changes.reconciler import Reconciler as JReconciler
from khronos_tpu.changes.reconciler import ReconcilerConfig as JReconcilerConfig
from khronos_tpu.eval.evaluators import min_distances as jmin_distances
from khronos_tpu.stm import serialization as jser
from khronos_tpu.stm.scene_graph import AgentNode, KhronosObject, Mesh, SceneGraph
from khronos_tpu.stm.spatio_temporal_map import SpatioTemporalMap as JMap
from khronos_tpu_torch.changes import change_detector as tcd
from khronos_tpu_torch.changes import detectors as tdet
from khronos_tpu_torch.changes import ray_verificator as trv
from khronos_tpu_torch.changes.change_state import Changes as TChanges
from khronos_tpu_torch.changes.change_state import ObjectChange as TObjectChange
from khronos_tpu_torch.changes.reconciler import Reconciler as TReconciler
from khronos_tpu_torch.changes.reconciler import ReconcilerConfig as TReconcilerConfig
from khronos_tpu_torch.eval.evaluators import min_distances as tmin_distances
from khronos_tpu_torch.stm import serialization as tser
from khronos_tpu_torch.stm.spatio_temporal_map import SpatioTemporalMap as TMap

from torch_parity import torch_merge, torch_scene_graph


# ----------------------------------------------------------------------------
# scenes (tests/test_changes.py's, built in the JAX package's types)
# ----------------------------------------------------------------------------


def make_mesh(vertices, first_s, last_s):
    V = len(vertices)
    return Mesh(
        vertices=np.asarray(vertices, np.float32),
        colors=np.zeros((V, 3), np.float32),
        labels=np.zeros(V, np.int32),
        first_seen_ns=(np.asarray(first_s) * 1e9).astype(np.int64),
        last_seen_ns=(np.asarray(last_s) * 1e9).astype(np.int64),
        faces=np.zeros((0, 3), np.int64),
    )


def make_agents(position, stamps_s):
    return [AgentNode(int(s * 1e9), np.eye(3, dtype=np.float32), np.asarray(position, np.float32))
            for s in stamps_s]


def make_object(nid, center, first_s, last_s, mesh_pts=None, cls=2):
    c = np.asarray(center, np.float32)
    pts = np.asarray(mesh_pts, np.float32) if mesh_pts is not None else np.zeros((0, 3), np.float32)
    return KhronosObject(
        node_id=nid, semantic_category=cls, bbox_min=c - 0.2, bbox_max=c + 0.2,
        first_observed_ns=[int(first_s * 1e9)], last_observed_ns=[int(last_s * 1e9)],
        mesh_vertices=pts - (c - 0.2) if len(pts) else pts,
        mesh_faces=np.zeros((0, 3), np.int64), mesh_colors=np.zeros((len(pts), 3), np.float32),
    )


def wall_scene():
    """Agent at (0, 0, 1); one wall vertex at (5, 0, 1) seen [0, 100] s."""
    dsg = SceneGraph()
    dsg.agents = make_agents([0, 0, 1], np.arange(0, 101, 2.0))
    dsg.mesh = make_mesh([[5, 0, 1]], [0.0], [100.0])
    return dsg


def long_ray_scene():
    dsg = SceneGraph()
    dsg.agents = make_agents([0.05, 0.05, 0.05], np.arange(0, 101, 2.0))
    dsg.mesh = make_mesh([[20.0, 0.05, 0.05]], [0.0], [100.0])
    return dsg


def corridor_scene(n_segments):
    """Corridor marching +x: segment k adds 40 wall vertices near x = 10 k."""
    dsg = SceneGraph()
    stamps = np.arange(0, n_segments * 10.0, 2.0)
    dsg.agents = [AgentNode(int(s * 1e9), np.eye(3, dtype=np.float32), np.asarray([s, 0, 1], np.float32))
                  for s in stamps]
    verts, first, last = [], [], []
    for k in range(n_segments):
        verts.append(np.stack([np.full(40, 10.0 * k + 3.0), np.linspace(-2, 2, 40), np.ones(40)], axis=1))
        first += [10.0 * k] * 40
        last += [10.0 * k + 8.0] * 40
    dsg.mesh = make_mesh(np.concatenate(verts), first, last)
    dsg.opt_epoch = 1
    return dsg


def random_scene(seed=0, n_agents=40, n_verts=300):
    """General positions (no grid alignment): agents on a noisy circle
    looking around, vertices scattered in a room."""
    rng = np.random.default_rng(seed)
    dsg = SceneGraph()
    ang = np.linspace(0, 2 * np.pi, n_agents)
    for i, a in enumerate(ang):
        R = np.asarray([[np.cos(a), 0, -np.sin(a)], [np.sin(a), 0, np.cos(a)], [0, 1, 0]], np.float32)
        t = np.asarray([1.3 * np.cos(a), 1.3 * np.sin(a), 1.2], np.float32) + rng.normal(0, 0.03, 3).astype(np.float32)
        dsg.agents.append(AgentNode(int((i * 0.7 + 1.0) * 1e9), R, t))
    verts = rng.uniform([-3.5, -3.5, 0.0], [3.5, 3.5, 2.5], (n_verts, 3))
    first = rng.uniform(0, 20, n_verts)
    last = first + rng.uniform(0, 12, n_verts)
    dsg.mesh = make_mesh(verts, first, last)
    dsg.opt_epoch = 0
    return dsg


def disappearance_scene():
    dsg = SceneGraph()
    dsg.agents = make_agents([0, 0, 1], np.arange(0, 101, 2.0))
    verts = [[4.0, 0, 1], [4.0, 0.1, 1], [5.0, 0, 1], [5.0, 0.1, 1], [0.0, 3.0, 1]]
    dsg.mesh = make_mesh(verts, [0.0, 0.0, 45.0, 45.0, 0.0], [40.0, 40.0, 100.0, 100.0, 100.0])
    dsg.objects[1] = make_object(1, [4.0, 0.05, 1], 0.0, 40.0, mesh_pts=[[4.0, 0, 1], [4.0, 0.1, 1]])
    return dsg


def persistence_scene():
    dsg = SceneGraph()
    dsg.agents = make_agents([0, 0, 1], np.arange(0, 101, 2.0))
    dsg.mesh = make_mesh([[4.0, 0, 1], [4.0, 0.1, 1], [0.0, 3.0, 1]], [0.0] * 3, [100.0] * 3)
    dsg.objects[1] = make_object(1, [4.0, 0.05, 1], 0.0, 40.0, mesh_pts=[[4.0, 0, 1]])
    return dsg


def twin_scene():
    """Wall at x=5 seen [0, 100] s; twin T (2) seen [0, 60], survivor S (1)
    seen [62, 100], the same spot at x=4."""
    dsg = SceneGraph()
    dsg.agents = make_agents([0, 0, 1], np.arange(0, 101, 2.0))
    dsg.mesh = make_mesh([[5.0, 0, 1], [5.0, 0.1, 1]], [0.0, 0.0], [100.0, 100.0])
    pts = [[4.0, 0, 1], [4.0, 0.1, 1]]
    dsg.objects[1] = make_object(1, [4.0, 0.05, 1], 62.0, 100.0, mesh_pts=pts)
    dsg.objects[2] = make_object(2, [4.0, 0.05, 1], 0.0, 60.0, mesh_pts=pts)
    return dsg


def veto_scene():
    """The twin-presence veto inside a whole pass: object 1 is removed after
    40 s (rays from the wall behind read through it), and a same-class
    fragment (3) at the same spot is re-observed at 70-90 s, so the removal
    is vetoed; object 4, elsewhere, disappears for real."""
    def plus(c, r):  # six points around c, a box of half-size r
        return np.asarray(c, np.float32) + np.float32(r) * np.concatenate([np.eye(3), -np.eye(3)]).astype(np.float32)

    dsg = SceneGraph()
    dsg.agents = make_agents([0, 0, 1], np.arange(0, 101, 2.0))
    wall = [[5.0, 0.05 + dy, 1.0 + dz] for dy in (-0.05, 0.0, 0.05) for dz in (-0.05, 0.0, 0.05)]
    verts = [[4.0, 0.05, 1.0]] + wall + [[0.0, 4.0, 1.0], [0.0, 4.0, 1.2]]
    n = len(verts)
    dsg.mesh = make_mesh(verts, [0.0] + [45.0] * (n - 1), [40.0] + [100.0] * (n - 1))
    dsg.objects[1] = make_object(1, [4.0, 0.05, 1], 0.0, 40.0, mesh_pts=plus([4.0, 0.05, 1.0], 0.05))
    dsg.objects[3] = make_object(3, [4.0, 0.05, 1], 70.0, 90.0, mesh_pts=plus([4.0, 0.05, 1.0], 0.04))
    dsg.objects[4] = make_object(4, [0.0, 3.0, 1.1], 0.0, 40.0, mesh_pts=[[0.0, 3.0, 1.0], [0.0, 3.0, 1.2]], cls=5)
    return dsg


def both(cfg_kw=None):
    """The same RayVerificatorConfig in each package."""
    cfg_kw = cfg_kw or {}
    return jrv.RayVerificatorConfig(**cfg_kw), trv.RayVerificatorConfig(**cfg_kw)


def index_arrays(ver, torch_side):
    keys = ("sorted_cells", "sorted_rays", "cell_start", "ray_table", "target_idx")
    if torch_side:
        return {k: getattr(ver, k).numpy() for k in keys}
    return {k: np.asarray(getattr(ver, k)) for k in keys}


def assert_index_equal(jver, tver):
    j, t = index_arrays(jver, False), index_arrays(tver, True)
    for k in j:
        assert j[k].dtype == t[k].dtype, k
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    assert tver.num_rays == jver.num_rays
    assert (tver.bin_origin_s, tver.active_num_bins) == (jver.bin_origin_s, jver.active_num_bins)


# ----------------------------------------------------------------------------
# the ray verificator
# ----------------------------------------------------------------------------

INDEX_SCENES = {
    "wall_all": (wall_scene, {"ray_policy": "All", "num_bins": 32, "temporal_resolution": 4.0}),
    "long_ray": (long_ray_scene, {"ray_policy": "Middle", "num_bins": 32, "temporal_resolution": 4.0}),
    "corridor": (lambda: corridor_scene(8), {"ray_policy": "Middle", "max_ray_length": 12.0}),
    "random_all": (random_scene, {"ray_policy": "All", "temporal_resolution": 2.0, "max_ray_length": 5.25}),
    "random_sampled": (lambda: random_scene(1), {"ray_policy": "SampledAll", "max_ray_angle_deg": 50.0}),
}


@pytest.mark.parametrize("scene", list(INDEX_SCENES))
def test_index_and_query_match_reference(scene):
    """The CSR index bit for bit, and the evidence of points on, in front of,
    behind and beside the rays exactly."""
    make, kw = INDEX_SCENES[scene]
    dsg = make()
    jcfg, tcfg = both(kw)
    jver = jrv.RayVerificator(jcfg)
    tver = trv.RayVerificator(tcfg, device="cpu")
    jver.build(dsg)
    tver.build(torch_scene_graph(dsg))
    assert_index_equal(jver, tver)
    rng = np.random.default_rng(3)
    verts = dsg.mesh.vertices
    pts = np.concatenate([
        verts, verts - 0.5, verts + 0.07,
        rng.uniform(verts.min(0) - 1, verts.max(0) + 1, (500, 3)),
    ]).astype(np.float32)
    ev_j, ev_t = jver.query(pts), tver.query(pts)
    assert ev_t.dtype == ev_j.dtype
    np.testing.assert_array_equal(ev_t, ev_j)
    assert ev_j.sum() > 0


def test_per_point_tolerance_and_candidate_overflow():
    """A ray 6 cm beside a pole: the global tolerance reads absence, the
    pole's own tolerance none (both packages alike); and a cell holding more
    rays than max_candidates is sampled evenly in both."""
    dsg = SceneGraph()
    dsg.agents = make_agents([0, 0, 1], [10.0])
    dsg.mesh = make_mesh([[6.0, 0.06, 1.0]], [0.0], [100.0])
    kw = {"ray_policy": "First", "num_bins": 32, "temporal_resolution": 4.0, "active_window_duration": 0.0}
    jcfg, tcfg = both(kw)
    jver, tver = jrv.RayVerificator(jcfg), trv.RayVerificator(tcfg, device="cpu")
    jver.build(dsg)
    tver.build(torch_scene_graph(dsg))
    pole = np.asarray([[5.0, 0.0, 1.0]], np.float32)
    for tol in (None, np.asarray([0.025], np.float32)):
        np.testing.assert_array_equal(tver.query(pole, radial_tol=tol), jver.query(pole, radial_tol=tol))
    assert tver.query(pole)[0, :, 1].sum() > 0 and tver.query(pole, radial_tol=np.float32([0.025])).sum() == 0

    dsg = SceneGraph()
    dsg.agents = make_agents([0, 0, 1], np.arange(0, 101, 1.0))
    dsg.mesh = make_mesh([[5, 0, 1]], [0.0], [100.0])
    jcfg, tcfg = both({"ray_policy": "All", "num_bins": 32, "temporal_resolution": 4.0, "max_candidates": 8})
    jver, tver = jrv.RayVerificator(jcfg), trv.RayVerificator(tcfg, device="cpu")
    jver.build(dsg)
    tver.build(torch_scene_graph(dsg))
    assert_index_equal(jver, tver)
    pts = np.asarray([[3.0, 0, 1], [1.0, 0, 1], [5.0, 0, 1]], np.float32)
    ev = tver.query(pts)
    np.testing.assert_array_equal(ev, jver.query(pts))
    assert np.nonzero(ev[0, :, 1])[0].max() >= 20  # late evidence survives the cap


def test_even_sampling_wraps_in_int32():
    """A cell whose candidate count times the sample offset passes 2^31: the
    reference's int32 product wraps, its floor division rounds toward -inf
    and a negative entry index counts from the end; the port does the same.
    (The CSR claims counts the entry array does not hold, which only the
    arithmetic reads.)"""
    C, K, B = 1 << 6, 256, 8
    rng = np.random.default_rng(0)
    E = 4096
    sorted_rays = rng.integers(0, 512, E).astype(np.int32)
    table = np.zeros((512, 8), np.float32)
    table[:, 0:3] = rng.uniform(-1, 1, (512, 3))
    table[:, 3:6] = rng.uniform(2, 4, (512, 3))
    table[:, 6] = rng.uniform(0, 30, 512)
    counts = np.where(np.arange(C) % 2, 1 << 24, 1 << 22).astype(np.int64)  # 255 * 2^24 > 2^31
    cell_start = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    cell_start = (cell_start % (1 << 31)).astype(np.int32)
    pts = rng.uniform(0, 3, (64, 3)).astype(np.float32)
    tol = np.full(64, 5.0, np.float32)  # every candidate overlaps
    j = np.asarray(jrv._query_device(jnp.asarray(pts), jnp.asarray(sorted_rays), jnp.asarray(cell_start),
                                     jnp.asarray(table), C, 0.5, jnp.asarray(tol), 0.15, 5.0, B, K))
    t = trv._query_device(torch.from_numpy(pts), torch.from_numpy(sorted_rays), torch.from_numpy(cell_start),
                          torch.from_numpy(table), C, 0.5, torch.from_numpy(tol), 0.15, 5.0, B, K).numpy()
    np.testing.assert_array_equal(t, j)
    assert j.sum() > 0


def test_hash_wraps_in_int32():
    """Cell coordinates whose products pass 2^31: the device hash of both
    packages and the host hash agree (int32 wraparound, never widened)."""
    rng = np.random.default_rng(1)
    cells = rng.integers(-(1 << 20), 1 << 20, (20000, 3)).astype(np.int32)
    cells[0] = (29, -112, 26)
    for C in (1 << 18, 1 << 4):
        j = np.asarray(jrv._hash_cells_dev(jnp.asarray(cells), C))
        t = trv._hash_cells_dev(torch.from_numpy(cells), C).numpy()
        np.testing.assert_array_equal(t, j)
        np.testing.assert_array_equal(trv._hash_cells_np(cells, C), j)


def test_self_collision_counted_twice():
    """A ray whose marched cells collide in one bucket (a 16-bucket table) is
    listed in that bucket twice, so a point there counts the ray twice: the
    reference's known double count, kept by the port."""
    dsg = SceneGraph()
    dsg.agents = make_agents([0.1, 0.1, 1.1], [10.0])
    dsg.mesh = make_mesh([[9.6, 0.1, 1.1]], [0.0], [100.0])
    kw = {"ray_policy": "First", "hash_cells": 16, "num_bins": 8, "temporal_resolution": 4.0,
          "active_window_duration": 0.0}
    jcfg, tcfg = both(kw)
    jver, tver = jrv.RayVerificator(jcfg), trv.RayVerificator(tcfg, device="cpu")
    jver.build(dsg)
    tver.build(torch_scene_graph(dsg))
    assert_index_equal(jver, tver)
    cells = index_arrays(tver, True)["sorted_cells"][: int(tver.cell_start[-1])]
    assert len(cells) > len(np.unique(cells))  # the one ray lists a bucket more than once
    pts = np.stack([np.arange(0.3, 9.5, 0.5), np.full(19, 0.1), np.full(19, 1.1)], 1).astype(np.float32)
    ev_j, ev_t = jver.query(pts), tver.query(pts)
    np.testing.assert_array_equal(ev_t, ev_j)
    assert ev_t[:, :, 1].sum(axis=1).max() >= 2  # one ray, counted twice


def test_delta_merge_and_touched_cells_match_reference():
    """The corridor explored segment by segment: delta indexes and the
    device merge in both packages, index for index; the merged index answers
    as a full build does; touched cells agree."""
    kw = {"ray_policy": "Middle", "num_bins": 32, "temporal_resolution": 4.0, "max_candidates": 1024,
          "max_ray_length": 12.0}
    jcfg, tcfg = both(kw)
    jver, tver = jrv.RayVerificator(jcfg), trv.RayVerificator(tcfg, device="cpu")
    pts = np.asarray([[3.0, 0, 1], [13.0, 1.5, 1], [33.0, -1.5, 1], [20.0, 0, 1]], np.float32)
    for seg in range(1, 5):
        dsg = corridor_scene(seg)
        jver.update(dsg, had_loop_closure=seg == 1)
        tver.update(torch_scene_graph(dsg), had_loop_closure=seg == 1)
        assert (tver.n_full_builds, tver.n_delta_updates, tver.n_merges) == (
            jver.n_full_builds, jver.n_delta_updates, jver.n_merges)
        assert_index_equal(jver, tver)
        assert (tver._delta is None) == (jver._delta is None)
        if tver._delta is not None:
            for k in ("sorted_cells", "sorted_rays", "cell_start"):
                np.testing.assert_array_equal(tver._delta[k].numpy(), np.asarray(jver._delta[k]))
    assert tver.n_full_builds == 1 and tver.n_merges >= 1
    np.testing.assert_array_equal(tver.touched_cells_for_new_targets(120), jver.touched_cells_for_new_targets(120))
    np.testing.assert_array_equal(tver.query(pts), jver.query(pts))
    full = trv.RayVerificator(tcfg, device="cpu")
    full.build(torch_scene_graph(corridor_scene(4)))
    np.testing.assert_array_equal(tver.query(pts), full.query(pts))
    assert tver.query(pts).sum() > 0


# ----------------------------------------------------------------------------
# the scan
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("relative", [True, False])
def test_scan_bins_match_reference(relative):
    rng = np.random.default_rng(4 + relative)
    P, B = 300, 32
    ev = (rng.random((P, B, 2)) < 0.3) * rng.integers(0, 5, (P, B, 2))
    tmin = rng.uniform(-10, 40, P)
    tmax = tmin + rng.uniform(0, 80, P)
    tmax[::7] = np.inf
    cfg = dict(window_size=3, min_rays_per_window=2, use_relative_confidence=relative, evidence_prior=1.5,
               absence_confidence=0.5 if relative else 2.0, presence_confidence=0.2 if relative else 1.0)
    jdetc = jcd.RayChangeDetector(jcd.RayChangeDetectorConfig(**cfg), bin_size_s=2.0)
    tdetc = tcd.RayChangeDetector(tcd.RayChangeDetectorConfig(**cfg), bin_size_s=2.0, device="cpu")
    j = jdetc.scan(ev, tmin, tmax, origin_s=3.0)
    t = tdetc.scan(ev, tmin, tmax, origin_s=3.0)
    # the chunk-list form (device chunks of a query) too
    chunks = [torch.from_numpy(np.concatenate([ev, np.zeros((212, B, 2), ev.dtype)])[k * 256:(k + 1) * 256]
                               .astype(np.int32)) for k in range(2)]
    tc = tdetc.scan(chunks, tmin, tmax, origin_s=3.0, n_valid=P)
    for k in j:
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)
        np.testing.assert_array_equal(tc[k], j[k], err_msg=k)
    assert (j["first_absent_bin"] >= 0).any() and (j["first_persistent_bin"] >= 0).any()


# ----------------------------------------------------------------------------
# the sequential detector
# ----------------------------------------------------------------------------


def _cd_configs(**kw):
    j, t = jdet.SequentialChangeDetectorConfig(), tdet.SequentialChangeDetectorConfig()
    for cfg in (j, t):
        cfg.verificator.ray_policy = "All"
        cfg.verificator.temporal_resolution = 2.0
        for key, value in kw.items():
            section, field = key.split("__")
            setattr(getattr(cfg, section) if section != "top" else cfg, field, value)
    return j, t


def assert_changes_equal(tch, jch):
    assert sorted(tch.object_changes) == sorted(jch.object_changes)
    for k, jo in jch.object_changes.items():
        assert dataclasses.astuple(tch.object_changes[k]) == dataclasses.astuple(jo), k
    assert tch.background_states.dtype == jch.background_states.dtype
    np.testing.assert_array_equal(tch.background_states, jch.background_states)


SEQUENTIAL_SCENES = {
    "disappearance": (disappearance_scene, {"verificator__num_bins": 64, "detector__window_size": 4}, None),
    "persistence": (persistence_scene, {}, None),
    "twins_unmerged": (twin_scene, {"detector__window_size": 3}, None),
    "twins_merged": (twin_scene, {"detector__window_size": 3}, [JMerge(from_id=2, into_id=1, iou=0.9)]),
    "twin_veto": (veto_scene, {"detector__window_size": 4}, None),
    "random": (random_scene, {"verificator__max_ray_length": 5.25}, None),
}


@pytest.mark.parametrize("scene", list(SEQUENTIAL_SCENES))
def test_sequential_changes_match_reference(scene):
    make, kw, merges = SEQUENTIAL_SCENES[scene]
    jcfg, tcfg = _cd_configs(**kw)
    dsg = make()
    jch = jdet.SequentialChangeDetector(jcfg).detect_changes(dsg, merges=merges)
    tch = tdet.SequentialChangeDetector(tcfg, device="cpu").detect_changes(
        torch_scene_graph(dsg), merges=None if merges is None else [torch_merge(m) for m in merges])
    assert_changes_equal(tch, jch)
    if scene == "disappearance":
        assert tch.object_changes[1].last_absent_ns > 0
    if scene == "twins_merged":
        assert tch.object_changes[1].first_absent_ns < 0 and tch.object_changes[2].merged_id == 1
    if scene == "twin_veto":  # the fragment vetoes object 1; object 4 disappears for real
        assert tch.object_changes[1].last_absent_ns < 0 and tch.object_changes[4].last_absent_ns > 0


def _incremental_dsg(n_extra, behind=True):
    dsg = SceneGraph()
    dsg.agents = make_agents([0, 0, 1], np.arange(0, 101, 2.0))
    verts = [[4.0, 0, 1], [4.0, 0.1, 1], [5.0, 0, 1], [0.0, 3.0, 1]]
    first, last = [0.0, 0.0, 45.0, 0.0], [40.0, 40.0, 100.0, 100.0]
    for k in range(n_extra):
        verts.append([6.0, 0.1 * k, 1.0] if behind else [5.0, 0.2 + 0.1 * k, 1.0])
        first.append(50.0)
        last.append(100.0)
    dsg.mesh = make_mesh(verts, first, last)
    dsg.opt_epoch = 0
    dsg.objects[1] = make_object(1, [4.0, 0.05, 1], 0.0, 40.0, mesh_pts=[[4.0, 0, 1], [4.0, 0.1, 1]])
    dsg.objects[2] = make_object(2, [-2.0, -2.0, 1], 0.0, 100.0, mesh_pts=[[-2.0, -2.0, 1]])
    return dsg


def test_incremental_passes_match_reference_and_full():
    """Two passes with appended vertices (same epoch, no loop closure): the
    incremental pass queries what the reference's does (touched object only,
    the same background subset), and ends where a full pass ends; then an
    epoch change forces the full pass in both."""
    jcfg, tcfg = _cd_configs()
    jd, td = jdet.SequentialChangeDetector(jcfg), tdet.SequentialChangeDetector(tcfg, device="cpu")
    calls = {"j": [], "t": []}
    for name, d in (("j", jd), ("t", td)):
        orig = d.verificator.query
        d.verificator.query = (lambda pts, _o=orig, _c=calls[name], **kw: (_c.append(len(pts)), _o(pts, **kw))[1])
    for n_extra in (0, 3):
        dsg = _incremental_dsg(n_extra)
        assert_changes_equal(td.detect_changes(torch_scene_graph(dsg), had_loop_closure=False),
                             jd.detect_changes(dsg, had_loop_closure=False))
    assert calls["t"] == calls["j"] and calls["t"][2] == 2  # the second object pass re-queries object 1 only
    full = tdet.SequentialChangeDetector(tcfg, device="cpu")
    assert_changes_equal(full.detect_changes(torch_scene_graph(_incremental_dsg(3)), had_loop_closure=False), td.changes)
    moved = _incremental_dsg(3)
    moved.mesh.vertices = moved.mesh.vertices + np.float32([0.5, 0, 0])
    moved.opt_epoch = 1
    assert_changes_equal(td.detect_changes(torch_scene_graph(moved), had_loop_closure=False),
                         jd.detect_changes(moved, had_loop_closure=False))
    assert td.verificator.n_full_builds == jd.verificator.n_full_builds == 2


def test_votes_match_reference():
    rng = np.random.default_rng(5)
    ev = rng.integers(0, 3, (256, 16, 2)).astype(np.int32)
    seg = rng.integers(0, 65, 256).astype(np.int32)
    j = np.asarray(jdet._votes_device(jnp.asarray(ev), jnp.asarray(seg), 65))
    t = tdet._votes_device(torch.from_numpy(ev), torch.from_numpy(seg), 65).numpy()
    np.testing.assert_array_equal(t, j)


# ----------------------------------------------------------------------------
# the reconciler, nearest distances, CSV and .4dmap.npz across packages
# ----------------------------------------------------------------------------


def test_min_distances_match_reference():
    rng = np.random.default_rng(6)
    a = rng.uniform(-3, 3, (5000, 3)).astype(np.float32)
    b = rng.uniform(-3, 3, (3000, 3)).astype(np.float32)
    np.testing.assert_array_equal(tmin_distances(a, b, device="cpu"), jmin_distances(a, b))
    assert tmin_distances(a[:0], b, device="cpu").shape == (0,)
    assert np.isinf(tmin_distances(a[:2], b[:0], device="cpu")).all()


def _reconcile_scene():
    dsg = disappearance_scene()
    rng = np.random.default_rng(7)
    extra = rng.uniform([3.5, -0.5, 0.5], [4.5, 0.5, 1.5], (400, 3)).astype(np.float32)
    verts = np.concatenate([dsg.mesh.vertices, extra])
    V = len(verts)
    dsg.mesh = make_mesh(verts, rng.uniform(0, 50, V), rng.uniform(50, 100, V))
    dsg.mesh.faces = rng.integers(0, V, (600, 3)).astype(np.int64)
    dsg.objects[1] = make_object(1, [4.0, 0.05, 1], 0.0, 40.0, mesh_pts=extra[:120])
    dsg.objects[2] = make_object(2, [4.05, 0.0, 1], 50.0, 60.0, mesh_pts=extra[100:200])
    dsg.objects[3] = make_object(3, [0.0, 3.0, 1], 20.0, 30.0)
    return dsg


@pytest.mark.parametrize("merger", ["ChangeMerger", "OverwriteMesh"])
def test_reconciled_dsg_matches_reference(merger):
    dsg = _reconcile_scene()
    jch = JChanges()
    jch.object_changes[1] = JObjectChange(1, first_absent_ns=int(5e9), last_absent_ns=int(80e9), last_persistent_ns=int(50e9))
    jch.object_changes[3] = JObjectChange(3, first_persistent_ns=int(10e9))
    jch.background_states = np.random.default_rng(8).integers(0, 3, dsg.mesh.num_vertices).astype(np.int8)
    tch = TChanges()
    tch.object_changes = {k: TObjectChange(**dataclasses.asdict(v)) for k, v in jch.object_changes.items()}
    tch.background_states = jch.background_states.copy()
    merges = [JMerge(from_id=2, into_id=1, iou=0.8)]
    cfg = {"mesh_merger": merger, "merge_object_meshes": merger == "OverwriteMesh"}
    tdsg = torch_scene_graph(dsg)
    jout = JReconciler(JReconcilerConfig(**cfg)).reconcile(dsg, jch, merges)
    tout = TReconciler(TReconcilerConfig(**cfg), device="cpu").reconcile(tdsg, tch, [torch_merge(m) for m in merges])
    ja, ta = jser.scene_graph_arrays(jout), tser.scene_graph_arrays(tout)
    assert ja.keys() == ta.keys()
    for k in ja:
        assert ja[k].dtype == ta[k].dtype, k
        np.testing.assert_array_equal(ta[k], ja[k], err_msg=k)
    assert_changes_equal(tch, jch)
    assert 2 not in tout.objects and tout.mesh.num_vertices < 405


def test_changes_csv_cross_read(tmp_path):
    jch = JChanges()
    jch.object_changes[3] = JObjectChange(3, first_absent_ns=5, last_absent_ns=9, merged_id=7)
    jch.object_changes[11] = JObjectChange(11, first_persistent_ns=int(3e18), last_persistent_ns=-1)
    jch.background_states = np.asarray([0, 1, 2, 2, 0], np.int8)
    tch = TChanges()
    tch.object_changes = {k: TObjectChange(**dataclasses.asdict(v)) for k, v in jch.object_changes.items()}
    tch.background_states = jch.background_states.copy()
    jch.save(str(tmp_path / "j"))
    tch.save(str(tmp_path / "t"))
    for name in ("object_changes.csv", "background_changes.csv"):
        assert filecmp.cmp(tmp_path / "j" / name, tmp_path / "t" / name, shallow=False), name
    assert_changes_equal(TChanges.load(str(tmp_path / "j")), JChanges.load(str(tmp_path / "t")))


def _map_inputs():
    """tests/test_changes.py's union-store sequence: growth, a removal
    against the canonical mesh, a reappearance, a value mutation, plus a
    moved mesh (a fresh union) and objects."""
    def make(n, drop_first=False, shift=0.0):
        dsg = SceneGraph()
        verts = [[i * 0.1 + shift, 0, 0] for i in range(n)]
        first, last = [float(i) for i in range(n)], [100.0] * n
        if drop_first:
            verts, first, last = verts[1:], first[1:], last[1:]
        dsg.mesh = make_mesh(verts, first, last)
        dsg.mesh.faces = np.asarray([[i, i + 1, i + 2] for i in range(len(verts) - 2)], np.int64).reshape(-1, 3)
        dsg.agents = make_agents([0, 0, 0], np.arange(0, n, 1.0))
        if n >= 14:
            dsg.objects[1] = make_object(1, [1, 1, 0], 12.0, 18.0, mesh_pts=[[1, 1, 0], [1.1, 1, 0]])
        return dsg

    mutated = make(18)
    mutated.mesh.last_seen_ns = np.full(18, int(200e9), np.int64)
    mutated.mesh.colors = mutated.mesh.colors + 0.25
    return [
        (make(10), 10, None), (make(14), 20, None), (make(18, drop_first=True), 40, make(18).mesh),
        (make(18), 50, None), (mutated, 60, None), (make(18, shift=0.3), 70, None),
    ]


def test_4dmap_matches_reference_and_cross_reads(tmp_path):
    jmap, tmap = JMap(), TMap()
    for dsg, t, canon in _map_inputs():
        jmap.update(dsg, int(t * 1e9), canonical_mesh=canon)
        tmap.update(torch_scene_graph(dsg), int(t * 1e9),
                    canonical_mesh=None if canon is None else torch_scene_graph(SceneGraph(mesh=canon)).mesh)
    assert len(tmap._unions) == len(jmap._unions) == 2
    for js, ts in zip(jmap._stores, tmap._stores):
        np.testing.assert_array_equal(ts["keep"], js["keep"])
    jmap.save(str(tmp_path / "j.4dmap.npz"))
    tmap.save(str(tmp_path / "t.4dmap.npz"))
    with np.load(tmp_path / "j.4dmap.npz") as j, np.load(tmp_path / "t.4dmap.npz") as t:
        assert sorted(j.files) == sorted(t.files)
        for k in j.files:
            assert j[k].dtype == t[k].dtype, k
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    t_from_j = TMap.load(str(tmp_path / "j.4dmap.npz"))
    j_from_t = JMap.load(str(tmp_path / "t.4dmap.npz"))
    for i in range(jmap.num_snapshots):
        want = jser.scene_graph_arrays(jmap.snapshots[i])
        for got in (tser.scene_graph_arrays(t_from_j.snapshots[i]), jser.scene_graph_arrays(j_from_t.snapshots[i]),
                    tser.scene_graph_arrays(tmap.snapshots[i])):
            assert got.keys() == want.keys()
            for k in want:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for robot_t, query_t in ((15e9, None), (45e9, 5e9), (65e9, 30e9)):
        jd, td = jmap.get_dsg(int(robot_t), None if query_t is None else int(query_t)), \
            t_from_j.get_dsg(int(robot_t), None if query_t is None else int(query_t))
        ja, ta = jser.scene_graph_arrays(jd), tser.scene_graph_arrays(td)
        for k in ja:
            np.testing.assert_array_equal(ta[k], ja[k], err_msg=k)
    assert sorted(t_from_j.objects_present_at(int(65e9), int(15e9))) == sorted(jmap.objects_present_at(int(65e9), int(15e9)))
