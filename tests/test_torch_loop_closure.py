"""Port parity: backend/loop_closure.py's detectors without the oracle.

Each detector of both packages is fed the same keyframe stream and must
return the same loop closures: the same (from_key, to_key) pairs, with R and
t within 1e-4 and the score within 1e-5 (the descriptor's) or 2e-3 (the
appearance descriptor's: its gradient-orientation histogram bins each pixel
of a 24x32 thumbnail, and the thumbnail's float32 sums, in another order
than the reference's einsum, move a pixel or two across an orientation bin
edge; the descriptors themselves agree to 1e-6). The LCD stream is rendered
by the JAX package: office keyframes over two orbits with drifted odometry,
so each later keyframe revisits the view of one orbit earlier, and a
far-away keyframe that must match nothing; each keyframe's payload is built
as the pipeline's `_prepare_lcd_frame` builds it (back-projection at stride
4, valid ranges, strided colour). Also the cases of tests/test_backend.py's
LCD classes and tests/test_registration.py's GNC slot, through both
packages, and the backend built from a config for each `lcd.type`."""

import dataclasses
import functools

import numpy as np
import pytest

from khronos_tpu.backend import loop_closure as jlc
from khronos_tpu.backend.backend import Backend as JBackend
from khronos_tpu.backend.backend import BackendConfig as JBackendConfig
from khronos_tpu.config import build as jbuild
from khronos_tpu.config import to_dict as jto_dict
from khronos_tpu.data import synthetic as jsyn
from khronos_tpu.stm.scene_graph import KhronosObject as JObject
from khronos_tpu_torch.backend import loop_closure as tlc
from khronos_tpu_torch.backend.backend import Backend as TBackend
from khronos_tpu_torch.backend.backend import BackendConfig as TBackendConfig
from khronos_tpu_torch.config import build as tbuild
from khronos_tpu_torch.config import to_dict as tto_dict

from torch_parity import torch_object

POSE_ATOL = 1e-4
KINDS = ("DescriptorLoopClosure", "AppearanceLoopClosure", "SceneGraphLoopClosure", "HybridLoopClosure")


@functools.lru_cache(maxsize=None)
def lcd_stream():
    """[(key, stamp_ns, points_c, valid, color_small, R_odom, t_odom)]: 16
    office keyframes, one a second over two orbits (drift 0.05), then one
    far away (the first view shifted 4 m along the optical axis)."""
    dur, H, W = 16.0, 120, 160
    seq = jsyn.SyntheticSequence(jsyn.office_scene(dur), jsyn.SyntheticSequenceConfig(
        duration=dur, fps=1.0, height=H, width=W, fx=W * 0.625, fy=W * 0.625, cx=W / 2, cy=H / 2,
        drift_rate=0.05))
    cam = seq.camera
    out = []
    for i in range(seq.n_frames):
        f = seq.render_frame(i)
        depth = np.asarray(f["depth"])[::4, ::4]
        pts = np.asarray(cam.back_project(f["depth"]))[::4, ::4].astype(np.float32)
        valid = (depth > 0.1) & (depth < cam.max_range)
        color = np.asarray(f["color"])[::4, ::4].astype(np.float32)
        R, t = seq.odometry_pose(i)
        out.append((i, f["stamp_ns"], pts, valid, color, np.asarray(R, np.float32), np.asarray(t, np.float32)))
    k, s, pts, valid, color, R, t = out[0]
    out.append((len(out), s + int(20e9), pts + np.float32([0, 0, 4.0]), valid, color[::-1].copy(), R,
                t + R @ np.float32([0, 0, 4.0])))
    return out


def _closures(lcs):
    return [(lc.from_key, lc.to_key, np.asarray(lc.R), np.asarray(lc.t), lc.score, lc.sigma_trans, lc.sigma_rot)
            for lc in lcs]


def assert_same_closures(want, got, score_atol=1e-5):
    assert [(a, b) for a, b, *_ in got] == [(a, b) for a, b, *_ in want], (want, got)
    for (_, _, jR, jt, js, jst, jsr), (_, _, R, t, s, st, sr) in zip(want, got):
        np.testing.assert_allclose(R, jR, rtol=0, atol=POSE_ATOL)
        np.testing.assert_allclose(t, jt, rtol=0, atol=POSE_ATOL)
        assert abs(s - js) <= score_atol, (s, js)
        assert (st is None) == (jst is None) and (st is None or abs(st - jst) <= POSE_ATOL)
        assert sr == jsr


def _feed(det, stream, appearance):
    out = []
    for k, s, pts, valid, color, R, t in stream:
        args = (k, s, pts, valid, color, R, t) if appearance else (k, s, pts, valid, R, t)
        out += _closures(det.add_keyframe(*args))
    return out


@pytest.mark.parametrize("registration", ["gnc", "icp"])
def test_descriptor_detector_on_lcd_stream(registration):
    kw = dict(min_time_gap=6.0, min_descriptor_similarity=0.9, registration=registration)
    want = _feed(jlc.DescriptorLoopClosureConfig(**kw).create(), lcd_stream(), False)
    got = _feed(tlc.DescriptorLoopClosureConfig(**kw).create(device="cpu"), lcd_stream(), False)
    assert len(want) >= 2, want  # revisits one orbit later
    assert all(a - b == 8 for a, b, *_ in want)
    assert_same_closures(want, got)


def test_place_descriptor_matches_reference():
    import jax.numpy as jnp
    import torch

    for k, s, pts, valid, *_ in lcd_stream()[::3]:
        want = np.asarray(jlc._place_descriptor(jnp.asarray(pts), jnp.asarray(valid)))
        got = tlc._place_descriptor(torch.from_numpy(pts), torch.from_numpy(valid)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_appearance_detector_on_lcd_stream():
    kw = dict(min_time_gap=6.0)
    want = _feed(jlc.AppearanceLoopClosureConfig(**kw).create(), lcd_stream(), True)
    got = _feed(tlc.AppearanceLoopClosureConfig(**kw).create(device="cpu"), lcd_stream(), True)
    assert len(want) >= 2, want
    assert_same_closures(want, got, score_atol=2e-3)


def test_appearance_descriptor_matches_reference():
    """The thumbnail resize (jax.image.resize's antialiased triangle kernel)
    within 5e-7 (a few ulp of colours in [0, 1]: its float32 sums run in
    another order than the reference's einsum); the descriptor's thumbnail
    half within 1e-6; its gradient-orientation half bins each pixel by angle,
    so a pixel at a bin edge may land in the neighbouring bin: every entry
    within 0.05 and the two descriptors' cosine above 0.995 (the detector's
    threshold is 0.85). Then with open-set features, within 1e-6."""
    import jax
    import jax.numpy as jnp

    for *_, color, _, _ in lcd_stream()[::4]:
        for hw in ((24, 32), (12, 16)):
            want = np.asarray(jax.image.resize(jnp.asarray(color), hw + (3,), method="linear"))
            np.testing.assert_allclose(tlc._resize_linear(color, hw), want, rtol=0, atol=5e-7)
        got, want = tlc._appearance_descriptor(color), jlc._appearance_descriptor(color)
        thumb = 12 * 16 * 3
        np.testing.assert_allclose(got[:thumb], want[:thumb], rtol=0, atol=1e-6)
        np.testing.assert_allclose(got, want, rtol=0, atol=0.05)
        assert float(got @ want) > 0.995
    feats = np.random.default_rng(0).normal(size=(5, 32)).astype(np.float32)
    np.testing.assert_allclose(tlc._appearance_descriptor(None, feats), jlc._appearance_descriptor(None, feats),
                               rtol=0, atol=1e-6)


def test_hybrid_detector_on_lcd_stream():
    """No object layer: the hybrid stack falls back to its appearance stream;
    with a places feed the gate describes keyframes and passes the revisits."""
    rng = np.random.default_rng(1)
    places = ((rng.random((12, 3)).astype(np.float32) - 0.5) * 6.0, np.full(12, 0.8, np.float32))

    def feed(det):
        det.appearance.config = dataclasses.replace(det.appearance.config, min_time_gap=6.0)
        out = []
        for k, s, pts, valid, color, R, t in lcd_stream():
            out += _closures(det.add_keyframe(k, s, pts, valid, color, R, t, (), places=places))
        return out, det

    want, jdet = feed(jlc.HybridLoopClosureConfig().create())
    got, tdet = feed(tlc.HybridLoopClosureConfig().create(device="cpu"))
    assert len(want) >= 2
    assert_same_closures(want, got, score_atol=2e-3)
    assert (tdet.appearance_fires, tdet.constellation_fires) == (jdet.appearance_fires, jdet.constellation_fires)
    assert [e[:2] + e[3:] for e in tdet.place_gate_events] == [e[:2] + e[3:] for e in jdet.place_gate_events]


# ---- tests/test_backend.py's and tests/test_registration.py's LCD cases, through both packages ----


def test_descriptor_revisit_case_matches_reference():
    """TestDescriptorLCD.test_detects_revisit: the apartment at 96x128,
    keyframes at GT poses, back-projected at full resolution."""
    seq = jsyn.SyntheticSequence(jsyn.apartment_scene(), jsyn.SyntheticSequenceConfig(
        duration=16.0, fps=2.5, height=96, width=128, fx=80., fy=80., cx=64., cy=48.))
    cam = seq.camera
    kw = dict(min_time_gap=6.0, min_descriptor_similarity=0.97)
    jdet, tdet = jlc.DescriptorLoopClosureConfig(**kw).create(), tlc.DescriptorLoopClosureConfig(**kw).create("cpu")
    want, got = [], []
    for i in range(seq.n_frames):
        f = seq.render_frame(i)
        pts_c = np.asarray(cam.back_project(f["depth"]))
        valid = np.asarray(f["depth"]) > 0
        want += _closures(jdet.add_keyframe(i, f["stamp_ns"], pts_c, valid, f["R_gt"], f["t_gt"]))
        got += _closures(tdet.add_keyframe(i, f["stamp_ns"], pts_c, valid, f["R_gt"], f["t_gt"]))
    assert len(got) >= 1 and all(np.linalg.norm(t) < 1.0 for _, _, _, t, *_ in got)
    assert_same_closures(want, got)


def test_gnc_slot_fires_case_matches_reference():
    """TestRobustIcp.test_lcd_gnc_slot_fires: a corner seen, a far view, the
    corner again with small odometry drift."""
    H, W = 32, 48
    u = np.linspace(-1, 1, W)[None, :].repeat(H, 0)
    v = np.linspace(-1, 1, H)[:, None].repeat(W, 1)
    depth = 2.0 + 0.8 * np.abs(u) + 0.3 * v
    pts = np.stack([u * depth, v * depth, depth], -1).astype(np.float32)
    valid = np.ones((H, W), bool)
    R_a, t_a = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    far = np.float32([0, 0, 4.0])
    calls = [(0, 0, pts, valid, R_a, t_a), (1, int(2e9), pts + far, valid, R_a, t_a + far),
             (2, int(4e9), pts, valid, R_a, t_a + np.float32([0.05, 0.0, 0.02]))]
    kw = dict(min_time_gap=1.0, min_detection_separation=0.5, registration="gnc")
    jdet, tdet = jlc.DescriptorLoopClosureConfig(**kw).create(), tlc.DescriptorLoopClosureConfig(**kw).create("cpu")
    want = [c for a in calls for c in _closures(jdet.add_keyframe(*a))]
    got = [c for a in calls for c in _closures(tdet.add_keyframe(*a))]
    assert [(a, b) for a, b, *_ in got] == [(2, 0)]
    assert_same_closures(want, got)


def _objects(cls, positions, labels, detected_s, start_id=1):
    out = []
    for i, (p, lab) in enumerate(zip(positions, labels)):
        p = np.asarray(p, np.float32)
        ns = int(detected_s * 1e9)
        out.append(cls(node_id=start_id + i, semantic_category=int(lab), bbox_min=p - 0.2, bbox_max=p + 0.2,
                       first_observed_ns=[ns], last_observed_ns=[ns + int(1e9)],
                       mesh_vertices=np.zeros((0, 3), np.float32), mesh_faces=np.zeros((0, 3), np.int32),
                       mesh_colors=np.zeros((0, 3), np.float32)))
    return out


def _scene_graph_calls(case):
    """TestSceneGraphLCD's keyframe calls: [(key, stamp_ns, R, t, JAX objects)]."""
    I, z = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    P = [[2.0, 1.0, 0.5], [3.5, -1.0, 0.4], [5.0, 0.5, 0.6], [2.5, -2.0, 0.5]]
    if case == "drift":
        L = [2, 3, 4, 5]
        old = _objects(JObject, P, L, 1.0)
        ang = 0.12
        Rd = np.array([[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0], [0, 0, 1]], np.float32)
        td = np.array([0.6, -0.4, 0.05], np.float32)
        dup = _objects(JObject, [(Rd @ np.asarray(p) + td) for p in P], L, 20.0, 100)
        return [(10, int(1e9), I, z, old), (50, int(21e9), Rd, td, old + dup)]
    if case == "lag":
        old = _objects(JObject, P[:3], [2, 3, 4], 1.0)
        dup = _objects(JObject, P[:3], [2, 3, 4], 22.0, 100)
        return [(10, int(1e9), I, z, old), (50, int(21e9), I, z, old), (60, int(23e9), I, z, old + dup)]
    a = _objects(JObject, [[2, 1, 0.5], [3.5, -1, 0.4], [5, 0.5, 0.6]], [2, 3, 4], 1.0)
    b = _objects(JObject, [[1, 0, 0.5], [1.5, 2.5, 0.4], [4, 3, 0.6]], [5, 6, 6], 20.0, 100)
    return [(10, int(1e9), I, z, a), (50, int(21e9), I, z, a + b)]


@pytest.mark.parametrize("case,fires", [("drift", 1), ("lag", 1), ("different", 0)])
def test_scene_graph_cases_match_reference(case, fires):
    """TestSceneGraphLCD: a revisit under drift recovers the true relative
    pose, a keyframe whose objects arrive late fires on a later call, and
    different constellations do not match."""
    jdet, tdet = jlc.SceneGraphLoopClosureConfig().create(), tlc.SceneGraphLoopClosureConfig().create("cpu")
    want, got = [], []
    for key, stamp, R, t, objs in _scene_graph_calls(case):
        want += _closures(jdet.add_keyframe(key, stamp, R, t, objs))
        got += _closures(tdet.add_keyframe(key, stamp, R, t, [torch_object(o) for o in objs]))
    assert len(got) == fires
    assert_same_closures(want, got)
    if case == "drift":
        np.testing.assert_allclose(got[0][2], np.eye(3), atol=1e-3)
        np.testing.assert_allclose(got[0][3], np.zeros(3), atol=5e-3)


def _gate_hist(module, clearances, center=np.zeros(3, np.float32)):
    rng = np.random.default_rng(3)
    pos = (rng.random((len(clearances), 3)).astype(np.float32) - 0.5) * 6.0
    return module._place_layer_descriptor(pos + center, np.asarray(clearances, np.float32), center,
                                          module.PlacesGateConfig())


CORRIDOR = [0.6, 0.65, 0.7, 0.6, 0.55, 0.62, 0.68, 0.6]
OPEN_ROOM = [2.2, 2.3, 2.1, 2.4, 2.2, 2.25, 2.3, 2.15]


def test_places_gate_descriptors_match_reference():
    """TestPlacesGate's descriptor cases: the clearance histograms and their
    L1 scores, abstentions included (too few places, all out of range)."""
    for c in (CORRIDOR, OPEN_ROOM, [0.6, 0.66, 0.71, 0.59, 0.56, 0.61, 0.69, 0.63], [0.6, 0.7],
              [5.0, 6.0, 7.0, 8.0, 9.0]):
        j, t = _gate_hist(jlc, c), _gate_hist(tlc, c)
        assert (j is None) == (t is None)
        if j is not None:
            np.testing.assert_array_equal(t, j)
    a, b = _gate_hist(tlc, CORRIDOR), _gate_hist(tlc, OPEN_ROOM)
    assert tlc._place_descriptor_score(a, b) == jlc._place_descriptor_score(_gate_hist(jlc, CORRIDOR),
                                                                            _gate_hist(jlc, OPEN_ROOM)) < 0.1
    assert tlc._place_descriptor_score(a, None) == 1.0


@pytest.mark.parametrize("context,fires", [("distinct", 0), ("consistent", 1)])
def test_places_gate_veto_matches_reference(context, fires):
    """TestPlacesGate.test_gate_vetoes_appearance_candidate: identical frames
    at places-distinct keyframes are vetoed; with matching context they fire."""
    rng = np.random.default_rng(0)
    pts = rng.random((24, 32, 3)).astype(np.float32) * 3.0
    valid = np.ones((24, 32), bool)
    color = rng.random((12, 16, 3)).astype(np.float32)
    I, z = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    results = []
    for mod, make in ((jlc, lambda c: c.create()), (tlc, lambda c: c.create(device="cpu"))):
        det = make(mod.HybridLoopClosureConfig())
        det.appearance.config = dataclasses.replace(det.appearance.config, min_time_gap=5.0,
                                                    min_detection_separation=1.0)
        assert det.add_keyframe(10, int(1e9), pts, valid, color, I, z) == []
        other = OPEN_ROOM if context == "distinct" else CORRIDOR
        det._place_descs = {10: _gate_hist(mod, CORRIDOR), 50: _gate_hist(mod, other)}
        results.append((_closures(det.add_keyframe(50, int(20e9), pts, valid, color, I, z)),
                        det.place_gate_rejections))
    (want, jrej), (got, trej) = results
    assert len(got) == fires and trej == jrej
    assert_same_closures(want, got)


def test_places_gate_feed_and_epochs_match_reference():
    """TestPlacesGate's feed cases: a thin layer leaves a keyframe
    undescribed until the layer grows, a keyframe without a snapshot is
    described later, and a geometry epoch change invalidates descriptors."""
    rng = np.random.default_rng(1)
    pts = rng.random((24, 32, 3)).astype(np.float32) * 3.0
    valid = np.ones((24, 32), bool)
    color = rng.random((12, 16, 3)).astype(np.float32)
    I, z = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    thin = (np.zeros((2, 3), np.float32), np.asarray([0.6, 0.7], np.float32))
    grown = ((rng.random((10, 3)).astype(np.float32) - 0.5) * 6.0, np.full(10, 0.8, np.float32))
    states = []
    for mod, make in ((jlc, lambda c: c.create()), (tlc, lambda c: c.create(device="cpu"))):
        det = make(mod.HybridLoopClosureConfig())
        det.add_keyframe(10, int(1e9), pts, valid, color, I, z, places=thin)
        first = det._place_descs[10]
        det.add_keyframe(11, int(3e9), pts, valid, color, I, z, places=grown)
        det.add_keyframe(12, int(4e9), pts, valid, color, I, z)
        det.add_keyframe(13, int(5e9), pts, valid, color, I, z, places=grown)
        described = {k: v for k, v in det._place_descs.items()}
        det.on_geometry_epoch(0)
        det.on_geometry_epoch(0)
        kept = dict(det._place_descs)
        det.on_geometry_epoch(1)
        states.append((first, described, kept, dict(det._place_descs), [p[0] for p in det._place_pending]))
    (j0, jd, jk, je, jp), (t0, td, tk, te, tp) = states
    assert j0 is None and t0 is None
    for jmap, tmap in ((jd, td), (jk, tk), (je, te)):
        assert jmap.keys() == tmap.keys()
        for k in jmap:
            assert (jmap[k] is None) == (tmap[k] is None)
            if jmap[k] is not None:
                np.testing.assert_array_equal(tmap[k], jmap[k])
    assert tp == jp and td[10] is not None


@pytest.mark.parametrize("kind", KINDS)
def test_backend_builds_each_detector_from_config(kind):
    """One config builds both packages' backends with the detector of each
    `lcd.type` (the config trees equal), with the reference's routing flags."""
    j = JBackend(jbuild(JBackendConfig, {"lcd": {"type": kind}}))
    cfg = tbuild(TBackendConfig, {"lcd": {"type": kind}})
    t = TBackend(cfg, device="cpu")
    assert jto_dict(j.config) == tto_dict(cfg)
    assert type(t.lcd).__name__ == type(j.lcd).__name__
    for flag in ("needs_frame", "needs_color", "needs_scene", "needs_places"):
        assert getattr(t.lcd, flag, False) == getattr(j.lcd, flag, False), flag
    if hasattr(t.lcd, "device"):
        assert t.lcd.device.type == "cpu"
