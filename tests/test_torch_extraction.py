"""Port parity for active_window/object_extraction.py and the mesh
accumulators (stm/scene_graph.MeshAccumulator, khronos_tpu_torch/native.py).

Frames are the JAX renderer's small office frames (tests/torch_parity.py);
the shelf's semantic label stands in for its cluster id, so the object image
is the label image. Tolerances:
- `_reconstruct_device`: weights and confidences (the fg / bg counts over
  the same frames) equal on at least 99.5% of voxels (measured: all of
  them), TSDF within 1e-5 where they are. The projections round differently
  (the reference's einsum against the port's elementwise sums, a few ulp),
  which can move a voxel across a pixel edge or the truncation band.
- `_mesh_small_grid` on one TSDF input: the same triangle count, rows and the
  bbox row within 1e-6.
- `MeshObjectExtractor.extract`: the same triangle count and bbox within
  1e-5, vertices within 1e-5; dynamic tracks exactly.
- The accumulators are bit for bit the JAX package's, Python and native."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from khronos_tpu import native as jnative
from khronos_tpu.active_window import object_extraction as joe
from khronos_tpu.active_window.frame_data import FrameData as JFrame
from khronos_tpu.active_window.frame_data import FrameDataBuffer as JBuffer
from khronos_tpu.active_window.frame_data import FrameDataBufferConfig as JBufferConfig
from khronos_tpu.active_window.tracking import Observation as JObservation
from khronos_tpu.active_window.tracking import Track as JTrack
from khronos_tpu.stm.scene_graph import MeshAccumulator as JAccumulator
from khronos_tpu_torch import native as tnative
from khronos_tpu_torch.active_window import object_extraction as toe
from khronos_tpu_torch.active_window.frame_data import FrameData as TFrame
from khronos_tpu_torch.active_window.frame_data import FrameDataBuffer as TBuffer
from khronos_tpu_torch.active_window.frame_data import FrameDataBufferConfig as TBufferConfig
from khronos_tpu_torch.stm.scene_graph import MeshAccumulator as TAccumulator

from torch_parity import frames, torch_camera, torch_track

SHELF = 6
G, K = 16, 4
CONFIG = dict(grid_size=G, max_frames=K, min_num_observations=2)
FRAME_IDS = [0, 1, 2, 15, 16, 17]  # two visits of the shelf


def _shelf_points(cam, f):
    rays = torch_camera(cam).pixel_rays_np()
    m = (f["labels"] == SHELF) & (f["depth"] > 0)
    return (rays * f["depth"][..., None])[m] @ f["R_w_c"].T + f["t_w_c"]


def _grid_inputs(cam, fr, ids):
    pts = np.concatenate([_shelf_points(cam, fr[i]) for i in ids])
    bmin, bmax = pts.min(0), pts.max(0)
    voxel = max(0.02 * float((bmax - bmin).max()), 0.005)
    margin = 2.5 * voxel
    voxel = max(voxel, float(((bmax - bmin) + 2 * margin).max() / G) * 1.001)
    return np.asarray(bmin - margin, np.float32), np.float32(voxel), np.float32(2 * voxel)


def _reconstruct_both(ids):
    cam, fr = frames(24)
    sel = [fr[i] for i in ids]
    origin, voxel, trunc = _grid_inputs(cam, fr, ids)
    stack = lambda key, dt: np.stack([f[key] for f in sel]).astype(dt)  # noqa: E731
    depths, objs = stack("depth", np.float32), stack("labels", np.int32)
    Rs, ts = stack("R_w_c", np.float32), stack("t_w_c", np.float32)
    n = len(sel)
    j = joe._reconstruct_device(
        jnp.asarray(depths), jnp.asarray(objs), jnp.full((n,), SHELF, jnp.int32), jnp.ones((n,), bool),
        jnp.asarray(Rs), jnp.asarray(ts), cam.fx, cam.fy, cam.cx, cam.cy, cam.width, cam.height,
        jnp.asarray(origin), voxel, trunc, jnp.float32(0.5), G,
    )
    t = toe._reconstruct_device(
        [(torch.from_numpy(depths[k]), torch.from_numpy(objs[k]), SHELF, Rs[k], ts[k]) for k in range(n)],
        torch_camera(cam), origin, voxel, trunc, 0.5, G, "cpu",
    )
    return [np.asarray(x) for x in j], [x.numpy() for x in t], origin, voxel


@pytest.mark.parametrize("ids", [FRAME_IDS[:K], FRAME_IDS[2:]], ids=["one-visit", "two-visits"])
def test_reconstruct_matches_reference(ids):
    (jt, jw, jc), (tt, tw, tc), _, _ = _reconstruct_both(ids)
    same = (jw == tw) & (jc == tc)
    assert same.mean() >= 0.995, same.mean()
    assert (jw > 0).mean() > 0.05 and (jc > 0.5).any()  # the grid saw the shelf
    np.testing.assert_allclose(jt[same], tt[same], rtol=0, atol=1e-5)


def test_mesh_small_grid_matches_reference():
    (jt, jw, _), _, origin, voxel = _reconstruct_both(FRAME_IDS[2:])
    jp = np.asarray(joe._mesh_small_grid(jnp.asarray(jt), jnp.asarray(jw), jnp.asarray(origin), voxel, G))
    tp = toe._mesh_small_grid(torch.from_numpy(jt), torch.from_numpy(jw), origin, voxel, G).numpy()
    assert jp.shape == tp.shape == (toe.MAX_OBJ_TRIS + 1, 9)
    n = int(jp[-1, 0])
    assert n == int(tp[-1, 0]) > 100
    np.testing.assert_allclose(jp[:n], tp[:n], rtol=0, atol=1e-6)
    np.testing.assert_allclose(jp[-1], tp[-1], rtol=0, atol=1e-6)


def test_mesh_small_grid_caps_rows_and_keeps_full_bbox():
    """More valid triangles than MAX_OBJ_TRIS (35^3 cells, a periodic field
    whose zero set cuts most of them): both keep the first MAX_OBJ_TRIS rows
    in cell order and report the bbox of every valid triangle."""
    g = 36
    ax = np.arange(g, dtype=np.float32)
    x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
    tsdf = (np.sin(x * 0.9) + np.cos(y * 1.3) + np.sin(z * 0.7)).astype(np.float32) * 0.1
    weight = np.ones_like(tsdf)
    origin, voxel = np.asarray([-1.0, 0.5, 0.0], np.float32), np.float32(0.05)
    jp = np.asarray(joe._mesh_small_grid(jnp.asarray(tsdf), jnp.asarray(weight), jnp.asarray(origin), voxel, g))
    tp = toe._mesh_small_grid(torch.from_numpy(tsdf), torch.from_numpy(weight), origin, voxel, g).numpy()
    assert int(jp[-1, 0]) == int(tp[-1, 0]) == toe.MAX_OBJ_TRIS
    np.testing.assert_allclose(jp, tp, rtol=0, atol=1e-6)


def _buffers(fr, ids):
    jbuf, tbuf = JBuffer(JBufferConfig()), TBuffer(TBufferConfig())
    for i in ids:
        f = fr[i]
        lab = f["labels"].astype(np.int32)
        jbuf.store(JFrame(stamp_ns=f["stamp_ns"], depth=jnp.asarray(f["depth"]), color=None, labels=None,
                          R_w_c=f["R_w_c"], t_w_c=f["t_w_c"], object_image=jnp.asarray(lab)))
        tbuf.store(TFrame(stamp_ns=f["stamp_ns"], depth=torch.from_numpy(f["depth"]), color=None, labels=None,
                          R_w_c=f["R_w_c"], t_w_c=f["t_w_c"], object_image=torch.from_numpy(lab)))
    return jbuf, tbuf


def _track(cam, fr, ids, dynamic=False):
    obs = []
    for i in ids:
        pts = _shelf_points(cam, fr[i])
        centroid = pts.mean(0) + (np.asarray([0.3 * i, 0, 0]) if dynamic else 0)
        obs.append(JObservation(stamp_ns=fr[i]["stamp_ns"], semantic_cluster_id=0 if dynamic else SHELF,
                                dynamic_cluster_id=1 if dynamic else 0, centroid=centroid.astype(np.float32),
                                bbox_min=pts.min(0).astype(np.float32), bbox_max=pts.max(0).astype(np.float32)))
    return JTrack(track_id=7, first_seen_ns=obs[0].stamp_ns, last_seen_ns=obs[-1].stamp_ns, observations=obs,
                  semantic_category=1 if dynamic else SHELF, is_dynamic=dynamic)


@pytest.mark.parametrize("max_frames", [K, 6], ids=["subsampled", "all-frames"])
def test_extractor_static_object_matches_reference(max_frames):
    cam, fr = frames(24)
    config = {**CONFIG, "max_frames": max_frames}
    jext = joe.MeshObjectExtractor(joe.MeshObjectExtractorConfig(**config), cam)
    text = toe.MeshObjectExtractor(toe.MeshObjectExtractorConfig(**config), torch_camera(cam), device="cpu")
    jbuf, tbuf = _buffers(fr, FRAME_IDS)
    track = _track(cam, fr, FRAME_IDS)
    jobj = jext.extract(track, jbuf)
    tobj = text.extract(torch_track(track), tbuf)
    assert jobj is not None and tobj is not None
    assert (tobj.node_id, tobj.semantic_category, tobj.first_observed_ns, tobj.last_observed_ns) == (
        jobj.node_id, jobj.semantic_category, jobj.first_observed_ns, jobj.last_observed_ns)
    assert len(tobj.mesh_faces) == len(jobj.mesh_faces) > 50
    assert len(tobj.mesh_vertices) == len(jobj.mesh_vertices)
    np.testing.assert_allclose(tobj.bbox_min, jobj.bbox_min, rtol=0, atol=1e-5)
    np.testing.assert_allclose(tobj.bbox_max, jobj.bbox_max, rtol=0, atol=1e-5)
    np.testing.assert_allclose(tobj.mesh_vertices, jobj.mesh_vertices, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(tobj.mesh_faces, jobj.mesh_faces)
    np.testing.assert_array_equal(tobj.mesh_colors, jobj.mesh_colors)


def test_extractor_dynamic_and_rejected_tracks_match_reference():
    cam, fr = frames(24)
    jext = joe.MeshObjectExtractor(joe.MeshObjectExtractorConfig(**CONFIG), cam)
    text = toe.MeshObjectExtractor(toe.MeshObjectExtractorConfig(**CONFIG), torch_camera(cam), device="cpu")
    jbuf, tbuf = _buffers(fr, FRAME_IDS)
    tracks = [
        _track(cam, fr, FRAME_IDS, dynamic=True),  # moves 5 m: a dynamic object
        _track(cam, fr, FRAME_IDS[:2], dynamic=True),  # moves 0.3 m: below min displacement
        _track(cam, fr, FRAME_IDS[:1]),  # one observation: below allocation confidence
        _track(cam, fr, FRAME_IDS[:3]),  # its frames are not buffered (below): nothing to fuse
    ]
    for o in tracks[-1].observations:
        o.stamp_ns += 1
    jobjs = jext.extract_all(tracks, jbuf)
    tobjs = text.extract_all([torch_track(t) for t in tracks], tbuf)
    assert len(jobjs) == len(tobjs) == 1
    j, t = jobjs[0], tobjs[0]
    assert t.trajectory_stamps_ns == j.trajectory_stamps_ns and t.is_dynamic
    np.testing.assert_array_equal(t.trajectory_positions, j.trajectory_positions)
    np.testing.assert_array_equal(t.bbox_min, j.bbox_min)
    np.testing.assert_array_equal(t.bbox_max, j.bbox_max)


def _soup(seed, n=3000, res=0.02):
    """Triangles whose vertices repeat on a coarse lattice (and some exactly
    on quantisation half-steps), with stamps that extend and shrink."""
    rng = np.random.default_rng(seed)
    lattice = rng.integers(-40, 40, (n, 3, 3)).astype(np.float32) * np.float32(res / 2)
    jitter = rng.normal(0, res / 8, (n, 3, 3)).astype(np.float32) * (rng.random((n, 3, 1)) < 0.5)
    verts = (lattice + jitter).astype(np.float32)
    colors = rng.random((n, 3, 3)).astype(np.float32)
    first = rng.integers(0, 10**9, (n, 3)).astype(np.int64)
    last = first + rng.integers(0, 10**9, (n, 3)).astype(np.int64)
    labels = rng.integers(0, 7, (n, 3)).astype(np.int32)
    return verts, colors, first, last, labels


@pytest.mark.parametrize("kind", ["python", "native"])
def test_mesh_accumulator_bit_exact_against_reference(kind):
    res = 0.02
    if kind == "python":
        j, t = JAccumulator(res), TAccumulator(res)
    else:
        assert jnative.available()
        j, t = jnative.NativeMeshAccumulator(res), tnative.NativeMeshAccumulator(res)
    for seed in range(3):  # three batches: later ones hit earlier vertices
        soup = _soup(seed)
        assert j.add_triangles(*soup) == t.add_triangles(*soup)
    jm, tm = j.build(), t.build()
    for field in ("vertices", "colors", "labels", "first_seen_ns", "last_seen_ns", "faces"):
        a, b = getattr(jm, field), getattr(tm, field)
        assert a.dtype == b.dtype and a.shape == b.shape, field
        np.testing.assert_array_equal(a, b, err_msg=field)
    assert tm.num_faces > 1000


def test_native_accumulator_builds_into_build_dir_only():
    lib = tnative.load_library()
    assert lib is tnative.load_library()
    path = tnative._library_path()
    assert path.exists() and path.parent == tnative.BUILD_DIR
    assert tnative.BUILD_DIR.parts[-2:] == ("build", "khronos_tpu_torch")
    empty = tnative.NativeMeshAccumulator(0.01).build()
    assert empty.num_vertices == 0 and empty.faces.shape == (0, 3)
    with pytest.raises(ValueError):
        tnative.NativeMeshAccumulator(0.01).add_triangles(np.zeros((2, 3, 3), np.float32), np.zeros((2, 3), np.float32),
                                                          np.zeros((2, 3)), np.zeros((2, 3)), np.zeros((2, 3)))


def test_native_accumulator_build_failure_raises(tmp_path, monkeypatch):
    bad = tmp_path / "mesh_accum.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tnative, "SOURCE", bad)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tnative, "_lib", None)
    with pytest.raises(RuntimeError, match="building mesh_accum.cpp failed"):
        tnative.make_mesh_accumulator(0.01)
