"""Port parity: the modular detectors and the ops they use.

FreeSpaceMotionDetector, ConnectedSemantics (3D and 2D) and
InstanceForwarding (with and without background embeddings) run in both
packages on the same volume state (built by the reference: its motion
detector masks each frame's dynamic pixels, then integrate_frame) and the
same frames (the JAX renderer's small office sequence, instances and
embeddings included). Id images, cluster ids, pixel and voxel counts and
categories must match bit for bit. Coordinate-valued stats come from the
vertex image, which the reference computes with a 3x3 matmul and the port
elementwise: bbox extremes within 1e-6 m, centroids (sums in another order)
within rtol 1e-5, as in tests/test_torch_fused_step.py.

Then the dense and cluster ops of the modular path (2D propagation, keyed
2D propagation, compact_labels, cluster_voxel_counts) bit for bit on random
inputs, the camera samplers (nearest exact, bilinear within 1e-6),
world_to_index exact, and integrate_frame_cropped against the reference's
(the state as in tests/torch_parity.assert_states_match).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from khronos_tpu.active_window.frame_data import FrameData as JFrame
from khronos_tpu.active_window.instance_forwarding import InstanceForwardingConfig as JIFConfig
from khronos_tpu.active_window.motion_detection import FreeSpaceMotionDetectorConfig as JMDConfig
from khronos_tpu.active_window.object_detection import ConnectedSemanticsConfig as JCSConfig
from khronos_tpu.data import synthetic as jsyn
from khronos_tpu.geometry import camera as jcam
from khronos_tpu.map import active_volume as jav
from khronos_tpu.ops import clusters as jcl
from khronos_tpu.ops import dense as jdense
from khronos_tpu_torch.active_window.frame_data import FrameData as TFrame
from khronos_tpu_torch.active_window.instance_forwarding import OPENSET_CATEGORY
from khronos_tpu_torch.active_window.instance_forwarding import InstanceForwardingConfig as TIFConfig
from khronos_tpu_torch.active_window.motion_detection import FreeSpaceMotionDetectorConfig as TMDConfig
from khronos_tpu_torch.active_window.object_detection import ConnectedSemanticsConfig as TCSConfig
from khronos_tpu_torch.geometry import camera as tcam
from khronos_tpu_torch.map import active_volume as tav
from khronos_tpu_torch.ops import clusters as tcl
from khronos_tpu_torch.ops import dense as tdense

from torch_parity import assert_states_match, frames, torch_camera, torch_label_space

N_FRAMES = 60
KEEP = (20, 26, 28, 52, 56)  # frames whose pre-integration state is kept (humans in view)
VOL = dict(grid_shape=(48, 48, 32), voxel_size=0.1)


def _origin_xyz(t_w_c):
    shape = np.asarray(VOL["grid_shape"])
    return (np.floor(np.asarray(t_w_c) / VOL["voxel_size"] - shape / 2.0) + 0.5) * VOL["voxel_size"]


@functools.lru_cache(maxsize=None)
def _scenario():
    """(camera, [(numpy state fields, frame dict)]) at the KEEP frames: the
    reference's motion detector and integration over the office frames."""
    cam, fr = frames(N_FRAMES)
    vol_cfg = jav.VolumeConfig(**VOL)
    state = jav.create(vol_cfg, origin_xyz=_origin_xyz(fr[0]["t_w_c"]))
    det = JMDConfig(min_cluster_size=20, grow_iterations=12).create(vol_cfg, cam)
    kept = []
    for i, f in enumerate(fr[:N_FRAMES]):
        if i in KEEP:
            kept.append(([np.asarray(a) for a in state], f))
        frame = _jframe(f)
        det.process(state, frame)
        state = jav.integrate_frame(vol_cfg, cam, state, frame.depth, frame.color, frame.labels,
                                    frame.dynamic_image > 0, frame.R_w_c, frame.t_w_c, jnp.float32(f["t"]))
    return cam, kept


def _jframe(f, openset=False):
    return JFrame(stamp_ns=f["stamp_ns"], depth=jnp.asarray(f["depth"]), color=jnp.asarray(f["color"]),
                  labels=jnp.asarray(f["labels"]), R_w_c=f["R_w_c"], t_w_c=f["t_w_c"],
                  instances=jnp.asarray(f["instances"]) if openset else None,
                  label_features=f["features"] if openset else None)


def _tframe(f, openset=False):
    return TFrame(stamp_ns=f["stamp_ns"], depth=torch.from_numpy(f["depth"]), color=torch.from_numpy(f["color"]),
                  labels=torch.from_numpy(f["labels"]), R_w_c=f["R_w_c"], t_w_c=f["t_w_c"],
                  instances=torch.from_numpy(f["instances"]) if openset else None,
                  label_features=f["features"] if openset else None)


def _assert_clusters(want, got):
    assert [(c.cluster_id, c.num_pixels, c.num_voxels, c.category_id) for c in got] == [
        (c.cluster_id, c.num_pixels, c.num_voxels, c.category_id) for c in want]
    for a, b in zip(want, got):
        np.testing.assert_allclose(b.centroid, a.centroid, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(b.bbox_min, a.bbox_min, rtol=0, atol=1e-6)
        np.testing.assert_allclose(b.bbox_max, a.bbox_max, rtol=0, atol=1e-6)
        assert (a.feature is None) == (b.feature is None)
        if a.feature is not None:
            np.testing.assert_array_equal(b.feature, a.feature)


def _run_both(jcfg, tcfg, index, openset=False, label_space=False, background=None):
    """The detector of each package on the kept state and frame `index`;
    returns (reference frame, port frame, reference clusters, port clusters)."""
    cam, kept = _scenario()
    fields, f = kept[index]
    vol_j, vol_t = jav.VolumeConfig(**VOL), tav.VolumeConfig(**VOL)
    ls = jsyn.default_label_space()
    jargs = (vol_j, cam) + ((ls,) if label_space else ())
    targs = (vol_t, torch_camera(cam)) + ((torch_label_space(ls),) if label_space else ())
    jdet, tdet = jcfg.create(*jargs), tcfg.create(*targs)
    if background is not None:
        jdet.set_background_embeddings(background)
        tdet.set_background_embeddings(background)
    jfr, tfr = _jframe(f, openset), _tframe(f, openset)
    jc = jdet.process(jav.VolumeState(*[jnp.asarray(a) for a in fields]), jfr)
    tc = tdet.process(tav.state_from_numpy(fields, device="cpu"), tfr)
    return jfr, tfr, jc, tc


@pytest.mark.parametrize("index", range(len(KEEP)))
def test_motion_detector_matches_reference(index):
    jfr, tfr, jc, tc = _run_both(JMDConfig(min_cluster_size=20, grow_iterations=12),
                                 TMDConfig(min_cluster_size=20, grow_iterations=12), index)
    np.testing.assert_array_equal(tfr.dynamic_image.numpy(), np.asarray(jfr.dynamic_image))
    _assert_clusters(jc, tc)
    assert tfr.dynamic_clusters is tc


DETECTORS = {
    "motion": lambda i: _run_both(JMDConfig(min_cluster_size=20, grow_iterations=12),
                                  TMDConfig(min_cluster_size=20, grow_iterations=12), i),
    "semantics_3d": lambda i: _run_both(JCSConfig(min_cluster_size=5), TCSConfig(min_cluster_size=5), i,
                                        label_space=True),
    "semantics_2d": lambda i: _run_both(JCSConfig(min_cluster_size=5, use_3d=False),
                                        TCSConfig(min_cluster_size=5, use_3d=False), i, label_space=True),
    "instances": lambda i: _run_both(JIFConfig(min_cluster_size=10), TIFConfig(min_cluster_size=10), i,
                                     openset=True),
}


@pytest.mark.parametrize("detector", list(DETECTORS))
def test_detectors_find_clusters(detector):
    """The scenario is not trivial: each detector finds clusters in some
    kept frame, in both packages."""
    counts = [(len(jc), len(tc)) for _, _, jc, tc in map(DETECTORS[detector], range(len(KEEP)))]
    assert any(j and t for j, t in counts), counts


@pytest.mark.parametrize("use_3d", [True, False])
@pytest.mark.parametrize("index", range(len(KEEP)))
def test_connected_semantics_matches_reference(index, use_3d):
    kw = dict(min_cluster_size=5, use_3d=use_3d)
    jfr, tfr, jc, tc = _run_both(JCSConfig(**kw), TCSConfig(**kw), index, label_space=True)
    np.testing.assert_array_equal(tfr.object_image.numpy(), np.asarray(jfr.object_image))
    _assert_clusters(jc, tc)


def test_connected_semantics_4_connected_matches_reference():
    kw = dict(min_cluster_size=5, use_3d=False, use_full_connectivity=False)
    jfr, tfr, jc, tc = _run_both(JCSConfig(**kw), TCSConfig(**kw), 1, label_space=True)
    np.testing.assert_array_equal(tfr.object_image.numpy(), np.asarray(jfr.object_image))
    _assert_clusters(jc, tc)


@pytest.mark.parametrize("background", [False, True])
@pytest.mark.parametrize("index", range(len(KEEP)))
def test_instance_forwarding_matches_reference(index, background):
    """With background embeddings, one of them is an object's own feature,
    so the filter drops that instance in both packages."""
    bg = None
    if background:
        feats = _scenario()[1][index][1]["features"]
        inst = _scenario()[1][index][1]["instances"]
        present = sorted(set(np.unique(inst[inst > 0]).tolist()))
        bg = np.stack([feats[present[0] - 1], -feats[-1]]).astype(np.float32)
    kw = dict(min_cluster_size=10)
    jfr, tfr, jc, tc = _run_both(JIFConfig(**kw), TIFConfig(**kw), index, openset=True, background=bg)
    np.testing.assert_array_equal(tfr.object_image.numpy(), np.asarray(jfr.object_image))
    _assert_clusters(jc, tc)
    assert all(c.category_id == OPENSET_CATEGORY for c in tc)


def test_instance_forwarding_without_instances():
    cam, kept = _scenario()
    tdet = TIFConfig().create(tav.VolumeConfig(**VOL), torch_camera(cam))
    fr = _tframe(kept[0][1])
    assert tdet.process(tav.state_from_numpy(kept[0][0], device="cpu"), fr) == []
    assert not fr.object_image.any()


def test_background_scores_stay_full_float32():
    """The background filter compares cosines against a threshold: the
    matmul must not run in TF32 (the port turns TF32 off on import)."""
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    from khronos_tpu.active_window.instance_forwarding import _background_scores as jscores
    from khronos_tpu_torch.active_window.instance_forwarding import _background_scores as tscores

    rng = np.random.default_rng(3)
    f, b = rng.normal(size=(32, 32)).astype(np.float32), rng.normal(size=(4, 32)).astype(np.float32)
    np.testing.assert_allclose(tscores(torch.from_numpy(f), torch.from_numpy(b)).numpy(),
                               np.asarray(jscores(jnp.asarray(f), jnp.asarray(b))), rtol=0, atol=1e-6)


# ----------------------------------------------------------------------------
# ops
# ----------------------------------------------------------------------------


def _random_labels(rng, shape, p_seed=0.1, p_grow=0.6):
    grow = rng.random(shape) < p_grow
    lab = np.where(grow & (rng.random(shape) < p_seed), rng.integers(0, 10_000, shape), -1).astype(np.int32)
    return lab, grow


@pytest.mark.parametrize("full", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_propagate_labels_2d_matches_reference(seed, full):
    """The reference jits full_connectivity as a traced argument, so only its
    default traces; the 4-connected case runs its Python body eagerly."""
    rng = np.random.default_rng(seed)
    lab, grow = _random_labels(rng, (37, 53))
    if full:
        want = jdense.propagate_labels_2d(jnp.asarray(lab), jnp.asarray(grow), 9)
    else:
        want = jdense.propagate_labels_2d.__wrapped__(jnp.asarray(lab), jnp.asarray(grow), 9, False)
    got = tdense.propagate_labels_2d(torch.from_numpy(lab), torch.from_numpy(grow), 9, full).numpy()
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("full", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_propagate_labels_keyed_2d_matches_reference(seed, full):
    rng = np.random.default_rng(seed)
    lab, grow = _random_labels(rng, (41, 29), p_grow=0.8)
    key = rng.integers(-1, 4, (41, 29)).astype(np.int32)
    want = np.asarray(jdense.propagate_labels_keyed_2d(jnp.asarray(lab), jnp.asarray(key), jnp.asarray(grow), 12, full))
    got = tdense.propagate_labels_keyed_2d(torch.from_numpy(lab), torch.from_numpy(key),
                                           torch.from_numpy(grow), 12, full).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_values", [0, 5, 40, 200])
def test_compact_labels_matches_reference(n_values):
    """ops.dense.compact_labels: fewer and more distinct values than
    max_clusters, with and without -1."""
    rng = np.random.default_rng(n_values)
    vals = rng.choice(100_000, size=max(n_values, 1), replace=False)
    flat = np.where(rng.random(3000) < 0.3, -1, vals[rng.integers(0, len(vals), 3000)]).astype(np.int32)
    if n_values == 0:
        flat[:] = -1
    for mc in (8, 64):
        want = jdense.compact_labels(jnp.asarray(flat), mc)
        got = tdense.compact_labels(torch.from_numpy(flat), mc)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("vox_bound", [500, 1 << 22])
def test_cluster_voxel_counts_matches_reference(vox_bound):
    """Voxel indices under and above the key's 21 bits (the reference clamps
    the latter into one key per cluster)."""
    rng = np.random.default_rng(7)
    compact = np.where(rng.random((30, 40)) < 0.7, rng.integers(0, 64, (30, 40)), -1).astype(np.int32)
    vox = rng.integers(0, vox_bound, (30, 40)).astype(np.int32)
    want = np.asarray(jcl.cluster_voxel_counts(jnp.asarray(compact), jnp.asarray(vox), 64))
    got = tcl.cluster_voxel_counts(torch.from_numpy(compact), torch.from_numpy(vox), 64).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("channels", [0, 3])
def test_camera_samplers_match_reference(channels):
    rng = np.random.default_rng(channels)
    shape = (24, 32) + ((channels,) if channels else ())
    img = rng.normal(size=shape).astype(np.float32)
    # in and out of the image, and exact half-pixel ties for the rounding
    u = np.concatenate([rng.uniform(-3, 35, 500), np.arange(-1, 33) + 0.5]).astype(np.float32)
    v = np.concatenate([rng.uniform(-3, 27, 500), (np.arange(-1, 33) % 26) + 0.5]).astype(np.float32)
    ju, jv, tu, tv = jnp.asarray(u), jnp.asarray(v), torch.from_numpy(u), torch.from_numpy(v)
    np.testing.assert_array_equal(tcam.nearest_sample(torch.from_numpy(img), tu, tv).numpy(),
                                  np.asarray(jcam.nearest_sample(jnp.asarray(img), ju, jv)))
    np.testing.assert_allclose(tcam.bilinear_sample(torch.from_numpy(img), tu, tv).numpy(),
                               np.asarray(jcam.bilinear_sample(jnp.asarray(img), ju, jv)), rtol=0, atol=1e-6)
    labels = rng.integers(-1, 7, (24, 32)).astype(np.int32)
    np.testing.assert_array_equal(tcam.nearest_sample(torch.from_numpy(labels), tu, tv).numpy(),
                                  np.asarray(jcam.nearest_sample(jnp.asarray(labels), ju, jv)))


def test_world_to_index_matches_reference():
    cam, kept = _scenario()
    fields, f = kept[0]
    jstate = jav.VolumeState(*[jnp.asarray(a) for a in fields])
    tstate = tav.state_from_numpy(fields, device="cpu")
    pts = np.asarray(jcam.Camera.vertex_image_world(cam, jnp.asarray(f["depth"]), f["R_w_c"], f["t_w_c"]))
    pts = np.concatenate([pts.reshape(-1, 3), np.random.default_rng(0).uniform(-6, 6, (500, 3)).astype(np.float32)])
    ji, jok = jav.world_to_index(jstate, jnp.asarray(pts), VOL["voxel_size"])
    ti, tok = tav.world_to_index(tstate, torch.from_numpy(pts), VOL["voxel_size"])
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    assert tok.any() and not tok.all()


@pytest.mark.parametrize("grid", [(48, 48, 32), (128, 128, 16)])
def test_integrate_frame_cropped_matches_reference(grid):
    """A grid smaller than the crop integrates in full; a larger one through
    the camera-centred crop, leaving the rest untouched."""
    cam, fr = frames(N_FRAMES)
    jcfg = jav.VolumeConfig(grid_shape=grid, voxel_size=0.1)
    tcfg = tav.VolumeConfig(grid_shape=grid, voxel_size=0.1)
    origin = (np.floor(np.asarray(fr[0]["t_w_c"]) / 0.1 - np.asarray(grid) / 2.0) + 0.5) * 0.1
    jstate = jav.create(jcfg, origin_xyz=origin)
    tstate = tav.create(tcfg, origin_xyz=origin, device="cpu")
    tc = torch_camera(cam)
    for f in fr[:4]:
        mask = f["labels"] == jsyn.HUMAN
        jstate = jav.integrate_frame_cropped(jcfg, cam, jstate, jnp.asarray(f["depth"]), jnp.asarray(f["color"]),
                                             jnp.asarray(f["labels"]), jnp.asarray(mask), f["R_w_c"], f["t_w_c"],
                                             jnp.float32(f["t"]))
        tstate = tav.integrate_frame_cropped(tcfg, tc, tstate, torch.from_numpy(f["depth"]),
                                             torch.from_numpy(f["color"]), torch.from_numpy(f["labels"]),
                                             torch.from_numpy(mask), f["R_w_c"], f["t_w_c"], f["t"])
    assert_states_match(jstate, tstate)
    assert (np.asarray(jstate.weight) > 0).any()
