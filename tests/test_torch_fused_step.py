"""Port parity: active_window/fused_step.py, the per-frame device program.

The same synthetic office frames (rendered by the JAX package) run through the
JAX step and the port's step from one shared start state, frame by frame, for
every closed-set detector combination at detection stride 1 and 2, with and
without semantic motion seeding. Id images, pixel counts, categories and
cluster ids must match bit for bit. Coordinate-valued stats (bbox extremes,
point samples) come from the vertex image, whose rounding the port copies
from XLA CPU (bit for bit in tests/test_torch_contraction.py): held here to
1e-6 m (about 2 ulp at 5 m). Centroid sums add those terms in another order:
rtol 1e-5. The volume state as in tests/torch_parity.assert_states_match."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from khronos_tpu.active_window import fused_step as jfs
from khronos_tpu.active_window.active_window import ActiveWindowConfig as JConfig
from khronos_tpu.config import build as jbuild
from khronos_tpu.data import synthetic as jsyn
from khronos_tpu.map import active_volume as jav
from khronos_tpu_torch.active_window import fused_step as tfs
from khronos_tpu_torch.active_window.active_window import ActiveWindowConfig as TConfig
from khronos_tpu_torch.config import build as tbuild
from khronos_tpu_torch.map import active_volume as tav

from torch_parity import assert_states_match, frames, torch_camera, torch_label_space

N_FRAMES = 14
GRID = [48, 48, 32]
SUMS = np.zeros((tfs.MC, 12), bool)
SUMS[:, 0:3] = True  # centroid sums
COORDS = np.zeros((tfs.MC, 12), bool)
COORDS[:, 3:9] = True  # bbox min / max
EXACT = ~(SUMS | COORDS)  # pixels, voxels or category, cluster id


def _config(detectors, seed):
    d = {"volumetric_map": {"grid_shape": GRID, "voxel_size": 0.1}}
    d["motion_detector"] = (
        {"type": "FreeSpaceMotionDetector", "min_cluster_size": 20, "seed_dynamic_labels": seed}
        if "motion" in detectors else None
    )
    d["object_detector"] = (
        {"type": "ConnectedSemantics", "min_cluster_size": 5} if "objects" in detectors else None
    )
    return jbuild(JConfig, d), tbuild(TConfig, d)


def _assert_packed(want, got):
    n = tfs.MC * 12
    for part in (slice(0, n), slice(n, 2 * n)):
        w = want[part].reshape(tfs.MC, 12)
        g = got[part].reshape(tfs.MC, 12)
        np.testing.assert_array_equal(w[EXACT], g[EXACT])
        np.testing.assert_allclose(w[COORDS], g[COORDS], rtol=0, atol=1e-6)
        np.testing.assert_allclose(w[SUMS], g[SUMS], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(want[2 * n:], got[2 * n:], rtol=0, atol=1e-6)  # point samples


@pytest.mark.parametrize(
    "detectors,stride,seed",
    [
        ("motion+objects", 2, False),
        ("motion+objects", 2, True),
        ("motion+objects", 1, False),
        ("motion+objects", 1, True),
        ("motion", 2, False),
        ("motion", 1, True),
        ("objects", 2, False),
        ("objects", 1, False),
    ],
)
def test_frame_step_matches_reference(detectors, stride, seed):
    cam, fr = frames(N_FRAMES)
    jc, tc = _config(detectors, seed)
    ls = jsyn.default_label_space()
    jmd = jc.motion_detector.config if jc.motion_detector.enabled else None
    jod = jc.object_detector.config if jc.object_detector.enabled else None
    tmd = tc.motion_detector.config if tc.motion_detector.enabled else None
    tod = tc.object_detector.config if tc.object_detector.enabled else None
    jstep = jfs.make_frame_step(jc.volumetric_map, cam, jmd, jod, ls, detection_stride=stride, donate=False)
    tstep = tfs.make_frame_step(
        tc.volumetric_map, torch_camera(cam), tmd, tod, torch_label_space(ls), detection_stride=stride
    )
    origin = np.floor(fr[0]["t_w_c"] / 0.1 - np.asarray(GRID) / 2.0).astype(np.int32)
    js = jav.create(jc.volumetric_map)._replace(origin=jnp.asarray(origin))
    ts = tav.state_from_numpy([np.asarray(a) for a in js], device="cpu")
    n_dyn = n_obj = 0
    for f in fr:
        js, jd, jo, jp = jstep(
            js, jnp.asarray(f["depth"]), jnp.asarray(f["color"]), jnp.asarray(f["labels"]),
            f["R_w_c"], f["t_w_c"], jnp.float32(f["t"]),
        )
        ts, td, to, tp = tstep(
            ts, torch.from_numpy(f["depth"]), torch.from_numpy(f["color"]),
            torch.from_numpy(f["labels"]), f["R_w_c"], f["t_w_c"], f["t"],
        )
        np.testing.assert_array_equal(np.asarray(jd), td.numpy())
        np.testing.assert_array_equal(np.asarray(jo), to.numpy())
        _assert_packed(np.asarray(jp), tp.numpy())
        n_dyn += int(td.max())
        n_obj += int(to.max())
    assert_states_match(js, ts)
    # the frames must exercise what the configuration detects
    assert n_dyn > 0 or "motion" not in detectors
    assert n_obj > 0 or "objects" not in detectors


def test_unpack_stats_matches_reference():
    rng = np.random.default_rng(2)
    n = tfs.MC * 24 + 2 * tfs.MC * tfs.K_SAMPLES * 3
    packed = rng.normal(size=n).astype(np.float32)
    stats = packed[: tfs.MC * 24].reshape(2 * tfs.MC, 12)
    stats[:, 9] = rng.integers(0, 200, 2 * tfs.MC)
    stats[:, 10] = rng.integers(-1, 7, 2 * tfs.MC)
    stats[:, 11] = np.where(rng.random(2 * tfs.MC) < 0.5, rng.integers(1, 20, 2 * tfs.MC), 0)
    want = jfs.unpack_stats(packed)
    got = tfs.unpack_stats(packed)
    for wl, gl in zip(want[:2], got[:2]):
        assert len(wl) == len(gl) > 0
        for a, b in zip(wl, gl):
            assert (a.cluster_id, a.num_pixels, a.num_voxels, a.category_id) == (
                b.cluster_id, b.num_pixels, b.num_voxels, b.category_id)
            for x, y in ((a.centroid, b.centroid), (a.bbox_min, b.bbox_min), (a.bbox_max, b.bbox_max)):
                np.testing.assert_array_equal(x, y)
    for wd, gd in zip(want[2:], got[2:]):
        assert wd.keys() == gd.keys()
        for k in wd:
            np.testing.assert_array_equal(wd[k], gd[k])


def test_unported_options_raise():
    cam, _ = frames(N_FRAMES)
    _, tc = _config("motion+objects", False)
    ls = torch_label_space(jsyn.default_label_space())
    with pytest.raises(NotImplementedError):
        tfs.make_frame_step(tc.volumetric_map, torch_camera(cam), None, None, ls, mesh=object())
    with pytest.raises(NotImplementedError):
        tfs.make_frame_step(tc.volumetric_map, torch_camera(cam), None, object(), ls)
