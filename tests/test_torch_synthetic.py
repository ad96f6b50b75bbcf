"""Port parity: data/synthetic.py clean frames (the sphere tracer).

The port's renderer follows XLA CPU's rounding of the reference's march
(tests/test_torch_contraction.py holds each operation): labels, colour and
instances come out bit for bit, and depth differs only through the final
rsqrt, by at most 2 ulps (`test_config_frames_match_reference`, the
configs' own 240x320 frames). The older cases below keep their budget for
flips on silhouettes: at most 1e-4 of the pixels may have a depth more than
1e-5 m off (none may be more than 1e-3 m off), and at most 1e-4 of the
pixels may carry another label, only on silhouettes (pixels whose 3x3
neighbourhood holds more than one label in the reference)."""

import numpy as np
import pytest
import torch
import yaml

from khronos_tpu.data import synthetic as jsyn
from khronos_tpu_torch.data import synthetic as tsyn

from torch_parity import H, W, sequence


def _silhouette(labels):
    """Pixels whose 3x3 neighbourhood holds more than one value."""
    h, w = labels.shape
    pad = np.pad(labels, 1, mode="edge")
    window = np.stack([pad[i:i + h, j:j + w] for i in range(3) for j in range(3)])
    return (window != labels[None]).any(0)


def _config_of(jseq):
    return tsyn.SyntheticSequenceConfig(**{
        k: getattr(jseq.config, k) for k in
        ("height", "width", "fx", "fy", "cx", "cy", "max_range", "min_range", "fps", "duration", "n_loops")
    })


def _assert_frame_matches(want, got):
    assert want["stamp_ns"] == got["stamp_ns"]
    np.testing.assert_array_equal(want["R_w_c"], got["R_w_c"])
    np.testing.assert_array_equal(want["t_w_c"], got["t_w_c"])
    wl = np.asarray(want["labels"])
    gl = got["labels"].numpy()
    assert gl.dtype == np.int32 and gl.shape == wl.shape
    differ = wl != gl
    assert not (differ & ~_silhouette(wl)).any()
    assert differ.mean() <= 1e-4
    same = ~differ & (wl >= 0)
    wd = np.asarray(want["depth"])
    gd = got["depth"].numpy()
    err = np.abs(wd[same] - gd[same])
    assert err.max() <= 1e-3 and (err > 1e-5).sum() <= 1e-4 * wl.size
    np.testing.assert_array_equal(wd[wl < 0], gd[wl < 0])
    np.testing.assert_allclose(np.asarray(want["color"])[same], got["color"].numpy()[same], atol=0)
    # open-set outputs: instance ids differ only on silhouettes (of the
    # instance image), within the same budget; the embeddings bit for bit
    wi = np.asarray(want["instances"])
    gi = got["instances"].numpy()
    assert gi.dtype == np.int32
    idiff = wi != gi
    assert not (idiff & ~_silhouette(wi)).any() and idiff.mean() <= 1e-4
    np.testing.assert_array_equal(want["features"], got["features"])


@pytest.mark.parametrize("index", [0, 7, 13])
def test_clean_frame_matches_reference(index):
    jseq = sequence(20)
    tseq = tsyn.SyntheticSequence(tsyn.office_scene(duration=jseq.config.duration), _config_of(jseq), device="cpu")
    want = jseq.render_frame(index)
    got = tseq.render_frame(index)
    assert got["labels"].shape == (H, W)
    _assert_frame_matches(want, got)


@pytest.mark.parametrize("index", [0, 9, 24])
def test_apartment_frame_matches_reference(index):
    """The apartment scene (two boxes and a sphere) on the orbit camera."""
    duration = 4.0
    cfg = jsyn.SyntheticSequenceConfig(duration=duration, fps=10.0, height=H, width=W,
                                       fx=W * 0.625, fy=W * 0.625, cx=W / 2, cy=H / 2)
    jseq = jsyn.SyntheticSequence(jsyn.apartment_scene(duration), cfg)
    tseq = tsyn.SyntheticSequence(tsyn.apartment_scene(duration), _config_of(jseq), device="cpu")
    want, got = jseq.render_frame(index), tseq.render_frame(index)
    assert (np.asarray(want["instances"]) > 0).any()
    _assert_frame_matches(want, got)


@pytest.mark.parametrize("index", [0, 40, 77])
def test_hard_scene_tour_frame_matches_reference(index):
    """The four-room hard scene on the waypoint tour: poses to 1e-6, frames
    within the budget."""
    duration = 8.0
    cfg = jsyn.SyntheticSequenceConfig(duration=duration, fps=10.0, height=H, width=W,
                                       fx=W * 0.625, fy=W * 0.625, cx=W / 2, cy=H / 2, n_loops=1.0)
    jseq = jsyn.TourSequence(jsyn.hard_scene(duration), cfg)
    tseq = tsyn.TourSequence(tsyn.hard_scene(duration), _config_of(jseq), device="cpu")
    for t in np.linspace(0.0, duration, 17):
        jR, jt = jseq.pose_at(t)
        tR, tt = tseq.pose_at(t)
        np.testing.assert_allclose(tR, jR, rtol=0, atol=1e-6)
        np.testing.assert_allclose(tt, jt, rtol=0, atol=1e-6)
    _assert_frame_matches(jseq.render_frame(index), tseq.render_frame(index))


def test_scenes_and_embeddings_match_reference():
    """The apartment's and the hard scene's arrays, the tour waypoints, and
    the open-set embeddings (numpy generators from the reference's seeds)."""
    for jscene, tscene in ((jsyn.apartment_scene(20.0), tsyn.apartment_scene(20.0)),
                           (jsyn.hard_scene(60.0), tsyn.hard_scene(60.0))):
        assert [p.name for p in tscene.primitives] == [p.name for p in jscene.primitives]
        assert [(p.structure, p.group) for p in tscene.primitives] == [(p.structure, p.group) for p in jscene.primitives]
        for t in (0.0, 13.3, 27.0, 31.5, 59.0):
            for a, b in zip(jscene.device_arrays(t), tscene.host_arrays(t)):
                np.testing.assert_array_equal(np.asarray(a), b)
    np.testing.assert_array_equal(tsyn.hard_scene_tour_waypoints(), jsyn.hard_scene_tour_waypoints())
    jseq = sequence(4)
    tseq = tsyn.SyntheticSequence(tsyn.office_scene(jseq.config.duration), _config_of(jseq), device="cpu")
    np.testing.assert_array_equal(tseq.instance_features(), jseq.instance_features())
    np.testing.assert_array_equal(tseq.instance_features(16), jseq.instance_features(16))
    np.testing.assert_array_equal(tseq.background_embeddings(), jseq.background_embeddings())


def test_scene_and_label_space_match_reference():
    js, ts = jsyn.office_scene(12.0), tsyn.office_scene(12.0)
    for t in (0.0, 5.5, 7.0):
        for a, b in zip(js.device_arrays(t), ts.host_arrays(t)):
            np.testing.assert_array_equal(np.asarray(a), b)
    jl, tl = jsyn.default_label_space(), tsyn.default_label_space()
    np.testing.assert_array_equal(jl.is_object_lut(), tl.is_object_lut())
    np.testing.assert_array_equal(jl.is_dynamic_lut(), tl.is_dynamic_lut())


@pytest.mark.parametrize("config,index", [("office", 10), ("office", 85), ("apartment", 10), ("apartment", 85)])
def test_config_frames_match_reference(config, index):
    """configs/{office,apartment}_synthetic.yaml's own 240x320 frames through
    both packages' SyntheticDataset: labels, colour, instances and poses bit
    for bit; depth within 2 ulps (the reference's rsqrt estimate), equal
    wherever nothing is hit."""
    from khronos_tpu.data.datasets import SyntheticDataset as JDataset
    from khronos_tpu_torch.data.datasets import SyntheticDataset as TDataset

    with open(f"configs/{config}_synthetic.yaml") as fh:
        spec = dict(yaml.safe_load(fh)["dataset"])
    spec.pop("kind", None)
    want = JDataset(**spec).seq.render_frame(index)
    got = TDataset(device="cpu", **spec).seq.render_frame(index)
    assert got["depth"].shape == (240, 320)
    for key in ("labels", "color", "instances", "R_w_c", "t_w_c"):
        np.testing.assert_array_equal(np.asarray(want[key]), np.asarray(got[key]), err_msg=key)
    wd, gd = np.asarray(want["depth"]), got["depth"].numpy()
    ulps = np.abs(gd.view(np.int32).astype(np.int64) - wd.view(np.int32))
    assert ulps.max() <= 2
    np.testing.assert_array_equal(gd[wd == 0], 0.0)
