"""Port parity: data/synthetic.py clean frames (the sphere tracer).

The two renderers trace the same rays through the same SDF, but the
reference rotates the rays with an einsum and the port elementwise, and the
96-step march accumulates those ulp differences. Whether a grazing ray stops
is a float decision: it can stop one step earlier on one side, inside the
tracer's 1e-3 m hit threshold, or land on the other side of a silhouette.
Budget for such flips: at most 1e-4 of the pixels may have a depth more than
1e-5 m off (none may be more than 1e-3 m off), and at most 1e-4 of the
pixels may carry another label, only on silhouettes (pixels whose 3x3
neighbourhood holds more than one label in the reference). Measured at this
size: no label differs and depth agrees to 2e-6 m; at 96x128, 2 of 12,288
pixels had a depth up to 6e-4 m off."""

import numpy as np
import pytest
import torch

from khronos_tpu.data import synthetic as jsyn
from khronos_tpu_torch.data import synthetic as tsyn

from torch_parity import H, W, sequence


@pytest.mark.parametrize("index", [0, 7, 13])
def test_clean_frame_matches_reference(index):
    jseq = sequence(20)
    tseq = tsyn.SyntheticSequence(
        tsyn.office_scene(duration=jseq.config.duration),
        tsyn.SyntheticSequenceConfig(**{
            k: getattr(jseq.config, k) for k in
            ("height", "width", "fx", "fy", "cx", "cy", "max_range", "min_range", "fps", "duration")
        }),
        device="cpu",
    )
    want = jseq.render_frame(index)
    got = tseq.render_frame(index)
    assert want["stamp_ns"] == got["stamp_ns"]
    np.testing.assert_array_equal(want["R_w_c"], got["R_w_c"])
    np.testing.assert_array_equal(want["t_w_c"], got["t_w_c"])
    wl = np.asarray(want["labels"])
    gl = got["labels"].numpy()
    assert gl.dtype == np.int32 and gl.shape == (H, W)
    pad = np.pad(wl, 1, mode="edge")
    window = np.stack([pad[i:i + H, j:j + W] for i in range(3) for j in range(3)])
    silhouette = (window != wl[None]).any(0)
    differ = wl != gl
    assert not (differ & ~silhouette).any()
    assert differ.mean() <= 1e-4
    same = ~differ & (wl >= 0)
    wd = np.asarray(want["depth"])
    gd = got["depth"].numpy()
    err = np.abs(wd[same] - gd[same])
    assert err.max() <= 1e-3 and (err > 1e-5).sum() <= 1e-4 * wl.size
    np.testing.assert_array_equal(wd[wl < 0], gd[wl < 0])
    np.testing.assert_allclose(np.asarray(want["color"])[same], got["color"].numpy()[same], atol=0)


def test_scene_and_label_space_match_reference():
    js, ts = jsyn.office_scene(12.0), tsyn.office_scene(12.0)
    for t in (0.0, 5.5, 7.0):
        for a, b in zip(js.device_arrays(t), ts.host_arrays(t)):
            np.testing.assert_array_equal(np.asarray(a), b)
    jl, tl = jsyn.default_label_space(), tsyn.default_label_space()
    np.testing.assert_array_equal(jl.is_object_lut(), tl.is_object_lut())
    np.testing.assert_array_equal(jl.is_dynamic_lut(), tl.is_dynamic_lut())


def test_noise_is_a_later_slice():
    cfg = tsyn.SyntheticSequenceConfig(noise=object())
    with pytest.raises(NotImplementedError):
        tsyn.SyntheticSequence(tsyn.office_scene(), cfg, device="cpu")
