"""The frozen scenes and camera path against the program's renderer, on
small frames.

The poses are the program's bit for bit. The program sphere-traces each
ray and stops once the scene's distance falls under 1e-3 m, short of the
surface by that distance over the cosine of the ray's angle to it; the
copy intersects the surfaces in closed form. So the labels and colours of
a frame agree but for rays that graze an edge, and where both hit the
same surface the closed form lies at or beyond the traced depth (up to
float32 rounding, 2e-4 m) and within 5e-3 m of it on 99% of the pixels:
further only where a ray grazes a wall."""

import numpy as np
import pytest
import torch

from harness import scene


@pytest.mark.parametrize("kind", ["office", "apartment"])
def test_frozen_scene_agrees_with_the_programs_renderer(kind):
    from khronos_tpu_torch.data import synthetic as syn

    duration, hz, radius = 8.0, 25.0, 2.0
    sensor = dict(height=48, width=64, fx=40.0, fy=40.0, cx=32.0, cy=24.0, min_range=0.1, max_range=5.0)
    frames = scene.render_loop({"kind": kind, "seconds": duration, "n_loops": 1.0, "orbit_radius": radius,
                                "camera_height": 1.4}, sensor, hz, "cpu", block=4)
    prog_scene = (syn.office_scene if kind == "office" else syn.apartment_scene)(duration=duration)
    seq = syn.SyntheticSequence(prog_scene, syn.SyntheticSequenceConfig(
        height=48, width=64, fx=40.0, fy=40.0, cx=32.0, cy=24.0, duration=duration, fps=hz, n_loops=1.0,
        orbit_radius=radius), device="cpu")
    gaps = []
    for i in (0, 37, 101, 163, 199):
        f = seq.render_frame(i)
        np.testing.assert_array_equal(frames.R[i], f["R_w_c"])
        np.testing.assert_array_equal(frames.t[i], f["t_w_c"])
        same = frames.labels[i] == f["labels"]
        assert same.float().mean() >= 0.995, i
        assert torch.equal(frames.color[i][same], f["color"][same]), i
        both = same & (f["labels"] >= 0)
        gaps.append((frames.depth[i] - f["depth"])[both])
    gap = torch.cat(gaps)
    assert gap.min() >= -2e-4
    assert (gap <= 5e-3).float().mean() >= 0.99
    assert len(frames) == 200
