"""Port parity: the synthetic sensor-noise model (data/synthetic.py).

The reference draws its noise with jax.random and the port from a
torch.Generator seeded from (noise.seed, frame index), so the two agree in
distribution only, never bit for bit. Over the same eight office frames
(96x128) rendered and noised by each package: the depth dropout rate, the
edge-pixel share, the label-flicker rate and the median depth error in each
1 m depth bin must agree within 25% of the reference's value (each is a mean
over thousands of pixels: a few percent of sampling spread), and the
flipped labels come from the 4-neighbourhood. Then the cases of
tests/test_noise.py on the port: the physical bands, the noise fixed per
frame and different between frames, and a short noisy pipeline run whose
mesh stays inside the room."""

import functools

import numpy as np
import torch

from khronos_tpu.data import synthetic as jsyn
from khronos_tpu_torch.data import synthetic as tsyn

import torch_parity  # noqa: F401  (one PyTorch thread per test worker)

RATE_RTOL = 0.25
FRAMES = range(2, 10)


def _config(mod, noise):
    return mod.SyntheticSequenceConfig(duration=2.0, height=96, width=128, fx=80, fy=80, cx=64, cy=48, noise=noise)


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


@functools.lru_cache(maxsize=None)
def _pairs(package):
    """[(clean frame, noisy frame)] of FRAMES by one package, numpy."""
    if package == "jax":
        mk = lambda nz: jsyn.SyntheticSequence(jsyn.office_scene(), _config(jsyn, nz))  # noqa: E731
        clean, noisy = mk(None), mk(jsyn.SensorNoiseConfig())
    else:
        mk = lambda nz: tsyn.SyntheticSequence(tsyn.office_scene(), _config(tsyn, nz), device="cpu")  # noqa: E731
        clean, noisy = mk(None), mk(tsyn.SensorNoiseConfig())
    out = []
    for i in FRAMES:
        c, n = clean.render_frame(i), noisy.render_frame(i)
        out.append(tuple(_np(f[k]) for f in (c, n) for k in ("depth", "labels")))
    return out


def _statistics(pairs):
    valid = drop = edge = flips = pixels = 0
    err_bins = {b: [] for b in range(5)}
    for d0, l0, d, lab in pairs:
        v = d0 > 0
        nb = np.stack([np.concatenate([d0[:1], d0[:-1]]), np.concatenate([d0[1:], d0[-1:]]),
                       np.concatenate([d0[:, :1], d0[:, :-1]], 1), np.concatenate([d0[:, 1:], d0[:, -1:]], 1)])
        e = v & (np.abs(nb - d0).max(0) > 0.10)
        valid += v.sum()
        drop += (v & (d == 0)).sum()
        edge += e.sum()
        flips += (lab != l0).sum()
        pixels += lab.size
        keep = v & ~e & (d > 0)
        for b in err_bins:
            m = keep & (d0 >= b) & (d0 < b + 1)
            err_bins[b].append(np.abs(d - d0)[m])
    errs = {b: np.concatenate(x) for b, x in err_bins.items()}
    return {"dropout": drop / valid, "edges": edge / valid, "flicker": flips / pixels,
            **{f"median_err_{b}m": float(np.median(x)) for b, x in errs.items() if len(x) > 500}}


def test_noise_statistics_match_reference():
    want, got = _statistics(_pairs("jax")), _statistics(_pairs("torch"))
    assert set(got) == set(want) and len([k for k in want if k.startswith("median")]) >= 2, (want, got)
    for k, w in want.items():
        assert abs(got[k] - w) <= RATE_RTOL * w, (k, got[k], w)


def test_noise_statistics_physical():
    """tests/test_noise.py's bands, on the port: dropout exists but does not
    wipe the frame, the depth error is in the mm-to-cm band, labels flicker
    only a little and only to labels of the clean frame."""
    d0, l0, d, lab = _pairs("torch")[1]  # frame 3
    v = d0 > 0
    drop = (v & (d == 0)).sum() / v.sum()
    assert 0.001 < drop < 0.25, drop
    err = np.abs(d - d0)[v & (d > 0)]
    assert 0.001 < np.median(err) < 0.05, np.median(err)
    flips = (lab != l0).mean()
    assert 0 < flips < 0.05, flips
    assert set(np.unique(lab)).issubset(set(np.unique(l0)))
    assert (d[~v] == 0).all()  # invalid pixels stay invalid


def test_noise_flicker_takes_a_neighbour_label():
    for d0, l0, d, lab in _pairs("torch"):
        flip = lab != l0
        nb = np.stack([np.concatenate([l0[:1], l0[:-1]]), np.concatenate([l0[1:], l0[-1:]]),
                       np.concatenate([l0[:, :1], l0[:, :-1]], 1), np.concatenate([l0[:, 1:], l0[:, -1:]], 1)])
        assert (nb == lab[None])[:, flip].any(0).all()


def test_noise_deterministic_per_frame():
    seq = tsyn.SyntheticSequence(tsyn.office_scene(), _config(tsyn, tsyn.SensorNoiseConfig()), device="cpu")
    a, b, other = seq.render_frame(3), seq.render_frame(3), seq.render_frame(4)
    assert torch.equal(a["depth"], b["depth"]) and torch.equal(a["labels"], b["labels"])
    assert not torch.equal(a["depth"], other["depth"])
    seeded = tsyn.SyntheticSequence(tsyn.office_scene(), _config(tsyn, tsyn.SensorNoiseConfig(seed=8)), device="cpu")
    assert not torch.equal(a["depth"], seeded.render_frame(3)["depth"])


def test_pipeline_survives_noise():
    """tests/test_noise.py's mini end-to-end run on the port: TSDF and mesh
    still form under sensor noise, and the map stays inside the room."""
    from khronos_tpu_torch.active_window.frame_data import FrameData
    from khronos_tpu_torch.config import build
    from khronos_tpu_torch.pipeline.pipeline import KhronosPipeline, PipelineConfig

    scene = tsyn.office_scene()
    seq = tsyn.SyntheticSequence(scene, tsyn.SyntheticSequenceConfig(
        duration=3.0, height=96, width=128, fx=80, fy=80, cx=64, cy=48, noise=tsyn.SensorNoiseConfig()), device="cpu")
    cfg = build(PipelineConfig, {
        "active_window": {
            "volumetric_map": {"grid_shape": [96, 96, 32], "voxel_size": 0.1},
            "motion_detector": {"type": "FreeSpaceMotionDetector", "min_cluster_size": 50},
            "object_detector": {"type": "ConnectedSemantics", "min_cluster_size": 30},
            "tracker": {"type": "MaxIouTracker"},
            "object_extractor": {"type": "MeshObjectExtractor"},
        },
        "label_space": {"num_classes": 8, "object_labels": [2, 3, 4, 5, 6], "dynamic_labels": [1]},
        "run_change_detection_every_n_frames": -1,
        "places": None,
    })
    pipe = KhronosPipeline(cfg, seq.camera, device="cpu")
    for i in range(seq.n_frames):
        f = seq.render_frame(i)
        pipe.process_frame(FrameData(stamp_ns=f["stamp_ns"], depth=f["depth"], color=f["color"], labels=f["labels"],
                                     R_w_c=f["R_w_c"], t_w_c=f["t_w_c"]), gt_pose=(f["R_gt"], f["t_gt"]))
    pipe.finish()
    verts = np.asarray(pipe.backend.get_dsg().mesh.vertices)
    assert len(verts) > 500, len(verts)
    c, h = scene.room_center, scene.room_half_extents
    inside = np.all(np.abs(verts - c) <= h + 0.5, axis=1).mean()
    assert inside > 0.95, inside
