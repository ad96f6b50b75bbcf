"""Port parity: backend/registration.py (GNC-TLS and robust ICP).

The cases of tests/test_registration.py, through both packages on the same
numpy inputs: the port must pass the reference test's own checks, and agree
with the reference's result. Tolerances: rotations and translations within
5e-6 (float32 sums and the 3x3 SVD of another library: a few ulp of the
clouds' few-metre scale); GNC weights within 1e-5 and the same inlier set;
RMS and inlier fraction within 1e-6."""

import numpy as np
import pytest

from khronos_tpu.backend import registration as jreg
from khronos_tpu_torch.backend import registration as treg

import torch_parity  # noqa: F401  (one PyTorch thread per test worker)
from test_registration import _angle_deg, _random_rotation

POSE_ATOL = 5e-6


def _both(fn, *args, **kwargs):
    want = [np.asarray(x) for x in getattr(jreg, fn)(*args, **kwargs)]
    got = [x.numpy() for x in getattr(treg, fn)(*args, **kwargs, device="cpu")]
    return want, got


@pytest.mark.parametrize("outlier_frac", [0.0, 0.3, 0.6])
def test_gnc_tls_matches_reference_under_outliers(outlier_frac):
    rng = np.random.default_rng(3)
    N = 300
    src = rng.uniform(-2, 2, (N, 3)).astype(np.float32)
    R_gt = _random_rotation(rng)
    t_gt = np.array([0.7, -1.2, 0.4])
    dst = src @ R_gt.T + t_gt + rng.normal(0, 0.01, (N, 3))
    n_out = int(outlier_frac * N)
    dst[:n_out] = rng.uniform(-4, 4, (n_out, 3))
    (jR, jt, jw, jrms), (R, t, w, rms) = _both("gnc_tls_register", src, dst.astype(np.float32), noise_bound=0.05)
    # the reference test's checks, on the port
    assert _angle_deg(R, R_gt) < 1.0
    assert np.linalg.norm(t - t_gt) < 0.03
    assert (w[:n_out].mean() < 0.2) if n_out else True
    assert w[n_out:].mean() > 0.8
    assert float(rms) < 0.05
    # against the reference
    np.testing.assert_allclose(R, jR, rtol=0, atol=POSE_ATOL)
    np.testing.assert_allclose(t, jt, rtol=0, atol=POSE_ATOL)
    np.testing.assert_allclose(w, jw, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(w > 0, jw > 0)
    np.testing.assert_allclose(rms, jrms, rtol=0, atol=1e-6)


def test_gnc_tls_padded_entries_match_reference():
    rng = np.random.default_rng(5)
    N, P = 200, 56
    src = rng.uniform(-1, 1, (N + P, 3)).astype(np.float32)
    R_gt = _random_rotation(rng)
    t_gt = np.array([0.2, 0.1, -0.3])
    dst = src @ R_gt.T + t_gt
    dst[N:] = 99.0  # garbage padding
    valid = np.concatenate([np.ones(N), np.zeros(P)]).astype(np.float32)
    (jR, jt, jw, _), (R, t, w, _) = _both("gnc_tls_register", src, dst.astype(np.float32), noise_bound=0.05,
                                          valid=valid)
    assert _angle_deg(R, R_gt) < 0.5
    assert w[N:].max() == 0.0
    np.testing.assert_allclose(R, jR, rtol=0, atol=POSE_ATOL)
    np.testing.assert_allclose(t, jt, rtol=0, atol=POSE_ATOL)
    np.testing.assert_array_equal(w > 0, jw > 0)


def test_gnc_tls_identity_matches_reference():
    rng = np.random.default_rng(7)
    src = rng.uniform(-1, 1, (128, 3)).astype(np.float32)
    (jR, jt, _, jrms), (R, t, _, rms) = _both("gnc_tls_register", src, src, noise_bound=0.05)
    assert _angle_deg(R, np.eye(3)) < 1e-3
    assert np.linalg.norm(t) < 1e-4
    assert float(rms) < 1e-4
    np.testing.assert_allclose(R, jR, rtol=0, atol=POSE_ATOL)
    np.testing.assert_allclose(t, jt, rtol=0, atol=POSE_ATOL)


@pytest.mark.parametrize("R0_angle", [0.0, 0.15])
def test_robust_icp_partial_overlap_matches_reference(R0_angle):
    """Plain ICP's failure mode: only part of the clouds overlap; from the
    identity and from a rotated start."""
    rng = np.random.default_rng(11)
    n = 250
    wall1 = np.stack([rng.uniform(0, 3, n), np.zeros(n), rng.uniform(0, 2, n)], 1)
    wall2 = np.stack([np.zeros(n), rng.uniform(0, 3, n), rng.uniform(0, 2, n)], 1)
    cloud = np.concatenate([wall1, wall2]).astype(np.float32)
    R_gt = _random_rotation(rng, max_angle=0.25)
    t_gt = np.array([0.15, -0.1, 0.05])
    dst = (cloud @ R_gt.T + t_gt).astype(np.float32)
    extra = np.stack([rng.uniform(4, 6, 120), rng.uniform(4, 6, 120), rng.uniform(0, 2, 120)], 1).astype(np.float32)
    src = np.concatenate([cloud, extra])
    c, s = np.cos(R0_angle), np.sin(R0_angle)
    R0 = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    t0 = np.zeros(3, np.float32)
    (jR, jt, jrms, jfrac), (R, t, rms, frac) = _both("robust_icp", src, dst, R0, t0, noise_bound=0.08)
    assert _angle_deg(R, R_gt) < 2.0
    assert np.linalg.norm(t - t_gt) < 0.08
    assert float(frac) > 0.5
    np.testing.assert_allclose(R, jR, rtol=0, atol=POSE_ATOL)
    np.testing.assert_allclose(t, jt, rtol=0, atol=POSE_ATOL)
    np.testing.assert_allclose(rms, jrms, rtol=0, atol=1e-6)
    np.testing.assert_allclose(frac, jfrac, rtol=0, atol=1e-6)


def test_weighted_horn_and_weights_match_reference():
    """The two building blocks alone: the GNC weight bands at mu from the
    schedule's start to hard TLS, and the weighted Horn solve."""
    import jax.numpy as jnp
    import torch

    rng = np.random.default_rng(17)
    r2 = rng.uniform(0, 0.02, 4096).astype(np.float32)
    c2 = np.float32(0.05) ** 2
    for mu in (np.float32(1e-3), np.float32(0.5), np.float32(3.0), np.float32(1e6)):
        want = np.asarray(jreg._gnc_tls_weights(jnp.asarray(r2), jnp.float32(mu), jnp.float32(c2)))
        got = treg._gnc_tls_weights(torch.from_numpy(r2), torch.tensor(mu), torch.tensor(c2)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(got == 1.0, want == 1.0)
        np.testing.assert_array_equal(got == 0.0, want == 0.0)
    src = rng.uniform(-2, 2, (256, 3)).astype(np.float32)
    R_gt = _random_rotation(rng).astype(np.float32)
    dst = (src @ R_gt.T + [0.3, 0.2, -0.1] + rng.normal(0, 0.01, (256, 3))).astype(np.float32)
    w = rng.uniform(0, 1, 256).astype(np.float32)
    jR, jt = (np.asarray(x) for x in jreg._weighted_horn(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w)))
    R, t = (x.numpy() for x in treg._weighted_horn(*(torch.from_numpy(a) for a in (src, dst, w))))
    np.testing.assert_allclose(R, jR, rtol=0, atol=POSE_ATOL)
    np.testing.assert_allclose(t, jt, rtol=0, atol=POSE_ATOL)
