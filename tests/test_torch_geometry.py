"""Port parity for geometry/transforms.py, geometry/bbox.py and
utils/intervals.py (mirrors tests/test_geometry.py).

Transforms: the same float32 inputs through both packages. Values agree to
2e-6 (a few ulp of rotations and translations of size one: the packages
evaluate the same formulas, but XLA fuses and reorders some of them). The
factor-graph optimizer differentiates these maps at xi = 0, inside the
Taylor branches, and the Jacobians of its residuals must be finite there and
agree with JAX's `jacfwd` (to 1e-5 of the largest entry at xi = 0), at
xi = 0 and at random xi. Boxes and
intervals are host numpy in both packages and agree exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from khronos_tpu.backend import factor_graph as jfg
from khronos_tpu.geometry import bbox as jbbox
from khronos_tpu.geometry import transforms as jtf
from khronos_tpu.utils import intervals as jiv
from khronos_tpu_torch.backend import factor_graph as tfg
from khronos_tpu_torch.geometry import bbox as tbbox
from khronos_tpu_torch.geometry import transforms as ttf
from khronos_tpu_torch.utils import intervals as tiv

import torch_parity  # noqa: F401  (one PyTorch thread per test worker)

VALUE_ATOL = 2e-6
# Jacobian tolerance relative to the largest entry, by kind of increment:
# at and near xi = 0 (the optimizer's linearisation point) the packages'
# operation orders differ by tens of ulp; random increments reach rotations
# near pi, where the log map's derivative amplifies rounding; just above the
# Taylor switch 1 - cos(theta) cancels (see se3_log below)
JACOBIAN_RTOL = {"zero": 1e-5, "tiny": 1e-5, "edge": 1e-3, "random": 1e-4}


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _close(jax_out, torch_out, atol=VALUE_ATOL):
    if isinstance(jax_out, (tuple, list)):
        for a, b in zip(jax_out, torch_out):
            _close(a, b, atol)
        return
    np.testing.assert_allclose(np.asarray(jax_out), torch_out.numpy(), rtol=0, atol=atol)


def _tangents(kind, n=16, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "zero":
        return np.zeros((n, 6), np.float32)
    if kind == "tiny":  # inside the Taylor branches (t2 < 1e-3)
        return (rng.normal(size=(n, 6)) * 1e-3).astype(np.float32)
    if kind == "edge":  # around the branch switch, theta^2 near 1e-3
        w = rng.normal(size=(n, 3))
        w = w / np.linalg.norm(w, axis=1, keepdims=True) * np.sqrt(1e-3) * rng.uniform(0.9, 1.1, (n, 1))
        return np.concatenate([rng.normal(size=(n, 3)), w], axis=1).astype(np.float32)
    w = rng.normal(size=(n, 3))
    w = w / np.linalg.norm(w, axis=1, keepdims=True) * rng.uniform(0.05, 3.0, (n, 1))
    return np.concatenate([rng.normal(size=(n, 3)), w], axis=1).astype(np.float32)


KINDS = ["zero", "tiny", "edge", "random"]


@pytest.mark.parametrize("kind", KINDS)
def test_exp_log_maps_match_reference(kind):
    xi = _tangents(kind)
    _close(jtf.hat(jnp.asarray(xi[:, 3:])), ttf.hat(_t(xi[:, 3:])))
    _close(jtf.so3_exp(jnp.asarray(xi[:, 3:])), ttf.so3_exp(_t(xi[:, 3:])))
    R, t = jtf.se3_exp(jnp.asarray(xi))
    _close((R, t), ttf.se3_exp(_t(xi)))
    _close(jtf.so3_log(R), ttf.so3_log(_t(R)))
    # se3_log's coefficient of K^2 divides by 1 - cos(theta): just above the
    # Taylor switch (theta^2 = 1e-3) float32 cancellation leaves it a relative
    # error near 1e-4, which the packages' different operation orders expose
    _close(jtf.se3_log(R, t), ttf.se3_log(_t(R), _t(t)), atol=2e-4 if kind == "edge" else 2e-5)
    assert torch.isfinite(ttf.se3_log(_t(R), _t(t))).all()


def test_pose_algebra_matches_reference():
    rng = np.random.default_rng(3)
    Ra, ta = jtf.se3_exp(jnp.asarray(_tangents("random", 8, seed=3)))
    Rb, tb = jtf.se3_exp(jnp.asarray(_tangents("random", 8, seed=4)))
    Ra, ta, Rb, tb = (np.asarray(x) for x in (Ra, ta, Rb, tb))
    pts = rng.normal(size=(8, 5, 3)).astype(np.float32)
    _close(jtf.compose(Ra, ta, Rb, tb), ttf.compose(_t(Ra), _t(ta), _t(Rb), _t(tb)))
    _close(jtf.inverse(Ra, ta), ttf.inverse(_t(Ra), _t(ta)))
    _close(jtf.between(Ra, ta, Rb, tb), ttf.between(_t(Ra), _t(ta), _t(Rb), _t(tb)))
    _close(jtf.transform_points(Ra, ta, pts), ttf.transform_points(_t(Ra), _t(ta), _t(pts)), atol=1e-5)
    for alpha in (0.0, 0.3, 1.0):
        _close(jtf.interpolate_pose(Ra[0], ta[0], Rb[0], tb[0], alpha),
               ttf.interpolate_pose(_t(Ra[0]), _t(ta[0]), _t(Rb[0]), _t(tb[0]), alpha), atol=1e-5)
    q = rng.normal(size=(6, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    _close(jtf.quat_to_rot(jnp.asarray(q)), ttf.quat_to_rot(_t(q)))
    np.testing.assert_allclose(ttf.quat_to_rot(_t([1, 0, 0, 0])).numpy(), np.eye(3), atol=1e-6)


def _poses(n, seed):
    R, t = jtf.se3_exp(jnp.asarray(_tangents("random", n, seed=seed)))
    return np.asarray(R), np.asarray(t)


@pytest.mark.parametrize("kind", KINDS)
def test_residual_jacobians_match_reference(kind):
    """The optimizer's Jacobians: jacfwd of the between and prior residuals
    w.r.t. the tangent increments, vmapped over factors, at the increments
    of `kind` (zero is the linearisation point the optimizer uses)."""
    n = 8
    (Ri, ti), (Rj, tj) = _poses(n, 10), _poses(n, 11)
    # measurements near the poses' relation (residual rotations up to 0.3
    # rad), as in a graph being optimized: far from the log map's pole at pi
    Rrel, trel = jtf.between(Ri, ti, Rj, tj)
    Rn, tn = jtf.se3_exp(jnp.asarray(_tangents("random", n, seed=12) * 0.1))
    Zr, Zt = (np.asarray(x) for x in jtf.compose(Rrel, trel, Rn, tn))
    xi, xj = _tangents(kind, n, seed=13), _tangents(kind, n, seed=14)
    jj = jax.vmap(jax.jacfwd(jfg._between_residual, argnums=(0, 1)))(xi, xj, Ri, ti, Rj, tj, Zr, Zt)
    tj_ = torch.func.vmap(torch.func.jacfwd(tfg._between_residual, argnums=(0, 1)))(
        *(_t(a) for a in (xi, xj, Ri, ti, Rj, tj, Zr, Zt)))
    for a, b in zip(jj, tj_):
        assert torch.isfinite(b).all()
        np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=0, atol=JACOBIAN_RTOL[kind] * float(np.abs(a).max()))
    jp = jax.vmap(jax.jacfwd(jfg._prior_residual))(xi, Ri, ti, Zr, Zt)
    tp = torch.func.vmap(torch.func.jacfwd(tfg._prior_residual))(*(_t(a) for a in (xi, Ri, ti, Zr, Zt)))
    assert torch.isfinite(tp).all()
    np.testing.assert_allclose(np.asarray(jp), tp.numpy(), rtol=0, atol=JACOBIAN_RTOL[kind] * float(np.abs(jp).max()))


def test_jacobians_at_identity_are_finite_and_exact():
    """All poses identity and xi = 0: theta is exactly 0 in every map, the
    case where an untaken branch's NaN would poison forward-mode AD."""
    eye, zero = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    args = (np.zeros(6, np.float32), np.zeros(6, np.float32), eye, zero, eye, zero, eye, zero)
    jj = jax.jacfwd(jfg._between_residual, argnums=(0, 1))(*args)
    tj = torch.func.jacfwd(tfg._between_residual, argnums=(0, 1))(*(_t(a) for a in args))
    for a, b in zip(jj, tj):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    np.testing.assert_array_equal(tj[1].numpy(), np.eye(6, dtype=np.float32))


def _boxes(seed, n=12):
    rng = np.random.default_rng(seed)
    mn = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    return mn, mn + rng.uniform(0.05, 1.5, (n, 3)).astype(np.float32)


@pytest.mark.parametrize("as_tensor", [False, True], ids=["numpy", "torch"])
def test_bbox_matches_reference(as_tensor):
    amin, amax = _boxes(0)
    bmin, bmax = _boxes(1)
    conv = _t if as_tensor else (lambda x: x)

    def same(a, b):
        b = b.numpy() if torch.is_tensor(b) else np.asarray(b)
        np.testing.assert_allclose(np.asarray(a), b, rtol=1e-6, atol=1e-7)

    for name in ("intersects", "intersection_volume", "iou", "merge"):
        same(np.asarray(getattr(jbbox, name)(amin, amax, bmin, bmax)),
             getattr(tbbox, name)(conv(amin), conv(amax), conv(bmin), conv(bmax)))
    same(jbbox.pairwise_iou(amin, amax, bmin, bmax), tbbox.pairwise_iou(conv(amin), conv(amax), conv(bmin), conv(bmax)))
    same(jbbox.volume(amin, amax), tbbox.volume(conv(amin), conv(amax)))
    same(jbbox.is_valid(amin, amax), tbbox.is_valid(conv(amin), conv(amax)))
    pts = np.random.default_rng(2).uniform(-2, 3, (12, 3)).astype(np.float32)
    same(jbbox.contains(amin, amax, pts), tbbox.contains(conv(amin), conv(amax), conv(pts)))
    valid = np.asarray([True, False] * 6)
    vmask = torch.from_numpy(valid) if as_tensor else valid
    for want, got in zip(jbbox.from_points(pts, valid), tbbox.from_points(conv(pts), vmask)):
        same(want, got)
    for want, got in zip(jbbox.from_points(pts), tbbox.from_points(conv(pts))):
        same(want, got)


def test_bbox_grid_candidates_match_reference():
    mins, maxs = _boxes(5, n=64)
    mins, maxs = mins * 3, maxs * 3
    jgrid, tgrid = jbbox.BboxGrid(mins, maxs), tbbox.BboxGrid(mins, maxs)
    for i in range(len(mins)):
        np.testing.assert_array_equal(jgrid.candidates(mins[i], maxs[i]), tgrid.candidates(mins[i], maxs[i]))


def test_intervals_match_reference():
    cases = [([], [], 10, 20), ([10], [20], 30, 40), ([10, 30], [20, 40], 15, 35), ([0, 50], [5, 60], 5, 50)]
    for f, l, a, b in cases:
        assert jiv.add_presence_duration(list(f), list(l), a, b) == tiv.add_presence_duration(list(f), list(l), a, b)
    f, l = [10, 30], [20, 40]
    for t in range(0, 50, 5):
        assert jiv.is_present(f, l, t) == tiv.is_present(f, l, t)
        assert jiv.has_appeared(f, t) == tiv.has_appeared(f, t)
        assert jiv.has_disappeared(f, l, t) == tiv.has_disappeared(f, l, t)
    assert jiv.clamp_intervals([0, 10], [5, 20], 3, 12) == tiv.clamp_intervals([0, 10], [5, 20], 3, 12)
    assert jiv.merge_presence([0], [5], [4], [9]) == tiv.merge_presence([0], [5], [4], [9])
    assert (jiv.first_seen(f), jiv.last_seen(l)) == (tiv.first_seen(f), tiv.last_seen(l))
