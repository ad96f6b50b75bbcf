"""Loop-closure detection.

Port of `khronos_tpu/backend/loop_closure.py`. The reference delegates LCD to
hydra (BoW appearance matching + object/place descriptor matching + TEASER++
registration); this module provides:

  - GtLoopClosureDetector: the oracle detector for simulation. It fires when
    the ground-truth pose revisits an earlier keyframe (position within
    max_distance after min_time_gap) and emits the GT relative pose with
    noise drawn from numpy's generator (the same numbers as the reference
    from the same seed), mapped through the port's se3_exp on the host.
  - DescriptorLoopClosureDetector: appearance-free place recognition: a
    range + height histogram of the camera-frame vertex image (on the
    device), matched by cosine similarity on the host; candidates verified
    by robust_icp (GNC-TLS, registration.py) or point-to-point ICP on
    256-point subsamples, on the device.
  - AppearanceLoopClosureDetector: a colour thumbnail + gradient-orientation
    descriptor (host numpy, as in the reference) proposes, GNC registration
    of the depth clouds verifies.
  - SceneGraphLoopClosureDetector: object constellations of the backend's
    object layer (host numpy, copied).
  - HybridLoopClosureDetector: constellation first, appearance as fallback,
    both gated by the places layer's clearance-histogram tier.

Detectors that register run it on `device` (CUDA unless the caller passes
device="cpu"); `create(device=...)` passes it on. The host decisions
(similarity ranks, thresholds, odometry gates) are the reference's, in its
order: `sims` is a numpy product on the host, the registration's inlier
fraction and RMS are pulled and compared as Python floats.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from khronos_tpu_torch import resolve_device
from khronos_tpu_torch.backend.registration import _moved, _nearest, _sq_norm, robust_icp
from khronos_tpu_torch.config import register
from khronos_tpu_torch.geometry import transforms as tf


@dataclasses.dataclass
class LoopClosure:
    from_key: int  # later keyframe (graph node id)
    to_key: int  # earlier keyframe
    R: np.ndarray  # measured relative pose from->to frame: T_from^-1 T_to
    t: np.ndarray
    score: float = 1.0
    # measurement uncertainty; None -> backend's sigma_lc_* defaults
    sigma_trans: Optional[float] = None
    sigma_rot: Optional[float] = None


@register("lcd", "GtLoopClosure")
@dataclasses.dataclass
class GtLoopClosureConfig:
    min_time_gap: float = 10.0  # s
    max_distance: float = 1.0  # m (GT positions)
    min_detection_separation: float = 5.0  # s between fired LCs
    noise_sigma_trans: float = 0.01
    noise_sigma_rot: float = 0.002
    seed: int = 0

    def create(self, device=None):
        return GtLoopClosureDetector(self)


class GtLoopClosureDetector:
    needs_frame = False  # keyframes are GT poses, no sensor data required

    def __init__(self, config: GtLoopClosureConfig):
        self.config = config
        self._keyframes: List[Tuple[int, int, np.ndarray, np.ndarray]] = []
        # (key, stamp_ns, R_gt, t_gt)
        self._last_fire_ns = -(10**18)
        self._rng = np.random.default_rng(config.seed)

    def add_keyframe(
        self, key: int, stamp_ns: int, R_gt: np.ndarray, t_gt: np.ndarray
    ) -> List[LoopClosure]:
        cfg = self.config
        out: List[LoopClosure] = []
        if stamp_ns - self._last_fire_ns >= int(cfg.min_detection_separation * 1e9):
            best = None
            for (k2, s2, R2, t2) in self._keyframes:
                if stamp_ns - s2 < int(cfg.min_time_gap * 1e9):
                    continue
                d = float(np.linalg.norm(t_gt - t2))
                if d <= cfg.max_distance and (best is None or d < best[0]):
                    best = (d, k2, R2, t2)
            if best is not None:
                _, k2, R2, t2 = best
                Rrel = R_gt.T @ R2
                trel = R_gt.T @ (t2 - t_gt)
                noise = np.concatenate(
                    [
                        self._rng.normal(0, cfg.noise_sigma_trans, 3),
                        self._rng.normal(0, cfg.noise_sigma_rot, 3),
                    ]
                ).astype(np.float32)
                Rn, tn = tf.se3_exp(torch.from_numpy(noise))
                Rrel = Rrel @ Rn.numpy()
                trel = trel + tn.numpy()
                out.append(LoopClosure(from_key=key, to_key=k2, R=Rrel, t=trel))
                self._last_fire_ns = stamp_ns
        self._keyframes.append((key, stamp_ns, R_gt.copy(), t_gt.copy()))
        return out


# ----------------------------------------------------------------------------
# Descriptor-based detector (appearance-free place recognition)
# ----------------------------------------------------------------------------


def _place_descriptor(points_c: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Rotation-sensitive place descriptor from a camera-frame vertex image:
    range histogram (16 bins to 8 m) ++ height histogram (12 bins). The bins
    count pixels (sums of 0 and 1, exact in any order)."""
    r = torch.sqrt(_sq_norm(points_c))
    rb = ((r * 2.0).to(torch.int32)).clamp(0, 15)  # r / 0.5, exact
    h = points_c[..., 1]  # camera y (down)
    hb = (((h + 3.0) * 2.0).to(torch.int32)).clamp(0, 11)
    w = valid.to(torch.float32).reshape(-1)
    rhist = torch.zeros(16, dtype=torch.float32, device=w.device).index_add_(0, rb.reshape(-1).long(), w)
    hhist = torch.zeros(12, dtype=torch.float32, device=w.device).index_add_(0, hb.reshape(-1).long(), w)
    d = torch.cat([rhist, hhist])
    return d / torch.clamp_min(torch.sqrt((d * d).sum()), 1e-6)


def _icp_point2point(src: torch.Tensor, dst: torch.Tensor, R0, t0, iters: int = 10):
    """Small point-to-point ICP: src/dst [N,3] subsampled clouds on one
    device; returns (R, t, rms) aligning src into dst frame, initialized at
    (R0, t0)."""
    R, t = R0, t0
    for _ in range(iters):
        moved = _moved(src, R, t)
        nn, _ = _nearest(moved, dst)
        target = dst[nn]
        # umeyama (no scale)
        mu_s = moved.mean(0)
        mu_t = target.mean(0)
        H = (moved - mu_s).T @ (target - mu_t)
        U, _, Vt = torch.linalg.svd(H)
        det = torch.sign(torch.linalg.det(Vt.T @ U.T))
        D = torch.diag(torch.stack([torch.ones_like(det), torch.ones_like(det), det]))
        dR = Vt.T @ D @ U.T
        dt = mu_t - dR @ mu_s
        R, t = dR @ R, dR @ t + dt
    _, d2 = _nearest(_moved(src, R, t), dst)
    rms = torch.sqrt(d2.amin(dim=1).mean())
    return R, t, rms


@register("lcd", "DescriptorLoopClosure")
@dataclasses.dataclass
class DescriptorLoopClosureConfig:
    min_time_gap: float = 10.0
    min_descriptor_similarity: float = 0.985
    min_detection_separation: float = 5.0
    max_registration_rms: float = 0.15  # m
    n_icp_points: int = 256
    # odometry-estimate gate on candidates; generous because accumulated
    # drift is exactly what a revisit looks like (a tight gate rejects the
    # true loop). <= 0 disables the gate entirely.
    max_candidate_distance: float = 10.0
    # registration slot (reference: TEASER++, uHumans2.yaml:298-307):
    # "gnc" = robust_icp with a GNC-TLS core (registration.py), "icp" = plain
    # point-to-point ICP. GNC additionally gates on inlier fraction.
    registration: str = "gnc"
    noise_bound: float = 0.07  # m, GNC-TLS truncation
    min_inlier_fraction: float = 0.35

    def check(self):
        if self.registration not in ("gnc", "icp"):
            raise ValueError(f"registration must be 'gnc' or 'icp', got {self.registration!r}")

    def create(self, device=None):
        return DescriptorLoopClosureDetector(self, device=device)


class DescriptorLoopClosureDetector:
    """Keyframe database of (descriptor, subsampled cloud); query + ICP verify.
    The descriptor and the registration run on `device`."""

    needs_frame = True  # consumes the camera-frame vertex image per keyframe

    def __init__(self, config: DescriptorLoopClosureConfig, device=None):
        self.config = config
        self.device = resolve_device(device)
        self._keys: List[int] = []
        self._stamps: List[int] = []
        self._descs: List[np.ndarray] = []
        self._clouds: List[np.ndarray] = []  # camera-frame subsamples
        self._poses: List[Tuple[np.ndarray, np.ndarray]] = []  # odom estimates
        self._last_fire_ns = -(10**18)

    def add_keyframe(
        self,
        key: int,
        stamp_ns: int,
        points_c: np.ndarray,  # [H, W, 3] camera-frame vertex image
        valid: np.ndarray,
        R_odom: np.ndarray,
        t_odom: np.ndarray,
    ) -> List[LoopClosure]:
        cfg = self.config
        desc = _place_descriptor(
            torch.from_numpy(np.array(points_c, np.float32)).to(self.device),
            torch.from_numpy(np.array(valid, bool)).to(self.device),
        ).cpu().numpy()
        pts = points_c[np.asarray(valid)]
        if len(pts) >= cfg.n_icp_points:
            sel = np.linspace(0, len(pts) - 1, cfg.n_icp_points).astype(int)
            cloud = pts[sel]
        else:
            cloud = np.zeros((cfg.n_icp_points, 3), np.float32)
        out: List[LoopClosure] = []
        if (
            self._descs
            and stamp_ns - self._last_fire_ns >= int(cfg.min_detection_separation * 1e9)
        ):
            sims = np.asarray(self._descs) @ desc
            order = np.argsort(-sims)
            for idx in order[:3]:
                if sims[idx] < cfg.min_descriptor_similarity:
                    break
                if stamp_ns - self._stamps[idx] < int(cfg.min_time_gap * 1e9):
                    continue
                R2, t2 = self._poses[idx]
                if (
                    cfg.max_candidate_distance > 0
                    and np.linalg.norm(t_odom - t2) > cfg.max_candidate_distance
                ):
                    continue
                # register candidate cloud (earlier keyframe) into current
                R0 = (R_odom.T @ R2).astype(np.float32)
                t0 = (R_odom.T @ (t2 - t_odom)).astype(np.float32)
                if cfg.registration == "gnc":
                    R, t, rms, inlier_frac = robust_icp(
                        self._clouds[idx], cloud, R0, t0, noise_bound=cfg.noise_bound, device=self.device,
                    )
                    if float(inlier_frac) < cfg.min_inlier_fraction:
                        continue
                else:
                    dev = self.device
                    R, t, rms = _icp_point2point(
                        *(torch.from_numpy(np.asarray(a, np.float32)).to(dev)
                          for a in (self._clouds[idx], cloud, R0, t0))
                    )
                if float(rms) <= cfg.max_registration_rms:
                    out.append(
                        LoopClosure(
                            from_key=key,
                            to_key=self._keys[idx],
                            R=R.cpu().numpy(),
                            t=t.cpu().numpy(),
                            score=float(sims[idx]),
                        )
                    )
                    self._last_fire_ns = stamp_ns
                    break
        self._keys.append(key)
        self._stamps.append(stamp_ns)
        self._descs.append(desc)
        self._clouds.append(cloud.astype(np.float32))
        self._poses.append((R_odom.copy(), t_odom.copy()))
        return out


# ----------------------------------------------------------------------------
# Appearance-stream detector (hydra LCD BoW-appearance analog)
# ----------------------------------------------------------------------------


def _triangle_weights(m: int, n: int) -> np.ndarray:
    """[m, n] float32 weights of jax.image.resize's "linear" method from m to
    n samples (its compute_weight_mat: the triangle kernel, widened by the
    downsampling factor, columns normalised)."""
    inv = np.float32(1.0 / (n / m))
    kscale = max(inv, np.float32(1.0))
    sample = (np.arange(n, dtype=np.float32) + np.float32(0.5)) * inv - np.float32(0.5)
    x = np.abs(sample[None, :] - np.arange(m, dtype=np.float32)[:, None]) / kscale
    w = np.maximum(np.float32(0.0), np.float32(1.0) - x)
    total = w.sum(axis=0, keepdims=True)
    eps = float(np.finfo(np.float32).eps)
    w = np.where(np.abs(total) > 1000.0 * eps, w / np.where(total != 0, total, 1), 0)
    inside = (sample >= -0.5) & (sample <= m - 0.5)
    return np.where(inside[None, :], w, 0).astype(np.float32)


def _resize_linear(img: np.ndarray, hw) -> np.ndarray:
    """jax.image.resize(img, (h, w, C), method="linear") on the host, in
    float32: each spatial axis contracted with its triangle weights. The
    reference's einsum may sum in another order (within 1e-6 of the image's
    scale, tests/test_torch_loop_closure.py)."""
    out = np.asarray(img, np.float32)
    for axis, n in enumerate(hw):
        if out.shape[axis] != n:
            w = _triangle_weights(out.shape[axis], n)
            out = np.moveaxis(np.tensordot(np.moveaxis(out, axis, -1), w, axes=1), -1, axis)
    return out.astype(np.float32)


def _gradient_signature(
    img: np.ndarray, H: int = 24, W: int = 32, cells=(3, 4), nori: int = 8
) -> np.ndarray:
    """Coarse gradient-orientation histogram (HOG-lite): unsigned edge
    orientations, magnitude-weighted, pooled over a cells grid. Invariant to
    gain/offset (gradients) and tolerant to small viewpoint shifts (coarse
    pooling) — the photometric-invariance role of the reference's ORB BoW
    features (kimera_vio bow_query, khronos.launch.yaml:49)."""
    g = _resize_linear(img, (H, W)).mean(-1)
    gy, gx = np.gradient(g)
    mag = np.hypot(gx, gy)
    ori = np.mod(np.arctan2(gy, gx), np.pi)
    ob = np.minimum((ori / np.pi * nori).astype(np.int64), nori - 1)
    ch, cw = H // cells[0], W // cells[1]
    rows = np.arange(H)[:, None] // ch
    cols = np.arange(W)[None, :] // cw
    flat = (rows * cells[1] + cols) * nori + ob
    hist = np.zeros(cells[0] * cells[1] * nori, np.float32)
    np.add.at(hist, flat.reshape(-1), mag.reshape(-1).astype(np.float32))
    n = np.linalg.norm(hist)
    return hist / n if n > 0 else hist


def _appearance_descriptor(color_small: np.ndarray, features=None) -> np.ndarray:
    """Compact per-keyframe APPEARANCE descriptor — the role of the
    reference's BoW appearance queries (khronos.launch.yaml:49 ->
    kimera_vio bow_query; hydra LCD appearance stream, uHumans2.yaml:254-307).

    Open-set path: when per-instance CLIP embeddings are available they are
    mean-pooled into the descriptor. Otherwise a two-part signature, each
    half unit-normalized (cosine = mean of the two parts' cosines):
      * 12x16 color thumbnail, per-channel mean-subtracted + L2-normalized
        — invariant to global gain and offset;
      * gradient-orientation histogram — invariant to monotonic photometric
        shifts (gamma/saturation) and tolerant to small viewpoint offsets.
    Candidates are ALWAYS verified by GNC depth registration downstream, so
    the descriptor gates recall/cost, not final precision."""
    if features is not None and len(features):
        f = np.asarray(features, np.float32).mean(axis=0)
        n = np.linalg.norm(f)
        return f / n if n > 0 else f
    img = np.asarray(color_small, np.float32)
    th = _resize_linear(img, (12, 16))
    th = th - th.mean(axis=(0, 1), keepdims=True)
    d = th.reshape(-1)
    n = np.linalg.norm(d)
    d = d / n if n > 0 else d
    grad = _gradient_signature(img)
    out = np.concatenate([d, grad]) * np.float32(np.sqrt(0.5))
    n = np.linalg.norm(out)
    return out / n if n > 0 else out


@register("lcd", "AppearanceLoopClosure")
@dataclasses.dataclass
class AppearanceLoopClosureConfig:
    min_time_gap: float = 10.0
    # recall/cost dial, not a precision gate: every candidate is verified by
    # GNC depth registration (+ inlier fraction + odometry distance), so the
    # threshold is set where PERTURBED true revisits (lighting shift, small
    # viewpoint offset) still surface in the top-3 (r4 invariance study,
    # METRICS.md)
    min_appearance_similarity: float = 0.85
    min_detection_separation: float = 5.0
    max_registration_rms: float = 0.15  # m
    n_icp_points: int = 256
    max_candidate_distance: float = 10.0  # odometry gate; <= 0 disables
    noise_bound: float = 0.07  # m, GNC-TLS truncation
    min_inlier_fraction: float = 0.35
    sigma_rot: float = 0.02

    def create(self, device=None):
        return AppearanceLoopClosureDetector(self, device=device)


class AppearanceLoopClosureDetector:
    """Keyframe database of (appearance descriptor, subsampled depth cloud).
    Appearance proposes; GNC-TLS registration of the depth clouds verifies
    and measures (registration-residual sigma on the factor). Works where
    geometric/constellation recognition fails: object-free corridors,
    geometry-ambiguous junctions."""

    needs_frame = True  # camera-frame vertex image
    needs_color = True  # + downsampled color image

    def __init__(self, config: AppearanceLoopClosureConfig, device=None):
        self.config = config
        self.device = resolve_device(device)
        self._keys: List[int] = []
        self._stamps: List[int] = []
        self._descs: List[np.ndarray] = []
        self._clouds: List[np.ndarray] = []
        self._poses: List[Tuple[np.ndarray, np.ndarray]] = []
        self._last_fire_ns = -(10**18)
        # optional places-tier veto set by the hybrid stack: (query_key,
        # candidate_key) -> bool (False rejects the candidate pre-registration)
        self.place_gate = None

    def add_keyframe(
        self,
        key: int,
        stamp_ns: int,
        points_c: np.ndarray,  # [H, W, 3] camera-frame vertex image
        valid: np.ndarray,
        color_small: np.ndarray,  # downsampled color [h, w, 3]
        R_odom: np.ndarray,
        t_odom: np.ndarray,
        features=None,  # optional per-instance open-set embeddings
    ) -> List[LoopClosure]:
        cfg = self.config
        desc = _appearance_descriptor(color_small, features)
        pts = points_c[np.asarray(valid)]
        if len(pts) >= cfg.n_icp_points:
            sel = np.linspace(0, len(pts) - 1, cfg.n_icp_points).astype(int)
            cloud = pts[sel].astype(np.float32)
        else:
            cloud = np.zeros((cfg.n_icp_points, 3), np.float32)
        out: List[LoopClosure] = []
        comparable = [
            i for i, d in enumerate(self._descs) if d.shape == desc.shape
        ]
        if comparable and stamp_ns - self._last_fire_ns >= int(
            cfg.min_detection_separation * 1e9
        ):
            sims = np.asarray([self._descs[i] @ desc for i in comparable])
            for j in np.argsort(-sims)[:3]:
                idx = comparable[j]
                if sims[j] < cfg.min_appearance_similarity:
                    break
                if stamp_ns - self._stamps[idx] < int(cfg.min_time_gap * 1e9):
                    continue
                R2, t2 = self._poses[idx]
                if (
                    cfg.max_candidate_distance > 0
                    and np.linalg.norm(t_odom - t2) > cfg.max_candidate_distance
                ):
                    continue
                if self.place_gate is not None and not self.place_gate(
                    key, self._keys[idx]
                ):
                    continue
                R0 = (R_odom.T @ R2).astype(np.float32)
                t0 = (R_odom.T @ (t2 - t_odom)).astype(np.float32)
                R, t, rms, inlier_frac = robust_icp(
                    self._clouds[idx], cloud, R0, t0, noise_bound=cfg.noise_bound, device=self.device,
                )
                if float(inlier_frac) < cfg.min_inlier_fraction:
                    continue
                if float(rms) <= cfg.max_registration_rms:
                    out.append(
                        LoopClosure(
                            from_key=key, to_key=self._keys[idx],
                            R=R.cpu().numpy(), t=t.cpu().numpy(),
                            score=float(sims[j]),
                            # measurement-grade sigma from the actual
                            # registration residual
                            sigma_trans=float(max(float(rms), 0.5 * cfg.noise_bound)),
                            sigma_rot=cfg.sigma_rot,
                        )
                    )
                    self._last_fire_ns = stamp_ns
                    break
        self._keys.append(key)
        self._stamps.append(stamp_ns)
        self._descs.append(desc)
        self._clouds.append(cloud)
        self._poses.append((R_odom.copy(), t_odom.copy()))
        return out


# ----------------------------------------------------------------------------
# Scene-graph object-descriptor detector (hydra LCD object-layer analog)
# ----------------------------------------------------------------------------


def _constellation_descriptor(
    positions: np.ndarray, labels: np.ndarray, radius: float
) -> np.ndarray:
    """Viewpoint-invariant descriptor of a labeled object constellation:
    semantic-label histogram ++ pairwise-centroid-distance histogram
    (the role of hydra LCD's object-layer descriptors, uHumans2.yaml:266-277)."""
    lab_hist = np.bincount(labels % 32, minlength=32).astype(np.float32)
    d = np.linalg.norm(positions[:, None, :] - positions[None, :, :], axis=-1)
    iu = np.triu_indices(len(positions), k=1)
    dist_hist, _ = np.histogram(d[iu], bins=16, range=(0.0, 2.0 * radius))
    desc = np.concatenate([lab_hist, dist_hist.astype(np.float32)])
    n = np.linalg.norm(desc)
    return desc / n if n > 0 else desc


def _register_constellations(
    a: np.ndarray,
    a_lab: np.ndarray,
    b: np.ndarray,
    b_lab: np.ndarray,
    R0: np.ndarray,
    t0: np.ndarray,
    noise_bound: float,
):
    """Graduated truncated-LS alignment of labeled centroid set `a` (earlier
    keyframe, local frame) onto `b` (current keyframe, local frame):
    label-gated nearest-neighbor correspondences + weighted Umeyama, with the
    inlier threshold annealed 4x -> 1x noise_bound (GNC-TLS schedule, the
    TEASER++ slot of hydra LCD registration, uHumans2.yaml:298-307).
    Returns (R, t, rms, n_inliers)."""
    R, t = R0.astype(np.float64), t0.astype(np.float64)
    gate = a_lab[:, None] != b_lab[None, :]
    inl = np.zeros(len(a), bool)
    res = np.full(len(a), np.inf)
    for thr in (4.0, 2.0, 1.5, 1.0, 1.0, 1.0):
        moved = a @ R.T + t
        d = np.linalg.norm(moved[:, None, :] - b[None, :, :], axis=-1)
        d[gate] = np.inf
        nn = np.argmin(d, axis=1)
        res = d[np.arange(len(a)), nn]
        inl = res < thr * noise_bound
        if inl.sum() < 3:
            break
        src = a[inl]
        dst = b[nn[inl]]
        mu_s, mu_d = src.mean(0), dst.mean(0)
        H = (src - mu_s).T @ (dst - mu_d)
        U, _, Vt = np.linalg.svd(H)
        D = np.diag([1.0, 1.0, np.sign(np.linalg.det(Vt.T @ U.T))])
        R = Vt.T @ D @ U.T
        t = mu_d - R @ mu_s
    n_inl = int(inl.sum())
    rms = float(np.sqrt(np.mean(res[inl] ** 2))) if n_inl else float("inf")
    return R.astype(np.float32), t.astype(np.float32), rms, n_inl


@register("lcd", "SceneGraphLoopClosure")
@dataclasses.dataclass
class SceneGraphLoopClosureConfig:
    """Object-layer place recognition over the scene graph: keyframes are
    described by the constellation of nearby recently-detected objects and
    verified by robust registration of the two constellations. Needs no GT,
    no depth frame, and no appearance vocabulary — the analog of hydra LCD's
    scene-graph descriptor path (uHumans2.yaml:254-307)."""

    radius: float = 8.0  # m: objects within this range of the keyframe
    obs_window: float = 5.0  # s: |detected - keyframe stamp| for membership
    min_objects: int = 3
    min_time_gap: float = 10.0
    min_descriptor_similarity: float = 0.7
    min_detection_separation: float = 5.0
    # registration gates
    noise_bound: float = 0.3  # m (object-centroid uncertainty)
    min_inliers: int = 3
    max_registration_rms: float = 0.4  # m
    # odometry-estimate candidate gate; <= 0 disables
    max_candidate_distance: float = 15.0

    def check(self):
        if self.obs_window >= self.min_time_gap:
            raise ValueError(
                "obs_window must be < min_time_gap or first-visit objects leak "
                "into the re-visit constellation"
            )

    def create(self, device=None):
        return SceneGraphLoopClosureDetector(self)


class SceneGraphLoopClosureDetector:
    """Keyframe database over the object layer. Constellations are built
    LAZILY (refreshed every call) because object extraction lags the frame
    stream by the active-window duration — a keyframe's nearby objects only
    materialize a few seconds after the keyframe itself. Pending (recent)
    keyframes are therefore retried each call until their constellation is
    complete enough to match."""

    needs_frame = False
    needs_scene = True  # consumes the backend's object layer per keyframe

    def __init__(self, config: SceneGraphLoopClosureConfig):
        self.config = config
        self._kfs: List[Tuple[int, int, np.ndarray, np.ndarray]] = []
        # (key, stamp_ns, R_odom, t_odom)
        self._matched: set = set()  # keyframe indices already fired or expired
        self._last_fire_ns = -(10**18)
        # keyframe index -> frozen (constellation, descriptor): membership
        # gates on |detected_ns - stamp| <= obs_window and detected_ns is
        # fixed once set, so constellations of keyframes older than the
        # pending window are immutable — caching them keeps add_keyframe
        # O(pending x objects) instead of O(keyframes x objects) per call
        self._frozen: Dict[int, Tuple] = {}
        # optional places-tier veto set by the hybrid stack (see
        # PlacesGateConfig): (query_key, candidate_key) -> bool
        self.place_gate = None

    def _constellation(self, stamp_ns: int, t_odom: np.ndarray, objects):
        cfg = self.config
        w = int(cfg.obs_window * 1e9)
        pos, lab = [], []
        for o in objects:
            if o.is_dynamic:
                continue
            if abs(o.detected_ns() - stamp_ns) > w:
                continue
            p = o.position()
            if np.linalg.norm(p - t_odom) > cfg.radius:
                continue
            pos.append(p)
            lab.append(o.semantic_category)
        if not pos:
            return np.zeros((0, 3), np.float32), np.zeros((0,), np.int32)
        return np.stack(pos).astype(np.float32), np.asarray(lab, np.int32)

    def add_keyframe(
        self,
        key: int,
        stamp_ns: int,
        R_odom: np.ndarray,
        t_odom: np.ndarray,
        objects,
    ) -> List[LoopClosure]:
        cfg = self.config
        self._kfs.append((key, stamp_ns, R_odom.copy(), t_odom.copy()))
        out: List[LoopClosure] = []
        if stamp_ns - self._last_fire_ns < int(cfg.min_detection_separation * 1e9):
            return out
        gap = int(cfg.min_time_gap * 1e9)
        pend_w = int((cfg.obs_window + 2.0) * 1e9)

        # constellations per keyframe: pending (recent) keyframes rebuild
        # each call because objects arrive late; older ones come from the
        # frozen cache (their membership window has closed)
        cons, descs = [], []
        for i, (_, s, _, t) in enumerate(self._kfs):
            hit = self._frozen.get(i)
            if hit is not None:
                c, d = hit
            else:
                c = self._constellation(s, t, objects)
                d = (
                    _constellation_descriptor(c[0], c[1], cfg.radius)
                    if len(c[0]) >= cfg.min_objects
                    else None
                )
                if stamp_ns - s > pend_w:
                    self._frozen[i] = (c, d)
            cons.append(c)
            descs.append(d)

        for qi in range(len(self._kfs) - 1, -1, -1):
            qkey, qstamp, qR, qt = self._kfs[qi]
            if stamp_ns - qstamp > pend_w:
                break  # older keyframes already had their full retry window
            if qi in self._matched or descs[qi] is None:
                continue
            qdesc = descs[qi]
            qpos, qlab = cons[qi]
            best = None
            for ci in range(qi):
                ckey, cstamp, cR, ct = self._kfs[ci]
                if qstamp - cstamp < gap or descs[ci] is None:
                    continue
                if (
                    cfg.max_candidate_distance > 0
                    and np.linalg.norm(qt - ct) > cfg.max_candidate_distance
                ):
                    continue
                if self.place_gate is not None and not self.place_gate(qkey, ckey):
                    continue
                sim = float(qdesc @ descs[ci])
                if sim >= cfg.min_descriptor_similarity and (
                    best is None or sim > best[0]
                ):
                    best = (sim, ci)
            if best is None:
                continue
            sim, ci = best
            ckey, cstamp, cR, ct = self._kfs[ci]
            cpos, clab = cons[ci]
            # local (sensor-relative) constellations: drift cancels within
            # each visit because objects were mapped from that visit's poses
            a = (cpos - ct) @ cR  # earlier, in earlier keyframe frame
            b = (qpos - qt) @ qR  # current, in current keyframe frame
            R0 = qR.T @ cR
            t0 = qR.T @ (ct - qt)
            R, t, rms, n_inl = _register_constellations(
                a, clab, b, qlab, R0, t0, cfg.noise_bound
            )
            if n_inl >= cfg.min_inliers and rms <= cfg.max_registration_rms:
                out.append(
                    LoopClosure(
                        from_key=qkey, to_key=ckey, R=R, t=t, score=sim,
                        # centroid-grade measurement: sigma from the actual
                        # registration residual, floored at half noise_bound
                        sigma_trans=float(max(rms, 0.5 * cfg.noise_bound)),
                        sigma_rot=0.03,
                    )
                )
                self._matched.add(qi)
                self._last_fire_ns = stamp_ns
                break
        return out


# ----------------------------------------------------------------------------
# Places-layer descriptor tier (hydra LCD places path)
# ----------------------------------------------------------------------------


@dataclasses.dataclass
class PlacesGateConfig:
    """Places-layer descriptor tier of the LCD cascade — the analog of hydra
    LCD's place descriptors (clearance histogram `place_histogram_config:
    {min: 0.5, max: 2.5, bins: 30}` over places within a fixed radius,
    L1-matched; reference uHumans2.yaml:262,288-296).

    Persistent place nodes are shared between visits, so registering them
    against themselves carries no drift information — as in hydra, the
    places tier GATES candidate matches top-down; the relative pose comes
    from the object/agent-level registration of the stream it gates."""

    radius: float = 8.0  # m (hydra places_extraction max_radius_m: 13)
    hist_min: float = 0.5  # m (place_histogram_config.min)
    hist_max: float = 2.5  # m (place_histogram_config.max)
    hist_bins: int = 30  # (place_histogram_config.bins)
    min_places: int = 4  # below this the tier abstains (gate passes)
    # score = 1 - 0.5 * ||a - b||_1 on sum-normalized histograms, in [0, 1]
    # (hydra `type: L1`, places min_score 0.2). Chosen from the r4 gate
    # study (scripts/places_gate_study.py): live true-pair scores ranged
    # 0.58-0.75 once descriptors freeze on layer MATURITY, but the round-3
    # 0.35 default false-vetoed premature run-start descriptors — hydra's
    # 0.2 keeps the measured false-veto rate at 0 while still rejecting
    # clearance-profile-distinct contexts (corridor vs open room ~= 0.0-0.1).
    min_score: float = 0.2


def _place_layer_descriptor(
    positions: np.ndarray, clearances: np.ndarray, center: np.ndarray,
    cfg: PlacesGateConfig,
) -> Optional[np.ndarray]:
    """Clearance histogram of the place nodes within `radius` of a keyframe;
    None when the local places layer is too thin to describe (gate abstains)."""
    if positions is None or len(positions) == 0:
        return None
    d = np.linalg.norm(np.asarray(positions, np.float32) - center[None, :], axis=1)
    m = d <= cfg.radius
    if int(m.sum()) < cfg.min_places:
        return None
    hist, _ = np.histogram(
        np.asarray(clearances, np.float32)[m], bins=cfg.hist_bins,
        range=(cfg.hist_min, cfg.hist_max),
    )
    h = hist.astype(np.float32)
    n = float(h.sum())
    if n == 0:
        # every in-radius clearance fell outside [hist_min, hist_max]: an
        # all-zero vector would score a meaningless constant against any
        # normalized histogram — abstain instead (r4 advisor fix)
        return None
    return h / n


def _place_descriptor_score(a: Optional[np.ndarray], b: Optional[np.ndarray]) -> float:
    """L1 match score in [0, 1]; 1.0 (abstain/pass) when either side is
    undescribed — the tier only vetoes when BOTH keyframes have a local
    places context to compare."""
    if a is None or b is None:
        return 1.0
    return float(1.0 - 0.5 * np.abs(a - b).sum())


# ----------------------------------------------------------------------------
# Hybrid detector: constellation + appearance fallback (full hydra LCD stack)
# ----------------------------------------------------------------------------


@register("lcd", "HybridLoopClosure")
@dataclasses.dataclass
class HybridLoopClosureConfig:
    """The full hydra-LCD stack analog (uHumans2.yaml:254-307): scene-graph
    object-constellation matching PLUS an appearance stream. The
    constellation detector is consulted first (objects are the stronger
    signal); when the revisit frustum carries no usable constellation
    (object-free corridor, ambiguous geometry) the appearance stream still
    closes the loop."""

    constellation: "SceneGraphLoopClosureConfig" = dataclasses.field(
        default_factory=lambda: SceneGraphLoopClosureConfig()
    )
    appearance: AppearanceLoopClosureConfig = dataclasses.field(
        default_factory=AppearanceLoopClosureConfig
    )
    # places-layer descriptor tier (hydra LCD's place path): gates BOTH
    # streams' candidates top-down when the pipeline wires a places layer in;
    # abstains (passes) for keyframes with no local places context. None
    # disables the tier entirely.
    places: Optional[PlacesGateConfig] = dataclasses.field(
        default_factory=PlacesGateConfig
    )

    def check(self):
        self.constellation.check()

    def create(self, device=None):
        return HybridLoopClosureDetector(self, device=device)


class HybridLoopClosureDetector:
    needs_frame = True
    needs_color = True
    needs_scene = True
    needs_places = True  # consumes (positions, clearances) of the places layer

    def __init__(self, config: HybridLoopClosureConfig, device=None):
        self.config = config
        self.constellation = SceneGraphLoopClosureDetector(config.constellation)
        self.appearance = AppearanceLoopClosureDetector(config.appearance, device=device)
        self.constellation_fires = 0
        self.appearance_fires = 0
        # key -> places-layer descriptor (None = undescribed at that keyframe)
        self._place_descs: Dict[int, Optional[np.ndarray]] = {}
        # recent keyframes re-describe each call: the places layer
        # materializes behind the frame stream (mesh archival lag), so a
        # keyframe's local places only exist a few seconds after it
        self._place_pending: List[Tuple[int, int, np.ndarray]] = []  # (key, stamp, t)
        self.place_gate_rejections = 0
        # gate-efficacy audit trail (r4 task 8): every gate decision as
        # (query_key, cand_key, score, passed, described) — `described` =
        # both sides had a usable places context (score is real, not an
        # abstention). Tests join keys against GT positions to assert the
        # false-veto rate on true loops is zero.
        self.place_gate_events: List[Tuple[int, int, float, bool, bool]] = []
        self._geom_epoch = None
        if config.places is not None:
            self.constellation.place_gate = self._place_gate
            self.appearance.place_gate = self._place_gate

    def on_geometry_epoch(self, epoch) -> None:
        """An optimization MOVED geometry: stored place descriptors were
        computed at raw odometry positions against the (now moved)
        world-frame places layer — invalidate them so the gate abstains on
        stale context instead of vetoing true loops under drift (r4 advisor
        fix). Keyframes still inside the pending horizon re-describe on the
        next call that carries a places snapshot."""
        if self._geom_epoch is not None and epoch != self._geom_epoch:
            pending = {p[0] for p in self._place_pending}
            for k in list(self._place_descs):
                if k not in pending:
                    self._place_descs[k] = None
        self._geom_epoch = epoch

    def _place_gate(self, query_key: int, cand_key: int) -> bool:
        a = self._place_descs.get(query_key)
        b = self._place_descs.get(cand_key)
        score = _place_descriptor_score(a, b)
        ok = score >= self.config.places.min_score
        if not ok:
            self.place_gate_rejections += 1
        self.place_gate_events.append(
            (query_key, cand_key, float(score), ok, a is not None and b is not None)
        )
        return ok

    def add_keyframe(
        self,
        key: int,
        stamp_ns: int,
        points_c: np.ndarray,
        valid: np.ndarray,
        color_small: np.ndarray,
        R_odom: np.ndarray,
        t_odom: np.ndarray,
        objects=(),
        features=None,
        places=None,  # optional (positions [P,3], clearances [P]) snapshot
    ) -> List[LoopClosure]:
        if self.config.places is not None:
            # enqueue unconditionally (r4 advisor fix): a keyframe arriving
            # while the places layer is still empty/unwired must be described
            # once the layer materializes within the horizon, not abstain
            # forever
            self._place_pending.append(
                (key, stamp_ns, np.asarray(t_odom, np.float32), None, stamp_ns)
            )
            horizon = int((self.config.constellation.obs_window + 2.0) * 1e9)
            keep = []
            for k, s, t, ref_desc, ref_stamp in self._place_pending:
                if places is not None:
                    d = _place_layer_descriptor(
                        places[0], places[1], t, self.config.places
                    )
                    self._place_descs[k] = d
                else:
                    d = self._place_descs.get(k)
                # maturity freeze (r4 gate-efficacy study): the places layer
                # materializes behind the frame stream, so a descriptor
                # frozen on a fixed age can capture a premature local layer
                # (measured: run-start keyframes scored 0.18-0.2 against
                # their own revisit and false-vetoed the true loop). Keep
                # refreshing until the descriptor has been STABLE for a full
                # horizon, hard-capped at 4x horizon.
                changed = (
                    (d is None) != (ref_desc is None)
                    or (
                        d is not None and ref_desc is not None
                        and float(np.abs(d - ref_desc).sum()) >= 0.1
                    )
                )
                if changed:
                    ref_desc, ref_stamp = d, stamp_ns
                age, stable_for = stamp_ns - s, stamp_ns - ref_stamp
                if age <= horizon or (stable_for < horizon and age <= 4 * horizon):
                    keep.append((k, s, t, ref_desc, ref_stamp))
            self._place_pending = keep
        lcs = self.constellation.add_keyframe(key, stamp_ns, R_odom, t_odom, objects)
        if lcs:
            self.constellation_fires += len(lcs)
            # keep the appearance database in sync (store-only, no fire)
            app = self.appearance
            fire_guard = app._last_fire_ns
            app._last_fire_ns = stamp_ns  # suppress a duplicate same-frame LC
            app.add_keyframe(
                key, stamp_ns, points_c, valid, color_small, R_odom, t_odom, features
            )
            app._last_fire_ns = max(fire_guard, stamp_ns)
            return lcs
        lcs = self.appearance.add_keyframe(
            key, stamp_ns, points_c, valid, color_small, R_odom, t_odom, features
        )
        if lcs:
            self.appearance_fires += len(lcs)
        return lcs
