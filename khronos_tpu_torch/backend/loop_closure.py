"""Loop-closure detection.

Port of the ground-truth part of `khronos_tpu/backend/loop_closure.py`:
`GtLoopClosureDetector` is the oracle detector for simulation. It fires when
the ground-truth pose revisits an earlier keyframe (position within
max_distance after min_time_gap) and emits the GT relative pose with noise
drawn from numpy's generator (the same numbers as the reference from the
same seed), mapped through the port's se3_exp on the host.

The other detectors (DescriptorLoopClosure, AppearanceLoopClosure,
SceneGraphLoopClosure, HybridLoopClosure with its PlacesGate tier) and their
registration (`registration.py`) are later slices of the port: their configs
are registered here, so one config file builds both packages, and `create`
raises NotImplementedError.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

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

    def create(self):
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


def _not_ported(name: str):
    return NotImplementedError(
        f"{name} is not ported yet (a later slice: loop_closure.py's detectors and registration.py)"
    )


@register("lcd", "DescriptorLoopClosure")
@dataclasses.dataclass
class DescriptorLoopClosureConfig:
    min_time_gap: float = 10.0
    min_descriptor_similarity: float = 0.985
    min_detection_separation: float = 5.0
    max_registration_rms: float = 0.15  # m
    n_icp_points: int = 256
    max_candidate_distance: float = 10.0
    registration: str = "gnc"
    noise_bound: float = 0.07  # m, GNC-TLS truncation
    min_inlier_fraction: float = 0.35

    def check(self):
        if self.registration not in ("gnc", "icp"):
            raise ValueError(f"registration must be 'gnc' or 'icp', got {self.registration!r}")

    def create(self):
        raise _not_ported("DescriptorLoopClosure")


@register("lcd", "AppearanceLoopClosure")
@dataclasses.dataclass
class AppearanceLoopClosureConfig:
    min_time_gap: float = 10.0
    min_appearance_similarity: float = 0.85
    min_detection_separation: float = 5.0
    max_registration_rms: float = 0.15  # m
    n_icp_points: int = 256
    max_candidate_distance: float = 10.0  # odometry gate; <= 0 disables
    noise_bound: float = 0.07  # m, GNC-TLS truncation
    min_inlier_fraction: float = 0.35
    sigma_rot: float = 0.02

    def create(self):
        raise _not_ported("AppearanceLoopClosure")


@register("lcd", "SceneGraphLoopClosure")
@dataclasses.dataclass
class SceneGraphLoopClosureConfig:
    radius: float = 8.0  # m: objects within this range of the keyframe
    obs_window: float = 5.0  # s: |detected - keyframe stamp| for membership
    min_objects: int = 3
    min_time_gap: float = 10.0
    min_descriptor_similarity: float = 0.7
    min_detection_separation: float = 5.0
    noise_bound: float = 0.3  # m (object-centroid uncertainty)
    min_inliers: int = 3
    max_registration_rms: float = 0.4  # m
    max_candidate_distance: float = 15.0

    def check(self):
        if self.obs_window >= self.min_time_gap:
            raise ValueError("obs_window must be < min_time_gap")

    def create(self):
        raise _not_ported("SceneGraphLoopClosure")


@dataclasses.dataclass
class PlacesGateConfig:
    """Places-layer descriptor tier of the hybrid detector (hydra LCD's
    place descriptors, uHumans2.yaml:262,288-296)."""

    radius: float = 8.0  # m
    hist_min: float = 0.5  # m
    hist_max: float = 2.5  # m
    hist_bins: int = 30
    min_places: int = 4  # below this the tier abstains (gate passes)
    min_score: float = 0.2


@register("lcd", "HybridLoopClosure")
@dataclasses.dataclass
class HybridLoopClosureConfig:
    constellation: SceneGraphLoopClosureConfig = dataclasses.field(
        default_factory=SceneGraphLoopClosureConfig
    )
    appearance: AppearanceLoopClosureConfig = dataclasses.field(
        default_factory=AppearanceLoopClosureConfig
    )
    places: Optional[PlacesGateConfig] = dataclasses.field(default_factory=PlacesGateConfig)

    def check(self):
        self.constellation.check()

    def create(self):
        raise _not_ported("HybridLoopClosure")
