"""Open-set object detection: forward externally-segmented instances.

Port of `khronos_tpu/active_window/instance_forwarding.py` (the reference
InstanceForwarding detector, instance_forwarding.cpp): an upstream open-set
segmenter provides an instance image and per-instance embedding vectors; this
detector filters instances by range, pixel count, bbox volume, and the best
background-prompt similarity (skip if the max cosine to any `background`
embedding exceeds max_background_score, cpp:94-104), then attaches the
per-instance feature vectors (cpp:137-147).

The filters run as one pass on the device: per-instance stats (integer
counts; the point sums a one-hot float32 matmul, deterministic) and a
[instances x background-prompts] cosine matrix in full float32 (TF32 is off
package-wide: the scores are compared against a threshold).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from khronos_tpu_torch.active_window.motion_detection import MAX_CLUSTERS, MeasurementCluster
from khronos_tpu_torch.config import check_ge, check_gt, register
from khronos_tpu_torch.ops import clusters as cl

OPENSET_CATEGORY = -2  # semantic_category marker for open-set objects


@register("object_detector", "InstanceForwarding")
@dataclasses.dataclass
class InstanceForwardingConfig:
    min_cluster_size: int = 50  # pixels
    max_range: float = 5.0  # m
    min_bbox_volume: float = 0.0  # m^3
    max_bbox_volume: float = 10.0  # m^3
    max_background_score: float = 0.6  # cosine vs background prompts
    max_instances: int = MAX_CLUSTERS
    # embedding dimensionality for the FUSED device path (0 = taken from the
    # background embeddings when set, or features disabled)
    feature_dim: int = 0

    def check(self):
        check_gt(self.min_cluster_size, 0, "min_cluster_size")
        check_ge(self.max_background_score, 0.0, "max_background_score")

    def create(self, volume_config, camera, label_space=None):
        return InstanceForwarding(self, volume_config, camera)


def _stats_device(instances, points_w, valid, max_instances: int):
    """Per-instance (counts, sums, bb_min, bb_max) over ids 1..max_instances."""
    inst = torch.where(valid, instances, 0)  # 0 = background
    compact = torch.where((inst >= 1) & (inst <= max_instances), inst - 1, -1)
    return cl.cluster_stats(compact, points_w, max_clusters=max_instances)


def _unit_rows(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(1e-9)


def _background_scores(features: torch.Tensor, background: torch.Tensor) -> torch.Tensor:
    """Best cosine similarity of each instance feature [N, D] to any
    background-prompt embedding [B, D] (full float32)."""
    return (_unit_rows(features) @ _unit_rows(background).T).amax(dim=-1)


class InstanceForwarding:
    def __init__(self, config: InstanceForwardingConfig, volume_config, camera,
                 background_embeddings: Optional[np.ndarray] = None):
        self.config = config
        self.volume_config = volume_config
        self.camera = camera
        # `background` EmbeddingGroup (reference openset stack): prompts like
        # "wall", "floor", "ceiling" encoded by the upstream text encoder
        self.background_embeddings = background_embeddings

    def set_background_embeddings(self, embeddings: np.ndarray) -> None:
        self.background_embeddings = np.asarray(embeddings, np.float32)

    def process(self, state, frame) -> List[MeasurementCluster]:
        """Requires frame.instances ([H, W] int32 tensor, 0 = none, ids 1..N
        stable) and frame.label_features ([N, D], row i = feature of instance
        i+1)."""
        cfg = self.config
        cam = self.camera
        depth = frame.depth
        if frame.instances is None:
            frame.object_image = torch.zeros(depth.shape, dtype=torch.int32, device=depth.device)
            frame.semantic_clusters = []
            return []
        valid = (depth > cam.min_range) & (depth <= min(cam.max_range, cfg.max_range))
        points_w = cam.vertex_image_world(depth, frame.R_w_c, frame.t_w_c)
        counts, sums, bb_min, bb_max = (
            t.cpu().numpy() for t in _stats_device(frame.instances, points_w, valid, cfg.max_instances)
        )

        features = frame.label_features
        bg_scores = None
        if features is not None and self.background_embeddings is not None and len(self.background_embeddings):
            n = min(len(features), cfg.max_instances)
            bg_scores = _background_scores(
                torch.as_tensor(np.asarray(features[:n], np.float32), device=depth.device),
                torch.as_tensor(np.asarray(self.background_embeddings, np.float32), device=depth.device),
            ).cpu().numpy()

        keep_ids = np.zeros(cfg.max_instances + 1, np.int32)
        clusters: List[MeasurementCluster] = []
        next_id = 1
        for k in range(cfg.max_instances):
            if counts[k] < cfg.min_cluster_size:
                continue
            ext = np.clip(bb_max[k] - bb_min[k], 0, None)
            vol = float(np.prod(ext))
            if not (cfg.min_bbox_volume <= vol <= cfg.max_bbox_volume):
                continue
            if bg_scores is not None and k < len(bg_scores) and bg_scores[k] > cfg.max_background_score:
                continue  # looks like background per the prompt group
            feat = None
            if features is not None and k < len(features):
                feat = np.asarray(features[k], np.float32)
            clusters.append(
                MeasurementCluster(
                    cluster_id=next_id,
                    num_pixels=int(counts[k]),
                    num_voxels=0,
                    centroid=sums[k] / max(int(counts[k]), 1),
                    bbox_min=bb_min[k],
                    bbox_max=bb_max[k],
                    category_id=OPENSET_CATEGORY,
                    feature=feat,
                )
            )
            keep_ids[k + 1] = next_id
            next_id += 1
        remap = torch.from_numpy(keep_ids).to(depth.device)
        inst = frame.instances.clamp(0, cfg.max_instances)
        frame.object_image = remap[torch.where(valid, inst, 0).long()]
        frame.semantic_clusters = clusters
        return clusters
