"""Offline evaluation suite, as far as the pipeline needs it: the batched
nearest-neighbour distance.

Port of `min_distances` and `_min_dists_chunk` of
`khronos_tpu/eval/evaluators.py` (the equivalents of the reference
khronos_eval evaluators). The reconciler's ChangeMerger strips background
vertices within a threshold of an object mesh with it
(`changes/reconciler.py`). The metrics (MeshEvaluator, ObjectEvaluator,
DynamicObjectEvaluator) are a later slice of the port.
"""

from __future__ import annotations

import numpy as np
import torch

from khronos_tpu_torch import fma32, resolve_device, sqrt32

# elements of one chunk's [rows, |b|] distance table (float64 temporaries of
# 128 MiB): rows per chunk shrink as b grows, so memory stays flat
_CHUNK_ELEMENTS = 1 << 24


def _min_dists_chunk(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [M, 3], b [N, 3] -> per-a min distance to b.

    The difference-of-squares form sum((a - b)^2), summed x, y, z with
    fused multiply-adds as the reference's CPU build does; the
    |a|^2 + |b|^2 - 2ab matmul form cancels, and its result decides a
    proximity threshold."""
    x, y, z = (a[:, None, :] - b[None, :, :]).unbind(-1)
    d2 = fma32(z, z, fma32(y, y, x * x))
    return sqrt32(d2.amin(dim=1))


def min_distances(a: np.ndarray, b: np.ndarray, chunk: int = 4096, device=None) -> np.ndarray:
    """Nearest-neighbor distances from each point in a to the set b.

    The reference pads `a` to whole chunks and `b` to a pow2 bucket of
    far-away sentinels for its compile cache; neither changes a distance, so
    the port pads nothing. Rows go `chunk` at a time, fewer when b is large.
    device: CUDA unless the caller passes device="cpu"."""
    dev = resolve_device(device)
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    if len(a) == 0:
        return np.zeros((0,), np.float32)
    if len(b) == 0:
        return np.full((len(a),), np.inf, np.float32)
    rows = max(1, min(chunk, _CHUNK_ELEMENTS // len(b)))
    at = torch.from_numpy(a).to(dev)
    bt = torch.from_numpy(b).to(dev)
    out = torch.cat([_min_dists_chunk(at[s: s + rows], bt) for s in range(0, len(a), rows)])
    return out.cpu().numpy()
