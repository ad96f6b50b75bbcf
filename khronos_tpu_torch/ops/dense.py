"""Dense 3D grid ops: separable pooling stencils and label propagation.

Port of `khronos_tpu/ops/dense.py`. These replace the reference's
voxel-neighborhood searches (spatial_hash NeighborSearch, 6/18/26
connectivity) and stack-based region growing
(free_space_motion_detector.cpp:205-272): fixed-iteration label propagation
over a dense grid instead of data-dependent flood fill.

All outputs are integer or bool and match the JAX functions bit for bit. The
borders are padded with the same values (iinfo.min/max by default).
`F.max_pool3d` takes no int32, so each axis pass is pad + three slices +
`torch.maximum`/`torch.minimum`.
"""

from __future__ import annotations

import torch


def _pool1d(x: torch.Tensor, axis: int, reducer, pad_value) -> torch.Tensor:
    """3-wide reduction window along one axis (edge-padded with pad_value)."""
    n = x.shape[axis]
    pad_shape = list(x.shape)
    pad_shape[axis] = 1
    pad = torch.full(pad_shape, pad_value, dtype=x.dtype, device=x.device)
    xp = torch.cat([pad, x, pad], dim=axis)
    lo = xp.narrow(axis, 0, n)
    hi = xp.narrow(axis, 2, n)
    return reducer(reducer(lo, x), hi)


def _default_pad(dtype: torch.dtype, lowest: bool):
    info = torch.finfo(dtype) if dtype.is_floating_point else torch.iinfo(dtype)
    return info.min if lowest else info.max


def max_pool3(x: torch.Tensor, pad_value=None) -> torch.Tensor:
    """26-neighborhood (3x3x3) max, separable. x: [..., X, Y, Z]."""
    if pad_value is None:
        pad_value = _default_pad(x.dtype, lowest=True)
    for axis in (-3, -2, -1):
        x = _pool1d(x, axis % x.ndim, torch.maximum, pad_value)
    return x


def min_pool3(x: torch.Tensor, pad_value=None) -> torch.Tensor:
    """26-neighborhood (3x3x3) min, separable."""
    if pad_value is None:
        pad_value = _default_pad(x.dtype, lowest=False)
    for axis in (-3, -2, -1):
        x = _pool1d(x, axis % x.ndim, torch.minimum, pad_value)
    return x


def all_pool3(mask: torch.Tensor, pad_value=False) -> torch.Tensor:
    """True where the full 3x3x3 neighborhood of a bool grid is True."""
    return min_pool3(mask.to(torch.uint8), pad_value=1 if pad_value else 0) > 0


def any_pool3(mask: torch.Tensor) -> torch.Tensor:
    """True where any of the 3x3x3 neighborhood is True."""
    return max_pool3(mask.to(torch.uint8), pad_value=0) > 0


def dilate(mask: torch.Tensor, iterations: int) -> torch.Tensor:
    for _ in range(iterations):
        mask = any_pool3(mask)
    return mask


def propagate_labels_3d(
    labels: torch.Tensor, growable: torch.Tensor, iterations: int
) -> torch.Tensor:
    """Connected-component growth by iterated 26-neighbor max-label propagation.

    labels: int32 grid, -1 = unlabeled (seed cells carry unique positive ids).
    growable: bool grid — cells labels may spread into (seeds should be True).
    After `iterations` rounds, connected growable regions containing >=1 seed
    share the max seed label within reach; components merge to the max label
    where they touch.

    CUDA tensors go to the hand-written kernel (ops/propagate.py,
    csrc/propagate.cu); CPU tensors to its plain PyTorch version.
    """
    from khronos_tpu_torch.ops import propagate

    return propagate.propagate_labels_3d(labels, growable, iterations)


_FACE_OFFSETS_3D = [(0, -1), (0, 1), (1, -1), (1, 1), (2, -1), (2, 1)]  # (axis, offset)


def _face_slices(shape, axis: int, o: int):
    """(dst, src) index tuples of a shift by `o` along `axis` (data moves by
    +o: out[i] = arr[i - o]); cells outside dst read the fill value."""
    n = shape[axis]
    dst = [slice(None)] * len(shape)
    src = [slice(None)] * len(shape)
    dst[axis] = slice(o, n) if o > 0 else slice(0, n + o)
    src[axis] = slice(0, n - o) if o > 0 else slice(-o, n)
    return tuple(dst), tuple(src)


def propagate_labels_keyed_3d(
    labels: torch.Tensor, key: torch.Tensor, growable: torch.Tensor, iterations: int
) -> torch.Tensor:
    """Label propagation constrained to neighbors with equal `key` (6-conn).

    Used for per-class connected components (ConnectedSemantics 3D mode,
    reference connected_semantics.cpp:70-144): labels only spread between
    voxels of the same semantic class.

    Every face contributes at least the fill -1 (a border or a key mismatch),
    so each round starts from max(lab, -1); the six neighbour-key equality
    masks are fixed and computed once."""
    lab = torch.where(growable, labels, -1)
    faces = []
    for axis, o in _FACE_OFFSETS_3D:
        dst, src = _face_slices(lab.shape, axis, o)
        faces.append((dst, src, key[dst] == key[src]))
    for _ in range(iterations):
        best = lab.clamp_min(-1)
        for dst, src, eq in faces:
            best[dst] = torch.maximum(best[dst], torch.where(eq, lab[src], -1))
        lab = torch.where(growable, best, -1)
    return lab
