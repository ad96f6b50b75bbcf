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


def propagate_labels_2d(
    labels: torch.Tensor, growable: torch.Tensor, iterations: int, full_connectivity: bool = True
) -> torch.Tensor:
    """2D variant (image connected components), 8- or 4-connected."""
    lab = torch.where(growable, labels, -1)
    for _ in range(iterations):
        if full_connectivity:
            spread = _pool1d(_pool1d(lab, 0, torch.maximum, -1), 1, torch.maximum, -1)
        else:
            spread = torch.maximum(
                _pool1d(lab, 0, torch.maximum, -1), _pool1d(lab, 1, torch.maximum, -1)
            )
        lab = torch.where(growable, torch.maximum(lab, spread), -1)
    return lab


def compact_labels(labels_flat: torch.Tensor, max_clusters: int):
    """Map arbitrary int labels (-1 = none) to compact ids [0, max_clusters).

    Returns (compact_labels_flat, unique_labels[max_clusters] with -1 fill,
    n_clusters): the reference's `jnp.unique(size=max_clusters + 1)` keeps
    the max_clusters + 1 smallest distinct values (-1 among them when
    present), and n counts the non-negative ones among those."""
    from khronos_tpu_torch.ops.clusters import INT32_MAX

    vals = torch.unique(labels_flat)  # sorted ascending
    uniq = vals[: max_clusters + 1]
    is_real = uniq >= 0
    n = is_real.sum(dtype=torch.int32)
    reals = torch.full((max_clusters + 1,), INT32_MAX, dtype=labels_flat.dtype, device=labels_flat.device)
    real_vals = uniq[is_real]
    reals[: real_vals.shape[0]] = real_vals
    idx = torch.searchsorted(reals, labels_flat.contiguous()).clamp(0, max_clusters - 1)
    hit = reals[idx] == labels_flat
    compact = torch.where((labels_flat >= 0) & hit, idx, -1).to(torch.int32)
    head = reals[:max_clusters]
    uniq_out = torch.where(head == INT32_MAX, -1, head).to(torch.int32)
    return compact, uniq_out, n


_OFFSETS_2D_8 = [(di, dj) for di in (-1, 0, 1) for dj in (-1, 0, 1) if (di, dj) != (0, 0)]
_OFFSETS_2D_4 = [(-1, 0), (1, 0), (0, -1), (0, 1)]


def _shift_slices_2d(shape, off):
    """(dst, src) index tuples of a 2D shift by `off` (data moves by +off)."""
    dst, src = [], []
    for axis, o in enumerate(off):
        n = shape[axis]
        dst.append(slice(o, n) if o > 0 else slice(0, n + o))
        src.append(slice(0, n - o) if o > 0 else slice(-o, n))
    return tuple(dst), tuple(src)


def propagate_labels_keyed_2d(
    labels: torch.Tensor,
    key: torch.Tensor,
    growable: torch.Tensor,
    iterations: int,
    full_connectivity: bool = True,
) -> torch.Tensor:
    """2D image variant (ConnectedSemantics 2D mode, 4/8-connectivity).

    As in the 3D keyed propagation, every neighbour contributes at least the
    fill -1, and the neighbour-key equality masks are computed once."""
    lab = torch.where(growable, labels, -1)
    offsets = _OFFSETS_2D_8 if full_connectivity else _OFFSETS_2D_4
    nbrs = []
    for off in offsets:
        dst, src = _shift_slices_2d(lab.shape, off)
        nbrs.append((dst, src, key[dst] == key[src]))
    for _ in range(iterations):
        best = lab.clamp_min(-1)
        for dst, src, eq in nbrs:
            best[dst] = torch.maximum(best[dst], torch.where(eq, lab[src], -1))
        lab = torch.where(growable, best, -1)
    return lab
