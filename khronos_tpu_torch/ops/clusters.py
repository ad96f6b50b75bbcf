"""Cluster compaction, statistics, and point subsampling (device, fixed-shape).

Port of `khronos_tpu/ops/clusters.py`: raw propagated labels -> compact ids ->
segment-reduced stats -> renumbered id image -> per-cluster point
subsamples. Everything keeps fixed shapes and stays on the device, so the
frame step has no host sync.

Exactness against the reference: ids, counts and every integer output match
bit for bit. Centroid sums come from a one-hot float32 matmul as in the
reference (TF32 is off package-wide), so they agree to float32 rounding of a
differently ordered sum; bbox extremes and point samples are exact copies of
input values.
"""

from __future__ import annotations

from typing import Tuple

import torch

INT32_MAX = torch.iinfo(torch.int32).max


def unique_smallest(flat: torch.Tensor, k: int) -> torch.Tensor:
    """The k smallest distinct non-negative values of an int vector,
    ascending, INT32_MAX-padded (one sort + one top-k)."""
    s = torch.sort(flat).values
    first = torch.ones_like(s, dtype=torch.bool)
    first[1:] = s[1:] != s[:-1]
    cand = torch.where(first & (s >= 0), s, INT32_MAX)
    return torch.topk(cand, k, largest=False, sorted=True).values


def compact_labels(raw: torch.Tensor, max_clusters: int, num_values: int = None) -> torch.Tensor:
    """Raw int labels (-1 = none) -> compact int32 ids in [0, max_clusters), -1 none.

    Ids are assigned in ascending raw-value order; when more than max_clusters
    distinct values exist, the smallest max_clusters are kept. The table of
    distinct values is ascending, so a pixel's rank is its searchsorted
    position (the reference's compare-and-count over the table gives the same
    rank). `num_values` is accepted for interface parity and ignored."""
    del num_values
    uniq = unique_smallest(raw.reshape(-1), max_clusters)
    pos = torch.searchsorted(uniq, raw.contiguous())
    hit = uniq[pos.clamp_max(max_clusters - 1)] == raw
    return torch.where(hit & (raw >= 0), pos, -1).to(torch.int32)


def cluster_stats(
    compact: torch.Tensor,  # [H, W] ids in [0, MC) or -1
    points_w: torch.Tensor,  # [H, W, 3]
    extra: torch.Tensor = None,  # [H, W] extra int (e.g. class) -> segment max
    max_clusters: int = 32,
):
    """Per-cluster (counts, centroid_sums, bbox_min, bbox_max[, extra_max]).

    counts are an integer scatter-add (exact, and unlike bincount it never
    reads a size back from the device); sums are a [MC, N] x [N, 3] float32
    one-hot matmul (no float atomics, deterministic); bbox extremes and
    `extra` ride one segment-max (scatter_reduce amax, order-free) with
    bbox_min negated. Empty clusters carry the -inf identity (bbox_min +inf,
    bbox_max -inf) exactly like jax.ops.segment_max."""
    MC = max_clusters
    flat = compact.reshape(-1).long()
    on = flat >= 0
    seg = torch.where(on, flat, MC)
    pts = points_w.reshape(-1, 3)
    m = on[:, None]
    counts = torch.zeros(MC + 1, dtype=torch.int32, device=flat.device)
    counts = counts.scatter_add_(0, seg, torch.ones_like(seg, dtype=torch.int32))[:MC]
    onehot = (flat[:, None] == torch.arange(MC, device=flat.device)).to(torch.float32)
    sums = onehot.T @ torch.where(m, pts, 0.0)
    neg_inf = float("-inf")
    cols = [torch.where(m, pts, neg_inf), torch.where(m, -pts, neg_inf)]
    if extra is not None:
        cols.append(torch.where(on, extra.reshape(-1), -1).to(torch.float32)[:, None])
    vals = torch.cat(cols, dim=1)
    maxed = torch.full((MC + 1, vals.shape[1]), neg_inf, dtype=torch.float32, device=vals.device)
    maxed.scatter_reduce_(0, seg[:, None].expand_as(vals), vals, "amax", include_self=True)
    maxed = maxed[:MC]
    bb_max = maxed[:, 0:3]
    bb_min = -maxed[:, 3:6]
    if extra is None:
        return counts, sums, bb_min, bb_max
    # empty clusters carry -inf; map them to -1 before the int cast
    ex = torch.where(counts > 0, maxed[:, 6], -1.0).to(torch.int32)
    return counts, sums, bb_min, bb_max, ex


def filter_and_renumber(
    compact: torch.Tensor, keep: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Drop clusters where ~keep; renumber survivors 1..N (0 = background).

    Returns (id_image int32 [H, W], out_ids int32 [MC] mapping compact k -> new
    id or 0). The image lookup is one gather from [out_ids, 0]."""
    mc = keep.shape[0]
    out_ids = torch.where(keep, torch.cumsum(keep.to(torch.int32), 0, dtype=torch.int32), 0)
    lut = torch.cat([out_ids, out_ids.new_zeros(1)])
    img = lut[torch.where(compact >= 0, compact.long(), mc)]
    return img, out_ids


def exclusive_cumsum_2d(x: torch.Tensor, rows: int = 128) -> torch.Tensor:
    """Exclusive prefix sum along axis 0 of [N, C] ints, as int32 (`rows` is
    the reference's TPU blocking, which does not change the result).

    The scan runs along the contiguous axis of the transpose: CUDA's scan over
    a leading axis gives each column one thread, which at [76800, 32] takes
    about 13 ms on an H100; the returned [N, C] tensor is a transposed view."""
    del rows
    xt = x.to(torch.int32).T.contiguous()
    return (torch.cumsum(xt, 1, dtype=torch.int32) - xt).T


def exclusive_cumsum_1d(x: torch.Tensor, block: int = 1024) -> torch.Tensor:
    """Exclusive prefix sum of an int vector, as int32."""
    del block
    x = x.to(torch.int32)
    return torch.cumsum(x, 0, dtype=torch.int32) - x


def cluster_point_samples(
    compact: torch.Tensor,  # [H, W]
    points_w: torch.Tensor,  # [H, W, 3]
    k: int = 64,
    max_clusters: int = 32,
):
    """Evenly-strided subsample of up to k pixel points per cluster.

    Returns (samples [MC, k, 3], valid [MC, k]); slots [0, min(count, k))
    are filled per cluster. A pixel's rank within its cluster is a running
    count over the cluster one-hot; selected pixels land in unique slots, and
    unselected ones add zeros to a dropped row, so the index-add is exact
    and order-free."""
    MC = max_clusters
    flat = compact.reshape(-1).long()
    pts = points_w.reshape(-1, 3)
    on = flat >= 0
    oh = (flat[:, None] == torch.arange(MC, device=flat.device)).to(torch.int32)
    rank = (exclusive_cumsum_2d(oh) * oh).sum(-1, dtype=torch.int32)  # [N]
    counts = oh.sum(0, dtype=torch.int32)  # [MC]
    cnt = (counts[None, :] * oh).sum(-1, dtype=torch.int32)  # own cluster's count
    small = cnt <= k
    cnt_safe = cnt.clamp_min(1)
    slot_big = (rank * k) // cnt_safe
    sel_big = (rank == 0) | (slot_big > ((rank - 1) * k) // cnt_safe)
    slot = torch.where(small, rank, slot_big)
    sel = on & (small | sel_big) & (slot < k)
    row = torch.where(sel, flat, MC)
    col = torch.where(sel, slot.long(), 0)
    contrib = torch.where(sel[:, None], pts, 0.0)
    samples = torch.zeros(((MC + 1) * k, 3), dtype=pts.dtype, device=pts.device)
    samples = samples.index_add_(0, row * k + col, contrib).view(MC + 1, k, 3)[:MC]
    valid = torch.arange(k, device=flat.device)[None, :] < counts.clamp_max(k)[:, None]
    return torch.where(valid[..., None], samples, 0.0), valid


def compact_indices(mask_flat: torch.Tensor, capacity: int) -> torch.Tensor:
    """Indices of True elements (ascending), -1 padded, via cumsum + scatter
    (unselected elements write a dropped slot)."""
    n = mask_flat.shape[0]
    pos = exclusive_cumsum_1d(mask_flat)
    slot = torch.where(mask_flat & (pos < capacity), pos, capacity).long()
    out = torch.full((capacity + 1,), -1, dtype=torch.int32, device=mask_flat.device)
    out[slot] = torch.arange(n, dtype=torch.int32, device=mask_flat.device)
    return out[:capacity]


def compact_rows(values: torch.Tensor, mask: torch.Tensor, capacity: int) -> torch.Tensor:
    """Rows of `values` [N, D] where mask, packed ascending into
    [capacity, D] (zero padded), via cumsum + scatter."""
    pos = exclusive_cumsum_1d(mask)
    slot = torch.where(mask & (pos < capacity), pos, capacity).long()
    out = torch.zeros((capacity + 1, values.shape[1]), dtype=values.dtype, device=values.device)
    out[slot] = values
    return out[:capacity]
