"""Ray verificator: visibility evidence for long-term change detection.

Port of `khronos_tpu/changes/ray_verificator.py`, the equivalent of the
reference RayVerificator (khronos/src/backend/change_detection/
ray_verificator.cpp): agent nodes are ray sources; each background mesh
vertex spawns rays to the poses that observed it per `ray_policy` in
{First, Last, FirstAndLast, Middle, All, SampledAll, Random, Random3} over
[first_seen, last_seen - active_window_duration] (cpp:211-314). Rays are
hashed into a coarse block grid (block_size 0.5 m, step block/4,
cpp:327-349). A query point is classified against each candidate ray through
its block (cpp:66-145):

    radial distance > radial_tolerance            -> no overlap
    |ray_length - depth_along_ray| <= depth_tol   -> MATCH   (point present)
    ray_length  >  depth + depth_tol              -> ABSENT  (saw through it)
    ray_length  <  depth - depth_tol              -> occluded

The library is flat tensors on `device` (CUDA unless the caller passes
device="cpu"): ray->cell assignment materialises [R, S] stamped cell ids of a
world-anchored spatial hash (a fixed table of `hash_cells` buckets), sorted
once into a CSR index (`torch.sort(stable=True)` + `torch.searchsorted`). A
query batches P points x K candidate rays (one gather from a packed [R, 8]
ray table) and reduces evidence into per-point time-bin counters [P, B, 2]
with one integer `index_add_` (integer atomics do not depend on order, so two
card runs give the same bits). Incremental updates go to a small delta index
sharing the hash; when the delta outgrows 25% of the main index it is merged
on the device without a re-sort; a full rebuild happens only when the
optimized geometry moves (the reference's recomputeHash on loop closure,
ray_verificator.cpp:316-325).

Arithmetic follows the reference's CPU build bit for bit: the cell hash in
int32 with wraparound, the even sampling of an overflowing cell in int32
(wrapping too), jnp indexing's rule for a negative index, division by the
reference's static block size as a multiplication by its float32
reciprocal (what XLA emits) and by its traced values as a true division, and
the norms, dot products and the marching step as the fused multiply-adds
XLA's CPU build emits (`fma32`). The known hash self-collision double count
(a ray whose marched cells collide in one bucket is listed there twice) is
kept as the reference has it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from khronos_tpu_torch import fma32, resolve_device, sqrt32, true_div
from khronos_tpu_torch.config import check_gt, check_in
from khronos_tpu_torch.utils.timing import Timer


@dataclasses.dataclass
class RayVerificatorConfig:
    block_size: float = 0.5  # m coarse hash cell
    # fixed spatial-hash table size (power of two). World-anchored: any cell
    # coordinate hashes in-table, so map growth never voids the index. 2^18
    # buckets vs ~20-40k occupied cells on the largest scenes keeps the
    # collision rate (irrelevant-candidate overhead) per-mille level.
    hash_cells: int = 1 << 18
    radial_tolerance: float = 0.1  # m (point-to-ray distance)
    depth_tolerance: float = 0.15  # m (along-ray)
    # First | Last | FirstAndLast | Middle | All | SampledAll | Random |
    # Random3 (reference ray_verificator.h ray_policy enum; cpp:211-314).
    # `All` spawns a ray from EVERY in-range observing pose to the vertex,
    # as the reference does (ragged per-vertex observer lists expanded on
    # host; the CSR index build buckets the resulting ray count) —
    # `SampledAll` is the cheaper 4-evenly-spaced-observers variant.
    ray_policy: str = "Middle"
    # safety cap on observers per vertex under `All` (0 = uncapped): when a
    # vertex's stamp range covers more poses, the list is strided down to
    # this many, evenly spaced — bounds ray count on pathological dwell
    all_max_observers: int = 0
    random_seed: int = 0  # Random/Random3 observer draws (deterministic)
    active_window_duration: float = 3.0  # s excluded from the recent end
    # MINIMUM marching steps per ray; the actual count is sized from the
    # longest real ray at build time so step length stays block_size/4
    max_steps: int = 24
    max_candidates: int = 256  # rays considered per query point
    temporal_resolution: float = 5.0  # s per evidence bin (change detector)
    # MINIMUM evidence bins. The active bin count is derived from the
    # library's actual stamp span (reference discretizes over the evidence's
    # own range, ray_change_detector.cpp:66-133) so long sequences keep
    # per-bin resolution = temporal_resolution instead of clipping into the
    # last bin of a fixed [0, num_bins * temporal_resolution] horizon.
    num_bins: int = 64
    # Physical plausibility gates: observers are sampled by STAMP range, so
    # a policy can pair a vertex with a pose that could not have observed it
    # (beyond sensor range, or outside the camera frustum) — a fabricated
    # ray whose absence evidence reads through whatever actually occludes
    # it. Rays longer than max_ray_length, or more than max_ray_angle_deg
    # off the observer's forward axis, are dropped at generation. 0 disables
    # either gate; the pipeline wires the camera's max_range (+5%) and
    # diagonal half-FOV in automatically.
    max_ray_length: float = 0.0
    max_ray_angle_deg: float = 0.0

    def check(self):
        check_gt(self.block_size, 0.0, "block_size")
        assert self.hash_cells > 0 and (self.hash_cells & (self.hash_cells - 1)) == 0, (
            f"hash_cells must be a power of two, got {self.hash_cells}"
        )
        check_in(
            self.ray_policy,
            ("First", "Last", "FirstAndLast", "Middle", "All", "SampledAll",
             "Random", "Random3"),
            "ray_policy",
        )


def _f32(x: float, device) -> torch.Tensor:
    """A float32 0-dim tensor: a scalar operand rounded as the reference's
    weakly typed float32 constant."""
    return torch.tensor(x, dtype=torch.float32, device=device)


def _norm3(v: torch.Tensor) -> torch.Tensor:
    """|v| over the last axis of size 3 as the reference's ray query computes
    it on the CPU: x*x, then two fused multiply-adds, then the root."""
    x, y, z = v.unbind(-1)
    return sqrt32(fma32(z, z, fma32(y, y, x * x)))


def _take(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """values[idx] with jnp indexing's rule: a negative index counts from the
    end once, then every index clamps into range (reachable when the even
    sampling's int32 product wraps)."""
    n = values.shape[0]
    idx = idx.long()
    return values[torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)]


def _ray_cells(origins, targets, block_size: float, max_steps: int):
    """March each ray origin->target; returns ABSOLUTE int32 cell ids
    [R, S, 3] (floor(p / block_size), world-anchored).

    Fixed step = block_size/4 (reference ray_verificator.cpp:327-349), so
    sample spacing never exceeds a quarter hash cell REGARDLESS of ray
    length — the caller sizes `max_steps` from the longest real ray at
    build time. Samples past the target clamp onto the target and collapse
    into consecutive duplicates that the index builder drops.

    The reference compiles this with block_size static: its length sums
    x*x + y*y + z*z in order, its sample is one fused multiply-add, and the
    division by the constant block size is a multiplication by its float32
    reciprocal."""
    dev = origins.device
    delta = targets - origins
    dx, dy, dz = delta.unbind(-1)
    length = sqrt32(dx * dx + dy * dy + dz * dz)[:, None]  # [R, 1]
    step_len = _f32(block_size * 0.25, dev)
    dist = torch.arange(max_steps, dtype=torch.float32, device=dev)[None, :] * step_len  # [1, S]
    frac = torch.minimum(dist, length) / torch.clamp_min(length, 1e-6)  # [R, S]
    recip = _f32(float(np.float32(1.0) / np.float32(block_size)), dev)
    # one axis at a time: the float64 temporaries of fma32 stay [R, S]
    return torch.stack([
        torch.floor(fma32(delta[:, None, c], frac, origins[:, None, c]) * recip).to(torch.int32)
        for c in range(3)
    ], dim=-1)  # [R, S, 3]


# standard 3D spatial-hash primes (Teschner et al.); int32 wraparound is the
# modulo. Identical math on host (numpy) and device so both sides agree on
# every cell id.
_HP = (73856093, 19349663, 83492791)


def _hash_cells_dev(cells: torch.Tensor, num_cells: int) -> torch.Tensor:
    """Absolute int32 cell coords [..., 3] -> bucket id in [0, num_cells).
    The products stay int32 and wrap, as the reference's do."""
    h = (
        (cells[..., 0] * _HP[0])
        ^ (cells[..., 1] * _HP[1])
        ^ (cells[..., 2] * _HP[2])
    )
    return h & (num_cells - 1)


def _hash_cells_np(cells, num_cells: int):
    cells = np.asarray(cells, np.int64)
    h = (
        (cells[..., 0] * _HP[0]).astype(np.int64)
        ^ (cells[..., 1] * _HP[1]).astype(np.int64)
        ^ (cells[..., 2] * _HP[2]).astype(np.int64)
    )
    # match int32 wraparound on device before masking
    return (h.astype(np.int32) & np.int32(num_cells - 1)).astype(np.int64)


def _build_index_device(origins, targets, valid, num_cells: int, block_size: float, max_steps: int):
    """March rays into the hashed cell table and build the CSR index:
    (sorted_cells, sorted_rays, cell_start[num_cells+1]), all int32. `valid`
    masks out padding rays (their marched cells would otherwise hash into
    real buckets). A stable sort of the int32 keys gives the reference's
    stable argsort permutation."""
    C = num_cells
    cells = _ray_cells(origins, targets, block_size, max_steps)  # [R,S,3]
    lin = _hash_cells_dev(cells, C)  # [R, S]
    R, S = lin.shape
    # dedup consecutive duplicates (same cell repeated along the march)
    keep = torch.ones_like(lin, dtype=torch.bool)
    keep[:, 1:] = lin[:, 1:] != lin[:, :-1]
    keep &= valid[:, None]
    flat_cells = torch.where(keep, lin, C).reshape(-1)  # C = sentinel end
    sorted_cells, order = torch.sort(flat_cells, stable=True)
    sorted_rays = torch.div(order, S, rounding_mode="floor").to(torch.int32)
    cell_start = torch.searchsorted(
        sorted_cells, torch.arange(C + 1, dtype=torch.int32, device=lin.device)
    ).to(torch.int32)
    return sorted_cells, sorted_rays, cell_start


def _merge_sorted_device(
    a_cells, a_rays, a_cs, a_table, a_tidx,  # main index (entries + table)
    b_cells, b_rays, b_cs, b_table, b_tidx,  # delta index
    n1: int,  # main REAL ray count (delta ray ids shift by this)
    e_out: int,  # pow2-padded merged entry count
    out_bucket: int,  # pow2 merged ray-table row count (>= n1 + b rows)
    num_cells: int,
):
    """Merge two cell-sorted CSR indexes ON DEVICE without re-sorting: each
    entry's merged position is its own rank plus the other index's CSR count
    of strictly-earlier cells (one [E]-gather from a [C+1] table each), and
    the merged cell_start is the elementwise SUM of the two.

    Sentinel entries (cell == num_cells) are dropped: the output is sized by
    the real entry count. The kept positions are unique, so the writes (a
    masked `index_put_`) do not race. The tables are copied in as the
    reference's `dynamic_update_slice` places them (a start clamped so the
    block fits)."""
    C = num_cells
    dev = a_cells.device
    idx_a = torch.arange(a_cells.shape[0], dtype=torch.int32, device=dev)
    idx_b = torch.arange(b_cells.shape[0], dtype=torch.int32, device=dev)
    # a-entry before b-entries of the same cell: count b with cell < c
    pos_a = idx_a + b_cs[a_cells.clamp(0, C).long()]
    # b-entry after a-entries of cell <= c
    pos_b = idx_b + a_cs[(b_cells + 1).clamp(0, C).long()]
    keep_a = (a_cells < C) & (pos_a < e_out)
    keep_b = (b_cells < C) & (pos_b < e_out)
    out_cells = torch.full((e_out,), C, dtype=torch.int32, device=dev)
    out_rays = torch.zeros((e_out,), dtype=torch.int32, device=dev)
    pa, pb = pos_a[keep_a].long(), pos_b[keep_b].long()
    out_cells[pa] = a_cells[keep_a]
    out_cells[pb] = b_cells[keep_b]
    out_rays[pa] = a_rays[keep_a]
    out_rays[pb] = b_rays[keep_b] + n1
    out_cs = a_cs + b_cs
    table = torch.zeros((out_bucket, 8), dtype=torch.float32, device=dev)
    tidx = torch.full((out_bucket,), -1, dtype=torch.int32, device=dev)
    for dst, src, start in ((table, a_table, 0), (table, b_table, n1), (tidx, a_tidx, 0), (tidx, b_tidx, n1)):
        s = min(max(start, 0), dst.shape[0] - src.shape[0])
        dst[s: s + src.shape[0]] = src
    return out_cells, out_rays, out_cs, table, tidx


def _touched_cells_device(sorted_cells, sorted_rays, target_idx, min_target: int, num_cells: int):
    """Bool [num_cells]: cells traversed by rays whose target vertex index is
    >= min_target (sentinel entries carry cell id == num_cells)."""
    new = target_idx[sorted_rays.long()] >= min_target
    cell = sorted_cells.clamp(0, num_cells).long()
    out = torch.zeros((num_cells + 1,), dtype=torch.bool, device=sorted_cells.device)
    out[cell[new]] = True
    return out[:num_cells]


def _pack_ray_table(origins, targets, stamps_s):
    """[R, 8] f32 gather table: origin(3) ++ target(3) ++ stamp ++ pad: one
    row gather a candidate instead of three."""
    return torch.cat(
        [origins, targets, stamps_s[:, None], torch.zeros_like(stamps_s)[:, None]], dim=1
    )


def _query_device(
    points,  # [P, 3]
    sorted_rays,  # [E] int32 ray index per (ray, step) entry, cell-sorted
    cell_start,  # [C+1] CSR offsets into sorted_rays
    ray_table,  # [R, 8] packed origin/target/stamp records
    num_cells: int,
    block_size: float,
    radial_tol,  # [P] float32 tensor
    depth_tol: float,
    bin_size_s: float,
    num_bins: int,
    max_candidates: int,
):
    """Returns evidence [P, num_bins, 2] int32 (0: present/match, 1: absent),
    binned by ONE integer segment sum (`index_add_`) over the flattened
    [P*K] candidate stream (segment id = point * num_bins + bin)."""
    P = points.shape[0]
    dev = points.device
    K = max_candidates
    # block size and bin size are traced in the reference: true divisions
    pc = torch.floor(true_div(points, block_size)).to(torch.int32)
    lin = _hash_cells_dev(pc, num_cells).long()  # [P]
    start = cell_start[lin]
    end = cell_start[lin + 1]
    count_full = end - start
    count = torch.clamp_max(count_full, K)
    offs = torch.arange(K, dtype=torch.int32, device=dev)[None, :]
    # when a cell holds more rays than the cap, sample EVENLY across its
    # whole candidate list instead of truncating the prefix (entry order
    # tracks ray generation order, vertex-major, observers in time order).
    # int32 as in the reference: the product wraps past 2^31 and the floor
    # division then rounds toward -inf
    sel = torch.where(
        count_full[:, None] > K,
        torch.div(offs * count_full[:, None], K, rounding_mode="floor"),
        offs,
    )
    entry_idx = torch.clamp_max(start[:, None] + sel, sorted_rays.shape[0] - 1)
    cand_valid = offs < count[:, None]
    rays = _take(sorted_rays, entry_idx)  # [P, K]

    rec = _take(ray_table, rays)  # [P, K, 8] single gather
    o = rec[..., 0:3]
    st = rec[..., 6]
    d = rec[..., 3:6] - o
    ray_len = _norm3(d)
    dir_ = d / torch.clamp_min(ray_len, 1e-6)[..., None]
    rel = points[:, None, :] - o
    # elementwise, with the reference's fused multiply-adds; no contraction
    # on a matrix unit (a dot may round differently and flip borderline
    # radial/depth classifications)
    rx, ry, rz = rel.unbind(-1)
    ux, uy, uz = dir_.unbind(-1)
    depth = fma32(rz, uz, fma32(ry, uy, rx * ux))
    radial = _norm3(fma32(-depth[..., None], dir_, rel))

    # radial_tol per point: thin structures use a tolerance bounded by their
    # own half-extent
    tol = _f32(depth_tol, dev)
    overlap = cand_valid & (radial <= radial_tol[:, None]) & (depth > 0.0)
    match = overlap & (torch.abs(ray_len - depth) <= tol)
    absent = overlap & (ray_len > depth + tol)

    bins = torch.clamp(true_div(st, bin_size_s).to(torch.int32), 0, num_bins - 1)
    seg = (torch.arange(P, dtype=torch.int64, device=dev)[:, None] * num_bins + bins).reshape(-1)
    vals = torch.stack([match.reshape(-1), absent.reshape(-1)], dim=-1).to(torch.int32)
    ev = torch.zeros((P * num_bins, 2), dtype=torch.int32, device=dev)
    ev.index_add_(0, seg, vals)
    return ev.reshape(P, num_bins, 2)


class RayVerificator:
    """Builds the ray library from a SceneGraph and answers batched queries.

    device: where the library lives and queries run; CUDA unless the caller
    passes device="cpu" (raises when no GPU is visible)."""

    def __init__(self, config: RayVerificatorConfig, device=None):
        self.config = config
        self.device = resolve_device(device)
        self._built = False
        self._delta = None  # incremental index over new-vertex rays
        self._epoch = None
        self._V_covered = 0
        # time base: stamps are stored float32 RELATIVE to the library's
        # first agent stamp (set at full build). Epoch-scale stamps
        # (~1.7e9 s) would otherwise quantize to ~128 s in float32.
        self._t0_s: float = 0.0
        self._max_rel_s: float = 0.0
        # observability counters: full rebuilds vs incremental delta updates
        # vs delta-into-main merges
        self.n_full_builds = 0
        self.n_delta_updates = 0
        self.n_merges = 0

    @property
    def bin_origin_s(self) -> float:
        """Absolute time (s) of evidence bin 0 (the library time base)."""
        return self._t0_s

    @property
    def active_num_bins(self) -> int:
        """Bin count covering the library's actual stamp span at
        `temporal_resolution`: the config minimum, else the next power of
        two (the histogram length consumers see)."""
        cfg = self.config
        need = int(np.ceil(self._max_rel_s / cfg.temporal_resolution)) + 2
        if need <= cfg.num_bins:
            return cfg.num_bins
        return 1 << int(np.ceil(np.log2(need)))

    # ------------------------------------------------------------------
    def _generate_rays(self, dsg, v_lo: int = 0):
        """Rays for vertices [v_lo, V) per the configured policy. Returns
        (origins, targets, stamps, target_idx) or None if nothing to do."""
        cfg = self.config
        agents_t = dsg.agent_positions()  # [A, 3]
        agent_stamps = dsg.agent_stamps().astype(np.float64) * 1e-9  # s
        mesh = dsg.mesh
        V = mesh.num_vertices
        if V <= v_lo or len(agents_t) == 0:
            return None
        sl = slice(v_lo, V)
        first = mesh.first_seen_ns[sl].astype(np.float64) * 1e-9
        last = (
            mesh.last_seen_ns[sl].astype(np.float64) * 1e-9
            - cfg.active_window_duration
        )
        last = np.maximum(last, first)

        # observer selection per policy: indices into agents by stamp
        lo = np.searchsorted(agent_stamps, first)
        hi = np.maximum(np.searchsorted(agent_stamps, last, side="right") - 1, lo)
        lo = np.clip(lo, 0, len(agent_stamps) - 1)
        hi = np.clip(hi, 0, len(agent_stamps) - 1)
        nv = len(lo)
        if cfg.ray_policy == "First":
            obs = [lo]
        elif cfg.ray_policy == "Last":
            obs = [hi]
        elif cfg.ray_policy == "FirstAndLast":
            obs = [lo, hi]
        elif cfg.ray_policy == "Middle":
            obs = [(lo + hi) // 2]
        elif cfg.ray_policy in ("Random", "Random3"):
            # uniform draws in [lo, hi] per vertex (cpp:211-314); seeded so
            # rebuilds are reproducible
            rng = np.random.default_rng(cfg.random_seed)
            k = 1 if cfg.ray_policy == "Random" else 3
            span = (hi - lo + 1).astype(np.int64)
            obs = [
                lo + (rng.random(len(lo)) * span).astype(np.int64).clip(0, span - 1)
                for _ in range(k)
            ]
        elif cfg.ray_policy == "All":
            obs = None  # ragged per-vertex expansion below
        else:  # SampledAll: 4 evenly spaced observers
            obs = [lo, (2 * lo + hi) // 3, (lo + 2 * hi) // 3, hi]

        if obs is None:
            # true `All` (reference ray_verificator.cpp:211-314): one ray
            # per (vertex, in-range observing pose) pair, expanded flat on
            # the host via repeat arithmetic
            spans = (hi - lo + 1).astype(np.int64)
            take = spans
            if cfg.all_max_observers > 0:
                take = np.minimum(spans, cfg.all_max_observers)
            starts = np.cumsum(take) - take
            total = int(take.sum())
            pos = np.arange(total, dtype=np.int64) - np.repeat(starts, take)
            tk = np.repeat(take, take)
            sp = np.repeat(spans, take)
            # evenly strided when capped; identity (pos) when take == span
            off = np.where(tk > 1, (pos * (sp - 1)) // np.maximum(tk - 1, 1), 0)
            obs_flat = np.repeat(lo, take) + off
            vrel_flat = np.repeat(np.arange(nv, dtype=np.int64), take)
        else:
            obs_flat = np.concatenate(obs)
            vrel_flat = np.tile(np.arange(nv, dtype=np.int64), len(obs))
        origins = agents_t[obs_flat].astype(np.float32)
        targets = mesh.vertices[sl][vrel_flat].astype(np.float32)
        # float64 ABSOLUTE seconds here; build()/update() rebase to the
        # library time base before the float32 cast (epoch-stamp safety)
        stamps = agent_stamps[obs_flat].astype(np.float64)
        # target VERTEX index per ray: old vertices keep exactly their old
        # rays across passes (append-only mesh + frozen per-vertex stamps),
        # so "rays new since vertex count Vp" === "rays with target >= Vp" —
        # the basis for incremental re-detection (reference
        # ray_verificator.cpp:163-182 updateDsg re-observed reporting)
        target_idx = (v_lo + vrel_flat).astype(np.int32)
        ok = np.ones(len(origins), bool)
        if cfg.max_ray_length > 0:
            ok &= np.linalg.norm(targets - origins, axis=1) <= cfg.max_ray_length
        if cfg.max_ray_angle_deg > 0 and dsg.agents:
            # observer forward axis (camera z column of the body rotation)
            fwd_all = np.stack(
                [np.asarray(a.R_w_b)[:, 2] for a in dsg.agents]
            ).astype(np.float32)
            fwd = fwd_all[obs_flat]
            d = targets - origins
            dn = d / np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-6)
            cosang = np.einsum("ij,ij->i", dn, fwd)
            ok &= cosang >= np.cos(np.radians(cfg.max_ray_angle_deg))
        if not ok.all():
            origins, targets = origins[ok], targets[ok]
            stamps, target_idx = stamps[ok], target_idx[ok]
        if len(origins) == 0:
            return None
        return origins, targets, stamps, target_idx

    def build(self, dsg) -> None:
        """(Re)build the full ray library from scratch (recomputeHash path —
        after loop closures the geometry moved, cpp:316-325)."""
        with Timer("ray_verificator/generate_rays"):
            rays = self._generate_rays(dsg, 0)
        self._delta = None
        self._epoch = getattr(dsg, "opt_epoch", None)
        if rays is None:
            self._built = False
            self._V_covered = 0
            return
        origins, targets, stamps, target_idx = rays
        # time base = first agent stamp: all stored stamps become small
        # relative seconds (float32-exact to ~0.1 ms over multi-hour runs)
        self._t0_s = float(stamps.min())
        rel = (stamps - self._t0_s).astype(np.float32)
        self._max_rel_s = float(rel.max())
        self._build_index(origins, targets, rel, target_idx)
        self._V_covered = dsg.mesh.num_vertices
        self.n_full_builds += 1

    def update(self, dsg, had_loop_closure: bool = True) -> None:
        """Incremental library update (reference updateDsg,
        ray_verificator.cpp:163-182): between optimizations that MOVE
        geometry the backend mesh is append-only, so only rays targeting NEW
        vertices are added — into a small DELTA index sharing the main
        index's world-anchored hash. When the delta outgrows ~25% of the
        main index it is MERGED into the main on the device. Only a
        geometry-epoch change or a vertex-count shrink forces the full
        rebuild (recomputeHash semantics, ray_verificator.cpp:316-325); a
        loop closure is advisory (the backend's geometry epoch is the
        "geometry moved" signal)."""
        epoch = getattr(dsg, "opt_epoch", None)
        V = dsg.mesh.num_vertices
        if (
            not self._built
            or (had_loop_closure and epoch is None)
            or epoch != self._epoch
            or V < self._V_covered
        ):
            self.build(dsg)
            return
        with Timer("ray_verificator/generate_rays_delta"):
            rays = self._generate_rays(dsg, self._V_covered)
        if rays is None:
            return
        origins, targets, stamps, target_idx = rays
        # rebase onto the time base fixed at the last full build (stamps only
        # grow forward between builds, so relative values stay non-negative)
        rel = stamps - self._t0_s
        self._max_rel_s = max(self._max_rel_s, float(rel.max()))
        stamps = rel.astype(np.float32)
        if self._delta is not None:  # extend the existing delta's raw rays
            origins = np.concatenate([self._delta["raw"][0], origins])
            targets = np.concatenate([self._delta["raw"][1], targets])
            stamps = np.concatenate([self._delta["raw"][2], stamps])
            target_idx = np.concatenate([self._delta["raw"][3], target_idx])
        self._delta = self._make_index(origins, targets, stamps, target_idx)
        self._delta["raw"] = (origins, targets, stamps, target_idx)
        if len(origins) > 0.25 * max(self.num_rays, 1):
            self._merge_delta_index()
        self._V_covered = V
        self.n_delta_updates += 1

    def _merge_delta_index(self) -> None:
        """Fold the delta index into the main index entirely on device (see
        _merge_sorted_device). The time base is unchanged, so stored relative
        stamps stay valid; the merged entry and table lengths are pow2."""
        a, b = self._main, self._delta
        n1 = a["num_rays"]
        # REAL entry counts (cell_start[-1] = first sentinel position): the
        # merged array is sized by content, not by the inputs' padded shapes
        ea = int(a["cell_start"][-1])
        eb = int(b["cell_start"][-1])
        e_out = 1 << int(np.ceil(np.log2(max(ea + eb, 2))))
        rows_b = int(b["ray_table"].shape[0])
        out_bucket = 1 << int(np.ceil(np.log2(max(n1 + rows_b, 2))))
        with Timer("ray_verificator/merge_delta"):
            oc, orr, ocs, table, tidx = _merge_sorted_device(
                a["sorted_cells"], a["sorted_rays"], a["cell_start"],
                a["ray_table"], a["target_idx"],
                b["sorted_cells"], b["sorted_rays"], b["cell_start"],
                b["ray_table"], b["target_idx"],
                n1, e_out, out_bucket, self.config.hash_cells,
            )
        self._set_main(dict(
            sorted_cells=oc,
            sorted_rays=orr,
            cell_start=ocs,
            origins=table[:, 0:3],
            targets=table[:, 3:6],
            stamps_s=table[:, 6],
            ray_table=table,
            target_idx=tidx,
            num_rays=n1 + b["num_rays"],
        ))
        self.n_merges += 1

    @property
    def total_rays(self) -> int:
        """Rays across main + delta index (num_rays covers the main only)."""
        n = int(getattr(self, "num_rays", 0) or 0)
        if self._delta is not None:
            n += len(self._delta["raw"][0])
        return n

    @staticmethod
    def _bucket(n: int) -> int:
        """Round n up to the next POWER OF TWO (min 4096): the ray rows the
        index is built over. The reference buckets for its compile cache;
        the port keeps the bucket because it sets the merged index's table
        length and where delta rays land in it."""
        if n <= 4096:
            return 4096
        return 1 << int(np.ceil(np.log2(n)))

    def _make_index(self, origins, targets, stamps, target_idx):
        """Build one CSR index dict over the fixed world-anchored hash (all
        indexes share the hash by construction, so cell masks compose)."""
        cfg = self.config

        # pad rays to the bucket; padding rows carry target_idx -1 and are
        # masked out of the CSR build, so they never appear in any cell's
        # candidate list
        R_real = len(origins)
        pad = self._bucket(R_real) - R_real
        if pad:
            origins = np.concatenate([origins, np.zeros((pad, 3), np.float32)])
            targets = np.concatenate([targets, np.zeros((pad, 3), np.float32)])
            stamps = np.concatenate([stamps, np.zeros(pad, np.float32)])
            target_idx = np.concatenate([target_idx, np.full(pad, -1, np.int32)])

        # size the march so fixed step = block/4 covers the LONGEST ray
        # (reference ray_verificator.cpp:327-349 computes n_steps per ray;
        # here one count covers all, rounded up to a multiple of 16)
        lengths = np.linalg.norm(targets[:R_real] - origins[:R_real], axis=1)
        max_len = float(lengths.max()) if R_real else 0.0
        needed = int(np.ceil(max_len / (cfg.block_size * 0.25))) + 2
        steps = ((max(needed, cfg.max_steps) + 15) // 16) * 16

        dev = self.device
        origins_dev = torch.from_numpy(np.ascontiguousarray(origins, np.float32)).to(dev)
        targets_dev = torch.from_numpy(np.ascontiguousarray(targets, np.float32)).to(dev)
        stamps_dev = torch.from_numpy(np.ascontiguousarray(stamps, np.float32)).to(dev)
        tidx_dev = torch.from_numpy(np.ascontiguousarray(target_idx, np.int32)).to(dev)
        sorted_cells, sorted_rays, cell_start = _build_index_device(
            origins_dev, targets_dev, tidx_dev >= 0, cfg.hash_cells, cfg.block_size, steps,
        )
        return dict(
            sorted_cells=sorted_cells,
            sorted_rays=sorted_rays,
            cell_start=cell_start,
            origins=origins_dev,
            targets=targets_dev,
            stamps_s=stamps_dev,
            ray_table=_pack_ray_table(origins_dev, targets_dev, stamps_dev),
            target_idx=tidx_dev,
            num_rays=R_real,
        )

    def _build_index(self, origins, targets, stamps, target_idx=None):
        """Full (main) index build."""
        if target_idx is None:
            target_idx = np.arange(len(origins), dtype=np.int32)
        self._set_main(self._make_index(origins, targets, stamps, target_idx))

    def _set_main(self, idx) -> None:
        """Install `idx` as the main index; mirrors the index fields as
        attributes for existing consumers (tests)."""
        self.sorted_cells = idx["sorted_cells"]
        self.sorted_rays = idx["sorted_rays"]
        self.cell_start = idx["cell_start"]
        self.origins = idx["origins"]
        self.targets = idx["targets"]
        self.stamps_s = idx["stamps_s"]
        self.ray_table = idx["ray_table"]
        self.target_idx = idx["target_idx"]
        self.num_rays = idx["num_rays"]
        self._main = idx
        self._delta = None
        self._built = True

    # ------------------------------------------------------------------
    def _indexes(self):
        out = [self._main]
        if self._delta is not None:
            out.append(self._delta)
        return out

    def touched_cells_for_new_targets(self, min_target_idx: int) -> np.ndarray:
        """Bool [C]: hash cells traversed by rays targeting vertex indices
        >= min_target_idx (across main + delta indexes — all share the
        world-anchored hash). Basis for incremental change detection: only
        query points in touched cells can have gained evidence."""
        if not self._built:
            return np.zeros((0,), bool)
        C = self.config.hash_cells
        mask = None
        for idx in self._indexes():
            m = _touched_cells_device(
                idx["sorted_cells"], idx["sorted_rays"], idx["target_idx"], int(min_target_idx), C,
            )
            mask = m if mask is None else mask | m
        return mask.cpu().numpy()

    def point_cells(self, points: np.ndarray) -> np.ndarray:
        """Hash-bucket index per point (host math; world-anchored, so every
        point is in-table)."""
        if not self._built:
            return np.full((len(points),), -1, np.int64)
        pc = np.floor(np.asarray(points) / self.config.block_size).astype(np.int32)
        return _hash_cells_np(pc, self.config.hash_cells)

    # ------------------------------------------------------------------
    # fixed device chunk: bounds the [chunk, max_candidates, 8] geometry
    # temporaries so arbitrarily large vertex sets fit in device memory
    QUERY_CHUNK = 32768

    def query(self, points: np.ndarray, radial_tol=None, as_chunks: bool = False):
        """points [P,3] -> evidence histogram [P, B, 2] (match, absent).
        B = active_num_bins; bin b covers library-relative time
        [b, b+1) * temporal_resolution, i.e. absolute time offset by
        `bin_origin_s` (consumers must use the same origin).

        `radial_tol`: optional per-point radial tolerance [P] (defaults to
        the config scalar) — the object pass bounds it by each object's own
        thinnest extent so thin structures don't read phantom absence.

        `as_chunks=True` returns the per-chunk DEVICE tensors ([chunk, B, 2]
        each; rows past P are padding) for consumers that keep the evidence
        on the device (RayChangeDetector.scan), with P."""
        cfg = self.config
        num_bins = self.active_num_bins if self._built else cfg.num_bins
        if not self._built or len(points) == 0:
            if as_chunks:
                return [], 0
            return np.zeros((len(points), num_bins, 2), np.int32)
        points = np.asarray(points, np.float32)
        P = len(points)
        if radial_tol is None:
            tol = np.full(P, cfg.radial_tolerance, np.float32)
        else:
            tol = np.broadcast_to(
                np.asarray(radial_tol, np.float32), (P,)
            ).copy()
        # chunk = pow2 bucket of the workload, capped at QUERY_CHUNK: the
        # chunk shape is part of what consumers see (chunk lists)
        chunk = min(self.QUERY_CHUNK, max(4096, 1 << int(np.ceil(np.log2(max(P, 2))))))
        pad = (-P) % chunk
        if pad:
            points = np.concatenate([points, np.zeros((pad, 3), np.float32)])
            tol = np.concatenate([tol, np.zeros(pad, np.float32)])
        pts_all = torch.from_numpy(points).to(self.device)
        tol_all = torch.from_numpy(tol).to(self.device)
        outs = []
        for s in range(0, len(points), chunk):
            ev = None
            for idx in self._indexes():  # main + (incremental) delta
                e = _query_device(
                    pts_all[s: s + chunk],
                    idx["sorted_rays"],
                    idx["cell_start"],
                    idx["ray_table"],
                    cfg.hash_cells,
                    cfg.block_size,
                    tol_all[s: s + chunk],
                    cfg.depth_tolerance,
                    cfg.temporal_resolution,
                    num_bins,
                    cfg.max_candidates,
                )
                ev = e if ev is None else ev + e
            outs.append(ev)
        if as_chunks:
            return outs, P
        return torch.cat(outs).cpu().numpy()[:P]
