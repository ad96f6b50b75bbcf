"""Device-mesh sharding of the active-window map, in one process.

Port of `khronos_tpu/parallel/sharding.py`. The reference shards the dense
voxel grid SPATIALLY over a 1D device mesh ("x" = the grid's leading axis)
with `NamedSharding`, and XLA partitions the step: elementwise work per
shard, halo exchanges (collective-permutes) for the 3x3x3 stencils. Here the
same layout is explicit:

- a `Mesh` is an ordered tuple of torch devices, one per shard, as the
  reference's `make_mesh(n)` takes `jax.devices()[:n]`: the visible cards
  in order, from the window's card on (a device may hold several shards:
  with fewer cards than shards they go round-robin, where the reference
  shrinks the mesh; N shards on one card are the counterpart of the
  reference's virtual CPU devices);
- a `ShardedVolume` holds the grid as N slabs of `X / N` x-planes, slab i on
  shard i's device, each a `VolumeState` whose origin is the global origin
  plus (i * X / N, 0, 0); the global origin is replicated;
- every grid operation with a reach of r planes (a 3x3x3 pool has reach 1,
  k rounds of label propagation reach k) runs on its slab extended by r
  planes from the neighbours, as many slabs away as r needs, and keeps the
  slab's interior. This is exact by construction: a cell's result depends
  only on cells within r of it, and the extension holds all of them (at the
  grid's ends the extension stops, and the op pads as it does on one grid);
- the pixel side of the frame step (the cluster statistics included) runs
  once, on the mesh's first device; pixels scatter into, and read from, the
  slab that owns their voxel.

Kernels A and B run per slab: a CUDA slab goes to them, on the slab's card,
and a CPU slab to their plain versions, as every tensor does. Results equal
the unsharded step's with cropping off.

`DenseGrid` (fused_step.py) and `SlabGrid` here are the two layouts of the
volume; the fused step and the window are written once against either.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from khronos_tpu_torch.active_window import fused_step as fs
from khronos_tpu_torch.map import active_volume as av
from khronos_tpu_torch.map import meshing
from khronos_tpu_torch.ops import clusters as cl
from khronos_tpu_torch.ops.dense import all_pool3, any_pool3
from khronos_tpu_torch.utils.logging import clog


class Mesh(NamedTuple):
    """An ordered tuple of devices, one per shard. The slabs split the
    grid's leading axis, the reference's mesh axis "x"."""

    devices: Tuple[torch.device, ...]
    axis = "x"  # a constant, not a field

    @property
    def size(self) -> int:
        return len(self.devices)


def _concrete(device) -> torch.device:
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def visible_cards(first="cuda") -> List[torch.device]:
    """Every visible CUDA card once, in order from `first` (default: the
    current card) on, wrapping around: the reference's `jax.devices()` as
    the window's card sees them (card 0 first when it is current)."""
    k, n = _concrete(first).index, torch.cuda.device_count()
    return [torch.device("cuda", (k + j) % n) for j in range(n)]


def make_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """A mesh of n_devices shards (default: one per device) over `devices`,
    round-robin when there are fewer devices than shards. The default is
    `visible_cards()`: with card 0 current and n or more cards visible,
    cards 0..n-1, the reference's `jax.devices()[:n]`. Where the reference
    shrinks the mesh to the devices that are visible, this one keeps n
    shards and puts several on a card."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: no GPU is visible; pass devices=['cpu'] to shard on the CPU"
            )
        devices = visible_cards()
    devices = [_concrete(d) for d in devices]
    if not devices:
        raise ValueError("make_mesh: no devices")
    n = int(n_devices or len(devices))
    if n < 1:
        raise ValueError(f"make_mesh: n_devices must be >= 1, got {n}")
    return Mesh(tuple(devices[i % len(devices)] for i in range(n)))


_logged_layouts = set()


def mesh_for(n_devices: int, device) -> Mesh:
    """The window's mesh for `n_devices` slabs on `device`: on a CUDA device
    one slab a card over `visible_cards(device)`, round-robin when fewer
    cards are visible (the layout is logged once); on the CPU every slab on
    the CPU."""
    device = _concrete(device)
    if device.type != "cuda":
        return make_mesh(n_devices, devices=[device])
    cards = visible_cards(device)
    mesh = make_mesh(n_devices, devices=cards)
    if len(cards) < mesh.size and mesh.devices not in _logged_layouts:
        _logged_layouts.add(mesh.devices)
        clog(1, f"{mesh.size} slabs on {len(cards)} visible card(s), round-robin: "
                + ", ".join(f"slab {i} on {d}" for i, d in enumerate(mesh.devices)))
    return mesh


def synchronize(devices) -> None:
    """Wait for the work queued on each CUDA device of `devices` (a bare
    torch.cuda.synchronize() waits for the current card only)."""
    for d in dict.fromkeys(torch.device(d) for d in devices):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


class ShardedVolume(NamedTuple):
    """A volume split along x into equal slabs (see the module docstring)."""

    origin: torch.Tensor  # int32[3] (CPU): the global grid's origin
    slabs: Tuple[av.VolumeState, ...]

    @property
    def width(self) -> int:
        return self.slabs[0].tsdf.shape[0]

    @property
    def shape(self) -> Tuple[int, int, int]:
        w, Y, Z = self.slabs[0].tsdf.shape
        return (w * len(self.slabs), Y, Z)

    @property
    def devices(self) -> Tuple[torch.device, ...]:
        return tuple(s.tsdf.device for s in self.slabs)


def volume_sharding(mesh: Mesh, grid_shape) -> List[Tuple[torch.device, slice]]:
    """The layout: (device, x-planes) of each slab. Raises ValueError unless
    the mesh size divides grid_shape[0]."""
    X = int(grid_shape[0])
    if X % mesh.size:
        raise ValueError(f"grid_shape[0]={X} not divisible by n_devices={mesh.size}")
    w = X // mesh.size
    return [(d, slice(i * w, (i + 1) * w)) for i, d in enumerate(mesh.devices)]


def _slab_origin(origin: torch.Tensor, i: int, width: int) -> torch.Tensor:
    return origin + torch.tensor([i * width, 0, 0], dtype=torch.int32)


def shard_volume(state, mesh: Mesh) -> ShardedVolume:
    """A VolumeState (or a ShardedVolume, e.g. restored from a checkpoint)
    -> its slabs on the mesh's devices."""
    if isinstance(state, ShardedVolume):
        state = gather_volume(state)
    layout = volume_sharding(mesh, state.tsdf.shape)
    width = layout[0][1].stop
    slabs = tuple(
        av.VolumeState(
            origin=_slab_origin(state.origin, i, width),
            **{f: getattr(state, f)[xs].to(dev, copy=True) for f in av.GRID_FIELDS},
        )
        for i, (dev, xs) in enumerate(layout)
    )
    return ShardedVolume(state.origin.clone(), slabs)


def gather_volume(sv: ShardedVolume, device=None) -> av.VolumeState:
    """The whole grid as one VolumeState on `device` (default: the first
    slab's): the modular window path, re-sharding and the checks."""
    dev = torch.device(device) if device is not None else sv.slabs[0].tsdf.device
    return av.VolumeState(
        origin=sv.origin.clone(),
        **{f: torch.cat([getattr(s, f).to(dev) for s in sv.slabs]) for f in av.GRID_FIELDS},
    )


def with_origin(sv: ShardedVolume, origin) -> ShardedVolume:
    """The volume with a new global origin (the slabs' follow)."""
    origin = torch.as_tensor(np.asarray(origin), dtype=torch.int32).reshape(3)
    w = sv.width
    return ShardedVolume(origin, tuple(s._replace(origin=_slab_origin(origin, i, w)) for i, s in enumerate(sv.slabs)))


# ---------------------------------------------------------------------------
# halo exchange
# ---------------------------------------------------------------------------


def _rows(slabs: Sequence[torch.Tensor], rows: Sequence[int], device) -> torch.Tensor:
    """Global x-planes `rows` (each in [0, X)) of a field split into equal
    slabs, on `device`: each run of consecutive planes of one slab is one
    copy (none when it lies on `device` already and is the whole request)."""
    w = slabs[0].shape[0]
    parts, k = [], 0
    while k < len(rows):
        j, r0 = divmod(rows[k], w)
        m = 1
        while k + m < len(rows) and rows[k + m] == rows[k] + m and (r0 + m) < w:
            m += 1
        parts.append(slabs[j][r0 : r0 + m].to(device))
        k += m
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def extend(slabs: Sequence[torch.Tensor], i: int, below: int, above: int):
    """Slab i of a field with `below` planes before it and `above` after it
    (fewer at the grid's ends), on slab i's device: (tensor, the slab's
    first plane in it)."""
    w, n = slabs[0].shape[0], len(slabs)
    lo, hi = max(0, i * w - below), min(n * w, (i + 1) * w + above)
    return _rows(slabs, range(lo, hi), slabs[i].device), i * w - lo


class SlabGrid(fs.DenseGrid):
    """The grid operations of `fused_step.DenseGrid` over a grid split into
    slabs: a grid value is a list of per-slab tensors. The cluster
    statistics are DenseGrid's: they read the pixel side only."""

    def __init__(self, mesh: Mesh, shape):
        volume_sharding(mesh, shape)
        X, Y, Z = (int(v) for v in shape)
        self.mesh, self.n, self.shape = mesh, mesh.size, (X, Y, Z)
        self.width = X // mesh.size
        self.cells = self.width * Y * Z  # voxels per slab
        self.slab_shape = (self.width, Y, Z)
        # global linear voxel ids: seed labels must not depend on the layout
        self.lin = [
            (torch.arange(self.cells, dtype=torch.int32, device=d) + i * self.cells).view(self.slab_shape)
            for i, d in enumerate(mesh.devices)
        ]

    def field(self, sv: ShardedVolume, name: str):
        return [getattr(s, name) for s in sv.slabs]

    def map(self, fn, *grids):
        return [fn(*(g[i] for g in grids)) for i in range(self.n)]

    def stencil(self, fn, reach: int, *grids):
        """fn on each slab extended by `reach` planes on both sides; the
        slab's interior of the result."""
        out = []
        for i in range(self.n):
            exts = [extend(g, i, reach, reach) for g in grids]
            out.append(fn(*(e for e, _ in exts)).narrow(0, exts[0][1], self.width))
        return out

    def route(self, clin: torch.Tensor):
        """Per slab: which pixels its voxels own (on the first device) and
        their slab-local voxel ids (on the slab's device; 0 elsewhere).
        Every pixel's id lies in the grid, so exactly one slab owns it."""
        slab = clin // self.cells
        own = [slab == i for i in range(self.n)]
        local = [torch.where(o, clin - i * self.cells, 0).to(d) for i, (o, d) in enumerate(zip(own, self.mesh.devices))]
        return own, local

    def scatter_max(self, route, values: torch.Tensor, fill: int):
        own, local = route
        flat = values.reshape(-1)
        return [
            fs._scatter_max(self.cells, local[i], torch.where(own[i], flat, fill).to(d), fill).view(self.slab_shape)
            for i, d in enumerate(self.mesh.devices)
        ]

    def gather(self, grids, route) -> torch.Tensor:
        own, local = route
        dev0 = self.mesh.devices[0]
        out = None
        for i in range(self.n):
            g = grids[i].reshape(-1)[local[i]].to(dev0)
            out = g if out is None else torch.where(own[i], g, out)
        return out

    def integrate(self, vol_cfg, camera, sv: ShardedVolume, depth, color, labels, excluded, R_w_c, t_w_c, t_now):
        """integrate_frame on each slab: kernel B looks up the slab's voxels
        only; the two 3x3x3 pools read one halo plane from each neighbour."""
        packed = av.pack_pixels(depth, color, labels, excluded)
        parts = [
            av.integrate_frame_local(vol_cfg, camera, s, packed.to(s.tsdf.device), R_w_c, t_w_c, t_now)
            for s in sv.slabs
        ]
        cand_all = self.stencil(all_pool3, 1, [p[1] for p in parts])
        upd_any = self.stencil(any_pool3, 1, [p[2] for p in parts])
        return ShardedVolume(
            sv.origin,
            tuple(av.integrate_frame_pools(p[0], ca, ua) for p, ca, ua in zip(parts, cand_all, upd_any)),
        )

    def archive(self, vol_cfg, sv: ShardedVolume, t_now):
        return ShardedVolume(sv.origin, tuple(av.update_archival(vol_cfg, s, t_now) for s in sv.slabs))

    # the window's grid passes (see DenseGrid)

    def place(self, state) -> ShardedVolume:
        return shard_volume(state, self.mesh)

    def whole(self, sv: ShardedVolume) -> av.VolumeState:
        return gather_volume(sv)

    def with_origin(self, sv: ShardedVolume, origin) -> ShardedVolume:
        return with_origin(sv, origin)

    def scroll(self, vol_cfg, sv: ShardedVolume, shift) -> ShardedVolume:
        return scroll(vol_cfg, sv, shift)

    def emission_mask(self, sv: ShardedVolume, kind: str, shift=None):
        return emission_masks(sv, kind, shift)

    def extract_mesh_async(self, sv: ShardedVolume, masks, vol_cfg, max_cells: int):
        return extract_mesh_async(sv, masks, vol_cfg, max_cells=max_cells)


# ---------------------------------------------------------------------------
# sharded steps
# ---------------------------------------------------------------------------


def make_sharded_step(config: av.VolumeConfig, camera, mesh: Mesh):
    """step(sv, depth, color, labels, mask, R, t, t_now) -> sv':
    integrate_frame + update_archival on every slab. The images are on the
    mesh's first device."""
    grid = SlabGrid(mesh, config.grid_shape)

    def step(sv, depth, color, labels, mask, R_w_c, t_w_c, t_now):
        sv = grid.integrate(config, camera, sv, depth, color, labels, mask, R_w_c, t_w_c, t_now)
        return grid.archive(config, sv, t_now)

    return step


def make_sharded_frame_step(
    config: av.VolumeConfig,
    camera,
    md_cfg,
    od_cfg,
    label_space,
    mesh: Mesh,
    detection_stride: int = 1,
    background_embeddings=None,
):
    """The FULL fused frame step (motion detection, object detection,
    integration, archival, packed cluster stats) over the mesh, cropping off
    (`fused_step.make_frame_step(mesh=)`): step(sv, depth, color, labels,
    R, t, t_now) -> (sv', dynamic_image, object_image, packed_stats) like the
    unsharded step (the open-set variant takes instances and features too)."""
    return fs.make_frame_step(
        config,
        camera,
        md_cfg,
        od_cfg,
        label_space,
        detection_stride=detection_stride,
        crop=False,
        background_embeddings=background_embeddings,
        mesh=mesh,
    )


def make_sharded_ray_query(verificator, mesh: Mesh):
    """Split the change-detection ray check over the mesh: the query points
    in N contiguous parts, one per shard, the ray library replicated on
    every shard's device. Returns query(points [P, 3]) -> evidence
    [P, num_bins, 2] int32, equal to verificator.query(points) (each
    point's evidence depends on that point only)."""
    from khronos_tpu_torch.changes import ray_verificator as rv

    cfg = verificator.config

    def query(points: np.ndarray) -> np.ndarray:
        P_n = len(points)
        num_bins = verificator.active_num_bins if verificator._built else cfg.num_bins
        if not verificator._built or P_n == 0:
            return np.zeros((P_n, num_bins, 2), np.int32)
        pts = np.asarray(points, np.float32)
        bounds = np.linspace(0, P_n, mesh.size + 1).round().astype(np.int64)
        outs = []
        for i, dev in enumerate(mesh.devices):
            part = pts[bounds[i] : bounds[i + 1]]
            if not len(part):
                continue
            p = torch.from_numpy(part).to(dev)
            tol = torch.full((len(part),), float(np.float32(cfg.radial_tolerance)), dtype=torch.float32, device=dev)
            ev = None
            for idx in verificator._indexes():  # the library, as built now, on the shard's device
                lib = {k: idx[k].to(dev) for k in ("sorted_rays", "cell_start", "ray_table")}
                e = rv._query_device(
                    p, lib["sorted_rays"], lib["cell_start"], lib["ray_table"], cfg.hash_cells, cfg.block_size,
                    tol, cfg.depth_tolerance, cfg.temporal_resolution, num_bins, cfg.max_candidates,
                )
                ev = e if ev is None else ev + e
            outs.append(ev.cpu().numpy())
        return np.concatenate(outs)

    return query


# ---------------------------------------------------------------------------
# the window's other grid passes: scroll and mesh emission
# ---------------------------------------------------------------------------


def _scroll_edges(lo: int, hi: int, shape, shift, device, leaving: bool) -> torch.Tensor:
    """On global x-planes [lo, hi): the cells a scroll by `shift` drops
    (leaving, av.scroll_out_mask) or exposes (av.scroll's wrap-around cells)."""
    sizes = (hi - lo,) + tuple(shape[1:])
    out = torch.zeros(sizes, dtype=torch.bool, device=device)
    for axis, (s, n) in enumerate(zip(shift, shape)):
        if s == 0:
            continue
        idx = torch.arange(sizes[axis], device=device) + (lo if axis == 0 else 0)
        view = [1, 1, 1]
        view[axis] = sizes[axis]
        if leaving:
            edge = (idx < s) if s > 0 else (idx >= n + s)
        else:
            edge = (idx >= n - s) if s > 0 else (idx < -s)
        out |= edge.view(view)
    return out


def scroll(config: av.VolumeConfig, sv: ShardedVolume, shift) -> ShardedVolume:
    """av.scroll on a sharded volume: planes move across slab boundaries.
    Each slab is rebuilt from the old grid's planes it now shows, with one
    halo plane on each side for the wrap seam's 3x3x3 pools."""
    shift = [int(v) for v in np.asarray(shift)]
    sx, sy, sz = shift
    X, Y, Z = shape = sv.shape
    w = sv.width
    origin = sv.origin + torch.tensor(shift, dtype=torch.int32)
    slabs = []
    for i, slab in enumerate(sv.slabs):
        dev = slab.tsdf.device
        lo, hi = max(0, i * w - 1), min(X, (i + 1) * w + 1)
        src = [(x + sx) % X for x in range(lo, hi)]  # the rolled grid's planes [lo, hi)
        ext = av.VolumeState(
            origin=origin,
            **{
                f: torch.roll(_rows([getattr(s, f) for s in sv.slabs], src, dev), shifts=(-sy, -sz), dims=(1, 2))
                for f in av.GRID_FIELDS
            },
        )
        fresh = _scroll_edges(lo, hi, shape, shift, dev, leaving=False)
        out = av._reset_values(config, ext, fresh)
        out = out._replace(cell_meshed=out.cell_meshed & ~any_pool3(fresh))
        off = i * w - lo
        slabs.append(
            av.VolumeState(
                origin=_slab_origin(origin, i, w),
                **{f: getattr(out, f).narrow(0, off, w).clone() for f in av.GRID_FIELDS},
            )
        )
    return ShardedVolume(origin, tuple(slabs))


_MASK_FIELDS = ("tsdf", "weight", "archived", "cell_meshed")
_CORNER_FIELDS = ("tsdf", "first_obs", "last_obs", "color", "label")


def _with_next_plane(sv: ShardedVolume, i: int, fields) -> av.VolumeState:
    """Slab i with the next slab's first plane appended to `fields` (a
    cell's corners reach one plane up); the last slab as it is."""
    slab = sv.slabs[i]
    return slab._replace(**{f: extend([getattr(s, f) for s in sv.slabs], i, 0, 1)[0] for f in fields})


def emission_masks(sv: ShardedVolume, kind: str, shift=None) -> List[torch.Tensor]:
    """meshing's emission masks per slab: the cells whose lowest corner lies
    in the slab ([w, Y-1, Z-1], the last slab [w-1, Y-1, Z-1]). kind:
    "archived", "finish" or "forced" (the cells a scroll by `shift` would
    drop a corner of)."""
    masks = []
    w = sv.width
    for i in range(len(sv.slabs)):
        ext = _with_next_plane(sv, i, _MASK_FIELDS)
        if kind == "archived":
            masks.append(meshing.archived_emission_mask(ext))
        elif kind == "finish":
            masks.append(meshing.finish_emission_mask(ext))
        elif kind == "forced":
            lo = i * w
            force = _scroll_edges(lo, lo + ext.tsdf.shape[0], sv.shape, [int(v) for v in np.asarray(shift)],
                                  ext.tsdf.device, leaving=True)
            masks.append(meshing.forced_emission_mask(ext, force))
        else:
            raise ValueError(f"emission_masks: unknown kind {kind!r}")
    return masks


def extract_mesh_async(sv: ShardedVolume, masks, config: av.VolumeConfig, max_cells: int = 16384,
                       tri_capacity: int = None):
    """meshing.extract_mesh_async on a sharded volume, with the same result:
    each slab picks its first max_cells wanted cells, the round takes the
    first max_cells of all in global cell order, each slab reads its taken
    cells' corners (one halo plane from the next slab), and the triangles
    are built and packed on the first device. Returns (sv', packed, meta)."""
    if tri_capacity is None:
        tri_capacity = meshing.default_tri_capacity(max_cells)
    X, Y, Z = sv.shape
    CY, CZ = Y - 1, Z - 1
    w, n = sv.width, len(sv.slabs)
    per_slab = w * CY * CZ
    dev0 = sv.slabs[0].tsdf.device
    ids, n_want = [], None
    for i, (slab, m) in enumerate(zip(sv.slabs, masks)):
        c, nw = meshing.select_cells(slab, m, max_cells)
        ids.append(torch.where(c >= 0, c + i * per_slab, -1).to(dev0))
        n_want = nw.to(dev0) if n_want is None else n_want + nw.to(dev0)
    cat = torch.cat(ids)
    slots = cl.compact_indices(cat >= 0, max_cells)
    cell_ids = torch.where(slots >= 0, cat[slots.clamp_min(0).long()], -1)
    safe_ids, (ii, jj, kk) = meshing.cell_corners(cell_ids, CY, CZ)
    owner = safe_ids // per_slab
    corners = None
    for i, d in enumerate(sv.devices):
        ext = _with_next_plane(sv, i, _CORNER_FIELDS)
        own = (owner == i)[:, None]
        vals = meshing.corner_values(ext, torch.where(own, ii - i * w, 0).to(d), jj.to(d), kk.to(d))
        vals = [v.to(dev0) for v in vals]
        if corners is None:
            corners = vals
        else:
            corners = [torch.where(own if v.ndim == 2 else own[..., None], v, c) for v, c in zip(vals, corners)]
    origin = [int(o) for o in sv.origin.tolist()]
    done, packed, meta = meshing.emit_cells(
        corners, (ii, jj, kk), cell_ids >= 0, n_want, origin, (X, Y, Z), config.voxel_size, tri_capacity
    )
    slabs = []
    for i, (slab, d) in enumerate(zip(sv.slabs, sv.devices)):
        cm = meshing.mark_meshed(
            slab.cell_meshed, w if i < n - 1 else w - 1, (safe_ids - i * per_slab).to(d),
            (done & (owner == i)).to(d), zero_alias=(i == 0),
        )
        slabs.append(slab._replace(cell_meshed=cm))
    return ShardedVolume(sv.origin, tuple(slabs)), packed, meta
