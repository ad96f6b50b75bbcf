"""Device-mesh sharding of the active-window map, in one process or over
several ("ranks").

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

Over several processes (a mesh made with a `parallel.distributed` group: the
reference's global mesh after `jax.distributed.initialize`), the N slabs are
laid out process-major, as the reference's `jax.devices()[:n]` lists the
global devices: rank r owns slabs [r N/W, (r + 1) N/W), all on its own
device. Every rank runs the same calls in the same order (SPMD): the pixel
side and the host state are replicated, a rank computes its own slabs only
(the others are None in its `ShardedVolume`), and whatever crosses a slab
boundary goes through the group's `all_gather`: the halo planes, the
per-pixel values a slab owns (selected by owner, never summed), the scroll's
planes, the wanted cells and the corners of an emission round, and the whole
grid for the modular path. Results equal the one-process mesh's bit for bit.

`DenseGrid` (fused_step.py) and `SlabGrid` here are the two layouts of the
volume; the fused step and the window are written once against either.
"""

from __future__ import annotations

import functools
import math
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
    grid's leading axis, the reference's mesh axis "x". With a `group`
    (`parallel.distributed`) the mesh spans its ranks: devices[i] is slab
    i's device in the rank that owns it."""

    devices: Tuple[torch.device, ...]
    group: Optional[object] = None
    axis = "x"  # a constant, not a field

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def ranks(self) -> int:
        return 1 if self.group is None else self.group.size

    @property
    def rank(self) -> int:
        return 0 if self.group is None else self.group.rank

    def owner(self, i: int) -> int:
        """The rank that owns slab i (process-major)."""
        return i // (self.size // self.ranks)

    def slabs_of(self, rank: int) -> range:
        k = self.size // self.ranks
        return range(rank * k, (rank + 1) * k)

    @property
    def local(self) -> range:
        """The slabs this process computes."""
        return self.slabs_of(self.rank)


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


def make_mesh(n_devices: Optional[int] = None, devices=None, group=None) -> Mesh:
    """A mesh of n_devices shards (default: one per device) over `devices`,
    round-robin when there are fewer devices than shards. The default is
    `visible_cards()`: with card 0 current and n or more cards visible,
    cards 0..n-1, the reference's `jax.devices()[:n]`. Where the reference
    shrinks the mesh to the devices that are visible, this one keeps n
    shards and puts several on a card.

    With a `group` (`parallel.distributed`) the mesh spans its W ranks
    (default: one shard a rank): n_devices / W shards a rank, process-major,
    each on its rank's device (`devices` is not read). n_devices must be a
    multiple of W: the reference's workers take every device of the global
    mesh, so every process owns as many."""
    if group is not None:
        n = int(n_devices or group.size)
        if n < 1 or n % group.size:
            raise ValueError(f"make_mesh: n_devices={n} over {group.size} ranks: every rank must own as many "
                             f"slabs (n_devices a multiple of the ranks, as the reference's workers take every "
                             f"device of the global mesh)")
        k = n // group.size
        return Mesh(tuple(group.devices[i // k] for i in range(n)), group)
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


def mesh_for(n_devices: int, device, group=None) -> Mesh:
    """The window's mesh for `n_devices` slabs on `device`: on a CUDA device
    one slab a card over `visible_cards(device)`, round-robin when fewer
    cards are visible (the layout is logged once); on the CPU every slab on
    the CPU. With a `group`, the global layout over its ranks (`make_mesh`);
    `device` must be of the kind of the rank's device."""
    if group is not None:
        if torch.device(device).type != group.device.type:
            raise ValueError(f"mesh_for: the window asks for {device} and this rank's device is {group.device}")
        return make_mesh(n_devices, group=group)
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
    """A volume split along x into equal slabs (see the module docstring).
    Over several ranks a slab another rank owns is None."""

    origin: torch.Tensor  # int32[3] (CPU): the global grid's origin
    slabs: Tuple[Optional[av.VolumeState], ...]

    @property
    def local(self) -> List[Tuple[int, av.VolumeState]]:
        """(index, slab) of the slabs this process holds."""
        return [(i, s) for i, s in enumerate(self.slabs) if s is not None]

    @property
    def width(self) -> int:
        return self.local[0][1].tsdf.shape[0]

    @property
    def shape(self) -> Tuple[int, int, int]:
        w, Y, Z = self.local[0][1].tsdf.shape
        return (w * len(self.slabs), Y, Z)


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


def _multi(mesh: Optional[Mesh]) -> bool:
    return mesh is not None and mesh.ranks > 1


def shard_volume(state, mesh: Mesh) -> ShardedVolume:
    """A VolumeState (or a ShardedVolume, e.g. restored from a checkpoint)
    -> its slabs on the mesh's devices. Over several ranks every rank holds
    the whole `state` and keeps its own slabs."""
    if isinstance(state, ShardedVolume):
        state = gather_volume(state, mesh=mesh)
    layout = volume_sharding(mesh, state.tsdf.shape)
    width = layout[0][1].stop
    slabs = tuple(
        av.VolumeState(
            origin=_slab_origin(state.origin, i, width),
            **{f: getattr(state, f)[xs].to(dev, copy=True) for f in av.GRID_FIELDS},
        ) if i in mesh.local else None
        for i, (dev, xs) in enumerate(layout)
    )
    return ShardedVolume(state.origin.clone(), slabs)


def gather_volume(sv: ShardedVolume, device=None, mesh: Optional[Mesh] = None) -> av.VolumeState:
    """The whole grid as one VolumeState on `device` (default: the first
    slab this process holds): the modular window path, re-sharding and the
    checks. Over several ranks (`mesh` with a group) every rank calls it and
    gets the whole grid."""
    dev = torch.device(device) if device is not None else sv.local[0][1].tsdf.device
    if not _multi(mesh):
        if any(s is None for s in sv.slabs):
            raise ValueError("gather_volume: a volume split over several ranks needs its mesh")
        return av.VolumeState(
            origin=sv.origin.clone(),
            **{f: torch.cat([getattr(s, f).to(dev) for s in sv.slabs]) for f in av.GRID_FIELDS},
        )
    mine = [torch.cat([getattr(s, f) for _, s in sv.local]) for f in av.GRID_FIELDS]
    parts = _all_gather_rows(mesh.group, mine)
    return av.VolumeState(
        origin=sv.origin.clone(),
        **{f: torch.cat([p[k] for p in parts]).to(dev) for k, f in enumerate(av.GRID_FIELDS)},
    )


def with_origin(sv: ShardedVolume, origin) -> ShardedVolume:
    """The volume with a new global origin (the slabs' follow)."""
    origin = torch.as_tensor(np.asarray(origin), dtype=torch.int32).reshape(3)
    w = sv.width
    return ShardedVolume(origin, tuple(
        None if s is None else s._replace(origin=_slab_origin(origin, i, w)) for i, s in enumerate(sv.slabs)))


# ---------------------------------------------------------------------------
# halo exchange
# ---------------------------------------------------------------------------


def _row_bytes(t: torch.Tensor) -> int:
    return math.prod(t.shape[1:]) * t.element_size()


def _all_gather_rows(group, tensors: Sequence[torch.Tensor]) -> List[List[torch.Tensor]]:
    """Every rank's `tensors` (the same shapes and dtypes in every rank, one
    leading length), in rank order, in ONE all_gather: each row of each
    tensor travels as its bytes, so the values arrive bit for bit."""
    L = tensors[0].shape[0]
    pack = torch.cat([t.contiguous().view(torch.uint8).reshape(L, _row_bytes(t)) for t in tensors], dim=1)
    out = []
    for p in group.all_gather(pack):
        got, off = [], 0
        for t in tensors:
            nb = _row_bytes(t)
            got.append(p[:, off:off + nb].contiguous().view(t.dtype).reshape(t.shape))
            off += nb
        out.append(got)
    return out


def _extent(n: int, w: int, i: int, below: int, above: int) -> Tuple[int, int]:
    """Global x-planes [lo, hi) of slab i with `below` planes before it and
    `above` after it (fewer at the grid's ends)."""
    return max(0, i * w - below), min(n * w, (i + 1) * w + above)


def _fetch(mesh: Optional[Mesh], fields, rows_of_slab):
    """The planes of other ranks' slabs that this rank's slabs read, for
    each of `fields` (per-slab lists, None where another rank owns the slab);
    rows_of_slab(i) are the global planes slab i reads. Every rank computes
    every rank's wants, so ONE all_gather carries what each rank's slabs
    give. Per field: (global plane -> position, the planes in plane order) on
    this rank's device, or None where nothing is fetched (one process)."""
    if not _multi(mesh):
        return [None] * len(fields)
    W, me = mesh.ranks, mesh.rank
    first = [next(s for s in g if s is not None) for g in fields]
    w = first[0].shape[0]

    def owner(x):
        return mesh.owner(x // w)

    wanted = [sorted({x for i in mesh.slabs_of(q) for x in rows_of_slab(i) if owner(x) != q}) for q in range(W)]
    send = [sorted({x for q in range(W) for x in wanted[q] if owner(x) == s}) for s in range(W)]
    L = max(len(v) for v in send)
    if L == 0:
        return [None] * len(fields)
    dev = first[0].device
    mine = []
    for g, f0 in zip(fields, first):
        planes = _rows(g, send[me], dev) if send[me] else f0.new_zeros((0,) + tuple(f0.shape[1:]))
        mine.append(torch.cat([planes, planes.new_zeros((L - planes.shape[0],) + tuple(f0.shape[1:]))]))
    parts = _all_gather_rows(mesh.group, mine)
    idx = torch.tensor([owner(x) * L + send[owner(x)].index(x) for x in wanted[me]], dtype=torch.long, device=dev)
    pos = {x: k for k, x in enumerate(wanted[me])}
    return [(pos, torch.cat([p[k] for p in parts]).index_select(0, idx)) for k in range(len(fields))]


def _rows(slabs: Sequence[torch.Tensor], rows: Sequence[int], device, remote=None) -> torch.Tensor:
    """Global x-planes `rows` (each in [0, X)) of a field split into equal
    slabs, on `device`: each run of consecutive planes of one slab is one
    copy (none when it lies on `device` already and is the whole request).
    A plane of a slab another rank owns comes from `remote` (`_fetch`)."""
    w = next(s for s in slabs if s is not None).shape[0]
    parts, k = [], 0
    while k < len(rows):
        j, r0 = divmod(rows[k], w)
        m = 1
        while k + m < len(rows) and rows[k + m] == rows[k] + m and (r0 + m) < w:
            m += 1
        if slabs[j] is not None:
            parts.append(slabs[j][r0 : r0 + m].to(device))
        else:  # the fetched planes are in plane order, so a run of them is contiguous
            pos, planes = remote
            parts.append(planes[pos[rows[k]] : pos[rows[k]] + m])
        k += m
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def extend(slabs: Sequence[torch.Tensor], i: int, below: int, above: int, remote=None):
    """Slab i of a field with `below` planes before it and `above` after it
    (fewer at the grid's ends), on slab i's device: (tensor, the slab's
    first plane in it). `remote`: what `_fetch` gave for the field."""
    w = slabs[i].shape[0]
    lo, hi = _extent(len(slabs), w, i, below, above)
    return _rows(slabs, range(lo, hi), slabs[i].device, remote), i * w - lo


class SlabGrid(fs.DenseGrid):
    """The grid operations of `fused_step.DenseGrid` over a grid split into
    slabs: a grid value is a list of per-slab tensors (None for a slab
    another rank owns). The cluster statistics are DenseGrid's: they read
    the pixel side only."""

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
            if i in mesh.local else None
            for i, d in enumerate(mesh.devices)
        ]

    def field(self, sv: ShardedVolume, name: str):
        return [None if s is None else getattr(s, name) for s in sv.slabs]

    def map(self, fn, *grids):
        return [fn(*(g[i] for g in grids)) if i in self.mesh.local else None for i in range(self.n)]

    def stencil(self, fn, reach: int, *grids):
        """fn on each slab extended by `reach` planes on both sides; the
        slab's interior of the result."""
        remote = _fetch(self.mesh, grids, lambda i: range(*_extent(self.n, self.width, i, reach, reach)))
        out = [None] * self.n
        for i in self.mesh.local:
            exts = [extend(g, i, reach, reach, rem) for g, rem in zip(grids, remote)]
            out[i] = fn(*(e for e, _ in exts)).narrow(0, exts[0][1], self.width)
        return out

    def route(self, clin: torch.Tensor):
        """Per slab: which pixels its voxels own (on the pixel side's device)
        and, for this process's slabs, their slab-local voxel ids (on the
        slab's device; 0 elsewhere). Every pixel's id lies in the grid, so
        exactly one slab owns it."""
        slab = clin // self.cells
        own = [slab == i for i in range(self.n)]
        local = [
            torch.where(own[i], clin - i * self.cells, 0).to(d) if i in self.mesh.local else None
            for i, d in enumerate(self.mesh.devices)
        ]
        return own, local

    def scatter_max(self, route, values: torch.Tensor, fill: int):
        own, local = route
        flat = values.reshape(-1)
        return [
            fs._scatter_max(self.cells, local[i], torch.where(own[i], flat, fill).to(d), fill).view(self.slab_shape)
            if i in self.mesh.local else None
            for i, d in enumerate(self.mesh.devices)
        ]

    def gather(self, grids, route) -> torch.Tensor:
        """Each pixel's value in the slab that owns it, on the pixel side's
        device. Over several ranks each rank gathers from its own slabs and
        the ranks' results are selected by owner, never summed (a sum would
        turn -0.0 into +0.0 and change NaN payloads)."""
        own, local = route
        dev = own[0].device
        out = None
        for i in self.mesh.local:
            g = grids[i].reshape(-1)[local[i]].to(dev)
            out = g if out is None else torch.where(own[i], g, out)
        if _multi(self.mesh):
            parts = self.mesh.group.all_gather(out)
            out = parts[0]
            for q in range(1, self.mesh.ranks):
                mine = functools.reduce(torch.logical_or, [own[i] for i in self.mesh.slabs_of(q)])
                out = torch.where(mine, parts[q], out)
        return out

    def integrate(self, vol_cfg, camera, sv: ShardedVolume, depth, color, labels, excluded, R_w_c, t_w_c, t_now):
        """integrate_frame on each slab: kernel B looks up the slab's voxels
        only; the two 3x3x3 pools read one halo plane from each neighbour."""
        packed = av.pack_pixels(depth, color, labels, excluded)
        parts = [
            None if s is None else av.integrate_frame_local(vol_cfg, camera, s, packed.to(s.tsdf.device), R_w_c,
                                                            t_w_c, t_now)
            for s in sv.slabs
        ]
        cand_all = self.stencil(all_pool3, 1, [None if p is None else p[1] for p in parts])
        upd_any = self.stencil(any_pool3, 1, [None if p is None else p[2] for p in parts])
        return ShardedVolume(
            sv.origin,
            tuple(None if p is None else av.integrate_frame_pools(p[0], ca, ua)
                  for p, ca, ua in zip(parts, cand_all, upd_any)),
        )

    def archive(self, vol_cfg, sv: ShardedVolume, t_now):
        return ShardedVolume(sv.origin, tuple(None if s is None else av.update_archival(vol_cfg, s, t_now)
                                              for s in sv.slabs))

    # the window's grid passes (see DenseGrid)

    def place(self, state) -> ShardedVolume:
        return shard_volume(state, self.mesh)

    def whole(self, sv: ShardedVolume) -> av.VolumeState:
        return gather_volume(sv, mesh=self.mesh)

    def with_origin(self, sv: ShardedVolume, origin) -> ShardedVolume:
        return with_origin(sv, origin)

    def scroll(self, vol_cfg, sv: ShardedVolume, shift) -> ShardedVolume:
        return scroll(vol_cfg, sv, shift, mesh=self.mesh)

    def emission_mask(self, sv: ShardedVolume, kind: str, shift=None):
        return emission_masks(sv, kind, shift, mesh=self.mesh)

    def extract_mesh_async(self, sv: ShardedVolume, masks, vol_cfg, max_cells: int):
        return extract_mesh_async(sv, masks, vol_cfg, max_cells=max_cells, mesh=self.mesh)


# ---------------------------------------------------------------------------
# sharded steps
# ---------------------------------------------------------------------------


def make_sharded_step(config: av.VolumeConfig, camera, mesh: Mesh):
    """step(sv, depth, color, labels, mask, R, t, t_now) -> sv':
    integrate_frame + update_archival on every slab this process holds. The
    images are on the pixel side's device (the mesh's first device in one
    process, the rank's own over several)."""
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
    point's evidence depends on that point only). One process only."""
    from khronos_tpu_torch.changes import ray_verificator as rv

    if _multi(mesh):
        raise ValueError("make_sharded_ray_query: the ray query over several ranks is not ported; "
                         "every rank holds the whole ray library, so query it with verificator.query")
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


def _fields(sv: ShardedVolume, names) -> List[list]:
    return [[None if s is None else getattr(s, f) for s in sv.slabs] for f in names]


def scroll(config: av.VolumeConfig, sv: ShardedVolume, shift, mesh: Optional[Mesh] = None) -> ShardedVolume:
    """av.scroll on a sharded volume: planes move across slab boundaries.
    Each slab is rebuilt from the old grid's planes it now shows, with one
    halo plane on each side for the wrap seam's 3x3x3 pools (over several
    ranks, fetched from their owners in one exchange)."""
    shift = [int(v) for v in np.asarray(shift)]
    sx, sy, sz = shift
    X, Y, Z = shape = sv.shape
    w, n = sv.width, len(sv.slabs)
    origin = sv.origin + torch.tensor(shift, dtype=torch.int32)

    def src_rows(i):  # the rolled grid's planes [lo, hi) of slab i, in the old grid
        return [(x + sx) % X for x in range(*_extent(n, w, i, 1, 1))]

    fields = _fields(sv, av.GRID_FIELDS)
    remote = _fetch(mesh, fields, src_rows)
    slabs = [None] * n
    for i, slab in sv.local:
        dev = slab.tsdf.device
        lo, hi = _extent(n, w, i, 1, 1)
        src = src_rows(i)
        ext = av.VolumeState(
            origin=origin,
            **{
                f: torch.roll(_rows(fields[k], src, dev, remote[k]), shifts=(-sy, -sz), dims=(1, 2))
                for k, f in enumerate(av.GRID_FIELDS)
            },
        )
        fresh = _scroll_edges(lo, hi, shape, shift, dev, leaving=False)
        out = av._reset_values(config, ext, fresh)
        out = out._replace(cell_meshed=out.cell_meshed & ~any_pool3(fresh))
        off = i * w - lo
        slabs[i] = av.VolumeState(
            origin=_slab_origin(origin, i, w),
            **{f: getattr(out, f).narrow(0, off, w).clone() for f in av.GRID_FIELDS},
        )
    return ShardedVolume(origin, tuple(slabs))


_MASK_FIELDS = ("tsdf", "weight", "archived", "cell_meshed")
_CORNER_FIELDS = ("tsdf", "first_obs", "last_obs", "color", "label")


def _fetch_next_plane(sv: ShardedVolume, names, mesh: Optional[Mesh]):
    """`_fetch` of the next slab's first plane for each slab (a cell's
    corners reach one plane up)."""
    n, w = len(sv.slabs), sv.width
    return _fetch(mesh, _fields(sv, names), lambda i: range(*_extent(n, w, i, 0, 1)))


def _with_next_plane(sv: ShardedVolume, i: int, fields, remote=None) -> av.VolumeState:
    """Slab i with the next slab's first plane appended to `fields`; the
    last slab as it is. `remote`: `_fetch_next_plane`'s result."""
    remote = remote or [None] * len(fields)
    return sv.slabs[i]._replace(**{f: extend(g, i, 0, 1, rem)[0]
                                   for f, g, rem in zip(fields, _fields(sv, fields), remote)})


def emission_masks(sv: ShardedVolume, kind: str, shift=None, mesh: Optional[Mesh] = None) -> List[torch.Tensor]:
    """meshing's emission masks per slab: the cells whose lowest corner lies
    in the slab ([w, Y-1, Z-1], the last slab [w-1, Y-1, Z-1]; None for a
    slab another rank owns). kind: "archived", "finish" or "forced" (the
    cells a scroll by `shift` would drop a corner of)."""
    if kind not in ("archived", "finish", "forced"):
        raise ValueError(f"emission_masks: unknown kind {kind!r}")
    masks = [None] * len(sv.slabs)
    w = sv.width
    remote = _fetch_next_plane(sv, _MASK_FIELDS, mesh)
    for i, _ in sv.local:
        ext = _with_next_plane(sv, i, _MASK_FIELDS, remote)
        if kind == "archived":
            masks[i] = meshing.archived_emission_mask(ext)
        elif kind == "finish":
            masks[i] = meshing.finish_emission_mask(ext)
        else:
            lo = i * w
            force = _scroll_edges(lo, lo + ext.tsdf.shape[0], sv.shape, [int(v) for v in np.asarray(shift)],
                                  ext.tsdf.device, leaving=True)
            masks[i] = meshing.forced_emission_mask(ext, force)
    return masks


def _select_by(owner: torch.Tensor, values, current):
    """Per cell, `values` where `owner` (a [C] bool) else `current`."""
    own = owner[:, None]
    return [torch.where(own if v.ndim == 2 else own[..., None], v, c) for v, c in zip(values, current)]


def extract_mesh_async(sv: ShardedVolume, masks, config: av.VolumeConfig, max_cells: int = 16384,
                       tri_capacity: int = None, mesh: Optional[Mesh] = None):
    """meshing.extract_mesh_async on a sharded volume, with the same result:
    each slab picks its first max_cells wanted cells, the round takes the
    first max_cells of all in global cell order, each slab reads its taken
    cells' corners (one halo plane from the next slab), and the triangles
    are built and packed on the pixel side's device. Over several ranks the
    wanted cells and their counts come from every rank, each cell's corners
    from its owner, and every rank builds the triangles. Returns (sv',
    packed, meta)."""
    if tri_capacity is None:
        tri_capacity = meshing.default_tri_capacity(max_cells)
    X, Y, Z = sv.shape
    CY, CZ = Y - 1, Z - 1
    w, n = sv.width, len(sv.slabs)
    per_slab = w * CY * CZ
    dev = sv.local[0][1].tsdf.device
    ids, n_want = [], None
    for i, slab in sv.local:
        c, nw = meshing.select_cells(slab, masks[i], max_cells)
        ids.append(torch.where(c >= 0, c + i * per_slab, -1).to(dev))
        n_want = nw.to(dev) if n_want is None else n_want + nw.to(dev)
    if _multi(mesh):
        parts = mesh.group.all_gather(torch.cat(ids + [n_want.reshape(1)]))
        ids = [p[:-1] for p in parts]
        n_want = functools.reduce(torch.add, [p[-1] for p in parts])
    cat = torch.cat(ids)
    slots = cl.compact_indices(cat >= 0, max_cells)
    cell_ids = torch.where(slots >= 0, cat[slots.clamp_min(0).long()], -1)
    safe_ids, (ii, jj, kk) = meshing.cell_corners(cell_ids, CY, CZ)
    owner = safe_ids // per_slab
    remote = _fetch_next_plane(sv, _CORNER_FIELDS, mesh)
    corners = None
    for i, slab in sv.local:
        d = slab.tsdf.device
        ext = _with_next_plane(sv, i, _CORNER_FIELDS, remote)
        own = (owner == i)[:, None]
        vals = meshing.corner_values(ext, torch.where(own, ii - i * w, 0).to(d), jj.to(d), kk.to(d))
        vals = [v.to(dev) for v in vals]
        corners = vals if corners is None else _select_by(owner == i, vals, corners)
    if _multi(mesh):
        parts = _all_gather_rows(mesh.group, corners)
        rank_of = owner // (n // mesh.ranks)
        corners = parts[0]
        for q in range(1, mesh.ranks):
            corners = _select_by(rank_of == q, parts[q], corners)
    origin = [int(o) for o in sv.origin.tolist()]
    done, packed, meta = meshing.emit_cells(
        corners, (ii, jj, kk), cell_ids >= 0, n_want, origin, (X, Y, Z), config.voxel_size, tri_capacity
    )
    slabs = list(sv.slabs)
    for i, slab in sv.local:
        d = slab.tsdf.device
        cm = meshing.mark_meshed(
            slab.cell_meshed, w if i < n - 1 else w - 1, (safe_ids - i * per_slab).to(d),
            (done & (owner == i)).to(d), zero_alias=(i == 0),
        )
        slabs[i] = slab._replace(cell_meshed=cm)
    return ShardedVolume(sv.origin, tuple(slabs)), packed, meta
