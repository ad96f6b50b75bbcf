"""Surface extraction from the ActiveVolume: batched marching tetrahedra.

Port of `khronos_tpu/map/meshing.py` (hydra's incremental MeshIntegrator,
SURVEY.md §2.3, active_window.cpp:223 `generateMesh`): each grid cell is split
into 6 tetrahedra around the c0-c6 diagonal, with the 16-case tetrahedron
table generated below. Triangles carry interpolated color and per-vertex
first/last-observed stamps.

Fixed-shape pipeline: an emission mask picks cells, `compact_indices`
compacts them, and all tet/case math runs batched over [C, 6 tets, 2 tris].
Cells that do not fit in one round stay unmeshed (`cell_meshed` False) and
are drained in another round. The emission buffer keeps the reference's
12-word quantised triangle layout; words are uint32 bit patterns held in
int32 (read them with `.view(np.uint32)` on the host).

`cell_meshed` is written back as the reference writes it: every compacted
slot writes its cell, `True` if emitted and the old value if not, and the
padding slots all alias cell (0, 0, 0) with its old value. In slot order the
last write to a cell wins (the reference's serial scatter on the CPU), so a
taken cell (0, 0, 0) stays unmeshed whenever a padding slot follows it. The
port computes that outcome explicitly, not through CUDA's scatter order.

Triangle winding is not globally consistent (normals unused downstream).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from khronos_tpu_torch import true_div, u32_bits
from khronos_tpu_torch.map.active_volume import VolumeConfig, VolumeState
from khronos_tpu_torch.ops.clusters import compact_indices, compact_rows
from khronos_tpu_torch.utils.host_copy import HostCopy
from khronos_tpu_torch.utils.timing import Wait

# --- cube corners: c0..c7; tets around the c0-c6 diagonal -------------------
CORNER_OFFSETS = np.array(
    [
        [0, 0, 0],
        [1, 0, 0],
        [1, 1, 0],
        [0, 1, 0],
        [0, 0, 1],
        [1, 0, 1],
        [1, 1, 1],
        [0, 1, 1],
    ],
    np.int32,
)
TETS = np.array(
    [[0, 1, 2, 6], [0, 2, 3, 6], [0, 3, 7, 6], [0, 7, 4, 6], [0, 4, 5, 6], [0, 5, 1, 6]],
    np.int32,
)
TET_EDGES = np.array([[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]], np.int32)
_EDGE_ID = {(int(a), int(b)): i for i, (a, b) in enumerate(TET_EDGES)}
_EDGE_ID.update({(int(b), int(a)): i for i, (a, b) in enumerate(TET_EDGES)})


def _build_tet_table() -> np.ndarray:
    """[16 cases, 2 triangles, 3 edge-ids] with -1 padding.

    Case bit i set <=> tet vertex i is inside (sdf < 0)."""
    table = -np.ones((16, 2, 3), np.int32)
    for case in range(16):
        inside = [i for i in range(4) if case >> i & 1]
        outside = [i for i in range(4) if i not in inside]
        tris = []
        if len(inside) == 1:
            a = inside[0]
            o = outside
            tris.append([_EDGE_ID[(a, o[0])], _EDGE_ID[(a, o[1])], _EDGE_ID[(a, o[2])]])
        elif len(inside) == 3:
            a = outside[0]
            i = inside
            tris.append([_EDGE_ID[(i[0], a)], _EDGE_ID[(i[2], a)], _EDGE_ID[(i[1], a)]])
        elif len(inside) == 2:
            a, b = inside
            x, y = outside
            e_ax, e_ay = _EDGE_ID[(a, x)], _EDGE_ID[(a, y)]
            e_bx, e_by = _EDGE_ID[(b, x)], _EDGE_ID[(b, y)]
            tris.append([e_ax, e_ay, e_by])
            tris.append([e_ax, e_by, e_bx])
        for k, t in enumerate(tris):
            table[case, k] = t
    return table


TET_TABLE = _build_tet_table()
INF = float("inf")


def corner_views(arr: torch.Tensor) -> torch.Tensor:
    """[X,Y,Z,...] grid -> stacked 8-corner cell views [8, X-1, Y-1, Z-1, ...]."""
    X, Y, Z = arr.shape[:3]
    views = [arr[dx : X - 1 + dx, dy : Y - 1 + dy, dz : Z - 1 + dz] for dx, dy, dz in CORNER_OFFSETS.tolist()]
    return torch.stack(views, dim=0)


def cell_validity(state: VolumeState) -> Tuple[torch.Tensor, torch.Tensor]:
    """(valid, crossing): cells whose 8 corners are all observed, and whose
    corner sdf signs differ (surface passes through)."""
    valid = (corner_views(state.weight) > 0.0).all(dim=0)
    inside = corner_views(state.tsdf) < 0.0
    crossing = inside.any(dim=0) & (~inside).any(dim=0)
    return valid, crossing


def archived_emission_mask(state: VolumeState) -> torch.Tensor:
    """Cells ready for one-time emission: fully archived, unmeshed, on-surface."""
    valid, crossing = cell_validity(state)
    arch = corner_views(state.archived).all(dim=0)
    meshed = state.cell_meshed[:-1, :-1, :-1]
    return valid & crossing & arch & ~meshed


def forced_emission_mask(state: VolumeState, force: torch.Tensor) -> torch.Tensor:
    """Cells to emit because voxels in `force` (bool voxel grid) are about to
    be dropped (scroll-out) — any corner forced."""
    valid, crossing = cell_validity(state)
    f = corner_views(force).any(dim=0)
    meshed = state.cell_meshed[:-1, :-1, :-1]
    return valid & crossing & f & ~meshed


def finish_emission_mask(state: VolumeState) -> torch.Tensor:
    """Everything still unmeshed with a surface (finishMapping flush)."""
    valid, crossing = cell_validity(state)
    meshed = state.cell_meshed[:-1, :-1, :-1]
    return valid & crossing & ~meshed


_TABLES = {}


def _tables(device):
    key = str(device)
    if key not in _TABLES:
        _TABLES[key] = tuple(
            torch.from_numpy(a).long().to(device) for a in (CORNER_OFFSETS, TETS, TET_TABLE, TET_EDGES)
        )
    return _TABLES[key]


def _extract_device(
    state: VolumeState,
    emit_mask: torch.Tensor,
    voxel_size: float,
    max_cells: int,
    tri_capacity: int,
):
    """One emission round on the device: (cell_meshed', packed [cap, 12]
    int32 words, meta f32 [9] = n_tris, n_want, n_emitted, t_base, tick,
    qscale, base xyz). The host waits for the card in `mark_meshed` only."""
    X, Y, Z = state.tsdf.shape
    cell_ids, n_want = select_cells(state, emit_mask, max_cells)
    safe_ids, (ii, jj, kk) = cell_corners(cell_ids, Y - 1, Z - 1)
    corners = corner_values(state, ii, jj, kk)
    origin = [int(o) for o in state.origin.tolist()]
    done, packed, meta = emit_cells(
        corners, (ii, jj, kk), cell_ids >= 0, n_want, origin, (X, Y, Z), voxel_size, tri_capacity
    )
    return mark_meshed(state.cell_meshed, X - 1, safe_ids, done), packed, meta


def select_cells(state: VolumeState, emit_mask: torch.Tensor, max_cells: int):
    """(cell ids [max_cells] int32 in linear cell order, -1 padded; the count
    of cells wanted). Already-meshed cells are excluded HERE too, so repeated
    rounds with the same mask are incremental. `state`'s first
    emit_mask.shape[0] x-planes hold the cells (a slab of a sharded grid
    passes itself extended by its neighbour's first plane)."""
    cx = emit_mask.shape[0]
    flat = (emit_mask & ~state.cell_meshed[:cx, :-1, :-1]).reshape(-1)
    return compact_indices(flat, max_cells), flat.sum(dtype=torch.int32)


def cell_corners(cell_ids: torch.Tensor, CY: int, CZ: int):
    """(clamped cell ids int64, the 8 corner voxel indices (ii, jj, kk) of
    each cell, [C, 8] each)."""
    off = _tables(cell_ids.device)[0]
    safe_ids = cell_ids.clamp_min(0).long()
    ci = safe_ids // (CY * CZ)
    cj = (safe_ids // CZ) % CY
    ck = safe_ids % CZ
    return safe_ids, tuple(c[:, None] + off[None, :, a] for a, c in enumerate((ci, cj, ck)))


def corner_values(state: VolumeState, ii, jj, kk):
    """(sdf, first_obs, last_obs, color, label) at the corners, [C, 8(, 3)]."""
    return (
        state.tsdf[ii, jj, kk],
        state.first_obs[ii, jj, kk],
        state.last_obs[ii, jj, kk],
        state.color[ii, jj, kk],
        state.label[ii, jj, kk],
    )


def emit_cells(corners, idx, taken, n_want, origin, shape, voxel_size: float, tri_capacity: int):
    """The triangles of the taken cells: (done [C] bool, packed [cap, 12]
    int32 words, meta f32 [9]). corners: corner_values at the cells' corner
    indices idx = (ii, jj, kk) of the grid whose origin (host ints) and shape
    are given (the whole grid, also for a sharded one)."""
    sdf, first, last, color, label = corners
    X, Y, Z = shape
    dev = sdf.device
    _, tets, tet_table, edge_v = _tables(dev)
    pos = torch.stack(
        [(c.to(torch.float32) + float(origin[a]) + 0.5) * voxel_size for a, c in enumerate(idx)],
        dim=-1,
    )  # [C,8,3]

    # tets: [C, 6, 4]
    t_sdf = sdf[:, tets]
    inside = (t_sdf < 0.0).to(torch.int64)
    case = inside[..., 0] + inside[..., 1] * 2 + inside[..., 2] * 4 + inside[..., 3] * 8  # [C,6]

    tri_edges = tet_table[case]  # [C,6,2,3] edge ids or -1
    tri_valid = (tri_edges[..., 0] >= 0) & taken[:, None, None]  # [C,6,2]

    safe_edges = tri_edges.clamp_min(0)
    lv_p = edge_v[safe_edges, 0]
    lv_q = edge_v[safe_edges, 1]
    t_idx = torch.arange(6, device=dev)[None, :, None, None]
    gc_p = tets[t_idx, lv_p]  # global corner ids [C,6,2,3]
    gc_q = tets[t_idx, lv_q]

    C = sdf.shape[0]
    c_idx = torch.arange(C, device=dev)[:, None, None, None]

    def corner_gather(values, gc):
        return values[c_idx, gc]  # [C,6,2,3,...]

    sdf_p = corner_gather(sdf, gc_p)
    sdf_q = corner_gather(sdf, gc_q)
    denom = sdf_p - sdf_q
    t_interp = torch.where(
        denom.abs() > 1e-9, sdf_p / torch.where(denom == 0, 1e-9, denom), 0.5
    ).clamp(0.0, 1.0)[..., None]  # [C,6,2,3,1]

    pos_p = corner_gather(pos, gc_p)
    pos_q = corner_gather(pos, gc_q)
    verts = pos_p + t_interp * (pos_q - pos_p)  # [C,6,2,3,3]

    col_p = corner_gather(color, gc_p)
    col_q = corner_gather(color, gc_q)
    vcolor = col_p + t_interp * (col_q - col_p)

    vfirst = torch.minimum(corner_gather(first, gc_p), corner_gather(first, gc_q))
    vlast = torch.maximum(corner_gather(last, gc_p), corner_gather(last, gc_q))
    vlabel = torch.where(t_interp[..., 0] < 0.5, corner_gather(label, gc_p), corner_gather(label, gc_q))

    # ---- device-side compaction to tri_capacity ----
    # Cells whose triangles don't fit are NOT marked meshed (they re-emit in
    # the next round), so the cap never loses geometry.
    valid_flat = tri_valid.reshape(C, 12)
    counts = valid_flat.sum(dim=1)
    fits = torch.cumsum(counts, 0) <= tri_capacity
    done = taken & fits
    n_emitted = done.sum(dtype=torch.int32)

    kept = (valid_flat & done[:, None]).reshape(C * 12)
    n_tris = kept.sum(dtype=torch.int32)

    # ---- quantized packing: 12 uint32 words / triangle ----
    # verts: u16 in qscale units from the grid base; colors: u8; labels: u8
    # (+1, 0=none); stamps: u16 ticks from t_base (tick adapts to the span).
    # grid base (origin * voxel in float32, as the reference) as host scalars:
    # building a device tensor from host values would wait for the device
    base = [float(np.float32(o) * np.float32(voxel_size)) for o in origin]
    extent = float(max(X, Y, Z)) * voxel_size
    qscale = extent / 65535.0
    kr = kept.reshape(C, 6, 2)
    f_rows = torch.where(kr[..., None], vfirst, INF)
    l_rows = torch.where(kr[..., None], vlast, -INF)
    t_base = f_rows.min()
    t_base = torch.where(torch.isfinite(t_base), t_base, 0.0)
    t_max = l_rows.max()
    t_max = torch.where(torch.isfinite(t_max), t_max, 0.0)
    tick = true_div(t_max - t_base, 65535.0).clamp_min(1e-4)

    def to_u16(q):  # float in any range -> int64 in [0, 65535]
        return q.clamp(0, 65535).to(torch.int64)

    rel = torch.stack([verts[..., a] - base[a] for a in range(3)], dim=-1)
    vq = to_u16(torch.round(true_div(rel, qscale))).reshape(C * 12, 9)
    cq = to_u16(torch.round(vcolor * 255.0).clamp(0, 255)).reshape(C * 12, 9)
    lq = (vlabel.to(torch.int64) + 1).clamp(0, 255).reshape(C * 12, 3)
    fq = to_u16(torch.floor((vfirst - t_base) / tick)).reshape(C * 12, 3)
    gq = to_u16(torch.ceil((vlast - t_base) / tick)).reshape(C * 12, 3)

    words = torch.stack(
        [
            vq[:, 0] | (vq[:, 1] << 16),
            vq[:, 2] | (vq[:, 3] << 16),
            vq[:, 4] | (vq[:, 5] << 16),
            vq[:, 6] | (vq[:, 7] << 16),
            vq[:, 8],
            cq[:, 0] | (cq[:, 1] << 8) | (cq[:, 2] << 16) | (cq[:, 3] << 24),
            cq[:, 4] | (cq[:, 5] << 8) | (cq[:, 6] << 16) | (cq[:, 7] << 24),
            cq[:, 8] | (lq[:, 0] << 8) | (lq[:, 1] << 16) | (lq[:, 2] << 24),
            fq[:, 0] | (fq[:, 1] << 16),
            fq[:, 2] | (gq[:, 0] << 16),
            gq[:, 1] | (gq[:, 2] << 16),
            torch.zeros_like(vq[:, 0]),
        ],
        dim=1,
    )  # [C*12, 12] uint32 values in int64
    packed = compact_rows(u32_bits(words), kept, tri_capacity)
    meta = torch.stack(
        [
            n_tris.to(torch.float32),
            n_want.to(torch.float32),
            n_emitted.to(torch.float32),
            t_base,
            tick,
            *(torch.full((), v, dtype=torch.float32, device=dev) for v in (qscale, *base)),
        ]
    )
    return done, packed, meta


def mark_meshed(cell_meshed: torch.Tensor, cx: int, ids: torch.Tensor, done: torch.Tensor,
                zero_alias: bool = True) -> torch.Tensor:
    """cell_meshed with a round's writes to the cells held in its first cx
    x-planes: slot k sets cell ids[k] when done[k]. Every other cell has at
    most one slot: its emitted write lands as is (the rest go to a dropped
    extra cell). With zero_alias, cell (0, 0, 0) takes the write of the last
    slot aliasing it, in slot order: True if that slot emitted it, else its
    old value (the padding slots alias it).

    On the card the host waits twice: the written scalar is copied to the
    card (`wait/mark_meshed`), and the 0-dim slot index is read back
    (`wait/mark_meshed_alias`)."""
    CY, CZ = cell_meshed.shape[1] - 1, cell_meshed.shape[2] - 1
    n_cells = cx * CY * CZ
    meshed_flat = torch.cat([cell_meshed[:cx, :-1, :-1].reshape(-1), done.new_zeros(1)])
    on_card = cell_meshed.is_cuda
    with Wait("mark_meshed", on_card):
        meshed_flat[torch.where(done & (ids != 0) if zero_alias else done, ids, n_cells)] = True
    if zero_alias:
        last = torch.where(ids == 0, torch.arange(ids.shape[0], device=ids.device), -1).max()
        with Wait("mark_meshed_alias", on_card):
            meshed_flat[0] |= done[last.clamp_min(0)] & (last >= 0)
    out = cell_meshed.clone()
    out[:cx, :-1, :-1] = meshed_flat[:n_cells].view(cx, CY, CZ)
    return out


def default_tri_capacity(max_cells: int) -> int:
    return max(min(6 * max_cells, 16384), 1024)


def extract_mesh(
    config: VolumeConfig,
    state: VolumeState,
    emit_mask: torch.Tensor,
    max_cells: int = 16384,
    tri_capacity: int = None,
):
    """One emission round. Returns (new_state, host mesh dict, n_remaining).

    n_remaining > 0 means more cells wanted emission than fit — call again
    with a recomputed mask; unemitted cells keep their cell_meshed flag clear."""
    state, packed, meta = extract_mesh_async(state, emit_mask, config, max_cells, tri_capacity)
    out, n_remaining = pull_mesh(packed, meta)
    return state, out, n_remaining


def min_cells_per_round(max_cells: int, tri_capacity: int = None) -> int:
    """Guaranteed number of wanted cells consumed by one emission round
    (each cell yields at most 12 triangles)."""
    if tri_capacity is None:
        tri_capacity = default_tri_capacity(max_cells)
    return max(1, min(max_cells, tri_capacity // 12))


def extract_mesh_async(
    state: VolumeState,
    emit_mask: torch.Tensor,
    config: VolumeConfig,
    max_cells: int = 16384,
    tri_capacity: int = None,
):
    """Device-side emission round only: returns (state', packed int32
    [tri_capacity, 12], meta float32 [9]), both on the device. The caller
    copies the meta to the host (its own HostCopy, or the active window's
    bus) and then only the used body rows (`start_body_pull`): the fixed
    buffer (768 KB at the default capacity) is mostly padding."""
    if tri_capacity is None:
        tri_capacity = default_tri_capacity(max_cells)
    cell_meshed, packed, meta = _extract_device(
        state, emit_mask, config.voxel_size, max_cells, tri_capacity
    )
    return state._replace(cell_meshed=cell_meshed), packed, meta


def start_body_pull(packed: torch.Tensor, n_tris: int, earliest: bool = False):
    """Start the host copy of the used rows of an emission buffer: a HostCopy
    (`earliest` as HostCopy's), or None when the round emitted nothing."""
    if n_tris <= 0:
        return None
    return HostCopy(packed[:n_tris], earliest=earliest, site="mesh_body")


def body_rows(body) -> np.ndarray:
    """A started body pull's rows as uint32 [n, 12], waiting for the copy."""
    if body is None:
        return np.zeros((0, 12), np.uint32)
    return body.numpy(0).view(np.uint32)


def pull_mesh(packed: torch.Tensor, meta: torch.Tensor):
    """Copy an emission round to the host, waiting, and unpack it:
    (mesh dict, n_remaining)."""
    meta = HostCopy(meta, site="mesh_meta").numpy(0)
    return unpack_mesh(body_rows(start_body_pull(packed, int(meta[0]))), meta)


def unpack_mesh(packed: np.ndarray, meta: np.ndarray):
    """Quantized emission buffer + meta -> (mesh dict, n_remaining)."""
    n = int(meta[0])
    n_want = int(meta[1])
    n_emitted = int(meta[2])
    t_base, tick, qscale = float(meta[3]), float(meta[4]), float(meta[5])
    base = meta[6:9].astype(np.float32)
    body = packed[:n].astype(np.uint32)

    def u16(col, hi):
        w = body[:, col]
        return ((w >> 16) if hi else (w & 0xFFFF)).astype(np.float32)

    vq = np.stack(
        [u16(0, 0), u16(0, 1), u16(1, 0), u16(1, 1), u16(2, 0), u16(2, 1),
         u16(3, 0), u16(3, 1), u16(4, 0)],
        axis=1,
    )
    verts = (vq * qscale + np.tile(base, 3)[None, :]).reshape(-1, 3, 3)
    cb = np.stack(
        [(body[:, 5] >> s) & 0xFF for s in (0, 8, 16, 24)]
        + [(body[:, 6] >> s) & 0xFF for s in (0, 8, 16, 24)]
        + [body[:, 7] & 0xFF],
        axis=1,
    ).astype(np.float32) / 255.0
    labels = np.stack(
        [(body[:, 7] >> s) & 0xFF for s in (8, 16, 24)], axis=1
    ).astype(np.int32) - 1
    first = np.stack([u16(8, 0), u16(8, 1), u16(9, 0)], axis=1) * tick + t_base
    last = np.stack([u16(9, 1), u16(10, 0), u16(10, 1)], axis=1) * tick + t_base
    out = {
        "vertices": verts.astype(np.float32),
        "colors": cb.reshape(-1, 3, 3),
        "first_obs": first.astype(np.float32),
        "last_obs": last.astype(np.float32),
        "labels": labels,
    }
    return out, max(0, n_want - n_emitted)
