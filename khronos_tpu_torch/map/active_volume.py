"""ActiveVolume: dense scrolling TSDF+semantic+tracking voxel grid.

Port of `khronos_tpu/map/active_volume.py` (the reference's hydra
VolumetricMap + ProjectiveIntegrator + khronos TrackingIntegrator, SURVEY.md
§2.1/§2.3): the active window is ONE fixed-shape dense grid that scrolls with
the camera, and every per-frame update is a masked elementwise op or a gather
over the grid.

Channels (all [X, Y, Z] float32 unless noted): tsdf, weight, color [...,3],
label int32 (-1 none), label_weight, first_obs (+inf), last_obs (-inf),
last_occupied (-inf), ever_free bool, archived bool, cell_meshed bool.

Differences from the JAX module, all without effect on results:
- `VolumeState.origin` is an int32[3] CPU tensor even when the grids live on
  CUDA: it is host metadata (crop starts and scroll shifts are host integers),
  so reading it never waits for the device.
- `crop_start` returns host ints, `slice_state` returns views, and
  `unslice_state` writes the crop back into the full grid IN PLACE.
- `integrate_frame` looks up the per-voxel pixel payload with kernel B
  (ops/gather.py) and is otherwise elementwise PyTorch; it returns new
  tensors and leaves its input state untouched.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from khronos_tpu_torch import fma32, resolve_device, sqrt32, true_div, u32_bits
from khronos_tpu_torch.config import check_ge, check_gt
from khronos_tpu_torch.geometry.camera import Camera, voxel_floor, world_to_camera
from khronos_tpu_torch.ops.dense import all_pool3, any_pool3
from khronos_tpu_torch.ops.gather import gather_rows

INF = float("inf")


@dataclasses.dataclass
class VolumeConfig:
    grid_shape: Tuple[int, int, int] = (128, 128, 64)
    voxel_size: float = 0.1  # m
    truncation_distance: float = 0.2  # m (2-3x voxel, uHumans2.yaml:46)
    max_weight: float = 100.0
    # tracking layer (reference tracking_integrator.h:79-80)
    temporal_window: float = 3.0  # s until a voxel exits the active window
    temporal_buffer: float = 0.5  # s a voxel must stay free to become ever-free
    # Occupancy threshold for the tracking layer, reference semantics
    # (tracking_integrator.cpp:136-138): negative values are multiples of the
    # voxel size with the sign flipped — the default -1.5 means "occupied iff
    # tsdf < +1.5 * voxel_size".
    tsdf_occupancy_threshold: float = -1.5
    recenter_margin: float = 3.0  # m camera-to-center slack before scrolling

    def check(self):
        check_gt(self.voxel_size, 0.0, "voxel_size")
        check_gt(self.truncation_distance, self.voxel_size * 0.99, "truncation_distance")
        check_gt(self.temporal_window, 0.0, "temporal_window")
        for s in self.grid_shape:
            check_ge(s, 8, "grid_shape")

    @property
    def occupancy_threshold(self) -> float:
        t = self.tsdf_occupancy_threshold
        return -t * self.voxel_size if t < 0 else t


class VolumeState(NamedTuple):
    origin: torch.Tensor  # int32[3] (CPU) world voxel index of grid cell (0,0,0)
    tsdf: torch.Tensor
    weight: torch.Tensor
    color: torch.Tensor
    label: torch.Tensor
    label_weight: torch.Tensor
    first_obs: torch.Tensor
    last_obs: torch.Tensor
    last_occupied: torch.Tensor
    ever_free: torch.Tensor
    archived: torch.Tensor
    cell_meshed: torch.Tensor


GRID_FIELDS = VolumeState._fields[1:]


def create(config: VolumeConfig, origin_xyz: Optional[np.ndarray] = None, device=None) -> VolumeState:
    """Fresh volume; origin_xyz (m) is the world position of grid corner (0,0,0)."""
    dev = resolve_device(device)
    shape = tuple(config.grid_shape)
    if origin_xyz is None:
        origin_xyz = -0.5 * np.asarray(shape) * config.voxel_size
    origin = np.floor(np.asarray(origin_xyz) / config.voxel_size).astype(np.int32)

    def z(v, dt=torch.float32):
        return torch.full(shape, v, dtype=dt, device=dev)

    return VolumeState(
        origin=torch.from_numpy(origin),
        tsdf=z(config.truncation_distance),
        weight=z(0.0),
        color=torch.zeros(shape + (3,), dtype=torch.float32, device=dev),
        label=z(-1, torch.int32),
        label_weight=z(0.0),
        first_obs=z(INF),
        last_obs=z(-INF),
        last_occupied=z(-INF),
        ever_free=z(False, torch.bool),
        archived=z(False, torch.bool),
        cell_meshed=z(False, torch.bool),
    )


def state_from_numpy(fields, device=None) -> VolumeState:
    """A volume given as numpy arrays in VolumeState field order (e.g. a JAX
    VolumeState converted with np.asarray per field, or a dict by field name)
    -> the port's state on `device` (origin stays on the CPU)."""
    dev = resolve_device(device)
    if isinstance(fields, dict):
        fields = [fields[f] for f in VolumeState._fields]
    fields = [np.asarray(a) for a in fields]
    if len(fields) != len(VolumeState._fields):
        raise ValueError(f"state_from_numpy: need {len(VolumeState._fields)} fields, got {len(fields)}")
    origin = torch.from_numpy(fields[0].astype(np.int32).reshape(3).copy())
    # copies: the port updates grids in place, and a JAX array's buffer is read-only
    grids = [torch.from_numpy(np.array(a)).to(dev) for a in fields[1:]]
    return VolumeState(origin, *grids)


def state_to_numpy(state: VolumeState) -> VolumeState:
    """The port's state -> a VolumeState of host numpy arrays (same field
    order and dtypes as the JAX VolumeState)."""
    return VolumeState(*[t.detach().cpu().numpy() for t in state])


def _origin(state: VolumeState):
    return [int(v) for v in state.origin.tolist()]


def voxel_centers(state: VolumeState, voxel_size: float) -> torch.Tensor:
    """World-frame voxel center positions [X, Y, Z, 3]."""
    return torch.stack(_center_components(state, voxel_size), dim=-1)


def _center_components(state: VolumeState, voxel_size: Optional[float]):
    """Per-axis center coordinates, broadcast to [X, Y, Z] each; in voxels
    (index + 0.5) when voxel_size is None."""
    dev = state.tsdf.device
    shape = state.tsdf.shape
    comps = []
    for axis, (n, o) in enumerate(zip(shape, _origin(state))):
        c = (torch.arange(n, dtype=torch.int32, device=dev) + o).to(torch.float32) + 0.5
        if voxel_size is not None:
            c = c * voxel_size
        view = [1, 1, 1]
        view[axis] = n
        comps.append(c.view(view).expand(shape))
    return comps


def world_to_index(state: VolumeState, points: torch.Tensor, voxel_size: float):
    """World points [..., 3] -> (grid index int32 [..., 3], in-bounds mask)."""
    origin = torch.tensor(_origin(state), dtype=torch.int32, device=points.device)
    idx = voxel_floor(points, voxel_size) - origin
    shape = torch.tensor(tuple(state.tsdf.shape), dtype=torch.int32, device=points.device)
    ok = ((idx >= 0) & (idx < shape)).all(dim=-1)
    return idx, ok


def _reset_values(config: VolumeConfig, state: VolumeState, reset: torch.Tensor, pool_cells: bool = True) -> VolumeState:
    """Clear voxel data where `reset` (bool grid) — used for re-observation of
    archived voxels and for scroll-in regions. pool_cells=False leaves the
    meshed flags to the caller."""
    r3 = reset[..., None]
    # a reset voxel invalidates the meshed flag of every cell touching it
    cell_meshed = state.cell_meshed & ~any_pool3(reset) if pool_cells else state.cell_meshed
    return state._replace(
        tsdf=torch.where(reset, config.truncation_distance, state.tsdf),
        weight=torch.where(reset, 0.0, state.weight),
        color=torch.where(r3, 0.0, state.color),
        label=torch.where(reset, -1, state.label),
        label_weight=torch.where(reset, 0.0, state.label_weight),
        first_obs=torch.where(reset, INF, state.first_obs),
        last_obs=torch.where(reset, -INF, state.last_obs),
        last_occupied=torch.where(reset, -INF, state.last_occupied),
        ever_free=state.ever_free & ~reset,
        archived=state.archived & ~reset,
        cell_meshed=cell_meshed,
    )


def pack_pixels(depth: torch.Tensor, color: torch.Tensor, labels: torch.Tensor, exclusion_mask: torch.Tensor) -> torch.Tensor:
    """[H*W, 2] float32 payload image: depth, then one word packing rgb as
    3 x u8 | (label+1) in 7 bits | exclusion in bit 31 (bit-cast, not converted)."""
    rgb = (color.clamp(0.0, 1.0) * 255.0).to(torch.int64)  # truncation toward zero
    word = (
        rgb[..., 0]
        | (rgb[..., 1] << 8)
        | (rgb[..., 2] << 16)
        | ((labels.to(torch.int64) + 1).clamp(0, 126) << 24)
        | (exclusion_mask.to(torch.int64) << 31)
    )
    packed = torch.stack([depth.contiguous().view(torch.int32), u32_bits(word)], dim=-1)
    return packed.reshape(-1, 2).view(torch.float32)


INV_255 = float(np.float32(1.0) / np.float32(255.0))


def integrate_frame(
    config: VolumeConfig,
    camera: Camera,
    state: VolumeState,
    depth: torch.Tensor,
    color: torch.Tensor,
    labels: torch.Tensor,
    exclusion_mask: torch.Tensor,
    R_w_c,
    t_w_c,
    t_now,
    eager: bool = False,
) -> VolumeState:
    """Projective TSDF + color + semantic + tracking-layer update for one frame.

    Equivalent of hydra::ProjectiveIntegrator::updateMap with the khronos
    dynamic integration mask (active_window.cpp:203-215) fused with
    TrackingIntegrator::updateBlocks (tracking_integrator.cpp:71-104).

    exclusion_mask: bool [H, W], True = pixel excluded (dynamic object).
    R_w_c, t_w_c: host float32 pose; t_now: seconds (rounded to float32).
    eager: round as the reference's modular window path, which calls its
    integrate_frame outside jit (`active_window.py:406`), one XLA operation
    at a time: no product is fused into a sum, and the division by 255 is a
    true division. By default the rounding of the reference's compiled
    programs (the fused and the sharded step)."""
    packed_img = pack_pixels(depth, color, labels, exclusion_mask)
    state, cand, upd = integrate_frame_local(config, camera, state, packed_img, R_w_c, t_w_c, t_now, eager)
    return integrate_frame_pools(state, all_pool3(cand), any_pool3(upd))


def integrate_frame_local(
    config: VolumeConfig, camera: Camera, state: VolumeState, packed_img: torch.Tensor, R_w_c, t_w_c, t_now,
    eager: bool = False,
):
    """integrate_frame up to its two 3x3x3 stencils: (state with every
    per-voxel update applied, the ever-free candidates `cand`, the updated
    voxels `upd`). `integrate_frame_pools` finishes it from all_pool3(cand)
    and any_pool3(upd); a slab of a sharded grid pools them over a one-plane
    halo from its neighbours (parallel/sharding.py). packed_img is
    pack_pixels' [H*W, 2] payload image on the state's device; eager as in
    integrate_frame."""
    t_now = float(np.float32(t_now))
    tau = float(np.float32(config.truncation_distance))
    shape = state.tsdf.shape
    # XLA CPU rounds the reference's projection so (probed on its compiled
    # integrate_frame, tests/test_torch_contraction.py): each center less t
    # in one rounding, fma(index + 0.5, voxel, -t); R^T by world_to_camera's
    # rule; the pixel coordinates fma(x / z, f, c). Eager, every operation
    # rounds alone (the einsum keeps its rule: XLA CPU compiles it alike).
    if eager:
        pc = world_to_camera(_center_components(state, config.voxel_size), R_w_c, t_w_c)
    else:
        pc = world_to_camera(_center_components(state, None), R_w_c, t_w_c, scale=config.voxel_size)
    z = pc[2]
    safe_z = torch.where(z > 1e-6, z, 1e-6)
    if eager:
        u = pc[0] / safe_z * camera.fx + camera.cx
        v = pc[1] / safe_z * camera.fy + camera.cy
    else:
        u = fma32(pc[0] / safe_z, camera.fx, camera.cx)
        v = fma32(pc[1] / safe_z, camera.fy, camera.cy)
    in_img = (z > 1e-6) & camera.in_image(u, v)
    # clamp in float first: an out-of-range float->int cast is undefined (the
    # index only matters where in_img holds)
    ui = torch.round(u - 0.5).clamp(-1, camera.width).to(torch.int32).clamp(0, camera.width - 1)
    vi = torch.round(v - 0.5).clamp(-1, camera.height).to(torch.int32).clamp(0, camera.height - 1)

    # per-voxel payload lookup (kernel B): depth + one packed word per voxel
    lin_pix = (vi * camera.width + ui).reshape(-1)
    pix = gather_rows(packed_img, lin_pix)
    d = pix[:, 0].reshape(shape)
    w_bits = pix.view(torch.int32)[:, 1].reshape(shape)
    pix_rgb = torch.stack([w_bits & 0xFF, (w_bits >> 8) & 0xFF, (w_bits >> 16) & 0xFF], dim=-1).to(torch.float32)
    pix_label = ((w_bits >> 24) & 0x7F) - 1
    pix_excluded = ((w_bits >> 31) & 1) > 0

    valid_pix = in_img & (d > camera.min_range) & (d <= camera.max_range)
    # along-ray signed distance (projective): scale z-difference by range/z
    if eager:
        range_scale = sqrt32(pc[0] * pc[0] + pc[1] * pc[1] + z * z) / safe_z
    else:
        range_scale = sqrt32(fma32(z, z, fma32(pc[0], pc[0], pc[1] * pc[1]))) / safe_z
    sdf = (d - z) * range_scale

    upd = valid_pix & (sdf > -tau) & (z <= camera.max_range) & ~pix_excluded

    # lazy reset of archived voxels being re-observed (fresh data); its
    # cell-meshed stencil is left to the pools: reset voxels are updated ones
    state = _reset_values(config, state, upd & state.archived, pool_cells=False)

    w = state.weight
    w_new = torch.where(upd, (w + 1.0).clamp_max(config.max_weight), w)
    sdf_c = sdf.clamp(-tau, tau)
    near_surface = upd & (sdf.abs() <= tau)
    cw = w.clamp_max(20.0)[..., None]
    if eager:
        tsdf_sum = state.tsdf * w + sdf_c
        color_sum = state.color * cw + true_div(pix_rgb, 255.0)
    else:
        tsdf_sum = fma32(state.tsdf, w, sdf_c)
        # pix_color = rgb / 255 (XLA: times the float32 reciprocal), fused into the sum
        color_sum = fma32(pix_rgb, INV_255, state.color * cw)
    tsdf_new = torch.where(upd, tsdf_sum / (w + 1.0), state.tsdf)
    color_new = torch.where(near_surface[..., None], color_sum / (cw + 1.0), state.color)
    # winner-take-all semantic fusion (counting argmax)
    has_label = near_surface & (pix_label >= 0)
    same = has_label & (pix_label == state.label)
    diff = has_label & (pix_label != state.label)
    lw = state.label_weight
    lw_new = torch.where(same, lw + 1.0, torch.where(diff, lw - 1.0, lw))
    takeover = diff & (lw_new <= 0.0)
    label_new = torch.where(takeover, pix_label, state.label)
    lw_new = torch.where(takeover, 1.0, lw_new)

    first_obs = torch.where(upd, state.first_obs.clamp_max(t_now), state.first_obs)
    last_obs = torch.where(upd, t_now, state.last_obs)

    # tracking layer (occupancy from the *updated* tsdf), reference
    # voxelIsFree (tracking_integrator.cpp:248-252). Ever-free is only ever
    # set here; archival and lazy reset clear it.
    occ = (w_new > 0.0) & (tsdf_new < config.occupancy_threshold)
    last_occupied = torch.where(occ, t_now, state.last_occupied)
    cand = (w_new > 0.0) & (last_occupied + config.temporal_buffer < t_now)
    state = state._replace(
        tsdf=tsdf_new,
        weight=w_new,
        color=color_new,
        label=label_new,
        label_weight=lw_new,
        first_obs=first_obs,
        last_obs=last_obs,
        last_occupied=last_occupied,
    )
    return state, cand, upd


def integrate_frame_pools(state: VolumeState, cand_all: torch.Tensor, upd_any: torch.Tensor) -> VolumeState:
    """The end of integrate_frame: ever-free where the whole 3x3x3
    neighbourhood is a candidate (cand_all = all_pool3(cand)), and
    integration dirties the meshed flag of every cell touching an updated
    voxel (upd_any = any_pool3(upd))."""
    return state._replace(ever_free=state.ever_free | cand_all, cell_meshed=state.cell_meshed & ~upd_any)


def crop_shape_for_camera(config: VolumeConfig, camera: Camera) -> Tuple[int, int, int]:
    """Static xy crop size (voxels) of a box guaranteed to contain the camera
    frustum (range ball + truncation + one-voxel stencil margin), rounded up
    to a multiple of 8; z is never cropped (grids are shallow)."""
    need = int(np.ceil(2.0 * (camera.max_range + config.truncation_distance) / config.voxel_size)) + 4
    need = (need + 7) // 8 * 8
    X, Y, Z = config.grid_shape
    return (min(X, need), min(Y, need), Z)


def integrate_frame_cropped(
    config: VolumeConfig,
    camera: Camera,
    state: VolumeState,
    depth: torch.Tensor,
    color: torch.Tensor,
    labels: torch.Tensor,
    exclusion_mask: torch.Tensor,
    R_w_c,
    t_w_c,
    t_now,
) -> VolumeState:
    """integrate_frame restricted to a camera-centered subgrid: the projective
    update only touches voxels within max_range of the camera, and the box
    includes a stencil margin, so every voxel within range sees its true
    26-neighborhood; voxels outside it are untouched. Writes the crop back
    into `state` in place (as the fused step does)."""
    crop = crop_shape_for_camera(config, camera)
    if all(c >= s for c, s in zip(crop, state.tsdf.shape)):
        return integrate_frame(
            config, camera, state, depth, color, labels, exclusion_mask, R_w_c, t_w_c, t_now
        )
    start = crop_start(config, state, t_w_c, crop)
    sub = slice_state(state, start, crop)
    sub = integrate_frame(
        config, camera, sub, depth, color, labels, exclusion_mask, R_w_c, t_w_c, t_now
    )
    return unslice_state(state, sub, start)


def crop_start(config: VolumeConfig, state: VolumeState, t_w_c, crop) -> Tuple[int, int, int]:
    """Camera-centered crop start (grid-local voxel index, clamped in-bounds),
    computed on the host in float32 like the reference's device program."""
    X, Y, Z = state.tsdf.shape
    t = np.asarray(t_w_c, np.float32)
    cam_vox = np.floor(t / np.float32(config.voxel_size)).astype(np.int32) - np.asarray(_origin(state), np.int32)
    hi = np.asarray((X - crop[0], Y - crop[1], Z - crop[2]), np.int32)
    start = np.clip(cam_vox - np.asarray(crop, np.int32) // 2, 0, hi)
    return tuple(int(s) for s in start)


def _crop_index(start, crop):
    return tuple(slice(s, s + c) for s, c in zip(start, crop))


def slice_state(state: VolumeState, start, crop) -> VolumeState:
    """Views of the crop box starting at `start` (host ints)."""
    ix = _crop_index(start, crop)
    return VolumeState(
        origin=state.origin + torch.tensor(start, dtype=torch.int32),
        **{f: getattr(state, f)[ix] for f in GRID_FIELDS},
    )


def unslice_state(full: VolumeState, sub: VolumeState, start) -> VolumeState:
    """Write the crop `sub` back into `full` at `start`, in place; returns full."""
    ix = _crop_index(start, sub.tsdf.shape)
    for f in GRID_FIELDS:
        getattr(full, f)[ix].copy_(getattr(sub, f))
    return full


def update_archival(config: VolumeConfig, state: VolumeState, t_now, eager: bool = False) -> VolumeState:
    """Flag voxels unobserved for temporal_window as archived
    (TrackingIntegrator::resetInactive equivalent; data stays until reuse).
    Ever-free is cleared on archival (the reference removes inactive blocks).

    The horizon t_now - temporal_window is a float32 difference, as in the
    reference's compiled programs; eager (its modular window path, which
    calls this outside jit with a Python t_now), the float64 difference
    rounded once to float32."""
    if eager:
        horizon = float(np.float32(float(t_now) - config.temporal_window))
    else:
        horizon = float(np.float32(t_now) - np.float32(config.temporal_window))
    inactive = (state.weight > 0.0) & (state.last_obs < horizon)
    archived = state.archived | inactive
    return state._replace(archived=archived, ever_free=state.ever_free & ~archived)


def active_mask(config: VolumeConfig, state: VolumeState, t_now) -> torch.Tensor:
    horizon = float(np.float32(t_now) - np.float32(config.temporal_window))
    return (state.weight > 0.0) & (state.last_obs >= horizon)


def needs_recenter(
    config: VolumeConfig, state: VolumeState, cam_pos: np.ndarray, origin_np=None
) -> bool:
    """Host-side check: camera too far from grid center? (The grid's shape
    is the config's; a sharded volume passes its ShardedVolume.)"""
    shape = np.asarray(config.grid_shape)
    origin = origin_np if origin_np is not None else np.asarray(_origin(state))
    center = (origin + shape / 2.0) * config.voxel_size
    return bool(np.any(np.abs(np.asarray(cam_pos) - center) > config.recenter_margin))


def recenter_shift(
    config: VolumeConfig, state: VolumeState, cam_pos: np.ndarray, origin_np=None
) -> np.ndarray:
    """Voxel shift that would center the grid on the camera."""
    shape = np.asarray(config.grid_shape)
    origin = origin_np if origin_np is not None else np.asarray(_origin(state))
    target_origin = np.floor(
        np.asarray(cam_pos) / config.voxel_size - shape / 2.0
    ).astype(np.int32)
    return target_origin - origin


def _axis_index(shape, axis: int, device) -> torch.Tensor:
    view = [1, 1, 1]
    view[axis] = shape[axis]
    return torch.arange(shape[axis], device=device).view(view)


def scroll_out_mask(state: VolumeState, shift: np.ndarray) -> torch.Tensor:
    """Bool grid of voxels that will leave the volume when rolled by `shift`
    (mesh these before calling `scroll`)."""
    shape = state.tsdf.shape
    out = torch.zeros(shape, dtype=torch.bool, device=state.tsdf.device)
    for axis, s in enumerate(int(v) for v in np.asarray(shift)):
        if s == 0:
            continue
        idx = _axis_index(shape, axis, out.device)
        out |= (idx < s) if s > 0 else (idx >= shape[axis] + s)
    return out


def scroll(config: VolumeConfig, state: VolumeState, shift: np.ndarray) -> VolumeState:
    """Shift the grid window by `shift` voxels (moving-volume scrolling);
    newly exposed cells are reset to defaults."""
    shift = [int(v) for v in np.asarray(shift)]
    neg = tuple(-s for s in shift)
    rolled = VolumeState(
        origin=state.origin + torch.tensor(shift, dtype=torch.int32),
        **{f: torch.roll(getattr(state, f), shifts=neg, dims=(0, 1, 2)) for f in GRID_FIELDS},
    )
    # fresh region: cells that wrapped around
    shape = state.tsdf.shape
    fresh = torch.zeros(shape, dtype=torch.bool, device=state.tsdf.device)
    for axis, s in enumerate(shift):
        if s == 0:
            continue
        idx = _axis_index(shape, axis, fresh.device)
        fresh |= (idx >= shape[axis] - s) if s > 0 else (idx < -s)
    out = _reset_values(config, rolled, fresh)
    # cells adjacent to the wrap seam must also re-mesh
    return out._replace(cell_meshed=out.cell_meshed & ~any_pool3(fresh))
