"""Port parity: map/active_volume.py (integration through kernel B's
function, crop helpers, archival, scroll) and map/meshing.py (emission masks,
quantised triangle words).

Both packages start from ONE shared non-trivial state: the JAX package
integrates a few synthetic frames, its VolumeState goes through
`state_from_numpy`, and both then run the same further steps. Integer and bool
fields must match bit for bit; tsdf and color carry the reference's einsum
rounding, so they are held to 1e-5 (a few ulp of the signed distance)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from khronos_tpu.map import active_volume as jav
from khronos_tpu.map import meshing as jm
from khronos_tpu_torch.map import active_volume as tav
from khronos_tpu_torch.map import meshing as tm

from torch_parity import assert_states_match, frames, torch_camera

GRID = (40, 40, 24)


def _frame_args(f):
    return f["depth"], f["color"], f["labels"], f["R_w_c"], f["t_w_c"]


@pytest.fixture(scope="module")
def shared():
    """(camera, frames, JAX state after 4 integrated frames)."""
    cam, fr = frames(12)
    cfg = jav.VolumeConfig(grid_shape=GRID)
    origin = np.floor(fr[0]["t_w_c"] / cfg.voxel_size - np.asarray(GRID) / 2.0).astype(np.int32)
    js = jav.create(cfg)._replace(origin=jnp.asarray(origin))
    for i in range(4):
        d, c, l, R, t = _frame_args(fr[i])
        js = jav.integrate_frame_cropped(
            cfg, cam, js, jnp.asarray(d), jnp.asarray(c), jnp.asarray(l),
            jnp.zeros(d.shape, bool), jnp.asarray(R), jnp.asarray(t), jnp.float32(fr[i]["t"]),
        )
    return cam, fr, cfg, js


def test_state_round_trip(shared):
    _, _, _, js = shared
    fields = [np.asarray(a) for a in js]
    back = tav.state_to_numpy(tav.state_from_numpy(fields, device="cpu"))
    for a, b in zip(fields, back):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_integrate_archival_scroll(shared):
    cam, fr, cfg, js = shared
    tcam = torch_camera(cam)
    # archive everything observed so far, so re-observation takes the lazy
    # reset path of integrate_frame
    ts = tav.update_archival(cfg, tav.state_from_numpy([np.asarray(a) for a in js], device="cpu"), 10.0)
    js = jav.update_archival(cfg, js, jnp.float32(10.0))
    assert_states_match(js, ts)
    crop = tav.crop_shape_for_camera(cfg, tcam)
    assert crop == jav.crop_shape_for_camera(cfg, cam)
    for i in range(4, 8):
        d, c, l, R, t = _frame_args(fr[i])
        excl = np.zeros(d.shape, bool)
        excl[: d.shape[0] // 3] = True  # exercise the exclusion bit
        tn = 10.5 + 0.1 * i
        start_j = np.asarray(jav.crop_start(cfg, js, jnp.asarray(t), crop))
        start_t = tav.crop_start(cfg, ts, t, crop)
        np.testing.assert_array_equal(start_j, start_t)
        js = jav.integrate_frame_cropped(
            cfg, cam, js, jnp.asarray(d), jnp.asarray(c), jnp.asarray(l), jnp.asarray(excl),
            jnp.asarray(R), jnp.asarray(t), jnp.float32(tn),
        )
        sub = tav.slice_state(ts, start_t, crop)
        sub = tav.integrate_frame(
            cfg, tcam, sub, torch.from_numpy(d), torch.from_numpy(c), torch.from_numpy(l),
            torch.from_numpy(excl), R, t, tn,
        )
        ts = tav.unslice_state(ts, sub, start_t)
        assert_states_match(js, ts)
    js = jav.update_archival(cfg, js, jnp.float32(13.8))
    ts = tav.update_archival(cfg, ts, 13.8)
    assert_states_match(js, ts)
    np.testing.assert_array_equal(
        np.asarray(jav.active_mask(cfg, js, jnp.float32(13.8))), tav.active_mask(cfg, ts, 13.8).numpy()
    )
    cam_pos = fr[7]["t_w_c"] + np.array([2.5, -1.7, 0.3], np.float32)
    origin = np.asarray(js.origin)
    assert jav.needs_recenter(cfg, js, cam_pos, origin) == tav.needs_recenter(cfg, ts, cam_pos, origin)
    shift = jav.recenter_shift(cfg, js, cam_pos, origin)
    np.testing.assert_array_equal(shift, tav.recenter_shift(cfg, ts, cam_pos, origin))
    for sh in (shift, np.array([-3, 0, 2], np.int32)):
        np.testing.assert_array_equal(
            np.asarray(jav.scroll_out_mask(js, sh)), tav.scroll_out_mask(ts, sh).numpy()
        )
        js = jav.scroll(cfg, js, sh)
        ts = tav.scroll(cfg, ts, sh)
        assert_states_match(js, ts)


def _mesh_state(seed, shape=(20, 18, 12)):
    rng = np.random.default_rng(seed)
    cfg = jav.VolumeConfig(grid_shape=shape)
    x = np.arange(shape[0])[:, None, None] * 0.1
    y = np.arange(shape[1])[None, :, None] * 0.2
    z = (np.arange(shape[2])[None, None, :] - shape[2] // 2) * 0.03
    tsdf = (np.sin(x * 3 + y) * 0.15 + z + rng.normal(0, 0.01, shape)).astype(np.float32)
    js = jav.create(cfg)._replace(
        origin=jnp.asarray([-7, 3, -2], jnp.int32),
        tsdf=jnp.asarray(tsdf),
        weight=jnp.asarray((rng.random(shape) < 0.95).astype(np.float32) * 3),
        color=jnp.asarray(rng.random(shape + (3,)).astype(np.float32)),
        label=jnp.asarray(rng.integers(-1, 6, shape).astype(np.int32)),
        first_obs=jnp.asarray(rng.random(shape).astype(np.float32) * 5),
        last_obs=jnp.asarray(5 + rng.random(shape).astype(np.float32) * 5),
        archived=jnp.asarray(rng.random(shape) < 0.8),
        cell_meshed=jnp.asarray(rng.random(shape) < 0.2),
    )
    return cfg, js, tav.state_from_numpy([np.asarray(a) for a in js], device="cpu")


@pytest.mark.parametrize("max_cells,tri_capacity", [(300, 2048), (64, 1024), (4096, 16384)])
def test_meshing_words_bit_exact(max_cells, tri_capacity):
    cfg, js, ts = _mesh_state(max_cells)
    force = np.zeros(cfg.grid_shape, bool)
    force[:3] = True
    for name, jmask, tmask in (
        ("finish", jm.finish_emission_mask(js), tm.finish_emission_mask(ts)),
        ("archived", jm.archived_emission_mask(js), tm.archived_emission_mask(ts)),
        ("forced", jm.forced_emission_mask(js, jnp.asarray(force)),
         tm.forced_emission_mask(ts, torch.from_numpy(force))),
    ):
        np.testing.assert_array_equal(np.asarray(jmask), tmask.numpy(), err_msg=name)
    jmask = jm.finish_emission_mask(js)
    tmask = tm.finish_emission_mask(ts)
    for _ in range(2):  # the second round is incremental (meshed cells excluded)
        jcm, jp, jmeta = jm._extract_device(js, jmask, cfg.voxel_size, max_cells, tri_capacity)
        tcm, tp, tmeta = tm._extract_device(ts, tmask, cfg.voxel_size, max_cells, tri_capacity)
        np.testing.assert_array_equal(np.asarray(jmeta), tmeta.numpy())
        np.testing.assert_array_equal(np.asarray(jp).view(np.uint32), tp.numpy().view(np.uint32))
        np.testing.assert_array_equal(np.asarray(jcm), tcm.numpy())
        js, ts = js._replace(cell_meshed=jcm), ts._replace(cell_meshed=tcm)
        n = int(np.asarray(jmeta)[0])
        want, want_rem = jm.unpack_mesh(np.asarray(jp)[:n], np.asarray(jmeta))
        got, got_rem = tm.unpack_mesh(tp.numpy()[:n].view(np.uint32), tmeta.numpy())
        assert want_rem == got_rem
        for k in want:
            np.testing.assert_array_equal(want[k], got[k], err_msg=k)


def test_extract_mesh_host_pull(shared):
    cfg, js, ts = _mesh_state(3)
    _, want, want_rem = jm.extract_mesh(cfg, js, jm.finish_emission_mask(js), max_cells=128)
    ts, got, got_rem = tm.extract_mesh(cfg, ts, tm.finish_emission_mask(ts), max_cells=128)
    assert want_rem == got_rem > 0
    for k in want:
        np.testing.assert_array_equal(want[k], got[k], err_msg=k)


def test_cell_origin_write_back_matches_reference():
    """cell_meshed after an emission round equals the reference's on the whole
    grid, cell (0, 0, 0) included. That cell takes the write of the last slot
    aliasing it: with padding slots after it (more capacity than cells) a
    padding slot's old value, so a taken cell (0, 0, 0) stays unmeshed; with
    no padding slot (capacity 1) the real write, so it is meshed."""
    cfg, js, ts = _mesh_state(9)
    shape = cfg.grid_shape
    tsdf = np.asarray(js.tsdf).copy()
    tsdf[:2, :2, :2] = np.array([-0.05, 0.05], np.float32)[None, None, :]
    weight = np.full(shape, 3.0, np.float32)
    js = js._replace(tsdf=jnp.asarray(tsdf), weight=jnp.asarray(weight), cell_meshed=jnp.zeros(shape, bool))
    ts = tav.state_from_numpy([np.asarray(a) for a in js], device="cpu")
    only = np.zeros(tuple(s - 1 for s in shape), bool)
    only[0, 0, 0] = True
    for max_cells, origin_meshed in ((16, False), (1, True)):
        jcm, _, jmeta = jm._extract_device(js, jnp.asarray(only), cfg.voxel_size, max_cells, 1024)
        tcm, _, tmeta = tm._extract_device(ts, torch.from_numpy(only), cfg.voxel_size, max_cells, 1024)
        assert float(np.asarray(jmeta)[2]) == float(tmeta[2]) == 1.0  # one cell emitted
        np.testing.assert_array_equal(np.asarray(jcm), tcm.numpy(), err_msg=f"max_cells {max_cells}")
        assert bool(tcm[0, 0, 0]) == origin_meshed


def _mark_meshed_loop(cell_meshed, cx, ids, done, zero_alias):
    """The round's write-back as a serial scatter in slot order (the
    reference's `at[...].set(where(done, True, old))` on the CPU): with
    zero_alias every slot writes its cell, True if done else the old value;
    without it only the done slots write. Slots outside the first cx
    x-planes are dropped."""
    cm = cell_meshed.numpy().copy()
    CY, CZ = cm.shape[1] - 1, cm.shape[2] - 1
    old = cm[:cx, :-1, :-1].reshape(-1).copy()
    flat = old.copy()
    for cell, d in zip(ids.tolist(), done.tolist()):
        if 0 <= cell < flat.size and (d or zero_alias):
            flat[cell] = True if d else old[cell]
    cm[:cx, :-1, :-1] = flat.reshape(cx, CY, CZ)
    return cm


# (cx, slot cell ids, done, zero_alias, old flag of cell (0, 0, 0)) on a
# [6, 5, 4] flag grid ([5, 4, 3] cells); a cell of id 0 in a padding slot
# is the alias every padding slot writes
MARK_CASES = {
    "all_padding": (5, [0] * 6, [False] * 6, True, True),
    "no_alias_slot": (5, [4, 9, 13], [True, True, False], True, False),
    "alias_emitted": (5, [0, 4, 9, 13], [True, True, False, True], True, False),
    "alias_not_emitted": (5, [0, 4, 9], [False, True, True], True, False),
    "alias_not_emitted_was_meshed": (5, [0, 4, 9, 0], [False, True, True, False], True, True),
    "last_alias_not_done": (5, [0, 4, 0, 0], [True, True, False, False], True, False),
    "no_zero_alias": (5, [0, 7, 30, -20, 100, 0], [True, True, False, False, False, False], False, False),
    "slab_cx": (3, [0, 5, 35, 36, 50, 0, 0], [True, True, True, False, False, False, False], True, False),
    "slab_cx_no_zero_alias": (3, [2, 35, -12, -1, 40], [True, True, False, False, False], False, False),
}


@pytest.mark.parametrize("case", sorted(MARK_CASES))
def test_mark_meshed_matches_slot_loop(case):
    """mark_meshed equals the serial slot-order write-back: the padding
    slots, no slot on cell (0, 0, 0), the alias slot of cell (0, 0, 0) emitted or not and followed by
    padding, the sharded slabs other than slab 0 (no alias rule) and a slab
    extended by its neighbour's plane (cx below the grid's cells)."""
    cx, ids, done, zero_alias, origin_meshed = MARK_CASES[case]
    rng = np.random.default_rng(sorted(MARK_CASES).index(case))
    cell_meshed = torch.from_numpy(rng.random((6, 5, 4)) < 0.3)
    cell_meshed[0, 0, 0] = origin_meshed
    ids = torch.tensor(ids, dtype=torch.int64)
    done = torch.tensor(done)
    want = _mark_meshed_loop(cell_meshed, cx, ids, done, zero_alias)
    got = tm.mark_meshed(cell_meshed, cx, ids, done, zero_alias=zero_alias)
    np.testing.assert_array_equal(got.numpy(), want)
