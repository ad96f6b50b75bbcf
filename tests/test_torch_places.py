"""Port parity for the places layer (stm/places.py): the device functions,
the fixpoint of the room components, PlacesExtractor call sequences, and the
places keys of dsg.npz and .4dmap.npz across packages.

Both packages run on the CPU on the same numpy inputs: the two-room mesh of
tests/test_places.py and random grids. Tolerance: none. Positions,
clearances and fields are float32 and must be equal bit for bit (float bound
0); room ids, edges and labels exactly."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from khronos_tpu.ops.dense import max_pool3 as jmax_pool3
from khronos_tpu.stm import places as jp
from khronos_tpu.stm import serialization as jser
from khronos_tpu.stm.scene_graph import SceneGraph as JSceneGraph
from khronos_tpu.stm.spatio_temporal_map import SpatioTemporalMap as JMap
from khronos_tpu_torch.ops import propagate as tprop
from khronos_tpu_torch.stm import places as tp
from khronos_tpu_torch.stm import serialization as tser
from khronos_tpu_torch.stm.scene_graph import SceneGraph as TSceneGraph
from khronos_tpu_torch.stm.spatio_temporal_map import SpatioTemporalMap as TMap

from test_places import two_room_mesh
from test_torch_kernels_cuda import snake_case
from torch_parity import torch_scene_graph


def layer_arrays(layer):
    """(positions, clearances, room ids, place ids, edges) of a layer."""
    n = layer.nodes
    return (np.asarray([x.position for x in n], np.float32).reshape(-1, 3),
            np.asarray([x.distance for x in n], np.float64),
            np.asarray([x.room_id for x in n], np.int64),
            np.asarray([x.place_id for x in n], np.int64),
            list(layer.edges))


def assert_layers_equal(got, want, what=""):
    g, w = layer_arrays(got), layer_arrays(want)
    for name, a, b in zip(("positions", "clearances", "room ids", "place ids"), g[:4], w[:4]):
        assert a.dtype == b.dtype and a.shape == b.shape, (what, name)
        np.testing.assert_array_equal(a, b, err_msg=f"{what} {name}")
    assert g[4] == w[4], f"{what} edges"


def random_cells(dims, n, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, d, n) for d in dims], axis=1).astype(np.int64)


# ----------------------------------------------------------------------------
# device functions
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("voxel,dims,iterations", [(0.2, (40, 33, 21), 24), (0.5, (32, 32, 8), 24),
                                                     (0.1, (17, 9, 30), 7), (0.4, (1, 12, 5), 3)])
def test_chamfer_field_bit_for_bit(voxel, dims, iterations):
    occ = np.zeros(dims, bool)
    idx = random_cells(dims, max(2, int(np.prod(dims)) // 200), seed=len(dims) + iterations)
    occ[idx[:, 0], idx[:, 1], idx[:, 2]] = True
    want = np.asarray(jp.chamfer_distance_field(jnp.asarray(occ), voxel, iterations))
    got = tp.chamfer_distance_field(torch.from_numpy(occ), voxel, iterations).numpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dims,min_d,max_d", [((40, 33, 21), 0.3, 4.5), ((64, 64, 64), 0.3, 4.5),
                                               ((24, 30, 12), 0.2, 0.6)])
def test_candidate_field_bit_for_bit(dims, min_d, max_d):
    idx = random_cells(dims, int(np.prod(dims)) // 150, seed=dims[0])
    jd, jc = jp._candidate_field(jnp.asarray(idx), dims, 0.2, 24, min_d, max_d)
    td, tc = tp._candidate_field(torch.from_numpy(idx), dims, 0.2, 24, min_d, max_d)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert np.asarray(jc).any()
    # the one pull to the host carries both, bit for bit
    d_np, cand = tp._pull_field(td, tc)
    np.testing.assert_array_equal(d_np, np.asarray(jd))
    np.testing.assert_array_equal(cand, np.asarray(jc))


def _room_case(kind, seed=0):
    """(occupied cells, zmask, dims, voxel, clearance, floor_cells) exposing
    one mask of _room_blobs at a time: labels > 0 is exactly the eroded mask.
    'ball': floor under every column, all z in the slab, so eroded = not
    blocked; 'floor': a one-cell ball (blocked = occupied) over a patchy floor,
    so eroded = free cells with closed floor support; 'random': both."""
    rng = np.random.default_rng(seed)
    dims = (32, 48, 16)
    if kind == "ball":
        floor = np.stack(np.meshgrid(np.arange(dims[0]), np.arange(dims[1]), [0], indexing="ij"), -1).reshape(-1, 3)
        idx = np.concatenate([floor, random_cells(dims, 60, seed)])
        return idx, np.ones(dims[2], bool), dims, 0.4, 0.8, 0
    if kind == "floor":
        cols = rng.random(dims[:2]) < 0.3
        cols[10:14, :] = False  # a gap wider than the closing bridges
        xs, ys = np.nonzero(cols)
        idx = np.stack([xs, ys, np.full_like(xs, 2)], axis=1)
        return idx, np.ones(dims[2], bool), dims, 0.4, 0.3, 2
    zmask = np.zeros(dims[2], bool)
    zmask[2:12] = True
    floor = np.stack(np.meshgrid(np.arange(4, 28), np.arange(4, 44), [1], indexing="ij"), -1).reshape(-1, 3)
    walls = np.stack(np.meshgrid([16], np.arange(0, 48), np.arange(0, 16), indexing="ij"), -1).reshape(-1, 3)
    walls = walls[(walls[:, 1] < 20) | (walls[:, 1] > 23)]  # a doorway
    idx = np.concatenate([floor, walls, random_cells(dims, 80, seed)])
    return idx, zmask, dims, 0.4, 0.8, 2


@pytest.mark.parametrize("kind", ["ball", "floor", "random"])
def test_room_blobs_bit_for_bit(kind):
    """The labels, and with them the blocked mask (ball dilation) and the
    closed floor support: equal to the reference's, cell for cell."""
    idx, zmask, dims, voxel, clearance, floor_cells = _room_case(kind)
    want = np.asarray(jp._room_blobs(jnp.asarray(idx), jnp.asarray(zmask), dims, voxel, clearance, floor_cells))
    got = tp._room_blobs(torch.from_numpy(idx), torch.from_numpy(zmask), dims, voxel, clearance, floor_cells).numpy()
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got > 0, want > 0)
    np.testing.assert_array_equal(got, want)
    assert 0 < (want > 0).mean() < 1
    if kind == "random":
        assert len(np.unique(want[want > 0])) >= 2  # the doorway is narrower than the ball


def _jax_while_loop(labels0, grow):
    """The reference's fixpoint (khronos_tpu/stm/places.py:211-220): 0 =
    unlabeled, max over the 26-neighbourhood where growable, until a round
    changes nothing; also counts the rounds."""
    def body(carry):
        lab, _, k = carry
        grown = jnp.where(grow, jnp.maximum(lab, jmax_pool3(lab)), lab)
        return grown, (grown != lab).any(), k + 1

    lab, _, k = jax.lax.while_loop(lambda c: c[1], body, (labels0, jnp.bool_(True), jnp.int32(0)))
    return np.asarray(lab), int(k)


@pytest.mark.parametrize("case", ["snake", "random", "none", "odd"])
def test_fixpoint_plain_matches_the_reference_while_loop(case):
    if case == "snake":
        _, grow = snake_case((24, 20, 3), pitch=4)
    elif case == "random":
        grow = torch.from_numpy(np.random.default_rng(1).random((20, 17, 9)) < 0.55)
    elif case == "none":
        grow = torch.zeros((6, 5, 4), dtype=torch.bool)
    else:
        grow = torch.from_numpy(np.random.default_rng(2).random((3, 31, 2)) < 0.7)
    seeds = torch.arange(1, grow.numel() + 1, dtype=torch.int32).view(grow.shape)
    want, k = _jax_while_loop(jnp.asarray(np.where(grow.numpy(), seeds.numpy(), 0)), jnp.asarray(grow.numpy()))
    got, rounds = tprop.propagate_labels_3d_fixpoint_plain(torch.where(grow, seeds, -1), grow)
    np.testing.assert_array_equal(got.clamp_min(0).numpy(), want)
    assert rounds == k
    if case == "snake":
        assert rounds > 40  # the corridor's length, not its width
    # the wrapper takes a CPU tensor to the plain loop
    before = tprop.launches
    np.testing.assert_array_equal(tprop.propagate_labels_3d_fixpoint(torch.where(grow, seeds, -1), grow).numpy(),
                                  got.numpy())
    assert tprop.launches == before


# ----------------------------------------------------------------------------
# PlacesExtractor
# ----------------------------------------------------------------------------


def _configs(**kw):
    return jp.PlacesConfig(**kw), tp.PlacesConfig(**kw)


INCREMENTAL = dict(voxel_size=0.2, compression_distance=1.0, room_clearance=0.7, min_distance=0.3,
                   window_radius=3.2, window_margin=0.6)


@pytest.mark.parametrize("door,kw", [(0.6, dict(voxel_size=0.2, compression_distance=1.0, room_clearance=0.7,
                                                 min_distance=0.3)),
                                      (3.5, dict(voxel_size=0.2, compression_distance=1.0, room_clearance=0.7)),
                                      (0.6, {})])
def test_extract_matches_the_reference(door, kw):
    verts = two_room_mesh(door_width=door)
    jc, tc = _configs(**kw)
    want = jp.PlacesExtractor(jc).extract(verts)
    got = tp.PlacesExtractor(tc, device="cpu").extract(verts)
    assert len(want.nodes) >= 4 and len(want.edges) >= 2
    assert_layers_equal(got, want)
    assert tp.PlacesExtractor(tc, device="cpu").extract(verts[:5]).nodes == []


def _sequence(verts):
    """An incremental call sequence across both rooms: deltas, windowed
    updates on sequence stamps (the room refresh gate opens at 0 s, 16 s and
    32 s, not between), two wall-clock updates (the first opens the wall-clock
    gate, the second falls in it), a reset without the divider, and the
    forced refresh."""
    left, right = verts[verts[:, 0] <= 4.5], verts[verts[:, 0] > 3.5]
    s = int(1e9)
    return [
        ("add_mesh_delta", (left,), {}),
        ("update_local", (np.array([2.0, 2.0, 1.0]),), {"stamp_ns": 0}),
        ("update_local", (np.array([2.5, 1.5, 1.0]),), {"stamp_ns": 5 * s}),
        ("add_mesh_delta", (right,), {}),
        ("update_local", (np.array([4.2, 2.0, 1.0]),), {"stamp_ns": 10 * s}),
        ("update_local", (np.array([6.0, 2.0, 1.0]),), {"stamp_ns": 16 * s}),
        ("update_local", (np.array([6.5, 2.5, 1.0]),), {"stamp_ns": 20 * s}),
        ("update_local", (np.array([1.5, 2.0, 1.0]),), {}),
        ("update_local", (np.array([6.0, 1.5, 1.0]),), {}),
        ("reset_occupancy", (verts[np.abs(verts[:, 0] - 4.0) > 0.2],), {}),
        ("update_local", (np.array([4.0, 2.0, 1.0]),), {"stamp_ns": 24 * s}),
        ("update_local", (np.array([2.0, 2.0, 1.0]),), {"stamp_ns": 32 * s}),
        ("refresh_rooms", (), {}),
        ("update_local", (np.array([6.0, 2.0, 1.0]),), {"stamp_ns": 33 * s}),
    ]


def test_update_local_sequence_matches_the_reference():
    verts = two_room_mesh()
    jc, tc = _configs(**INCREMENTAL)
    jx, tx = jp.PlacesExtractor(jc), tp.PlacesExtractor(tc, device="cpu")
    split = False
    for i, (name, args, kw) in enumerate(_sequence(verts)):
        getattr(jx, name)(*args, **kw)
        getattr(tx, name)(*args, **kw)
        assert_layers_equal(tx.snapshot_layer(), jx.snapshot_layer(), f"call {i} ({name})")
        assert tx._last_room_update_s == jx._last_room_update_s
        assert (tx._blocks.keys() == jx._blocks.keys()
                and all(tx._blocks[k] == jx._blocks[k] for k in jx._blocks)), f"call {i} occupancy"
        layer = jx.layer
        left = {n.room_id for n in layer.nodes if n.position[0] < 3.5}
        right = {n.room_id for n in layer.nodes if n.position[0] > 4.5}
        split |= bool(left and right and left.isdisjoint(right) and -1 not in left | right)
    assert split  # the doorway separated the rooms at some point
    assert hasattr(tx, "_last_room_update_mono_s")
    jl, tl = jx.lcd_snapshot(), tx.lcd_snapshot()
    np.testing.assert_array_equal(tl[0], jl[0])
    np.testing.assert_array_equal(tl[1], jl[1])


def test_extractor_pickles_without_its_lock():
    import pickle

    tx = tp.PlacesExtractor(tp.PlacesConfig(**INCREMENTAL), device="cpu")
    tx.add_mesh_delta(two_room_mesh())
    tx.update_local(np.array([2.0, 2.0, 1.0]), stamp_ns=0)
    back = pickle.loads(pickle.dumps(tx))
    assert_layers_equal(back.layer, tx.layer)
    assert back._lock is not tx._lock and back._blocks == tx._blocks
    assert copy.deepcopy(tx).layer.nodes[0].position is not tx.layer.nodes[0].position


# ----------------------------------------------------------------------------
# dsg.npz and .4dmap.npz with a places layer, across packages
# ----------------------------------------------------------------------------


def _dsg_with_places(sg_cls, layer):
    dsg = sg_cls()
    dsg.places = layer
    return dsg


def test_dsg_npz_places_across_packages(tmp_path):
    verts = two_room_mesh()
    jc, tc = _configs(voxel_size=0.2, compression_distance=1.0, room_clearance=0.7)
    jlayer = jp.PlacesExtractor(jc).extract(verts)
    tlayer = tp.PlacesExtractor(tc, device="cpu").extract(verts)
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jser.save_scene_graph(_dsg_with_places(JSceneGraph, jlayer), jpath)
    tser.save_scene_graph(_dsg_with_places(TSceneGraph, tlayer), tpath)
    with np.load(jpath) as a, np.load(tpath) as b:
        assert sorted(a.files) == sorted(b.files) and "places/edges" in a.files
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    # each package reads the other's
    assert_layers_equal(tser.load_scene_graph(jpath).places, tlayer)
    back = jser.load_scene_graph(tpath).places
    for x, y in zip(back.nodes, jlayer.nodes):
        assert (np.array_equal(x.position, y.position), x.distance, x.room_id) == (True, y.distance, y.room_id)
    assert [tuple(np.float32(e)) for e in back.edges] == [tuple(np.float32(e)) for e in jlayer.edges]
    # an empty layer writes no places keys, in both
    assert not any(k.startswith("places/") for k in tser.scene_graph_arrays(_dsg_with_places(TSceneGraph, tp.PlacesLayer())))


def test_4dmap_npz_places_across_packages(tmp_path):
    verts = two_room_mesh()
    jx = jp.PlacesExtractor(jp.PlacesConfig(**INCREMENTAL))
    jmap, tmap = JMap(), TMap()
    for k, cx in enumerate((2.0, 6.0)):
        jx.add_mesh_delta(verts)
        jx.update_local(np.array([cx, 2.0, 1.0]), stamp_ns=k * int(20e9))
        dsg = _dsg_with_places(JSceneGraph, jx.snapshot_layer())
        jmap.update(dsg, (k + 1) * int(1e9))
        tmap.update(torch_scene_graph(dsg), (k + 1) * int(1e9))
    jpath, tpath = str(tmp_path / "j.4dmap.npz"), str(tmp_path / "t.4dmap.npz")
    jmap.save(jpath)
    tmap.save(tpath)
    with np.load(jpath) as a, np.load(tpath) as b:
        assert sorted(a.files) == sorted(b.files) and "snap/1/places/positions" in a.files
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for i in range(2):
        assert_layers_equal(TMap.load(jpath).snapshots[i].places, tmap.snapshots[i].places, f"snapshot {i}")
        assert len(JMap.load(tpath).snapshots[i].places.nodes) == len(jmap.snapshots[i].places.nodes)
