"""Port parity for device-mesh sharding: parallel/sharding.py, the window's
and the pipeline's mesh mode (`n_devices`), and the sharded factor assembly.

The JAX side runs on conftest's 8 virtual CPU devices in this process; the
port's shards all lie on the CPU (a mesh of N shards on one device), save
the window's card order, checked on 4 stubbed cards with torch.device
objects only. The file starts no process and opens no port. Tolerances, the reference's own
(tests/test_tools.py):
- labels, ids, id images, ray evidence and integer stats bit for bit;
- the volume as tests/torch_parity.assert_states_match (floats within 1e-5);
- packed stats within atol 2e-3, rtol 1e-5 (the reference's bars: XLA
  partitions its cluster sums);
- the port's sharded step against its own unsharded step with cropping off
  (what the reference's sharding equals): the volume and the images bit for
  bit;
- the window and the pipeline as tests/test_torch_bus.py holds them (the
  reference in its earliest host-pull schedule): triangles, objects and
  finished tracks per output equal, the weight sum within rtol 1e-5;
- the sharded Schur solve as tests/test_torch_distributed.py's (1e-4)."""

import copy
import functools
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from khronos_tpu.active_window.active_window import ActiveWindow as JWindow
from khronos_tpu.active_window.active_window import ActiveWindowConfig as JConfig
from khronos_tpu.active_window.frame_data import FrameData as JFrame
from khronos_tpu.backend import distributed as jdist
from khronos_tpu.backend import factor_graph as jfg
from khronos_tpu.config import build as jbuild
from khronos_tpu.data import synthetic as jsyn
from khronos_tpu.geometry.camera import Camera as JCamera
from khronos_tpu.map import active_volume as jav
from khronos_tpu.parallel import sharding as jsh
from khronos_tpu_torch.active_window import fused_step as tfs
from khronos_tpu_torch.active_window.active_window import ActiveWindow as TWindow
from khronos_tpu_torch.active_window.active_window import ActiveWindowConfig as TConfig
from khronos_tpu_torch.active_window.frame_data import FrameData as TFrame
from khronos_tpu_torch.backend import distributed as tdist
from khronos_tpu_torch.backend import factor_graph as tfg
from khronos_tpu_torch.config import build as tbuild
from khronos_tpu_torch.geometry.camera import voxel_floor
from khronos_tpu_torch.map import active_volume as tav
from khronos_tpu_torch.map import meshing as tmeshing
from khronos_tpu_torch.ops import gather as tgather
from khronos_tpu_torch.ops import native as tnative
from khronos_tpu_torch.ops import propagate as tpropagate
from khronos_tpu_torch.parallel import sharding as tsh
from khronos_tpu_torch.pipeline.pipeline import KhronosPipeline as TPipeline
from khronos_tpu_torch.pipeline.pipeline import PipelineConfig as TPipelineConfig

from test_torch_backend import GRAPHS
from test_torch_bus import _run, reference_earliest_schedule  # noqa: F401  (fixture)
from torch_parity import assert_states_match, frames, torch_camera, torch_graph, torch_label_space

N_FRAMES = 14
GRID = [48, 48, 32]
CPU = ["cpu"]


def _mesh(n):
    return tsh.make_mesh(n, devices=CPU)


def _t(a):
    return torch.from_numpy(np.array(a))


def _assert_packed(want, got):
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=1e-5)
    # pixel counts, categories and cluster ids bit for bit
    n = tfs.MC * 12
    for part in (slice(0, n), slice(n, 2 * n)):
        np.testing.assert_array_equal(got[part].reshape(tfs.MC, 12)[:, 9:], want[part].reshape(tfs.MC, 12)[:, 9:])


# ---------------------------------------------------------------------------
# the mesh and the layout
# ---------------------------------------------------------------------------


def test_mesh_layout_and_round_trip():
    mesh = tsh.make_mesh(3, devices=["cpu", "cpu"])
    assert mesh.size == 3 and mesh.axis == "x" and all(d.type == "cpu" for d in mesh.devices)
    cfg = tav.VolumeConfig(grid_shape=(24, 8, 8))
    state = tav.create(cfg, device="cpu")
    rng = np.random.default_rng(0)
    state = state._replace(tsdf=torch.from_numpy(rng.normal(size=(24, 8, 8)).astype(np.float32)))
    sv = tsh.shard_volume(state, mesh)
    assert [s.tsdf.shape[0] for s in sv.slabs] == [8, 8, 8] and sv.shape == (24, 8, 8)
    assert [s.origin.tolist() for s in sv.slabs] == [(state.origin + torch.tensor([8 * i, 0, 0])).tolist()
                                                      for i in range(3)]
    back = tsh.gather_volume(sv)
    for f in tav.VolumeState._fields:
        assert torch.equal(getattr(back, f), getattr(state, f)), f
    assert [xs for _, xs in tsh.volume_sharding(mesh, (24, 8, 8))] == [slice(0, 8), slice(8, 16), slice(16, 24)]


def _window_raises():
    cam, _ = frames(N_FRAMES)
    cfg = tbuild(TConfig, {"volumetric_map": {"grid_shape": [30, 16, 8]}, "n_devices": 4})
    TWindow(cfg, torch_camera(cam), torch_label_space(jsyn.default_label_space()), device="cpu")


INDIVISIBLE = {
    "shard_volume": lambda: tsh.shard_volume(tav.create(tav.VolumeConfig(grid_shape=(30, 16, 8)), device="cpu"),
                                             _mesh(4)),
    "make_sharded_step": lambda: tsh.make_sharded_step(tav.VolumeConfig(grid_shape=(30, 16, 8)), None, _mesh(4)),
    "active_window": _window_raises,
}


@pytest.mark.parametrize("entry", list(INDIVISIBLE))
def test_indivisible_grid_raises(entry):
    with pytest.raises(ValueError, match="not divisible"):
        INDIVISIBLE[entry]()


def test_default_mesh_keeps_every_shard_on_the_current_card(monkeypatch):
    """With one card visible, the default mesh (and a bare "cuda") keeps
    every shard on it; a list of cards takes them round-robin. With several
    cards visible the default takes one a card, from the current one on."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    card = torch.device("cuda", 0)
    assert tsh.make_mesh(4).devices == (card,) * 4
    assert tsh.make_mesh(2, devices=["cuda"]).devices == (card, card)
    assert tsh.make_mesh(3, devices=["cuda:0", "cuda:1"]).devices == tuple(
        torch.device("cuda", k) for k in (0, 1, 0))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
    assert tsh.make_mesh(4).devices == tuple(torch.device("cuda", k) for k in (3, 0, 1, 2))
    assert tsh.make_mesh().size == 4


def _four_cards(monkeypatch):
    """Four visible "cards", card 0 current: torch.device objects only."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_window_mesh_follows_the_reference_device_order(monkeypatch, n):
    """ActiveWindow(n_devices=n) on "cuda" with 4 cards visible puts slab i
    on the reference's make_mesh(n) device i (conftest's 8 virtual CPU
    devices): cards 0..n-1, and round-robin beyond 4. The window's pixel
    side stays on slab 0's card. Builds no CUDA tensor: the slab grid is
    stubbed."""
    _four_cards(monkeypatch)
    want = [d.id for d in jsh.make_mesh(n).devices.flat]
    assert want == list(range(n))
    monkeypatch.setattr(tsh, "SlabGrid", lambda mesh, shape: ("slabs", mesh, tuple(shape)))
    aw = TWindow.__new__(TWindow)
    aw.config = tbuild(TConfig, {**AW_CONFIG, "n_devices": n})
    aw.device = torch.device("cuda")
    aw._build_grid()
    assert [d.index for d in aw.mesh.devices] == [i % 4 for i in want]
    assert all(d.type == "cuda" for d in aw.mesh.devices)
    assert aw.grid == ("slabs", aw.mesh, tuple(AW_CONFIG["volumetric_map"]["grid_shape"]))
    assert aw.device == torch.device("cuda", 0) and aw.devices == aw.mesh.devices
    assert tsh.mesh_for(n, "cpu").devices == (torch.device("cpu"),) * n


def test_window_mesh_starts_at_the_window_card_and_logs_round_robin_once(monkeypatch):
    """A window on cuda:2 takes cards 2, 3, 0, 1; more slabs than cards
    log their layout once."""
    _four_cards(monkeypatch)
    logged = []
    monkeypatch.setattr(tsh, "clog", lambda level, msg: logged.append(msg))
    monkeypatch.setattr(tsh, "_logged_layouts", set())
    assert [d.index for d in tsh.mesh_for(4, "cuda:2").devices] == [2, 3, 0, 1]
    assert not logged
    for _ in range(3):
        assert [d.index for d in tsh.mesh_for(6, "cuda").devices] == [0, 1, 2, 3, 0, 1]
    assert len(logged) == 1 and "slab 4 on cuda:0" in logged[0]


class _OnCard(torch.Tensor):
    """A CPU tensor that calls itself a tensor on cuda:1, so a kernel
    wrapper runs its CUDA branch up to the (stubbed) C entry point."""

    @property
    def device(self):
        return torch.device("cuda", 1)

    @property
    def is_cuda(self):
        return True


def test_kernels_launch_on_their_tensors_card(monkeypatch):
    """A slab may lie on any card of a mesh: kernels A and B must launch with
    their tensors' card current (the C side reads it) and on that card's
    stream, and give the current device back after."""
    current = [0]
    calls = []

    class FakeDevice:  # stands in for torch.cuda.device
        def __init__(self, device):
            self.index = torch.device(device).index

        def __enter__(self):
            self.prev, current[0] = current[0], self.index

        def __exit__(self, *exc):
            current[0] = self.prev

    def current_stream(device=None):
        k = current[0] if device is None else torch.device(device).index
        return types.SimpleNamespace(cuda_stream=1000 + k)

    def entry(name):
        def call(*args):
            calls.append((name, current[0], args[-1]))
            return 0
        return call

    monkeypatch.setattr(torch.cuda, "device", FakeDevice)
    monkeypatch.setattr(torch.cuda, "current_stream", current_stream)
    monkeypatch.setattr(tnative, "load_library",
                        lambda: types.SimpleNamespace(khr_propagate=entry("A"), khr_gather_rows=entry("B")))

    def on_card(t):
        return torch.Tensor._make_subclass(_OnCard, t)

    tpropagate.propagate_labels_3d(on_card(torch.full((4, 4, 4), -1, dtype=torch.int32)),
                                   on_card(torch.ones((4, 4, 4), dtype=torch.bool)), 2)
    tgather.gather_rows(on_card(torch.zeros((6, 2), dtype=torch.float32)), on_card(torch.zeros(5, dtype=torch.int32)))
    assert calls == [("A", 1, 1001), ("B", 1, 1001)]
    assert current == [0]


# ---------------------------------------------------------------------------
# the sharded steps against the reference's over 8 devices
# ---------------------------------------------------------------------------


def test_sharded_integration_matches_reference():
    """tests/test_tools.py's integration case: make_sharded_step over 8
    shards against the reference's over 8 devices."""
    cfg_j = jav.VolumeConfig(grid_shape=(64, 32, 16), voxel_size=0.1, truncation_distance=0.2)
    cfg_t = tav.VolumeConfig(grid_shape=(64, 32, 16), voxel_size=0.1, truncation_distance=0.2)
    cam = JCamera(48, 64, 40.7, 41.3, 31.83, 23.71)
    rng = np.random.default_rng(5)
    depth = rng.uniform(1.0, 3.0, (48, 64)).astype(np.float32)
    color = rng.uniform(0, 1, (48, 64, 3)).astype(np.float32)
    labels = rng.integers(-1, 7, (48, 64)).astype(np.int32)
    mask = rng.random((48, 64)) < 0.1
    R = np.eye(3, dtype=np.float32)
    t = np.asarray([0.013, -0.021, 0.017], np.float32)
    j0 = jav.create(cfg_j, origin_xyz=np.array([-3.2, -1.6, -0.6]))
    js = jsh.shard_volume(j0, jsh.make_mesh(8))
    jstep = jsh.make_sharded_step(cfg_j, cam, jsh.make_mesh(8))
    ts = tsh.shard_volume(tav.state_from_numpy([np.asarray(a) for a in j0], device="cpu"), _mesh(8))
    tstep = tsh.make_sharded_step(cfg_t, torch_camera(cam), _mesh(8))
    for k in range(3):
        js = jstep(js, jnp.asarray(depth), jnp.asarray(color), jnp.asarray(labels), jnp.asarray(mask), R, t,
                   jnp.float32(0.1 * k))
        ts = tstep(ts, _t(depth), _t(color), _t(labels), _t(mask), R, t, 0.1 * k)
    assert len(js.tsdf.sharding.device_set) == 8 and len(ts.slabs) == 8
    got = tsh.gather_volume(ts)
    assert_states_match(js, got)
    assert bool(got.ever_free.any()) and float(got.weight.sum()) > 0


def _detectors(md_extra=None):
    d = {
        "volumetric_map": {"grid_shape": GRID, "voxel_size": 0.1},
        "motion_detector": {"type": "FreeSpaceMotionDetector", "min_cluster_size": 20, "seed_dynamic_labels": True,
                            **(md_extra or {})},
        "object_detector": {"type": "ConnectedSemantics", "min_cluster_size": 5},
    }
    jc, tc = jbuild(JConfig, d), tbuild(TConfig, d)
    return jc, tc, jc.motion_detector.config, jc.object_detector.config, tc.motion_detector.config, tc.object_detector.config


def _start(jc, fr):
    origin = np.floor(fr[0]["t_w_c"] / 0.1 - np.asarray(GRID) / 2.0).astype(np.int32)
    return jav.create(jc.volumetric_map)._replace(origin=jnp.asarray(origin))


@pytest.mark.parametrize("reach", ["office", "beyond_a_slab"])
def test_sharded_frame_step_matches_reference(reach):
    """The full fused step over 8 shards (6 planes each) against the
    reference's over 8 devices, on 14 office frames. 'beyond_a_slab' sets
    min_separation_distance 10: the dilation reaches 9 planes, more than a
    slab, so its extension comes from two slabs on each side (as
    configs/jackal_real.yaml's 50 does at 4 shards of the main grid)."""
    cam, fr = frames(N_FRAMES)
    extra = {"min_separation_distance": 10} if reach == "beyond_a_slab" else None
    jc, tc, jmd, jod, tmd, tod = _detectors(extra)
    ls = jsyn.default_label_space()
    jstep = jsh.make_sharded_frame_step(jc.volumetric_map, cam, jmd, jod, ls, jsh.make_mesh(8), detection_stride=2)
    tstep = tsh.make_sharded_frame_step(tc.volumetric_map, torch_camera(cam), tmd, tod, torch_label_space(ls),
                                        _mesh(8), detection_stride=2)
    width = GRID[0] // 8
    if reach == "beyond_a_slab":
        assert tmd.min_separation_distance - 1 > width
    j0 = _start(jc, fr)
    ts = tsh.shard_volume(tav.state_from_numpy([np.asarray(a) for a in j0], device="cpu"), _mesh(8))
    js = jsh.shard_volume(j0, jsh.make_mesh(8))
    n_dyn = n_obj = 0
    for f in fr:
        js, jd, jo, jp = jstep(js, jnp.asarray(f["depth"]), jnp.asarray(f["color"]), jnp.asarray(f["labels"]),
                               f["R_w_c"], f["t_w_c"], jnp.float32(f["t"]))
        ts, td, to, tp = tstep(ts, _t(f["depth"]), _t(f["color"]), _t(f["labels"]), f["R_w_c"], f["t_w_c"], f["t"])
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
        _assert_packed(np.asarray(jp), tp.numpy())
        n_dyn += int(td.max())
        n_obj += int(to.max())
    assert_states_match(js, tsh.gather_volume(ts))
    assert n_dyn > 0 and n_obj > 0


def test_flat_scene_frame_step_matches_reference():
    """tests/test_tools.py's full-frame case (one object in front of a flat
    wall) over 8 shards."""
    cfg_j = jav.VolumeConfig(grid_shape=(64, 32, 16), voxel_size=0.1)
    cfg_t = tav.VolumeConfig(grid_shape=(64, 32, 16), voxel_size=0.1)
    cam = JCamera(48, 64, 40.0, 40.0, 32.0, 24.0, max_range=5.0)
    from khronos_tpu.active_window.motion_detection import FreeSpaceMotionDetectorConfig as JMd
    from khronos_tpu.active_window.object_detection import ConnectedSemanticsConfig as JOd
    from khronos_tpu.active_window.object_detection import LabelSpace as JLs
    from khronos_tpu_torch.active_window.motion_detection import FreeSpaceMotionDetectorConfig as TMd
    from khronos_tpu_torch.active_window.object_detection import ConnectedSemanticsConfig as TOd

    ls = JLs(num_classes=7, object_labels=[2, 3, 4, 5, 6], dynamic_labels=[1])
    depth = np.full((48, 64), 0.8, np.float32)
    color = np.full((48, 64, 3), 0.4, np.float32)
    labels = np.zeros((48, 64), np.int32)
    labels[10:30, 20:44] = 3
    R, t = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    j0 = jav.create(cfg_j, origin_xyz=np.array([-3.2, -1.6, -0.6]))
    t0 = tsh.shard_volume(tav.state_from_numpy([np.asarray(a) for a in j0], device="cpu"), _mesh(8))
    jstep = jsh.make_sharded_frame_step(cfg_j, cam, JMd(min_cluster_size=5), JOd(min_cluster_size=5), ls,
                                        jsh.make_mesh(8))
    js, jd, jo, jp = jstep(jsh.shard_volume(j0, jsh.make_mesh(8)), jnp.asarray(depth), jnp.asarray(color),
                           jnp.asarray(labels), R, t, jnp.float32(0.5))
    tstep = tsh.make_sharded_frame_step(cfg_t, torch_camera(cam), TMd(min_cluster_size=5), TOd(min_cluster_size=5),
                                        torch_label_space(ls), _mesh(8))
    ts, td, to, tp = tstep(t0, _t(depth), _t(color), _t(labels), R, t, 0.5)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    _assert_packed(np.asarray(jp), tp.numpy())
    assert_states_match(js, tsh.gather_volume(ts))
    assert int(to.max()) > 0


# ---------------------------------------------------------------------------
# the sharded step against the port's own unsharded step (cropping off)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _one_grid_run(n, min_separation=None):
    """14 office frames through the port's unsharded step (crop off) and its
    step over n shards; returns what both gave, per frame, and the slabs the
    voxels of each dynamic and object cluster's pixels fall in."""
    cam, fr = frames(N_FRAMES)
    _, tc, _, _, tmd, tod = _detectors(None if min_separation is None else {"min_separation_distance": min_separation})
    tcam, ls = torch_camera(cam), torch_label_space(jsyn.default_label_space())
    one = tfs.make_frame_step(tc.volumetric_map, tcam, tmd, tod, ls, detection_stride=2, crop=False)
    sharded = tfs.make_frame_step(tc.volumetric_map, tcam, tmd, tod, ls, detection_stride=2, mesh=_mesh(n))
    origin = np.floor(fr[0]["t_w_c"] / 0.1 - np.asarray(GRID) / 2.0).astype(np.int32)
    rs = tav.create(tc.volumetric_map, device="cpu")._replace(origin=torch.from_numpy(origin))
    ss = tsh.shard_volume(rs, _mesh(n))
    width = GRID[0] // n
    crossing = {"dynamic": 0, "objects": 0}
    cam_d = tcam.__class__(tcam.height // 2, tcam.width // 2, tcam.fx / 2, tcam.fy / 2, tcam.cx / 2 + 0.25,
                           tcam.cy / 2 + 0.25, tcam.min_range, tcam.max_range)
    for f in fr:
        args = (_t(f["depth"]), _t(f["color"]), _t(f["labels"]), f["R_w_c"], f["t_w_c"], f["t"])
        rs, rd, ro, rp = one(rs, *args)
        ss, sd, so, sp = sharded(ss, *args)
        assert torch.equal(rd, sd) and torch.equal(ro, so)
        np.testing.assert_allclose(sp.numpy(), rp.numpy(), atol=2e-3, rtol=1e-5)
        # which slabs hold each cluster's voxels
        pts = cam_d.vertex_image_world(args[0][::2, ::2], f["R_w_c"], f["t_w_c"], reciprocal=True)
        slab = (voxel_floor(pts, 0.1)[..., 0] - int(origin[0])) // width
        for kind, img in (("dynamic", rd[::2, ::2]), ("objects", ro[::2, ::2])):
            for k in range(1, int(img.max()) + 1):
                if len(torch.unique(slab[img == k])) > 1:
                    crossing[kind] += 1
    return rs, ss, crossing


@pytest.mark.parametrize("n", [1, 2, 4])
def test_sharded_frame_step_equals_one_grid(n):
    rs, ss, crossing = _one_grid_run(n)
    got = tsh.gather_volume(ss)
    for f in tav.VolumeState._fields:
        assert torch.equal(getattr(got, f), getattr(rs, f)), f
    assert len(ss.slabs) == n


def test_components_crossing_slab_boundaries():
    """Over 8 shards of 6 planes, object clusters and a motion cluster span
    slab boundaries in these frames, and every id image, label and voxel
    still equals the one-grid step's (seed labels are global voxel ids;
    compaction ranks the global labels)."""
    rs, ss, crossing = _one_grid_run(8, 4)
    got = tsh.gather_volume(ss)
    for f in tav.VolumeState._fields:
        assert torch.equal(getattr(got, f), getattr(rs, f)), f
    assert crossing["objects"] >= 1 and crossing["dynamic"] >= 1, crossing


SHIFTS = {"x_and_yz": [7, -3, 2], "x_back": [-13, 0, 0], "beyond_slabs": [30, 5, -1]}


@pytest.mark.parametrize("shift", list(SHIFTS))
def test_scroll_and_emission_equal_one_grid(shift):
    """After 14 frames: each kind of emission mask per slab, an emission
    round (a capped one and a whole one) and a scroll across slab
    boundaries equal the one-grid functions' results bit for bit."""
    shift = SHIFTS[shift]
    rs, ss, _ = _one_grid_run(4)
    vol_cfg = tav.VolumeConfig(grid_shape=tuple(GRID), voxel_size=0.1)
    want = tmeshing.forced_emission_mask(rs, tav.scroll_out_mask(rs, shift))
    assert torch.equal(torch.cat(tsh.emission_masks(ss, "forced", shift)), want)
    assert torch.equal(torch.cat(tsh.emission_masks(ss, "archived")), tmeshing.archived_emission_mask(rs))
    finish = tmeshing.finish_emission_mask(rs)
    assert torch.equal(torch.cat(tsh.emission_masks(ss, "finish")), finish)
    for max_cells in (64, 1 << 16):
        r2, rpk, rmeta = tmeshing.extract_mesh_async(rs, finish, vol_cfg, max_cells=max_cells)
        s2, spk, smeta = tsh.extract_mesh_async(ss, tsh.emission_masks(ss, "finish"), vol_cfg, max_cells=max_cells)
        assert torch.equal(spk, rpk) and torch.equal(smeta, rmeta)
        assert torch.equal(tsh.gather_volume(s2).cell_meshed, r2.cell_meshed)
        assert float(rmeta[0]) > 0
    rs = tav.scroll(vol_cfg, rs, shift)
    got = tsh.gather_volume(tsh.scroll(vol_cfg, ss, shift))
    for f in tav.VolumeState._fields:
        assert torch.equal(getattr(got, f), getattr(rs, f)), f


# ---------------------------------------------------------------------------
# the ray query, the window, the pipeline, the solver
# ---------------------------------------------------------------------------


def test_sharded_ray_query_bit_exact():
    """tests/test_tools.py's ray-query case: the port's query over 8 shards
    equals its own query and the reference's over 8 devices."""
    from khronos_tpu.changes.ray_verificator import RayVerificator as JVer
    from khronos_tpu.changes.ray_verificator import RayVerificatorConfig as JVerCfg
    from khronos_tpu.stm.scene_graph import AgentNode, Mesh, SceneGraph
    from khronos_tpu_torch.changes.ray_verificator import RayVerificator as TVer
    from khronos_tpu_torch.changes.ray_verificator import RayVerificatorConfig as TVerCfg
    from torch_parity import torch_scene_graph

    rng = np.random.default_rng(3)
    dsg = SceneGraph()
    nv = 300
    dsg.mesh = Mesh(
        vertices=rng.uniform(-2, 2, (nv, 3)).astype(np.float32),
        colors=np.zeros((nv, 3), np.float32),
        faces=np.zeros((0, 3), np.int64),
        first_seen_ns=np.full(nv, 10**9, np.int64),
        last_seen_ns=np.full(nv, 20 * 10**9, np.int64),
        labels=np.zeros(nv, np.int32),
    )
    dsg.agents = [AgentNode(int(k * 1e9), np.eye(3), rng.uniform(-1, 1, 3).astype(np.float32), k) for k in range(12)]
    jver = JVer(JVerCfg(ray_policy="All"))
    jver.build(dsg)
    want = np.asarray(jsh.make_sharded_ray_query(jver, jsh.make_mesh(8))(dsg.mesh.vertices))
    tver = TVer(TVerCfg(ray_policy="All"), device="cpu")
    tver.build(torch_scene_graph(dsg))
    got = tsh.make_sharded_ray_query(tver, _mesh(8))(dsg.mesh.vertices)
    np.testing.assert_array_equal(got, tver.query(dsg.mesh.vertices))
    np.testing.assert_array_equal(got, want)
    assert got.sum() > 0


AW_CONFIG = {
    "volumetric_map": {"grid_shape": [64, 64, 32], "voxel_size": 0.2},
    "motion_detector": {"type": "FreeSpaceMotionDetector", "min_cluster_size": 40},
    "object_detector": {"type": "ConnectedSemantics", "min_cluster_size": 20},
    "tracker": {"type": "MaxIouTracker", "min_num_observations": 2},
    "object_extractor": {"type": "MeshObjectExtractor", "min_num_observations": 2},
}


def _office_frames(n):
    """tests/test_tools.py's orchestrator sequence (10 s of the office at 2
    frames/s, 48x64), rendered by the JAX package."""
    seq = jsyn.SyntheticSequence(jsyn.office_scene(duration=10.0), jsyn.SyntheticSequenceConfig(
        duration=10.0, fps=2.0, height=48, width=64, fx=40.0, fy=40.0, cx=32.0, cy=24.0))
    return seq.camera, [{k: (np.array(v) if hasattr(v, "shape") else v) for k, v in seq.render_frame(i).items()}
                        for i in range(n)]


@pytest.mark.parametrize("n_devices", [1, 4])
def test_active_window_mesh_mode_matches_reference(reference_earliest_schedule, n_devices):
    """ActiveWindow(n_devices) for 12 frames in both packages (spin_once,
    emission, finish on the slabs): per output the finished tracks, the
    object count and the triangles equal; the weight sum within rtol 1e-5."""
    cam, fr = _office_frames(12)
    cfg = {**AW_CONFIG, "n_devices": n_devices}
    ls = jsyn.default_label_space()
    jaw = JWindow(jbuild(JConfig, cfg), cam, ls)
    taw = TWindow(tbuild(TConfig, cfg), torch_camera(cam), torch_label_space(ls), device="cpu")
    jaw.defer_object_extraction = taw.defer_object_extraction = True
    j_spins, j_out = _run(jaw, JFrame, jnp.asarray, fr)
    t_spins, t_out = _run(taw, TFrame, _t, copy.deepcopy(fr))
    assert len(jaw.state.tsdf.sharding.device_set) == n_devices
    assert taw.mesh.size == n_devices and len(taw.state.slabs) == n_devices
    assert t_spins == j_spins
    assert t_out == j_out
    assert sum(o[3] for o in t_out) > 0 and sum(len(o[1]) for o in t_out) >= 1
    wj = float(np.asarray(jaw.state.weight).sum())
    wt = float(sum(s.weight.sum() for s in taw.state.slabs))
    assert wt == pytest.approx(wj, rel=1e-5) and wj > 0


def test_modular_path_on_a_mesh_equals_one_grid():
    """fused=False with n_devices=2: the stages run on the grid gathered onto
    the first device and split again, so outputs and volume equal the
    one-grid modular window's."""
    cam, fr = _office_frames(8)
    ls = torch_label_space(jsyn.default_label_space())
    runs = []
    for n in (0, 2):
        aw = TWindow(tbuild(TConfig, {**AW_CONFIG, "fused": False, "n_devices": n}), torch_camera(cam), ls,
                     device="cpu")
        tris = 0
        for f in copy.deepcopy(fr):
            out = aw.spin_once(TFrame(stamp_ns=f["stamp_ns"], depth=_t(f["depth"]), color=_t(f["color"]),
                                      labels=_t(f["labels"]), R_w_c=f["R_w_c"], t_w_c=f["t_w_c"]))
            tris += 0 if out is None else len(out.mesh_vertices)
        tris += len(aw.finish_mapping().mesh_vertices)
        runs.append((tris, aw.state if n == 0 else tsh.gather_volume(aw.state)))
    assert runs[0][0] == runs[1][0] > 0
    for f in tav.VolumeState._fields:
        assert torch.equal(getattr(runs[1][1], f), getattr(runs[0][1], f)), f


def test_pipeline_mesh_mode_matches_reference(reference_earliest_schedule):
    """tests/multihost_pipeline_worker.py's run_pipeline(n_devices=4), the
    single-process side of tests/test_multihost.py, run in this process,
    against the port's pipeline with the same config on the same frames
    (the JAX renderer's) over 4 shards."""
    from multihost_pipeline_worker import run_pipeline

    want = run_pipeline(4)
    seq = jsyn.SyntheticSequence(jsyn.office_scene(duration=8.0), jsyn.SyntheticSequenceConfig(
        duration=8.0, fps=1.0, height=48, width=64, fx=40.0, fy=40.0, cx=32.0, cy=24.0))
    cfg = tbuild(TPipelineConfig, {
        "active_window": {
            "n_devices": 4,
            "volumetric_map": {"grid_shape": [32, 32, 16], "voxel_size": 0.3, "truncation_distance": 0.6},
            "motion_detector": {"type": "FreeSpaceMotionDetector", "min_cluster_size": 5},
            "object_detector": {"type": "ConnectedSemantics", "min_cluster_size": 5},
            "tracker": {"type": "MaxIouTracker", "min_num_observations": 2},
            "object_extractor": {"type": "MeshObjectExtractor", "min_num_observations": 2},
        },
        "backend": {"lcd": {"type": "GtLoopClosure", "min_time_gap": 4.0, "max_distance": 1.0}},
        "label_space": {"num_classes": 7, "object_labels": [2, 3, 4, 5, 6], "dynamic_labels": [1]},
        "run_change_detection_every_n_frames": 4,
        "places": None,
    })
    pipe = TPipeline(cfg, torch_camera(seq.camera), device="cpu")
    for i in range(seq.n_frames):
        f = seq.render_frame(i)
        pipe.process_frame(TFrame(stamp_ns=f["stamp_ns"], depth=_t(f["depth"]), color=_t(f["color"]),
                                  labels=_t(f["labels"]), R_w_c=np.array(f["R_w_c"]), t_w_c=np.array(f["t_w_c"])),
                           gt_pose=(np.array(f["R_gt"]), np.array(f["t_gt"])))
    pipe.finish()
    dsg = pipe.backend.get_dsg()
    bg = pipe.change_detector.changes.background_states
    state = pipe.active_window.state
    got = {
        "n_state_devices": len(state.slabs),
        "weight_sum": float(sum(s.weight.sum() for s in state.slabs)),
        "n_agents": len(dsg.agents),
        "n_objects": len(dsg.objects),
        "n_mesh_vertices": int(dsg.mesh.num_vertices),
        "mesh_vertex_sum": round(float(np.abs(dsg.mesh.vertices).sum()), 1),
        "n_graph_nodes": pipe.backend.graph.num_nodes,
        "n_optimizations": pipe.backend.num_optimizations,
        "bg_state_counts": [int((bg == s).sum()) for s in (-1, 0, 1, 2)] if bg is not None else [],
        "n_snapshots": pipe.map.num_snapshots,
    }
    assert got["weight_sum"] == pytest.approx(want.pop("weight_sum"), rel=1e-5)
    assert got.pop("mesh_vertex_sum") == pytest.approx(want.pop("mesh_vertex_sum"), abs=0.2)
    got.pop("weight_sum")
    assert got == want
    assert want["n_objects"] >= 1 and want["n_optimizations"] >= 1


@pytest.mark.parametrize("name", ["loop_closure", "shadow", "gnc_anneal"])
def test_optimize_distributed_mesh_matches_reference(name):
    """optimize_distributed(mesh=) over 4 shards against the reference's over
    4 devices (and the assembly's H, g within 1e-5 of their largest entry)."""
    g, cfg = GRAPHS[name]()
    n_a = max(1, g.num_nodes // 2)
    want = jdist.optimize_distributed(g, mesh=jsh.make_mesh(4), n_pose_nodes=n_a, config=jfg.OptimizerConfig(**cfg))
    got = tdist.optimize_distributed(torch_graph(g), mesh=_mesh(4), n_pose_nodes=n_a,
                                     config=tfg.OptimizerConfig(**cfg), device="cpu")
    np.testing.assert_allclose(got.node_t, want.node_t, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.node_R, want.node_R, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got.outlier_mask, want.outlier_mask)
    jH, jg, _ = (np.asarray(a) for a in jdist.assemble_normal_equations(g, mesh=jsh.make_mesh(4)))
    tH, tg, _ = (a.numpy() for a in tdist.assemble_normal_equations(torch_graph(g), mesh=_mesh(4), device="cpu"))
    np.testing.assert_allclose(tH, jH, rtol=0, atol=1e-5 * np.abs(jH).max())
    np.testing.assert_allclose(tg, jg, rtol=0, atol=1e-5 * max(np.abs(jg).max(), 1e-6))


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def test_sharded_checkpoint_restores_into_the_mesh(tmp_path):
    """A pipeline with n_devices=2 checkpointed mid-run restores with its
    window on a rebuilt 2-shard mesh and finishes with the map of an
    uninterrupted run, bit for bit."""
    from khronos_tpu_torch.data import synthetic as tsyn

    seq = tsyn.SyntheticSequence(
        tsyn.office_scene(4.0),
        tsyn.SyntheticSequenceConfig(duration=4.0, fps=4.0, height=48, width=64, fx=40.0, fy=40.0, cx=32.0,
                                     cy=24.0),
        device="cpu",
    )
    rendered = [seq.render_frame(i) for i in range(seq.n_frames)]
    cfg = {
        "active_window": {**AW_CONFIG, "n_devices": 2,
                          "volumetric_map": {"grid_shape": [48, 48, 32], "voxel_size": 0.1, "recenter_margin": 1.0}},
        "backend": {"lcd": None},
        "run_change_detection_every_n_frames": -1,
        "places": None,
    }

    def frame(f):
        return TFrame(stamp_ns=f["stamp_ns"], depth=f["depth"], color=f["color"], labels=f["labels"],
                      R_w_c=f["R_w_c"], t_w_c=f["t_w_c"])

    def run(pipe, fs):
        for f in fs:
            pipe.process_frame(frame(f), gt_pose=(f["R_gt"], f["t_gt"]))

    ref = TPipeline(tbuild(TPipelineConfig, cfg), seq.camera, device="cpu")
    run(ref, rendered)
    ref.finish()
    cut = len(rendered) // 2 + 1
    a = TPipeline(tbuild(TPipelineConfig, cfg), seq.camera, device="cpu")
    run(a, rendered[:cut])
    a.checkpoint(str(tmp_path))
    del a
    b = TPipeline.restore(str(tmp_path), device="cpu")
    aw = b.active_window
    assert aw.mesh is not None and aw.mesh.size == 2 and isinstance(aw.state, tsh.ShardedVolume)
    assert len(aw.state.slabs) == 2 and aw._fused_step is not None
    run(b, rendered[cut:])
    b.finish()
    m_ref, m_res = ref.map.snapshots[-1].mesh, b.map.snapshots[-1].mesh
    assert m_ref.num_vertices > 100
    for field in ("vertices", "faces", "first_seen_ns"):
        np.testing.assert_array_equal(getattr(m_res, field), getattr(m_ref, field), err_msg=field)
    assert set(b.map.snapshots[-1].objects) == set(ref.map.snapshots[-1].objects)
    for f in tav.VolumeState._fields:
        assert torch.equal(getattr(tsh.gather_volume(b.active_window.state), f),
                           getattr(tsh.gather_volume(ref.active_window.state), f)), f
