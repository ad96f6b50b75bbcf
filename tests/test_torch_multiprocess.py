"""Port parity for the window over several ranks (parallel/distributed.py,
parallel/workers.py, and sharding.py under a group): the port's counterpart
of tests/test_multihost.py, whose two processes x two CPU devices run the
reference's sharded step and pipeline over a global mesh.

Every test but one runs the ranks as threads of this process
(`distributed.ThreadGroup`), on the CPU. One test starts two processes:
gloo ranks through `workers.launch`, a file rendezvous in tmp_path, outputs
to files, its own 120 s limit. Tolerances:
- the step over 2 ranks x 2 slabs against the JAX package's single-process
  step: tests/test_multihost.py's checksums within its 1e-3 relative bound;
- the pipeline against the reference's run_pipeline(4) in its earliest
  host-pull schedule: tests/test_torch_sharding.py's bounds (weight sum rel
  1e-5, vertex sum 0.2, every count equal);
- the ranks against the port's one-process runs: bit for bit (digests of
  the bytes), everywhere.
"""

import copy
import threading

import numpy as np
import pytest
import torch

import chip_smoke
from khronos_tpu_torch.active_window.active_window import ActiveWindow, ActiveWindowConfig
from khronos_tpu_torch.backend import factor_graph
from khronos_tpu_torch.config import build
from khronos_tpu_torch.data import synthetic as tsyn
from khronos_tpu_torch.map import active_volume as tav
from khronos_tpu_torch.map import meshing
from khronos_tpu_torch.ops.dense import propagate_labels_3d
from khronos_tpu_torch.parallel import distributed, sharding, workers

from test_torch_bus import reference_earliest_schedule  # noqa: F401  (fixture)
from torch_parity import torch_camera  # noqa: F401  (sets one PyTorch thread)

N_SLABS = 4  # the reference's global mesh: 2 processes x 2 devices


def _threads(n_ranks, fn, *args, **kwargs):
    return distributed.run_threads(distributed.ThreadGroup.create(n_ranks), fn, *args, **kwargs)


@pytest.fixture
def one_solve_at_a_time(monkeypatch):
    """torch.func's forward-mode AD levels are process-wide: the thread
    ranks' backends take their Jacobians one at a time (ranks that are
    processes need no lock)."""
    lock = threading.Lock()
    solve = factor_graph._normal_equations

    def locked(*args, **kwargs):
        with lock:
            return solve(*args, **kwargs)

    monkeypatch.setattr(factor_graph, "_normal_equations", locked)


# ---------------------------------------------------------------------------
# tests/multihost_worker.py's step
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def step_one_process():
    return workers.sharded_step_checksums(None, N_SLABS, "cpu")


@pytest.fixture(scope="module")
def step_two_ranks():
    return _threads(2, workers.sharded_step_checksums, n_devices=N_SLABS)


def test_step_over_two_ranks_matches_reference(step_two_ranks):
    """The full fused step over 2 ranks x 2 slabs against the JAX package's
    single-process step on the worker's inputs, as tests/test_multihost.py
    compares its two processes."""
    from test_multihost import _single_process_reference

    ref = _single_process_reference()
    for out in step_two_ranks:
        assert out["devices"] == N_SLABS
        for k, v in ref.items():
            assert abs(out[k] - v) <= 1e-3 * max(abs(v), 1.0), (k, out[k], v)
    assert ref["obj_sum"] > 0 and ref["weight_sum"] > 0


@pytest.mark.parametrize("n_ranks", [2, 4])
def test_step_over_ranks_equals_one_process(step_one_process, step_two_ranks, n_ranks):
    """Every rank's volume, images and stats equal the one-process 4-slab
    step's, bit for bit, with 2 slabs a rank or one."""
    outs = step_two_ranks if n_ranks == 2 else _threads(4, workers.sharded_step_checksums, n_devices=N_SLABS)
    assert len(outs) == n_ranks
    for out in outs:
        assert out == step_one_process


def test_two_process_step_equals_threads(tmp_path, step_two_ranks):
    """The one test that starts processes: 2 gloo ranks (fresh interpreters
    through workers.launch, a file rendezvous in tmp_path) give the
    thread ranks' results bit for bit."""
    outs = workers.launch(2, "gloo", "sharded_step_checksums", {"n_devices": N_SLABS}, tmp_path, timeout_s=120,
                          device="cpu")
    assert outs == step_two_ranks
    assert all((tmp_path / f"rank{r}.err").exists() for r in range(2))


# ---------------------------------------------------------------------------
# tests/multihost_pipeline_worker.py's pipeline
# ---------------------------------------------------------------------------


def _reference_frames():
    """The reference worker's sequence, rendered by the JAX package."""
    from khronos_tpu.data import synthetic as jsyn

    seq = jsyn.SyntheticSequence(jsyn.office_scene(duration=8.0), jsyn.SyntheticSequenceConfig(
        duration=8.0, fps=1.0, height=48, width=64, fx=40.0, fy=40.0, cx=32.0, cy=24.0))
    frames = [{k: (np.array(v) if hasattr(v, "shape") else v) for k, v in seq.render_frame(i).items()}
              for i in range(seq.n_frames)]
    return torch_camera(seq.camera), frames


def test_pipeline_over_two_ranks_matches_reference(reference_earliest_schedule, one_solve_at_a_time):
    """run_pipeline(4) over 2 ranks x 2 slabs against the reference's
    run_pipeline(4) (the single-process side of tests/test_multihost.py) on
    the JAX renderer's frames; every rank equals the port's one-process run
    bit for bit."""
    from multihost_pipeline_worker import run_pipeline

    want = run_pipeline(4)
    camera, frames = _reference_frames()
    one = workers.run_pipeline(None, N_SLABS, "cpu", frames=copy.deepcopy(frames), camera=camera, digests=True)
    ranks = _threads(2, workers.run_pipeline, n_devices=N_SLABS, frames=frames, camera=camera, digests=True)
    for got in ranks:
        assert got == one
    got = {k: v for k, v in one.items() if k in want}
    assert got["weight_sum"] == pytest.approx(want.pop("weight_sum"), rel=1e-5)
    assert got.pop("mesh_vertex_sum") == pytest.approx(want.pop("mesh_vertex_sum"), abs=0.2)
    got.pop("weight_sum")
    assert got == want
    assert want["n_objects"] >= 1 and want["n_optimizations"] >= 1


def test_pipeline_over_ranks_on_the_port_renderer(one_solve_at_a_time):
    """The same pipeline on the port's own frames: 2 ranks equal one
    process, bit for bit."""
    one = workers.run_pipeline(None, N_SLABS, "cpu", digests=True)
    for got in _threads(2, workers.run_pipeline, n_devices=N_SLABS, digests=True):
        assert got == one
    assert one["n_mesh_vertices"] > 0


# ---------------------------------------------------------------------------
# the window
# ---------------------------------------------------------------------------

def _window_config(grid):
    """chip_smoke.py's main-path window (the bench detectors, stride 2) on `grid`."""
    return {**chip_smoke.bench_config(), "volumetric_map": {"grid_shape": list(grid), "voxel_size": 0.1}}


WINDOW = dict(config=_window_config((48, 48, 32)), sequence=chip_smoke.sequence_settings(12, 48, 64), warmup=4,
              frames=8)


@pytest.mark.parametrize("n_ranks,n_slabs", [(2, 2), (2, 4)])
def test_window_over_ranks_equals_one_process(n_ranks, n_slabs):
    """The window (the main path's detectors and stride) over ranks: every
    frame's packed stats and id images, the triangles in emission order,
    the finished tracks and every slab each rank holds equal the
    one-process window's, bit for bit."""
    one = workers.run_window(None, n_devices=n_slabs, device="cpu", **WINDOW)
    ranks = _threads(n_ranks, workers.run_window, n_devices=n_slabs, **WINDOW)
    keys = ("packed", "images", "triangles", "triangles_digest", "tracks", "tracks_digest", "dynamic_ids")
    held = []
    for r, got in enumerate(ranks):
        assert {k: got[k] for k in keys} == {k: one[k] for k in keys}
        assert got["slabs"] == list(range(r * n_slabs // n_ranks, (r + 1) * n_slabs // n_ranks))
        for s, d in got["slab_digests"].items():
            assert d == one["slab_digests"][s], s
        held += got["slabs"]
    assert held == list(range(n_slabs)) and one["triangles"] > 0


# ---------------------------------------------------------------------------
# the grid passes across ranks
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def surface():
    """A 32x32x16 grid with surface in every slab: the one-process state
    after the worker's two steps."""
    mesh, state, _ = workers.sharded_step(None, N_SLABS, "cpu")
    return sharding.gather_volume(state)


def _each_rank(fn, n_ranks=2, n_slabs=N_SLABS):
    """fn(mesh, group) in every rank of a ThreadGroup over n_slabs."""
    return _threads(n_ranks, lambda g: fn(sharding.make_mesh(n_slabs, group=g), g))


def test_halo_beyond_a_slab_and_across_ranks():
    """A stencil whose reach (11 planes) passes a slab (8 planes) and the
    rank boundary: each rank's slabs of the result equal the one-grid
    result's planes."""
    rng = np.random.default_rng(3)
    lab = torch.from_numpy(np.where(rng.random((32, 12, 10)) < 0.02, rng.integers(0, 1000, (32, 12, 10)), -1)
                           .astype(np.int32))
    grow = torch.from_numpy(rng.random((32, 12, 10)) < 0.7)
    want = propagate_labels_3d(lab, grow, 11)
    assert not torch.equal(want, propagate_labels_3d(lab, grow, 7))  # the far planes matter

    def body(mesh, group):
        grid = sharding.SlabGrid(mesh, (32, 12, 10))
        split = [lab[i * 8:(i + 1) * 8] if i in mesh.local else None for i in range(N_SLABS)]
        gsplit = [grow[i * 8:(i + 1) * 8] if i in mesh.local else None for i in range(N_SLABS)]
        out = grid.stencil(lambda a, b: propagate_labels_3d(a, b, 11), 11, split, gsplit)
        return {i: torch.equal(out[i], want[i * 8:(i + 1) * 8]) for i in mesh.local}

    held = {}
    for r in _each_rank(body):
        held.update(r)
    assert held == {i: True for i in range(N_SLABS)}


SHIFTS = {"x_and_yz": [5, -3, 2], "x_back": [-9, 0, 0], "beyond_a_rank": [21, 4, -1]}


@pytest.mark.parametrize("shift", list(SHIFTS))
def test_scroll_across_ranks(surface, shift):
    """A scroll whose planes move across slab and rank boundaries equals
    av.scroll of the whole grid, every field bit for bit."""
    shift = SHIFTS[shift]
    cfg = tav.VolumeConfig(grid_shape=(32, 32, 16), voxel_size=0.1)
    want = tav.scroll(cfg, surface, shift)

    def body(mesh, group):
        sv = sharding.shard_volume(surface, mesh)
        got = sharding.gather_volume(sharding.scroll(cfg, sv, shift, mesh=mesh), mesh=mesh)
        return [f for f in tav.VolumeState._fields if not torch.equal(getattr(got, f), getattr(want, f))]

    assert _each_rank(body) == [[], []]


def test_emission_and_extraction_across_ranks(surface):
    """Emission masks of every kind per slab, and emission rounds (capped
    and whole) with wanted cells on both ranks, equal the one-grid
    functions: masks, packed triangles, metas and cell_meshed."""
    cfg = tav.VolumeConfig(grid_shape=(32, 32, 16), voxel_size=0.1)
    shift = [6, 0, -2]
    masks = {"archived": meshing.archived_emission_mask(surface), "finish": meshing.finish_emission_mask(surface),
             "forced": meshing.forced_emission_mask(surface, tav.scroll_out_mask(surface, shift))}
    finish = masks["finish"]
    cells_per_rank = [int(finish[r * 16:(r + 1) * 16].sum()) for r in range(2)]
    assert all(c > 0 for c in cells_per_rank), cells_per_rank
    rounds = {mc: meshing.extract_mesh_async(surface, finish, cfg, max_cells=mc) for mc in (64, 1 << 14)}

    def body(mesh, group):
        sv = sharding.shard_volume(surface, mesh)
        bad = []
        for kind, want in masks.items():
            got = sharding.emission_masks(sv, kind, shift, mesh=mesh)
            bad += [(kind, i) for i in mesh.local if not torch.equal(got[i], want[i * 8:(i + 1) * 8])]
        for mc, (w_state, w_packed, w_meta) in rounds.items():
            s2, packed, meta = sharding.extract_mesh_async(sv, sharding.emission_masks(sv, "finish", mesh=mesh), cfg,
                                                           max_cells=mc, mesh=mesh)
            if not (torch.equal(packed, w_packed) and torch.equal(meta, w_meta)):
                bad.append(("round", mc))
            if not torch.equal(sharding.gather_volume(s2, mesh=mesh).cell_meshed, w_state.cell_meshed):
                bad.append(("cell_meshed", mc))
        return bad

    assert _each_rank(body) == [[], []]
    assert float(rounds[64][2][1]) > 64  # the capped round leaves wanted cells


def test_modular_path_whole_and_place_across_ranks(surface):
    """SlabGrid.whole gives every rank the whole grid, and place keeps each
    rank's slabs of it (the modular window path over ranks)."""

    def body(mesh, group):
        grid = sharding.SlabGrid(mesh, (32, 32, 16))
        sv = grid.place(surface)
        held = [i for i, _ in sv.local]
        whole = grid.whole(sv)
        same = all(torch.equal(getattr(whole, f), getattr(surface, f)) for f in tav.VolumeState._fields)
        again = grid.place(whole)
        kept = all(torch.equal(getattr(a, f), getattr(b, f)) for (_, a), (_, b) in zip(again.local, sv.local)
                   for f in tav.VolumeState._fields)
        return held, same, kept

    assert _each_rank(body) == [([0, 1], True, True), ([2, 3], True, True)]


def test_gather_keeps_negative_zero_and_nan_payloads_from_the_other_rank():
    """A pixel owned by the other rank's slab whose value is -0.0 comes back
    as -0.0 (a sum would give +0.0), and a NaN payload comes back as is."""
    nan_bits = np.int32(0x7FC01234)

    def body(mesh, group):
        grid = sharding.SlabGrid(mesh, (4, 2, 2))
        clin = torch.tensor([0, 5, 9, 15], dtype=torch.long)  # slabs 0, 1, 2, 3
        vals = {0: 1.5, 1: 2.5, 2: -0.0, 3: float(np.int32(nan_bits).view(np.float32))}
        grids = [torch.full((1, 2, 2), vals[i], dtype=torch.float32) if i in mesh.local else None
                 for i in range(N_SLABS)]
        return grid.gather(grids, grid.route(clin))

    for out in _each_rank(body):
        assert out[:2].tolist() == [1.5, 2.5]
        assert out[2].item() == 0.0 and torch.signbit(out[2]).item()
        assert out[3:].view(torch.int32).item() == nan_bits


# ---------------------------------------------------------------------------
# errors
# ---------------------------------------------------------------------------


def test_nccl_with_two_ranks_on_one_card_raises_before_init(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="one rank a card"):
        distributed.initialize(0, 2, f"file://{tmp_path / 'rendezvous'}", "nccl")
    assert not torch.distributed.is_initialized()
    assert not (tmp_path / "rendezvous").exists()


def test_indivisible_slabs_over_ranks_raise():
    groups = distributed.ThreadGroup.create(2)
    with pytest.raises(ValueError, match="multiple of the ranks"):
        sharding.make_mesh(3, group=groups[0])
    cam, _ = workers.pipeline_frames("cpu")
    cfg = build(ActiveWindowConfig, {**_window_config((30, 16, 8)), "n_devices": 3})
    with pytest.raises(ValueError, match="multiple of the ranks"):
        ActiveWindow(cfg, cam, tsyn.default_label_space(), device="cpu", group=groups[1])


def test_no_gpu_without_cpu_raises(monkeypatch, tmp_path):
    """Every entry point runs on CUDA unless the caller asks for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        distributed.initialize(0, 2, f"file://{tmp_path / 'rendezvous'}", "gloo")
    for run in (lambda: workers.run_window(None, n_devices=2, **WINDOW),
                lambda: workers.sharded_step_checksums(None),
                lambda: workers.run_pipeline(None),
                lambda: workers.run_config(None, out_dir=str(tmp_path / "run_config"))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run()
    assert not torch.distributed.is_initialized()
    assert not (tmp_path / "run_config").exists()


def test_a_rank_that_skips_a_collective_times_out_with_its_name():
    groups = distributed.ThreadGroup.create(2, timeout_s=0.5)
    released = threading.Event()

    def body(g):
        if g.rank == 1:
            released.wait(5)
            return None
        try:
            return g.all_gather(torch.zeros(3))
        finally:
            released.set()

    with pytest.raises(TimeoutError, match="rank 0 of 2: all_gather"):
        distributed.run_threads(groups, body)


def test_a_group_counts_its_collectives_bytes_and_seconds():
    def body(g):
        got = g.all_gather(torch.full((3,), g.rank, dtype=torch.int64))
        g.barrier()
        return [t.tolist() for t in got], g.calls, g.gathered_bytes, g.seconds

    for got, calls, gathered, seconds in _threads(2, body):
        assert got == [[0, 0, 0], [1, 1, 1]]
        assert (calls, gathered) == (2, 2 * 3 * 8) and seconds > 0
