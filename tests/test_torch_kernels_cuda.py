"""The port's hand-written CUDA kernels against their plain PyTorch versions,
on the card. Every test here needs a CUDA device and skips without one; they
import neither jax nor the JAX package, so they also run where only PyTorch
is installed:

    python -m pytest --noconftest -p no:cacheprovider -o "markers=gpu: needs a CUDA device" \
        -m gpu tests/test_torch_kernels_cuda.py

(`--noconftest` skips tests/conftest.py, which imports jax; `-o markers=`
registers the marker that conftest.py registers otherwise.)

`propagate_case`, `expected_rounds` and `active_tiles` are shared with
tests/test_torch_ops.py, which holds a CPU model of kernel A's schedule
against the same inputs, and with chip_smoke.py; `snake_case` and
`fixpoint_rounds` with tests/test_torch_places.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from khronos_tpu_torch.ops import gather, propagate

pytestmark = pytest.mark.gpu

# kernel A's inputs: odd shapes, and iterations around the rounds one
# barrier covers (h = propagate.DEPTH: h - 1, h, h + 1) and the main path's 16
ODD_SHAPES = [(37, 53, 29), (1, 1, 1), (5, 112, 3)]
ODD_ITERATIONS = sorted({0, 1, propagate.DEPTH - 1, propagate.DEPTH, propagate.DEPTH + 1, 16, 17})
# no growable cell; every cell growable; a fixpoint at round 0; blobs that
# settle mid-way; a plane that does not settle within 17 rounds
FAMILIES = ["none", "all", "fix0", "mid", "never"]


def propagate_case(shape, family, seed=0):
    """(labels int32, growable bool) CPU tensors of one input family."""
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    lin = np.arange(n, dtype=np.int32).reshape(shape)
    if family == "none":
        return torch.from_numpy(rng.integers(-1, 1000, shape).astype(np.int32)), torch.zeros(shape, dtype=torch.bool)
    if family == "all":  # any int32 below -1 too: the separable max is exact for all
        lab = np.where(rng.random(shape) < 0.05, lin, rng.integers(-4, 0, shape)).astype(np.int32)
        return torch.from_numpy(lab), torch.ones(shape, dtype=torch.bool)
    if family == "fix0":  # one label per growable cell already: nothing moves
        return torch.full(shape, 7, dtype=torch.int32), torch.from_numpy(rng.random(shape) < 0.5)
    if family == "mid":  # dilated sparse seeds, as the motion detector grows them
        seeds = rng.random(shape) < 0.0005
        seeds.flat[0] = True
        grow = torch.from_numpy(seeds)
        for _ in range(2):
            g = torch.nn.functional.pad(grow.float()[None, None], (1, 1, 1, 1, 1, 1))
            grow = torch.nn.functional.max_pool3d(g, 3, stride=1)[0, 0] > 0
        return torch.from_numpy(np.where(seeds, lin, -1).astype(np.int32)), grow
    if family == "never":  # the plane z = 0, its largest label in the far corner
        grow = np.zeros(shape, bool)
        grow[:, :, 0] = True
        lab = np.full(shape, -1, np.int32)
        lab[0, 0, 0] = 1
        lab[-1, -1, 0] = n
        return torch.from_numpy(lab), torch.from_numpy(grow)
    raise ValueError(family)


def expected_rounds(lab, grow, iterations, depth=propagate.DEPTH):
    """Rounds kernel A runs, `depth` a step: none without a growable cell,
    else every step up to the one holding the first round that changes
    nothing, at most `iterations` rounds."""
    if iterations <= 0 or not bool(grow.any()):
        return 0
    cur = torch.where(grow, lab, -1)
    for k in range(iterations):
        nxt = propagate.propagate_labels_3d_plain(cur, grow, 1)
        if torch.equal(nxt, cur):
            return min(iterations, -(-(k + 1) // depth) * depth)
        cur = nxt
    return iterations


def snake_case(shape, pitch=8):
    """(labels int32, growable bool) CPU tensors: a corridor that snakes
    along x, lane after lane along y, on every z (lanes pitch - 2 cells wide,
    walls 2 cells thick, joined at alternate ends), every corridor cell
    seeded with its linear index + 1, the room segmentation's seeding. The
    largest label travels the whole corridor: rounds grow with its length."""
    X, Y, Z = shape
    grow = np.zeros(shape, bool)
    lanes = list(range(0, Y - 1, pitch))
    for k, y0 in enumerate(lanes):
        grow[:, y0: y0 + pitch - 2, :] = True
        if k + 1 < len(lanes):  # the joint to the next lane, at alternate ends
            x = slice(X - 2, X) if k % 2 == 0 else slice(0, 2)
            grow[x, y0: y0 + pitch, :] = True
    seeds = np.arange(1, grow.size + 1, dtype=np.int32).reshape(shape)
    return torch.from_numpy(np.where(grow, seeds, -1).astype(np.int32)), torch.from_numpy(grow)


def fixpoint_rounds(plain_rounds, grow, numel, depth=propagate.DEPTH):
    """Rounds kernel A reports at the fixpoint: the plain loop's rounds (the
    last of them changing nothing), in whole steps of `depth`, at most numel;
    none without a growable cell."""
    if numel <= 0 or not bool(grow.any()):
        return 0
    return min(numel, -(-plain_rounds // depth) * depth)


def active_tiles(grow) -> int:
    """Tiles of kernel A's tile shape that hold a growable cell."""
    t = propagate.TILE
    n = [-(-s // b) for s, b in zip(grow.shape, t)]
    g = torch.zeros([a * b for a, b in zip(n, t)], dtype=torch.bool, device=grow.device)
    g[: grow.shape[0], : grow.shape[1], : grow.shape[2]] = grow
    return int(g.view(n[0], t[0], n[1], t[1], n[2], t[2]).any(5).any(3).any(1).sum())


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _seeded(shape, seed, device):
    g = torch.Generator().manual_seed(seed)
    seeds = torch.rand(shape, generator=g) < 0.02
    grow = (torch.rand(shape, generator=g) < 0.4) | seeds
    lin = torch.arange(int(np.prod(shape)), dtype=torch.int32).view(shape)
    return torch.where(seeds, lin, -1).to(device), grow.to(device)


def _run_kernel_a(lab, grow, iterations):
    """(out, active tiles, rounds run), one launch."""
    before = propagate.launches
    out, ws = propagate.launch(lab, grow, iterations)
    torch.cuda.synchronize()
    assert propagate.launches - before == 1
    marks = ws[propagate.WS_HEADER: propagate.WS_HEADER + propagate.n_tiles(lab.shape)]
    return out, int((marks != 0).sum()), int(ws[propagate.WS_ROUNDS])


@pytest.mark.parametrize("shape,iterations", [((112, 112, 48), 16), ((20, 16, 12), 0), ((33, 7, 5), 3)])
def test_propagate_kernel_bit_exact(cuda, shape, iterations):
    lab, grow = _seeded(shape, iterations, cuda)
    before = propagate.launches
    got = propagate.propagate_labels_3d(lab, grow, iterations)
    want = propagate.propagate_labels_3d_plain(lab, grow, iterations)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert propagate.launches - before == 1


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("shape", ODD_SHAPES)
def test_propagate_kernel_odd_shapes(cuda, shape, family):
    lab, grow = propagate_case(shape, family)
    for iterations in ODD_ITERATIONS:
        got, active, rounds = _run_kernel_a(lab.to(cuda), grow.to(cuda), iterations)
        want = propagate.propagate_labels_3d_plain(lab, grow, iterations)
        assert torch.equal(got.cpu(), want), (shape, family, iterations)
        assert rounds == expected_rounds(lab, grow, iterations), (shape, family, iterations)
        if iterations:
            assert active == active_tiles(grow), (shape, family)


@pytest.mark.parametrize("iterations", [16, 112])
def test_propagate_kernel_wall(cuda, iterations):
    shape = (112, 112, 48)
    labels = torch.full(shape, -1, dtype=torch.int32)
    labels[1, 1, 1] = 100
    labels[100, 100, 40] = 200
    grow = torch.ones(shape, dtype=torch.bool)
    grow[:, 56, :] = False
    got, _, rounds = _run_kernel_a(labels.to(cuda), grow.to(cuda), iterations)
    want = propagate.propagate_labels_3d_plain(labels.to(cuda), grow.to(cuda), iterations)
    assert torch.equal(got, want)
    got = got.cpu()
    assert (got[:, :56][got[:, :56] >= 0] == 100).all()
    assert (got[:, 57:][got[:, 57:] >= 0] == 200).all()
    assert (got[:, 56] == -1).all()
    assert rounds == expected_rounds(labels, grow, iterations)


@pytest.mark.parametrize("fixpoint_at_round_0", [False, True])
def test_propagate_kernel_more_tiles_than_a_block_lists(cuda, fixpoint_at_round_0):
    """40,960 tiles, every one active: more a block than the kernel's list in
    shared memory holds, so the rest come from the tile marks."""
    shape = (320, 256, 416)
    g = torch.Generator(device=cuda).manual_seed(3)
    grow = torch.rand(shape, device=cuda, generator=g) < 0.4
    if fixpoint_at_round_0:
        lab = torch.full(shape, 7, dtype=torch.int32, device=cuda)
    else:
        lab = torch.where(torch.rand(shape, device=cuda, generator=g) < 0.01,
                          torch.arange(int(np.prod(shape)), dtype=torch.int32, device=cuda).view(shape), -1)
    got, active, rounds = _run_kernel_a(lab, grow, 4)
    assert torch.equal(got, propagate.propagate_labels_3d_plain(lab, grow, 4))
    assert active == propagate.n_tiles(shape)
    assert rounds == (propagate.DEPTH if fixpoint_at_round_0 else 4)


def test_propagate_kernel_graph_replay(cuda):
    """One call captured into a CUDA graph replays bit-exact on new inputs
    written into the captured tensors."""
    shape, iterations = (112, 112, 48), 16
    lab, grow = _seeded(shape, 5, cuda)
    propagate.propagate_labels_3d(lab, grow, iterations)  # builds, and warms the occupancy query
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = propagate.propagate_labels_3d(lab, grow, iterations)
    for seed in (6, 7, 6):
        new_lab, new_grow = _seeded(shape, seed, cuda)
        lab.copy_(new_lab)
        grow.copy_(new_grow)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, propagate.propagate_labels_3d_plain(lab, grow, iterations)), seed


def test_gather_kernel_bit_exact(cuda):
    g = torch.Generator().manual_seed(3)
    words = torch.randint(-2**31, 2**31 - 1, (307200, 2), generator=g, dtype=torch.int64).to(torch.int32)
    words[:64, 1] = 0x7FC00001  # NaN bit patterns survive the copy
    img = words.view(torch.float32).to(cuda)
    idx = torch.randint(0, 307200, (602112,), generator=g, dtype=torch.int32)
    idx[:4] = torch.tensor([-1, -307201, 307200, 10**9], dtype=torch.int32)
    idx = idx.to(cuda)
    before = gather.launches
    got = gather.gather_rows(img, idx)
    want = gather.gather_rows_plain(img, idx)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert gather.launches == before + 1


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    lab, grow = _seeded((8, 8, 8), 0, cuda)
    with pytest.raises(ValueError):
        propagate.propagate_labels_3d(lab.transpose(0, 2), grow, 2)
    img = torch.zeros((10, 2), device=cuda)
    with pytest.raises(ValueError):
        gather.gather_rows(img.t().contiguous().t(), torch.zeros(3, dtype=torch.int32, device=cuda))


@pytest.mark.parametrize("case", ["snake", "rooms", "odd"])
def test_propagate_fixpoint_wrapper(cuda, case):
    """propagate_labels_3d_fixpoint on the card: kernel A in one launch, to
    the fixpoint, bit for bit against the plain loop, with the rounds it
    reports against the loop's count."""
    if case == "snake":  # hundreds of rounds along the corridor
        lab, grow = snake_case((144, 144, 16), pitch=16)
    elif case == "rooms":  # blobs of free space, seeded as the room segmentation seeds them
        g = torch.Generator().manual_seed(4)
        grow = torch.rand((64, 80, 16), generator=g) < 0.6
        lab = torch.where(grow, torch.arange(1, grow.numel() + 1, dtype=torch.int32).view(grow.shape), -1)
    else:  # Z below one tile
        lab, grow = propagate_case((37, 53, 5), "mid", seed=1)
    want, plain_rounds = propagate.propagate_labels_3d_fixpoint_plain(lab, grow)
    before = propagate.launches
    got = propagate.propagate_labels_3d_fixpoint(lab.to(cuda), grow.to(cuda))
    torch.cuda.synchronize()
    assert propagate.launches - before == 1
    assert torch.equal(got.cpu(), want)
    _, _, rounds = _run_kernel_a(lab.to(cuda), grow.to(cuda), lab.numel())
    assert rounds == fixpoint_rounds(plain_rounds, grow, lab.numel())
    if case == "snake":
        assert plain_rounds > 300


@pytest.fixture
def two_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices: a sharded window's pulls span cards")
    return torch.device("cuda", 0), torch.device("cuda", 1)


def test_host_copy_over_two_cards_is_ready_once_both_land(two_cards):
    """A HostCopy of tensors on two cards (a sharded window's pull) is ready
    only once each card's copy has landed: card 1's copy queues behind a
    sleep of about a second on its stream, card 0's does not."""
    from khronos_tpu_torch.utils.host_copy import HostCopy

    first, second = two_cards
    a = torch.arange(4096, dtype=torch.int32, device=first)
    b = torch.arange(4096, dtype=torch.float32, device=second) * 0.5
    torch.cuda.synchronize(first)
    torch.cuda.synchronize(second)
    with torch.cuda.device(second):
        torch.cuda._sleep(2_000_000_000)
    copy = HostCopy(a, b)
    assert len(copy.events) == 2
    torch.cuda.synchronize(first)
    assert not copy.ready()  # card 0's copy has landed, card 1's has not
    torch.cuda.synchronize(second)
    assert copy.ready()
    assert np.array_equal(copy.numpy(0), a.cpu().numpy()) and np.array_equal(copy.numpy(1), b.cpu().numpy())


def test_two_gloo_ranks_on_one_card_equal_one_process(cuda, tmp_path):
    """tests/multihost_worker.py's step over 2 gloo ranks x 2 slabs, both
    ranks fresh interpreters on card 0 (parallel.workers.launch), against
    the one-process 4-slab step on the card: the whole grid, the images and
    the stats of each step bit for bit (digests of their bytes)."""
    from khronos_tpu_torch.parallel import workers

    outs = workers.launch(2, "gloo", "sharded_step_checksums", {"n_devices": 4}, tmp_path, timeout_s=300,
                          device="cuda")
    one = workers.sharded_step_checksums(None, 4, "cuda")
    assert outs == [one, one]
    assert one["obj_sum"] > 0
