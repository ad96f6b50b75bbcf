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
against the same inputs, and with chip_smoke.py.
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
