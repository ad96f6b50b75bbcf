"""The port's hand-written CUDA kernels against their plain PyTorch versions,
on the card. Every test here needs a CUDA device and skips without one; they
import neither jax nor the JAX package, so they also run where only PyTorch
is installed:

    python -m pytest --noconftest -p no:cacheprovider -o "markers=gpu: needs a CUDA device" \
        -m gpu tests/test_torch_kernels_cuda.py

(`--noconftest` skips tests/conftest.py, which imports jax; `-o markers=`
registers the marker that conftest.py registers otherwise.)
"""

import numpy as np
import pytest
import torch

from khronos_tpu_torch.ops import gather, propagate

pytestmark = pytest.mark.gpu


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


@pytest.mark.parametrize("shape,iterations", [((112, 112, 48), 16), ((20, 16, 12), 0), ((33, 7, 5), 3)])
def test_propagate_kernel_bit_exact(cuda, shape, iterations):
    lab, grow = _seeded(shape, iterations, cuda)
    before = propagate.launches
    got = propagate.propagate_labels_3d(lab, grow, iterations)
    want = propagate.propagate_labels_3d_plain(lab, grow, iterations)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert propagate.launches - before == max(iterations, 1)


def test_propagate_kernel_wall(cuda):
    shape = (112, 112, 48)
    labels = torch.full(shape, -1, dtype=torch.int32)
    labels[1, 1, 1] = 100
    labels[100, 100, 40] = 200
    grow = torch.ones(shape, dtype=torch.bool)
    grow[:, 56, :] = False
    got = propagate.propagate_labels_3d(labels.to(cuda), grow.to(cuda), 200).cpu()
    assert (got[:, :56][got[:, :56] >= 0] == 100).all()
    assert (got[:, 57:][got[:, 57:] >= 0] == 200).all()
    assert (got[:, 56] == -1).all()


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
