"""The emission round makes no host sync on the card: on the window's grid
(an output's archived round), a scroll's forced rounds and the sharded grid
(two slabs on one card), every call of the round runs under
`torch.cuda.set_sync_debug_mode("error")`, records no `wait/` span, and
gives the CPU's meshed flags and metas bit for bit. Each test needs a CUDA
device and skips without one; the file imports neither jax nor the JAX
package:

    python -m pytest --noconftest -p no:cacheprovider -o "markers=gpu: needs a CUDA device" \
        -m gpu tests/test_torch_emission_cuda.py
"""

import numpy as np
import pytest
import torch

from khronos_tpu_torch.active_window.fused_step import DenseGrid
from khronos_tpu_torch.map import active_volume as av
from khronos_tpu_torch.parallel import sharding
from khronos_tpu_torch.utils.timing import TimingRecorder

pytestmark = pytest.mark.gpu

SHAPE = (32, 24, 16)
# fewer slots than the sphere's 824 surface cells, so the archived round
# leaves cells for the next; the first forced round takes all 320 forced
# cells and ends in padding slots, and the second is padding only
MAX_CELLS = 512


def surface_state(device) -> av.VolumeState:
    """A sphere's signed distance on a fully observed, archived grid."""
    cfg = av.VolumeConfig(grid_shape=SHAPE)
    rng = np.random.default_rng(0)
    pts = np.stack(np.indices(SHAPE), axis=-1).astype(np.float32)
    dist = np.linalg.norm(pts - np.array([10.0, 12.0, 8.0], np.float32), axis=-1)
    tsdf = np.clip((dist - 6.5) * cfg.voxel_size, -cfg.truncation_distance, cfg.truncation_distance)
    first = rng.uniform(0.0, 2.0, SHAPE).astype(np.float32)
    fields = av.state_to_numpy(av.create(cfg, device="cpu"))._asdict() | dict(
        tsdf=tsdf.astype(np.float32), weight=np.full(SHAPE, 3.0, np.float32),
        color=rng.random(SHAPE + (3,), np.float32), label=rng.integers(-1, 5, SHAPE).astype(np.int32),
        first_obs=first, last_obs=first + 1.0, archived=np.ones(SHAPE, bool),
    )
    return av.state_from_numpy(fields, device=device)


def run_rounds(path: str, device, watch: bool = False):
    """(the grid's cell_meshed after the path's rounds, their metas' counts:
    triangles, cells wanted, cells emitted); with `watch`, the rounds alone
    under `inside`, the layout's set-up outside it."""
    cfg = av.VolumeConfig(grid_shape=SHAPE)
    dev = torch.device(device)
    state = surface_state(dev)
    if path == "sharded":
        grid = sharding.SlabGrid(sharding.make_mesh(2, devices=[dev]), SHAPE)
        state = grid.place(state)
    else:
        grid = DenseGrid(SHAPE)
    metas = []
    with inside(dev, watch):
        if path == "scroll":
            mask, rounds = grid.emission_mask(state, "forced", np.array([6, 0, -3])), 2
        else:
            mask, rounds = grid.emission_mask(state, "archived"), 1
        for _ in range(rounds):
            state, _, meta = grid.extract_mesh_async(state, mask, cfg, MAX_CELLS)
            metas.append(meta)
    return grid.whole(state).cell_meshed.cpu(), torch.stack(metas)[:, :3].cpu()


class inside:
    """On a CUDA device and `watch`: every synchronising call raises, and no
    `wait/` span may be recorded."""

    def __init__(self, device: torch.device, watch: bool):
        self.on_card = watch and device.type == "cuda"

    def __enter__(self):
        if self.on_card:
            torch.cuda.synchronize()
            TimingRecorder.instance().reset()
            torch.cuda.set_sync_debug_mode("error")

    def __exit__(self, *exc):
        if self.on_card:
            torch.cuda.set_sync_debug_mode("default")
            assert not [n for n in TimingRecorder.instance().names() if n.startswith("wait/")]


@pytest.mark.parametrize("path", ["window", "scroll", "sharded"])
def test_emission_round_has_no_host_sync(path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the sync debug mode watches CUDA streams")
    run_rounds(path, "cuda")  # a process's first round copies meshing's tables to the card
    got_meshed, got_meta = run_rounds(path, "cuda", watch=True)
    want_meshed, want_meta = run_rounds(path, "cpu")
    assert int(got_meta[0, 2]) > 0
    np.testing.assert_array_equal(got_meshed.numpy(), want_meshed.numpy())
    np.testing.assert_array_equal(got_meta.numpy(), want_meta.numpy())
