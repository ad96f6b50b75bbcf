"""The yardstick of the kernels' roofline shares: the card's published
peak and the least bytes each kernel's work moves, from the shapes the
configuration fixes. Both kernels are bound by bytes.

The peak of one NVIDIA H100 SXM (NVIDIA's data sheet): 3.35 TB/s of HBM3,
at a 700 W power limit.
"""

from __future__ import annotations

import numpy as np

from harness import reference

HBM_BYTES_PER_S = 3.35e12


def crop_cells(cfg: dict) -> int:
    """Voxels of the window's camera-centred crop, where the step runs."""
    vm = cfg["active_window"]["volumetric_map"]
    shape = vm["grid_shape"]
    _, size = reference.crop_box(shape, np.zeros(3, np.int64), np.zeros(3, np.float32), cfg["sensor"],
                                 vm["voxel_size"], vm.get("truncation_distance", 0.2))
    return int(np.prod(size))


def propagate_bound_s(cfg: dict) -> float:
    """Kernel A at the crop: what every input needs, the uint8 growable
    mask read once and the int32 labels written once. The labels are read
    and grown only where a cell is growable (a few hundred of the crop's
    cells in a frame with motion, none without), so neither they nor the
    rounds' operations are counted: the bound stays below the least time
    of any input, and the share cannot pass 100% by over-counting."""
    return 5 * crop_cells(cfg) / HBM_BYTES_PER_S


def gather_bound_s(cfg: dict) -> float:
    """Kernel B at the crop: the [H*W, 2] payload image read once, an int32
    index a voxel read and two words a voxel written."""
    n = crop_cells(cfg)
    px = cfg["sensor"]["height"] * cfg["sensor"]["width"]
    return (8 * px + 12 * n) / HBM_BYTES_PER_S
