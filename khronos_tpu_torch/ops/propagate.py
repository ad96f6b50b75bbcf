"""Kernel A: iterated 3D label propagation (port of the Pallas
`khronos_tpu/ops/pallas/propagate.py::_propagate_kernel`).

`propagate_labels_3d` computes exactly `khronos_tpu/ops/dense.py::
propagate_labels_3d`, bit for bit. A CUDA tensor goes to the hand-written
kernel `csrc/propagate.cu` (all rounds in one cooperative launch, over tiles
with a halo, active tiles only, stopping at the fixpoint; see the note
there); a CPU tensor goes to `propagate_labels_3d_plain`. There is no
fallback from one to the other.

`launches` counts kernel launches: one per call.
"""

from __future__ import annotations

import torch

from khronos_tpu_torch.ops import native
from khronos_tpu_torch.ops.dense import max_pool3

launches = 0

TILE = (8, 4, 26)  # csrc/propagate.cu: the tile interior (TX, TY, TZ = 32 - 2 D)
DEPTH = 3  # csrc/propagate.cu: rounds between two barriers (D)
WS_ROUNDS, WS_HEADER = 96, 128  # workspace words: rounds run; then the tile marks


def propagate_labels_3d_plain(
    labels: torch.Tensor, growable: torch.Tensor, iterations: int
) -> torch.Tensor:
    """Plain PyTorch version: masked start, then `iterations` rounds of
    where(growable, max(lab, max_pool3(lab, pad=-1)), -1)."""
    lab = torch.where(growable, labels, -1)
    for _ in range(iterations):
        spread = max_pool3(lab, pad_value=-1)
        lab = torch.where(growable, torch.maximum(lab, spread), -1)
    return lab


def _check(labels: torch.Tensor, growable: torch.Tensor) -> None:
    if labels.dtype != torch.int32 or growable.dtype != torch.bool:
        raise TypeError(f"propagate_labels_3d: need int32 labels and bool growable, got {labels.dtype}, {growable.dtype}")
    if labels.ndim != 3 or labels.shape != growable.shape:
        raise ValueError(f"propagate_labels_3d: need equal [X, Y, Z] shapes, got {tuple(labels.shape)}, {tuple(growable.shape)}")
    if labels.device != growable.device:
        raise ValueError("propagate_labels_3d: labels and growable on different devices")


def propagate_labels_3d(
    labels: torch.Tensor, growable: torch.Tensor, iterations: int
) -> torch.Tensor:
    """labels int32 [X, Y, Z] (-1 = unlabeled), growable bool [X, Y, Z]."""
    _check(labels, growable)
    if labels.device.type == "cpu":
        return propagate_labels_3d_plain(labels, growable, iterations)
    if labels.device.type != "cuda":
        raise ValueError(f"propagate_labels_3d: unsupported device {labels.device}")
    return propagate_labels_3d_cuda(labels, growable, iterations)


def propagate_labels_3d_cuda(
    labels: torch.Tensor, growable: torch.Tensor, iterations: int
) -> torch.Tensor:
    """Kernel A on CUDA tensors (raises on anything else)."""
    return launch(labels, growable, iterations)[0]


def n_tiles(shape) -> int:
    """Tiles of csrc/propagate.cu's tile shape that cover a grid."""
    n = 1
    for s, t in zip(shape, TILE):
        n *= -(-s // t)
    return n


def launch(labels: torch.Tensor, growable: torch.Tensor, iterations: int):
    """Kernel A's one launch: (out, workspace), the workspace being the
    kernel's int32 words on the device: `workspace[WS_ROUNDS]` holds the
    rounds run and, when iterations > 0, `workspace[WS_HEADER:][:n_tiles]`
    marks the tiles holding a growable cell. Nothing here waits for the
    device."""
    global launches
    _check(labels, growable)
    if not labels.is_cuda:
        raise ValueError("propagate_labels_3d_cuda needs CUDA tensors")
    if not (labels.is_contiguous() and growable.is_contiguous()):
        raise ValueError("propagate_labels_3d_cuda needs contiguous tensors")
    if labels.numel() >= 2**31:
        raise ValueError("propagate_labels_3d: grid too large for int32 cell counts")
    lib = native.load_library()
    X, Y, Z = labels.shape
    tiles = n_tiles(labels.shape)
    out = torch.empty_like(labels)
    tmp = torch.empty_like(labels)
    ws = torch.empty(WS_HEADER + 2 * tiles, dtype=torch.int32, device=labels.device)
    stream = torch.cuda.current_stream(labels.device).cuda_stream
    native.check(
        lib.khr_propagate(
            labels.data_ptr(), growable.view(torch.uint8).data_ptr(), out.data_ptr(), tmp.data_ptr(),
            ws.data_ptr(), X, Y, Z, tiles, max(int(iterations), 0), stream,
        ),
        "khr_propagate",
    )
    launches += 1
    return out, ws
