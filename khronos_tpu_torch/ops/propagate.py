"""Kernel A: iterated 3D label propagation (port of the Pallas
`khronos_tpu/ops/pallas/propagate.py::_propagate_kernel`).

`propagate_labels_3d` computes exactly `khronos_tpu/ops/dense.py::
propagate_labels_3d`, bit for bit. A CUDA tensor goes to the hand-written
kernel `csrc/propagate.cu` (one launch per round, ping-pong buffers; see the
note there); a CPU tensor goes to `propagate_labels_3d_plain`. There is no
fallback from one to the other.

`launches` counts kernel launches (one per round, one for iterations == 0).
"""

from __future__ import annotations

import torch

from khronos_tpu_torch.ops import native
from khronos_tpu_torch.ops.dense import max_pool3

launches = 0


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
    global launches
    _check(labels, growable)
    if not labels.is_cuda:
        raise ValueError("propagate_labels_3d_cuda needs CUDA tensors")
    if not (labels.is_contiguous() and growable.is_contiguous()):
        raise ValueError("propagate_labels_3d_cuda needs contiguous tensors")
    lib = native.load_library()
    grow = growable.view(torch.uint8)
    X, Y, Z = labels.shape
    if labels.numel() >= 2**31:
        raise ValueError("propagate_labels_3d: grid too large for int32 cell counts")
    out = torch.empty_like(labels)
    stream = torch.cuda.current_stream(labels.device).cuda_stream
    if iterations <= 0:
        native.check(
            lib.khr_propagate_round(labels.data_ptr(), grow.data_ptr(), out.data_ptr(), X, Y, Z, 0, 0, stream),
            "khr_propagate_round",
        )
        launches += 1
        return out
    tmp = torch.empty_like(labels)
    src = labels
    for k in range(iterations):
        dst = out if (iterations - 1 - k) % 2 == 0 else tmp
        native.check(
            lib.khr_propagate_round(
                src.data_ptr(), grow.data_ptr(), dst.data_ptr(), X, Y, Z, 1, int(k == 0), stream
            ),
            "khr_propagate_round",
        )
        launches += 1
        src = dst
    return out
