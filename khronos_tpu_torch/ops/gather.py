"""Kernel B: row gather (port of the Pallas
`khronos_tpu/ops/pallas/gather_probe.py::make_pallas_gather`).

`gather_rows(img [HW, C] f32, idx [n] int32) -> [n, C]` computes
`out[i, :] = img[idx[i], :]` with jnp indexing's rule for bad indices (a
negative index counts from the end once, then clamps to [0, HW - 1]),
copying bits (payload words that are NaN patterns survive). A CUDA tensor goes to the hand-written kernel `csrc/gather.cu`; a
CPU tensor goes to `gather_rows_plain`. There is no fallback from one to the
other.

`launches` counts kernel launches.
"""

from __future__ import annotations

import torch

from khronos_tpu_torch.ops import native

launches = 0


def gather_rows_plain(img: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version (advanced indexing on wrapped, clamped int64 rows)."""
    rows = idx.long()
    rows = torch.where(rows < 0, rows + img.shape[0], rows).clamp(0, img.shape[0] - 1)
    return img.view(torch.int32)[rows].view(torch.float32)


def _check(img: torch.Tensor, idx: torch.Tensor) -> None:
    if img.dtype != torch.float32 or idx.dtype != torch.int32:
        raise TypeError(f"gather_rows: need float32 img and int32 idx, got {img.dtype}, {idx.dtype}")
    if img.ndim != 2 or idx.ndim != 1 or img.shape[0] == 0:
        raise ValueError(f"gather_rows: need img [HW>0, C] and idx [n], got {tuple(img.shape)}, {tuple(idx.shape)}")
    if img.device != idx.device:
        raise ValueError("gather_rows: img and idx on different devices")


def gather_rows(img: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    _check(img, idx)
    if img.device.type == "cpu":
        return gather_rows_plain(img, idx)
    if img.device.type != "cuda":
        raise ValueError(f"gather_rows: unsupported device {img.device}")
    return gather_rows_cuda(img, idx)


def gather_rows_cuda(img: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Kernel B on CUDA tensors (raises on anything else)."""
    global launches
    _check(img, idx)
    if not img.is_cuda:
        raise ValueError("gather_rows_cuda needs CUDA tensors")
    if not (img.is_contiguous() and idx.is_contiguous()):
        raise ValueError("gather_rows_cuda needs contiguous tensors")
    rows, channels = img.shape
    if channels == 2 and img.data_ptr() % 8:
        raise ValueError("gather_rows_cuda: the 8-byte row loads need an 8-byte aligned img")
    lib = native.load_library()
    out = torch.empty((idx.shape[0], channels), dtype=torch.float32, device=img.device)
    stream = torch.cuda.current_stream(img.device).cuda_stream
    native.check(
        lib.khr_gather_rows(img.data_ptr(), idx.data_ptr(), out.data_ptr(), rows, channels, idx.shape[0], stream),
        "khr_gather_rows",
    )
    launches += 1
    return out
