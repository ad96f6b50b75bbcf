"""khronos_tpu_torch — the khronos_tpu SLAM engine on PyTorch and CUDA (NVIDIA Hopper).

A port of the JAX package `khronos_tpu`, module for module: each module here
has the name and path of its JAX counterpart, and is tested against it on the
same inputs. The JAX package is the reference; this package imports neither
`jax` nor anything of `khronos_tpu`.

Device rule: entry points take `device=None` and then run on CUDA. Without a
visible GPU they raise; the CPU is used only when the caller passes
`device="cpu"` (the tests do). Every hand-written kernel (`csrc/`) has a plain
PyTorch version beside it, which serves CPU tensors only.

TF32 stays off for matmul and cuDNN: contractions here feed decisions (voxel
indices, cluster statistics) and must be full float32, as in the reference.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless `device` says otherwise.

    Raises when CUDA is asked for (explicitly or by default) and no GPU is
    visible; there is no silent fallback to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "khronos_tpu_torch runs on CUDA by default and no GPU is visible; "
            "pass device='cpu' to run on the CPU"
        )
    return dev


def true_div(x: torch.Tensor, divisor: float) -> torch.Tensor:
    """x / divisor, correctly rounded in x's dtype.

    On CUDA, dividing by a Python scalar multiplies by its reciprocal, which
    can differ from the division by one ulp and flip a floor() or a compare;
    a 0-dim tensor on x's device keeps the true division the reference does."""
    return x / torch.full((), divisor, dtype=x.dtype, device=x.device)


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c of float32 tensors with one rounding, as a fused multiply-add.

    The reference's CPU build (XLA through LLVM) contracts such sums into
    fused multiply-adds where a decision follows (ray marching, the ray
    query's norms and dot products, nearest distances), and the tests hold
    the port to it bit for bit. A float32 product is exact in float64, so one
    float64 add and the cast give the fused result (a double rounding can
    differ from it, about once in 2^28 sums). The card and the CPU compute
    the same bits."""
    return (a.double() * b.double() + c.double()).float()


def sqrt32(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root of a float32 tensor.

    PyTorch's CPU sqrt of a large float32 tensor may be one ulp off the
    correctly rounded root (a vector math library's), where the reference
    and CUDA's sqrtf round correctly; the root in float64, rounded once to
    float32, is the correctly rounded one (53 >= 2 * 24 + 2 bits)."""
    return torch.sqrt(x.double()).float()


def u32_bits(words: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 with the same 32 bits.

    PyTorch has only partial uint32 support, so uint32 words of the reference
    are built in int64 and stored as int32 bit patterns (`.view` to read them
    back as float32, or `numpy().view(np.uint32)` on the host)."""
    words = words & 0xFFFFFFFF
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)
