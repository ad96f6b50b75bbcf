"""Build and load the hand-written CUDA kernels of `khronos_tpu_torch/csrc/`.

The sources have a plain C interface and are compiled with `nvcc` for Hopper
(`sm_90a`) into ONE shared library, loaded with ctypes (no PyTorch headers,
so a build takes seconds). The build runs at first use, from the sources in
this checkout only: each source compiles in its own `nvcc` process, all
started together, then one link step. The library lands in
`build/khronos_tpu_torch/` at the repository root (listed in .gitignore),
keyed by a hash of the sources and flags, and is renamed into place only when
complete, so processes building it at the same time never load a
half-written file.

Every C entry point takes device pointers, sizes and a `cudaStream_t` (all
passed as c_void_p / c_longlong / c_int), launches on that stream, allocates
nothing, does not synchronise, and returns `cudaGetLastError()`. It launches
on the CURRENT device (and reads it, `cudaGetDevice`, for its occupancy
queries), so a wrapper calls it inside `on_device(t.device)`: a mesh may put
a slab on any card.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("propagate.cu", "gather.cu")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "khronos_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C entry points: name -> argtypes (restype is always int = cudaError_t)
SIGNATURES = {
    "khr_propagate": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "khr_propagate_round": (_P, _P, _P, _I, _I, _I, _I, _I, _P),
    "khr_gather_rows": (_P, _P, _P, _L, _I, _L, _P),
}

_lock = threading.Lock()  # stage threads may make the first kernel call at once
_lib = None
build_info: dict = {}  # seconds, library path and ptxas report of this process's load


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), "/usr/local/cuda/bin/nvcc", shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of khronos_tpu_torch need the CUDA toolkit")


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libkhronos_kernels_{h.hexdigest()[:16]}.so"


def _compile(target: Path) -> str:
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for name in SOURCES:
            obj = Path(tmp) / (name + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)]
            procs.append((name, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        report = []
        for name, _, p in procs:
            out, _ = p.communicate()
            report.append(f"== {name}\n{out}")
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {name}:\n{out}")
        so_tmp = Path(tmp) / target.name
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
               "-o", str(so_tmp), *(str(obj) for _, obj, _ in procs)]
        link = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(so_tmp, target)
    return "\n".join(report)


def load_library():
    """The loaded kernel library, built from `csrc/` on first use."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        t0 = time.perf_counter()
        target = _library_path()
        report = "(cached build)"
        if not target.exists():
            report = _compile(target)
        lib = ctypes.CDLL(str(target))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        build_info.update(seconds=time.perf_counter() - t0, path=str(target), ptxas=report)
        _lib = lib
        return lib


def check(err: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")


@contextlib.contextmanager
def on_device(device: torch.device):
    """Make `device` current for a C entry point's launch and give the handle
    of its current stream; the previous current device comes back after."""
    with torch.cuda.device(device):
        yield torch.cuda.current_stream(device).cuda_stream
