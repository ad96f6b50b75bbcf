"""ctypes binding of the native mesh accumulator (`native/mesh_accum.cpp`).

Port of the mesh-accumulator part of `khronos_tpu/native.py`. The source is
the repository's own `native/mesh_accum.cpp`, compiled with the host C++
compiler at first use into `build/khronos_tpu_torch/` (listed in
.gitignore): one shared library keyed by a hash of the source and the flags,
renamed into place only when complete, as `ops/native.py` builds the CUDA
kernels. Nothing is written into `native/`.

There is no fallback: when the build or the load fails, it raises. The plain
version, which the tests hold the native one against, is
`stm.scene_graph.MeshAccumulator`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

from khronos_tpu_torch.stm.scene_graph import Mesh

SOURCE = Path(__file__).resolve().parents[1] / "native" / "mesh_accum.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "khronos_tpu_torch"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None


def _cxx() -> str:
    for cand in (os.environ.get("CXX"), shutil.which("g++"), shutil.which("c++")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("no C++ compiler found: the native mesh accumulator needs g++")


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libkhronos_mesh_accum_{h.hexdigest()[:16]}.so"


def _build(target: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        so_tmp = Path(tmp) / target.name
        res = subprocess.run([_cxx(), *CXX_FLAGS, "-o", str(so_tmp), str(SOURCE)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"building {SOURCE.name} failed:\n{res.stdout}")
        os.replace(so_tmp, target)


def load_library():
    """The loaded accumulator library, built from `native/mesh_accum.cpp` on first use."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        target = _library_path()
        if not target.exists():
            _build(target)
        lib = ctypes.CDLL(str(target))
        p_f32, p_i32, p_i64 = (ctypes.POINTER(t) for t in (ctypes.c_float, ctypes.c_int32, ctypes.c_int64))
        lib.mesh_accum_create.restype = ctypes.c_void_p
        lib.mesh_accum_create.argtypes = [ctypes.c_double]
        lib.mesh_accum_destroy.restype = None
        lib.mesh_accum_destroy.argtypes = [ctypes.c_void_p]
        lib.mesh_accum_add.restype = ctypes.c_int64
        lib.mesh_accum_add.argtypes = [ctypes.c_void_p, p_f32, p_f32, p_i64, p_i64, p_i32, ctypes.c_int64]
        lib.mesh_accum_num_vertices.restype = ctypes.c_int64
        lib.mesh_accum_num_vertices.argtypes = [ctypes.c_void_p]
        lib.mesh_accum_num_faces.restype = ctypes.c_int64
        lib.mesh_accum_num_faces.argtypes = [ctypes.c_void_p]
        lib.mesh_accum_get.restype = None
        lib.mesh_accum_get.argtypes = [ctypes.c_void_p, p_f32, p_f32, p_i32, p_i64, p_i64, p_i64]
        _lib = lib
        return lib


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


class NativeMeshAccumulator:
    """Native counterpart of stm.scene_graph.MeshAccumulator: quantized
    vertex dedup with first/last-seen stamp merging, results bit for bit the
    same."""

    def __init__(self, resolution: float = 0.005):
        self._lib = load_library()
        self.resolution = resolution
        self._h = self._lib.mesh_accum_create(ctypes.c_double(resolution))

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h:
            self._lib.mesh_accum_destroy(h)

    def add_triangles(self, tri_vertices, tri_colors, tri_first_ns, tri_last_ns, tri_labels) -> int:
        T = len(tri_vertices)
        if T == 0:
            return 0
        v = np.ascontiguousarray(tri_vertices, np.float32)
        c = np.ascontiguousarray(tri_colors, np.float32)
        f = np.ascontiguousarray(tri_first_ns, np.int64)
        l = np.ascontiguousarray(tri_last_ns, np.int64)
        lab = np.ascontiguousarray(tri_labels, np.int32)
        if v.shape != (T, 3, 3) or c.shape != (T, 3, 3) or any(a.shape != (T, 3) for a in (f, l, lab)):
            raise ValueError("add_triangles: expected [T, 3, 3] vertices and colors, [T, 3] stamps and labels")
        return int(self._lib.mesh_accum_add(
            self._h, _ptr(v, ctypes.c_float), _ptr(c, ctypes.c_float), _ptr(f, ctypes.c_int64),
            _ptr(l, ctypes.c_int64), _ptr(lab, ctypes.c_int32), ctypes.c_int64(T),
        ))

    def build(self) -> Mesh:
        V = int(self._lib.mesh_accum_num_vertices(self._h))
        F = int(self._lib.mesh_accum_num_faces(self._h))
        verts = np.zeros((V, 3), np.float32)
        colors = np.zeros((V, 3), np.float32)
        labels = np.zeros((V,), np.int32)
        first = np.zeros((V,), np.int64)
        last = np.zeros((V,), np.int64)
        faces = np.zeros((F, 3), np.int64)
        if V:
            self._lib.mesh_accum_get(
                self._h, _ptr(verts, ctypes.c_float), _ptr(colors, ctypes.c_float),
                _ptr(labels, ctypes.c_int32), _ptr(first, ctypes.c_int64),
                _ptr(last, ctypes.c_int64), _ptr(faces, ctypes.c_int64),
            )
        return Mesh(vertices=verts, colors=colors, labels=labels,
                    first_seen_ns=first, last_seen_ns=last, faces=faces)


def make_mesh_accumulator(resolution: float = 0.005) -> NativeMeshAccumulator:
    """The native accumulator (raises when it cannot be built)."""
    return NativeMeshAccumulator(resolution)
