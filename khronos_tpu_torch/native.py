"""ctypes bindings of the repository's native C++ runtime pieces (`native/`).

Port of `khronos_tpu/native.py`: the mesh accumulator (`native/mesh_accum.cpp`)
and the pipeline stage executor (`native/executor.cpp`: stage threads and
bounded queues). Each source is compiled with the host C++ compiler at first
use into `build/khronos_tpu_torch/` (listed in .gitignore): one shared library
per source, keyed by a hash of the source and the flags, renamed into place
only when complete, as `ops/native.py` builds the CUDA kernels. Nothing is
written into `native/`.

There is no fallback: when a build or a load fails, it raises. The plain
versions, which the tests hold the native ones against, are
`stm.scene_graph.MeshAccumulator` and `PyPipelineExecutor`; a caller may name
the latter explicitly.
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
EXECUTOR_SOURCE = Path(__file__).resolve().parents[1] / "native" / "executor.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "khronos_tpu_torch"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
EXECUTOR_LIBS = ("-lpthread",)
# void (*)(int64 item, void* user): ctypes re-acquires the GIL for every
# call, so Python stage bodies run safely on the C++ worker threads
STAGE_CB = ctypes.CFUNCTYPE(None, ctypes.c_int64, ctypes.c_void_p)

_lock = threading.Lock()
_lib = None
_exec_lib = None


def _cxx() -> str:
    for cand in (os.environ.get("CXX"), shutil.which("g++"), shutil.which("c++")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("no C++ compiler found: the native runtime needs g++")


def _library_path(source: Path = None, libs=(), stem: str = "libkhronos_mesh_accum") -> Path:
    source = SOURCE if source is None else source
    h = hashlib.sha256(" ".join(CXX_FLAGS + tuple(libs)).encode())
    h.update(source.read_bytes())
    return BUILD_DIR / f"{stem}_{h.hexdigest()[:16]}.so"


def _build(source: Path, target: Path, libs=()) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        so_tmp = Path(tmp) / target.name
        res = subprocess.run([_cxx(), *CXX_FLAGS, "-o", str(so_tmp), str(source), *libs],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"building {source.name} failed:\n{res.stdout}")
        os.replace(so_tmp, target)


def load_library():
    """The loaded accumulator library, built from `native/mesh_accum.cpp` on first use."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        target = _library_path()
        if not target.exists():
            _build(SOURCE, target)
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


def load_executor_library():
    """The loaded stage-executor library, built from `native/executor.cpp`
    (with -lpthread) on first use."""
    global _exec_lib
    with _lock:
        if _exec_lib is not None:
            return _exec_lib
        target = _library_path(EXECUTOR_SOURCE, EXECUTOR_LIBS, "libkhronos_executor")
        if not target.exists():
            _build(EXECUTOR_SOURCE, target, EXECUTOR_LIBS)
        lib = ctypes.CDLL(str(target))
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        for name, res, args in (
            ("exec_create", P, [I, L]),
            ("exec_set_stage", None, [P, I, STAGE_CB, P, I]),
            ("exec_start", None, [P]),
            ("exec_push", I, [P, I, L, I]),
            ("exec_drain", None, [P]),
            ("exec_stop", None, [P]),
            ("exec_destroy", None, [P]),
            ("exec_processed", L, [P, I]),
        ):
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = res, args
        _exec_lib = lib
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

    def __getstate__(self):
        """Checkpoint support: the accumulated mesh; the native table is
        rebuilt on restore."""
        return {"resolution": self.resolution, "mesh": self.build()}

    def __setstate__(self, state):
        """Rebuild the table exactly: one degenerate triangle per vertex, in
        index order, inserts every vertex under its own index and adds no
        face; then the faces, whose corners carry their vertices' own
        stamps, so no stamp moves."""
        self.__init__(state["resolution"])
        mesh = state["mesh"]
        for idx in (np.repeat(np.arange(mesh.num_vertices)[:, None], 3, axis=1), mesh.faces):
            self.add_triangles(mesh.vertices[idx], mesh.colors[idx], mesh.first_seen_ns[idx],
                               mesh.last_seen_ns[idx], mesh.labels[idx])

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


class NativePipelineExecutor:
    """Stage threads and bounded queues on the C++ runtime (`native/executor.cpp`).

    The equivalent of the reference's module spin threads with bounded
    queues and its detached change-detection thread (backend.cpp:189-216).
    Each stage function runs on its own native worker thread(s) and may push
    work to any stage from inside its callback. Exceptions raised by a stage
    are caught and raised again from drain() or stop()."""

    def __init__(self, stage_fns, capacity: int = 8, workers=None):
        self._lib = load_executor_library()
        self._errors = []
        self._err_lock = threading.Lock()
        self._h = self._lib.exec_create(len(stage_fns), capacity)
        self._cbs = []  # the CFUNCTYPE objects live as long as the executor
        workers = workers or [1] * len(stage_fns)
        for i, fn in enumerate(stage_fns):
            cb = STAGE_CB(self._wrap(fn))
            self._cbs.append(cb)
            self._lib.exec_set_stage(self._h, i, cb, None, int(workers[i]))
        self._lib.exec_start(self._h)

    def _wrap(self, fn):
        def call(item, _user):
            try:
                fn(int(item))
            except BaseException as e:  # never let it unwind into C++
                with self._err_lock:
                    self._errors.append(e)

        return call

    def push(self, stage: int, item: int, block: bool = True) -> bool:
        return bool(self._lib.exec_push(self._h, stage, int(item), 1 if block else 0))

    def drain(self) -> None:
        self._lib.exec_drain(self._h)
        self._raise_pending()

    def stop(self) -> None:
        if self._h:
            self._lib.exec_stop(self._h)
        self._raise_pending()

    def _raise_pending(self) -> None:
        with self._err_lock:
            if self._errors:
                e = self._errors[0]
                self._errors.clear()
                raise e

    def processed(self, stage: int) -> int:
        return int(self._lib.exec_processed(self._h, stage))

    def close(self) -> None:
        h, self._h = getattr(self, "_h", None), None
        if h:
            self._lib.exec_destroy(h)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
        self.close()

    def __del__(self):
        self.close()


class PyPipelineExecutor:
    """The plain version of NativePipelineExecutor: the same semantics on
    Python threads and queues. An item counts as pending from its push until
    its stage function returns, so drain() cannot return while a worker holds
    an item it has taken from its queue (the reference's plain executor
    counted an item only once its worker had marked it, and could return
    early; tests/test_torch_runtime.py's stress test holds this)."""

    def __init__(self, stage_fns, capacity: int = 8, workers=None):
        import queue

        self._fns = stage_fns
        self._queues = [queue.Queue(maxsize=capacity) for _ in stage_fns]
        self._pending = [0] * len(stage_fns)
        self._processed = [0] * len(stage_fns)
        self._lock = threading.Lock()
        self._idle = threading.Condition(self._lock)
        self._stop = False
        self._errors = []
        self._threads = []
        workers = workers or [1] * len(stage_fns)
        for i in range(len(stage_fns)):
            for _ in range(int(workers[i])):
                t = threading.Thread(target=self._worker, args=(i,), daemon=True)
                t.start()
                self._threads.append(t)

    def _worker(self, si: int) -> None:
        import queue

        q = self._queues[si]
        while True:
            try:
                item = q.get(timeout=0.05)
            except queue.Empty:
                if self._stop:
                    return
                continue
            try:
                self._fns[si](item)
            except BaseException as e:
                with self._lock:
                    self._errors.append(e)
            with self._lock:
                self._pending[si] -= 1
                self._processed[si] += 1
                self._idle.notify_all()

    def push(self, stage: int, item: int, block: bool = True) -> bool:
        import queue

        with self._lock:
            self._pending[stage] += 1
        try:
            self._queues[stage].put(int(item), block=block)
            return True
        except queue.Full:
            with self._lock:
                self._pending[stage] -= 1
                self._idle.notify_all()
            return False

    def drain(self) -> None:
        with self._idle:
            while any(n > 0 for n in self._pending):
                self._idle.wait(timeout=0.05)
            if self._errors:
                e = self._errors[0]
                self._errors.clear()
                raise e

    def stop(self) -> None:
        self.drain()
        self._stop = True
        for t in self._threads:
            t.join(timeout=2.0)

    def processed(self, stage: int) -> int:
        return self._processed[stage]

    def close(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()


def make_pipeline_executor(stage_fns, capacity: int = 8, workers=None) -> NativePipelineExecutor:
    """The native stage executor (raises when it cannot be built)."""
    return NativePipelineExecutor(stage_fns, capacity=capacity, workers=workers)
