"""Live checkpoint / resume of a running pipeline.

Port of `khronos_tpu/pipeline/checkpoint.py`. The reference system has no
crash recovery (a crash loses the in-memory state); this module serializes
the FULL mutable pipeline state (the voxel volume, tracks, the frame buffer,
the factor and deformation graphs, the accumulated mesh, change evidence,
the 4D map's snapshots) so a run can resume mid-sequence and produce the
same outputs as an uninterrupted run (tests/test_torch_checkpoint.py).

Format: a single gzip pickle, version-tagged, written to a temporary file
and moved into place with `os.replace`, so a crash mid-write never corrupts
the last good checkpoint. Every `torch.Tensor` is spilled to numpy with a
note of whether it lived on the accelerator (torch's own tensor reduction
records `cuda:0` and cannot load on a host without a card); on load such
tensors, and the `torch.device` objects of the components, go to the device
the caller restores onto, and CPU tensors stay on the CPU. Built programs,
ctypes handles, locks and host copies in flight are never pickled: each
component rebuilds or resolves them in its `__getstate__` / `__setstate__`.
"""

from __future__ import annotations

import gzip
import os
import pickle
import threading

import numpy as np
import torch

CHECKPOINT_VERSION = 1
_FILE = "pipeline.ckpt"

_target = threading.local()  # the device a load() puts accelerator state on


def _tensor(array: np.ndarray, on_accelerator: bool) -> torch.Tensor:
    t = torch.from_numpy(array)
    return t.to(_target.device) if on_accelerator else t


def _device(on_accelerator: bool) -> torch.device:
    return _target.device if on_accelerator else torch.device("cpu")


class _HostPickler(pickle.Pickler):
    """Pickler that spills tensors to numpy wherever they appear, so a
    restore never needs the writer's device."""

    def reducer_override(self, obj):
        if isinstance(obj, torch.Tensor):
            return _tensor, (obj.detach().cpu().numpy(), obj.device.type != "cpu")
        if isinstance(obj, torch.device):
            return _device, (obj.type != "cpu",)
        return NotImplemented


def save(pipeline, directory: str) -> str:
    """Write a resumable checkpoint of the full pipeline state."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, _FILE)
    payload = {
        "version": CHECKPOINT_VERSION,
        "device_type": pipeline.device.type,
        "pipeline": pipeline,
    }
    tmp = path + ".tmp"
    with gzip.open(tmp, "wb", compresslevel=1) as fh:
        _HostPickler(fh, protocol=pickle.HIGHEST_PROTOCOL).dump(payload)
    os.replace(tmp, path)
    return path


def load(directory: str, device: torch.device):
    """Restore a pipeline checkpoint written by save(), its accelerator state
    on `device`. A checkpoint written on the CPU restores on the CPU only:
    its tensors do not say which belong on an accelerator."""
    path = os.path.join(directory, _FILE)
    with gzip.open(path, "rb") as fh:
        head = pickle.Unpickler(fh)
        _target.device = torch.device(device)
        try:
            payload = head.load()
        finally:
            _target.device = None
    if payload.get("version") != CHECKPOINT_VERSION:
        raise ValueError(f"checkpoint version {payload.get('version')} != {CHECKPOINT_VERSION}")
    if payload["device_type"] == "cpu" and torch.device(device).type != "cpu":
        raise ValueError("a checkpoint written on the CPU restores on the CPU only: pass device='cpu'")
    return payload["pipeline"]


def exists(directory: str) -> bool:
    return os.path.exists(os.path.join(directory, _FILE))
