"""Shared inputs for the port's parity tests (tests/test_torch_*.py).

Frames come from the JAX package's synthetic office renderer and are handed
to both packages as the same numpy arrays; cameras and label spaces are
rebuilt field by field in the port's own types.
"""

import functools

import numpy as np
import torch

from khronos_tpu.data import synthetic as jsyn
from khronos_tpu_torch.active_window.object_detection import LabelSpace as TLabelSpace
from khronos_tpu_torch.geometry.camera import Camera as TCamera

H, W = 48, 64  # small frames: every test stays well inside the CPU budget

# The suite runs in several worker processes, and every worker imports this
# module while collecting. PyTorch's default of one intra-op thread per core
# in each of them oversubscribes the cores: with six workers on eight cores
# the whole suite took 669 s instead of 193 s. The tensors here are small, so
# one thread each loses little.
torch.set_num_threads(1)


def sequence(n_frames: int, height: int = H, width: int = W):
    duration = n_frames / 10.0 + 1.0
    return jsyn.SyntheticSequence(
        jsyn.office_scene(duration=duration),
        jsyn.SyntheticSequenceConfig(
            duration=duration, fps=10.0, height=height, width=width,
            fx=width * 0.625, fy=width * 0.625, cx=width / 2, cy=height / 2,
        ),
    )


@functools.lru_cache(maxsize=None)
def frames(n_frames: int):
    """(camera, [frame dicts of numpy arrays]) rendered by the JAX package."""
    seq = sequence(n_frames)
    out = []
    for i in range(n_frames):
        f = seq.render_frame(i)
        # writable copies: torch.from_numpy warns on a JAX array's read-only buffer
        out.append({k: (np.array(v) if hasattr(v, "shape") else v) for k, v in f.items()})
    return seq.camera, out


def torch_camera(cam) -> TCamera:
    return TCamera(cam.height, cam.width, cam.fx, cam.fy, cam.cx, cam.cy, cam.min_range, cam.max_range)


def torch_label_space(ls) -> TLabelSpace:
    return TLabelSpace(ls.num_classes, tuple(ls.object_labels), tuple(ls.dynamic_labels))


def assert_states_match(jax_state, torch_state, float_atol: float = 1e-5):
    """Integer and bool fields bit for bit; float fields equal where either
    side is infinite, else within float_atol (the reference's einsum
    projection rounds differently from the port's elementwise one, by at
    most a few ulp of the signed distance)."""
    from khronos_tpu_torch.map.active_volume import state_to_numpy

    got = state_to_numpy(torch_state)
    for name, a, b in zip(got._fields, jax_state, got):
        a = np.asarray(a)
        assert a.shape == b.shape and a.dtype == b.dtype, name
        if a.dtype.kind == "f":
            np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b), err_msg=name)
            fin = np.isfinite(a)
            np.testing.assert_array_equal(a[~fin], b[~fin], err_msg=name)
            np.testing.assert_allclose(a[fin], b[fin], rtol=0, atol=float_atol, err_msg=name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)
