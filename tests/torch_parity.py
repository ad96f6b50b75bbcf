"""Shared inputs for the port's parity tests (tests/test_torch_*.py).

Frames come from the JAX package's synthetic office renderer and are handed
to both packages as the same numpy arrays; cameras, label spaces, tracks,
objects, active-window outputs and factor graphs are rebuilt field by field
in the port's own types.
"""

import copy
import dataclasses
import functools

import numpy as np
import torch

from khronos_tpu.data import synthetic as jsyn
from khronos_tpu_torch.active_window.active_window import ActiveWindowOutput as TOutput
from khronos_tpu_torch.active_window.object_detection import LabelSpace as TLabelSpace
from khronos_tpu_torch.active_window.tracking import Observation as TObservation
from khronos_tpu_torch.active_window.tracking import Track as TTrack
from khronos_tpu_torch.backend.backend import MergeProposal as TMerge
from khronos_tpu_torch.backend.factor_graph import FactorGraphData as TGraph
from khronos_tpu_torch.geometry.camera import Camera as TCamera
from khronos_tpu_torch.stm.scene_graph import AgentNode as TAgent
from khronos_tpu_torch.stm.scene_graph import KhronosObject as TObject
from khronos_tpu_torch.stm.scene_graph import Mesh as TMesh
from khronos_tpu_torch.stm.scene_graph import SceneGraph as TSceneGraph
from khronos_tpu_torch.stm.places import PlaceNode as TPlaceNode
from khronos_tpu_torch.stm.places import PlacesLayer as TPlacesLayer

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
    side is infinite, else within float_atol (the port follows XLA CPU's
    rounding of the projection and the update, tests/test_torch_contraction.py
    holds it bit for bit; the tolerance covers paths that round otherwise)."""
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


# ----------------------------------------------------------------------------
# Host state across packages: the JAX package's objects rebuilt field by
# field in the port's own types (both backends consume host numpy data)
# ----------------------------------------------------------------------------


def _copy_fields(src, cls, **override):
    kw = {f.name: getattr(src, f.name) for f in dataclasses.fields(cls) if f.init}
    kw.update(override)
    return cls(**kw)


def torch_track(track) -> TTrack:
    """khronos_tpu Track (with its Observations) -> the port's Track."""
    obs = [_copy_fields(o, TObservation) for o in track.observations]
    return _copy_fields(track, TTrack, observations=obs, last_voxels=set(track.last_voxels),
                        category_votes=dict(track.category_votes))


def torch_object(obj) -> TObject:
    """khronos_tpu KhronosObject -> the port's KhronosObject (arrays copied)."""
    return _copy_fields(copy.deepcopy(obj), TObject)


def torch_output(out) -> TOutput:
    """khronos_tpu ActiveWindowOutput -> the port's, objects and pending
    tracks converted too."""
    pending = None if out.pending_tracks is None else [torch_track(t) for t in out.pending_tracks]
    return _copy_fields(out, TOutput, objects=[torch_object(o) for o in out.objects], pending_tracks=pending)


def torch_graph(graph) -> TGraph:
    """khronos_tpu FactorGraphData -> the port's (lists copied)."""
    return TGraph(**{f.name: list(getattr(graph, f.name)) for f in dataclasses.fields(TGraph)})


def torch_places(layer) -> TPlacesLayer:
    """khronos_tpu PlacesLayer (or None) -> the port's, arrays copied."""
    if layer is None:
        return None
    return TPlacesLayer(
        nodes=[TPlaceNode(n.place_id, np.array(n.position), n.distance, n.room_id) for n in layer.nodes],
        edges=list(layer.edges),
    )


def torch_scene_graph(dsg) -> TSceneGraph:
    """khronos_tpu SceneGraph -> the port's, arrays copied, the places layer
    converted, the backend's opt_epoch attribute carried over."""
    out = TSceneGraph(
        mesh=TMesh(**{f.name: np.array(getattr(dsg.mesh, f.name)) for f in dataclasses.fields(TMesh)}),
        objects={k: torch_object(o) for k, o in dsg.objects.items()},
        agents=[TAgent(a.stamp_ns, np.array(a.R_w_b), np.array(a.t_w_b), a.key) for a in dsg.agents],
        places=torch_places(dsg.places),
    )
    if hasattr(dsg, "opt_epoch"):
        out.opt_epoch = dsg.opt_epoch
    return out


def torch_merge(m) -> TMerge:
    return _copy_fields(m, TMerge)


def torch_cd_request(req):
    """A reference pipeline's change-detection request (dsg, stamp_ns,
    had_loop_closure, merges) in the port's types."""
    dsg, stamp, had_lc, merges = req
    return torch_scene_graph(dsg), stamp, had_lc, [torch_merge(m) for m in merges]
