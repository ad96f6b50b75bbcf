"""Faults planted in the program underneath a run, one a function: a worker
calls the one it is given (`runner.run(..., inject="faults:<name>")`)
before it builds its robot, and the timed path runs broken."""

import torch


def _wrap_step(fault):
    from khronos_tpu_torch.active_window import fused_step

    make = fused_step.make_frame_step

    def make_broken(*a, **kw):
        step = make(*a, **kw)

        def broken(state, *args):
            before = type(state)(*[t.clone() if torch.is_tensor(t) else t for t in state])
            return fault(before, step(state, *args))

        return broken

    fused_step.make_frame_step = make_broken


def state_unchanged():
    """The step returns the volume it was given."""
    _wrap_step(lambda before, out: (before,) + tuple(out[1:]))


def ids_altered():
    """Every object id is off by one where the step makes the id image."""
    _wrap_step(lambda before, out: (out[0], out[1], torch.where(out[2] > 0, out[2] + 1, out[2]), out[3]))


def stats_altered():
    """The statistics handed to the tracker are shifted by 5 cm."""
    _wrap_step(lambda before, out: tuple(out[:3]) + (out[3] + 0.05,))


def half_frame():
    """The right half of each image never reaches the map."""
    from khronos_tpu_torch.map import active_volume as av

    integrate = av.integrate_frame

    def half(config, camera, state, depth, *a, **kw):
        depth = depth.clone()
        depth[:, depth.shape[1] // 2:] = 0.0
        return integrate(config, camera, state, depth, *a, **kw)

    av.integrate_frame = half


def mesh_shifted():
    """Every emitted vertex lies one quantum off along x."""
    from khronos_tpu_torch.map import meshing

    extract = meshing.extract_mesh_async

    def shifted(*a, **kw):
        state, packed, meta = extract(*a, **kw)
        return state, torch.where(packed != 0, packed + 1, packed), meta

    meshing.extract_mesh_async = shifted


def scroll_reversed():
    """A recentring moves the grid's origin one way and its voxels the other."""
    from khronos_tpu_torch.map import active_volume as av

    scroll = av.scroll

    def reversed_(config, state, shift):
        out = scroll(config, state, shift)
        return scroll(config, state, -shift)._replace(origin=out.origin)

    av.scroll = reversed_
