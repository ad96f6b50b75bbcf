"""The port's async stage mode against the reference's inline run
(tests/test_runtime.py's sequence, tests/test_torch_runtime.py's helpers).

`ExperimentManager.run(async_stages=True)` in the port and the reference's
inline run on the same frames (rendered by the reference; the reference in
its earliest host-pull schedule, which the port's CPU path follows), with
tests/test_runtime.py's bars: the same frame count, snapshot count, object
ids and agent count; the final meshes' sorted vertices all within 1.5
quantisation steps of the mesh packing and at most 1e-3 of them beyond
1e-5 m (the meshing's known rounding across the packages,
tests/test_torch_slice.py)."""

import jax
import numpy as np
import pytest

from khronos_tpu.active_window import active_window as jaw_mod
from khronos_tpu.active_window.frame_data import FrameData as JFrame
from khronos_tpu.config import build as jbuild
from khronos_tpu.map import meshing as jmeshing
from khronos_tpu.pipeline.pipeline import ExperimentConfig as JExperimentConfig
from khronos_tpu.pipeline.pipeline import ExperimentManager as JManager
from khronos_tpu.pipeline.pipeline import KhronosPipeline as JPipeline
from khronos_tpu.pipeline.pipeline import PipelineConfig as JPipelineConfig

from test_torch_runtime import SMALL, _feed, _port_run, small_frames  # noqa: F401  (a fixture)


@pytest.fixture(scope="module")
def runs(small_frames, tmp_path_factory):  # noqa: F811
    cam, rendered = small_frames
    tmp = tmp_path_factory.mktemp("runs")
    port, _ = _port_run(cam, rendered, tmp, "async")
    with pytest.MonkeyPatch.context() as mp:
        # the reference in its earliest host-pull schedule (every pull has
        # landed when polled), which the port's CPU path follows
        concat, body, extract = jaw_mod._bus_concat, jmeshing.start_body_pull, jmeshing.extract_mesh_async
        mp.setattr(jaw_mod, "_bus_concat", lambda *xs: jax.block_until_ready(concat(*xs)))
        mp.setattr(jmeshing, "start_body_pull", lambda *a: jax.block_until_ready(body(*a)))
        mp.setattr(jmeshing, "extract_mesh_async", lambda *a, **k: jax.block_until_ready(extract(*a, **k)))
        jcfg = jbuild(JPipelineConfig, SMALL)
        jpipe = JPipeline(jcfg, cam)
        frames, gts = _feed(rendered, JFrame, jax.numpy.asarray)
        JManager(JExperimentConfig(output_dir=str(tmp / "reference")), jpipe, jcfg).run(frames, gts)
    return port, jpipe


def test_port_async_matches_reference_inline(runs):
    port, ref = runs
    assert port.frame_count == ref.frame_count
    assert port.map.num_snapshots == ref.map.num_snapshots
    a, b = port.map.snapshots[-1], ref.map.snapshots[-1]
    assert len(a.mesh.vertices) == len(b.mesh.vertices) > 1000
    step = max(SMALL["active_window"]["volumetric_map"]["grid_shape"]) * 0.12 / 65535.0
    err = np.abs(np.sort(np.asarray(a.mesh.vertices), axis=0) - np.sort(np.asarray(b.mesh.vertices), axis=0))
    assert err.max() <= 1.5 * step and (err > 1e-5).mean() <= 1e-3
    assert set(a.objects) == set(b.objects)
    assert len(a.agents) == len(b.agents)
    np.testing.assert_allclose(a.agent_positions(), b.agent_positions(), rtol=0, atol=1e-5)
