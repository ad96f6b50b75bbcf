"""The run's look for JAX compares whole top-level module names."""

import subprocess
import sys

from harness.manifest import forbidden_modules
from run import HERE


def test_top_level_names_are_compared_whole():
    assert forbidden_modules(["khronos_tpu_torch", "khronos_tpu_torch.ops.gather", "jaxtyping", "flaxen"]) == []
    assert forbidden_modules(["jax.numpy", "jaxlib", "flax.linen", "khronos_tpu", "khronos_tpu.ops"]) == [
        "flax.linen", "jax.numpy", "jaxlib", "khronos_tpu", "khronos_tpu.ops"]


def test_the_harness_and_the_program_it_drives_load_no_jax():
    code = (
        "import sys; sys.path[:0] = [%r, %r];"
        "from harness import runner, check, reference, worker, manifest, roofline, scene;"
        "[manifest.driver(p) for p in sorted((manifest.HERE / 'drivers').glob('*.py'))];"
        "from khronos_tpu_torch.active_window.active_window import ActiveWindow;"
        "from khronos_tpu_torch.ops import gather, propagate;"
        "print(worker.forbidden_modules(sys.modules))"
    ) % (str(HERE), str(HERE.parent))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_the_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path[:0] = [%r]; from harness import reference, check, scene;"
            "print(sorted(m for m in sys.modules if m.split('.')[0].startswith('khronos')))") % str(HERE)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_the_parent_loads_its_drivers_without_torch():
    """A run's parent process loads each cell's driver for its count of
    captures and its check's numbers; torch, which costs seconds of set-up,
    loads only in the workers."""
    code = ("import sys; sys.path[:0] = [%r]; from harness import manifest, runner;"
            "b = manifest.load(); [manifest.driver(manifest.driver_path(manifest.config(b, c['name'])))"
            " for c in b['configs']]; print('torch' in sys.modules)") % str(HERE)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"
