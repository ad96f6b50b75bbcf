"""The benchmark's own tests: run with `python -m pytest benchmark/tests`
from the root of the repository. CPU tests run the harness at tiny sizes;
tests marked `gpu` need a CUDA device and skip without one."""

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
for p in (str(BENCH), str(BENCH.parent)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA device; skips without one")
