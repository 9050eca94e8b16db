"""Settings of the benchmark's own tests: the repository root on the path,
and the marker of the tests that need the card (they skip without one)."""

import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device and nvcc; skips where there is none")
