"""The benchmark's own tests: the repository root on ``sys.path`` (the
harness is the package ``benchmark``) and the ``cuda`` marker.  Tests
that need a card decide inside the test, never at import."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (the port's kernels); skipped without one")
