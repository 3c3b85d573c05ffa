"""The benchmark's own tests: ``python -m pytest perfbench/tests`` from the
root of the repository. Tests that need a CUDA card carry the ``card``
marker and skip inside themselves where there is none."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device; skips inside where there is none")
