"""The benchmark's CPU tests run from the repository root; the port is
imported from ``src``.  ``cuda`` marks a test that needs a card."""
import sys
from pathlib import Path

_ROOT = Path(__file__).resolve().parent.parent
for _p in (str(_ROOT / "src"), str(_ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card")
