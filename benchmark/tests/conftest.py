"""The benchmark's own tests: `python -m pytest benchmark/tests` from the
repository root. Tests marked `card` need a CUDA device and skip without
one; `python -m pytest benchmark/tests -m card` on a machine with a card
runs them."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device; skips without one")
