"""Settings of the benchmark's own tests.

Tests that need an NVIDIA card carry the ``cuda`` marker registered
here (the repository's ``tests/conftest.py`` imports JAX and does not
apply to this folder); each decides inside the test whether a card is
present.  On the card: ``python -m pytest lz4bench/tests -m cuda -q``.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skips without one")
