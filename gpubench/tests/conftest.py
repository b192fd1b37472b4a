"""The benchmark's own tests: ``python -m pytest gpubench/tests -q`` from
the root of the checkout. Tests marked ``card`` need the CUDA card and skip
without one (decided inside each test)."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs the CUDA card; skips without one")
