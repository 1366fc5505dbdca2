"""The benchmark's own tests: on the CPU here, and those marked `card` on
an NVIDIA card only (they skip elsewhere, decided inside each test)."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card; skips without one")
