"""Tests of the port's benchmark.  CPU tests run anywhere at small sizes;
tests marked `chip` need a CUDA card and skip without one (the card is
looked for inside the test, through the `cuda` fixture).  On the card:
    python3 -m pytest portbench/tests -q -m chip
"""
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "chip: needs a CUDA card; skips without one")


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.fixture
def cpu_call():
    """CallConfig fields that keep CPU runs short (the engine pads every
    batch to site_batch)."""
    return {"site_batch": 256}


@pytest.fixture
def shrink():
    """A traffic dict cut to a small pool of its own kind."""
    def f(traffic: dict, n_reads: int = 4, **kw) -> dict:
        t = dict(traffic)
        t.update(n_reads=n_reads, length={"median": 1500, "sigma": 0.3,
                                          "min": 1000, "max": 3000})
        t.update(kw)
        return t
    return f
