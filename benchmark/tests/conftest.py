"""Fixtures of the benchmark's CPU tests: small versions of each cell, run
on the port's CPU route (no card), and the ``card`` marker for the one test
that needs the card (it skips inside its fixture without one)."""

from __future__ import annotations

import pytest

from benchmark import registry


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


def small(name: str) -> dict:
    """A configuration at its own widths, in a shorter capture: the stream
    cells' sizes are cut by the traffic, not here."""
    return registry.config(registry.benchmark(), name)


def small_traffic(name: str, config: str) -> dict:
    """2 captures of 2^22 samples: 16 telegrams or 2 presses each, enough
    that half of them left out crosses the cells' limits."""
    t = dict(registry.traffic(name), captures=2, warm_captures=1)
    if "capture_samples" in t:
        t["capture_samples"] = 1 << 22
    return t


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"
