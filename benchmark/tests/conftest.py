"""Tests of the benchmark.  Run them from the repository's root:

    python -m pytest benchmark/tests -q

Tests marked ``card`` need a CUDA card: each asks for the ``card`` fixture,
which skips it, with the reason, where there is none.  The rest run on the
CPU at a tiny size (``data/tiny*.json``)."""

import json
import os
import types

import pytest

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skipped without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: this machine has none")
    return torch.device("cuda", 0)


def read(name: str) -> dict:
    with open(os.path.join(DATA, name + ".json")) as f:
        return json.load(f)


def _tiny_cell(traffic: str, dtype: str = "bfloat16"):
    return types.SimpleNamespace(
        name=traffic, config=dict(read("tiny"), dtype=dtype), traffic=read(traffic),
        entry={"chips": 1}, limits={"limits": read("tiny_limits")[traffic]},
        end_to_end=[{"name": "images_per_s", "unit": "images/s"},
                    {"name": "latency_p90_s", "unit": "s"}, {"name": "setup_s", "unit": "s"}],
        per_layer=[])


@pytest.fixture
def tiny_cell():
    """``tiny_cell(traffic, dtype)``: a cell of the tiny configuration
    (``data/tiny.json``) under the mix ``data/<traffic>.json``, with the
    limits of ``data/tiny_limits.json``."""
    return _tiny_cell


@pytest.fixture
def data():
    """``data(name)``: the JSON file ``data/<name>.json``."""
    return read


@pytest.fixture
def data_root():
    """The repository's root."""
    return os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
