"""Tests of the port's benchmark (``python -m pytest benchmark/tests -q``).

Most run on the CPU at tiny sizes, with the port's plain kernel versions.
Tests marked ``card`` need a CUDA device: they decide in the ``card``
fixture, when they run, and skip here.
"""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device; skips without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _threads(tmp_path, monkeypatch):
    """Two torch threads and a temporary directory of the test's own."""
    import torch
    torch.set_num_threads(2)
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))


@pytest.fixture(scope="session")
def data_root(tmp_path_factory):
    return tmp_path_factory.mktemp("bench_data")
