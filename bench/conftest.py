import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for p in (os.path.join(ROOT, "src"), ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips without one "
        "(on the GPU machine: `pytest -m cuda bench/`)")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs beside other workers: chunk-wide torch ops on one
    thread each, as the port's heavier test modules run."""
    import torch
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
