"""The benchmark's CPU tests: run with ``python -m pytest benchmark/tests``
from the root of the repository.  Torch keeps to a few threads."""

import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture(autouse=True)
def _few_threads():
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(min(4, before))
    yield
    torch.set_num_threads(before)
