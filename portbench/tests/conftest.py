"""The benchmark's own tests: `python -m pytest portbench/tests -q` from the
root of the checkout. They run on the CPU at small sizes; the `cuda` tests
need the card and skip without it."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

SMALL = {"partitions": 3, "batch_rows": 1 << 12, "batches_per_partition": 2}


@pytest.fixture
def small():
    return dict(SMALL)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
