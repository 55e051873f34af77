"""The port's chaos soak (blaze_tpu_torch/tools/chaos_soak.py) against the
JAX package's tools/chaos_soak.py, loaded by file path: the point x kind
sweep as `make check-faults` runs it (every faults.KNOWN_POINTS entry x
io, oom and stall at 300 ms, each over the three catalogue queries), at
2,000 rows on the CPU.

Each package writes its validator's core tables from the same seed, and
each cell runs through its own soak's `_run_cell` under the same fault
spec: the outcome, the error category, the ladder's rung and the faults
injected must be the JAX soak's, with no wrong answer, no orphan, no
leaked reservation and no open pipeline stream on either side.
"""

import pytest

from blaze_tpu.runtime import faults as jfaults
from blaze_tpu_torch.runtime import faults
from torch_soak import (  # noqa: F401 (cpu_soaks, tables: fixtures)
    SEED, assert_same_cell, both_cells, cpu_soaks, jsoak, soak, tables)

pytestmark = pytest.mark.usefixtures("cpu_soaks")


def test_the_soaks_sweep_the_same_points_and_queries():
    assert faults.KNOWN_POINTS == jfaults.KNOWN_POINTS
    assert len(faults.KNOWN_POINTS) == 15
    assert faults.CORRUPT_POINTS == jfaults.CORRUPT_POINTS
    assert soak.QUERIES == jsoak.QUERIES and soak.KINDS == jsoak.KINDS
    assert soak.SERVICE_POINTS == jsoak.SERVICE_POINTS
    assert soak.NET_CELLS == jsoak.NET_CELLS


@pytest.mark.parametrize("kind", ["io", "oom", "stall"])
@pytest.mark.parametrize("point", jfaults.KNOWN_POINTS)
def test_sweep_cell_matches_jax(tables, point, kind):
    rule = {"fail_times": 2, "kind": kind}
    if kind == "stall":
        rule["ms"] = 300
    spec = {"seed": SEED, "points": {point: rule}}
    for query, mode in soak.QUERIES:
        port, jax = both_cells(tables, query, mode, spec)
        assert_same_cell(port, jax)


def test_clean_catalogue_fires_nothing(tables):
    for query, mode in soak.QUERIES:
        port, jax = both_cells(tables, query, mode, None)
        assert port["outcome"] == jax["outcome"] == "no_fire"
        assert_same_cell(port, jax)
