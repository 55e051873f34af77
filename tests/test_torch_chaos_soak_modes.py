"""The port's chaos soak against the JAX package's in three of its modes, at
2,000 rows on the CPU (see test_torch_chaos_soak.py for the default
sweep): a `--supervisor` subset (the concurrent supervised pool with hang
detection and speculation armed, stalls at the soak's 2 s past a 500 ms
watchdog), a `--pipeline` subset (the async pipeline kept live under
concurrent specs) and the `--durability` sweep (a bit flipped in a
committed shuffle .data or .index or a spill frame, and the mmap fetch
cell); test_torch_chaos_soak_rounds.py has the `--driver` round. Every
cell's outcome, error category, rung and faults injected must be the JAX
soak's.
Under a concurrent spec the rung a cell reaches depends on whether the
two failures land in one task, so there both ladders must engage and
the rung is not compared.
"""

import argparse

import pytest

from blaze_tpu.config import conf as jconf
from blaze_tpu_torch.config import conf
from torch_soak import (  # noqa: F401 (cpu_soaks, tables: fixtures)
    SEED, assert_same_cell, both_cells, cpu_soaks, jsoak, soak, tables)

SUPERVISED = ("op", "serde.encode", "shuffle.commit")
PIPELINED = ("io.prefetch", "serde.decode", "device.put")


pytestmark = pytest.mark.usefixtures("cpu_soaks")


@pytest.fixture
def supervised(monkeypatch):
    """main()'s --supervisor knobs in both packages."""
    for c in (conf, jconf):
        monkeypatch.setattr(c, "max_concurrent_tasks", 4)
        monkeypatch.setattr(c, "hang_detect_ms", 500)
        monkeypatch.setattr(c, "speculation_multiplier", 4.0)


@pytest.mark.parametrize("kind", ["io", "oom", "stall"])
@pytest.mark.parametrize("point", SUPERVISED)
def test_supervisor_cell_matches_jax(tables, supervised, point, kind):
    rule = {"fail_times": 2, "kind": kind}
    if kind == "stall":
        rule["ms"] = 2000
    spec = {"seed": SEED, "points": {point: rule}, "concurrent": True}
    for query, mode in soak.QUERIES:
        port, jax = both_cells(tables, query, mode, spec)
        assert_same_cell(port, jax, concurrent=True)
        if kind == "stall" and port["outcome"] == "recovered":
            # the watchdog killed and relaunched the stalled task rather
            # than waiting the stall out
            assert port.get("hangs_detected") == jax.get("hangs_detected")


@pytest.mark.parametrize("kind", soak.KINDS)
@pytest.mark.parametrize("point", PIPELINED)
def test_pipeline_cell_matches_jax(tables, monkeypatch, point, kind):
    for c in (conf, jconf):
        monkeypatch.setattr(c, "enable_pipeline", True)
    spec = {"seed": SEED, "concurrent": True,
            "points": {point: {"fail_times": 2, "kind": kind}}}
    for query, mode in soak.QUERIES:
        port, jax = both_cells(tables, query, mode, spec)
        assert_same_cell(port, jax, concurrent=True)


def test_durability_sweep_matches_jax(tables):
    args = argparse.Namespace(seed=SEED)
    port = soak._corruption_sweep(tables[0], args)
    jax = jsoak._corruption_sweep(tables[1], args)
    keys = ("query", "point", "outcome", "error_category", "corruption",
            "detected_ok", "faults_injected", "ladder_rung")
    assert [{k: c.get(k) for k in keys} for c in port] == \
        [{k: c.get(k) for k in keys} for c in jax]
    assert len(port) == 6
    for c in port:
        assert c["outcome"] == "recovered" and c["detected_ok"], c
        assert (c["orphans"], c["mem_leaked"], c["pipeline_leaked"]) == \
            ([], 0, 0)
