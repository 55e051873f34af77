"""Helpers the chaos-soak parity tests share (test_torch_chaos_soak*.py):
the JAX package's tools/chaos_soak.py loaded by file path, each package's
core tables from one seed, and one cell through both soaks."""

import copy
import importlib.util
import os

import pytest

from blaze_tpu_torch.tools import chaos_soak as soak

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS = 2000
SEED = 1234
KEYS = ("outcome", "error_category", "ladder_rung", "faults_injected")


def load_jax_soak():
    spec = importlib.util.spec_from_file_location(
        "jax_chaos_soak", os.path.join(REPO, "tools", "chaos_soak.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jsoak = load_jax_soak()


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    """(port tables, JAX tables): each package's core tables from seed 7."""
    from blaze_tpu.spark import validator as jvalidator
    from blaze_tpu_torch.spark import validator

    d = tmp_path_factory.mktemp("soak")
    out = []
    for name, val in (("port", validator), ("jax", jvalidator)):
        os.makedirs(d / name)
        out.append(val.generate_tables(str(d / name), rows=ROWS))
    return tuple(out)


@pytest.fixture
def cpu_soaks(monkeypatch):
    """The port's soak on the CPU, the JAX package's native layer out."""
    from torch_parity import no_jax_native

    no_jax_native(monkeypatch)
    monkeypatch.setattr(soak, "DEVICE", "cpu")


def both_cells(tables, query, mode, spec):
    """(port cell, JAX cell) of one query under `spec`, each package's
    spec a fresh copy."""
    port = soak._run_cell(tables[0], query, mode, copy.deepcopy(spec))
    jax = jsoak._run_cell(tables[1], query, mode, copy.deepcopy(spec))
    return port, jax


def assert_same_cell(port, jax, concurrent=False):
    """The cells' outcome, category, rung and faults injected are the same.
    Under a concurrent spec the two failures may land in one task or in
    two, so the rung reached is the scheduler's choice in either package:
    there the ladder must have engaged (or not) in both."""
    keys = KEYS
    if concurrent:
        keys = tuple(k for k in KEYS if k != "ladder_rung")
        assert bool(port.get("ladder_rung")) == bool(jax.get("ladder_rung"))
    assert {k: port.get(k) for k in keys} == {k: jax.get(k) for k in keys}
    for cell in (port, jax):
        assert cell["outcome"] != "wrong_answer", cell
        assert (cell["orphans"], cell["mem_leaked"],
                cell["pipeline_leaked"]) == ([], 0, 0), cell


def assert_no_leaks(rec):
    """A round's leak record: no orphan, reservation, stream or
    query-namespaced resource left."""
    assert (rec["orphans"], rec["mem_leaked"], rec["pipeline_leaked"],
            rec.get("resource_leaked", [])) == ([], 0, 0, []), rec


def jax_children_without_native(monkeypatch, *names):
    """The JAX soak's child scripts `names` with its native layer out, as
    no_jax_native does in-process."""
    for name in names:
        src = getattr(jsoak, name)
        assert "from blaze_tpu.config import conf\n" in src
        monkeypatch.setattr(jsoak, name, src.replace(
            "from blaze_tpu.config import conf\n",
            "from blaze_tpu.config import conf\n"
            "from blaze_tpu import native\n"
            "native.available = lambda: False\n", 1))


def gated(run, gate, tries=2):
    """run() again, up to `tries` times, while its record misses `gate`:
    the rounds whose gates hang on timing (a worker's start-up, a sampler's
    wake-up, an autoscaler tick) can miss them on a loaded host in either
    package. The last record is returned, met or not."""
    for _ in range(tries):
        rec = run()
        if gate(rec):
            break
    return rec
