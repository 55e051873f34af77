"""The port's chaos soak against the JAX package's in `--executors`' kill
rounds, at 2,000 rows on the CPU, each on a 2-seat executor pool: a busy
worker SIGKILLed (one executor_death dossier, the capacity shrinking and
recovering) or SIGTERMed (drained with no dossier and no requeue). Each
round's outcome and gates must be the JAX round's. A round whose gate
hangs on timing (a worker's start-up, a sampler's wake-up) runs once
more, in either package, when it misses the gate on a loaded host
(`torch_soak.gated`).
"""

import tempfile

import pytest

from torch_soak import (  # noqa: F401 (cpu_soaks, tables: fixtures)
    SEED, assert_no_leaks, cpu_soaks, gated, jsoak, soak, tables)

pytestmark = pytest.mark.usefixtures("cpu_soaks")


@pytest.mark.parametrize("kind", ["sigkill", "sigterm"])
def test_executor_kill_round_matches_jax(tables, tmp_path, kind):
    rounds = [gated(lambda: mod._executor_kill_round(
        t, kind, tempfile.mkdtemp(dir=tmp_path), "r0"),
        lambda r: r["outcome"] == "recovered" and r["dossier_ok"])
        for mod, t in ((soak, tables[0]), (jsoak, tables[1]))]
    keys = ("outcome", "fired", "death_dossiers", "dossier_ok",
            "capacity_shrank", "capacity_recovered")
    port, jax = rounds
    assert {k: port[k] for k in keys} == {k: jax[k] for k in keys}
    assert port["outcome"] == "recovered" and port["dossier_ok"]
    for r in rounds:
        assert_no_leaks(r)
