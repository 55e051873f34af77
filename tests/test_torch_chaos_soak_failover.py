"""The port's chaos soak against the JAX package's in its subprocess
rounds, on the CPU, each marked slow (a round spawns a primary driver,
its pool and a standby, and runs for one to several minutes a package;
on a loaded host it misses its own gates in either package):
`--elastic`'s failover round (a subprocess primary with a 4-seat pool
SIGKILLed with two of its executors; a warm standby takes the lease
under a bumped epoch, adopts the two survivors, respawns the others and
answers every query oracle-equal, with one driver_failover dossier),
`--streaming`'s round (an executor SIGKILL mid-batch, then the
primary's; the standby adopts the stream and drains it oracle-equal, its
checkpoint epochs monotone) and `--autopilot`'s poison round at the
24,000 rows its knob physics need (a seeded shrinking proposal rolls
back, is quarantined across a restart and never proposed again). The JAX
soak's children run with its native layer out, as the in-process runs
do. A round whose gate hangs on timing (a worker's start-up, a sampler's
wake-up, an autoscaler tick) runs once more, in either package, when it
misses the gate on a loaded host (`torch_soak.gated`).
"""

import argparse

import pytest

from torch_soak import (  # noqa: F401 (cpu_soaks, tables: fixtures)
    SEED, cpu_soaks, gated, jax_children_without_native, jsoak, soak)

pytestmark = pytest.mark.usefixtures("cpu_soaks")


def _failover_facts(rec):
    res = rec.get("standby") or {}
    return dict({k: rec.get(k) for k in ("outcome", "seconds",
                                          "standby_output")},
                **{k: res.get(k) for k in ("took_over", "wrong", "incomplete",
                                           "adopted", "live_seats",
                                           "recovered_stages", "takeover",
                                           "orphans")})


@pytest.mark.slow
def test_elastic_failover_round_matches_jax(monkeypatch):
    jax_children_without_native(monkeypatch, "_ELASTIC_PRIMARY",
                                "_ELASTIC_STANDBY")
    args = argparse.Namespace(rows=2000, seed=SEED)
    port, jax = (gated(lambda: mod._elastic_failover_round(args),
                       lambda r: r["outcome"] == "recovered")
                 for mod in (soak, jsoak))
    keys = ("outcome", "held", "standby_watching", "killed_primary",
            "killed_executors", "failover_dossiers")
    assert {k: port.get(k) for k in keys} == {k: jax.get(k) for k in keys}, (
        _failover_facts(port), _failover_facts(jax))
    assert port["outcome"] == "recovered", port.get("standby_output")
    res_keys = ("took_over", "wrong", "incomplete", "adopted", "live_seats",
                "orphans")
    assert {k: port["standby"][k] for k in res_keys} == \
        {k: jax["standby"][k] for k in res_keys}


@pytest.mark.slow
def test_streaming_round_matches_jax(monkeypatch):
    jax_children_without_native(monkeypatch, "_STREAM_PRIMARY",
                                "_STREAM_STANDBY")
    args = argparse.Namespace(rows=2000, seed=SEED)
    port, jax = (gated(lambda: mod._streaming_round(args),
                       lambda r: r["outcome"] == "recovered")
                 for mod in (soak, jsoak))
    keys = ("outcome", "held", "standby_watching", "killed_executors",
            "survived_executor_kill", "killed_primary", "failover_dossiers",
            "restart_dossiers", "diff", "epochs_monotone")
    assert {k: port.get(k) for k in keys} == {k: jax.get(k) for k in keys}
    assert port["outcome"] == "recovered", port.get("standby_output")


@pytest.mark.slow
def test_autopilot_poison_round_matches_jax(tmp_path_factory, monkeypatch):
    from blaze_tpu.config import conf as jconf
    from blaze_tpu.runtime import autopilot as jautopilot
    from blaze_tpu.runtime import history as jhistory
    from blaze_tpu.spark import validator as jvalidator
    from blaze_tpu_torch.config import conf
    from blaze_tpu_torch.runtime import autopilot, history
    from blaze_tpu_torch.spark import validator

    keys = ("autopilot_enabled", "autopilot_dir", "history_dir",
            "flight_dir", "flight_triggers", "trace_enabled",
            "autopilot_canary_runs", "history_regression_pct",
            "target_batch_bytes")
    rounds = []
    for c, mod, val, ap, hist in (
            (conf, soak, validator, autopilot, history),
            (jconf, jsoak, jvalidator, jautopilot, jhistory)):
        for k in keys:
            monkeypatch.setattr(c, k, getattr(c, k))
        d = tmp_path_factory.mktemp("ap")
        try:
            rounds.append(mod._autopilot_poison_round(
                val.generate_tables(str(d), rows=24000),
                argparse.Namespace(seed=SEED)))
        finally:
            ap.reset()
            hist.reset()
    port, jax = rounds
    keys = ("wrong_answers", "rolled_back", "rollback_reason", "quarantined",
            "quarantine_survived_restart", "reproposed_after_quarantine",
            "rollback_dossiers", "contained")
    assert {k: port[k] for k in keys} == {k: jax[k] for k in keys}
    assert port["contained"]
