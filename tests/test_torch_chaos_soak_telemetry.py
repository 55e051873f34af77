"""The port's chaos soak against the JAX package's in its telemetry
rounds, at 2,000 rows on the CPU, each on a 2-seat executor pool:
`--dist-obs`' chaos round (a busy worker SIGKILLed with the telemetry
plane on: one merged Chrome trace, executor spans on their own pid rows,
no dropped ring, the workers' copy bytes in the ledger) and `--profile`'s
pooled round (the profiler on in every process, every live telemetry
frame blackholed, a busy worker SIGKILLed: its samples reach the driver
through its sidecar). Each round's outcome and gates must be the JAX
round's. A round whose gate hangs on timing (a worker's start-up, a
sampler's wake-up) runs once more, in either package, when it misses the
gate on a loaded host (`torch_soak.gated`). Last, the port's worker spills
its telemetry tail before its first plan task starts the engine, which
is what keeps the pooled profile round's gate on the card.
"""

import argparse
import tempfile

import pytest

from torch_soak import (  # noqa: F401 (cpu_soaks, tables: fixtures)
    SEED, assert_no_leaks, cpu_soaks, gated, jsoak, soak, tables)

pytestmark = pytest.mark.usefixtures("cpu_soaks")


def test_dist_obs_chaos_round_matches_jax(tables, tmp_path):
    def run(mod, t):
        return mod._dist_obs_chaos_round(t, tempfile.mkdtemp(dir=tmp_path),
                                         tempfile.mkdtemp(dir=tmp_path))

    rounds = [gated(lambda: run(mod, t),
                    lambda r: r["outcome"] == "recovered"
                    and r["merged_trace"]["ok"] and r["counters_reconciled"])
              for mod, t in ((soak, tables[0]), (jsoak, tables[1]))]
    port, jax = rounds
    keys = ("outcome", "fired", "dropped_rings", "counters_reconciled")
    trace_keys = ("ok", "executor_pid_rows", "clock_aligned")
    assert {k: port[k] for k in keys} == {k: jax[k] for k in keys}
    assert {k: port["merged_trace"][k] for k in trace_keys} == \
        {k: jax["merged_trace"][k] for k in trace_keys}
    assert port["outcome"] == "recovered" and port["merged_trace"]["ok"]
    assert port["stats"]["telemetry_records_total"] > 0
    for r in rounds:
        assert_no_leaks(r)


def test_profile_pool_round_matches_jax(tables):
    args = argparse.Namespace(seed=SEED)
    rounds = [gated(lambda: mod._profile_pool_round(t, args),
                    lambda r: r["outcome"] == "recovered"
                    and r["merged_fleet_profile"] and r["sidecar_recovered"])
              for mod, t in ((soak, tables[0]), (jsoak, tables[1]))]
    port, jax = rounds
    keys = ("outcome", "fired", "merged_fleet_profile", "sidecar_recovered")
    assert {k: port[k] for k in keys} == {k: jax[k] for k in keys}
    assert port["sidecar_recovered"] and port["merged_fleet_profile"]
    for r in rounds:
        assert_no_leaks(r)


def test_worker_spills_telemetry_before_its_engine_starts(monkeypatch,
                                                          tmp_path):
    """A worker's first plan task announces "starting", spills its
    telemetry tail to the sidecar without shipping it (profile rows
    included), and only then starts the engine: the start-up holds the
    interpreter lock for seconds on the card, so no ship runs until it is
    done, and a worker killed meanwhile is recovered from the sidecar.
    Later plan tasks neither announce nor spill."""
    from blaze_tpu_torch.runtime import executor_pool as ep

    monkeypatch.setenv(ep._ENV_TOKEN, "tok")
    monkeypatch.setenv(ep._ENV_CTL, str(tmp_path / "ctl.sock"))
    worker = ep._Worker()
    calls = []
    monkeypatch.setattr(worker, "_send_quiet",
                        lambda header: calls.append(header["type"]))
    monkeypatch.setattr(worker, "_flush_telemetry",
                        lambda ship=True: calls.append(("flush", ship)))
    monkeypatch.setattr(worker, "_run_plan_loaded",
                        lambda payload, blob, epoch, t_load: calls.append(
                            ("run", t_load is not None)) or {})
    worker._run_plan({}, b"", 1)
    worker._run_plan({}, b"", 1)
    assert calls == ["starting", ("flush", False), ("run", True), "started",
                     ("run", False)]
