"""The port's chaos soak against the JAX package's in its fleet modes, at
2,000 rows on the CPU: `--network`'s transient control-socket reset (a
2-seat pool's busy seat reconnects and resumes, capacity untouched, no
dossier), `--elastic`'s autoscale round (a 1-seat pool under an 8-client
burst scales up and back down through the drain barrier), and one
oracle-checked `--autopilot` run with the plane on. Each round's outcome
and gates must be the JAX round's (test_torch_chaos_soak_failover.py has
the subprocess rounds). A round whose gate hangs on timing (a worker's
start-up, a sampler's wake-up, an autoscaler tick) runs once more, in
either package, when it misses the gate on a loaded host
(`torch_soak.gated`).
"""

import tempfile

import pytest

from torch_soak import (  # noqa: F401 (cpu_soaks, tables: fixtures)
    assert_no_leaks, cpu_soaks, gated, jsoak, soak, tables)

pytestmark = pytest.mark.usefixtures("cpu_soaks")


def test_control_reset_reconnect_round_matches_jax(tables, tmp_path):
    rounds = [gated(lambda: mod._net_reconnect_round(
        t, tempfile.mkdtemp(dir=tmp_path)), lambda r: r["reconnect_ok"])
        for mod, t in ((soak, tables[0]), (jsoak, tables[1]))]
    keys = ("outcome", "fired", "capacity_stable", "death_dossiers",
            "control_reconnect_event", "reconnect_ok")
    port, jax = rounds
    assert {k: port[k] for k in keys} == {k: jax[k] for k in keys}
    assert port["reconnect_ok"]
    for r in rounds:
        assert_no_leaks(r)


def test_elastic_scale_round_matches_jax(tables):
    rounds = [gated(lambda: mod._elastic_scale_round(t),
                    lambda r: r["elastic_ok"])
              for mod, t in ((soak, tables[0]), (jsoak, tables[1]))]
    port, jax = rounds
    keys = ("elastic_ok", "failed_queries")
    assert {k: port[k] for k in keys} == {k: jax[k] for k in keys}, [
        {k: r.get(k) for k in ("scaler", "capacity_timeline", "queries")}
        | {"stats": {k: r["stats"].get(k) for k in (
            "drain_requeues_total", "deaths_total", "draining")}}
        for r in rounds]
    assert port["elastic_ok"], port.get("scaler")
    for r in rounds:
        assert r["scaler"]["decisions"]["up"] >= 1
        assert r["scaler"]["decisions"]["down"] >= 1
        assert r["stats"]["drain_requeues_total"] == 0
        assert_no_leaks(r)


def test_autopilot_run_matches_jax(tables, monkeypatch, tmp_path):
    from blaze_tpu.config import conf as jconf
    from blaze_tpu.runtime import autopilot as jautopilot
    from blaze_tpu.runtime import history as jhistory
    from blaze_tpu_torch.config import conf
    from blaze_tpu_torch.runtime import autopilot, history

    runs = []
    for name, c, mod, ap, hist, t in (
            ("port", conf, soak, autopilot, history, tables[0]),
            ("jax", jconf, jsoak, jautopilot, jhistory, tables[1])):
        monkeypatch.setattr(c, "autopilot_enabled", True)
        monkeypatch.setattr(c, "autopilot_dir", str(tmp_path / name / "ap"))
        monkeypatch.setattr(c, "history_dir", str(tmp_path / name / "h"))
        monkeypatch.setattr(c, "trace_enabled", True)
        ap.reset()
        hist.reset()
        try:
            runs.append([mod._autopilot_run(t) for _ in range(2)])
        finally:
            ap.reset()
            hist.reset()
    for port, jax in zip(*runs):
        assert port["diff"] is None and jax["diff"] is None
        assert (port["canary"], port["overlay"]) == (jax["canary"],
                                                     jax["overlay"])
        assert port["fingerprint"]
