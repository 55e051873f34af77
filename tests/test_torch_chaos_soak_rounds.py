"""The port's chaos soak against the JAX package's in one round of its
`--service`, `--network`, `--profile` and `--driver` modes each, at
2,000 rows on the CPU (test_torch_chaos_soak_pool.py has the pooled
rounds).

Concurrent sessions share one fault schedule, so which session a fault
lands in is the scheduler's choice in either package: a service round is
held to its gates (every answer oracle-equal, no breaker isolation broken,
no leak, overload shed with typed rejections) and to the JAX round's, and
the fairness probe, whose dispatch order is deterministic, to the JAX
probe's exactly. The wire-fault cells of the shuffle fetch protocol and
the profiler's attribution round must give the JAX rounds' outcomes and
gates.
The attribution round runs with a second sampler a pass every 5 ms
beside the profiler's daemon in both packages, so that its samples fall
in the seeded stalls however loaded the host is. The driver round (a
journaling subprocess driver SIGKILLed mid-query and restarted: the
committed stages replayed, no map task re-run, the crashed attempt billed
with one driver_restart dossier) runs once more when it misses its gate
on a loaded host (`torch_soak.gated`).
"""

import argparse
import contextlib
import threading

import pytest

from blaze_tpu.config import conf as jconf
from blaze_tpu_torch.config import conf
from torch_soak import (  # noqa: F401 (cpu_soaks, tables: fixtures)
    SEED, assert_no_leaks, cpu_soaks, gated, jax_children_without_native,
    jsoak, soak, tables)

pytestmark = pytest.mark.usefixtures("cpu_soaks")


def _service_gates(r):
    return {"wrong": [q for q in r["queries"]
                      if q["outcome"] == "wrong_answer"],
            "failed": sorted(q["outcome"] for q in r["queries"]
                             if q["outcome"] == "classified_fail"),
            "isolation_violations": r["isolation_violations"],
            "queries": len(r["queries"])}


@pytest.fixture
def service_conf(monkeypatch):
    """main()'s --service admission for 6 sessions in both packages."""
    for c in (conf, jconf):
        monkeypatch.setattr(c, "max_concurrent_queries", 3)
        monkeypatch.setattr(c, "admission_queue_depth", 6)


@pytest.mark.parametrize("point", ["op", "serde.encode"])
def test_service_round_matches_jax(tables, service_conf, point):
    spec = {"seed": SEED, "concurrent": True,
            "points": {point: {"fail_times": 2, "kind": "io"}}}
    rounds = [mod._run_service_round(t, f"{point}:io", 6, 3, dict(spec))
              for mod, t in ((soak, tables[0]), (jsoak, tables[1]))]
    port, jax = rounds
    assert _service_gates(port) == _service_gates(jax)
    assert _service_gates(port)["wrong"] == []
    assert port["isolation_violations"] == []
    assert sum(q["faults_injected"] for q in port["queries"]) >= 1
    for r in rounds:
        assert_no_leaks(r)


def test_fairness_probe_matches_jax():
    port, jax = soak._fairness_probe(), jsoak._fairness_probe()
    keys = ("first8_heavy", "first8_light", "fairness_ok")
    assert {k: port[k] for k in keys} == {k: jax[k] for k in keys}
    assert port["fairness_ok"]


def test_admission_stress_sheds_as_jax(tables, service_conf):
    rounds = [mod._run_service_round(t, "admission_stress", 6, 3, None,
                                     max_concurrent=1, queue_depth=1)
              for mod, t in ((soak, tables[0]), (jsoak, tables[1]))]
    shed = [sum(q["outcome"] == "rejected_at_admission"
                for q in r["queries"]) for r in rounds]
    assert shed[0] > 0 and shed[1] > 0
    for r in rounds:
        assert {q["outcome"] for q in r["queries"]} <= {
            "clean_ok", "rejected_at_admission"}
        assert_no_leaks(r)


@pytest.mark.parametrize("kind", ["delay", "reset", "torn", "dup",
                                  "blackhole"])
def test_shuffle_fetch_wire_cell_matches_jax(kind):
    port = soak._net_shuffle_cell(kind, SEED)
    jax = jsoak._net_shuffle_cell(kind, SEED)
    keys = ("outcome", "fired", "deaths")
    assert {k: port[k] for k in keys} == {k: jax[k] for k in keys}
    assert port["outcome"] == "recovered"


@contextlib.contextmanager
def sampling(profiler):
    """A second sampler beside the profiler's daemon, a pass every 5 ms:
    the daemon's governor sleeps 100x a pass's cost, so on a loaded host
    it can sleep through a seeded 250 ms stall altogether."""
    stop = threading.Event()

    def run():
        while not stop.wait(0.005):
            profiler.sample_once()

    t = threading.Thread(target=run, daemon=True)
    t.start()
    try:
        yield
    finally:
        stop.set()
        t.join(timeout=5)
        assert not t.is_alive()


def _stall_stacks(profiler, qid):
    """The seeded stall's collapsed stacks of query `qid`: (its synthetic
    query and stage roots, its frames from faults.inject down)."""
    out = set()
    for ln in profiler.collapsed(qid):
        stack = ln.rsplit(" ", 1)[0].split(";")
        if "faults._stall" in stack:
            roots = [f.split(":")[0] for f in stack[:2]]
            tail = stack[stack.index("faults.inject"):]
            out.add((tuple(roots), tuple(tail)))
    return out


def test_profile_attribution_round_matches_jax(tables):
    from blaze_tpu.runtime import profiler as jprofiler
    from blaze_tpu_torch.runtime import profiler

    args = argparse.Namespace(seed=SEED)
    with sampling(profiler):
        port = soak._profile_attrib_round(tables[0], args)
    port_stalls = _stall_stacks(profiler, port["query_id"])
    with sampling(jprofiler):
        jax = jsoak._profile_attrib_round(tables[1], args)
    jax_stalls = _stall_stacks(jprofiler, jax["query_id"])
    keys = ("outcome", "attributed", "exports_written", "stalls_injected")
    assert {k: port[k] for k in keys} == {k: jax[k] for k in keys}
    assert port["attributed"] and port["stall_stacks"] >= 1
    # frames are module-qualified (serde.serialize_slice, faults._stall),
    # so the two packages' stall frames compare as they are
    assert port_stalls == jax_stalls and port_stalls
    for r in (port, jax):
        assert_no_leaks(r)
    profiler.reset()
    jprofiler.reset()


def test_driver_kill_round_matches_jax(monkeypatch):
    jax_children_without_native(monkeypatch, "_DRIVER_CHILD")
    args = argparse.Namespace(rows=2000, seed=SEED)
    port, jax = (gated(lambda: mod._driver_kill_round(args),
                       lambda r: r["outcome"] == "recovered")
                 for mod in (soak, jsoak))
    keys = ("outcome", "held", "killed", "stages_committed_before_kill",
            "resume", "restart_dossiers", "billed_driver_restart")
    assert {k: port.get(k) for k in keys} == {k: jax.get(k) for k in keys}
    assert port["outcome"] == "recovered", port
    assert port["resume"]["map_tasks_run"] == 0
