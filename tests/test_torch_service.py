"""The port's multi-tenant query service (runtime/service.py) and the
supervisor's FairScheduler against the JAX package's, on the CPU.

- Admission: the same scripted arrivals (admit, park, reject, a deadline
  that expires while parked) give the same outcomes, in the same order,
  and the same stats in both packages; a shed query writes its own ledger
  line with the same keys; a closed service refuses.
- Fair scheduling: with one worker and a gate, the dispatch order of a
  weight-3 and a weight-1 session is equal, entry by entry; forget()
  cancels what is queued.
- Sessions: priority from conf.tenant_priority_spec, the deadline stamped
  at arrival and read by the Supervisor, the thread-local session.
- SLO: the same latencies give the same attainment, burn rate and
  breaches.
- Quotas: service.start() installs conf.tenant_quota_spec in the
  MemManager, and a tenant over its quota spills its own consumers only.
- End to end: TPC-DS and core queries through QueryService.submit on
  both packages against each validator's oracle; two concurrent sessions
  count the same kernel launches and host pulls as each query run alone
  (run_info's per-query tally); a session with no device raises without
  CUDA and frees its slot.

Waits are bounded by deadlines; counts and rows are exact.
"""

import json
import threading
import time

import numpy as np
import pytest

from blaze_tpu.config import conf as jconf
from blaze_tpu.runtime import faults as jfaults
from blaze_tpu.runtime import memory as jmemory
from blaze_tpu.runtime import service as jservice
from blaze_tpu.runtime import supervisor as jsupervisor
from blaze_tpu.runtime import trace as jtrace
from blaze_tpu_torch.config import conf
from blaze_tpu_torch.runtime import faults, memory, service, supervisor, trace
from torch_parity import both_tables, no_jax_native

# (service, supervisor, faults, memory, trace, conf) of each package
PKGS = {"port": (service, supervisor, faults, memory, trace, conf),
        "jax": (jservice, jsupervisor, jfaults, jmemory, jtrace, jconf)}

KNOBS = ("max_concurrent_queries", "admission_queue_depth",
         "tenant_quota_spec", "tenant_priority_spec", "tenant_slo_spec",
         "query_deadline_ms", "trace_enabled", "trace_export_dir",
         "breaker_failure_threshold", "spill_dir", "flight_dir")


@pytest.fixture(autouse=True)
def clean(monkeypatch, tmp_path):
    for c in (conf, jconf):
        for k in KNOBS:
            monkeypatch.setattr(c, k, getattr(c, k))
        monkeypatch.setattr(c, "spill_dir", str(tmp_path / "spill"))
    yield
    for svc, _sup, flt, mem, _tr, _c in PKGS.values():
        flt.install(None)
        mem.get_manager().set_tenant_quotas(None)
        svc.reset_slo()


def _wait(pred, timeout=10.0, what="condition"):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, f"timed out waiting: {what}"
        time.sleep(0.005)


# ---- admission ----


def _admission_script(svc_mod, flt):
    """Two slots, two parked seats: arrivals 1-2 admitted, 3-4 parked,
    5 rejected; then the parked two run as slots free. Returns the
    outcomes in arrival order and the stats after each phase."""
    out, stats = [], []
    with svc_mod.QueryService(max_concurrent=2, queue_depth=2) as svc:
        held = [svc.admit("gold"), svc.admit("silver")]
        out += [s.admission_outcome for s in held]
        parked = {}

        def waiter(i, tenant):
            s = svc.admit(tenant)
            parked[i] = s

        threads = [threading.Thread(target=waiter, args=(i, t))
                   for i, t in ((2, "gold"), (3, "silver"))]
        for i, t in enumerate(threads):
            t.start()
            _wait(lambda i=i: svc.stats()["queue_depth"] == i + 1,
                  what="the arrival parked")
        with pytest.raises(flt.AdmissionRejected) as ei:
            svc.admit("bronze")
        out.append(("rejected", ei.value.tenant_id, ei.value.wait_ms))
        stats.append(svc.stats())
        svc._release(held[0])
        _wait(lambda: len(parked) == 1, what="one parked admitted")
        stats.append(svc.stats())
        svc._release(held[1])
        _wait(lambda: len(parked) == 2, what="both parked admitted")
        for t in threads:
            t.join(timeout=5)
        out += [parked[i].admission_outcome for i in (2, 3)]
        out.append(all(parked[i].admission_wait_ms > 0 for i in (2, 3)))
        for s in parked.values():
            svc._release(s)
        stats.append(svc.stats())
    return out, stats


def test_admission_outcomes_and_stats_match_jax():
    runs = [_admission_script(svc, flt)
            for svc, _s, flt, _m, _t, _c in PKGS.values()]
    assert runs[0] == runs[1]
    out, stats = runs[0]
    assert out == ["admitted", "admitted", ("rejected", "bronze", 0.0),
                   "parked", "parked", True]
    assert [s["running"] for s in stats] == [2, 2, 0]
    assert [s["queue_depth"] for s in stats] == [2, 1, 0]
    assert stats[-1] == {"running": 0, "queue_depth": 0, "admitted": 4,
                         "parked": 2, "rejected": 1, "capacity": 2,
                         "streams": 0}


def test_deadline_while_parked_sheds_like_jax():
    """The deadline is stamped at arrival: an arrival parked past it is
    shed ("deadline_while_parked"), never started; the admitted query's
    Supervisor reads the same absolute deadline."""
    seen = []
    for svc_mod, sup_mod, flt, _m, _t, c in PKGS.values():
        c.query_deadline_ms = 150
        with svc_mod.QueryService(max_concurrent=1, queue_depth=4) as svc:
            hold = svc.admit("acme")
            assert hold.deadline_at - hold.arrived_at == pytest.approx(
                0.15, abs=1e-6)
            sup = sup_mod.Supervisor(run_info={}, session=hold)
            assert sup.query_deadline == hold.deadline_at
            t0 = time.monotonic()
            with pytest.raises(flt.AdmissionRejected) as ei:
                svc.admit("globex")
            waited = time.monotonic() - t0
            assert 0.1 < waited < 5.0 and ei.value.wait_ms >= 100
            svc._release(hold)
            seen.append((ei.value.tenant_id, svc.stats()["rejected"],
                         "deadline_while_parked" in str(ei.value)))
    assert seen[0] == seen[1] == ("globex", 1, True)


def test_shed_query_ledger_line_matches_jax(tmp_path):
    lines = []
    for name, (svc_mod, _s, flt, _m, _t, c) in PKGS.items():
        c.trace_enabled = True
        c.trace_export_dir = str(tmp_path / name)
        with svc_mod.QueryService(max_concurrent=1, queue_depth=0) as svc:
            hold = svc.admit("acme")
            with pytest.raises(flt.AdmissionRejected):
                svc.admit("globex")
            svc._release(hold)
        recs = [json.loads(line) for line in
                (tmp_path / name / "ledger.jsonl").read_text().splitlines()]
        assert len(recs) == 1
        lines.append(recs[0])
    port, jax = lines
    assert sorted(port) == sorted(jax)
    for rec in lines:
        assert rec["query_id"].startswith("q")
    for key in ("tenant_id", "admission_outcome", "admission_wait_ms",
                "stages", "events", "resilience_events", "dropped_events"):
        assert port[key] == jax[key], key
    assert port["counters"] == jax["counters"]
    assert port["counters"]["admission_reject_reason"] == "queue_full"
    assert port["tenant_id"] == "globex"


def test_closed_service_refuses_like_jax():
    for svc_mod, *_ in PKGS.values():
        svc = svc_mod.QueryService(max_concurrent=1, queue_depth=4)
        svc.start()
        assert svc_mod.active() is svc
        svc.close()
        assert svc_mod.active() is None
        with pytest.raises(RuntimeError, match="closed"):
            svc.admit("acme")


def test_stats_without_a_service_match_jax():
    rows = []
    for svc_mod, *_ in PKGS.values():
        assert svc_mod.active() is None
        rows.append((svc_mod.stats(), svc_mod.capacity()))
    assert rows[0] == rows[1]
    assert rows[0][0]["capacity"] == rows[0][1] >= 1


# ---- fair scheduling ----


def _dispatch_order(svc_mod, sup_mod):
    sched = sup_mod.FairScheduler(width=1)
    try:
        gate, started = threading.Event(), threading.Event()

        def hold():
            started.set()
            gate.wait(10)

        sched.submit(svc_mod.QuerySession("gate", 1.0, sched), hold,
                     what="gate")
        assert started.wait(10)  # the one worker is held
        hi = svc_mod.QuerySession("heavy", 3.0, sched)
        lo = svc_mod.QuerySession("light", 1.0, sched)
        futs = [sched.submit(hi, lambda: "hi", what=f"hi{i}")
                for i in range(9)]
        futs += [sched.submit(lo, lambda: "lo", what=f"lo{i}")
                 for i in range(3)]
        late = svc_mod.QuerySession("late", 1.0, sched)
        assert sched.queue_depth() == 12
        gate.set()
        for f in futs:
            f.result(timeout=10)
        # a session entering after the burst competes from the current
        # virtual clock on
        futs = [sched.submit(late, lambda: "x", what=f"late{i}")
                for i in range(2)]
        for f in futs:
            f.result(timeout=10)
        q = svc_mod.QuerySession("gone", 1.0, sched)
        gate2 = threading.Event()
        blocker = sched.submit(q, lambda: gate2.wait(10), what="block")
        _wait(lambda: blocker.running(), what="the blocker running")
        queued = sched.submit(q, lambda: 1, what="queued")
        sched.forget(q)
        cancelled = queued.cancelled()
        gate2.set()
        return [(t, w) for t, _q, w in sched.dispatch_log], cancelled
    finally:
        sched.close()


def test_fair_scheduler_dispatch_order_matches_jax():
    """One worker: after the gate, a weight-3 session gets three
    dispatches to a weight-1 session's one, FIFO within each session,
    in the same order entry by entry in both packages."""
    (order, cancelled), (jorder, jcancelled) = (
        _dispatch_order(svc, sup) for svc, sup, *_ in PKGS.values())
    assert order == jorder
    assert cancelled and jcancelled
    burst = [t for t, w in order if w[:2] in ("hi", "lo")]
    assert burst[:8].count("heavy") == 6 and burst[:8].count("light") == 2
    his = [w for _t, w in order if w.startswith("hi")]
    assert his == [f"hi{i}" for i in range(9)]


def test_sessions_match_jax():
    for svc_mod, sup_mod, _f, _m, _t, c in PKGS.values():
        c.tenant_priority_spec = {"gold": 4.0}
        c.query_deadline_ms = 0
        s = svc_mod.QuerySession("gold")
        assert s.priority == 4.0 and s.deadline_at is None
        assert svc_mod.QuerySession("other").priority == 1.0
        assert s.batch_target == 0 and s.query_id.startswith("q")
        assert sup_mod.current_session() is None
        sup_mod._current.session = s
        try:
            assert sup_mod.current_session() is s
        finally:
            sup_mod._current.session = None


def test_breaker_stays_per_query():
    """Query A tripping its breaker does not reroute query B: the breaker
    lives on the per-query Supervisor."""
    conf.breaker_failure_threshold = 1
    sup_a = supervisor.Supervisor(run_info={})
    sup_b = supervisor.Supervisor(run_info={})
    err = RuntimeError("boom")
    err.point = "op.SortExec"
    sup_a.breaker.note_failure(err)
    assert sup_a.breaker.should_reroute(frozenset({"SortExec"}))
    assert not sup_b.breaker.should_reroute(frozenset({"SortExec"}))


def test_sticky_cuda_error_is_fatal_for_every_session():
    """Port-only: one session's sticky CUDA error poisons the process's
    context, which every session shares, so it is fatal (never retried),
    whichever session meets it next."""
    for msg in ("CUDA error: an illegal memory access was encountered",
                "CUDA error: unspecified launch failure",
                "CUDA error: device-side assert triggered"):
        assert faults.classify(RuntimeError(msg)) == "fatal"


# ---- SLO ----


def test_slo_stats_match_jax():
    lat = [120.0, 480.0, 510.0, 90.0, 2000.0, 300.0, 450.0, 700.0]
    rows = []
    for svc_mod, _s, _f, _m, _t, c in PKGS.values():
        c.tenant_slo_spec = {"gold": {"latency_ms": 500, "target": 0.9},
                             "idle": {"latency_ms": 100}}
        svc_mod.reset_slo()
        trk = svc_mod.SloTracker()
        steps = []
        for i, ms in enumerate(lat):
            trk.observe("gold", ms, rejected=(i == 6))
            steps.append(trk.stats())
        rows.append(steps)
    assert rows[0] == rows[1]
    last = rows[0][-1]
    assert last["gold"]["window"] == 8 and last["gold"]["breaches"] == 4
    assert last["idle"] == {"latency_ms": 100.0, "target": 0.99,
                            "window": 0, "attainment": 1.0,
                            "burn_rate": 0.0, "breaches": 0}


# ---- quotas ----


def _consumer(mem_mod, name, used):
    class C(mem_mod.MemConsumer):
        def __init__(self):
            self.name, self.used, self.spills = name, used, 0

        def mem_used(self):
            return self.used

        def spill(self):
            freed, self.used = self.used, 0
            self.spills += 1
            return freed

    return C()


def test_service_installs_tenant_quotas_like_jax():
    """service.start() installs conf.tenant_quota_spec; a tenant past its
    quota spills its own consumers, never another tenant's, and close()
    removes the quotas."""
    rows = []
    for svc_mod, _s, _f, mem, tr, c in PKGS.values():
        c.tenant_quota_spec = {"a": 0.01, "b": 0.5}
        mgr = mem.get_manager()
        with svc_mod.QueryService(max_concurrent=1):
            quota_a = mgr.tenant_quota("a")
            with tr.context(tenant_id="a"):
                a1 = _consumer(mem, "a1", quota_a // 2)
                a2 = _consumer(mem, "a2", 0)
                mgr.register(a1)
                mgr.register(a2)
            with tr.context(tenant_id="b"):
                b1 = _consumer(mem, "b1", quota_a * 4)
                mgr.register(b1)
            a2.used = quota_a  # a is now past its quota
            mgr.update_mem_used(a2)
            row = (quota_a == int(mgr.total * 0.01),
                   a1.spills + a2.spills >= 1, b1.spills, b1.used > 0,
                   mgr.tenant_used("a") <= quota_a)
            for x in (a1, a2, b1):
                mgr.unregister(x)
        row += (mgr.tenant_quota("a"),)
        rows.append(row)
    assert rows[0] == rows[1] == (True, True, 0, True, True, None)


# ---- end to end ----


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    return both_tables(tmp_path_factory, rows=2000)


# (tenant, suite, query, join mode): q02 takes the dense partial
# aggregate (the accumulate kernel's route), the others the general paths
JOBS = (("gold", "tpcds", "q02", "bhj"),
        ("silver", "core", "q2_q06_core_agg", "bhj"),
        ("bronze", "core", "q3_join_agg_sort", "smj"),
        ("gold", "core", "q1_scan_filter_project", "bhj"))


def _val(pkg, suite):
    if pkg == "port":
        from blaze_tpu_torch.spark import tpcds, validator
    else:
        from blaze_tpu.spark import tpcds, validator
    return (tpcds if suite == "tpcds" else validator), validator


def test_concurrent_sessions_match_jax_and_oracle(tables, monkeypatch):
    """Four queries across three tenants through QueryService.submit in
    each package (two slots, so two park): every answer equals its
    validator's oracle and the other package's rows, and the billing
    lands in run_info alike."""
    no_jax_native(monkeypatch)
    answers = {}
    for pkg, (svc_mod, _s, _f, _m, _t, c) in PKGS.items():
        c.tenant_priority_spec = {"gold": 3.0, "silver": 1.0}
        extra = {"device": "cpu"} if pkg == "port" else {}
        with svc_mod.QueryService(max_concurrent=2, queue_depth=8) as svc:
            futs = []
            for tenant, suite, q, mode in JOBS:
                mod, val = _val(pkg, suite)
                paths, frames = tables[suite][0 if pkg == "port" else 1]
                plan, oracle = mod.QUERIES[q](paths, frames, mode)
                info = {}
                futs.append((q, val, oracle, info, svc.submit(
                    plan, tenant, run_info=info, num_partitions=4,
                    mesh_exchange="off", **extra)))
            for q, val, oracle, info, fut in futs:
                got = fut.result(timeout=300)
                assert val._compare(
                    val._to_pandas(got).reset_index(drop=True),
                    oracle().reset_index(drop=True)) is None, q
                answers.setdefault(q, []).append(
                    (val._to_pandas(got), info["tenant_id"],
                     info["admission_outcome"] in ("admitted", "parked")))
            st = svc.stats()
            assert st["admitted"] == len(JOBS) and st["rejected"] == 0
    for q, ((rows, tenant, ok), (jrows, jtenant, jok)) in answers.items():
        assert tenant == jtenant and ok and jok
        _same_frames(rows, jrows, q)


def _same_frames(a, b, what):
    """Rows equal as multisets: integers and strings exactly, floats
    within rtol 1e-12 (the dense route sums digit planes; the JAX
    package's float sums differ in the last bits)."""
    cols = list(a.columns)
    assert cols == list(b.columns), what
    a = a.sort_values(cols).reset_index(drop=True)
    b = b.sort_values(cols).reset_index(drop=True)
    assert len(a) == len(b), what
    for c in cols:
        if a[c].dtype.kind == "f":
            np.testing.assert_allclose(a[c].to_numpy(), b[c].to_numpy(),
                                       rtol=1e-12, err_msg=f"{what}.{c}")
        else:
            assert a[c].tolist() == b[c].tolist(), f"{what}.{c}"


def _count_launches(monkeypatch):
    """On the CPU the accumulate wrapper runs its plain version and counts
    no launch; count each call into the thread's tally as a launch on
    the card would (ops/mxu_agg.accumulate_into)."""
    from blaze_tpu_torch.ops import mxu_agg
    from blaze_tpu_torch.runtime import metrics

    real = mxu_agg.accumulate_into

    def counted(*a, **k):
        metrics.tally_add("kernel_launches")
        return real(*a, **k)

    monkeypatch.setattr(mxu_agg, "accumulate_into", counted)


def test_two_sessions_count_their_own_launches_and_pulls(tables,
                                                         monkeypatch):
    """Two q02 sessions at once count, each in its run_info, exactly the
    kernel launches and host pulls that q02 counts run alone, and the
    rows are the same."""
    from blaze_tpu_torch.spark import tpcds, validator

    _count_launches(monkeypatch)
    paths, frames = tables["tpcds"][0]

    def plan():
        return tpcds.QUERIES["q02"](paths, frames, "bhj")[0]

    alone = {}
    with service.QueryService(max_concurrent=1) as svc:
        solo = validator._to_pandas(svc.run(
            plan(), "solo", run_info=alone, num_partitions=4,
            mesh_exchange="off", device="cpu"))
    assert alone["kernel_launches"] > 0 and alone["host_pulls"] > 0
    infos = [{}, {}]
    with service.QueryService(max_concurrent=2, queue_depth=0) as svc:
        futs = [svc.submit(plan(), t, run_info=i, num_partitions=4,
                           mesh_exchange="off", device="cpu")
                for t, i in zip(("a", "b"), infos)]
        outs = [validator._to_pandas(f.result(timeout=300)) for f in futs]
    for info, out in zip(infos, outs):
        assert info["admission_outcome"] == "admitted"
        assert info["kernel_launches"] == alone["kernel_launches"]
        assert info["host_pulls"] == alone["host_pulls"]
        assert out.equals(solo)


def test_session_without_a_device_raises_without_cuda(tables):
    """A service session names no device: run_plan takes the card, and
    with no CUDA it raises before any work, on the host or elsewhere;
    the slot is freed."""
    import torch

    from blaze_tpu_torch.spark import validator

    assert not torch.cuda.is_available()
    paths, frames = tables["core"][0]
    plan, _ = validator.QUERIES["q1_scan_filter_project"](paths, frames,
                                                          "bhj")
    with service.QueryService(max_concurrent=1) as svc:
        info = {}
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            svc.run(plan, "acme", run_info=info)
        assert "stage_s" not in info  # no stage ran
        fut = svc.submit(plan, "acme", run_info={})
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            fut.result(timeout=30)
        _wait(lambda: svc.stats()["running"] == 0, what="slot freed")
        assert svc.stats()["admitted"] == 2
