"""Chaos soak: sweep every fault-injection point x fault kind over the
validator mini-catalogue on the port, and write the cells as JSON where
`--json-out` says.

`--supervisor`: the same sweep — plus the "stall"
kind — under the CONCURRENT supervised pool (4 workers, hang detection
armed, straggler speculation on). Every
cell must still match the pandas oracle with zero orphan artifacts and
zero leaked reservations; stall cells must recover via watchdog kill +
relaunch instead of waiting the stall out. The overhead section gains a
supervisor-off vs. sequential A/B backing the "disabled path is the
sequential runner" claim.

`--pipeline`: the same sweep with the async pipeline layer
kept LIVE under every armed spec (specs are marked concurrent, since
the pipeline gate otherwise falls back to serial for deterministic
non-concurrent specs). This drives
pool-thread failures — including the queue hand-off point
`io.prefetch` — through the classification/recovery ladder; every cell
must additionally finalize all prefetch streams and sinks
(`pipeline_leaked` = 0; leaked MemManager pipeline reservations are
already covered by `mem_leaked`, since `mem_used()` includes them).

`--service`: concurrent multi-tenant soak through
runtime/service.QueryService — `--concurrent-queries N` sessions across
`--tenants K` tenants per round, one clean round plus one round per
armed (point, kind). Every session's
answer must match the pandas oracle, no round may leak consumers,
pipeline streams, namespaced resources or orphan artifacts, and breaker
state must stay per-query: a session that saw zero injected faults must
never record a breaker reroute caused by a faulted neighbor. An
admission-stress round (1 slot, tiny queue) must shed with typed
rejections while every admitted query still answers correctly.

`--durability`: the artifact-integrity sweep — every
CORRUPT_POINTS cell arms a deterministic post-publish bit flip in a
committed artifact (shuffle .data frame body, .index offsets, spill
frame) and demands the checksum layer DETECT it (corruptions +1),
QUARANTINE the flipped file (.quarantine rename), lineage-REPAIR
shuffle outputs by re-running only the producing map task under a new
epoch, and still match the pandas oracle. Spill cells run under a tiny
memory budget so the sort actually spills; their recovery is the task
retry ladder (no lineage repair), so `repaired` stays 0 there by
design. `--driver` adds the driver-crash round: a subprocess driver
journals its stage commits, is SIGKILLed while holding mid-query (all
map stages committed, result stage not), and a restarted driver must
replay the journal — verified committed stages reused (map_tasks_run
== 0), the crashed attempt billed failed with a `driver_restart`
flight dossier — and still answer oracle-equal.

`--dist-obs`: the distributed-telemetry acceptance run —
a pooled chaos round (q3 under a 2-seat pool, SIGKILL mid-stage) with
the telemetry plane ON must still answer oracle-equal AND produce ONE
merged Chrome trace where driver and executor spans share query/task
ids on per-executor pid rows with clock-aligned timestamps, zero
executors report dropped span rings, and the run ledger's counters
carry the workers' federated copy bytes (pre-federation these were
silently zero for pooled runs). A telemetry on/off A/B over the pooled
catalogue gates the plane's overhead below 2%.

`--elastic`: the elastic-fleet & driver-HA acceptance run, two
rounds. (1) autoscale: a 1-seat pool
under an 8-client burst must scale UP on parked arrivals (typed
scale_up decisions, fleet pinned by autoscale_max), then scale DOWN to
the floor after quiesce through the drain barrier — both directions
recorded, ZERO drain requeues, every answer oracle-equal. (2) failover:
a subprocess primary (4-seat pool, journaling, fleet manifest + fenced
leader lease beside the journals) is SIGKILLed while holding 8 queries
mid-flight, then TWO of its executors are SIGKILLed too; a warm-standby
subprocess must detect the death, acquire the lease under a bumped
epoch, rebind the control plane (ADOPTING the two surviving workers,
respawning the dead ones), replay the dead primary's journals, and
answer every query oracle-equal — with exactly ONE driver_failover
dossier and zero orphans.

`--streaming`: the durable exactly-once streaming acceptance run. A
subprocess primary (4-seat pool, fenced leader lease, fleet manifest)
opens a checkpointed micro-batch stream over a growing parquet directory
through QueryService while the parent keeps publishing files; one of its
executors is SIGKILLed mid-batch (the primary must keep committing
checkpoints), then the primary itself is SIGKILLed; a warm-standby
subprocess must take over, ADOPT the dead driver's stream from its
journal (takeover reports streams_adoptable, never a driver_restart
bill), resume from the last committed checkpoint (resumed_batches >= 1)
and drain the remaining input — final aggregation state oracle-equal to
a pandas replay of EVERY published file (0 dropped, 0 double-counted
rows), checkpoint epochs strictly monotone across both drivers, exactly
ONE driver_failover dossier.

`--autopilot`: the self-tuning-autopilot acceptance run. (1) converge: a
400ms stall armed on EVERY serde.encode call makes frame count the
dominant cost, so the doctor's serde_bound suggestion (raise
conf.target_batch_bytes) is genuinely right; the explorer must canary
its way up the knob's declared schedule — stepping OVER the neutral
512KB plateau via an inconclusive-canary quarantine — until a promoted
settled overlay beats the base configuration's p50, with every run
pandas-oracle-equal and no (knob, value) proposed twice. (2) poison: a
seeded proposal that SHRINKS target_batch_bytes (strictly more frames
under the same stall) must draw a regression verdict on its first canary
run, roll back, quarantine the value, capture exactly one
autopilot_rollback flight dossier, keep the quarantine across a driver
restart (store refold), and never re-propose the value. (3) an autopilot
on/off A/B with the explorer idled must be within noise.

`--profile`: the continuous-profiling acceptance run. (1) attrib: four
deterministic 250ms stalls armed on serde.encode with the sampling
profiler on — the collapsed-stack export must show faults frames under
the right query:<qid>;stage:<sid> synthetic roots (the "which code,
attributed" claim), the per-query .collapsed + .speedscope.json
artifacts must land in conf.profile_export_dir, answer oracle-equal. (2)
pool: q3 on a 2-seat pool with the profiler on in every process and a
PERSISTENT net.telemetry blackhole (live frames lost in transit), one
busy worker SIGKILLed mid-stage — the merged table must hold driver
samples for the query AND executor-stamped samples, with
recovered_samples > 0 proving the dead worker's tail arrived via its
sidecar spill. (3) a profiler on/off A/B over the pooled catalogue gated
below 2%.

Each cell installs one deterministic fault spec (fail the first N calls
of one KNOWN_POINTS prefix), runs a full driver-path query, and diffs
the answer against the pandas oracle. A cell is

  recovered        fault(s) fired, answer matches the oracle
  no_fire          the query never crossed that injection point
  classified_fail  the run raised — recorded with its taxonomy category
                   (acceptable only for kinds the ladder can't absorb)
  wrong_answer     fault fired AND the answer diverged — the one outcome
                   the harness exists to catch; fails the soak

After every cell the work dir must hold no orphan artifacts and the
MemManager no leaked reservations. The overhead section times the
disabled-path `inject()` (one truthiness check) and a full disabled vs.
armed-but-never-firing catalogue pass, backing the "disabled points are
free" claim.

Every query runs through the port's `run_plan` on `--device` (default
`cuda`; without a card and without `--device cpu` the soak refuses to
start). Child drivers, standbys and pool workers are given the same
device. The cells, outcomes and gates are the JAX package's
tools/chaos_soak.py's, so the two soaks' records compare cell by cell.

    python -m blaze_tpu_torch.tools.chaos_soak --device cpu \
        --kinds io,oom,stall --stall-ms 300 --json-out faults.json
"""

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# where every query of the soak runs; main() sets it from --device
DEVICE = "cuda"

QUERIES = [  # (name, join mode) — scan/agg/join coverage of KNOWN_POINTS
    ("q1_scan_filter_project", "bhj"),
    ("q2_q06_core_agg", "bhj"),
    ("q3_join_agg_sort", "smj"),
]
KINDS = ("io", "oom")


def _run_cell(tables, query, mode, spec):
    from blaze_tpu_torch.runtime import artifacts, faults, pipeline
    from blaze_tpu_torch.runtime import memory as M
    from blaze_tpu_torch.spark import validator
    from blaze_tpu_torch.spark.local_runner import run_plan

    paths, frames = tables
    plan, oracle = validator.QUERIES[query](paths, frames, mode)
    faults.install(spec)
    info = {}
    work_dir = tempfile.mkdtemp(prefix="chaos_cell_")
    t0 = time.time()
    cell = {"query": query, "mode": mode}
    try:
        out = run_plan(plan, num_partitions=4, work_dir=work_dir,
                       mesh_exchange="off", device=DEVICE, run_info=info)
        diff = validator._compare(
            validator._to_pandas(out).reset_index(drop=True),
            oracle().reset_index(drop=True))
        if info.get("faults_injected", 0) == 0:
            cell["outcome"] = "no_fire" if diff is None else "wrong_answer"
        else:
            cell["outcome"] = "recovered" if diff is None else "wrong_answer"
        if diff is not None:
            cell["diff"] = diff
    except Exception as e:  # noqa: BLE001 — the soak records, not raises
        cell["outcome"] = "classified_fail"
        cell["error_category"] = faults.classify(e)
        cell["error"] = f"{type(e).__name__}: {e}"[:300]
    finally:
        faults.install(None)
    cell["seconds"] = round(time.time() - t0, 3)
    for k in ("faults_injected", "retries", "degradations", "ladder_rung",
              "task_fallbacks", "stalls_injected", "hangs_detected",
              "deadline_kills", "speculations_launched", "speculations_won",
              "breaker_trips", "breaker_reroutes", "pipeline_streams",
              "kernel_launches"):
        if info.get(k):
            cell[k] = info[k]
    cell["orphans"] = artifacts.find_orphans([work_dir])
    cell["mem_leaked"] = int(M.get_manager().mem_used())
    cell["pipeline_leaked"] = pipeline.live_streams()
    shutil.rmtree(work_dir, ignore_errors=True)
    return cell


# representative fault points for the concurrent service rounds (the
# full KNOWN_POINTS x kind sweep lives in the sequential/supervisor
# soaks; the service gate is about isolation under concurrency, so it
# covers the operator, serde, spill, and exchange layers once each)
SERVICE_POINTS = ("op", "serde.encode", "spill.write", "exchange.stage",
                  "shuffle.commit")


def _leaks(work_dirs):
    from blaze_tpu_torch.runtime import artifacts, pipeline, resources
    from blaze_tpu_torch.runtime import memory as M

    return {
        "orphans": artifacts.find_orphans(list(work_dirs)),
        "mem_leaked": int(M.get_manager().mem_used()),
        "pipeline_leaked": pipeline.live_streams(),
        # query-namespaced registrations ("<qid>/shuffle:3") must all be
        # popped by each run's cleanup — a leftover means one session's
        # teardown missed a resource another session could collide with
        "resource_leaked": [k for k in resources.keys() if "/" in k],
    }


def _run_service_round(tables, name, n_queries, n_tenants, spec,
                       max_concurrent=None, queue_depth=None):
    """One round: n_queries client THREADS (round-robined across
    n_tenants tenants and the mini-catalogue) each pushing a session
    through QueryService.run — admission parks/sheds on the client
    thread, exactly the overload shape the service exists for."""
    import threading

    from blaze_tpu_torch.runtime import faults
    from blaze_tpu_torch.runtime.service import QueryService
    from blaze_tpu_torch.spark import validator

    paths, frames = tables
    faults.install(spec)
    round_rec = {"round": name}
    results = [None] * n_queries
    work_dirs = []
    t0 = time.time()

    def client(i, svc, query, mode, tenant, plan, oracle, wd):
        info = {}
        q = {"query": query, "tenant": tenant}
        try:
            out = svc.run(plan, tenant, run_info=info,
                          num_partitions=4, work_dir=wd,
                          mesh_exchange="off", device=DEVICE)
            diff = validator._compare(
                validator._to_pandas(out).reset_index(drop=True),
                oracle().reset_index(drop=True))
            if diff is not None:
                q["outcome"] = "wrong_answer"
                q["diff"] = diff
            elif info.get("faults_injected", 0):
                q["outcome"] = "recovered"
            else:
                q["outcome"] = "clean_ok"
        except faults.AdmissionRejected:
            q["outcome"] = "rejected_at_admission"
        except Exception as e:  # noqa: BLE001 — the soak records, not raises
            q["outcome"] = "classified_fail"
            q["error_category"] = faults.classify(e)
            q["error"] = f"{type(e).__name__}: {e}"[:300]
        q["faults_injected"] = info.get("faults_injected", 0)
        q["breaker_trips"] = info.get("breaker_trips", 0)
        q["breaker_reroutes"] = info.get("breaker_reroutes", 0)
        if info.get("admission_outcome"):
            q["admission_outcome"] = info["admission_outcome"]
        results[i] = q

    try:
        with QueryService(max_concurrent=max_concurrent,
                          queue_depth=queue_depth) as svc:
            threads = []
            for i in range(n_queries):
                query, mode = QUERIES[i % len(QUERIES)]
                tenant = f"tenant{i % n_tenants}"
                plan, oracle = validator.QUERIES[query](paths, frames, mode)
                wd = tempfile.mkdtemp(prefix="svc_cell_")
                work_dirs.append(wd)
                threads.append(threading.Thread(
                    target=client,
                    args=(i, svc, query, mode, tenant, plan, oracle, wd)))
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
            round_rec["queries"] = [q for q in results if q is not None]
            round_rec["stats"] = svc.stats()
            if svc.scheduler is not None:
                counts = {}
                for tenant, _qid, _what in svc.scheduler.dispatch_log:
                    counts[tenant] = counts.get(tenant, 0) + 1
                round_rec["dispatches_by_tenant"] = counts
    finally:
        faults.install(None)
    round_rec["seconds"] = round(time.time() - t0, 3)
    round_rec.update(_leaks(work_dirs))
    for wd in work_dirs:
        shutil.rmtree(wd, ignore_errors=True)
    # breaker isolation: an unfaulted session must never have been
    # rerouted by a neighbor's breaker — trips/reroutes are per-query
    round_rec["isolation_violations"] = [
        q for q in round_rec["queries"]
        if q.get("faults_injected", 0) == 0
        and (q.get("breaker_trips", 0) or q.get("breaker_reroutes", 0))]
    return round_rec


def _fairness_probe():
    """Deterministic stride-scheduling check: one worker held at a gate,
    a weight-3 and a weight-1 session each enqueue equal work, and the
    dispatch order must give the heavy session ~3x the early share.
    Total dispatch counts can't show this (all submitted work runs
    eventually); ORDER under contention is the fairness observable."""
    import threading

    from blaze_tpu_torch.runtime.service import QuerySession
    from blaze_tpu_torch.runtime.supervisor import FairScheduler

    sched = FairScheduler(width=1)
    try:
        gate = threading.Event()
        sched.submit(QuerySession("gate", 1.0, sched), gate.wait,
                     what="gate")
        time.sleep(0.05)  # the worker picks up the gate and blocks
        hi = QuerySession("heavy", 3.0, sched)
        lo = QuerySession("light", 1.0, sched)
        futs = [sched.submit(hi, lambda: None, what="hi")
                for _ in range(12)]
        futs += [sched.submit(lo, lambda: None, what="lo")
                 for _ in range(12)]
        gate.set()
        for f in futs:
            f.result(timeout=30)
        first8 = [t for t, _q, w in sched.dispatch_log
                  if w != "gate"][:8]
        n_hi, n_lo = first8.count("heavy"), first8.count("light")
        return {"round": "fairness_probe", "queries": [],
                "first8_heavy": n_hi, "first8_light": n_lo,
                "fairness_ok": n_hi >= 2 * n_lo,
                "orphans": [], "mem_leaked": 0, "pipeline_leaked": 0,
                "resource_leaked": [], "isolation_violations": [],
                "seconds": 0.1}
    finally:
        sched.close()


def _service_soak(tables, args):
    """The --service sweep: clean round, fairness probe, per-(point,
    kind) fault rounds, and an admission-stress round."""
    rounds = []
    n, k = args.concurrent_queries, args.tenants

    rounds.append(_run_service_round(tables, "clean", n, k, None))
    rounds.append(_fairness_probe())

    for point in SERVICE_POINTS:
        for kind in KINDS:
            spec = {"seed": args.seed, "concurrent": True,
                    "points": {point: {"fail_times": args.fail_times,
                                       "kind": kind}}}
            r = _run_service_round(tables, f"{point}:{kind}", n, k, spec)
            rounds.append(r)
            print(f"[round] {point:15s} {kind:5s} "
                  + " ".join(sorted({q['outcome'] for q in r['queries']}))
                  + f" {r['seconds']:.1f}s", flush=True)

    stress = _run_service_round(tables, "admission_stress", n, k, None,
                                max_concurrent=1, queue_depth=1)
    shed = [q for q in stress["queries"]
            if q["outcome"] == "rejected_at_admission"]
    stress["shed_count"] = len(shed)
    # 1 slot + 1 parked against n submitters: overload MUST shed
    stress["shedding_ok"] = (len(shed) > 0) if n > 2 else True
    rounds.append(stress)
    return rounds


def _executor_kill_round(tables, kind, flight_dir, seed_tag):
    """One kill-recovery round: run the q3 catalogue query with a 2-seat
    executor pool active, fire the `kind` fault at the first executor
    seen busy mid-stage, and demand (a) the answer still matches the
    pandas oracle, (b) exactly one executor_death dossier for the kill,
    (c) the admission capacity timeline shrinks then recovers, and
    (d) zero leaked resources or orphan artifacts.

    kinds: sigkill (process dies — one dossier) | sigterm (graceful
    drain: in-flight work finishes, NO dossier, seat respawns) | hung
    (stops heartbeating without dying — the zombie; its late results
    must be epoch-fenced)."""
    import signal
    import threading

    from blaze_tpu_torch.config import conf
    from blaze_tpu_torch.runtime import executor_pool as ep
    from blaze_tpu_torch.runtime import flight_recorder
    from blaze_tpu_torch.spark import validator
    from blaze_tpu_torch.spark.local_runner import run_plan

    paths, frames = tables
    plan, oracle = validator.QUERIES["q3_join_agg_sort"](paths, frames,
                                                         "smj")
    saved = {k: getattr(conf, k) for k in
             ("flight_dir", "executor_death_ms", "executor_heartbeat_ms",
              "executor_drain_grace_ms")}
    conf.flight_dir = flight_dir
    conf.executor_death_ms = 800
    conf.executor_heartbeat_ms = 50
    if kind == "sigterm":
        # the SIGTERM lands in a cold worker's first plan task, which
        # starts the engine first (torch's import and the CUDA context:
        # 6.8-9.1 s on an H100 host, past the 5 s default grace); the
        # drain must wait that out to finish the task, as the rolling
        # drain round's grace does
        conf.executor_drain_grace_ms = 30_000
    rec = {"round": f"kill_{kind}_{seed_tag}", "kind": kind}
    timeline = []
    work_dir = tempfile.mkdtemp(prefix="chaos_exec_")
    t0 = time.time()
    pool = ep.ExecutorPool(count=2, slots=2)
    try:
        pool.start()
        t_start = time.monotonic()
        timeline.append((0.0, pool.capacity()))
        pool.on_membership(lambda p: timeline.append(
            (round(time.monotonic() - t_start, 3), p.capacity())))
        ep.activate(pool)
        info = {}
        box = {}

        def run():
            try:
                box["out"] = run_plan(plan, num_partitions=4,
                                      work_dir=work_dir,
                                      mesh_exchange="off", run_info=info,
                                      device=DEVICE)
            except Exception as e:  # noqa: BLE001 — recorded below
                box["err"] = e

        t = threading.Thread(target=run)
        t.start()
        # fire at the first busy executor; cold workers pay the torch
        # import + CUDA context on their first task, so the window is wide
        fired = False
        deadline = time.monotonic() + 120
        while not fired and t.is_alive() and time.monotonic() < deadline:
            busy = pool.busy_pids()
            if busy:
                seat, pid = next(iter(busy.items()))
                if kind == "sigkill":
                    os.kill(pid, signal.SIGKILL)
                elif kind == "sigterm":
                    os.kill(pid, signal.SIGTERM)
                else:
                    pool.hang_executor(seat, 3000)
                fired = True
            else:
                time.sleep(0.002)
        t.join(timeout=300)
        rec["fired"] = fired
        if "err" in box:
            rec["outcome"] = "classified_fail"
            rec["error"] = f"{type(box['err']).__name__}: {box['err']}"[:300]
        elif not fired:
            rec["outcome"] = "no_fire"
        else:
            diff = validator._compare(
                validator._to_pandas(box["out"]).reset_index(drop=True),
                oracle().reset_index(drop=True))
            rec["outcome"] = "recovered" if diff is None else "wrong_answer"
            if diff is not None:
                rec["diff"] = diff
        # let the respawn land so the timeline shows the recovery edge
        deadline = time.monotonic() + 30
        while pool.live_count() < 2 and time.monotonic() < deadline:
            time.sleep(0.05)
        # the hung worker wakes ~3s in and sends its stale result; give
        # the fence a beat to reject it before reading the counters
        if kind == "hung":
            time.sleep(3.5)
        rec["pool_stages"] = info.get("pool_stages", 0)
        rec["stats"] = pool.stats()
        deaths = [d for d in flight_recorder.list_dossiers(flight_dir)
                  if d.get("trigger") == "executor_death"]
        rec["death_dossiers"] = len(deaths)
        rec["capacity_timeline"] = timeline
        caps = [c for _t, c in timeline]
        rec["capacity_shrank"] = fired and min(caps) < caps[0]
        rec["capacity_recovered"] = pool.capacity() == caps[0]
        if kind == "sigterm":
            # SIGTERM is a graceful decommission now: the worker drains
            # (finishes in-flight, flushes telemetry, exits 0) and the
            # seat respawns — NO executor_death dossier, no requeues
            # attributed to the drain
            rec["dossier_ok"] = (not fired) or (
                len(deaths) == 0
                and rec["stats"].get("drains_total", 0) >= 1
                and rec["stats"].get("drain_requeues_total", 0) == 0)
        else:
            rec["dossier_ok"] = (not fired) or len(deaths) == 1
    finally:
        ep.deactivate(pool)
        pool.close()
        for k, v in saved.items():
            setattr(conf, k, v)
    rec["seconds"] = round(time.time() - t0, 3)
    rec.update(_leaks([work_dir]))
    shutil.rmtree(work_dir, ignore_errors=True)
    return rec


def _executor_soak(tables, args):
    """The --executors sweep:

    1. weak-scaling smoke at 1/2/4 executors — work grows with the seat
       count (6 fixed-length tasks per seat), so ideal wall time is flat
       and task throughput must scale; the 4-seat pool must beat the
       1-seat pool.
    2. a pooled catalogue-correctness round per seat count — every
       answer diffed against the pandas oracle, with at least one stage
       actually carried by the pool.
    3. kill-recovery rounds: SIGKILL, SIGTERM, and the hung/zombie
       variant fired at a busy executor mid-stage.
    """
    from blaze_tpu_torch.runtime import executor_pool as ep
    from blaze_tpu_torch.runtime import flight_recorder
    from blaze_tpu_torch.spark import validator
    from blaze_tpu_torch.spark.local_runner import run_plan

    paths, frames = tables
    rounds = []

    # -- 1. weak scaling ------------------------------------------------
    scaling = []
    for n in (1, 2, 4):
        pool = ep.ExecutorPool(count=n, slots=2)
        try:
            pool.start()
            # warm: the first round-trip per worker absorbs socket setup
            pool.run_tasks([ep.PoolTaskSpec(f"warm:{i}", "echo",
                                            {"value": i})
                            for i in range(n)], timeout=120)
            tasks = 6 * n
            specs = [ep.PoolTaskSpec(f"scale:{i}", "sleep", {"ms": 150})
                     for i in range(tasks)]
            t0 = time.time()
            pool.run_tasks(specs, timeout=120)
            wall = time.time() - t0
            scaling.append({"executors": n, "slots": 2, "tasks": tasks,
                            "seconds": round(wall, 3),
                            "throughput_tps": round(tasks / wall, 2)})
            print(f"[scale] {n} executors: {tasks} tasks in {wall:.2f}s "
                  f"({tasks / wall:.1f} tasks/s)", flush=True)
        finally:
            pool.close()
    rounds.append({"round": "weak_scaling", "cells": scaling,
                   "scaling_ok": (scaling[-1]["throughput_tps"]
                                  > scaling[0]["throughput_tps"])})

    # -- 2. pooled catalogue correctness ---------------------------------
    for n in (1, 2, 4):
        pool = ep.ExecutorPool(count=n, slots=2)
        rec = {"round": f"pooled_catalogue_{n}x", "executors": n,
               "queries": []}
        work_dirs = []
        t0 = time.time()
        try:
            pool.start()
            ep.activate(pool)
            for query, mode in QUERIES:
                plan, oracle = validator.QUERIES[query](paths, frames, mode)
                info = {}
                wd = tempfile.mkdtemp(prefix="chaos_exec_")
                work_dirs.append(wd)
                q = {"query": query}
                try:
                    out = run_plan(plan, num_partitions=4, work_dir=wd,
                                   mesh_exchange="off", run_info=info,
                                   device=DEVICE)
                    diff = validator._compare(
                        validator._to_pandas(out).reset_index(drop=True),
                        oracle().reset_index(drop=True))
                    q["outcome"] = ("clean_ok" if diff is None
                                    else "wrong_answer")
                    if diff is not None:
                        q["diff"] = diff
                except Exception as e:  # noqa: BLE001 — recorded
                    q["outcome"] = "classified_fail"
                    q["error"] = f"{type(e).__name__}: {e}"[:300]
                q["pool_stages"] = info.get("pool_stages", 0)
                rec["queries"].append(q)
            rec["stats"] = pool.stats()
        finally:
            ep.deactivate(pool)
            pool.close()
        rec["seconds"] = round(time.time() - t0, 3)
        rec["pool_carried_stages"] = sum(
            q["pool_stages"] for q in rec["queries"])
        rec.update(_leaks(work_dirs))
        for wd in work_dirs:
            shutil.rmtree(wd, ignore_errors=True)
        print(f"[pooled] {n}x: "
              + " ".join(sorted({q['outcome'] for q in rec['queries']}))
              + f" pool_stages={rec['pool_carried_stages']} "
              f"{rec['seconds']:.1f}s", flush=True)
        rounds.append(rec)

    # -- 3. kill-recovery ------------------------------------------------
    flight_root = tempfile.mkdtemp(prefix="chaos_flight_")
    for i, kind in enumerate(("sigkill", "sigterm", "hung")):
        fd = os.path.join(flight_root, kind)
        r = _executor_kill_round(tables, kind, fd, f"r{i}")
        rounds.append(r)
        print(f"[kill]  {kind:8s} {r['outcome']:15s} "
              f"dossiers={r['death_dossiers']} "
              f"capacity={r['capacity_timeline']} {r['seconds']:.1f}s",
              flush=True)
    shutil.rmtree(flight_root, ignore_errors=True)
    return rounds


# wire-fault cells for the --network sweep: every net.* point crossed
# with the kinds its transport layer must absorb. blackhole cells carry
# a short ms so a cell costs a stall, not the 2s default.
NET_CELLS = (
    ("net.control.send", ("delay", "reset", "torn", "dup", "blackhole")),
    ("net.control.recv", ("delay", "reset", "torn", "dup", "blackhole")),
    ("net.shuffle.fetch", ("delay", "reset", "torn", "dup", "blackhole")),
    ("net.telemetry", ("delay", "reset", "dup")),
)


def _net_cell(tables, pool, point, kind, seed):
    """One armed wire-fault cell against the SHARED warm pool: run the
    q3 catalogue query with {point: kind} armed driver-side and demand
    an oracle-equal answer, zero leaks, and zero executor deaths — a
    transient wire fault costs a retry/reconnect, never a seat."""
    from blaze_tpu_torch.runtime import artifacts, faults, pipeline
    from blaze_tpu_torch.runtime import memory as M
    from blaze_tpu_torch.spark import validator
    from blaze_tpu_torch.spark.local_runner import run_plan

    paths, frames = tables
    plan, oracle = validator.QUERIES["q3_join_agg_sort"](paths, frames,
                                                         "smj")
    rule = {"kind": kind, "fail_times": 2}
    if kind == "blackhole":
        rule["ms"] = 400
    spec = {"seed": seed, "points": {point: rule}, "concurrent": True}
    deaths0 = pool.stats()["deaths_total"]
    faults.install(spec)
    cell = {"point": point, "kind": kind, "query": "q3_join_agg_sort"}
    info = {}
    work_dir = tempfile.mkdtemp(prefix="chaos_net_")
    t0 = time.time()
    try:
        out = run_plan(plan, num_partitions=4, work_dir=work_dir,
                       mesh_exchange="off", device=DEVICE, run_info=info)
        diff = validator._compare(
            validator._to_pandas(out).reset_index(drop=True),
            oracle().reset_index(drop=True))
        # fired = the schedule actually injected (the control points also
        # fire on beat frames, which run_info's per-query counter misses)
        fired = len(faults.injection_log)
        if fired == 0:
            cell["outcome"] = "no_fire" if diff is None else "wrong_answer"
        else:
            cell["outcome"] = ("recovered" if diff is None
                               else "wrong_answer")
        cell["fired"] = fired
        if diff is not None:
            cell["diff"] = diff
    except Exception as e:  # noqa: BLE001 — the soak records, not raises
        cell["outcome"] = "classified_fail"
        cell["fired"] = len(faults.injection_log)
        cell["error"] = f"{type(e).__name__}: {e}"[:300]
    finally:
        faults.install(None)
    cell["seconds"] = round(time.time() - t0, 3)
    cell["pool_stages"] = info.get("pool_stages", 0)
    cell["deaths"] = pool.stats()["deaths_total"] - deaths0
    cell["orphans"] = artifacts.find_orphans([work_dir])
    cell["mem_leaked"] = int(M.get_manager().mem_used())
    cell["pipeline_leaked"] = pipeline.live_streams()
    shutil.rmtree(work_dir, ignore_errors=True)
    return cell


def _net_shuffle_cell(kind, seed):
    """net.shuffle.fetch cells exercise the fetch protocol DIRECTLY
    (server + client in-process): the pooled catalogue's reduce reads
    run driver-side, so worker-side socket fetches don't occur on every
    plan shape — but the client's bounded retry ladder must still
    survive every wire-fault kind and return byte-exact segments."""
    import tempfile as _tf

    from blaze_tpu_torch.runtime import faults
    from blaze_tpu_torch.runtime import shuffle_server as ss

    rule = {"kind": kind, "fail_times": 2}
    if kind == "blackhole":
        rule["ms"] = 300
    spec = {"seed": seed, "points": {"net.shuffle.fetch": rule},
            "concurrent": True}
    cell = {"point": "net.shuffle.fetch", "kind": kind,
            "query": "fetch_protocol", "deaths": 0, "orphans": [],
            "mem_leaked": 0, "pipeline_leaked": 0}
    t0 = time.time()
    sock_dir = _tf.mkdtemp(prefix="chaos_net_shf_")
    server = ss.ShuffleServer(os.path.join(sock_dir, "shf.sock"))
    server.start()
    try:
        payloads = [os.urandom(1 << 14) for _ in range(3)]
        for i, p in enumerate(payloads):
            server.register_frames(f"cell:{i}", [p])
        faults.install(spec)
        try:
            client = ss.ShuffleClient(server.sock_path)
            try:
                ok = all(client.fetch(f"cell:{i % 3}", 0)
                         == payloads[i % 3] for i in range(6))
            finally:
                client.close()
            fired = len(faults.injection_log)
            cell["fired"] = fired
            if not ok:
                cell["outcome"] = "wrong_answer"
            elif fired == 0:
                cell["outcome"] = "no_fire"
            else:
                cell["outcome"] = "recovered"
        except Exception as e:  # noqa: BLE001 — the soak records
            cell["outcome"] = "classified_fail"
            cell["fired"] = len(faults.injection_log)
            cell["error"] = f"{type(e).__name__}: {e}"[:300]
        finally:
            faults.install(None)
        cell["conns_dropped"] = server.conns_dropped
    finally:
        server.close()
        shutil.rmtree(sock_dir, ignore_errors=True)
    cell["seconds"] = round(time.time() - t0, 3)
    return cell


def _net_reconnect_round(tables, flight_dir):
    """Transient control-socket reset: sever a busy seat's control
    connection driver-side mid-query. The contract: reconnect + resume
    — the answer stays oracle-equal, capacity NEVER dips, no
    executor_death dossier is cut, and a control_reconnect event lands
    in the trace."""
    import threading

    from blaze_tpu_torch.config import conf
    from blaze_tpu_torch.runtime import executor_pool as ep
    from blaze_tpu_torch.runtime import flight_recorder, trace
    from blaze_tpu_torch.spark import validator
    from blaze_tpu_torch.spark.local_runner import run_plan

    paths, frames = tables
    plan, oracle = validator.QUERIES["q3_join_agg_sort"](paths, frames,
                                                         "smj")
    saved = {k: getattr(conf, k) for k in ("flight_dir", "trace_enabled")}
    conf.flight_dir = flight_dir
    conf.trace_enabled = True
    rec = {"round": "control_reset_reconnect"}
    timeline = []
    work_dir = tempfile.mkdtemp(prefix="chaos_net_")
    t0 = time.time()
    pool = ep.ExecutorPool(count=2, slots=2)
    try:
        pool.start()
        t_start = time.monotonic()
        timeline.append((0.0, pool.capacity()))
        pool.on_membership(lambda p: timeline.append(
            (round(time.monotonic() - t_start, 3), p.capacity())))
        ep.activate(pool)
        info, box = {}, {}

        def run():
            try:
                box["out"] = run_plan(plan, num_partitions=4,
                                      work_dir=work_dir,
                                      mesh_exchange="off", run_info=info,
                                      device=DEVICE)
            except Exception as e:  # noqa: BLE001 — recorded below
                box["err"] = e

        t = threading.Thread(target=run)
        t.start()
        fired = False
        deadline = time.monotonic() + 120
        while not fired and t.is_alive() and time.monotonic() < deadline:
            busy = pool.busy_pids()
            if busy:
                seat = next(iter(busy))
                fired = pool.break_conn(seat)
            else:
                time.sleep(0.002)
        t.join(timeout=300)
        rec["fired"] = fired
        if "err" in box:
            rec["outcome"] = "classified_fail"
            rec["error"] = f"{type(box['err']).__name__}: {box['err']}"[:300]
        elif not fired:
            rec["outcome"] = "no_fire"
        else:
            diff = validator._compare(
                validator._to_pandas(box["out"]).reset_index(drop=True),
                oracle().reset_index(drop=True))
            rec["outcome"] = ("recovered" if diff is None
                              else "wrong_answer")
            if diff is not None:
                rec["diff"] = diff
        # let the resume settle before reading the counters
        deadline = time.monotonic() + 10
        while (fired and pool.stats()["reconnects_total"] == 0
               and time.monotonic() < deadline):
            time.sleep(0.05)
        rec["stats"] = pool.stats()
        rec["capacity_timeline"] = timeline
        caps = [c for _t, c in timeline]
        rec["capacity_stable"] = min(caps) == caps[0]
        deaths = [d for d in flight_recorder.list_dossiers(flight_dir)
                  if d.get("trigger") == "executor_death"]
        rec["death_dossiers"] = len(deaths)
        kinds = {r.get("kind") for r in trace.TRACE.snapshot()
                 if r.get("type") == "event"}
        rec["control_reconnect_event"] = "control_reconnect" in kinds
        rec["reconnect_ok"] = (not fired) or (
            rec["stats"]["reconnects_total"] >= 1
            and rec["stats"]["deaths_total"] == 0
            and len(deaths) == 0
            and rec["capacity_stable"]
            and rec["control_reconnect_event"])
    finally:
        ep.deactivate(pool)
        pool.close()
        for k, v in saved.items():
            setattr(conf, k, v)
    rec["seconds"] = round(time.time() - t0, 3)
    rec.update(_leaks([work_dir]))
    shutil.rmtree(work_dir, ignore_errors=True)
    return rec


def _net_partition_round(tables, flight_dir):
    """Asymmetric partition PAST the lease: a busy worker keeps
    receiving but none of its sends reach the driver for longer than
    executor_death_ms. Both ends must give up on the same schedule —
    the driver cuts exactly ONE executor_death dossier (heartbeat) and
    requeues, the worker's lease expires and it self-fences with exit
    code 17, and the query still answers oracle-equal off the surviving
    seat with no double-counted results."""
    import threading

    from blaze_tpu_torch.config import conf
    from blaze_tpu_torch.runtime import executor_pool as ep
    from blaze_tpu_torch.runtime import flight_recorder
    from blaze_tpu_torch.spark import validator
    from blaze_tpu_torch.spark.local_runner import run_plan

    paths, frames = tables
    plan, oracle = validator.QUERIES["q3_join_agg_sort"](paths, frames,
                                                         "smj")
    saved = {k: getattr(conf, k) for k in
             ("flight_dir", "executor_death_ms", "executor_heartbeat_ms")}
    conf.flight_dir = flight_dir
    conf.executor_death_ms = 800
    conf.executor_heartbeat_ms = 50
    rec = {"round": "asymmetric_partition"}
    work_dir = tempfile.mkdtemp(prefix="chaos_net_")
    t0 = time.time()
    pool = ep.ExecutorPool(count=2, slots=2)
    try:
        pool.start()
        ep.activate(pool)
        info, box = {}, {}

        def run():
            try:
                box["out"] = run_plan(plan, num_partitions=4,
                                      work_dir=work_dir,
                                      mesh_exchange="off", run_info=info,
                                      device=DEVICE)
            except Exception as e:  # noqa: BLE001 — recorded below
                box["err"] = e

        t = threading.Thread(target=run)
        t.start()
        fired, proc = False, None
        deadline = time.monotonic() + 120
        while not fired and t.is_alive() and time.monotonic() < deadline:
            busy = pool.busy_pids()
            if busy:
                seat = next(iter(busy))
                # the chaos harness holds the child Popen to read the
                # self-fence exit code after the seat is buried
                with pool._lock:
                    handle = pool._seats.get(seat)
                    proc = handle.proc if handle else None
                fired = pool.partition_executor(seat, 3000)
            else:
                time.sleep(0.002)
        t.join(timeout=300)
        rec["fired"] = fired
        if "err" in box:
            rec["outcome"] = "classified_fail"
            rec["error"] = f"{type(box['err']).__name__}: {box['err']}"[:300]
        elif not fired:
            rec["outcome"] = "no_fire"
        else:
            diff = validator._compare(
                validator._to_pandas(box["out"]).reset_index(drop=True),
                oracle().reset_index(drop=True))
            rec["outcome"] = ("recovered" if diff is None
                              else "wrong_answer")
            if diff is not None:
                rec["diff"] = diff
        # the partitioned worker self-fences at lease expiry (~800ms in)
        exit_code = None
        if proc is not None:
            deadline = time.monotonic() + 30
            while proc.poll() is None and time.monotonic() < deadline:
                time.sleep(0.05)
            exit_code = proc.poll()
        # let the respawn land before reading recovery state
        deadline = time.monotonic() + 30
        while pool.live_count() < 2 and time.monotonic() < deadline:
            time.sleep(0.05)
        rec["stats"] = pool.stats()
        rec["worker_exit_code"] = exit_code
        rec["self_fenced"] = exit_code == 17
        deaths = [d for d in flight_recorder.list_dossiers(flight_dir)
                  if d.get("trigger") == "executor_death"]
        rec["death_dossiers"] = len(deaths)
        rec["partition_ok"] = (not fired) or (
            len(deaths) == 1 and rec["self_fenced"])
    finally:
        ep.deactivate(pool)
        pool.close()
        for k, v in saved.items():
            setattr(conf, k, v)
    rec["seconds"] = round(time.time() - t0, 3)
    rec.update(_leaks([work_dir]))
    shutil.rmtree(work_dir, ignore_errors=True)
    return rec


def _net_rolling_drain_round(tables):
    """Rolling restart of EVERY seat under concurrent service load:
    SIGTERM each executor in turn (graceful drain -> respawn) while
    client threads keep pushing the catalogue through QueryService.
    The gate: 0 failed queries, 0 task requeues attributed to drained
    seats, 0 executor deaths."""
    import signal
    import threading

    from blaze_tpu_torch.config import conf
    from blaze_tpu_torch.runtime import executor_pool as ep
    from blaze_tpu_torch.runtime import faults
    from blaze_tpu_torch.runtime.service import QueryService
    from blaze_tpu_torch.spark import validator
    from blaze_tpu_torch.spark.local_runner import run_plan

    paths, frames = tables
    saved = {"executor_drain_grace_ms": conf.executor_drain_grace_ms}
    # a cold respawned worker pays the torch import and its CUDA
    # context on its first task (6.8-9.1 s on an H100 host);
    # the drain must wait for that, not shed it
    conf.executor_drain_grace_ms = 30_000
    rec = {"round": "rolling_drain_restart"}
    work_dirs = []
    t0 = time.time()
    pool = ep.ExecutorPool(count=2, slots=2)
    try:
        pool.start()
        ep.activate(pool)
        # warm both seats so drains race real work, not torch imports
        plan, _oracle = validator.QUERIES["q1_scan_filter_project"](
            paths, frames, "bhj")
        wd = tempfile.mkdtemp(prefix="chaos_net_")
        work_dirs.append(wd)
        run_plan(plan, num_partitions=4, work_dir=wd, mesh_exchange="off",
                 device=DEVICE)

        n_queries = 6
        results = [None] * n_queries
        with QueryService() as svc:

            def client(i, query, mode, plan, oracle, wd):
                q = {"query": query}
                try:
                    out = svc.run(plan, f"tenant{i % 2}", num_partitions=4,
                                  work_dir=wd, mesh_exchange="off",
                                  device=DEVICE)
                    diff = validator._compare(
                        validator._to_pandas(out).reset_index(drop=True),
                        oracle().reset_index(drop=True))
                    q["outcome"] = ("clean_ok" if diff is None
                                    else "wrong_answer")
                except faults.AdmissionRejected:
                    q["outcome"] = "rejected_at_admission"
                except Exception as e:  # noqa: BLE001 — recorded
                    q["outcome"] = "classified_fail"
                    q["error"] = f"{type(e).__name__}: {e}"[:300]
                results[i] = q

            threads = []
            for i in range(n_queries):
                query, mode = QUERIES[i % len(QUERIES)]
                plan, oracle = validator.QUERIES[query](paths, frames,
                                                        mode)
                wd = tempfile.mkdtemp(prefix="chaos_net_")
                work_dirs.append(wd)
                threads.append(threading.Thread(
                    target=client,
                    args=(i, query, mode, plan, oracle, wd)))
            for t in threads:
                t.start()
            # rolling restart: SIGTERM every seat, one at a time,
            # waiting for each drain -> respawn cycle to complete
            restarted = []
            for seat, pid in sorted(pool.pids().items()):
                os.kill(pid, signal.SIGTERM)
                deadline = time.monotonic() + 120
                while time.monotonic() < deadline:
                    now_pids = pool.pids()
                    if (pool.live_count() == 2
                            and now_pids.get(seat) not in (None, pid)):
                        break
                    time.sleep(0.05)
                restarted.append(seat)
            rec["seats_restarted"] = restarted
            for t in threads:
                t.join(timeout=600)
        rec["queries"] = [q for q in results if q is not None]
        rec["stats"] = pool.stats()
        failed = [q for q in rec["queries"]
                  if q["outcome"] != "clean_ok"]
        rec["failed_queries"] = len(failed)
        rec["rolling_ok"] = (
            len(restarted) == 2
            and not failed
            and rec["stats"]["drains_total"] >= 2
            and rec["stats"]["drain_requeues_total"] == 0
            and rec["stats"]["deaths_total"] == 0)
    finally:
        ep.deactivate(pool)
        pool.close()
        for k, v in saved.items():
            setattr(conf, k, v)
    rec["seconds"] = round(time.time() - t0, 3)
    rec.update(_leaks(work_dirs))
    for wd in work_dirs:
        shutil.rmtree(wd, ignore_errors=True)
    return rec


def _network_soak(tables, args):
    """The --network sweep: (1) every net.* point x
    wire-fault kind armed under a live 2-seat pool, oracle-equal + no
    deaths; (2) transient control reset -> reconnect+resume, capacity
    untouched, no dossier; (3) asymmetric partition past the lease ->
    exactly one dossier + worker self-fence; (4) rolling drain/restart
    of every seat under concurrent service load, zero failed queries."""
    from blaze_tpu_torch.config import conf
    from blaze_tpu_torch.runtime import executor_pool as ep

    rounds = []
    cells = []
    # one SHARED warm pool for the cell sweep: wire faults are transient
    # by contract, so the pool must survive every cell; per-cell pools
    # would also re-pay the worker torch import 20x
    saved_monitor = conf.monitor_enabled
    conf.monitor_enabled = True  # telemetry must flow for net.telemetry
    pool = ep.ExecutorPool(count=2, slots=2)
    try:
        pool.start()
        ep.activate(pool)
        warm = _net_cell(tables, pool, "net.control.send", "delay",
                         args.seed)  # first cell doubles as the warm-up
        warm["warmup"] = True
        cells.append(warm)
        print(f"[net]  warmup {warm['outcome']:15s} "
              f"{warm['seconds']:.1f}s", flush=True)
        for point, kinds in NET_CELLS:
            for kind in kinds:
                if point == "net.shuffle.fetch":
                    cell = _net_shuffle_cell(kind, args.seed)
                else:
                    cell = _net_cell(tables, pool, point, kind, args.seed)
                cells.append(cell)
                print(f"[net]  {point:18s} {kind:9s} "
                      f"{cell['outcome']:15s} fired={cell['fired']} "
                      f"deaths={cell['deaths']} {cell['seconds']:.1f}s",
                      flush=True)
    finally:
        ep.deactivate(pool)
        pool.close()
        conf.monitor_enabled = saved_monitor
    rounds.append({"round": "net_cell_sweep", "cells": cells})

    flight_root = tempfile.mkdtemp(prefix="chaos_net_flight_")
    try:
        r = _net_reconnect_round(tables,
                                 os.path.join(flight_root, "reconnect"))
        rounds.append(r)
        print(f"[net]  control_reset {r['outcome']:15s} "
              f"reconnects={r['stats']['reconnects_total']} "
              f"dossiers={r['death_dossiers']} "
              f"capacity_stable={r['capacity_stable']} "
              f"event={r['control_reconnect_event']} "
              f"{r['seconds']:.1f}s", flush=True)
        r = _net_partition_round(tables,
                                 os.path.join(flight_root, "partition"))
        rounds.append(r)
        print(f"[net]  partition     {r['outcome']:15s} "
              f"dossiers={r['death_dossiers']} "
              f"exit={r['worker_exit_code']} "
              f"self_fenced={r['self_fenced']} {r['seconds']:.1f}s",
              flush=True)
    finally:
        shutil.rmtree(flight_root, ignore_errors=True)
    r = _net_rolling_drain_round(tables)
    rounds.append(r)
    print(f"[net]  rolling_drain restarted={r.get('seats_restarted')} "
          f"failed={r.get('failed_queries')} "
          f"drains={r['stats']['drains_total']} "
          f"drain_requeues={r['stats']['drain_requeues_total']} "
          f"{r['seconds']:.1f}s", flush=True)
    return rounds


def _corruption_sweep(tables, args):
    """--durability corruption cells: CORRUPT_POINTS x catalogue queries.

    Every armed cell must fire (a committed artifact really was
    bit-flipped), be detected by the checksum layer, quarantine the
    corrupt file, and still answer oracle-equal. Shuffle cells must
    additionally lineage-repair (re-run just the producing map task);
    spill cells recover through the task retry ladder instead, so
    `repaired` is not demanded there. Spill cells pin a tiny memory
    budget so the q3 sort actually spills — the corruption hook fires at
    spill READ time, so a query that never spills can't exercise it."""
    from blaze_tpu_torch.runtime import artifacts, faults
    from blaze_tpu_torch.runtime import memory as M

    # q1 is a single scan/filter/project stage — no exchange, no spill —
    # so no corrupt point can fire there; arm only queries whose plans
    # actually cross each point (q2/q3 shuffle; q3's smj sort spills
    # under the tight budget)
    point_queries = {
        "corrupt.shuffle_data": QUERIES[1:],
        "corrupt.shuffle_index": QUERIES[1:],
        "corrupt.spill": [("q3_join_agg_sort", "smj")],
    }
    cells = []
    for point in faults.CORRUPT_POINTS:
        for query, mode in point_queries.get(point, QUERIES[1:]):
            mgr = M.get_manager()
            saved_total = mgr.total
            if point == "corrupt.spill":
                # spill corruption fires at spill READ time; shrink the
                # live manager's budget so the sort really spills
                mgr.total = 1 << 14
            before = dict(artifacts.corruption_stats())
            spec = {"seed": args.seed,
                    "points": {point: {"kind": "corrupt", "nth": 1}}}
            try:
                cell = _run_cell(tables, query, mode, spec)
            finally:
                mgr.total = saved_total
            after = artifacts.corruption_stats()
            delta = {k: after[k] - before.get(k, 0) for k in after}
            cell.update(point=point, kind="corrupt", corruption=delta)
            cell["detected_ok"] = (
                delta["corruptions"] >= 1 and delta["quarantined"] >= 1
                and (point == "corrupt.spill" or delta["repaired"] >= 1))
            cells.append(cell)
            print(f"[cell] {point:20s} corrupt {query:22s} "
                  f"{cell['outcome']:15s} {delta} {cell['seconds']:.1f}s",
                  flush=True)
    cell = _mmap_corruption_cell(args)
    cells.append(cell)
    print(f"[cell] {'corrupt.shuffle_data':20s} corrupt "
          f"{'mmap_fetch':22s} {cell['outcome']:15s} "
          f"{cell['corruption']} {cell['seconds']:.1f}s", flush=True)
    return cells


def _mmap_corruption_cell(args):
    """The zero-copy fast path under corruption: a committed pair whose
    .data was bit-flipped ON DISK (armed `corrupt.shuffle_data` fires at
    commit time) is mmapped by the client; the lazy per-frame CRC must
    detect on first touch, fall back to the socket path — which
    quarantines the pair and lineage-repairs through the registered
    repair hook — and every partition must still answer byte-equal.
    Component-level by necessity: pooled workers run with the fault spec
    stripped, so only a driver-process client can see an armed flip."""
    import struct

    from blaze_tpu_torch.config import conf
    from blaze_tpu_torch.runtime import artifacts, faults, monitor, pipeline
    from blaze_tpu_torch.runtime import memory as M
    from blaze_tpu_torch.runtime import shuffle_server as ss

    saved = (conf.artifact_checksums, conf.shuffle_mmap_enabled,
             conf.monitor_enabled)
    conf.artifact_checksums = True
    conf.shuffle_mmap_enabled = True
    conf.monitor_enabled = True  # the fallback/hit gates read counters
    tmpdir = tempfile.mkdtemp(prefix="chaos_mmap_")
    cell = {"query": "mmap_fetch", "mode": "component",
            "point": "corrupt.shuffle_data", "kind": "corrupt"}
    t0 = time.time()
    payloads = [bytes([65 + p]) * (1 << 12) for p in range(4)]
    frames = [b"BTB1" + struct.pack("<II", len(pl), len(pl)) + pl
              for pl in payloads]
    offsets = [0]
    for fr in frames:
        offsets.append(offsets[-1] + len(fr))

    def commit(name):
        data = os.path.join(tmpdir, f"{name}.data")
        index = os.path.join(tmpdir, f"{name}.index")

        def write(tmp_data, tmp_index):
            with open(tmp_data, "wb") as f:
                f.write(b"".join(frames))
            with open(tmp_index, "wb") as f:
                f.write(struct.pack(f"<{len(offsets)}Q", *offsets))
            return tuple(len(fr) for fr in frames)

        artifacts.commit_shuffle_pair(write, data, index)
        return data, index

    server = client = None
    before = dict(artifacts.corruption_stats())
    try:
        # armed flip fires INSIDE this commit: the pair lands on disk
        # already corrupt, exactly what a torn write looks like to mmap
        faults.install({"seed": args.seed, "points": {
            "corrupt.shuffle_data": {"kind": "corrupt", "nth": 1}}})
        try:
            data, index = commit("pair")
        finally:
            faults.install(None)
        artifacts.register_repair(data, lambda: commit("repaired"))
        server = ss.ShuffleServer(os.path.join(tmpdir, "mmap.sock"))
        server.register_shuffle("chaos/shuffle:0", [(data, index)])
        server.start()
        client = ss.ShuffleClient(server.sock_path)
        zc0 = monitor.zerocopy_stats()
        wrong = 0
        for p, fr in enumerate(frames):
            got = b"".join(bytes(g) for g in
                           client.fetch_frames("chaos/shuffle:0", p))
            if got != fr:
                wrong += 1
        # second pass must ride the REPAIRED pair as mmap hits again
        for p, fr in enumerate(frames):
            got = b"".join(bytes(g) for g in
                           client.fetch_frames("chaos/shuffle:0", p))
            if got != fr:
                wrong += 1
        zc1 = monitor.zerocopy_stats()
        after = artifacts.corruption_stats()
        delta = {k: after[k] - before.get(k, 0) for k in after}
        fell_back = zc1["shuffle_mmap_fallbacks"] - zc0["shuffle_mmap_fallbacks"]
        rehit = zc1["shuffle_mmap_hits"] - zc0["shuffle_mmap_hits"]
        cell["corruption"] = delta
        cell["mmap_fallbacks"] = fell_back
        cell["mmap_hits_after_repair"] = rehit
        cell["outcome"] = "recovered" if wrong == 0 else "wrong_answer"
        cell["detected_ok"] = (
            fell_back >= 1 and rehit >= 1
            and delta["corruptions"] >= 1 and delta["quarantined"] >= 1
            and delta["repaired"] >= 1)
    except Exception as e:  # noqa: BLE001 — the soak records, not raises
        cell["outcome"] = "classified_fail"
        cell["error_category"] = faults.classify(e)
        cell["error"] = f"{type(e).__name__}: {e}"[:300]
        cell.setdefault("corruption", {})
        cell["detected_ok"] = False
    finally:
        if client is not None:
            client.close()
        if server is not None:
            server.close()
        (conf.artifact_checksums, conf.shuffle_mmap_enabled,
         conf.monitor_enabled) = saved
        shutil.rmtree(tmpdir, ignore_errors=True)
    cell["seconds"] = round(time.time() - t0, 3)
    cell["orphans"] = []
    cell["mem_leaked"] = int(M.get_manager().mem_used())
    cell["pipeline_leaked"] = pipeline.live_streams()
    return cell


# the --driver child: a real subprocess driver running the q3 catalogue
# query with journaling on. BLZ_HOLD=1 parks the result stage AFTER all
# map stages have committed and journaled (touching BLZ_READY so the
# parent knows the window is open) — the parent SIGKILLs it there, the
# closest deterministic stand-in for "driver crashes mid-query with
# durable work on disk". The restarted child (BLZ_HOLD=0) must replay
# the journal instead of recomputing.
_DRIVER_CHILD = '''\
import json, os, sys, time
sys.path.insert(0, os.environ["BLZ_REPO"])
DEVICE = os.environ["BLZ_DEVICE"]
from blaze_tpu_torch.config import conf
conf.journal_dir = os.environ["BLZ_JDIR"]
conf.flight_dir = os.environ.get("BLZ_FDIR", "")
conf.trace_enabled = False
from blaze_tpu_torch.spark import validator
from blaze_tpu_torch.spark import local_runner

paths, frames = validator.generate_tables(
    os.environ["BLZ_TDIR"], rows=int(os.environ["BLZ_ROWS"]), seed=7)
if os.environ.get("BLZ_HOLD") == "1":
    real = local_runner._run_result_stage

    def hold(*a, **k):
        with open(os.environ["BLZ_READY"], "w") as f:
            f.write("ready")
        time.sleep(600)  # the parent SIGKILLs inside this window
        return real(*a, **k)

    local_runner._run_result_stage = hold
plan, oracle = validator.QUERIES["q3_join_agg_sort"](paths, frames, "smj")
info = {}
out = local_runner.run_plan(plan, num_partitions=4,
                            work_dir=os.environ["BLZ_WDIR"],
                            mesh_exchange="off", device=DEVICE, run_info=info)
diff = validator._compare(
    validator._to_pandas(out).reset_index(drop=True),
    oracle().reset_index(drop=True))
print("DRIVER_RESULT " + json.dumps({
    "diff": diff,
    "recovered_stages": info.get("recovered_stages", 0),
    "map_tasks_run": info.get("map_tasks_run", 0)}))
'''


def _driver_kill_round(args):
    """--driver round: SIGKILL a subprocess driver mid-query, restart it,
    and demand the restarted driver (a) answers oracle-equal, (b) reuses
    every journaled+verified stage commit (recovered_stages >= 1 and
    ZERO map tasks re-run), (c) bills the crashed attempt failed with a
    `driver_restart` terminal journal record and flight dossier."""
    import glob
    import signal
    import subprocess

    from blaze_tpu_torch.runtime import flight_recorder, journal

    root = tempfile.mkdtemp(prefix="chaos_driver_")
    jdir = os.path.join(root, "journal")
    fdir = os.path.join(root, "flight")
    ready = os.path.join(root, "ready")
    child = os.path.join(root, "driver_child.py")
    with open(child, "w") as f:
        f.write(_DRIVER_CHILD)
    tdir = os.path.join(root, "tables")
    os.makedirs(tdir, exist_ok=True)
    env = dict(os.environ, BLZ_REPO=REPO, BLZ_JDIR=jdir, BLZ_FDIR=fdir,
               BLZ_TDIR=tdir,
               BLZ_WDIR=os.path.join(root, "work"),
               BLZ_READY=ready, BLZ_ROWS=str(args.rows),
               BLZ_HOLD="1", BLZ_DEVICE=DEVICE)
    rec = {"round": "driver_kill"}
    t0 = time.time()
    log1 = open(os.path.join(root, "run1.log"), "w")
    p1 = subprocess.Popen([sys.executable, child], env=env,
                          stdout=log1, stderr=subprocess.STDOUT)
    deadline = time.monotonic() + 300
    while (not os.path.exists(ready) and p1.poll() is None
           and time.monotonic() < deadline):
        time.sleep(0.05)
    rec["held"] = os.path.exists(ready)
    if p1.poll() is None:
        p1.send_signal(signal.SIGKILL)
    p1.wait(timeout=30)
    log1.close()
    rec["killed"] = p1.returncode == -signal.SIGKILL

    jfiles = sorted(glob.glob(os.path.join(jdir, "journal_*.jsonl")))
    rec["stages_committed_before_kill"] = sum(
        1 for jf in jfiles for r in journal.load_records(jf)
        if r.get("kind") == "stage_commit")

    env2 = dict(env, BLZ_HOLD="0")
    try:
        p2 = subprocess.run([sys.executable, child], env=env2,
                            capture_output=True, text=True, timeout=600)
    except subprocess.TimeoutExpired:
        rec["outcome"] = "classified_fail"
        rec["error"] = "restarted driver timed out"
        rec["seconds"] = round(time.time() - t0, 3)
        shutil.rmtree(root, ignore_errors=True)
        return rec
    resume = None
    for line in p2.stdout.splitlines():
        if line.startswith("DRIVER_RESULT "):
            resume = json.loads(line[len("DRIVER_RESULT "):])
    rec["resume"] = resume
    if resume is None:
        rec["restart_output"] = (p2.stdout + p2.stderr)[-2000:]

    rec["restart_dossiers"] = len(
        [d for d in flight_recorder.list_dossiers(fdir)
         if d.get("trigger") == "driver_restart"])
    # the crashed attempt must carry a terminal billed-failed record
    rec["billed_driver_restart"] = sum(
        1 for jf in jfiles for r in journal.load_records(jf)
        if r.get("kind") == "complete"
        and r.get("error") == "driver_restart")
    ok = (rec["held"] and rec["killed"]
          and rec["stages_committed_before_kill"] >= 1
          and resume is not None and resume.get("diff") is None
          and resume.get("recovered_stages", 0) >= 1
          and resume.get("map_tasks_run", -1) == 0
          and rec["restart_dossiers"] == 1
          and rec["billed_driver_restart"] == 1)
    rec["outcome"] = "recovered" if ok else "failed"
    rec["seconds"] = round(time.time() - t0, 3)
    shutil.rmtree(root, ignore_errors=True)
    return rec


def _elastic_scale_round(tables):
    """--elastic round 1: SLO-driven autoscaling through a real burst.

    A 1-seat pool (autoscale_min=1, autoscale_max=3) takes an 8-client
    catalogue burst through QueryService: admission parks the overflow,
    the autoscaler must read the parked arrivals and spawn seats up to
    the ceiling (typed scale_up decisions), and — once the burst drains
    — walk the fleet back down to the floor through the decommission
    drain barrier (typed scale_down decisions). The gate: decisions in
    BOTH directions, the fleet back at autoscale_min, ZERO drain
    requeues (a scale-down must never shed in-flight work), every
    answer oracle-equal, nothing leaked."""
    import threading

    from blaze_tpu_torch.config import conf
    from blaze_tpu_torch.runtime import autoscaler as asc
    from blaze_tpu_torch.runtime import executor_pool as ep
    from blaze_tpu_torch.runtime import faults
    from blaze_tpu_torch.runtime.service import QueryService
    from blaze_tpu_torch.spark import validator

    paths, frames = tables
    saved = {k: getattr(conf, k) for k in (
        "autoscale_enabled", "autoscale_min", "autoscale_max",
        "autoscale_cooldown_ms")}
    conf.autoscale_enabled = True
    conf.autoscale_min = 1
    conf.autoscale_max = 3
    conf.autoscale_cooldown_ms = 400
    rec = {"round": "autoscale_burst"}
    work_dirs = []
    timeline = []
    t0 = time.time()
    pool = ep.ExecutorPool(count=1, slots=2)
    scaler = None
    try:
        pool.start()
        ep.activate(pool)
        t_start = time.monotonic()
        timeline.append((0.0, pool.capacity()))
        pool.on_membership(lambda p: timeline.append(
            (round(time.monotonic() - t_start, 3), p.capacity())))
        n_queries = 8
        results = [None] * n_queries
        with QueryService(queue_depth=16) as svc:
            scaler = asc.Autoscaler(pool, service=svc, tick_s=0.05)
            scaler.start()

            def client(i, query, plan, oracle, wd):
                q = {"query": query}
                try:
                    out = svc.run(plan, f"tenant{i % 2}",
                                  num_partitions=4, work_dir=wd,
                                  mesh_exchange="off", device=DEVICE)
                    diff = validator._compare(
                        validator._to_pandas(out).reset_index(drop=True),
                        oracle().reset_index(drop=True))
                    q["outcome"] = ("clean_ok" if diff is None
                                    else "wrong_answer")
                except faults.AdmissionRejected:
                    q["outcome"] = "rejected_at_admission"
                except Exception as e:  # noqa: BLE001 — recorded
                    q["outcome"] = "classified_fail"
                    q["error"] = f"{type(e).__name__}: {e}"[:300]
                results[i] = q

            threads = []
            for i in range(n_queries):
                query, mode = QUERIES[i % len(QUERIES)]
                plan, oracle = validator.QUERIES[query](paths, frames,
                                                        mode)
                wd = tempfile.mkdtemp(prefix="chaos_elastic_")
                work_dirs.append(wd)
                threads.append(threading.Thread(
                    target=client, args=(i, query, plan, oracle, wd)))
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
            # quiesce: idle utilization below the floor must drain the
            # fleet back to autoscale_min through the decommission
            # barrier (the service stays open so the policy keeps its
            # queue/parked signals)
            deadline = time.monotonic() + 90
            while time.monotonic() < deadline:
                if (scaler.decisions["down"] >= 1
                        and pool.capacity() <= conf.autoscale_min
                        * pool.slots
                        and pool.stats()["draining"] == 0):
                    break
                time.sleep(0.05)
            rec["scaler"] = scaler.state()
        rec["queries"] = [q for q in results if q is not None]
        rec["stats"] = pool.stats()
        rec["capacity_timeline"] = timeline
        caps = [c for _t, c in timeline]
        failed = [q for q in rec["queries"]
                  if q["outcome"] != "clean_ok"]
        rec["failed_queries"] = len(failed)
        rec["elastic_ok"] = (
            scaler.decisions["up"] >= 1
            and scaler.decisions["down"] >= 1
            and max(caps) > caps[0]
            and pool.capacity() == conf.autoscale_min * pool.slots
            and rec["stats"]["drain_requeues_total"] == 0
            and rec["stats"]["deaths_total"] == 0
            and not failed)
    finally:
        if scaler is not None:
            scaler.close()
        ep.deactivate(pool)
        pool.close()
        for k, v in saved.items():
            setattr(conf, k, v)
    rec["seconds"] = round(time.time() - t0, 3)
    rec.update(_leaks(work_dirs))
    for wd in work_dirs:
        shutil.rmtree(wd, ignore_errors=True)
    return rec


# the --elastic primary child: a real subprocess driver owning a 4-seat
# pool with journaling on, a fenced leader lease and a published fleet
# manifest beside the journals. It parks all BLZ_CLIENTS queries in
# their result stage (maps committed + journaled), touches BLZ_READY,
# and sleeps — the parent SIGKILLs it there, then SIGKILLs two of its
# executors from the manifest pids.
_ELASTIC_PRIMARY = '''\
import json, os, sys, threading, time
sys.path.insert(0, os.environ["BLZ_REPO"])
DEVICE = os.environ["BLZ_DEVICE"]
from blaze_tpu_torch.config import conf
conf.journal_dir = os.environ["BLZ_JDIR"]
conf.flight_dir = os.environ["BLZ_FDIR"]
conf.trace_enabled = False
conf.executor_death_ms = 20000   # workers must outlive the driver gap
conf.executor_heartbeat_ms = 100
conf.leader_lease_ms = 1000
from blaze_tpu_torch.runtime import executor_pool as ep
from blaze_tpu_torch.runtime import standby
from blaze_tpu_torch.spark import validator
from blaze_tpu_torch.spark import local_runner

paths, frames = validator.generate_tables(
    os.environ["BLZ_TDIR"], rows=int(os.environ["BLZ_ROWS"]), seed=7)
pool = ep.ExecutorPool(count=4, slots=2)
pool.start()
ep.activate(pool)
lease = standby.LeaderLease(os.environ["BLZ_JDIR"])
lease.acquire()
lease.start_renewing()
standby.wire_manifest(pool, os.environ["BLZ_JDIR"])
# warm every seat before arming the hold: adoption must race real
# work, not torch imports
warm, _ = validator.QUERIES["q1_scan_filter_project"](paths, frames, "bhj")
local_runner.run_plan(warm, num_partitions=4,
                      work_dir=os.path.join(os.environ["BLZ_WDIR"], "warm"),
                      mesh_exchange="off", device=DEVICE)
parked = threading.Semaphore(0)
real = local_runner._run_result_stage

def hold(*a, **k):
    parked.release()
    time.sleep(600)  # the parent SIGKILLs inside this window
    return real(*a, **k)

local_runner._run_result_stage = hold
QUERIES = [("q1_scan_filter_project", "bhj"), ("q2_q06_core_agg", "bhj"),
           ("q3_join_agg_sort", "smj")]

def client(i):
    query, mode = QUERIES[i % len(QUERIES)]
    plan, _ = validator.QUERIES[query](paths, frames, mode)
    local_runner.run_plan(
        plan, num_partitions=4,
        work_dir=os.path.join(os.environ["BLZ_WDIR"], "q%d" % i),
        mesh_exchange="off", device=DEVICE)

n = int(os.environ["BLZ_CLIENTS"])
for i in range(n):
    threading.Thread(target=client, args=(i,), daemon=True).start()
for _ in range(n):
    parked.acquire()
with open(os.environ["BLZ_READY"], "w") as f:
    f.write("ready")
time.sleep(600)
'''

# the --elastic standby child: a warm StandbyDriver on the same journal
# dir. It must detect the primary's death, fence it behind a bumped
# lease epoch, rebind the pool (adopting the two surviving workers,
# respawning the two SIGKILLed ones), replay the dead primary's
# journals, then re-run every query oracle-equal on the adopted fleet.
_ELASTIC_STANDBY = '''\
import json, os, sys, threading, time
sys.path.insert(0, os.environ["BLZ_REPO"])
DEVICE = os.environ["BLZ_DEVICE"]
from blaze_tpu_torch.config import conf
conf.journal_dir = os.environ["BLZ_JDIR"]
conf.flight_dir = os.environ["BLZ_FDIR"]
conf.trace_enabled = False
conf.executor_death_ms = 20000
conf.executor_heartbeat_ms = 100
conf.leader_lease_ms = 1000
from blaze_tpu_torch.runtime import artifacts, standby
from blaze_tpu_torch.spark import validator
from blaze_tpu_torch.spark import local_runner

paths, frames = validator.generate_tables(
    os.environ["BLZ_TDIR"], rows=int(os.environ["BLZ_ROWS"]), seed=7)
sb = standby.StandbyDriver(os.environ["BLZ_JDIR"]).start()
with open(os.environ["BLZ_SREADY"], "w") as f:
    f.write("watching")
if not sb.wait_takeover(120):
    print("STANDBY_RESULT " + json.dumps({"took_over": False}))
    sys.exit(1)
QUERIES = [("q1_scan_filter_project", "bhj"), ("q2_q06_core_agg", "bhj"),
           ("q3_join_agg_sort", "smj")]
n = int(os.environ["BLZ_CLIENTS"])
results = [None] * n

def client(i):
    query, mode = QUERIES[i % len(QUERIES)]
    plan, oracle = validator.QUERIES[query](paths, frames, mode)
    info = {}
    q = {"query": query}
    try:
        out = local_runner.run_plan(
            plan, num_partitions=4,
            work_dir=os.path.join(os.environ["BLZ_WDIR"], "q%d" % i),
            mesh_exchange="off", device=DEVICE, run_info=info)
        q["diff"] = validator._compare(
            validator._to_pandas(out).reset_index(drop=True),
            oracle().reset_index(drop=True))
        q["recovered_stages"] = info.get("recovered_stages", 0)
    except Exception as e:
        q["diff"] = "%s: %s" % (type(e).__name__, e)
        q["recovered_stages"] = 0
    results[i] = q

threads = [threading.Thread(target=client, args=(i,)) for i in range(n)]
for t in threads:
    t.start()
for t in threads:
    t.join(timeout=600)
pool = sb.pool
wdirs = [os.path.join(os.environ["BLZ_WDIR"], "q%d" % i)
         for i in range(n)]
print("STANDBY_RESULT " + json.dumps({
    "took_over": True,
    "takeover": sb.takeover_info,
    "role": standby.role(),
    "queries": results,
    "wrong": sum(1 for r in results if r and r["diff"] is not None),
    "incomplete": sum(1 for r in results if r is None),
    "recovered_stages": sum(r["recovered_stages"] for r in results if r),
    "adopted": getattr(pool, "adopted_total", 0) if pool else 0,
    "live_seats": pool.live_count() if pool else 0,
    "orphans": artifacts.find_orphans(wdirs),
}))
sb.close()
'''


def _elastic_failover_round(args):
    """--elastic round 2: warm-standby driver failover under compound
    loss. SIGKILL the primary driver while it holds 8 journaled queries
    mid-flight, then SIGKILL two of its four executors. The pre-started
    standby must take over (bumped lease epoch, control-plane rebind,
    two workers ADOPTED, two respawned, journals replayed) and answer
    every query oracle-equal — exactly one driver_failover dossier,
    zero orphans."""
    import signal
    import subprocess

    from blaze_tpu_torch.runtime import flight_recorder

    n_clients = 8
    root = tempfile.mkdtemp(prefix="chaos_elastic_ha_")
    jdir = os.path.join(root, "journal")
    fdir = os.path.join(root, "flight")
    ready = os.path.join(root, "ready")
    sready = os.path.join(root, "standby_ready")
    primary = os.path.join(root, "primary_child.py")
    standby_py = os.path.join(root, "standby_child.py")
    with open(primary, "w") as f:
        f.write(_ELASTIC_PRIMARY)
    with open(standby_py, "w") as f:
        f.write(_ELASTIC_STANDBY)
    tdir = os.path.join(root, "tables")
    os.makedirs(tdir, exist_ok=True)
    env = dict(os.environ, BLZ_REPO=REPO, BLZ_JDIR=jdir, BLZ_FDIR=fdir,
               BLZ_TDIR=tdir, BLZ_WDIR=os.path.join(root, "work"),
               BLZ_READY=ready, BLZ_SREADY=sready,
               BLZ_ROWS=str(args.rows), BLZ_CLIENTS=str(n_clients),
               BLZ_DEVICE=DEVICE)
    rec = {"round": "driver_failover", "clients": n_clients}
    t0 = time.time()
    log1 = open(os.path.join(root, "primary.log"), "w")
    p1 = subprocess.Popen([sys.executable, primary], env=env,
                          stdout=log1, stderr=subprocess.STDOUT)
    p2 = None
    try:
        deadline = time.monotonic() + 300
        while (not os.path.exists(ready) and p1.poll() is None
               and time.monotonic() < deadline):
            time.sleep(0.05)
        rec["held"] = os.path.exists(ready)
        # warm standby: started while the primary is still healthy (it
        # waits on the lease), so takeover latency excludes its imports
        p2 = subprocess.Popen([sys.executable, standby_py], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
        deadline = time.monotonic() + 120
        while (not os.path.exists(sready) and p2.poll() is None
               and time.monotonic() < deadline):
            time.sleep(0.05)
        rec["standby_watching"] = os.path.exists(sready)
        manifest = {}
        try:
            with open(os.path.join(jdir, "fleet.manifest.json")) as f:
                manifest = json.load(f)
        except (OSError, ValueError):
            pass
        exec_pids = [int(s["pid"]) for s in manifest.get("seats", [])]
        if p1.poll() is None:
            p1.send_signal(signal.SIGKILL)
        p1.wait(timeout=30)
        rec["killed_primary"] = p1.returncode == -signal.SIGKILL
        killed_execs = []
        for pid in exec_pids[:2]:  # two of the four seats die with it
            try:
                os.kill(pid, signal.SIGKILL)
                killed_execs.append(pid)
            except ProcessLookupError:
                pass
        rec["killed_executors"] = len(killed_execs)
        try:
            out, err = p2.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            p2.kill()
            out, err = p2.communicate()
        res = None
        for line in out.splitlines():
            if line.startswith("STANDBY_RESULT "):
                res = json.loads(line[len("STANDBY_RESULT "):])
        rec["standby"] = res
        if res is None:
            rec["standby_output"] = (out + err)[-2000:]
        rec["failover_dossiers"] = len(
            [d for d in flight_recorder.list_dossiers(fdir)
             if d.get("trigger") == "driver_failover"])
        takeover = (res or {}).get("takeover") or {}
        ok = (rec["held"] and rec["standby_watching"]
              and rec["killed_primary"] and len(killed_execs) == 2
              and res is not None and res.get("took_over")
              and res.get("wrong") == 0 and res.get("incomplete") == 0
              and res.get("adopted") == 2
              and res.get("live_seats") == 4
              and not res.get("orphans")
              and res.get("recovered_stages", 0) >= 1
              and takeover.get("lease_epoch", 0) >= 2
              and takeover.get("journals_replayed", 0) >= 1
              and takeover.get("queries_resumed", 0) >= 1
              and rec["failover_dossiers"] == 1)
        rec["outcome"] = "recovered" if ok else "failed"
    finally:
        log1.close()
        for p in (p1, p2):
            if p is not None and p.poll() is None:
                p.kill()
    rec["seconds"] = round(time.time() - t0, 3)
    shutil.rmtree(root, ignore_errors=True)
    return rec


# the --streaming primary child: a subprocess driver owning a 4-seat
# pool with a fenced leader lease and a published fleet manifest. It
# opens the checkpointed stream as a QueryService session (every
# micro-batch goes through admission), touches BLZ_READY once the first
# checkpoint is durable, and sleeps — the parent SIGKILLs one of its
# executors from the manifest (the stream must keep checkpointing),
# then SIGKILLs the driver itself mid-stream.
_STREAM_PRIMARY = '''\
import os, sys, time
sys.path.insert(0, os.environ["BLZ_REPO"])
DEVICE = os.environ["BLZ_DEVICE"]
from blaze_tpu_torch.config import conf
conf.journal_dir = os.environ["BLZ_JDIR"]
conf.flight_dir = os.environ["BLZ_FDIR"]
conf.trace_enabled = False
conf.executor_death_ms = 20000   # workers must outlive the driver gap
conf.executor_heartbeat_ms = 100
conf.leader_lease_ms = 1000
conf.stream_poll_ms = 50
conf.stream_checkpoint_interval = 1
from blaze_tpu_torch.columnar import types as T
from blaze_tpu_torch.runtime import executor_pool as ep
from blaze_tpu_torch.runtime import standby, streaming
from blaze_tpu_torch.runtime.service import QueryService

pool = ep.ExecutorPool(count=4, slots=2)
pool.start()
ep.activate(pool)
lease = standby.LeaderLease(os.environ["BLZ_JDIR"])
lease.acquire()
lease.start_renewing()
standby.wire_manifest(pool, os.environ["BLZ_JDIR"])
schema = T.Schema([T.Field("k", T.INT64), T.Field("amount", T.FLOAT64)])
spec = streaming.StreamSpec(
    schema, keys=[{"col": "k", "name": "k"}],
    aggs=[{"fn": "sum", "col": "amount", "name": "amount_sum"},
          {"fn": "count", "col": "amount", "name": "n"}])
svc = QueryService(queue_depth=16)
svc.start()
sq = svc.open_stream(streaming.TailSource(os.environ["BLZ_SRC"]), spec,
                     tenant_id="stream", stream_id="stream-chaos",
                     num_partitions=4, work_dir=os.environ["BLZ_WDIR"],
                     mesh_exchange="off", device=DEVICE)
while not (sq.last_checkpoint_epoch >= 1 and len(sq.offsets) >= 1):
    time.sleep(0.05)
with open(os.environ["BLZ_READY"], "w") as f:
    f.write("ready")
time.sleep(600)  # the parent SIGKILLs inside this window
'''

# the --streaming standby child: a warm StandbyDriver on the same
# journal dir. After lease-fenced takeover it must find the dead
# primary's stream ADOPTABLE, resume it from the last committed
# checkpoint, and drain every published file — reporting the final
# aggregation state for the parent's pandas-oracle diff, plus the full
# checkpoint-epoch chain for the monotonicity gate.
_STREAM_STANDBY = '''\
import json, os, sys, time
sys.path.insert(0, os.environ["BLZ_REPO"])
DEVICE = os.environ["BLZ_DEVICE"]
from blaze_tpu_torch.config import conf
conf.journal_dir = os.environ["BLZ_JDIR"]
conf.flight_dir = os.environ["BLZ_FDIR"]
conf.trace_enabled = False
conf.executor_death_ms = 20000
conf.executor_heartbeat_ms = 100
conf.leader_lease_ms = 1000
conf.stream_poll_ms = 50
conf.stream_checkpoint_interval = 1
from blaze_tpu_torch.runtime import journal, standby, streaming

sb = standby.StandbyDriver(os.environ["BLZ_JDIR"]).start()
with open(os.environ["BLZ_SREADY"], "w") as f:
    f.write("watching")
if not sb.wait_takeover(120):
    print("STREAM_RESULT " + json.dumps({"took_over": False}))
    sys.exit(1)
adoptable = sorted(streaming.adoptable_streams())
sq = streaming.resume_stream("stream-chaos",
                             work_dir=os.environ["BLZ_WDIR"] + "_sb",
                             device=DEVICE)
total = None
deadline = time.monotonic() + 300
while time.monotonic() < deadline:
    if total is None and os.path.exists(os.environ["BLZ_FEED_DONE"]):
        with open(os.environ["BLZ_FEED_DONE"]) as f:
            total = int(f.read().strip())
    st = sq.stats()
    if (total is not None and st["files_consumed"] >= total
            and sq.last_checkpoint_epoch >= sq.epoch):
        break
    time.sleep(0.05)
records = journal.load_records(
    journal.journal_path("stream-chaos", os.environ["BLZ_JDIR"]))
print("STREAM_RESULT " + json.dumps({
    "took_over": True,
    "takeover": sb.takeover_info,
    "role": standby.role(),
    "adoptable": adoptable,
    "stats": sq.stats(),
    "rows": sq.result_rows(),
    "checkpoint_epochs": [r["epoch"] for r in records
                          if r.get("kind") == "stream_checkpoint"],
}))
sq.stop(graceful=True)
sb.close()
'''


def _streaming_round(args):
    """--streaming round: a checkpointed micro-batch stream survives an
    executor SIGKILL mid-batch AND a primary-driver SIGKILL with
    warm-standby takeover — resumed from the last committed checkpoint,
    final state oracle-equal to a pandas replay of every published file
    (0 dropped, 0 double-counted), checkpoint epochs strictly monotone
    across both drivers, exactly one driver_failover dossier and no
    driver_restart bill (the stream is adopted, not billed)."""
    import signal
    import subprocess

    import numpy as np
    import pandas as pd
    import pyarrow as pa

    from blaze_tpu_torch.runtime import flight_recorder, journal, streaming
    from blaze_tpu_torch.spark import validator

    root = tempfile.mkdtemp(prefix="chaos_stream_")
    jdir = os.path.join(root, "journal")
    fdir = os.path.join(root, "flight")
    sdir = os.path.join(root, "source")
    ready = os.path.join(root, "ready")
    sready = os.path.join(root, "standby_ready")
    feed_done = os.path.join(root, "feed_done")
    primary = os.path.join(root, "stream_primary.py")
    standby_py = os.path.join(root, "stream_standby.py")
    with open(primary, "w") as f:
        f.write(_STREAM_PRIMARY)
    with open(standby_py, "w") as f:
        f.write(_STREAM_STANDBY)
    env = dict(os.environ, BLZ_REPO=REPO, BLZ_JDIR=jdir, BLZ_FDIR=fdir,
               BLZ_SRC=sdir, BLZ_WDIR=os.path.join(root, "work"),
               BLZ_READY=ready, BLZ_SREADY=sready,
               BLZ_FEED_DONE=feed_done, BLZ_DEVICE=DEVICE)
    src = streaming.TailSource(sdir)
    rng = np.random.default_rng(args.seed)
    frames = []

    def feed(n):
        # the producer side of the stream: numbered immutable files,
        # rename-published — it outlives both driver kills
        for _ in range(n):
            i = len(frames)
            df = pd.DataFrame({
                "k": rng.integers(0, 8, 120).astype("int64"),
                "amount": np.round(rng.normal(50.0, 12.0, 120), 6)})
            frames.append(df)
            src.publish("part-%04d.parquet" % i,
                        pa.Table.from_pandas(df, preserve_index=False))
            time.sleep(0.1)

    def _ckpt_files():
        # files covered by the primary's newest durable checkpoint
        recs = journal.load_records(
            journal.journal_path("stream-chaos", jdir))
        offs = [len(r.get("offsets") or {}) for r in recs
                if r.get("kind") == "stream_checkpoint"]
        return max(offs) if offs else 0

    rec = {"round": "stream_failover"}
    t0 = time.time()
    log1 = open(os.path.join(root, "primary.log"), "w")
    feed(3)
    p1 = subprocess.Popen([sys.executable, primary], env=env,
                          stdout=log1, stderr=subprocess.STDOUT)
    p2 = None
    try:
        deadline = time.monotonic() + 300
        while (not os.path.exists(ready) and p1.poll() is None
               and time.monotonic() < deadline):
            time.sleep(0.05)
        rec["held"] = os.path.exists(ready)
        p2 = subprocess.Popen([sys.executable, standby_py], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
        deadline = time.monotonic() + 120
        while (not os.path.exists(sready) and p2.poll() is None
               and time.monotonic() < deadline):
            time.sleep(0.05)
        rec["standby_watching"] = os.path.exists(sready)
        manifest = {}
        try:
            with open(os.path.join(jdir, "fleet.manifest.json")) as f:
                manifest = json.load(f)
        except (OSError, ValueError):
            pass
        exec_pids = [int(s["pid"]) for s in manifest.get("seats", [])]
        # (a) executor SIGKILL mid-batch: new files keep arriving around
        # the kill, and the PRIMARY must keep committing checkpoints —
        # the failed micro-batch simply re-runs from unconsumed offsets
        feed(2)
        killed_execs = 0
        for pid in exec_pids[:1]:
            try:
                os.kill(pid, signal.SIGKILL)
                killed_execs += 1
            except ProcessLookupError:
                pass
        rec["killed_executors"] = killed_execs
        feed(2)
        before = _ckpt_files()
        deadline = time.monotonic() + 240
        while (_ckpt_files() < len(frames) and p1.poll() is None
               and time.monotonic() < deadline):
            time.sleep(0.1)
        rec["survived_executor_kill"] = _ckpt_files() >= len(frames)
        rec["checkpointed_files_before_driver_kill"] = _ckpt_files()
        rec["checkpointed_files_at_exec_kill"] = before
        # (b) primary driver SIGKILL: the standby must take over and
        # ADOPT the stream; files published after the kill are
        # standby-only input
        if p1.poll() is None:
            p1.send_signal(signal.SIGKILL)
        p1.wait(timeout=30)
        rec["killed_primary"] = p1.returncode == -signal.SIGKILL
        feed(2)
        with open(feed_done, "w") as f:
            f.write(str(len(frames)))
        try:
            out, err = p2.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            p2.kill()
            out, err = p2.communicate()
        res = None
        for line in out.splitlines():
            if line.startswith("STREAM_RESULT "):
                res = json.loads(line[len("STREAM_RESULT "):])
        rec["standby"] = res
        if res is None:
            rec["standby_output"] = (out + err)[-2000:]
        rec["failover_dossiers"] = len(
            [d for d in flight_recorder.list_dossiers(fdir)
             if d.get("trigger") == "driver_failover"])
        rec["restart_dossiers"] = len(
            [d for d in flight_recorder.list_dossiers(fdir)
             if d.get("trigger") == "driver_restart"])
        st = (res or {}).get("stats") or {}
        takeover = (res or {}).get("takeover") or {}
        diff = "no result"
        if res and res.get("rows"):
            got = (pd.DataFrame(res["rows"])[["k", "amount_sum", "n"]]
                   .sort_values("k").reset_index(drop=True))
            want = (pd.concat(frames).groupby("k", as_index=False)
                    .agg(amount_sum=("amount", "sum"),
                         n=("amount", "count"))
                    .sort_values("k").reset_index(drop=True))
            diff = validator._compare(got, want)
        rec["diff"] = diff
        epochs = (res or {}).get("checkpoint_epochs") or []
        rec["epochs_monotone"] = epochs == sorted(set(epochs))
        ok = (rec["held"] and rec["standby_watching"]
              and rec["killed_primary"] and killed_execs == 1
              and rec["survived_executor_kill"]
              and res is not None and res.get("took_over")
              and diff is None
              and st.get("rows_total") == sum(len(f) for f in frames)
              and st.get("files_consumed") == len(frames)
              and st.get("resumed_batches", 0) >= 1
              and st.get("resumed_from_epoch") is not None
              and takeover.get("streams_adoptable", 0) >= 1
              and "stream-chaos" in (res.get("adoptable") or [])
              and rec["epochs_monotone"] and len(epochs) >= 2
              and rec["failover_dossiers"] == 1
              and rec["restart_dossiers"] == 0)
        rec["outcome"] = "recovered" if ok else "failed"
    finally:
        log1.close()
        for p in (p1, p2):
            if p is not None and p.poll() is None:
                p.kill()
    rec["seconds"] = round(time.time() - t0, 3)
    shutil.rmtree(root, ignore_errors=True)
    return rec


def _autopilot_run(tables, run_info=None):
    """One oracle-checked q3 driver run under whatever overlay the
    autopilot currently holds for its fingerprint."""
    from blaze_tpu_torch.spark import validator
    from blaze_tpu_torch.spark.local_runner import run_plan

    paths, frames = tables
    plan, oracle = validator.QUERIES["q3_join_agg_sort"](paths, frames,
                                                         "smj")
    info = dict(run_info or {})
    work_dir = tempfile.mkdtemp(prefix="chaos_ap_cell_")
    t0 = time.time()
    try:
        out = run_plan(plan, num_partitions=4, work_dir=work_dir,
                       mesh_exchange="off", device=DEVICE, run_info=info)
        diff = validator._compare(
            validator._to_pandas(out).reset_index(drop=True),
            oracle().reset_index(drop=True))
    finally:
        shutil.rmtree(work_dir, ignore_errors=True)
    ap = info.get("autopilot") or {}
    return {"seconds": round(time.time() - t0, 3),
            "canary": bool(ap.get("canary")),
            "overlay": ap.get("overlay") or {},
            "fingerprint": ap.get("fingerprint"),
            "diff": diff}


def _p50(xs):
    return sorted(xs)[len(xs) // 2] if xs else 0.0


def _autopilot_converge_round(tables, args):
    """Convergence: a 400ms stall on every serde.encode call makes frame
    count the dominant cost, so the doctor's serde_bound finding (raise
    conf.target_batch_bytes) is RIGHT. The explorer must walk the knob up
    — through the neutral 512KB plateau (inconclusive canary ->
    quarantine -> step over) — and promote a settled overlay whose p50
    beats the base configuration's. Every run stays oracle-equal and no
    (knob, value) is ever proposed twice (no oscillation)."""
    from blaze_tpu_torch.config import conf
    from blaze_tpu_torch.runtime import autopilot, faults, history

    conf.trace_enabled = True  # stage records feed doctor + verdicts
    conf.autopilot_canary_runs = 2
    conf.target_batch_bytes = 1 << 18
    rnd = {"round": "autopilot_converge", "runs": []}
    faults.install({"seed": args.seed, "concurrent": True,
                    "points": {"serde.encode": {"kind": "stall",
                                                "ms": 400}}})
    try:
        # warm jit caches with the plane OFF so the warm run never
        # reaches the history baseline the explorer gates on
        conf.autopilot_enabled = False
        conf.history_dir = ""
        _autopilot_run(tables)
        conf.autopilot_enabled = True
        conf.autopilot_dir = tempfile.mkdtemp(prefix="chaos_ap_store_")
        conf.history_dir = tempfile.mkdtemp(prefix="chaos_ap_hist_")
        autopilot.reset()
        history.reset()
        wrong = 0
        fp = None
        for _ in range(34):
            cell = _autopilot_run(tables)
            rnd["runs"].append({k: cell[k] for k in
                                ("seconds", "canary", "overlay")})
            if cell["diff"] is not None:
                wrong += 1
                rnd.setdefault("diffs", []).append(cell["diff"])
            fp = cell["fingerprint"] or fp
            st = autopilot.active().state_for(fp)
            settled = [r for r in rnd["runs"]
                       if not r["canary"] and r["overlay"] == st.settled]
            base = [r["seconds"] for r in rnd["runs"][:3]]
            if (st.promotions >= 1 and len(settled) >= 3
                    and _p50([r["seconds"] for r in settled[-3:]])
                    < _p50(base) * 0.95):
                break
    finally:
        faults.install(None)
    st = autopilot.active().state_for(fp)
    proposes = [(r["knob"], r["value"])
                for r in autopilot.active().store.load_records()
                if r["kind"] == "propose"]
    settled = [r["seconds"] for r in rnd["runs"]
               if not r["canary"] and r["overlay"] == st.settled]
    rnd.update({
        "wrong_answers": wrong,
        "promotions": st.promotions,
        "rollbacks": st.rollbacks,
        "settled_overlay": dict(st.settled),
        "quarantine": {k: list(v) for k, v in st.quarantine.items()},
        "proposes": [f"{k}={v}" for k, v in proposes],
        "oscillated": len(proposes) != len(set(proposes)),
        "base_p50_s": round(_p50([r["seconds"]
                                  for r in rnd["runs"][:3]]), 3),
        "settled_p50_s": round(_p50(settled[-3:]), 3),
    })
    rnd["converged"] = bool(
        not wrong and not rnd["oscillated"] and st.promotions >= 1
        and st.settled.get("target_batch_bytes", 0) > (1 << 18)
        and rnd["settled_p50_s"] < rnd["base_p50_s"])
    return rnd


def _autopilot_poison_round(tables, args):
    """Rollback: seed the store with a POISONED proposal (shrink
    target_batch_bytes to 256KB under the same stall — strictly more
    frames, strictly slower). The first canary run must come back as a
    regression verdict, roll back, quarantine the value, and capture an
    autopilot_rollback flight dossier; the quarantine must survive a
    driver restart (module cache dropped, store refolded) and the value
    must never be re-proposed."""
    from blaze_tpu_torch.config import conf
    from blaze_tpu_torch.runtime import autopilot, faults, history

    conf.autopilot_enabled = True
    conf.autopilot_dir = tempfile.mkdtemp(prefix="chaos_ap_store_")
    conf.history_dir = tempfile.mkdtemp(prefix="chaos_ap_hist_")
    conf.flight_dir = tempfile.mkdtemp(prefix="chaos_ap_flight_")
    conf.flight_triggers = "all"
    conf.trace_enabled = True
    conf.autopilot_canary_runs = 2
    conf.history_regression_pct = 15.0
    conf.target_batch_bytes = 4 << 20
    autopilot.reset()
    history.reset()
    poisoned = 1 << 18
    rnd = {"round": "autopilot_poison", "runs": []}
    faults.install({"seed": args.seed, "concurrent": True,
                    "points": {"serde.encode": {"kind": "stall",
                                                "ms": 400}}})
    try:
        wrong = 0
        fp = None
        for _ in range(3):  # settle a baseline at the healthy 4MB
            cell = _autopilot_run(tables)
            rnd["runs"].append({k: cell[k] for k in
                                ("seconds", "canary", "overlay")})
            wrong += int(cell["diff"] is not None)
            fp = cell["fingerprint"] or fp
        autopilot.active().store.append(
            "propose", fp, knob="target_batch_bytes", value=poisoned,
            direction=-1, finding="poisoned", current=4 << 20)
        autopilot.reset()  # refold: the canary arms on the next run
        budget = int(conf.autopilot_canary_runs)
        canaries = 0
        for _ in range(budget):
            cell = _autopilot_run(tables)
            rnd["runs"].append({k: cell[k] for k in
                                ("seconds", "canary", "overlay")})
            wrong += int(cell["diff"] is not None)
            canaries += int(cell["canary"])
            if autopilot.active().state_for(fp).rollbacks >= 1:
                break
        st = autopilot.active().state_for(fp)
        quarantined = st.quarantined("target_batch_bytes", poisoned)
        rolled_back = [r for r in autopilot.active().store.load_records()
                      if r["kind"] == "rollback"]
        autopilot.reset()  # driver restart: quarantine must survive
        survived = autopilot.active().state_for(fp).quarantined(
            "target_batch_bytes", poisoned)
        for _ in range(2):  # the value must never come back as a canary
            cell = _autopilot_run(tables)
            rnd["runs"].append({k: cell[k] for k in
                                ("seconds", "canary", "overlay")})
            wrong += int(cell["diff"] is not None)
        reproposed = any(
            r["kind"] == "propose" and r.get("value") == poisoned
            and r.get("finding") != "poisoned"
            for r in autopilot.active().store.load_records())
    finally:
        faults.install(None)
    import glob as _glob
    dossiers = _glob.glob(os.path.join(conf.flight_dir,
                                       "dossier_*autopilot_rollback*"))
    rnd.update({
        "wrong_answers": wrong,
        "canary_runs_before_rollback": canaries,
        "rolled_back": bool(rolled_back),
        "rollback_reason": (rolled_back[0].get("reason")
                            if rolled_back else None),
        "quarantined": quarantined,
        "quarantine_survived_restart": survived,
        "reproposed_after_quarantine": reproposed,
        "rollback_dossiers": len(dossiers),
    })
    rnd["contained"] = bool(
        not wrong and rolled_back and quarantined and survived
        and not reproposed and canaries <= budget
        and len(dossiers) == 1)
    return rnd


def _autopilot_overhead(tables, args):
    """Idle-autopilot A/B: with no faults armed and a too-thin history
    baseline (reset each rep, so the explorer never proposes), the
    resolve/observe path must be noise-level — autopilot-on p50 within
    15% of autopilot-off."""
    from blaze_tpu_torch.config import conf
    from blaze_tpu_torch.runtime import autopilot, history
    from blaze_tpu_torch.spark import validator
    from blaze_tpu_torch.spark.local_runner import run_plan

    paths, frames = tables

    def rep():
        history.reset()
        conf.history_dir = tempfile.mkdtemp(prefix="chaos_ap_ab_")
        plan, _ = validator.QUERIES["q1_scan_filter_project"](
            paths, frames, "bhj")
        t0 = time.time()
        run_plan(plan, num_partitions=4, mesh_exchange="off", device=DEVICE)
        return time.time() - t0

    rep()  # warm jit caches
    conf.autopilot_enabled = False
    off = [rep() for _ in range(5)]
    conf.autopilot_enabled = True
    conf.autopilot_dir = tempfile.mkdtemp(prefix="chaos_ap_store_")
    autopilot.reset()
    on = [rep() for _ in range(5)]
    rnd = {"round": "autopilot_overhead",
           "off_p50_s": round(_p50(off), 4),
           "on_p50_s": round(_p50(on), 4)}
    rnd["within_noise"] = (rnd["on_p50_s"]
                           <= rnd["off_p50_s"] * 1.15 + 0.05)
    return rnd


def _overhead(tables):
    """Disabled-path cost: the microbench backs the <=1%-claim at the
    per-call level; the catalogue A/B shows end-to-end parity with an
    armed spec whose rule never fires."""
    from blaze_tpu_torch.runtime import faults

    faults.install(None)
    n = 1_000_000
    t0 = time.perf_counter()
    for _ in range(n):
        faults.inject("op.SoakBench")
    ns_disabled = (time.perf_counter() - t0) / n * 1e9

    def catalogue(spec):
        from blaze_tpu_torch.spark.local_runner import run_plan
        from blaze_tpu_torch.spark import validator

        faults.install(spec)
        paths, frames = tables
        t0 = time.time()
        for query, mode in QUERIES:
            plan, _ = validator.QUERIES[query](paths, frames, mode)
            run_plan(plan, num_partitions=4, mesh_exchange="off",
                     device=DEVICE)
        faults.install(None)
        return round(time.time() - t0, 3)

    catalogue(None)  # warm jit caches so the A/B measures the harness
    t_disabled = catalogue(None)
    t_armed = catalogue(
        {"seed": 0, "points": {"shuffle.commit": {"nth": 10 ** 9}}})
    return {"inject_disabled_ns_per_call": round(ns_disabled, 1),
            "catalogue_disabled_s": t_disabled,
            "catalogue_armed_never_fires_s": t_armed}


def _supervisor_overhead(tables):
    """Supervisor-off must be the sequential runner: a clean
    catalogue A/B with no faults armed, pool on vs. off."""
    from blaze_tpu_torch.config import conf
    from blaze_tpu_torch.spark import validator
    from blaze_tpu_torch.spark.local_runner import run_plan

    def catalogue():
        paths, frames = tables
        t0 = time.time()
        for query, mode in QUERIES:
            plan, _ = validator.QUERIES[query](paths, frames, mode)
            run_plan(plan, num_partitions=4, mesh_exchange="off",
                     device=DEVICE)
        return round(time.time() - t0, 3)

    catalogue()  # warm jit caches
    saved = conf.enable_supervisor
    try:
        conf.enable_supervisor = False
        t_off = catalogue()
        conf.enable_supervisor = True
        t_on = catalogue()
    finally:
        conf.enable_supervisor = saved
    return {"catalogue_supervisor_off_s": t_off,
            "catalogue_supervisor_on_s": t_on}


def _check_merged_trace(path, qid, exec_ids):
    """Acceptance checks on ONE merged Chrome trace: valid JSON, a pid
    row per executor process, driver and executor spans sharing the
    query id, executor timestamps rebased inside the driver's observed
    window (clock alignment, 30s transit slack)."""
    out = {"path": path}
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError) as e:
        out["ok"] = False
        out["error"] = f"{type(e).__name__}: {e}"
        return out
    events = doc.get("traceEvents") or []
    procs = {ev["pid"]: ev["args"]["name"] for ev in events
             if ev.get("ph") == "M" and ev.get("name") == "process_name"}
    exec_pids = {pid for pid, name in procs.items()
                 if any(f"[{ex}]" in name for ex in exec_ids)}
    spans = [ev for ev in events if ev.get("ph") == "X"]
    drv = [ev for ev in spans if ev["pid"] not in exec_pids
           and (ev.get("args") or {}).get("query_id") == qid]
    exc = [ev for ev in spans if ev["pid"] in exec_pids
           and (ev.get("args") or {}).get("query_id") == qid]
    out["events"] = len(events)
    out["executor_pid_rows"] = len(exec_pids)
    out["driver_query_spans"] = len(drv)
    out["executor_query_spans"] = len(exc)
    out["executor_task_ids"] = sorted(
        {str((ev.get("args") or {}).get("task_id")) for ev in exc
         if (ev.get("args") or {}).get("task_id") is not None})
    aligned = True
    if drv and exc:
        lo = min(ev["ts"] for ev in drv)
        hi = max(ev["ts"] for ev in drv)
        slack = 30 * 1e6  # µs
        aligned = all(lo - slack <= ev["ts"] <= hi + slack for ev in exc)
    out["clock_aligned"] = aligned
    out["ok"] = bool(exec_pids and drv and exc and aligned
                     and out["executor_task_ids"])
    return out


def _dist_obs_chaos_round(tables, flight_dir, trace_dir):
    """Pooled chaos round with the telemetry plane ON: q3 under a
    2-seat pool, SIGKILL fired at a busy executor mid-stage. Beyond the
    executor-kill recovery demands, the telemetry acceptance: ONE merged
    Chrome trace with driver + executor spans sharing query/task ids on
    per-executor pid rows, clock-aligned timestamps, zero dropped-span
    rings, and ledger counters carrying executor-side bytes."""
    import signal
    import threading

    from blaze_tpu_torch.config import conf
    from blaze_tpu_torch.runtime import executor_pool as ep
    from blaze_tpu_torch.runtime import trace
    from blaze_tpu_torch.spark import validator
    from blaze_tpu_torch.spark.local_runner import run_plan

    paths, frames = tables
    plan, oracle = validator.QUERIES["q3_join_agg_sort"](paths, frames,
                                                         "smj")
    saved = {k: getattr(conf, k) for k in
             ("flight_dir", "executor_death_ms", "executor_heartbeat_ms",
              "trace_enabled", "monitor_enabled")}
    conf.flight_dir = flight_dir
    conf.executor_death_ms = 800
    conf.executor_heartbeat_ms = 50
    conf.trace_enabled = True
    conf.monitor_enabled = True
    trace.reset()
    rec = {"round": "dist_obs_chaos_sigkill"}
    work_dir = tempfile.mkdtemp(prefix="chaos_dobs_")
    t0 = time.time()
    pool = ep.ExecutorPool(count=2, slots=2)
    try:
        pool.start()
        ep.activate(pool)
        info = {}
        box = {}

        def run():
            try:
                box["out"] = run_plan(plan, num_partitions=4,
                                      work_dir=work_dir,
                                      mesh_exchange="off", run_info=info,
                                      device=DEVICE)
            except Exception as e:  # noqa: BLE001 — recorded below
                box["err"] = e

        t = threading.Thread(target=run)
        t.start()
        fired = False
        deadline = time.monotonic() + 120
        while not fired and t.is_alive() and time.monotonic() < deadline:
            busy = pool.busy_pids()
            if busy:
                _seat, pid = next(iter(busy.items()))
                os.kill(pid, signal.SIGKILL)
                fired = True
            else:
                time.sleep(0.002)
        t.join(timeout=300)
        rec["fired"] = fired
        if "err" in box:
            rec["outcome"] = "classified_fail"
            rec["error"] = f"{type(box['err']).__name__}: {box['err']}"[:300]
        elif not fired:
            rec["outcome"] = "no_fire"
        else:
            diff = validator._compare(
                validator._to_pandas(box["out"]).reset_index(drop=True),
                oracle().reset_index(drop=True))
            rec["outcome"] = "recovered" if diff is None else "wrong_answer"
        rec["pool_stages"] = info.get("pool_stages", 0)
        qid = info.get("query_id", "")
        # ONE merged export over the federated ring: driver spans and
        # every shipped/recovered executor span, one timeline
        merged = os.path.join(trace_dir, "dist_obs_merged.json")
        trace.export_chrome_trace(merged, records=trace.TRACE.snapshot())
        exec_ids = [e["exec_id"] for e in pool.executors()]
        rec["merged_trace"] = _check_merged_trace(merged, qid, exec_ids)
        rec["stats"] = pool.stats()
        rec["executors"] = pool.executors()
        rec["dropped_rings"] = sum(
            1 for e in rec["executors"] if e.get("telemetry_dropped"))
        ledger = trace.build_run_record(qid, info,
                                        trace.query_records(qid))
        counters = ledger.get("counters") or {}
        rec["ledger_counters"] = {
            k: counters.get(k, 0)
            for k in ("bytes_copied_total", "bytes_copied_shuffle",
                      "bytes_copied_serde", "spill_bytes")}
        # federation reconciliation: the pool carried map stages, so the
        # ledger must see the workers' copy bytes (pre-federation these
        # were silently zero for pooled runs)
        rec["counters_reconciled"] = (
            rec["pool_stages"] >= 1
            and counters.get("bytes_copied_total", 0) > 0)
    finally:
        ep.deactivate(pool)
        pool.close()
        for k, v in saved.items():
            setattr(conf, k, v)
    rec["seconds"] = round(time.time() - t0, 3)
    rec.update(_leaks([work_dir]))
    shutil.rmtree(work_dir, ignore_errors=True)
    return rec


def _dist_obs_overhead(tables):
    """Telemetry-plane overhead: the pooled catalogue A/B, telemetry
    (trace + monitor, federation included) OFF vs ON. Each arm spawns
    its own pool — workers snapshot the driver's tracing state at spawn
    — runs the catalogue once warm, then takes the best of 3 timed laps
    (the gate is <2%, well inside timing noise for a single lap)."""
    from blaze_tpu_torch.config import conf
    from blaze_tpu_torch.runtime import executor_pool as ep
    from blaze_tpu_torch.runtime import trace
    from blaze_tpu_torch.spark import validator
    from blaze_tpu_torch.spark.local_runner import run_plan

    paths, frames = tables
    saved = {k: getattr(conf, k) for k in
             ("trace_enabled", "monitor_enabled")}

    def catalogue():
        per = []
        for query, mode in QUERIES:
            plan, _ = validator.QUERIES[query](paths, frames, mode)
            t0 = time.time()
            run_plan(plan, num_partitions=4, mesh_exchange="off",
                     device=DEVICE)
            per.append(time.time() - t0)
        return per

    def arm(enabled):
        conf.trace_enabled = enabled
        conf.monitor_enabled = enabled
        trace.reset()
        pool = ep.ExecutorPool(count=2, slots=2)
        try:
            pool.start()
            ep.activate(pool)
            catalogue()  # warm: jit caches + worker imports
            # per-QUERY minima across laps, then summed: a single slow
            # lap of one query (GC, pool scheduling jitter) doesn't
            # poison the whole arm the way min-of-lap-totals does
            laps = [catalogue() for _ in range(3)]
            best = sum(min(lap[i] for lap in laps)
                       for i in range(len(QUERIES)))
        finally:
            ep.deactivate(pool)
            pool.close()
        trace.reset()
        return best

    try:
        # alternate arms and keep each one's best: a single off-then-on
        # pass charges every cold-start cost (imports, compile-cache
        # misses, pool spawn jitter) to whichever arm runs second — the
        # second pass absorbs it symmetrically
        t_off = t_on = float("inf")
        for _ in range(2):
            t_off = min(t_off, arm(False))
            t_on = min(t_on, arm(True))
    finally:
        for k, v in saved.items():
            setattr(conf, k, v)
    pct = 100.0 * (t_on - t_off) / max(t_off, 1e-9)
    return {"catalogue_telemetry_off_s": round(t_off, 3),
            "catalogue_telemetry_on_s": round(t_on, 3),
            "overhead_pct": round(pct, 2)}


def _profile_attrib_round(tables, args):
    """Seeded hot-spot attribution: q3 with a deterministic stall armed
    on serde.encode and the sampling profiler on. The stall executes
    inside faults._stall on a supervised task thread whose replayed
    trace context carries (query, stage, task) — so the collapsed-stack
    export MUST contain faults frames under the right
    query:<qid>;stage:<sid> synthetic roots, the per-query
    .collapsed/.speedscope.json files must land in
    conf.profile_export_dir, and the answer must stay oracle-equal."""
    from blaze_tpu_torch.config import conf
    from blaze_tpu_torch.runtime import faults, profiler
    from blaze_tpu_torch.spark import validator
    from blaze_tpu_torch.spark.local_runner import run_plan

    paths, frames = tables
    plan, oracle = validator.QUERIES["q3_join_agg_sort"](paths, frames,
                                                         "smj")
    saved = {k: getattr(conf, k) for k in
             ("profile_enabled", "profile_sample_ms",
              "profile_export_dir", "trace_enabled")}
    export_dir = tempfile.mkdtemp(prefix="chaos_prof_export_")
    conf.profile_enabled = True
    conf.profile_sample_ms = 5
    conf.profile_export_dir = export_dir
    conf.trace_enabled = True  # stage spans push the stage-id context
    profiler.reset()
    # four 250ms stalls: ~50 samples each at 5ms — an unmissable plateau
    faults.install({"seed": args.seed, "concurrent": True,
                    "points": {"serde.encode": {"kind": "stall",
                                                "ms": 250,
                                                "fail_times": 4}}})
    rec = {"round": "profile_attrib", "query": "q3_join_agg_sort"}
    work_dir = tempfile.mkdtemp(prefix="chaos_prof_")
    info = {}
    t0 = time.time()
    try:
        out = run_plan(plan, num_partitions=4, work_dir=work_dir,
                       mesh_exchange="off", device=DEVICE, run_info=info)
        diff = validator._compare(
            validator._to_pandas(out).reset_index(drop=True),
            oracle().reset_index(drop=True))
        rec["outcome"] = "recovered" if diff is None else "wrong_answer"
        if diff is not None:
            rec["diff"] = diff
    except Exception as e:  # noqa: BLE001 — the soak records, not raises
        rec["outcome"] = "classified_fail"
        rec["error"] = f"{type(e).__name__}: {e}"[:300]
    finally:
        faults.install(None)
        qid = info.get("query_id", "")
        lines = profiler.collapsed(qid)
        stalled = [ln for ln in lines if ";faults." in ln]
        rec["query_id"] = qid
        rec["stacks"] = len(lines)
        rec["stall_stacks"] = len(stalled)
        # the acceptance bit: the seeded hot spot shows up UNDER the
        # right query and a concrete stage, not as unattributed noise
        rec["attributed"] = bool(qid) and any(
            ln.startswith(f"query:{qid};stage:") for ln in stalled)
        rec["hot_frames"] = profiler.hot_frames(qid, top=5)
        rec["exports_written"] = (
            os.path.isfile(os.path.join(
                export_dir, f"profile_{qid}.collapsed"))
            and os.path.isfile(os.path.join(
                export_dir, f"profile_{qid}.speedscope.json")))
        rec["stalls_injected"] = info.get("stalls_injected", 0)
        profiler.stop()
        for k, v in saved.items():
            setattr(conf, k, v)
    rec["seconds"] = round(time.time() - t0, 3)
    rec.update(_leaks([work_dir]))
    shutil.rmtree(work_dir, ignore_errors=True)
    shutil.rmtree(export_dir, ignore_errors=True)
    return rec


def _profile_pool_round(tables, args):
    """Fleet federation under executor loss: q3 on a 2-seat pool with
    the profiler on in every process and a PERSISTENT net.telemetry
    blackhole armed — every live telemetry frame is lost in transit, so
    executor folded-stack deltas can only reach the driver through the
    death-time sidecar recovery. SIGKILL a busy worker mid-stage: the
    query must still answer oracle-equal, the merged table must hold
    driver samples for the query AND executor-stamped samples, and the
    recovered-sample counter must prove the SIGKILLed worker's last
    batch survived via its sidecar."""
    import signal
    import threading

    from blaze_tpu_torch.config import conf
    from blaze_tpu_torch.runtime import executor_pool as ep
    from blaze_tpu_torch.runtime import faults, profiler, trace
    from blaze_tpu_torch.spark import validator
    from blaze_tpu_torch.spark.local_runner import run_plan

    paths, frames = tables
    plan, oracle = validator.QUERIES["q3_join_agg_sort"](paths, frames,
                                                         "smj")
    saved = {k: getattr(conf, k) for k in
             ("profile_enabled", "profile_sample_ms", "trace_enabled",
              "monitor_enabled", "executor_death_ms",
              "executor_heartbeat_ms", "telemetry_ship_ms")}
    conf.profile_enabled = True
    conf.profile_sample_ms = 5
    conf.trace_enabled = True
    conf.monitor_enabled = True
    conf.executor_death_ms = 800
    conf.executor_heartbeat_ms = 50
    conf.telemetry_ship_ms = 120  # tight sidecar window: the recovered
    # batch covers the worker's final ~120ms of samples
    trace.reset()
    profiler.reset()
    faults.install({"seed": args.seed, "concurrent": True,
                    "points": {"net.telemetry": {"kind": "blackhole"}}})
    rec = {"round": "profile_pool_sigkill"}
    work_dir = tempfile.mkdtemp(prefix="chaos_profpool_")
    t0 = time.time()
    pool = ep.ExecutorPool(count=2, slots=2)
    try:
        pool.start()
        ep.activate(pool)
        info = {}
        box = {}

        def run():
            try:
                box["out"] = run_plan(plan, num_partitions=4,
                                      work_dir=work_dir,
                                      mesh_exchange="off", run_info=info,
                                      device=DEVICE)
            except Exception as e:  # noqa: BLE001 — recorded below
                box["err"] = e

        t = threading.Thread(target=run)
        t.start()
        fired = False
        deadline = time.monotonic() + 120
        while not fired and t.is_alive() and time.monotonic() < deadline:
            busy = pool.busy_pids()
            if busy:
                # one ship period in-task, so the worker's sidecar tail
                # holds query-attributed samples when the kill lands
                time.sleep(0.15)
                _seat, pid = next(iter(busy.items()))
                os.kill(pid, signal.SIGKILL)
                fired = True
            else:
                time.sleep(0.002)
        t.join(timeout=300)
        rec["fired"] = fired
        if "err" in box:
            rec["outcome"] = "classified_fail"
            rec["error"] = f"{type(box['err']).__name__}: {box['err']}"[:300]
        elif not fired:
            rec["outcome"] = "no_fire"
        else:
            diff = validator._compare(
                validator._to_pandas(box["out"]).reset_index(drop=True),
                oracle().reset_index(drop=True))
            rec["outcome"] = "recovered" if diff is None else "wrong_answer"
        qid = info.get("query_id", "")
        rows = profiler.rows()
        st = profiler.stats()
        rec["query_id"] = qid
        rec["profile_stats"] = st
        rec["driver_query_stacks"] = sum(
            1 for r in rows if r[0] == qid and not r[4])
        rec["exec_stacks"] = sum(1 for r in rows if r[4])
        rec["exec_query_stacks"] = sum(
            1 for r in rows if r[0] == qid and r[4])
        # the acceptance bits
        rec["merged_fleet_profile"] = (rec["driver_query_stacks"] > 0
                                       and rec["exec_stacks"] > 0)
        rec["sidecar_recovered"] = st["recovered_samples"] > 0
        rec["pool_stages"] = info.get("pool_stages", 0)
        rec["stats"] = pool.stats()
    finally:
        faults.install(None)
        ep.deactivate(pool)
        pool.close()
        profiler.stop()
        for k, v in saved.items():
            setattr(conf, k, v)
        trace.reset()
    rec["seconds"] = round(time.time() - t0, 3)
    rec.update(_leaks([work_dir]))
    shutil.rmtree(work_dir, ignore_errors=True)
    return rec


def _profile_overhead(tables):
    """Always-on cost, two measurements with different jobs. (1) The
    sampler's own duty ledger (cpu seconds inside sampling passes over
    wall seconds alive), driver-side and federated from the ON pool's
    workers — this is the number the <2% contract is gated on, because
    it is deterministic. (2) A wall-clock A/B of the pooled catalogue:
    both pools spawned up front (workers snapshot profile_enabled at
    spawn — one off, one on), alternating off/on laps with only the
    driver flag toggled, min-of-5 per arm. Measured per-lap scheduling
    noise on this host is +/-15% on a 0.4s lap and even CPU-time A/Bs
    swing +/-20%, so no end-to-end statistic here can resolve 2%; the
    A/B backstops gross systematic regressions (a per-task ship tax
    showed up as +9% here) at a noise-aware 10% threshold."""
    from blaze_tpu_torch.config import conf
    from blaze_tpu_torch.runtime import executor_pool as ep
    from blaze_tpu_torch.runtime import profiler
    from blaze_tpu_torch.spark import validator
    from blaze_tpu_torch.spark.local_runner import run_plan

    paths, frames = tables
    saved = {k: getattr(conf, k) for k in
             ("trace_enabled", "monitor_enabled", "profile_enabled")}

    def catalogue():
        t0 = time.time()
        for query, mode in QUERIES:
            plan, _ = validator.QUERIES[query](paths, frames, mode)
            run_plan(plan, num_partitions=4, mesh_exchange="off",
                     device=DEVICE)
        return time.time() - t0

    def spawn(enabled):
        conf.profile_enabled = enabled
        pool = ep.ExecutorPool(count=2, slots=2)
        pool.start()
        return pool

    def lap(pool, enabled):
        conf.profile_enabled = enabled
        ep.activate(pool)
        try:
            return catalogue()
        finally:
            ep.deactivate(pool)

    conf.trace_enabled = False
    conf.monitor_enabled = False
    profiler.reset()
    pool_off = pool_on = None
    try:
        pool_off = spawn(False)
        pool_on = spawn(True)
        lap(pool_off, False)  # warm: jit caches + worker imports
        lap(pool_on, True)
        offs, ons = [], []
        for _ in range(5):
            offs.append(lap(pool_off, False))
            ons.append(lap(pool_on, True))
        conf.profile_enabled = True  # ingest duty frames while closing
        pool_on.close()
        pool_on = None
        st = profiler.stats()
        # min is the right location estimate for the backstop: lap
        # timing noise is one-sided (scheduling only ever adds time),
        # so min-of-5 converges on the true lap cost where a median
        # still carries +/-10% of spike mass
        t_off = min(offs)
        t_on = min(ons)
    finally:
        for p in (pool_off, pool_on):
            if p is not None:
                p.close()
        profiler.stop()
        profiler.reset()
        for k, v in saved.items():
            setattr(conf, k, v)
    pct = 100.0 * (t_on - t_off) / max(t_off, 1e-9)
    return {"catalogue_profile_off_s": round(t_off, 3),
            "catalogue_profile_on_s": round(t_on, 3),
            "samples_on": st["samples"],
            "duty_pct": st["duty_pct"],
            "fleet_duty_pct": st["fleet_duty_pct"],
            "overhead_pct": round(pct, 2)}


def _write_report(path, report):
    """The report as JSON at `path`; no file when no path was given."""
    if path:
        with open(path, "w") as f:
            json.dump(report, f, indent=1)


def main(argv=None) -> int:
    global DEVICE
    ap = argparse.ArgumentParser(
        prog="python -m blaze_tpu_torch.tools.chaos_soak")
    ap.add_argument("--rows", type=int, default=8000)
    ap.add_argument("--fail-times", type=int, default=2,
                    help="consecutive failures per armed point (2 climbs "
                         "past a plain retry into the ladder)")
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--kinds", default=None,
                    help="comma-separated fault kinds to sweep "
                         "(default: io,oom; --supervisor adds stall)")
    ap.add_argument("--stall-ms", type=int, default=2000,
                    help="stall length per fired stall cell; the watchdog "
                         "must recover well before this elapses")
    ap.add_argument("--hang-detect-ms", type=int, default=500,
                    help="watchdog heartbeat-staleness threshold; must be "
                         "well under --stall-ms yet above the longest "
                         "legitimate between-batch gap (jit compiles)")
    ap.add_argument("--supervisor", action="store_true",
                    help="run the sweep under the concurrent supervised "
                         "pool (hang detection + speculation armed)")
    ap.add_argument("--pipeline", action="store_true",
                    help="keep the async pipeline layer live under every "
                         "armed spec (marks specs concurrent) and fail any "
                         "cell that leaks prefetch streams/sinks")
    ap.add_argument("--service", action="store_true",
                    help="concurrent multi-tenant soak through "
                         "runtime/service.QueryService (admission, quotas, "
                         "fair scheduling, per-query breaker isolation)")
    ap.add_argument("--executors", action="store_true",
                    help="process-isolated executor soak: weak-scaling "
                         "smoke at 1/2/4 seats, pooled catalogue "
                         "correctness, and SIGKILL/SIGTERM/hung "
                         "kill-recovery rounds with epoch fencing")
    ap.add_argument("--durability", action="store_true",
                    help="artifact-integrity sweep: bit-flip committed "
                         "shuffle/spill artifacts (CORRUPT_POINTS) and "
                         "demand detection + quarantine + lineage repair "
                         "with oracle-equal answers")
    ap.add_argument("--driver", action="store_true",
                    help="driver-crash round: SIGKILL a journaling "
                         "subprocess driver mid-query, restart it, and "
                         "demand journal replay (committed stages reused, "
                         "crashed attempt billed failed) with an "
                         "oracle-equal answer")
    ap.add_argument("--dist-obs", action="store_true",
                    help="distributed-telemetry acceptance: pooled chaos "
                         "round (SIGKILL) with the telemetry plane on — "
                         "one merged Chrome trace with per-executor pid "
                         "rows, clock-aligned spans, zero dropped rings, "
                         "federated ledger counters — plus a telemetry "
                         "on/off overhead A/B gated at <2%%")
    ap.add_argument("--profile", action="store_true",
                    help="continuous-profiling acceptance: a seeded "
                         "serde-stall hot spot must show up in the "
                         "collapsed-stack export attributed to the right "
                         "(query, stage); a pooled SIGKILL under a "
                         "net.telemetry blackhole must keep executor "
                         "samples via sidecar recovery (fleet-merged "
                         "profile); and a profiler on/off catalogue A/B "
                         "must stay under 2%% overhead")
    ap.add_argument("--network", action="store_true",
                    help="partition-tolerance acceptance: every net.* "
                         "wire-fault cell (delay/reset/blackhole/torn/dup) "
                         "under a live pool, a transient control reset "
                         "(reconnect+resume, capacity untouched), an "
                         "asymmetric partition past the lease (one "
                         "dossier + worker self-fence), and a rolling "
                         "drain/restart of every seat under service load")
    ap.add_argument("--elastic", action="store_true",
                    help="elastic fleet & driver-HA acceptance: an "
                         "8-client burst against a 1-seat pool must "
                         "autoscale up on parked arrivals and drain back "
                         "to the floor (0 requeues), and a warm-standby "
                         "subprocess must survive SIGKILL of the primary "
                         "driver plus two executors — lease-fenced "
                         "takeover, worker adoption, journal replay, "
                         "every answer oracle-equal")
    ap.add_argument("--streaming", action="store_true",
                    help="durable exactly-once streaming acceptance: a "
                         "checkpointed micro-batch stream must survive an "
                         "executor SIGKILL mid-batch and a primary-driver "
                         "SIGKILL with warm-standby takeover — adopted "
                         "from its journal, resumed from the last "
                         "committed checkpoint, final state pandas-oracle "
                         "equal with strictly monotone checkpoint epochs")
    ap.add_argument("--autopilot", action="store_true",
                    help="self-tuning autopilot acceptance: under a "
                         "seeded 400ms serde.encode stall the explorer "
                         "must converge target_batch_bytes upward "
                         "(canary -> consecutive wins -> promoted "
                         "settled overlay beating the base p50, zero "
                         "wrong answers, zero oscillation); a poisoned "
                         "proposal must roll back on its first "
                         "regression verdict, quarantine the value "
                         "across a driver restart, and never be "
                         "re-proposed; an autopilot on/off A/B must be "
                         "within noise")
    ap.add_argument("--concurrent-queries", type=int, default=8,
                    help="client sessions per --service round")
    ap.add_argument("--tenants", type=int, default=3,
                    help="distinct tenant ids per --service round")
    ap.add_argument("--trace-dir", default=None,
                    help="enable the engine trace (conf.trace_enabled) and "
                         "export per-query Chrome traces + ledger.jsonl "
                         "into this directory — the soak doubles as the "
                         "observability acceptance run")
    ap.add_argument("--json-out", default=None,
                    help="write the report here (default: no file)")
    ap.add_argument("--device", default="cuda",
                    help="torch device every query runs on (default: "
                         "the CUDA card; --device cpu runs on the host)")
    args = ap.parse_args(argv)
    from blaze_tpu_torch.tools import refuse_device

    if refuse_device("chaos_soak", args.device):
        return 2
    DEVICE = args.device
    kinds = (tuple(args.kinds.split(",")) if args.kinds
             else KINDS + ("stall",) if args.supervisor else KINDS)

    from blaze_tpu_torch.config import conf
    from blaze_tpu_torch.runtime import faults
    from blaze_tpu_torch.spark import validator

    saved_conf = {k: getattr(conf, k) for k in (
        "max_concurrent_tasks", "hang_detect_ms", "speculation_multiplier",
        "trace_enabled", "trace_export_dir", "enable_pipeline",
        "max_concurrent_queries", "admission_queue_depth",
        "tenant_priority_spec", "tenant_quota_spec",
        "autopilot_enabled", "autopilot_dir", "autopilot_canary_runs",
        "history_dir", "history_regression_pct", "flight_dir",
        "flight_triggers", "target_batch_bytes")}
    if args.autopilot and args.rows == ap.get_default("rows"):
        # the gate's knob physics need enough shuffle volume that
        # target_batch_bytes visibly changes the serde.encode frame
        # count (at 24k rows: 256KB->32 calls, 1MB->28, 2MB->24)
        args.rows = 24000
    if args.pipeline:
        conf.enable_pipeline = True
    if args.supervisor:
        conf.max_concurrent_tasks = 4
        conf.hang_detect_ms = args.hang_detect_ms
        conf.speculation_multiplier = 4.0
    if args.trace_dir:
        os.makedirs(args.trace_dir, exist_ok=True)
        conf.trace_enabled = True
        conf.trace_export_dir = args.trace_dir

    if args.streaming:
        # the round feeds its own growing parquet directory — no
        # catalogue tables needed
        try:
            rnd = _streaming_round(args)
        finally:
            for k, v in saved_conf.items():
                setattr(conf, k, v)
        bad = []
        if rnd.get("outcome") != "recovered":
            bad.append({"round": rnd["round"],
                        "outcome": rnd.get("outcome"),
                        "diff": rnd.get("diff"),
                        "standby": rnd.get("standby"),
                        "failover_dossiers": rnd.get("failover_dossiers"),
                        "restart_dossiers": rnd.get("restart_dossiers")})
        report = {
            "rows": args.rows, "seed": args.seed,
            "ok": not bad, "bad": bad, "rounds": [rnd],
        }
        _write_report(args.json_out, report)
        print(f"\nstreaming soak {'OK' if report['ok'] else 'FAILED'} "
              f"-> {args.json_out}")
        if bad:
            print(f"bad: {bad}")
        return 0 if report["ok"] else 1

    tmpdir = tempfile.mkdtemp(prefix="chaos_tables_")
    tables = validator.generate_tables(tmpdir, rows=args.rows)

    if args.autopilot:
        from blaze_tpu_torch.runtime import autopilot, history
        try:
            rounds = [_autopilot_converge_round(tables, args),
                      _autopilot_poison_round(tables, args),
                      _autopilot_overhead(tables, args)]
        finally:
            shutil.rmtree(tmpdir, ignore_errors=True)
            for k, v in saved_conf.items():
                setattr(conf, k, v)
            autopilot.reset()
            history.reset()
        bad = []
        converge, poison, ab = rounds
        if not converge.get("converged"):
            bad.append({"round": converge["round"], "converged": False,
                        "wrong_answers": converge.get("wrong_answers"),
                        "oscillated": converge.get("oscillated"),
                        "promotions": converge.get("promotions"),
                        "settled_overlay": converge.get("settled_overlay"),
                        "base_p50_s": converge.get("base_p50_s"),
                        "settled_p50_s": converge.get("settled_p50_s")})
        if not poison.get("contained"):
            bad.append({k: poison.get(k) for k in (
                "round", "wrong_answers", "rolled_back",
                "rollback_reason", "quarantined",
                "quarantine_survived_restart",
                "reproposed_after_quarantine", "rollback_dossiers")})
        if not ab.get("within_noise"):
            bad.append({"round": ab["round"],
                        "off_p50_s": ab.get("off_p50_s"),
                        "on_p50_s": ab.get("on_p50_s")})
        report = {
            "rows": args.rows, "seed": args.seed,
            "ok": not bad, "bad": bad, "rounds": rounds,
        }
        _write_report(args.json_out, report)
        print(f"\nautopilot soak {'OK' if report['ok'] else 'FAILED'} "
              f"-> {args.json_out}")
        if bad:
            print(f"bad: {bad}")
        return 0 if report["ok"] else 1

    if args.elastic:
        try:
            rounds = [_elastic_scale_round(tables),
                      _elastic_failover_round(args)]
        finally:
            shutil.rmtree(tmpdir, ignore_errors=True)
            for k, v in saved_conf.items():
                setattr(conf, k, v)
        bad = []
        scale, failover = rounds
        if not scale.get("elastic_ok"):
            bad.append({"round": scale["round"], "elastic_ok": False,
                        "scaler": scale.get("scaler"),
                        "failed_queries": scale.get("failed_queries")})
        if (scale.get("orphans") or scale.get("mem_leaked")
                or scale.get("pipeline_leaked")
                or scale.get("resource_leaked")):
            bad.append({"round": scale["round"], "leaks": True})
        if failover.get("outcome") != "recovered":
            bad.append({"round": failover["round"],
                        "outcome": failover.get("outcome"),
                        "standby": failover.get("standby"),
                        "dossiers": failover.get("failover_dossiers")})
        report = {
            "rows": args.rows, "seed": args.seed,
            "ok": not bad, "bad": bad, "rounds": rounds,
        }
        _write_report(args.json_out, report)
        print(f"\nelastic soak {'OK' if report['ok'] else 'FAILED'} "
              f"-> {args.json_out}")
        if bad:
            print(f"bad: {bad}")
        return 0 if report["ok"] else 1

    if args.network:
        try:
            rounds = _network_soak(tables, args)
        finally:
            shutil.rmtree(tmpdir, ignore_errors=True)
            for k, v in saved_conf.items():
                setattr(conf, k, v)
        bad = []
        for r in rounds:
            if r["round"] == "net_cell_sweep":
                for c in r["cells"]:
                    tag = f"{c['point']}/{c['kind']}"
                    if c["outcome"] not in ("recovered", "no_fire"):
                        bad.append({"cell": tag,
                                    "outcome": c["outcome"]})
                    if c.get("deaths"):
                        bad.append({"cell": tag, "deaths": c["deaths"]})
                    if (c.get("orphans") or c.get("mem_leaked")
                            or c.get("pipeline_leaked")):
                        bad.append({"cell": tag, "leaks": True})
                continue
            gate = {"control_reset_reconnect": "reconnect_ok",
                    "asymmetric_partition": "partition_ok",
                    "rolling_drain_restart": "rolling_ok"}[r["round"]]
            if r.get("outcome") not in ("recovered", None):
                bad.append({"round": r["round"],
                            "outcome": r.get("outcome")})
            if not r.get(gate):
                bad.append({"round": r["round"], gate: False})
            if (r.get("orphans") or r.get("mem_leaked")
                    or r.get("pipeline_leaked")
                    or r.get("resource_leaked")):
                bad.append({"round": r["round"], "leaks": True})
        cells = next(r["cells"] for r in rounds
                     if r["round"] == "net_cell_sweep")
        outcomes = {}
        for c in cells:
            outcomes[c["outcome"]] = outcomes.get(c["outcome"], 0) + 1
        report = {
            "rows": args.rows, "seed": args.seed,
            "ok": not bad, "bad": bad,
            "cell_outcomes": outcomes, "rounds": rounds,
        }
        _write_report(args.json_out, report)
        print(f"\nnetwork soak {'OK' if report['ok'] else 'FAILED'} "
              f"{outcomes} -> {args.json_out}")
        if bad:
            print(f"bad: {bad}")
        return 0 if report["ok"] else 1

    if args.dist_obs:
        flight_dir = tempfile.mkdtemp(prefix="chaos_dobs_flight_")
        trace_dir = tempfile.mkdtemp(prefix="chaos_dobs_trace_")
        try:
            rounds = [_dist_obs_chaos_round(tables, flight_dir, trace_dir)]
            overhead = _dist_obs_overhead(tables)
        finally:
            shutil.rmtree(tmpdir, ignore_errors=True)
            shutil.rmtree(flight_dir, ignore_errors=True)
            shutil.rmtree(trace_dir, ignore_errors=True)
            for k, v in saved_conf.items():
                setattr(conf, k, v)
        bad = []
        for r in rounds:
            if r.get("outcome") != "recovered":
                bad.append({"round": r["round"],
                            "outcome": r.get("outcome")})
            if not (r.get("merged_trace") or {}).get("ok"):
                bad.append({"round": r["round"], "merged_trace_ok": False,
                            "detail": r.get("merged_trace")})
            if r.get("dropped_rings"):
                bad.append({"round": r["round"],
                            "dropped_rings": r["dropped_rings"]})
            if not (r.get("stats") or {}).get("telemetry_records_total"):
                bad.append({"round": r["round"], "telemetry_shipped": 0})
            if not r.get("counters_reconciled"):
                bad.append({"round": r["round"],
                            "counters_reconciled": False,
                            "ledger_counters": r.get("ledger_counters")})
            if (r.get("orphans") or r.get("mem_leaked")
                    or r.get("pipeline_leaked") or r.get("resource_leaked")):
                bad.append({"round": r["round"], "leaks": True})
            mt = r.get("merged_trace") or {}
            print(f"[dist-obs] {r.get('outcome', '?'):10s} "
                  f"exec_pid_rows={mt.get('executor_pid_rows')} "
                  f"exec_spans={mt.get('executor_query_spans')} "
                  f"aligned={mt.get('clock_aligned')} "
                  f"dropped_rings={r.get('dropped_rings')} "
                  f"counters={r.get('ledger_counters')} "
                  f"{r.get('seconds', 0):.1f}s", flush=True)
        # wall-clock A/B on a shared host: the catalogue's off-arm
        # shrank ~20% with the zero-copy plane (mmap shuffle + dict
        # strings), so a 2%-of-wall gate is ~7 ms — under the host's
        # noise floor. 10% backstops gross regressions (a per-task ship
        # tax), matching the profile soak's wall gate; the <2% contract
        # is held by that soak's sampler duty ledger instead
        if overhead["overhead_pct"] >= 10.0:
            bad.append({"overhead_pct": overhead["overhead_pct"]})
        print(f"[dist-obs] overhead "
              f"off={overhead['catalogue_telemetry_off_s']:.2f}s "
              f"on={overhead['catalogue_telemetry_on_s']:.2f}s "
              f"({overhead['overhead_pct']:+.2f}%)", flush=True)
        report = {
            "rows": args.rows, "seed": args.seed,
            "ok": not bad, "bad": bad,
            "rounds": rounds, "overhead": overhead,
        }
        _write_report(args.json_out, report)
        print(f"\ndist-obs soak {'OK' if report['ok'] else 'FAILED'} "
              f"-> {args.json_out}")
        if bad:
            print(f"bad: {bad}")
        return 0 if report["ok"] else 1

    if args.profile:
        from blaze_tpu_torch.runtime import profiler
        try:
            attrib = _profile_attrib_round(tables, args)
            pool_rnd = _profile_pool_round(tables, args)
            overhead = _profile_overhead(tables)
        finally:
            shutil.rmtree(tmpdir, ignore_errors=True)
            for k, v in saved_conf.items():
                setattr(conf, k, v)
            profiler.stop()
            profiler.reset()
        bad = []
        if attrib.get("outcome") != "recovered":
            bad.append({"round": attrib["round"],
                        "outcome": attrib.get("outcome"),
                        "diff": attrib.get("diff"),
                        "error": attrib.get("error")})
        if not attrib.get("attributed"):
            bad.append({"round": attrib["round"], "attributed": False,
                        "stall_stacks": attrib.get("stall_stacks"),
                        "stacks": attrib.get("stacks")})
        if not attrib.get("exports_written"):
            bad.append({"round": attrib["round"],
                        "exports_written": False})
        print(f"[profile] attrib   {attrib.get('outcome', '?'):10s} "
              f"attributed={attrib.get('attributed')} "
              f"stall_stacks={attrib.get('stall_stacks')} "
              f"exports={attrib.get('exports_written')} "
              f"{attrib.get('seconds', 0):.1f}s", flush=True)
        if pool_rnd.get("outcome") != "recovered":
            bad.append({"round": pool_rnd["round"],
                        "outcome": pool_rnd.get("outcome"),
                        "error": pool_rnd.get("error")})
        if not pool_rnd.get("merged_fleet_profile"):
            bad.append({"round": pool_rnd["round"],
                        "merged_fleet_profile": False,
                        "driver_query_stacks":
                            pool_rnd.get("driver_query_stacks"),
                        "exec_stacks": pool_rnd.get("exec_stacks")})
        if not pool_rnd.get("sidecar_recovered"):
            bad.append({"round": pool_rnd["round"],
                        "sidecar_recovered": False,
                        "profile_stats": pool_rnd.get("profile_stats")})
        print(f"[profile] pool     {pool_rnd.get('outcome', '?'):10s} "
              f"fired={pool_rnd.get('fired')} "
              f"driver_q={pool_rnd.get('driver_query_stacks')} "
              f"exec={pool_rnd.get('exec_stacks')} "
              f"recovered="
              f"{(pool_rnd.get('profile_stats') or {}).get('recovered_samples')} "
              f"{pool_rnd.get('seconds', 0):.1f}s", flush=True)
        # the <2% always-on contract is gated on the sampler's own duty
        # ledger (cpu spent sampling / wall alive), driver and fleet —
        # the wall-clock A/B on a shared host has a noise floor well
        # above 2% and only backstops gross regressions (e.g. a
        # per-task ship tax)
        if overhead["duty_pct"] >= 2.0 or overhead["fleet_duty_pct"] >= 2.0:
            bad.append({"duty_pct": overhead["duty_pct"],
                        "fleet_duty_pct": overhead["fleet_duty_pct"]})
        if overhead["overhead_pct"] >= 10.0:
            bad.append({"overhead_pct": overhead["overhead_pct"]})
        print(f"[profile] overhead "
              f"off={overhead['catalogue_profile_off_s']:.2f}s "
              f"on={overhead['catalogue_profile_on_s']:.2f}s "
              f"({overhead['overhead_pct']:+.2f}% wall, "
              f"duty={overhead['duty_pct']:.2f}% "
              f"fleet={overhead['fleet_duty_pct']:.2f}%)", flush=True)
        report = {
            "rows": args.rows, "seed": args.seed,
            "ok": not bad, "bad": bad,
            "rounds": [attrib, pool_rnd], "overhead": overhead,
        }
        _write_report(args.json_out, report)
        print(f"\nprofile soak {'OK' if report['ok'] else 'FAILED'} "
              f"-> {args.json_out}")
        if bad:
            print(f"bad: {bad}")
        return 0 if report["ok"] else 1

    if args.durability or args.driver:
        cells = _corruption_sweep(tables, args) if args.durability else []
        rounds = [_driver_kill_round(args)] if args.driver else []
        shutil.rmtree(tmpdir, ignore_errors=True)
        for k, v in saved_conf.items():
            setattr(conf, k, v)
        bad = []
        for c in cells:
            if c["outcome"] != "recovered":
                bad.append({"cell": f"{c['point']}/{c['query']}",
                            "outcome": c["outcome"]})
            elif not c.get("detected_ok"):
                bad.append({"cell": f"{c['point']}/{c['query']}",
                            "detected_ok": False,
                            "corruption": c.get("corruption")})
            if (c.get("orphans") or c.get("mem_leaked")
                    or c.get("pipeline_leaked")):
                bad.append({"cell": f"{c['point']}/{c['query']}",
                            "leaks": True})
        for r in rounds:
            if r.get("outcome") != "recovered":
                bad.append({"round": r["round"],
                            "outcome": r.get("outcome"), "detail": r})
            print(f"[driver] {r['outcome']:10s} "
                  f"committed={r.get('stages_committed_before_kill')} "
                  f"resume={r.get('resume')} "
                  f"dossiers={r.get('restart_dossiers')} "
                  f"{r.get('seconds', 0):.1f}s", flush=True)
        outcomes = {}
        for c in cells:
            outcomes[c["outcome"]] = outcomes.get(c["outcome"], 0) + 1
        report = {
            "rows": args.rows, "seed": args.seed,
            "outcomes": outcomes, "ok": not bad, "bad": bad,
            "cells": cells, "rounds": rounds,
        }
        _write_report(args.json_out, report)
        print(f"\ndurability soak {'OK' if report['ok'] else 'FAILED'} "
              f"-> {args.json_out}")
        if bad:
            print(f"bad: {bad}")
        return 0 if report["ok"] else 1

    if args.executors:
        rounds = _executor_soak(tables, args)
        shutil.rmtree(tmpdir, ignore_errors=True)
        for k, v in saved_conf.items():
            setattr(conf, k, v)
        bad = []
        for r in rounds:
            for q in r.get("queries", []):
                if q["outcome"] != "clean_ok":
                    bad.append(q)
            if r.get("outcome") not in (None, "recovered"):
                bad.append({"round": r["round"],
                            "outcome": r.get("outcome")})
            if (r.get("orphans") or r.get("mem_leaked")
                    or r.get("pipeline_leaked") or r.get("resource_leaked")):
                bad.append({"round": r["round"], "leaks": True})
            for flag in ("scaling_ok", "dossier_ok", "capacity_shrank",
                         "capacity_recovered"):
                if r.get(flag) is False:
                    bad.append({"round": r["round"], flag: False})
            if (r.get("round", "").startswith("pooled_catalogue")
                    and not r.get("pool_carried_stages")):
                bad.append({"round": r["round"], "pool_carried": 0})
        report = {
            "rows": args.rows, "seed": args.seed,
            "ok": not bad, "bad": bad, "rounds": rounds,
        }
        _write_report(args.json_out, report)
        print(f"\nexecutor soak {'OK' if report['ok'] else 'FAILED'} "
              f"-> {args.json_out}")
        if bad:
            print(f"bad: {bad}")
        return 0 if report["ok"] else 1

    if args.service:
        conf.max_concurrent_queries = max(
            2, min(4, args.concurrent_queries // 2))
        conf.admission_queue_depth = args.concurrent_queries
        rounds = _service_soak(tables, args)
        shutil.rmtree(tmpdir, ignore_errors=True)
        for k, v in saved_conf.items():
            setattr(conf, k, v)
        outcomes = {}
        for r in rounds:
            for q in r["queries"]:
                outcomes[q["outcome"]] = outcomes.get(q["outcome"], 0) + 1
        bad = []
        for r in rounds:
            bad += [q for q in r["queries"]
                    if q["outcome"] == "wrong_answer"]
            bad += r["isolation_violations"]
            if (r["orphans"] or r["mem_leaked"] or r["pipeline_leaked"]
                    or r["resource_leaked"]):
                bad.append({"round": r["round"], "leaks": True})
            if r.get("fairness_ok") is False or r.get("shedding_ok") is False:
                bad.append({"round": r["round"], "behavior": False})
        report = {
            "rows": args.rows, "fail_times": args.fail_times,
            "seed": args.seed,
            "concurrent_queries": args.concurrent_queries,
            "tenants": args.tenants,
            "outcomes": outcomes, "ok": not bad, "rounds": rounds,
        }
        _write_report(args.json_out, report)
        print(f"\noutcomes: {outcomes}")
        print(f"service soak {'OK' if report['ok'] else 'FAILED'} "
              f"-> {args.json_out}")
        return 0 if report["ok"] else 1

    cells = []
    for point in faults.KNOWN_POINTS:
        for kind in kinds:
            rule = {"fail_times": args.fail_times, "kind": kind}
            if kind == "stall":
                rule["ms"] = args.stall_ms
            spec = {"seed": args.seed, "points": {point: rule}}
            if args.supervisor or args.pipeline:
                # scheduling order is part of the schedule only in the
                # sequential harness; the supervisor soak wants the pool,
                # and the pipeline soak needs the concurrent mark so the
                # pipeline layer stays live under the armed spec
                spec["concurrent"] = True
            for query, mode in QUERIES:
                cell = _run_cell(tables, query, mode, spec)
                cell.update(point=point, kind=kind)
                cells.append(cell)
                print(f"[cell] {point:15s} {kind:5s} {query:22s} "
                      f"{cell['outcome']:15s} rung={cell.get('ladder_rung', 0)}"
                      f" {cell['seconds']:.1f}s", flush=True)

    overhead = _overhead(tables)
    if args.supervisor:
        overhead.update(_supervisor_overhead(tables))
    shutil.rmtree(tmpdir, ignore_errors=True)
    for k, v in saved_conf.items():
        setattr(conf, k, v)

    outcomes = {}
    for c in cells:
        outcomes[c["outcome"]] = outcomes.get(c["outcome"], 0) + 1
    bad = ([c for c in cells if c["outcome"] == "wrong_answer"]
           + [c for c in cells if c["orphans"] or c["mem_leaked"]
              or c["pipeline_leaked"]])
    report = {
        "rows": args.rows, "fail_times": args.fail_times,
        "seed": args.seed, "kinds": list(kinds),
        "supervisor": bool(args.supervisor),
        "pipeline": bool(args.pipeline),
        "outcomes": outcomes, "overhead": overhead,
        "ok": not bad, "cells": cells,
    }
    if args.trace_dir:
        from blaze_tpu_torch.runtime import trace

        report["trace"] = {"dir": args.trace_dir,
                           "records": len(trace.TRACE),
                           "dropped_events": trace.TRACE.dropped}
    _write_report(args.json_out, report)
    print(f"\noutcomes: {outcomes}")
    print(f"overhead: {overhead}")
    print(f"soak {'OK' if report['ok'] else 'FAILED'} -> {args.json_out}")
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
