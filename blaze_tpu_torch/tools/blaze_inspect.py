"""blaze-inspect: live query introspection + flight-dossier reader +
acceptance gate over the port.

Four read modes over runtime/progress.py + runtime/flight_recorder.py:

  live        `python -m blaze_tpu_torch.tools.blaze_inspect live [--url
              URL]` — scrape a running engine's /queries debug endpoint
              (the metrics HTTP server, conf.metrics_port) and print one
              row per live query: tenant, phase, progress, ETA, SLO
              headroom. Add a query id (`live <qid>`) for the per-stage
              waterfall from /queries/<qid>.

  list        `python -m blaze_tpu_torch.tools.blaze_inspect list [--dir
              D]` — newest-first summaries of the dossiers under
              conf.flight_dir (or --dir): when, trigger, query, tenant,
              top finding.

  show        `python -m blaze_tpu_torch.tools.blaze_inspect show
              <dossier.json>` — the incident page: trigger, error,
              critical-path breakdown, ranked findings, violated history
              expectations, thread stacks (hang/deadline dossiers).

  waterfall   `python -m blaze_tpu_torch.tools.blaze_inspect waterfall
              <dossier.json>` — replay the run's stage waterfall from
              the dossier's ledger (ASCII gantt with retry/rung
              annotations from the resilience events).

  --gate      acceptance mode. Cell 1 runs the validator catalogue
              clean with the flight recorder armed
              and progress on: ZERO dossiers may appear and the
              progress tap's overhead (min-of-repeats vs instrumented
              baseline) must stay under 1%. Cell 2 pairs a seeded 400ms
              serde.encode stall with an unmeetable 5ms tenant SLO
              through the multi-tenant service: exactly one slo_breach
              dossier must appear, top finding serde_bound. Cell 3
              scrapes /queries MID-QUERY and checks the summary schema
              + monotone progress. The report goes where `--json-out`
              says.

Every mode takes `--device` (default `cuda`); without a card and without
`--device cpu` the tool refuses to start.

    python -m blaze_tpu_torch.tools.blaze_inspect --device cpu --gate \
        --json-out flight.json
"""

import argparse
import json
import os
import shutil
import sys
import tempfile
import threading
import time


# where the engine runs; main() sets it from --device
DEVICE = "cuda"

# same catalogue the doctor gate exercises: every validated query shape
CATALOGUE = [
    ("q1_scan_filter_project", "bhj"),
    ("q2_q06_core_agg", "bhj"),
    ("q3_join_agg_sort", "bhj"),
    ("q4_repartition_sort", "bhj"),
    ("q5_multijoin_limit", "bhj"),
    ("q6_semi_join", "smj"),
    ("q7_left_outer_join", "bhj"),
    ("q8_category_like", "bhj"),
    ("q9_substr_group", "bhj"),
]

STALL_MS = 400
STALL_SPEC = {"seed": 7,
              "points": {"serde.encode": {"kind": "stall",
                                          "nth": 1, "ms": STALL_MS}}}

OVERHEAD_LIMIT_PCT = 1.0
# absolute grace: on a sub-second catalogue pass, scheduler noise alone
# exceeds 1% — a relative bound needs an absolute floor to be meaningful
OVERHEAD_GRACE_MS = 50.0
REPEATS = 3


# -- live mode ---------------------------------------------------------------


def _fetch_json(url):
    from urllib.request import urlopen

    with urlopen(url, timeout=5) as r:
        return json.loads(r.read())


def _fmt_ms(v):
    if v is None:
        return "-"
    return f"{v / 1000:.1f}s" if v >= 1000 else f"{v:.0f}ms"


def live(args):
    base = args.url or f"http://127.0.0.1:{_default_port()}"
    base = base.rstrip("/")
    if args.query_id:
        doc = _fetch_json(f"{base}/queries/{args.query_id}")
        _print_waterfall(doc)
        return 0
    rows = _fetch_json(f"{base}/queries")
    if not rows:
        print("no live queries")
        return 0
    hdr = f"{'QUERY':<14} {'TENANT':<12} {'PHASE':<12} {'PROG':>6} " \
          f"{'ELAPSED':>8} {'ETA':>8} {'SLO HEADROOM':>12} {'ROWS':>10}"
    print(hdr)
    for q in rows:
        print(f"{q['query_id']:<14} {q['tenant_id'] or '-':<12} "
              f"{q['phase']:<12} {q['progress_ratio'] * 100:>5.1f}% "
              f"{_fmt_ms(q['elapsed_ms']):>8} {_fmt_ms(q['eta_ms']):>8} "
              f"{_fmt_ms(q['slo_headroom_ms']):>12} {q['rows']:>10}")
    return 0


def _default_port():
    from blaze_tpu_torch.config import conf

    return int(conf.metrics_port or 9090)


# -- dossier readers ---------------------------------------------------------


def list_mode(args):
    from blaze_tpu_torch.runtime import flight_recorder

    rows = flight_recorder.list_dossiers(args.dir)
    if not rows:
        print("no dossiers" + (f" under {args.dir}" if args.dir else
                               " (set conf.flight_dir / --dir)"))
        return 0
    for r in rows:
        when = time.strftime("%Y-%m-%d %H:%M:%S",
                             time.localtime(r["captured_at"] or 0))
        print(f"{when}  {r['trigger']:<13} {r['query_id']:<14} "
              f"tenant={r['tenant_id'] or '-':<12} "
              f"error={r['error'] or '-':<22} "
              f"top={r['top_finding'] or '-'}")
        print(f"    {r['path']}")
    return 0


def show(args):
    from blaze_tpu_torch.runtime import doctor, flight_recorder

    doc = flight_recorder.load(args.path)
    print(f"== dossier v{doc.get('schema_version')} "
          f"trigger={doc.get('trigger')} query={doc.get('query_id')} "
          f"tenant={doc.get('tenant_id') or '-'} ==")
    err = doc.get("error")
    if err:
        print(f"error: {err['type']}: {err['message']}")
    if doc.get("detail"):
        print(f"detail: {json.dumps(doc['detail'])}")
    cp = doc.get("critical_path")
    if cp:
        for ln in doctor.render_critical_path(cp):
            print(ln)
    findings = doc.get("findings") or []
    if findings:
        for ln in doctor.render_findings(
                [doctor.Finding(**f) for f in findings]):
            print(ln)
    else:
        print("  findings: none")
    violated = [e for e in doc.get("expectations") or [] if e["violated"]]
    for e in violated:
        print(f"  expectation violated: stage {e['stage_id']} took "
              f"{e['ms']:.0f}ms vs p95 {e['expected_ms_p95']:.0f}ms "
              f"(n={e['n']} prior runs)")
    stacks = doc.get("thread_stacks")
    if stacks:
        print(f"thread stacks ({stacks['reason']}, "
              f"{len(stacks['stacks'])} threads):")
        for th in stacks["stacks"]:
            print(f"  -- {th['name']} ({th['thread_id']})")
            for fr in th["frames"][-4:]:
                for ln in fr.splitlines():
                    print(f"     {ln}")
    return 0


def _print_waterfall(doc):
    """ASCII gantt over the per-stage rows of a /queries/<qid> payload
    or a dossier ledger (both carry stage timing + resilience notes)."""
    stages = doc.get("stages") or []
    if not stages:
        print("no stage data")
        return
    print(f"query {doc.get('query_id')} "
          f"({doc.get('phase', doc.get('trigger', '?'))}, "
          f"{_fmt_ms(doc.get('elapsed_ms'))} elapsed)")
    # live payloads carry offsets; ledgers only durations (sequential)
    offsets, t = [], 0.0
    for st in stages:
        off = st.get("started_offset_ms")
        if off is None:
            off = t
        offsets.append(off)
        t = off + (st.get("elapsed_ms") or st.get("ms") or 0.0)
    span = max((o + (st.get("elapsed_ms") or st.get("ms") or 0.0))
               for o, st in zip(offsets, stages)) or 1.0
    width = 40
    for off, st in zip(offsets, stages):
        ms = st.get("elapsed_ms") or st.get("ms") or 0.0
        lead = int(width * off / span)
        bar = max(int(width * ms / span), 1)
        notes = []
        if st.get("retries"):
            notes.append(f"retries={st['retries']}")
        if st.get("rungs"):
            notes.append("rungs=" + ">".join(st["rungs"]))
        if st.get("speculations"):
            notes.append(f"spec={st['speculations']}")
        if st.get("error"):
            notes.append(f"ERROR={st['error']}")
        print(f"  s{st['stage_id']:<3} {st.get('kind', '?'):<12} "
              f"{' ' * lead}{'#' * bar:<{width - lead}} "
              f"{_fmt_ms(ms):>8} rows={st.get('rows', '-')} "
              f"{' '.join(notes)}")


def waterfall(args):
    from blaze_tpu_torch.runtime import flight_recorder

    doc = flight_recorder.load(args.path)
    ledger = doc.get("ledger") or {}
    _print_waterfall({
        "query_id": doc.get("query_id"),
        "trigger": doc.get("trigger"),
        "elapsed_ms": ledger.get("duration_ms"),
        "stages": ledger.get("stages") or [],
    })
    return 0


# -- gate mode ---------------------------------------------------------------


def gate(args):
    from blaze_tpu_torch.config import conf
    from blaze_tpu_torch.runtime import faults, flight_recorder, history, \
        monitor, progress, service, trace
    from blaze_tpu_torch.spark import validator
    from blaze_tpu_torch.spark.local_runner import run_plan

    tmpdir = tempfile.mkdtemp(prefix="flight_gate_tables_")
    flight_dir = tempfile.mkdtemp(prefix="flight_gate_dossiers_")
    paths, frames = validator.generate_tables(tmpdir, rows=args.rows)

    def run_one(query, mode):
        plan, _ = validator.QUERIES[query](paths, frames, mode)
        return run_plan(plan, num_partitions=4, mesh_exchange="off",
                        device=DEVICE)

    saved = {k: getattr(conf, k)
             for k in ("trace_enabled", "monitor_enabled", "history_dir",
                       "fault_injection_spec", "tenant_slo_spec",
                       "flight_dir", "flight_retention", "flight_triggers",
                       "progress_enabled")}
    problems = []
    report = {"rows": args.rows, "repeats": REPEATS}
    try:
        # warm pass: jit/compile caches off-instrument
        conf.update(trace_enabled=False, monitor_enabled=False,
                    history_dir="", fault_injection_spec=None,
                    tenant_slo_spec=None, flight_dir="",
                    progress_enabled=False)
        for query, mode in CATALOGUE:
            run_one(query, mode)

        # cell 1: clean catalogue, recorder armed + progress on — zero
        # dossiers, and the tap overhead stays under the budget.
        # Baseline = the normal instrumented posture (trace+monitor on),
        # so the delta isolates the recorder's and progress's hooks;
        # min-of-repeats on both sides rejects scheduler noise.
        conf.update(trace_enabled=True, monitor_enabled=True)

        def pass_ms():
            t0 = time.perf_counter()
            for query, mode in CATALOGUE:
                run_one(query, mode)
            return (time.perf_counter() - t0) * 1000.0

        base_ms = min(pass_ms() for _ in range(REPEATS))
        conf.update(flight_dir=flight_dir, progress_enabled=True)
        flight_recorder.reset()
        on_ms = min(pass_ms() for _ in range(REPEATS))
        overhead_pct = (100.0 * (on_ms - base_ms) / base_ms
                        if base_ms > 0 else 0.0)
        report["baseline_ms"] = round(base_ms, 1)
        report["instrumented_ms"] = round(on_ms, 1)
        report["overhead_pct"] = round(overhead_pct, 3)
        report["overhead_grace_ms"] = OVERHEAD_GRACE_MS
        if overhead_pct > OVERHEAD_LIMIT_PCT and \
                (on_ms - base_ms) > OVERHEAD_GRACE_MS:
            problems.append(
                f"progress/flight overhead {overhead_pct:.2f}% "
                f"({on_ms - base_ms:.1f}ms) exceeds "
                f"{OVERHEAD_LIMIT_PCT}% + {OVERHEAD_GRACE_MS}ms grace")
        spurious = os.listdir(flight_dir)
        report["spurious_dossiers"] = len(spurious)
        if spurious:
            problems.append(f"{len(spurious)} dossier(s) on a clean "
                            f"catalogue: {spurious[:3]}")
        if progress.active():
            problems.append("progress registry leaked entries after "
                            f"clean runs: {progress.active()}")

        # cell 2: seeded 400ms serde stall + unmeetable 5ms tenant SLO
        # through the service -> exactly one slo_breach dossier whose
        # top-ranked finding is serde_bound
        conf.update(tenant_slo_spec={"gate-tenant": {"latency_ms": 5.0,
                                                     "target": 0.9}})
        service.reset_slo()
        flight_recorder.reset()
        plan, _ = validator.QUERIES["q2_q06_core_agg"](paths, frames,
                                                       "bhj")
        faults.install(STALL_SPEC)
        try:
            with service.QueryService() as svc:
                fut = svc.submit(plan, tenant_id="gate-tenant",
                                 num_partitions=4, mesh_exchange="off",
                                 device=DEVICE)
                fut.result(timeout=120)
        finally:
            faults.install(None)
        breach = [d for d in flight_recorder.list_dossiers(flight_dir)
                  if d["trigger"] == "slo_breach"]
        report["slo_breach_dossiers"] = len(breach)
        report["stall_top_finding"] = (breach[0]["top_finding"]
                                       if breach else None)
        if len(breach) != 1:
            problems.append(f"expected exactly 1 slo_breach dossier, "
                            f"got {len(breach)}")
        elif breach[0]["top_finding"] != "serde_bound":
            problems.append(
                f"seeded {STALL_MS}ms serde stall dossier top finding "
                f"is {breach[0]['top_finding']!r}, expected serde_bound")
        if breach:
            doc = flight_recorder.load(breach[0]["path"])
            if doc.get("schema_version") != flight_recorder.SCHEMA_VERSION:
                problems.append("dossier schema_version mismatch")
            for fld in ("knobs", "trace_events", "critical_path",
                        "findings", "ledger"):
                if not doc.get(fld):
                    problems.append(f"dossier field {fld!r} empty")

        # cell 3: /queries scraped MID-QUERY must serve valid, monotone
        # summaries (the 3am "how far along is it" workflow)
        snaps = []
        done = threading.Event()

        def scraper():
            while not done.is_set():
                status, _ct, body = monitor.serve_path("/queries")
                rows = json.loads(body)
                if status == 200 and rows:
                    snaps.append(rows[0])
                time.sleep(0.002)

        t = threading.Thread(target=scraper, daemon=True)
        t.start()
        try:
            run_one("q3_join_agg_sort", "smj")
        finally:
            done.set()
            t.join()
        report["mid_query_scrapes"] = len(snaps)
        if not snaps:
            problems.append("no mid-query /queries scrape caught a live "
                            "query")
        else:
            want = {"query_id", "tenant_id", "phase", "elapsed_ms",
                    "progress_ratio", "eta_ms", "slo_objective_ms",
                    "slo_headroom_ms", "rows", "stages_total",
                    "stages_done"}
            missing = want - set(snaps[0])
            if missing:
                problems.append(f"/queries summary missing fields: "
                                f"{sorted(missing)}")
            by_q = {}
            for s in snaps:
                by_q.setdefault(s["query_id"], []).append(
                    s["progress_ratio"])
            for qid, ratios in by_q.items():
                if ratios != sorted(ratios):
                    problems.append(f"progress ratio not monotone for "
                                    f"{qid}")
            report["progress_monotone"] = all(
                r == sorted(r) for r in by_q.values())
    finally:
        faults.install(None)
        service.reset_slo()
        for k, v in saved.items():
            setattr(conf, k, v)
        flight_recorder.reset()
        progress.reset()
        history.reset()
        monitor.reset()
        trace.reset()

    report["problems"] = problems
    report["ok"] = not problems
    shutil.rmtree(tmpdir, ignore_errors=True)
    shutil.rmtree(flight_dir, ignore_errors=True)
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(report, f, indent=1)
    print(f"flight gate: overhead={report.get('overhead_pct')}% "
          f"(base={report.get('baseline_ms')}ms), "
          f"spurious={report.get('spurious_dossiers')}, "
          f"slo_breach_dossiers={report.get('slo_breach_dossiers')}, "
          f"stall_top={report.get('stall_top_finding')}, "
          f"scrapes={report.get('mid_query_scrapes')}")
    print(f"flight gate {'OK' if report['ok'] else 'FAILED'} "
          f"-> {args.json_out}")
    for p in problems:
        print(f"  problem: {p}")
    return 0 if report["ok"] else 1


def main(argv=None):
    global DEVICE
    ap = argparse.ArgumentParser(
        prog="python -m blaze_tpu_torch.tools.blaze_inspect")
    sub = ap.add_subparsers(dest="cmd")
    p_live = sub.add_parser("live", help="scrape a running engine's "
                                         "/queries endpoint")
    p_live.add_argument("query_id", nargs="?", default=None)
    p_live.add_argument("--url", default=None,
                        help="metrics server base URL (default "
                             "http://127.0.0.1:<conf.metrics_port>)")
    p_list = sub.add_parser("list", help="list flight dossiers")
    p_list.add_argument("--dir", default=None,
                        help="dossier dir (default conf.flight_dir)")
    p_show = sub.add_parser("show", help="render one dossier")
    p_show.add_argument("path")
    p_wf = sub.add_parser("waterfall", help="replay a dossier's stage "
                                            "waterfall")
    p_wf.add_argument("path")
    ap.add_argument("--gate", action="store_true",
                    help="run the acceptance gate and write its report")
    ap.add_argument("--rows", type=int, default=8000)
    ap.add_argument("--json-out", default=None,
                    help="write the gate report here (default: no file)")
    ap.add_argument("--device", default="cuda",
                    help="torch device the engine runs on (default: the "
                         "CUDA card; --device cpu runs on the host)")
    args = ap.parse_args(argv)
    from blaze_tpu_torch.tools import refuse_device

    if refuse_device("blaze_inspect", args.device):
        return 2
    DEVICE = args.device
    if args.gate:
        return gate(args)
    if args.cmd == "live":
        return live(args)
    if args.cmd == "list":
        return list_mode(args)
    if args.cmd == "show":
        return show(args)
    if args.cmd == "waterfall":
        return waterfall(args)
    ap.print_help()
    return 2


if __name__ == "__main__":
    sys.exit(main())
