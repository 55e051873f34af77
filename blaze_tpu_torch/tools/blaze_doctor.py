"""blaze-doctor: query diagnosis CLI + acceptance gate over the port.

Two modes over the pure rule engine in runtime/doctor.py:

  summarize   `python -m blaze_tpu_torch.tools.blaze_doctor
              <trace_export_dir>` — doctor every ledger line in an
              export dir (the artifacts local_runner writes when
              conf.trace_export_dir is set): per-query critical-path
              breakdown, longest task chains, ranked findings with
              evidence + suggested knobs. Pass --history <dir> to enable
              the regression-vs-history rule.

  --gate      acceptance mode. Runs the validator catalogue clean (after
              a warm-up pass) — every breakdown must sum to the measured
              wall time within 5% and NO query may produce a finding —
              then two seeded perturbations that the doctor must
              top-rank: a 400ms serde.encode stall (serde_bound) and a
              skewed-partition input where one hash partition holds ~97%
              of the rows (skewed_partition). Diagnosis runs three times
              over the same artifacts and must be byte-identical (the
              chaos-soak determinism contract). A mid-query Prometheus
              scrape must expose the blaze_slo_* gauges for the
              configured tenant. The report goes where `--json-out`
              says.

Every mode takes `--device` (default `cuda`); without a card and without
`--device cpu` the tool refuses to start.

    python -m blaze_tpu_torch.tools.blaze_doctor --device cpu --gate \
        --json-out doctor.json
"""

import argparse
import json
import os
import shutil
import sys
import tempfile
import time


# where the engine runs; main() sets it from --device
DEVICE = "cuda"

# the full validator catalogue: every query shape the engine validates,
# one join mode each (the doctor reads timings, not answers)
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

# seeded perturbation 1: one 400ms hang at the first serde.encode call —
# the serde_encode timing window opens before the injection point, so
# the stall lands squarely in the serde term the doctor ranks
STALL_MS = 400
STALL_SPEC = {"seed": 7,
              "points": {"serde.encode": {"kind": "stall",
                                          "nth": 1, "ms": STALL_MS}}}

# seeded perturbation 2: the fault injector has no per-task targeting
# (rules fire on global call counts), so skew comes from DATA — a
# shuffle key where ~97% of rows share one value, leaving one hash
# partition (and its reduce task) holding nearly the whole table
SKEW_HOT_FRAC = 0.97

SUM_TOLERANCE = 0.05  # |sum(terms) - total_ms| <= 5% of total_ms


# -- summarize mode ----------------------------------------------------------


def summarize(trace_dir, history_dir=None):
    from blaze_tpu_torch.runtime import doctor

    entries = doctor.diagnose_dir(trace_dir, history_dir=history_dir)
    if not entries:
        print(f"no ledger under {trace_dir} (need ledger.jsonl — set "
              f"conf.trace_export_dir when running queries)")
        return 1
    lines = [f"== blaze doctor: {trace_dir} ({len(entries)} queries) =="]
    for e in entries:
        cp = e["critical_path"]
        head = f"-- {e['query_id']}"
        if e.get("tenant_id"):
            head += f" tenant={e['tenant_id']}"
        head += f" total={cp['total_ms']:.1f}ms"
        if cp.get("top_term"):
            head += f" top={cp['top_term']}"
        lines.append(head + " --")
        lines.extend(doctor.render_critical_path(cp))
        if e["findings"]:
            findings = [doctor.Finding(**f) for f in e["findings"]]
            lines.extend(doctor.render_findings(findings))
        else:
            lines.append("  findings: none")
    print("\n".join(lines))
    return 0


# -- gate mode ---------------------------------------------------------------


def _make_skew_table(tmpdir, rows):
    """Parquet with a pathological shuffle key: SKEW_HOT_FRAC of the rows
    share k=3, the rest spread over 64 other keys — after
    shuffle_exchange on k, one partition holds nearly everything."""
    import numpy as np
    import pandas as pd
    import pyarrow.parquet as pq

    from blaze_tpu_torch.columnar import types as T
    from blaze_tpu_torch.spark import validator

    rng = np.random.default_rng(11)
    k = np.where(rng.random(rows) < SKEW_HOT_FRAC, 3,
                 rng.integers(4, 68, rows)).astype(np.int64)
    df = pd.DataFrame({"k": k, "v": rng.random(rows) * 1000.0})
    schema = T.Schema([T.Field("k", T.INT64), T.Field("v", T.FLOAT64)])
    path = os.path.join(tmpdir, "skewed.parquet")
    pq.write_table(validator._to_arrow_typed(df, schema), path,
                   row_group_size=65536)
    return path, schema


def _skew_plan(path, schema):
    """shuffle on the skewed key, then per-partition sort + arithmetic —
    the non-root sort keeps the O(n log n) work INSIDE the reduce task
    (a root sort would merge on the driver and hide the skew)."""
    from blaze_tpu_torch.columnar import types as T
    from blaze_tpu_torch.exprs import ir
    from blaze_tpu_torch.exprs.ir import BinOp, col
    from blaze_tpu_torch.spark import plan_model as P

    sc = P.scan(schema, [(path, [])])
    x = P.shuffle_exchange(sc, [col("k")], 4)
    srt = P.sort(x, [(col("v"), True, True), (col("k"), True, True)])
    return P.project(
        srt,
        [col("k"), ir.Binary(BinOp.ADD,
                             ir.Binary(BinOp.MUL, col("v"), col("v")),
                             col("v"))],
        ["k", "score"],
        T.Schema([T.Field("k", T.INT64), T.Field("score", T.FLOAT64)]))


def _sum_gap_pct(cp):
    total = cp.get("total_ms") or 0.0
    s = sum((cp.get("terms") or {}).values())
    if total <= 0:
        return 0.0 if s == 0 else 100.0
    return 100.0 * abs(s - total) / total


def _top_code(entry):
    return entry["findings"][0]["code"] if entry["findings"] else None


def gate(args):
    from blaze_tpu_torch.config import conf
    from blaze_tpu_torch.runtime import doctor, faults, history, monitor, \
        service, trace
    from blaze_tpu_torch.spark import validator
    from blaze_tpu_torch.spark.local_runner import run_plan

    tmpdir = tempfile.mkdtemp(prefix="doctor_gate_tables_")
    clean_dir = tempfile.mkdtemp(prefix="doctor_gate_clean_")
    stall_dir = tempfile.mkdtemp(prefix="doctor_gate_stall_")
    skew_dir = tempfile.mkdtemp(prefix="doctor_gate_skew_")
    slo_dir = tempfile.mkdtemp(prefix="doctor_gate_slo_")
    paths, frames = validator.generate_tables(tmpdir, rows=args.rows)

    def run_one(query, mode):
        plan, _ = validator.QUERIES[query](paths, frames, mode)
        return run_plan(plan, num_partitions=4, mesh_exchange="off",
                        device=DEVICE)

    saved = {k: getattr(conf, k)
             for k in ("trace_enabled", "trace_export_dir",
                       "monitor_enabled", "doctor_enabled",
                       "history_dir", "history_retention_runs",
                       "fault_injection_spec", "tenant_slo_spec")}
    problems = []
    report = {"rows": args.rows, "skew_rows": args.skew_rows}
    try:
        # warm pass: jit + compile caches, instrumentation off — the
        # measured passes must not see first-run compile storms
        conf.update(trace_enabled=False, monitor_enabled=False,
                    history_dir="", fault_injection_spec=None,
                    tenant_slo_spec=None)
        for query, mode in CATALOGUE:
            run_one(query, mode)
        skew_path, skew_schema = _make_skew_table(tmpdir, args.skew_rows)
        run_plan(_skew_plan(skew_path, skew_schema), num_partitions=4,
                 mesh_exchange="off", device=DEVICE)

        conf.update(trace_enabled=True, monitor_enabled=True,
                    doctor_enabled=True,
                    history_retention_runs=4 * len(CATALOGUE))

        # cell 1: clean catalogue — additive breakdowns, zero findings
        conf.update(trace_export_dir=clean_dir)
        t0 = time.time()
        for query, mode in CATALOGUE:
            run_one(query, mode)
        report["catalogue_s"] = round(time.time() - t0, 3)
        clean = doctor.diagnose_dir(clean_dir)
        if len(clean) != len(CATALOGUE):
            problems.append(f"expected {len(CATALOGUE)} clean ledger "
                            f"lines, got {len(clean)}")
        gaps = [_sum_gap_pct(e["critical_path"]) for e in clean]
        report["max_sum_gap_pct"] = round(max(gaps), 3) if gaps else None
        for e, gap in zip(clean, gaps):
            if gap > 100.0 * SUM_TOLERANCE:
                problems.append(
                    f"{e['query_id']}: breakdown sums {gap:.1f}% away "
                    f"from wall time (tolerance {100 * SUM_TOLERANCE}%)")
        false_pos = [(e["query_id"], f["code"])
                     for e in clean for f in e["findings"]]
        report["clean_false_positives"] = [
            f"{q}:{c}" for q, c in false_pos]
        if false_pos:
            problems.append(
                f"{len(false_pos)} finding(s) on clean queries: "
                + "; ".join(f"{c}@{q}" for q, c in false_pos))

        # cell 2: determinism — same artifacts in, same bytes out, x3
        blobs = {json.dumps(doctor.diagnose_dir(clean_dir),
                            sort_keys=True) for _ in range(3)}
        report["deterministic"] = len(blobs) == 1
        if len(blobs) != 1:
            problems.append("diagnose_dir is not deterministic: "
                            f"{len(blobs)} distinct outputs over 3 runs")

        # cell 3: seeded serde stall must top-rank as serde_bound
        conf.update(trace_export_dir=stall_dir)
        faults.install(STALL_SPEC)
        try:
            run_one("q2_q06_core_agg", "bhj")
        finally:
            faults.install(None)
        stalled = doctor.diagnose_dir(stall_dir)
        top = _top_code(stalled[0]) if stalled else None
        report["stall_top_finding"] = top
        report["stall_findings"] = [
            f["code"] for e in stalled for f in e["findings"]]
        if top != "serde_bound":
            problems.append(
                f"seeded {STALL_MS}ms serde stall diagnosed as "
                f"{top!r}, expected serde_bound")

        # cell 4: skewed input must top-rank as skewed_partition
        conf.update(trace_export_dir=skew_dir)
        run_plan(_skew_plan(skew_path, skew_schema), num_partitions=4,
                 mesh_exchange="off", device=DEVICE)
        skewed = doctor.diagnose_dir(skew_dir)
        top = _top_code(skewed[0]) if skewed else None
        report["skew_top_finding"] = top
        report["skew_findings"] = [
            f["code"] for e in skewed for f in e["findings"]]
        if skewed and skewed[0]["findings"]:
            report["skew_evidence"] = skewed[0]["findings"][0]["evidence"]
        if top != "skewed_partition":
            problems.append(
                f"seeded skewed partition diagnosed as {top!r}, "
                f"expected skewed_partition")

        # cell 5: per-tenant SLO gauges visible in a MID-QUERY scrape
        conf.update(trace_export_dir=slo_dir,
                    tenant_slo_spec={"gate-tenant": {"latency_ms": 5.0,
                                                     "target": 0.9}})
        service.reset_slo()
        plan, _ = validator.QUERIES["q1_scan_filter_project"](
            paths, frames, "bhj")
        with service.QueryService() as svc:
            fut = svc.submit(plan, tenant_id="gate-tenant",
                             num_partitions=4, mesh_exchange="off",
                             device=DEVICE)
            mid = monitor.prometheus_text()  # scraped while the query runs
            fut.result(timeout=120)
        final = monitor.prometheus_text()
        want = [n + '{tenant="gate-tenant"}' for n in
                ("blaze_slo_objective_ms", "blaze_slo_attainment",
                 "blaze_slo_burn_rate", "blaze_slo_breaches_total")]
        missing = [w for w in want if w not in mid]
        report["slo_gauges_mid_query"] = not missing
        if missing:
            problems.append("mid-query scrape missing SLO gauges: "
                            + ", ".join(missing))
        # the 5ms objective is unmeetable, so the completed query must
        # register as a breach in the final scrape
        breach_line = next(
            (ln for ln in final.splitlines()
             if ln.startswith('blaze_slo_breaches_total{tenant='
                              '"gate-tenant"}')), "")
        breaches = float(breach_line.rsplit(" ", 1)[-1]) \
            if breach_line else 0.0
        report["slo_breaches_recorded"] = breaches
        if breaches < 1:
            problems.append("completed query missed its 5ms objective "
                            "but no SLO breach was recorded")
    finally:
        faults.install(None)
        service.reset_slo()
        for k, v in saved.items():
            setattr(conf, k, v)
        history.reset()
        monitor.reset()
        trace.reset()

    report["problems"] = problems
    report["ok"] = not problems
    for d in (tmpdir, clean_dir, stall_dir, skew_dir, slo_dir):
        shutil.rmtree(d, ignore_errors=True)
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(report, f, indent=1)
    print(f"doctor gate: clean={report.get('max_sum_gap_pct')}% max gap, "
          f"false_pos={len(report.get('clean_false_positives') or [])}, "
          f"stall={report.get('stall_top_finding')}, "
          f"skew={report.get('skew_top_finding')}, "
          f"deterministic={report.get('deterministic')}")
    print(f"doctor gate {'OK' if report['ok'] else 'FAILED'} "
          f"-> {args.json_out}")
    for p in problems:
        print(f"  problem: {p}")
    return 0 if report["ok"] else 1


def main(argv=None):
    global DEVICE
    ap = argparse.ArgumentParser(
        prog="python -m blaze_tpu_torch.tools.blaze_doctor")
    ap.add_argument("trace_dir", nargs="?", default=None,
                    help="trace export dir (conf.trace_export_dir) "
                         "holding ledger.jsonl + trace_<qid>.json")
    ap.add_argument("--history", default=None,
                    help="history store dir — enables the "
                         "regression-vs-history rule")
    ap.add_argument("--gate", action="store_true",
                    help="run the seeded-perturbation acceptance gate "
                         "and write its report")
    ap.add_argument("--rows", type=int, default=8000)
    ap.add_argument("--skew-rows", type=int, default=160_000,
                    help="rows in the skew cell's table (sized so the "
                         "hot reduce task clears the doctor's 50ms "
                         "finding floor)")
    ap.add_argument("--json-out", default=None,
                    help="write the gate report here (default: no file)")
    ap.add_argument("--device", default="cuda",
                    help="torch device the engine runs on (default: the "
                         "CUDA card; --device cpu runs on the host)")
    args = ap.parse_args(argv)
    from blaze_tpu_torch.tools import refuse_device

    if refuse_device("blaze_doctor", args.device):
        return 2
    DEVICE = args.device
    if args.gate:
        return gate(args)
    if not args.trace_dir:
        print("usage: blaze_doctor <trace_export_dir> | --gate",
              file=sys.stderr)
        return 2
    return summarize(args.trace_dir, history_dir=args.history)


if __name__ == "__main__":
    sys.exit(main())
