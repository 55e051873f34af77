"""Query-history reporting + regression gate over the port.

Three modes:

  summarize   `python -m blaze_tpu_torch.tools.history_report
              <history_dir>` — digest the
              store runtime/history.py persists (sharded JSONL of run
              records): per-fingerprint stage costs and observed operator
              cardinalities via StatisticsFeed, the query-duration trend
              across runs, and any cross-run regressions the detector
              flags at the configured threshold.

  --bench     fold the BENCH_*.json files at the repo root (one per
              bench.py round) into the same trend view — rc / parsed
              contract metric per round, so the single-number bench
              rides next to the per-fingerprint history.

  --gate      acceptance mode. Runs the validator mini-catalogue twice
              with the history store enabled (after a warm-up pass),
              then a third pass where the fault injector stalls one
              serde.encode call inside q2 — the detector must flag the
              slowed stage and NOTHING else (zero false positives on
              unperturbed stages), and the history-on catalogue must
              stay within noise of history-off. The report goes where
              `--json-out` says.

Every mode takes `--device` (default `cuda`); without a card and without
`--device cpu` the tool refuses to start.

    python -m blaze_tpu_torch.tools.history_report --device cpu --gate \
        --json-out history.json
"""

import argparse
import glob
import json
import os
import shutil
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# where the engine runs; main() sets it from --device
DEVICE = "cuda"

QUERIES = [  # same coverage as chaos_soak.py / trace_report.py
    ("q1_scan_filter_project", "bhj"),
    ("q2_q06_core_agg", "bhj"),
    ("q3_join_agg_sort", "smj"),
]

# the q2 stall the gate injects: one 400ms hang at the first
# serde.encode call — far above the detector's 100ms jitter grace, far
# below anything that could trip a watchdog
STALL_SPEC = {"seed": 7,
              "points": {"serde.encode": {"kind": "stall",
                                          "nth": 1, "ms": 400}}}


# -- summarize mode ----------------------------------------------------------


def summarize(history_dir):
    from blaze_tpu_torch.runtime import history
    from blaze_tpu_torch.runtime.trace import human_bytes

    store = history.HistoryStore(history_dir)
    records = store.records()
    if not records:
        print(f"no history records under {history_dir}")
        return 1
    feed = history.StatisticsFeed(records)
    lines = [f"== history report: {history_dir} "
             f"({len(records)} runs, {len(store.shards())} shards) =="]

    # query-duration trend, grouped by plan fingerprint (the whole point
    # of fingerprinting: literals change, the trend line doesn't)
    by_plan = {}
    for r in records:
        fp = r.get("plan_fingerprint") or "-"
        by_plan.setdefault(fp, []).append(r.get("duration_ms") or 0.0)
    lines.append("-- query trend (per plan fingerprint) --")
    for fp in sorted(by_plan):
        durs = by_plan[fp]
        spark = " ".join(f"{d:.0f}" for d in durs[-8:])
        lines.append(f"  {fp}  n={len(durs)}  last_ms=[{spark}]")

    # per-fingerprint stage costs
    stage_fps = [(feed.observed_stage_cost(fp), fp)
                 for fp in feed.fingerprints()["stages"]]
    stage_fps = [(c, fp) for c, fp in stage_fps if c]
    stage_fps.sort(key=lambda t: -t[0]["ms_p50"])
    lines.append("-- stage costs (observed, per fingerprint) --")
    for cost, fp in stage_fps[:12]:
        lines.append(
            f"  {fp}  {cost['kind']}[{cost['transport'] or '-'}]  "
            f"n={cost['n']} p50={cost['ms_p50']:.1f}ms "
            f"p95={cost['ms_p95']:.1f}ms "
            f"copied={human_bytes(int(cost['copied_p50']))}")

    # per-operator observed cardinalities (the statistics-feed payload
    # the fusion cost model will consume)
    lines.append("-- operator cardinalities (observed) --")
    op_fps = [(feed.observed_cardinality(fp), fp)
              for fp in feed.fingerprints()["ops"]]
    op_fps = [(c, fp) for c, fp in op_fps if c]
    op_fps.sort(key=lambda t: -t[0]["rows_p50"])
    for card, fp in op_fps[:12]:
        extra = ""
        if card.get("selectivity_p50") is not None:
            extra += f" sel={card['selectivity_p50']:.3f}"
        if card.get("groups_p50") is not None:
            extra += (f" groups={card['groups_p50']:.0f}"
                      f" dense={card['dense_ratio']:.0%}")
        lines.append(f"  {fp}  {card['op']:<18} n={card['n']} "
                     f"rows_p50={card['rows_p50']:.0f}{extra}")

    findings = history.detect_regressions(records)
    if findings:
        lines.append(f"-- REGRESSIONS ({len(findings)}) --")
        for f in findings:
            lines.append(
                f"  {f['fingerprint']} {f['metric']}: latest={f['latest']:.1f}"
                f" vs median={f['median']:.1f} "
                f"(threshold {f['threshold']:.1f}, x{f['ratio']:.2f}, "
                f"n={f['runs']}) query={f['query_id']}")
    else:
        lines.append("regressions: none")
    print("\n".join(lines))
    return 0


def bench_trend():
    """Fold the per-round BENCH_*.json artifacts into a trend table."""
    rows = []
    for path in sorted(glob.glob(os.path.join(REPO, "BENCH_*.json"))):
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            continue
        parsed = doc.get("parsed") or {}
        rows.append((doc.get("n"), os.path.basename(path),
                     doc.get("rc"), parsed))
    if not rows:
        print("no BENCH_*.json artifacts in repo root")
        return 1
    print(f"== bench trend ({len(rows)} rounds) ==")
    for n, name, rc, parsed in rows:
        if parsed:
            print(f"  r{n:02d} {name}: {parsed.get('metric')}="
                  f"{parsed.get('value')}{parsed.get('unit') or ''} "
                  f"vs_baseline={parsed.get('vs_baseline')}")
        else:
            print(f"  r{n:02d} {name}: rc={rc} (no contract line)")
    return 0


# -- gate mode ---------------------------------------------------------------


def gate(args):
    from blaze_tpu_torch.config import conf
    from blaze_tpu_torch.runtime import faults, history, trace
    from blaze_tpu_torch.spark import validator
    from blaze_tpu_torch.spark.local_runner import run_plan

    tmpdir = tempfile.mkdtemp(prefix="history_gate_tables_")
    hist_dir = tempfile.mkdtemp(prefix="history_gate_store_")
    paths, frames = validator.generate_tables(tmpdir, rows=args.rows)

    def run_one(query, mode):
        plan, _ = validator.QUERIES[query](paths, frames, mode)
        return run_plan(plan, num_partitions=4, mesh_exchange="off",
                        device=DEVICE)

    def catalogue():
        t0 = time.time()
        for query, mode in QUERIES:
            run_one(query, mode)
        return round(time.time() - t0, 3)

    saved = {k: getattr(conf, k)
             for k in ("history_dir", "trace_enabled",
                       "fault_injection_spec")}
    problems = []
    try:
        catalogue()  # warm jit caches so the A/B measures the harness
        conf.update(history_dir="", trace_enabled=False)
        history.reset()
        t_off = catalogue()
        # two recorded baseline runs
        conf.update(history_dir=hist_dir, trace_enabled=True)
        t_on = catalogue()
        catalogue()
        # perturbed pass: stall q2's first serde.encode, then give the
        # other queries a clean third sample so the detector evaluates
        # them too (zero-false-positive check needs evaluated peers)
        faults.install(STALL_SPEC)
        slowed = run_one("q2_q06_core_agg", "bhj")
        faults.install(None)
        run_one("q1_scan_filter_project", "bhj")
        run_one("q3_join_agg_sort", "smj")

        records = history.store(hist_dir).records()
        feed = history.StatisticsFeed(records)
        findings = history.detect_regressions(records)
    finally:
        faults.install(None)
        for k, v in saved.items():
            setattr(conf, k, v)
        history.reset()
        trace.reset()

    n_stage_fps = len(feed.fingerprints()["stages"])
    n_op_fps = len(feed.fingerprints()["ops"])
    if len(records) != 3 * len(QUERIES):
        problems.append(f"expected {3 * len(QUERIES)} run records, "
                        f"got {len(records)}")
    if not n_stage_fps or not feed.observed_stage_cost(
            next(iter(feed.fingerprints()["stages"]), None)):
        problems.append("statistics feed has no stage costs")
    if not n_op_fps:
        problems.append("statistics feed has no operator cardinalities")

    slowed_qid = records[-3]["query_id"] if len(records) >= 3 else None
    true_pos = [f for f in findings if f["query_id"] == slowed_qid
                and f["metric"] == "wall_ms"]
    false_pos = [f for f in findings if f not in true_pos]
    if not true_pos:
        problems.append("detector missed the injected 400ms stall in q2")
    if false_pos:
        problems.append(
            f"{len(false_pos)} false positive(s) on unperturbed stages: "
            + "; ".join(f"{f['fingerprint']}/{f['metric']}@{f['query_id']}"
                        for f in false_pos))
    # noise gate, not a microbench (same posture as trace_report): the
    # bound catches an accidental O(rows) ingest cost, not a 5% delta
    if t_on > t_off * 1.5 + 1.0:
        problems.append(f"history overhead out of noise: "
                        f"on={t_on}s off={t_off}s")

    report = {
        "rows": args.rows,
        "catalogue_history_off_s": t_off,
        "catalogue_history_on_s": t_on,
        "overhead_pct": round(100 * (t_on - t_off) / t_off, 1) if t_off
        else None,
        "runs_recorded": len(records),
        "stage_fingerprints": n_stage_fps,
        "operator_fingerprints": n_op_fps,
        "regressions_flagged": [
            {"fingerprint": f["fingerprint"], "metric": f["metric"],
             "latest": f["latest"], "median": f["median"],
             "ratio": f["ratio"], "query_id": f["query_id"]}
            for f in findings],
        "false_positives": len(false_pos),
        "slowed_query": slowed_qid,
        "problems": problems,
        "ok": not problems,
    }
    shutil.rmtree(tmpdir, ignore_errors=True)
    if args.keep_history_dir:
        report["history_dir"] = hist_dir
    else:
        shutil.rmtree(hist_dir, ignore_errors=True)
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(report, f, indent=1)
    print(f"history gate: off={t_off}s on={t_on}s runs={len(records)} "
          f"flagged={len(findings)} false_pos={len(false_pos)}")
    print(f"history gate {'OK' if report['ok'] else 'FAILED'} "
          f"-> {args.json_out}")
    for p in problems:
        print(f"  problem: {p}")
    return 0 if report["ok"] else 1


def main(argv=None):
    global DEVICE
    ap = argparse.ArgumentParser(
        prog="python -m blaze_tpu_torch.tools.history_report")
    ap.add_argument("history_dir", nargs="?", default=None,
                    help="history store directory (conf.history_dir) to "
                         "summarize")
    ap.add_argument("--bench", action="store_true",
                    help="fold the BENCH_*.json files at the repo root "
                         "into the trend view")
    ap.add_argument("--gate", action="store_true",
                    help="run the record/record/perturb acceptance gate "
                         "and write its report")
    ap.add_argument("--rows", type=int, default=8000)
    ap.add_argument("--keep-history-dir", action="store_true")
    ap.add_argument("--json-out", default=None,
                    help="write the gate report here (default: no file)")
    ap.add_argument("--device", default="cuda",
                    help="torch device the engine runs on (default: the "
                         "CUDA card; --device cpu runs on the host)")
    args = ap.parse_args(argv)
    from blaze_tpu_torch.tools import refuse_device

    if refuse_device("history_report", args.device):
        return 2
    DEVICE = args.device
    if args.gate:
        return gate(args)
    rc = 0
    ran = False
    if args.bench:
        rc = bench_trend()
        ran = True
    if args.history_dir:
        rc = summarize(args.history_dir) or rc
        ran = True
    if not ran:
        print("usage: history_report <history_dir> | --bench | --gate",
              file=sys.stderr)
        return 2
    return rc


if __name__ == "__main__":
    sys.exit(main())
