"""Trace reporting + overhead gate over the port.

Two modes:

  summarize   `python -m blaze_tpu_torch.tools.trace_report <trace_dir>`
              — digest the
              directory runtime/trace.py exports into (ledger.jsonl +
              trace_<qid>.json): per-query durations, the slowest stages
              across all queries, retry/speculation/degrade rates, and
              merged histogram percentiles. The terminal analog of
              loading every Chrome trace into Perfetto at once.

  --bench     run the validator mini-catalogue (the chaos_soak QUERIES)
              tracing-off vs tracing-on on `--device` and write the
              report where `--json-out` says: the
              enabled path must drop ZERO events at the default buffer
              size and stay within noise of the disabled path (the
              "tracing is cheap enough to leave on" claim), and the
              exported Chrome trace must be structurally valid
              (traceEvents list, X/i/M phases, µs timestamps).

Every mode takes `--device` (default `cuda`); without a card and without
`--device cpu` the tool refuses to start.

    python -m blaze_tpu_torch.tools.trace_report --device cpu --bench \
        --json-out trace.json
"""

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

# where the bench runs its queries; main() sets it from --device
DEVICE = "cuda"

QUERIES = [  # same coverage as chaos_soak.py
    ("q1_scan_filter_project", "bhj"),
    ("q2_q06_core_agg", "bhj"),
    ("q3_join_agg_sort", "smj"),
]


# -- summarize mode ----------------------------------------------------------


def load_ledger(trace_dir):
    path = os.path.join(trace_dir, "ledger.jsonl")
    entries = []
    if not os.path.exists(path):
        return entries
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                try:
                    entries.append(json.loads(line))
                except ValueError:
                    continue  # crash-torn line: skip, don't die
    return entries


def summarize(trace_dir):
    from blaze_tpu_torch.runtime.trace import human_bytes

    entries = load_ledger(trace_dir)
    if not entries:
        print(f"no ledger.jsonl under {trace_dir}")
        return 1
    lines = [f"== trace report: {trace_dir} ({len(entries)} queries) =="]

    durs = sorted(e.get("duration_ms") or 0 for e in entries)
    lines.append(
        f"query duration_ms: p50={durs[len(durs) // 2]:.1f} "
        f"max={durs[-1]:.1f}")

    # slowest stages across every query
    stages = [(s.get("ms", 0), e["query_id"], s) for e in entries
              for s in e.get("stages", [])]
    stages.sort(reverse=True)
    lines.append("-- slowest stages --")
    for ms, qid, s in stages[:8]:
        lines.append(
            f"  {ms:9.1f}ms  {qid} stage {s.get('stage_id')} "
            f"{s.get('kind')}[{s.get('transport') or '-'}] "
            f"tasks={s.get('tasks')} bytes={human_bytes(s.get('bytes') or 0)}")

    # resilience-event rates (events per query)
    totals = {}
    for e in entries:
        for k, v in (e.get("resilience_events") or {}).items():
            totals[k] = totals.get(k, 0) + v
    if totals:
        lines.append("-- resilience events (total, per-query rate) --")
        for k in sorted(totals):
            lines.append(f"  {k}: {totals[k]} "
                         f"({totals[k] / len(entries):.2f}/query)")

    # histogram percentiles: the ledger stores per-query percentiles;
    # report the worst (max) p95/p99 seen — the tail a soak cares about
    hists = {}
    for e in entries:
        for name, h in (e.get("histograms") or {}).items():
            cur = hists.setdefault(name, {"count": 0, "p50": 0,
                                          "p95": 0, "p99": 0, "max": 0})
            cur["count"] += h.get("count", 0)
            for p in ("p50", "p95", "p99", "max"):
                cur[p] = max(cur[p], h.get(p) or 0)
    if hists:
        lines.append("-- distributions (worst per-query percentiles) --")
        for name in sorted(hists):
            h = hists[name]
            lines.append(f"  {name}: n={h['count']} p50<={h['p50']} "
                         f"p95<={h['p95']} p99<={h['p99']} max={h['max']}")

    # resource roll-ups (monitor.py counters the runner merges into each
    # ledger line): copy traffic by boundary, memory/spill high-water
    counters = [e.get("counters") or {} for e in entries]

    def csum(key):
        return sum(int(c.get(key, 0)) for c in counters)

    copied = {b: csum(f"bytes_copied_{b}")
              for b in ("serde", "ffi", "shuffle", "spill", "fallback")}
    if any(copied.values()) or csum("bytes_moved_total"):
        lines.append("-- resource roll-up (all queries) --")
        moved = csum("bytes_moved_total")
        total = csum("bytes_copied_total")
        pct = round(100.0 * total / moved) if moved else 0
        lines.append(f"  moved {human_bytes(moved)}, copied "
                     f"{human_bytes(total)} ({pct}%)")
        lines.append("  copied by boundary: " + "  ".join(
            f"{b}={human_bytes(n)}" for b, n in copied.items() if n))
        peak = max((int(c.get("peak_mem_bytes", 0)) for c in counters),
                   default=0)
        lines.append(f"  peak_mem={human_bytes(peak)} "
                     f"spill={human_bytes(csum('spill_bytes'))} "
                     f"({csum('spill_count')} spills) "
                     f"compile={csum('compile_ms')}ms")
    leaks = csum("resource_leaks")
    if leaks:
        lines.append(f"  RESOURCE LEAKS: {leaks} across "
                     f"{sum(1 for c in counters if c.get('resource_leaks'))}"
                     " queries")

    dropped = sum(e.get("dropped_events") or 0 for e in entries)
    lines.append(f"dropped_events: {dropped}")
    print("\n".join(lines))
    return 0


def prom_snapshot(path):
    """Dump this process's Prometheus registry to a file (or '-' for
    stdout) — the scrape payload without standing up the HTTP server."""
    from blaze_tpu_torch.runtime import monitor

    text = monitor.prometheus_text()
    if path == "-":
        sys.stdout.write(text)
    else:
        with open(path, "w") as f:
            f.write(text)
        print(f"prometheus snapshot -> {path} "
              f"({len(text.splitlines())} lines)")
    return 0


# -- bench mode --------------------------------------------------------------


def validate_chrome_trace(path):
    """Structural checks on one exported trace; returns a problem list."""
    problems = []
    with open(path) as f:
        doc = json.load(f)
    evs = doc.get("traceEvents")
    if not isinstance(evs, list) or not evs:
        return ["traceEvents missing or empty"]
    for ev in evs:
        ph = ev.get("ph")
        if ph not in ("X", "i", "M"):
            problems.append(f"unexpected phase {ph!r}")
        if ph in ("X", "i") and not isinstance(ev.get("ts"), (int, float)):
            problems.append("X/i event without numeric ts")
        if ph == "X" and not isinstance(ev.get("dur"), (int, float)):
            problems.append("X event without numeric dur")
        if problems:
            break
    if not any(ev.get("ph") == "X" and ev.get("name") == "query"
               for ev in evs):
        problems.append("no query span in traceEvents")
    return problems


def bench(args):
    from blaze_tpu_torch.config import conf
    from blaze_tpu_torch.runtime import trace
    from blaze_tpu_torch.spark import validator
    from blaze_tpu_torch.spark.local_runner import run_plan

    tmpdir = tempfile.mkdtemp(prefix="trace_bench_tables_")
    trace_dir = tempfile.mkdtemp(prefix="trace_bench_out_")
    tables = validator.generate_tables(tmpdir, rows=args.rows)
    paths, frames = tables

    def catalogue():
        t0 = time.time()
        for query, mode in QUERIES:
            plan, _ = validator.QUERIES[query](paths, frames, mode)
            run_plan(plan, num_partitions=4, mesh_exchange="off",
                     device=DEVICE)
        return round(time.time() - t0, 3)

    saved = {k: getattr(conf, k)
             for k in ("trace_enabled", "trace_export_dir")}
    try:
        catalogue()  # warm jit caches so the A/B measures the harness
        conf.trace_enabled = False
        t_off = catalogue()
        trace.reset()
        conf.trace_enabled = True
        conf.trace_export_dir = trace_dir
        t_on = catalogue()
        dropped = trace.TRACE.dropped
        records = len(trace.TRACE)
    finally:
        for k, v in saved.items():
            setattr(conf, k, v)
        trace.reset()

    ledger = load_ledger(trace_dir)
    traces = sorted(f for f in os.listdir(trace_dir)
                    if f.startswith("trace_") and f.endswith(".json"))
    problems = []
    if not ledger:
        problems.append("no ledger lines exported")
    if not traces:
        problems.append("no chrome traces exported")
    else:
        problems += validate_chrome_trace(os.path.join(trace_dir, traces[-1]))
    if dropped:
        problems.append(f"{dropped} events dropped at default buffer size")
    # noise gate, not a microbench: a short catalogue pass jitters tens
    # of percent on a shared CPU host, so the bound is deliberately loose
    # — it catches an accidental O(rows) cost, not a 5% regression
    if t_on > t_off * 1.5 + 1.0:
        problems.append(f"tracing overhead out of noise: "
                        f"on={t_on}s off={t_off}s")

    report = {
        "rows": args.rows,
        "catalogue_trace_off_s": t_off,
        "catalogue_trace_on_s": t_on,
        "overhead_pct": round(100 * (t_on - t_off) / t_off, 1) if t_off
        else None,
        "trace_records": records,
        "dropped_events": dropped,
        "queries_exported": len(ledger),
        "chrome_traces": len(traces),
        "problems": problems,
        "ok": not problems,
    }
    shutil.rmtree(tmpdir, ignore_errors=True)
    if not args.keep_trace_dir:
        shutil.rmtree(trace_dir, ignore_errors=True)
    else:
        report["trace_dir"] = trace_dir
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(report, f, indent=1)
    print(f"trace bench: off={t_off}s on={t_on}s dropped={dropped} "
          f"exports={len(ledger)}")
    print(f"trace bench {'OK' if report['ok'] else 'FAILED'} "
          f"-> {args.json_out}")
    if problems:
        for p in problems:
            print(f"  problem: {p}")
    return 0 if report["ok"] else 1


def main(argv=None):
    global DEVICE
    ap = argparse.ArgumentParser(
        prog="python -m blaze_tpu_torch.tools.trace_report")
    ap.add_argument("trace_dir", nargs="?", default=None,
                    help="directory of trace_<qid>.json + ledger.jsonl "
                         "exports to summarize")
    ap.add_argument("--bench", action="store_true",
                    help="run the tracing-off vs tracing-on catalogue A/B "
                         "and write its report")
    ap.add_argument("--rows", type=int, default=8000)
    ap.add_argument("--keep-trace-dir", action="store_true")
    ap.add_argument("--json-out", default=None,
                    help="write the bench report here (default: no file)")
    ap.add_argument("--device", default="cuda",
                    help="torch device the bench runs on (default: the "
                         "CUDA card; --device cpu runs on the host)")
    ap.add_argument("--prom-snapshot", default=None, metavar="PATH",
                    help="write this process's Prometheus registry dump "
                         "to PATH ('-' for stdout) and exit")
    args = ap.parse_args(argv)
    from blaze_tpu_torch.tools import refuse_device

    if refuse_device("trace_report", args.device):
        return 2
    DEVICE = args.device
    if args.prom_snapshot:
        return prom_snapshot(args.prom_snapshot)
    if args.bench:
        return bench(args)
    if not args.trace_dir:
        print("usage: trace_report <trace_dir> | --bench", file=sys.stderr)
        return 2
    return summarize(args.trace_dir)


if __name__ == "__main__":
    sys.exit(main())
