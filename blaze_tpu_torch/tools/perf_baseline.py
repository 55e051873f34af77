"""Perf-regression gate + observability acceptance over the port.

Two modes over the validator's catalogue, on `--device`:

  default / --update    run the catalogue with tracing + resource
                        accounting on, collect one record per query from
                        the run (duration, bytes_copied/moved by
                        boundary, peak memory, spill, leaks), and compare
                        against the baseline at `--baseline`. Durations
                        gate loosely (shared hosts are noisy: ratio x2.5
                        + 2s grace); copy counters gate tightly (x1.15 +
                        64KiB) — byte counts are deterministic for a
                        fixed workload, so a copy regression fails loudly
                        while timing noise doesn't. --update writes the
                        baseline instead.

  --obs                 the monitor acceptance sweep — catalogue A/B with
                        conf.monitor_enabled off vs on (sampler thread +
                        live Prometheus endpoint scraped MID-QUERY and
                        format-checked), one chaos cell under the monitor
                        (the port's chaos_soak._run_cell), and a leak
                        count that must be 0.

They stand for the JAX package's `make check-perf`, `make
check-perf-update` and `make check-obs`. The port's baseline is a file of
its own (default `PERF_BASELINE_torch.json`, relative paths from the repo
root), never the JAX package's `PERF_BASELINE.json`. Takes `--device`
(default `cuda`); without a card and without `--device cpu` it refuses to
start. It writes a report (the run's records, or the --obs sweep) only
where `--json-out` says.

    python -m blaze_tpu_torch.tools.perf_baseline --device cpu --update
    python -m blaze_tpu_torch.tools.perf_baseline --device cpu
    python -m blaze_tpu_torch.tools.perf_baseline --device cpu --obs \
        --json-out obs.json
"""

import argparse
import json
import os
import re
import shutil
import sys
import tempfile
import threading
import time
import urllib.request

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# where the gate runs its queries; main() sets it from --device
DEVICE = "cuda"

QUERIES = [  # same catalogue as chaos_soak/trace_report
    ("q1_scan_filter_project", "bhj"),
    ("q2_q06_core_agg", "bhj"),
    ("q3_join_agg_sort", "smj"),
]

# gate thresholds (see module docstring for the asymmetry rationale)
TIME_RATIO = 2.5
TIME_GRACE_S = 2.0
# tight since the zero-copy plane: with mmap shuffle reads booking
# moved-only and strings shipping dict-encoded, baseline copy counts are
# lower AND steadier, so the gate can bite harder before grace bytes
# absorb a regression
COPY_RATIO = 1.15
COPY_GRACE_BYTES = 64 << 10

COPY_KEYS = ("bytes_copied_serde", "bytes_copied_ffi",
             "bytes_copied_shuffle", "bytes_copied_spill",
             "bytes_copied_fallback", "bytes_copied_total",
             "bytes_moved_total")


def _catalogue_records(tables, collect=True):
    """One timed catalogue pass; per-query {duration_s, <copy keys>,
    peak_mem_bytes, spill_bytes, resource_leaks} when collect."""
    from blaze_tpu_torch.spark import validator
    from blaze_tpu_torch.spark.local_runner import run_plan

    paths, frames = tables
    out = {}
    total = 0.0
    for query, mode in QUERIES:
        plan, _ = validator.QUERIES[query](paths, frames, mode)
        info = {}
        t0 = time.perf_counter()
        run_plan(plan, num_partitions=4, mesh_exchange="off", run_info=info,
                 device=DEVICE)
        dt = time.perf_counter() - t0
        total += dt
        if collect:
            rec = {"duration_s": round(dt, 3)}
            for k in COPY_KEYS + ("peak_mem_bytes", "spill_bytes",
                                  "resource_leaks"):
                rec[k] = int(info.get(k, 0))
            out[query] = rec
    return out, round(total, 3)


def _compare(baseline, current):
    problems = []
    for query, base in baseline["queries"].items():
        cur = current.get(query)
        if cur is None:
            problems.append(f"{query}: missing from current run")
            continue
        bt, ct = base["duration_s"], cur["duration_s"]
        if ct > bt * TIME_RATIO + TIME_GRACE_S:
            problems.append(
                f"{query}: duration {ct:.3f}s vs baseline {bt:.3f}s "
                f"(> x{TIME_RATIO} + {TIME_GRACE_S}s)")
        for k in COPY_KEYS:
            bv, cv = base.get(k, 0), cur.get(k, 0)
            if cv > bv * COPY_RATIO + COPY_GRACE_BYTES:
                problems.append(
                    f"{query}: {k} {cv} vs baseline {bv} "
                    f"(> x{COPY_RATIO} + {COPY_GRACE_BYTES}B) — a copy "
                    "regression; rerun with --update only if intended")
        if cur.get("resource_leaks", 0):
            problems.append(
                f"{query}: {cur['resource_leaks']} resource leak(s)")
    return problems


def run_perf(args) -> int:
    from blaze_tpu_torch.config import conf
    from blaze_tpu_torch.spark import validator

    baseline_path = os.path.join(REPO, args.baseline)
    saved = (conf.trace_enabled, conf.monitor_enabled)
    tmp = tempfile.mkdtemp(prefix="perf_baseline_")
    try:
        conf.update(trace_enabled=True, monitor_enabled=True)
        tables = validator.generate_tables(tmp, rows=args.rows)
        _catalogue_records(tables, collect=False)  # warm the process
        queries, total_s = _catalogue_records(tables)
    finally:
        conf.trace_enabled, conf.monitor_enabled = saved
        shutil.rmtree(tmp, ignore_errors=True)

    current = {"rows": args.rows, "catalogue_s": total_s,
               "device": args.device, "queries": queries}
    if args.update:
        with open(baseline_path, "w") as f:
            json.dump(current, f, indent=2, sort_keys=True)
            f.write("\n")
        print(f"[perf] baseline written: {baseline_path} "
              f"(catalogue {total_s}s)")
        return 0
    if not os.path.exists(baseline_path):
        print(f"[perf] no baseline at {baseline_path}; run with --update",
              file=sys.stderr)
        return 1
    with open(baseline_path) as f:
        baseline = json.load(f)
    if baseline.get("rows") != args.rows:
        print(f"[perf] baseline rows={baseline.get('rows')} != "
              f"--rows {args.rows}; not comparable", file=sys.stderr)
        return 1
    problems = _compare(baseline, queries)
    for q, rec in sorted(queries.items()):
        print(f"[perf] {q}: {rec['duration_s']}s "
              f"copied={rec['bytes_copied_total']} "
              f"moved={rec['bytes_moved_total']} "
              f"peak={rec['peak_mem_bytes']}")
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(dict(current, problems=problems), f, indent=2,
                      sort_keys=True)
            f.write("\n")
    if problems:
        for p in problems:
            print(f"[perf] GATE FAILED: {p}", file=sys.stderr)
        return 1
    print(f"[perf] OK: catalogue {total_s}s vs baseline "
          f"{baseline['catalogue_s']}s, copy counters within "
          f"x{COPY_RATIO}")
    return 0


# -- observability acceptance (--obs) ----------------------------------------

_PROM_LINE = re.compile(
    r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? -?[0-9eE+.na-]+$")


def _scrape_check(port: int) -> dict:
    body = urllib.request.urlopen(
        f"http://127.0.0.1:{port}/metrics", timeout=10).read().decode()
    lines = body.splitlines()
    bad = [l for l in lines
           if l and not l.startswith("#") and not _PROM_LINE.match(l)]
    return {"lines": len(lines), "format_errors": bad[:5],
            "has_copy_metric": "blaze_bytes_copied_total" in body}


def run_obs(args) -> int:
    from blaze_tpu_torch.config import conf
    from blaze_tpu_torch.runtime import monitor
    from blaze_tpu_torch.spark import validator
    from blaze_tpu_torch.tools import chaos_soak

    out = {"rows": args.rows, "device": args.device}
    saved = (conf.trace_enabled, conf.monitor_enabled, conf.metrics_port,
             dict(conf.fault_injection_spec or {}))
    saved_device = chaos_soak.DEVICE
    tmp = tempfile.mkdtemp(prefix="obs_gate_")
    try:
        conf.update(trace_enabled=True)
        tables = validator.generate_tables(tmp, rows=args.rows)

        conf.monitor_enabled = True
        _catalogue_records(tables, collect=False)  # warm the process
        # A/B: accounting off vs on (sampler + endpoint live during "on")
        conf.monitor_enabled = False
        _, t_off = _catalogue_records(tables, collect=False)
        conf.monitor_enabled = True
        srv = monitor.MetricsServer(0)
        sampler = monitor.ResourceMonitor(sample_ms=50).start()
        scrape = {}

        def scrape_mid_query():
            # endpoint must serve a valid payload DURING a live query
            time.sleep(0.3)
            try:
                scrape.update(_scrape_check(srv.port))
            except Exception as e:  # noqa: BLE001 — recorded, not raised
                scrape["error"] = repr(e)

        th = threading.Thread(target=scrape_mid_query, daemon=True)
        th.start()
        queries, t_on = _catalogue_records(tables)
        th.join(timeout=30)
        sampler.stop()
        ring = sampler.ring()
        srv.close()

        out["catalogue_monitor_off_s"] = t_off
        out["catalogue_monitor_on_s"] = t_on
        out["overhead_pct"] = round(100.0 * (t_on - t_off) / t_off, 2)
        out["scrape_during_query"] = scrape
        out["sampler_samples"] = len(ring)
        out["copy_totals_by_query"] = {
            q: {k: rec[k] for k in COPY_KEYS} for q, rec in queries.items()}
        out["leaks"] = sum(r.get("resource_leaks", 0)
                           for r in queries.values())

        # one chaos cell with the monitor live: recovery machinery and
        # accounting must coexist (injected faults, retries, fallbacks)
        chaos_soak.DEVICE = DEVICE
        cell = chaos_soak._run_cell(
            tables, "q2_q06_core_agg", "bhj",
            {"seed": 7, "points": {"serde.decode": {"nth": 1, "kind": "io",
                                                    "times": 2}}})
        out["chaos_cell"] = cell
    finally:
        (conf.trace_enabled, conf.monitor_enabled, conf.metrics_port,
         spec) = saved
        conf.fault_injection_spec = spec
        chaos_soak.DEVICE = saved_device
        shutil.rmtree(tmp, ignore_errors=True)

    problems = []
    if out["leaks"]:
        problems.append(f"{out['leaks']} resource leak(s) on a clean "
                        "catalogue")
    if scrape.get("error") or scrape.get("format_errors"):
        problems.append(f"prometheus scrape invalid: {scrape}")
    if not scrape.get("has_copy_metric"):
        problems.append("scrape served no blaze_bytes_copied_total")
    if out["chaos_cell"].get("outcome") not in ("recovered", "no_fire"):
        problems.append(f"chaos cell outcome: {out['chaos_cell']}")
    if out["chaos_cell"].get("mem_leaked") or \
            out["chaos_cell"].get("pipeline_leaked"):
        problems.append("chaos cell leaked memory/streams under monitor")
    # timing gate mirrors trace_report's: noise-tolerant, catches a
    # pathological accounting cost (the per-frame cost is one dict add)
    if t_on > t_off * 1.5 + 1.0:
        problems.append(
            f"monitor-on catalogue {t_on}s vs off {t_off}s (> x1.5 + 1s)")
    out["problems"] = problems

    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(out, f, indent=2, sort_keys=True, default=str)
            f.write("\n")
    print(json.dumps({k: out[k] for k in
                      ("catalogue_monitor_off_s", "catalogue_monitor_on_s",
                       "overhead_pct", "sampler_samples", "leaks")},
                     indent=2))
    if problems:
        for p in problems:
            print(f"[obs] GATE FAILED: {p}", file=sys.stderr)
        return 1
    print("[obs] OK")
    return 0


def main(argv=None) -> int:
    global DEVICE
    ap = argparse.ArgumentParser(
        prog="python -m blaze_tpu_torch.tools.perf_baseline")
    ap.add_argument("--rows", type=int, default=8000)
    ap.add_argument("--baseline", default="PERF_BASELINE_torch.json",
                    help="the port's baseline (relative paths from the "
                         "repo root)")
    ap.add_argument("--update", action="store_true",
                    help="rewrite the baseline from this run")
    ap.add_argument("--obs", action="store_true",
                    help="observability acceptance sweep")
    ap.add_argument("--json-out", default=None,
                    help="write the run's records here (default: no file)")
    ap.add_argument("--device", default="cuda",
                    help="torch device the gate runs on (default: the "
                         "CUDA card; --device cpu runs on the host)")
    args = ap.parse_args(argv)
    from blaze_tpu_torch.tools import refuse_device

    if refuse_device("perf_baseline", args.device):
        return 2
    if os.path.abspath(os.path.join(REPO, args.baseline)) == \
            os.path.join(REPO, "PERF_BASELINE.json"):
        ap.error("PERF_BASELINE.json is the JAX package's baseline; the "
                 "port keeps its own")
    DEVICE = args.device
    if args.obs:
        return run_obs(args)
    return run_perf(args)


if __name__ == "__main__":
    sys.exit(main())
