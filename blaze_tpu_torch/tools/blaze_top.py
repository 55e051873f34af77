"""blaze-top: live console over the engine's resource registry.

Renders running queries, task-pool occupancy, memory high-water marks,
copy-boundary totals, compile-cache traffic and breaker state — either
from THIS process's registry (embedders, --demo) or by scraping a
running engine's Prometheus endpoint (--url, any process that set
conf.metrics_port).

Every mode takes `--device` (default `cuda`: --demo's catalogue runs
there); without a card and without `--device cpu` the tool refuses to
start.

Usage:
    python -m blaze_tpu_torch.tools.blaze_top --once  # one local snapshot
    python -m blaze_tpu_torch.tools.blaze_top --url http://host:9109/metrics
    python -m blaze_tpu_torch.tools.blaze_top --demo  # run the catalogue
                                                      # in-process & watch
"""

import argparse
import sys
import time
import urllib.request


# where the engine runs; main() sets it from --device
DEVICE = "cuda"

BAR_W = 30


def _bar(used: float, total: float) -> str:
    frac = 0.0 if total <= 0 else min(max(used / total, 0.0), 1.0)
    n = int(round(frac * BAR_W))
    return "[" + "#" * n + "-" * (BAR_W - n) + f"] {frac * 100:5.1f}%"


def parse_prometheus(text: str) -> dict:
    """{metric_name: value} / {metric_name{labels}: value} from the text
    exposition format (enough structure for rendering, not a full
    client)."""
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        try:
            key, value = line.rsplit(" ", 1)
            out[key] = float(value)
        except ValueError:
            continue
    return out


def render(metrics: dict, source: str) -> str:
    def g(name, default=0.0):
        return metrics.get(name, default)

    from blaze_tpu_torch.runtime.trace import human_bytes

    lines = [f"blaze-top — {source} — {time.strftime('%H:%M:%S')}", ""]
    used, total = g("blaze_mem_used_bytes"), g("blaze_mem_budget_bytes")
    lines.append(f"memory   {_bar(used, total)}  "
                 f"used={human_bytes(int(used))} "
                 f"budget={human_bytes(int(total))} "
                 f"hwm={human_bytes(int(g('blaze_mem_peak_bytes')))}")
    lines.append(
        f"         pipeline_reserved="
        f"{human_bytes(int(g('blaze_mem_pipeline_reserved_bytes')))} "
        f"spill_pages={human_bytes(int(g('blaze_spill_pages_bytes')))} "
        f"spilled={human_bytes(int(g('blaze_spilled_bytes_total')))} "
        f"({int(g('blaze_spill_count_total'))} spills)")
    lines.append("")
    copy_cells = []
    for b in ("serde", "ffi", "shuffle", "spill", "fallback"):
        key = 'blaze_bytes_copied_total{boundary="%s"}' % b
        copy_cells.append(f"{b}={human_bytes(int(g(key)))}")
    lines.append("copies   " + "  ".join(copy_cells))
    lines.append("")
    lines.append(
        f"tasks    active={int(g('blaze_supervisor_active_tasks'))} "
        f"queries={int(g('blaze_queries_running'))} "
        f"pipeline_streams={int(g('blaze_pipeline_live_streams'))} "
        f"queued={int(g('blaze_pipeline_queue_depth'))}")
    lines.append(
        f"compile  hits={int(g('blaze_compile_cache_hits'))} "
        f"misses={int(g('blaze_compile_cache_misses'))} "
        f"compiled={int(g('blaze_compile_compile_count'))}")
    dropped = int(g("blaze_trace_dropped_events_total"))
    lines.append(
        f"trace    buffered={int(g('blaze_trace_buffer_events'))}"
        f"/{int(g('blaze_trace_buffer_capacity'))} "
        f"dropped={dropped}"
        + ("  ** TRACE RING OVERFLOWED **" if dropped else "")
        + f"  monitor_ring={int(g('blaze_monitor_ring_samples'))}"
        f"/{int(g('blaze_monitor_ring_capacity'))}")
    trips = int(g("blaze_faults_breaker_trips"))
    lines.append(
        f"faults   retries={int(g('blaze_faults_retries'))} "
        f"injected={int(g('blaze_faults_faults_injected'))} "
        f"breaker_trips={trips}"
        + ("  ** BREAKER TRIPPED **" if trips else ""))
    rejected = int(g("blaze_admission_rejected_total"))
    lines.append(
        f"service  queue={int(g('blaze_admission_queue_depth'))} "
        f"admitted={int(g('blaze_admission_admitted_total'))} "
        f"parked={int(g('blaze_admission_parked_total'))} "
        f"rejected={rejected}"
        + ("  ** LOAD SHEDDING **" if rejected else ""))
    role_rows = [(k, v) for k, v in metrics.items()
                 if k.startswith("blaze_driver_role{") and v]
    if role_rows or g("blaze_autoscale_target_seats"):
        role = (role_rows[0][0].split('role="', 1)[-1].rstrip('"}')
                if role_rows else "primary")
        ups = int(g('blaze_autoscale_decisions_total{direction="up"}'))
        downs = int(
            g('blaze_autoscale_decisions_total{direction="down"}'))
        lines.append(
            f"fleet    role={role} "
            f"target_seats={int(g('blaze_autoscale_target_seats'))} "
            f"scale_ups={ups} scale_downs={downs}"
            + ("  ** STANDBY **" if role == "standby" else ""))
    rollback_rows = [(k, v) for k, v in metrics.items()
                     if k.startswith("blaze_autopilot_rollbacks_total{")]
    if ("blaze_autopilot_overlays_active" in metrics or rollback_rows):
        rollbacks = int(sum(v for _, v in rollback_rows))
        by_knob = " ".join(
            k.split('knob="', 1)[-1].rstrip('"}') + f"={int(v)}"
            for k, v in sorted(rollback_rows) if v)
        lines.append(
            f"autopilot overlays="
            f"{int(g('blaze_autopilot_overlays_active'))} "
            f"promotions={int(g('blaze_autopilot_promotions_total'))} "
            f"rollbacks={rollbacks}"
            + (f" [{by_knob}]" if by_knob else "")
            + ("  ** ROLLED BACK **" if rollbacks else ""))
    if "blaze_profile_samples_total" in metrics:
        p_dropped = int(g("blaze_profile_dropped_total"))
        lines.append(
            f"profile  samples={int(g('blaze_profile_samples_total'))} "
            f"remote={int(g('blaze_profile_remote_samples_total'))} "
            f"recovered="
            f"{int(g('blaze_profile_recovered_samples_total'))} "
            f"stacks={int(g('blaze_profile_stacks'))} "
            f"duty={g('blaze_profile_fleet_duty_pct'):.2f}%"
            + (f"  ** {p_dropped} SAMPLES DROPPED **" if p_dropped
               else ""))
    exec_rows = [(k, v) for k, v in metrics.items()
                 if k.startswith("blaze_executor_up{")]
    if exec_rows:
        live = int(g("blaze_executor_live"))
        draining = sum(
            1 for k, dv in metrics.items()
            if k.startswith("blaze_executor_draining{") and dv)

        def _state(key, up):
            if not up:
                return "=DOWN"
            sel = key[len("blaze_executor_up"):]
            if g("blaze_executor_draining" + sel):
                return "=draining"
            return "=up"

        up = " ".join(
            k.split('exec_id="', 1)[-1].rstrip('"}') + _state(k, v)
            for k, v in sorted(exec_rows))
        lines.append(
            f"execs    live={live} "
            f"capacity={int(g('blaze_service_capacity'))} "
            f"deaths={int(g('blaze_executor_deaths_total'))} "
            f"restarts={int(g('blaze_executor_restarts_total'))} "
            f"reconnects="
            f"{int(sum(v for k, v in metrics.items() if k.startswith('blaze_executor_reconnects_total{')))} "
            f"drains={int(g('blaze_executor_drains_total'))}  {up}"
            + ("  ** NO EXECUTORS LIVE **" if live == 0 else "")
            + (f"  ** {draining} DRAINING **" if draining else ""))
        # per-executor pane, fed by the federation gauges: one row per
        # exec_id with heartbeat freshness, occupancy and telemetry flow
        for key, v in sorted(exec_rows):
            ex = key.split('exec_id="', 1)[-1].rstrip('"}')
            sel = '{exec_id="' + ex + '"}'
            hb = g("blaze_executor_heartbeat_age_ms" + sel)
            lines.append(
                f"  exec   {ex:<16} "
                f"hb={hb:6.0f}ms "
                f"busy={int(g('blaze_executor_busy_slots' + sel))} "
                f"done={int(g('blaze_executor_tasks_done_total' + sel))} "
                f"tel={human_bytes(int(g('blaze_executor_telemetry_bytes_total' + sel)))}"
                + (f" rc={int(g('blaze_executor_reconnects_total' + sel))}"
                   if g("blaze_executor_reconnects_total" + sel) else "")
                + (" ** DRAINING **"
                   if g("blaze_executor_draining" + sel) else "")
                + ("" if v else "  ** DOWN **"))
    stream_rows = [(k, v) for k, v in metrics.items()
                   if k.startswith("blaze_stream_lag_ms{")]
    for key, lag in sorted(stream_rows):
        # blaze_stream_lag_ms{qid="stream-7"} -> stream-7
        sid = key.split('qid="', 1)[-1].rstrip('"}')
        sel = '{qid="' + sid + '"}'
        lines.append(
            f"stream   {sid:<16} lag={lag:6.0f}ms "
            f"batches={int(g('blaze_stream_batches_total' + sel))} "
            f"ckpt={human_bytes(int(g('blaze_stream_checkpoint_bytes' + sel)))}")
    tenants = [(k, v) for k, v in metrics.items()
               if k.startswith("blaze_tenant_mem_used_bytes{")]
    for key, v in sorted(tenants):
        # blaze_tenant_mem_used_bytes{tenant="a"} -> a
        label = key.split('tenant="', 1)[-1].rstrip('"}')
        lines.append(f"tenant   {label:<16} mem={human_bytes(int(v))}")
    slo_rows = [(k, v) for k, v in metrics.items()
                if k.startswith("blaze_slo_attainment{")]
    for key, v in sorted(slo_rows):
        label = key.split('tenant="', 1)[-1].rstrip('"}')
        sel = 'blaze_slo_%s{tenant="' + label + '"}'
        burn = metrics.get(sel % "burn_rate", 0.0)
        lines.append(
            f"slo      {label:<16} "
            f"objective={int(metrics.get(sel % 'objective_ms', 0))}ms "
            f"attainment={v * 100:5.1f}% "
            f"burn={burn:4.1f}x "
            f"breaches={int(metrics.get(sel % 'breaches_total', 0))}"
            + ("  ** SLO BURNING **" if burn > 1.0 else ""))
    leaks = int(g("blaze_resource_leaks_total"))
    if leaks:
        lines.append(f"LEAKS    {leaks} resource leak(s) recorded")
    return "\n".join(lines)


def local_metrics() -> dict:
    from blaze_tpu_torch.runtime import monitor

    m = parse_prometheus(monitor.prometheus_text())
    # in-process bonus: per-query live rows (not in the scrape payload)
    running = monitor.running_queries()
    if running:
        m["__queries__"] = running
    return m


def render_queries(metrics: dict) -> str:
    rows = metrics.get("__queries__") or []
    if not rows:
        return ""
    from blaze_tpu_torch.runtime.trace import human_bytes

    lines = ["", "queries:"]
    for q in rows:
        lines.append(f"  {q['query_id']:<16} {q['seconds']:>6.1f}s  "
                     f"copied={human_bytes(q['bytes_copied'])} "
                     f"moved={human_bytes(q['bytes_moved'])}")
    return "\n".join(lines)


def _demo_workload(rows: int):
    """Run the validator catalogue on a loop in a daemon thread so the
    console has something to watch."""
    import tempfile
    import threading

    from blaze_tpu_torch.config import conf
    from blaze_tpu_torch.spark import validator
    from blaze_tpu_torch.spark.local_runner import run_plan

    conf.update(trace_enabled=True, monitor_enabled=True)
    tmp = tempfile.mkdtemp(prefix="blaze_top_demo_")
    paths, frames = validator.generate_tables(tmp, rows=rows)

    def loop():
        while True:
            for query, mode in (("q1_scan_filter_project", "bhj"),
                                ("q2_q06_core_agg", "bhj"),
                                ("q3_join_agg_sort", "smj")):
                plan, _ = validator.QUERIES[query](paths, frames, mode)
                run_plan(plan, num_partitions=4, mesh_exchange="off",
                         device=DEVICE)

    threading.Thread(target=loop, daemon=True).start()


def main(argv=None) -> int:
    global DEVICE
    ap = argparse.ArgumentParser(
        prog="python -m blaze_tpu_torch.tools.blaze_top")
    ap.add_argument("--url", default=None,
                    help="Prometheus endpoint of a running engine "
                         "(e.g. http://host:9109/metrics)")
    ap.add_argument("--once", action="store_true",
                    help="print one snapshot and exit")
    ap.add_argument("--interval", type=float, default=1.0)
    ap.add_argument("--demo", action="store_true",
                    help="drive a catalogue loop in-process to watch")
    ap.add_argument("--rows", type=int, default=4000)
    ap.add_argument("--device", default="cuda",
                    help="torch device the engine runs on (default: the "
                         "CUDA card; --device cpu runs on the host)")
    args = ap.parse_args(argv)
    from blaze_tpu_torch.tools import refuse_device

    if refuse_device("blaze_top", args.device):
        return 2
    DEVICE = args.device

    if args.demo:
        _demo_workload(args.rows)

    while True:
        if args.url:
            text = urllib.request.urlopen(args.url, timeout=10) \
                .read().decode()
            metrics, source = parse_prometheus(text), args.url
        else:
            metrics, source = local_metrics(), "in-process"
        frame = render(metrics, source) + render_queries(metrics)
        if args.once:
            print(frame)
            return 0
        # clear + home, no curses dependency
        sys.stdout.write("\x1b[2J\x1b[H" + frame + "\n")
        sys.stdout.flush()
        time.sleep(args.interval)


if __name__ == "__main__":
    sys.exit(main())
