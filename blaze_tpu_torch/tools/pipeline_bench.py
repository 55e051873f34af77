"""Pipelined-execution benchmark over the port.

Two measurements on `--device`:

  microbench  an I/O-bound shuffle-read loop over REAL serde frames with
              synthetic per-frame I/O latency (sleep) and synthetic
              per-batch device compute (sleep): serial iteration vs
              `pipeline.prefetch`. With producer and consumer each ~T
              per item the serial loop costs ~2T/item and the pipelined
              loop ~T/item, so the gate demands >= 1.3x (loose enough
              for shared-CPU jitter, far above noise). The write-side
              `pipeline.Sink` is measured the same way. Queue occupancy
              and overlap % come from the stream's own stats. The frames
              are built from batches on the device and encoded by serde
              (zstd: the zstandard wheel, or the native library's
              libzstd where there is no wheel).

  catalogue   the validator mini-catalogue with enable_pipeline off vs
              on: BOTH directions must land within a loose noise gate —
              off slower than on out of noise means the serial path
              regressed; on slower than off out of noise means
              pipelining costs real queries more than its machinery
              saves. q2 runs the dense stage, and on the card launches
              the accumulate kernel.

Stands for the JAX package's `make check-pipeline`. Takes `--device`
(default `cuda`); without a card and without `--device cpu` it refuses to
start. Writes its report only where `--json-out` says.

    python -m blaze_tpu_torch.tools.pipeline_bench --device cpu \
        --json-out pipeline.json
"""

import argparse
import json
import shutil
import sys
import tempfile
import time

# where the bench builds its batches and runs its queries; main() sets it
# from --device
DEVICE = "cuda"

QUERIES = [  # same coverage as chaos_soak.py
    ("q1_scan_filter_project", "bhj"),
    ("q2_q06_core_agg", "bhj"),
    ("q3_join_agg_sort", "smj"),
]


def _make_frames(rows, n_frames):
    """Serialized shuffle-style frames of a realistic mixed schema."""
    import numpy as np

    from blaze_tpu_torch.columnar import serde
    from blaze_tpu_torch.columnar import types as T
    from blaze_tpu_torch.columnar.batch import ColumnBatch
    from blaze_tpu_torch.columnar.types import Field, Schema

    schema = Schema([Field("k", T.INT64), Field("v", T.FLOAT64),
                     Field("s", T.STRING)])
    rng = np.random.default_rng(7)
    frames = []
    for _ in range(n_frames):
        b = ColumnBatch.from_numpy(
            {"k": rng.integers(0, 1 << 20, rows),
             "v": rng.random(rows),
             "s": np.array([f"row-{i:08d}" for i in range(rows)])},
            schema, device=DEVICE)
        frames.append(serde.serialize_batch(b))
    return schema, frames


def microbench(args):
    from blaze_tpu_torch.columnar import serde
    from blaze_tpu_torch.runtime import pipeline

    schema, frames = _make_frames(args.rows, args.frames)
    io_s = args.io_ms / 1000.0
    compute_s = args.compute_ms / 1000.0

    def produce():
        # a shuffle read: fetch latency (synthetic) + a REAL frame
        # decompress+decode on whatever thread runs this generator
        for fr in frames:
            time.sleep(io_s)
            yield serde.deserialize_batch_host(fr, schema)

    def consume(stream):
        # "device compute" per batch, on the consumer thread
        n = 0
        for hb in stream:
            time.sleep(compute_s)
            n += hb.num_rows
        return n

    # warm (allocator, imports)
    consume(produce())

    t0 = time.perf_counter()
    rows_serial = consume(produce())
    t_serial = time.perf_counter() - t0

    t0 = time.perf_counter()
    s = pipeline.prefetch(produce(), args.depth, name="bench")
    rows_pipe = consume(s)
    t_pipe = time.perf_counter() - t0
    stats = s.stats()

    if rows_serial != rows_pipe:
        raise RuntimeError(f"pipelined loop saw {rows_pipe} rows, the "
                           f"serial loop {rows_serial}")

    # write side: compute (consumer thread) + frame write (sink worker)
    sunk = []

    def write(fr):
        time.sleep(io_s)
        sunk.append(len(fr))

    def drive(sink_like):
        for fr in frames:
            time.sleep(compute_s)
            sink_like(fr)

    t0 = time.perf_counter()
    drive(write)
    t_sink_serial = time.perf_counter() - t0

    sk = pipeline.Sink(write, args.depth, name="bench_sink")
    t0 = time.perf_counter()
    drive(lambda fr: sk.submit(fr, len(fr)))
    sk.close()
    t_sink_pipe = time.perf_counter() - t0

    return {
        "frames": args.frames,
        "rows_per_frame": args.rows,
        "synthetic_io_ms": args.io_ms,
        "synthetic_compute_ms": args.compute_ms,
        "prefetch_depth": args.depth,
        "serial_s": round(t_serial, 3),
        "pipelined_s": round(t_pipe, 3),
        "speedup": round(t_serial / t_pipe, 2) if t_pipe else None,
        "sink_serial_s": round(t_sink_serial, 3),
        "sink_pipelined_s": round(t_sink_pipe, 3),
        "sink_speedup": (round(t_sink_serial / t_sink_pipe, 2)
                         if t_sink_pipe else None),
        "queue_max_depth": stats["max_depth"],
        "producer_occupancy_pct": stats["producer_occupancy_pct"],
        "overlap_pct": stats["overlap_pct"],
    }


def catalogue_ab(args):
    """The catalogue with the pipeline off, then on. Each run's answer is
    held against the validator's pandas oracle after the timed pass, and
    its kernel launches (the run's own tally) are kept."""
    from blaze_tpu_torch.config import conf
    from blaze_tpu_torch.spark import validator
    from blaze_tpu_torch.spark.local_runner import run_plan

    checks = {}
    tmpdir = tempfile.mkdtemp(prefix="pipeline_bench_tables_")
    try:
        paths, frames = validator.generate_tables(tmpdir,
                                                  rows=args.catalogue_rows)

        def catalogue(arm):
            runs = []
            t0 = time.time()
            for query, mode in QUERIES:
                plan, oracle = validator.QUERIES[query](paths, frames, mode)
                info = {}
                out = run_plan(plan, num_partitions=4, mesh_exchange="off",
                               run_info=info, device=DEVICE)
                runs.append((query, oracle, out, info))
            dt = round(time.time() - t0, 3)
            checks[arm] = {}
            for query, oracle, out, info in runs:
                got = validator._to_pandas(out)
                diff = validator._compare(got.reset_index(drop=True),
                                          oracle().reset_index(drop=True))
                checks[arm][query] = {
                    "oracle_equal": diff is None,
                    "kernel_launches": int(info.get("kernel_launches", 0))}
                if diff is not None:
                    checks[arm][query]["diff"] = diff
            return dt

        saved = conf.enable_pipeline
        try:
            catalogue("warm")  # the A/B measures the harness, not start-up
            conf.enable_pipeline = False
            t_off = catalogue("off")
            conf.enable_pipeline = True
            t_on = catalogue("on")
        finally:
            conf.enable_pipeline = saved
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    return {"catalogue_rows": args.catalogue_rows,
            "catalogue_pipeline_off_s": t_off,
            "catalogue_pipeline_on_s": t_on,
            "catalogue_checks": checks}


def gate(report):
    """The bench's problems: the speedup floor, the two loose catalogue
    noise gates, leaked streams and any catalogue answer that is not its
    oracle's."""
    problems = []
    if report["speedup"] is None or report["speedup"] < 1.3:
        problems.append(f"pipelined speedup {report['speedup']} < 1.3x "
                        f"on the I/O-bound microbench")
    t_off = report["catalogue_pipeline_off_s"]
    t_on = report["catalogue_pipeline_on_s"]
    # noise gates, not microbenches: a short catalogue pass jitters tens
    # of percent on a shared CPU host, so the bounds are deliberately
    # loose — they catch structural regressions, not 5% drifts
    if t_off > t_on * 1.5 + 1.0:
        problems.append(f"disabled-path overhead out of noise: "
                        f"off={t_off}s on={t_on}s")
    if t_on > t_off * 1.5 + 1.0:
        problems.append(f"pipelining slows the catalogue out of noise: "
                        f"on={t_on}s off={t_off}s")
    if report["live_streams_after"]:
        problems.append(f"{report['live_streams_after']} leaked streams")
    for arm, runs in report["catalogue_checks"].items():
        for query, c in runs.items():
            if not c["oracle_equal"]:
                problems.append(f"{query} ({arm}) differs from its oracle: "
                                f"{c.get('diff')}")
    return problems


def main(argv=None):
    global DEVICE
    ap = argparse.ArgumentParser(
        prog="python -m blaze_tpu_torch.tools.pipeline_bench")
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--rows", type=int, default=4096,
                    help="rows per microbench frame")
    ap.add_argument("--io-ms", type=float, default=8.0,
                    help="synthetic per-frame I/O latency")
    ap.add_argument("--compute-ms", type=float, default=8.0,
                    help="synthetic per-batch compute time")
    ap.add_argument("--depth", type=int, default=2)
    ap.add_argument("--catalogue-rows", type=int, default=8000)
    ap.add_argument("--json-out", default=None,
                    help="write the report here (default: no file)")
    ap.add_argument("--device", default="cuda",
                    help="torch device the bench runs on (default: the "
                         "CUDA card; --device cpu runs on the host)")
    args = ap.parse_args(argv)
    from blaze_tpu_torch.tools import refuse_device

    if refuse_device("pipeline_bench", args.device):
        return 2
    DEVICE = args.device

    from blaze_tpu_torch.runtime import pipeline

    report = microbench(args)
    report.update(catalogue_ab(args))
    report["device"] = args.device
    report["live_streams_after"] = pipeline.live_streams()
    problems = gate(report)
    report["problems"] = problems
    report["ok"] = not problems

    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(report, f, indent=1)
    print(f"pipeline bench: serial={report['serial_s']}s "
          f"pipelined={report['pipelined_s']}s "
          f"speedup={report['speedup']}x overlap={report['overlap_pct']}% "
          f"sink={report['sink_speedup']}x")
    print(f"catalogue: off={report['catalogue_pipeline_off_s']}s "
          f"on={report['catalogue_pipeline_on_s']}s")
    print(f"pipeline bench {'OK' if report['ok'] else 'FAILED'}"
          + (f" -> {args.json_out}" if args.json_out else ""))
    for p in problems:
        print(f"  problem: {p}")
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
