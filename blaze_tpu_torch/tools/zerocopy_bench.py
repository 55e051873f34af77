"""Zero-copy data-plane acceptance bench over the port.

Proves the two zero-copy fast paths deliver, on the port's real runtime
objects, and gates on it:

  fetch_ab    same-host shuffle A/B over a live ShuffleServer +
              ShuffleClient: serde frames committed through the
              crash-atomic pair commit (checksum footer stamped), then
              every partition fetched repeatedly with
              conf.shuffle_mmap_enabled on vs off. Gates: the mmap
              side answers byte-identical to the socket side, books
              bytes_moved ONLY (bytes_copied == 0 reader-side), and
              its p50 fetch latency is >= MIN_FETCH_SPEEDUP lower.

  pooled_ab   the q3 catalogue query on a live 2-seat ExecutorPool,
              mmap on vs off (a fresh pool per arm — workers snapshot
              conf at spawn). Gates: pandas-oracle-equal both arms,
              pool really carried stages, the on-arm recorded mmap
              hits and STRICTLY fewer bytes_copied_shuffle than the
              off-arm. On the card each arm's workers pay the engine's
              cold start (torch's import and the CUDA context).

  dict_ab     string-heavy DICT_ROWS-row serde round trip, dict on vs
              off, decoded output compared against the pandas oracle
              column both arms. Gates: oracle-equal both arms, dict
              arm ships fewer serialized bytes AND fewer
              bytes_copied_serde, and dict_cols_encoded counted.

Stands for the JAX package's `make check-zerocopy`. Takes `--device`
(default `cuda`): the batches, the queries and the pool's plan tasks run
there; without a card and without `--device cpu` it refuses to start.
Writes its report only where `--json-out` says.

    python -m blaze_tpu_torch.tools.zerocopy_bench --device cpu \
        --json-out zerocopy.json
"""

import argparse
import json
import os
import shutil
import statistics
import struct
import sys
import tempfile
import time

# where the bench builds its batches and runs its queries; main() sets it
# from --device
DEVICE = "cuda"

# gate thresholds: latency gates loosely vs the x3 acceptance ask
# (shared CI hosts are noisy; the observed collapse is >>10x), byte
# counts gate strictly (deterministic for a fixed workload)
MIN_FETCH_SPEEDUP = 3.0
DICT_ROWS = 2_000_000
FETCH_PARTITIONS = 8
FETCH_ITERS = 40


def _commit_string_pair(tmpdir, rows=120_000):
    """Commit one string-heavy shuffle .data/.index pair (one serde
    frame per partition) through the real crash-atomic commit, returning
    (data_path, index_path, [frame bytes per partition])."""
    import numpy as np

    from blaze_tpu_torch.columnar import serde
    from blaze_tpu_torch.columnar.batch import ColumnBatch
    from blaze_tpu_torch.columnar.types import INT64, STRING, Field, Schema
    from blaze_tpu_torch.runtime import artifacts

    rng = np.random.default_rng(7)
    cities = np.array([f"city_{i:03d}" for i in range(64)])
    schema = Schema([Field("k", INT64), Field("s", STRING)])
    per = rows // FETCH_PARTITIONS
    frames = []
    for p in range(FETCH_PARTITIONS):
        batch = ColumnBatch.from_numpy(
            {"k": rng.integers(0, 1 << 40, per),
             "s": list(cities[rng.integers(0, len(cities), per)])},
            schema, device=DEVICE)
        frames.append(serde.serialize_batch(batch))
    data = os.path.join(tmpdir, "zc_bench_0_0.data")
    index = os.path.join(tmpdir, "zc_bench_0_0.index")
    offsets = [0]
    for fr in frames:
        offsets.append(offsets[-1] + len(fr))

    def write(tmp_data, tmp_index):
        with open(tmp_data, "wb") as f:
            f.write(b"".join(frames))
        with open(tmp_index, "wb") as f:
            f.write(struct.pack(f"<{len(offsets)}Q", *offsets))
        return tuple(len(fr) for fr in frames)

    artifacts.commit_shuffle_pair(write, data, index)
    return data, index, frames


def _fetch_arm(client, rid, mmap_on):
    """One A/B arm: fetch every partition FETCH_ITERS times, returning
    (per-call latencies, concatenated answer bytes, counter deltas)."""
    from blaze_tpu_torch.config import conf
    from blaze_tpu_torch.runtime import monitor

    saved = conf.shuffle_mmap_enabled
    conf.shuffle_mmap_enabled = mmap_on
    copied0, moved0 = monitor.copy_totals()
    zc0 = monitor.zerocopy_stats()
    lats = []
    answer = []
    try:
        for i in range(FETCH_ITERS):
            for p in range(FETCH_PARTITIONS):
                t0 = time.perf_counter()
                frames = client.fetch_frames(rid, p)
                lats.append(time.perf_counter() - t0)
                if i == 0:
                    answer.append(b"".join(bytes(f) for f in frames))
    finally:
        conf.shuffle_mmap_enabled = saved
    copied1, moved1 = monitor.copy_totals()
    zc1 = monitor.zerocopy_stats()
    return lats, b"".join(answer), {
        "bytes_copied_shuffle": copied1["shuffle"] - copied0["shuffle"],
        "bytes_moved_shuffle": moved1["shuffle"] - moved0["shuffle"],
        "mmap_hits": zc1["shuffle_mmap_hits"] - zc0["shuffle_mmap_hits"],
        "mmap_fallbacks": (zc1["shuffle_mmap_fallbacks"]
                           - zc0["shuffle_mmap_fallbacks"]),
    }


def _fetch_ab():
    from blaze_tpu_torch.config import conf
    from blaze_tpu_torch.runtime import monitor
    from blaze_tpu_torch.runtime import shuffle_server as ss

    saved = (conf.artifact_checksums, conf.monitor_enabled)
    conf.artifact_checksums = True
    conf.monitor_enabled = True
    tmpdir = tempfile.mkdtemp(prefix="zc_fetch_")
    server = client = None
    rec = {"round": "fetch_ab", "partitions": FETCH_PARTITIONS,
           "iters": FETCH_ITERS}
    try:
        data, index, frames = _commit_string_pair(tmpdir)
        rec["segment_bytes"] = sum(len(f) for f in frames)
        server = ss.ShuffleServer(os.path.join(tmpdir, "zc.sock"))
        server.register_shuffle("zc/shuffle:0", [(data, index)])
        server.start()
        client = ss.ShuffleClient(server.sock_path)
        off_lats, off_ans, off_ctr = _fetch_arm(client, "zc/shuffle:0",
                                                mmap_on=False)
        on_lats, on_ans, on_ctr = _fetch_arm(client, "zc/shuffle:0",
                                             mmap_on=True)
        p50_off = statistics.median(off_lats)
        p50_on = statistics.median(on_lats)
        speedup = p50_off / p50_on if p50_on > 0 else float("inf")
        rec.update({
            "p50_off_us": round(p50_off * 1e6, 1),
            "p50_on_us": round(p50_on * 1e6, 1),
            "speedup_p50": round(speedup, 1),
            "off": off_ctr, "on": on_ctr,
            "answers_identical": on_ans == off_ans,
        })
        rec["ok"] = (
            rec["answers_identical"]
            and speedup >= MIN_FETCH_SPEEDUP
            # mmap hits book moved-only: the reader-side copy counter
            # must stay flat while moved carries the full volume
            and on_ctr["mmap_hits"] == FETCH_ITERS * FETCH_PARTITIONS
            and on_ctr["bytes_copied_shuffle"] == 0
            and on_ctr["bytes_moved_shuffle"] > 0
            and off_ctr["mmap_hits"] == 0
            and off_ctr["bytes_copied_shuffle"] > 0)
    finally:
        if client is not None:
            client.close()
        if server is not None:
            server.close()
        shutil.rmtree(tmpdir, ignore_errors=True)
        conf.artifact_checksums, conf.monitor_enabled = saved
        monitor.reset()
    return rec


def _pooled_arm(tables, mmap_on):
    from blaze_tpu_torch.config import conf
    from blaze_tpu_torch.runtime import executor_pool as ep
    from blaze_tpu_torch.spark import validator
    from blaze_tpu_torch.spark.local_runner import run_plan

    paths, frames = tables
    saved = conf.shuffle_mmap_enabled
    conf.shuffle_mmap_enabled = mmap_on
    pool = ep.ExecutorPool(count=2, slots=2)
    wd = tempfile.mkdtemp(prefix="zc_pool_")
    arm = {"mmap": mmap_on}
    try:
        pool.start()
        ep.activate(pool)
        plan, oracle = validator.QUERIES["q3_join_agg_sort"](
            paths, frames, "smj")
        info = {}
        t0 = time.perf_counter()
        out = run_plan(plan, num_partitions=4, work_dir=wd,
                       mesh_exchange="off", run_info=info, device=DEVICE)
        arm["seconds"] = round(time.perf_counter() - t0, 3)
        diff = validator._compare(
            validator._to_pandas(out).reset_index(drop=True),
            oracle().reset_index(drop=True))
        arm["oracle_equal"] = diff is None
        if diff is not None:
            arm["diff"] = diff
        arm["pool_stages"] = int(info.get("pool_stages", 0))
        for k in ("bytes_copied_shuffle", "bytes_moved_shuffle",
                  "bytes_copied_total", "shuffle_mmap_hits",
                  "shuffle_mmap_fallbacks"):
            arm[k] = int(info.get(k, 0))
        # the workers' import and device start-up, summed over the seats
        arm["pool_engine_start_s"] = float(info.get("pool_engine_start_s",
                                                    0.0))
    finally:
        ep.deactivate(pool)
        pool.close()
        shutil.rmtree(wd, ignore_errors=True)
        conf.shuffle_mmap_enabled = saved
    return arm


def _pooled_ab(tables):
    from blaze_tpu_torch.config import conf
    from blaze_tpu_torch.runtime import monitor

    saved = conf.monitor_enabled
    conf.monitor_enabled = True
    rec = {"round": "pooled_ab", "query": "q3_join_agg_sort",
           "executors": 2}
    try:
        rec["off"] = _pooled_arm(tables, mmap_on=False)
        rec["on"] = _pooled_arm(tables, mmap_on=True)
        on, off = rec["on"], rec["off"]
        rec["ok"] = (
            on["oracle_equal"] and off["oracle_equal"]
            and on["pool_stages"] > 0 and off["pool_stages"] > 0
            and on["shuffle_mmap_hits"] > 0
            and off["shuffle_mmap_hits"] == 0
            and on["bytes_copied_shuffle"] < off["bytes_copied_shuffle"])
    finally:
        conf.monitor_enabled = saved
        monitor.reset()
    return rec


def _dict_arm(vals_np, dict_on):
    import numpy as np

    from blaze_tpu_torch.columnar import serde
    from blaze_tpu_torch.columnar.batch import ColumnBatch
    from blaze_tpu_torch.columnar.types import INT64, STRING, Field, Schema
    from blaze_tpu_torch.config import conf
    from blaze_tpu_torch.runtime import monitor

    n = len(vals_np)
    schema = Schema([Field("k", INT64), Field("s", STRING)])
    batch = ColumnBatch.from_numpy(
        {"k": np.arange(n, dtype=np.int64), "s": list(vals_np)}, schema,
        device=DEVICE)
    saved = conf.dict_encode_strings
    conf.dict_encode_strings = dict_on
    copied0, _ = monitor.copy_totals()
    zc0 = monitor.zerocopy_stats()
    try:
        t0 = time.perf_counter()
        blob = serde.serialize_batch(batch)
        t_enc = time.perf_counter() - t0
        t0 = time.perf_counter()
        hb = serde.deserialize_batch_host(blob, schema)
        t_dec = time.perf_counter() - t0
    finally:
        conf.dict_encode_strings = saved
    copied1, _ = monitor.copy_totals()
    zc1 = monitor.zerocopy_stats()

    col = hb.cols[1]
    if col.kind == "dict":
        mat = np.ascontiguousarray(col.data[col.codes[:hb.num_rows]])
    else:
        mat = np.ascontiguousarray(col.data[:hb.num_rows])
    decoded = mat.view(f"S{mat.shape[1]}").ravel()
    # pandas oracle: the same column through a DataFrame round trip
    # (fixed-width S-compare strips trailing NULs on both sides)
    import pandas as pd

    oracle = pd.DataFrame({"s": vals_np})["s"].to_numpy().astype("S")
    return {
        "dict": dict_on, "rows": n,
        "encoded_kind": col.kind,
        "frame_bytes": len(blob),
        "encode_s": round(t_enc, 3), "decode_s": round(t_dec, 3),
        "bytes_copied_serde": copied1["serde"] - copied0["serde"],
        "dict_cols_encoded": (zc1["dict_cols_encoded"]
                              - zc0["dict_cols_encoded"]),
        "oracle_equal": bool(np.array_equal(decoded, oracle)),
    }


def _dict_ab(rows):
    import numpy as np

    from blaze_tpu_torch.config import conf
    from blaze_tpu_torch.runtime import monitor

    saved = conf.monitor_enabled
    conf.monitor_enabled = True
    rec = {"round": "dict_ab", "rows": rows}
    try:
        rng = np.random.default_rng(11)
        cities = np.array(
            ["tokyo", "delhi", "shanghai", "dhaka", "sao_paulo", "cairo",
             "mexico_city", "beijing", "mumbai", "osaka", "chongqing",
             "karachi", "kinshasa", "lagos", "istanbul", "buenos_aires"])
        vals = cities[rng.integers(0, len(cities), rows)]
        rec["off"] = _dict_arm(vals, dict_on=False)
        rec["on"] = _dict_arm(vals, dict_on=True)
        on, off = rec["on"], rec["off"]
        rec["frame_bytes_ratio"] = round(
            on["frame_bytes"] / max(off["frame_bytes"], 1), 3)
        rec["ok"] = (
            on["oracle_equal"] and off["oracle_equal"]
            and on["encoded_kind"] == "dict"
            and off["encoded_kind"] == "str"
            and on["dict_cols_encoded"] >= 1
            and off["dict_cols_encoded"] == 0
            and on["frame_bytes"] < off["frame_bytes"]
            and on["bytes_copied_serde"] < off["bytes_copied_serde"])
    finally:
        conf.monitor_enabled = saved
        monitor.reset()
    return rec


def main(argv=None) -> int:
    global DEVICE
    ap = argparse.ArgumentParser(
        prog="python -m blaze_tpu_torch.tools.zerocopy_bench")
    ap.add_argument("--rows", type=int, default=8000,
                    help="catalogue table scale for the pooled A/B")
    ap.add_argument("--dict-rows", type=int, default=DICT_ROWS)
    ap.add_argument("--json-out", default=None,
                    help="write the report here (default: no file)")
    ap.add_argument("--device", default="cuda",
                    help="torch device the bench runs on (default: the "
                         "CUDA card; --device cpu runs on the host)")
    args = ap.parse_args(argv)
    from blaze_tpu_torch.tools import refuse_device

    if refuse_device("zerocopy_bench", args.device):
        return 2
    DEVICE = args.device

    from blaze_tpu_torch.spark import validator

    tmpdir = tempfile.mkdtemp(prefix="zc_tables_")
    try:
        tables = validator.generate_tables(tmpdir, rows=args.rows)
        rounds = [_fetch_ab(), _pooled_ab(tables), _dict_ab(args.dict_rows)]
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)

    for r in rounds:
        if r["round"] == "fetch_ab":
            print(f"[fetch_ab]  p50 off={r.get('p50_off_us')}us "
                  f"on={r.get('p50_on_us')}us "
                  f"speedup=x{r.get('speedup_p50')} "
                  f"{'OK' if r.get('ok') else 'FAILED'}", flush=True)
        elif r["round"] == "pooled_ab":
            print(f"[pooled_ab] copied_shuffle "
                  f"off={r['off'].get('bytes_copied_shuffle')} "
                  f"on={r['on'].get('bytes_copied_shuffle')} "
                  f"hits={r['on'].get('shuffle_mmap_hits')} "
                  f"{'OK' if r.get('ok') else 'FAILED'}", flush=True)
        else:
            print(f"[dict_ab]   frame off={r['off'].get('frame_bytes')} "
                  f"on={r['on'].get('frame_bytes')} "
                  f"(x{r.get('frame_bytes_ratio')}) "
                  f"{'OK' if r.get('ok') else 'FAILED'}", flush=True)

    report = {
        "rows": args.rows, "dict_rows": args.dict_rows,
        "device": args.device,
        "ok": all(r.get("ok") for r in rounds),
        "bad": [r["round"] for r in rounds if not r.get("ok")],
        "rounds": rounds,
    }
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(report, f, indent=1)
    print(f"\nzerocopy bench {'OK' if report['ok'] else 'FAILED'}"
          + (f" -> {args.json_out}" if args.json_out else ""))
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
