"""Mesh-exchange scaling measurement over the port.

Times the port's grouped exchange (`parallel/shuffle.
mesh_shuffle_batch_grouped`) over D devices and prints one JSON line:
`devices`, `partitions`, `rows_per_device`, `exchange_ms`, `bytes_per_s`
(the JAX package's tools/mesh_scaling.py keys), plus `logical`, `device`,
what the exchange delivered (`rows_received`, `overflow`) and a `note`.
Each device holds a batch of `--rows` (default 2^16) rows of (i64 `k`,
f64 `v`), hashed on `k` into P logical partitions, ceil(P / D) owned by
each device.

D comes from `--devices`. On the card, D up to
`torch.cuda.device_count()` are distinct cards; past that, and on the
CPU, the D devices are logical copies of the one device (`logical`:
true), as the runtime's logical-device route runs them. A logical curve
measures one device doing D devices' work, and makes no multi-card claim.

The time of one exchange is the difference of 13 and 3 eager reps over
10, each run bracketed by a synchronize of every device, after one
unmeasured run of each. The JAX package differences two lengths of a
`lax.scan` inside one jitted program, which leaves dispatch out; an
eager rep issues each of its launches from Python, so the difference
keeps the per-rep launch cost.

    python -m blaze_tpu_torch.tools.mesh_scaling [P] --devices D \
        [--device cuda|cpu] [--rows N] [--json-out FILE]

Takes `--device` (default `cuda`); without a card and without `--device
cpu` it refuses to start. Writes the line to a file only where
`--json-out` says.
"""

import argparse
import json
import sys
import time

ROWS = 1 << 16
NOTE = ("exchange_ms is (13 reps - 3 reps) / 10 of eager launches, each "
        "run bracketed by a device synchronize: it keeps the per-rep launch "
        "cost, which the JAX package's lax.scan difference excluded. "
        "logical devices are copies of one device and make no multi-card "
        "claim.")


def exchange_devices(count, device):
    """(`count` torch devices for the exchange, whether they are logical
    copies of one device)."""
    import torch

    from blaze_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda" and count <= torch.cuda.device_count():
        return [torch.device("cuda", i) for i in range(count)], False
    return [dev] * count, True


def make_batches(devices, rows):
    """One batch of `rows` rows on each device: device d holds rows
    [d * rows, (d + 1) * rows) of the seeded draw the JAX tool shards."""
    import numpy as np

    from blaze_tpu_torch.columnar import types as T
    from blaze_tpu_torch.columnar.batch import ColumnBatch

    schema = T.Schema([T.Field("k", T.INT64), T.Field("v", T.FLOAT64)])
    D = len(devices)
    rng = np.random.default_rng(3)
    n = D * rows
    k = rng.integers(0, 1 << 20, n).astype(np.int64)
    v = rng.random(n)
    return [ColumnBatch.from_numpy(
        {"k": k[d * rows:(d + 1) * rows], "v": v[d * rows:(d + 1) * rows]},
        schema, capacity=rows, device=dev)
        for d, dev in enumerate(devices)]


def exchange(batches, devices, partitions, rows):
    """One grouped exchange: (a batch a device, a count tensor a device,
    the overflow)."""
    from blaze_tpu_torch.parallel.shuffle import mesh_shuffle_batch_grouped

    kpd = -(-partitions // len(devices))
    return mesh_shuffle_batch_grouped(batches, [0], devices, partitions,
                                      kpd, quota=rows * kpd)


def measure(count, partitions, device, rows=ROWS):
    """The tool's JSON record for D = `count` devices."""
    import torch

    devices, logical = exchange_devices(count, device)
    batches = make_batches(devices, rows)
    distinct = sorted(set(devices), key=str)

    def sync():
        for d in distinct:
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    def reps(n):
        out = None
        sync()
        t = time.perf_counter()
        for _ in range(n):
            out = exchange(batches, devices, partitions, rows)
        sync()
        return time.perf_counter() - t, out

    reps(3)
    reps(13)
    d1, _ = reps(3)
    d2, (outs, _, overflow) = reps(13)
    per = (d2 - d1) / 10
    total_bytes = count * rows * 16  # i64 + f64, validity-free
    return {
        "devices": count, "partitions": partitions, "rows_per_device": rows,
        "exchange_ms": round(per * 1e3, 2),
        "bytes_per_s": round(total_bytes / per, 0) if per > 0 else None,
        "logical": logical, "device": str(devices[0]),
        "rows_received": sum(int(o.num_rows) for o in outs),
        "overflow": int(overflow),
        "note": NOTE,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m blaze_tpu_torch.tools.mesh_scaling")
    ap.add_argument("partitions", nargs="?", type=int, default=16,
                    help="logical partitions P (default 16)")
    ap.add_argument("--devices", type=int, default=1,
                    help="devices D of the exchange (default 1)")
    ap.add_argument("--rows", type=int, default=ROWS,
                    help="rows a device (default 2^16)")
    ap.add_argument("--json-out", default=None,
                    help="also write the line here (default: no file)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the CUDA card; --device "
                         "cpu runs on the host)")
    args = ap.parse_args(argv)
    from blaze_tpu_torch.tools import refuse_device

    if refuse_device("mesh_scaling", args.device):
        return 2
    rec = measure(args.devices, args.partitions, args.device, args.rows)
    line = json.dumps(rec)
    print(line)
    if args.json_out:
        with open(args.json_out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
