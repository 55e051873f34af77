"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repo root; needs a CUDA card + nvcc

Drives `blaze_tpu_torch` only (no jax, nothing of `blaze_tpu`), on `cuda`:

  1. card       nvidia-smi name + power limit, torch and CUDA versions
  2. build      compiles every kernel of the path from blaze_tpu_torch/csrc/
  3. kernel     the digit-plane accumulate kernel at the main path's shape
                (2^21 rows, 2^16 groups, 7 planes, 3 words), held to its
                plain torch version with torch.equal there and on a ragged,
                an all-masked and a skewed-key input; CUDA-event times of
                the kernel, the plain version and `index_add_` (yardstick
                only) beside the byte bound
  4. main_path  bench.py's q06 plan (ffi_reader -> filter -> project ->
                partial/final agg) over 64 x 2^21 rows and 2^16 groups, as
                TaskDefinition bytes through decode_task_definition ->
                collect_fetch; checked against a numpy oracle (keys and
                counts exact, sums rtol 1e-9); the kernel's launch count
                must rise by one per batch; warm reps timed
  5. profile    one more rep under torch.profiler: device time by kernel
                and the device's idle share of a rep

Every phase prints one JSON line. Then come the kernels line, the card's
`nvidia-smi` line, and last `{"ok": true, "device": {...}}`. Any failure
raises and exits non-zero before the last line.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from blaze_tpu_torch import kernels
from blaze_tpu_torch.columnar import types as T
from blaze_tpu_torch.columnar.batch import ColumnBatch
from blaze_tpu_torch.ops import mxu_agg
from blaze_tpu_torch.plan import plan_pb2 as pb
from blaze_tpu_torch.plan.from_proto import decode_task_definition
from blaze_tpu_torch.runtime import resources
from blaze_tpu_torch.runtime.executor import collect_fetch

ROWS = 1 << 21       # rows per batch (bench.py)
N_BATCHES = 64       # 134M rows, ~3.2 GB input
GROUPS = 1 << 16
REPS = 5
WARM_REPS = 2
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
INT32_OPS_PER_S = 67e12        # data-sheet rate outside the tensor cores

SCHEMA = T.Schema([
    T.Field("ss_item_sk", T.INT32),
    T.Field("ss_quantity", T.INT32),
    T.Field("ss_sales_price", T.FLOAT64),
    T.Field("ss_ext_sales_price", T.FLOAT64),
])
SCHEMA_PB = [("ss_item_sk", pb.TK_INT32), ("ss_quantity", pb.TK_INT32),
             ("ss_sales_price", pb.TK_FLOAT64),
             ("ss_ext_sales_price", pb.TK_FLOAT64)]


# ---------------------------------------------------------------------------
# workload: copies of bench.py's data, oracle and plan construction
# ---------------------------------------------------------------------------

def _make_data(seed):
    rng = np.random.default_rng(seed)
    return {
        "ss_item_sk": rng.integers(0, GROUPS, size=ROWS).astype(np.int32),
        "ss_quantity": rng.integers(1, 100, size=ROWS).astype(np.int32),
        "ss_sales_price": rng.random(ROWS) * 100,
        "ss_ext_sales_price": rng.random(ROWS) * 500,
    }


def _numpy_pipeline(datas):
    out = np.zeros(GROUPS, np.float64)
    cnt = np.zeros(GROUPS, np.int64)
    for data in datas:
        keep = (data["ss_quantity"] <= 50) & (data["ss_sales_price"] > 10.0)
        k = data["ss_item_sk"][keep]
        amount = data["ss_quantity"][keep].astype(np.float64) * \
            data["ss_sales_price"][keep]
        out += np.bincount(k, weights=amount, minlength=GROUPS)
        cnt += np.bincount(k, minlength=GROUPS)
    return out, cnt


def _build_task(schema_fields, resource_id, agg_fns=("sum", "count"),
                final=True):
    """TaskDefinition bytes for the workload (bench.py's plan). agg_fns
    picks the aggregate of `amount` per output column; final=False stops
    at the partial aggregate."""
    fn_map = {"sum": (pb.AGG_SUM, pb.TK_FLOAT64, "sum_amount"),
              "count": (pb.AGG_COUNT, pb.TK_INT64, "cnt"),
              "avg": (pb.AGG_AVG, pb.TK_FLOAT64, "avg_amount")}

    def col(name):
        e = pb.ExprNode()
        e.column.name = name
        return e

    def lit(kind, field, v):
        e = pb.ExprNode()
        e.literal.dtype.kind = kind
        setattr(e.literal, field, v)
        return e

    src = pb.PlanNode()
    for name, kind in schema_fields:
        f = src.ffi_reader.schema.fields.add()
        f.name = name
        f.dtype.kind = kind
    src.ffi_reader.export_iter_resource_id = resource_id

    flt = pb.PlanNode()
    flt.filter.input.CopyFrom(src)
    p1 = flt.filter.predicates.add()
    p1.binary.op = pb.OP_LE
    p1.binary.left.CopyFrom(col("ss_quantity"))
    p1.binary.right.CopyFrom(lit(pb.TK_INT32, "int_value", 50))
    p2 = flt.filter.predicates.add()
    p2.binary.op = pb.OP_GT
    p2.binary.left.CopyFrom(col("ss_sales_price"))
    p2.binary.right.CopyFrom(lit(pb.TK_FLOAT64, "float_value", 10.0))

    proj = pb.PlanNode()
    proj.projection.input.CopyFrom(flt)
    proj.projection.exprs.add().CopyFrom(col("ss_item_sk"))
    amount = pb.ExprNode()
    amount.binary.op = pb.OP_MUL
    cast_q = pb.ExprNode()
    cast_q.cast.child.CopyFrom(col("ss_quantity"))
    cast_q.cast.dtype.kind = pb.TK_FLOAT64
    amount.binary.left.CopyFrom(cast_q)
    amount.binary.right.CopyFrom(col("ss_sales_price"))
    proj.projection.exprs.add().CopyFrom(amount)
    proj.projection.names.extend(["ss_item_sk", "amount"])

    def agg_node(inp, mode):
        n = pb.PlanNode()
        n.agg.input.CopyFrom(inp)
        n.agg.mode = mode
        n.agg.grouping.add().CopyFrom(col("ss_item_sk"))
        n.agg.grouping_names.append("ss_item_sk")
        for fn in agg_fns:
            code, kind, name = fn_map[fn]
            a = n.agg.aggs.add()
            a.fn = code
            a.args.add().CopyFrom(col("amount"))
            a.result_type.kind = kind
            a.name = name
        return n

    root = agg_node(proj, pb.AGG_PARTIAL)
    if final:
        root = agg_node(root, pb.AGG_FINAL)
    td = pb.TaskDefinition()
    td.partition_id = 0
    td.plan.CopyFrom(root)
    return td.SerializeToString()


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def _cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median of per-call CUDA-event times (ms) after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def _kernel_inputs(gen: torch.Generator, n: int, keys: torch.Tensor,
                   ok: torch.Tensor):
    """Main-path-shaped accumulate inputs: the presence count plane plus
    the 6 float-sum digit planes of amount = qty * price at a fixed probed
    scale, exactly as runtime/stage_compiler.py builds them."""
    dev = keys.device
    qty = torch.randint(1, 100, (n,), generator=gen, device=dev)
    price = torch.rand((n,), generator=gen, device=dev,
                       dtype=torch.float64) * 100
    amount = qty.to(torch.float64) * price
    valid = ok.to(torch.bool)
    ones = torch.ones_like(valid)
    cap_bits = 8.0 * mxu_agg.f64_chunks() - 4.0
    scale = cap_bits - (np.floor(np.log2(float(amount.abs().max()))) + 1.0)
    words, recipe, _, _, bad = mxu_agg.digitize(
        valid, [("count", ones), ("sum", amount, ones)],
        fixed_scales={1: scale})
    _require(not bool(bad), "kernel inputs digitized as bad")
    return keys.to(torch.int32).contiguous(), ok.to(torch.int32), words, recipe


def _check_equal(name, keys, ok, words, recipe, gh) -> int:
    got = mxu_agg._accumulate_planes_cuda(keys, ok, words, recipe, gh)
    want = mxu_agg._accumulate_planes_ref(keys, ok, words, recipe, gh)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        raise AssertionError(f"mxu_accumulate != plain version on {name} "
                             f"input (max |diff| {err})")
    return int((got.to(torch.int64) - want.to(torch.int64)).abs().max())


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_card() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    _emit({"phase": "card", "nvidia_smi": smi,
           "device": torch.cuda.get_device_name(0),
           "torch": torch.__version__, "cuda": torch.version.cuda})
    return smi


def phase_build() -> None:
    t0 = time.perf_counter()
    kernels.build_all(sorted(kernels.SIGNATURES))
    for name in sorted(kernels.SIGNATURES):
        kernels.load(name)
    _emit({"phase": "build", "seconds": time.perf_counter() - t0,
           "kernels": kernels.BUILD_INFO})


def phase_kernel() -> dict:
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    n, gh = ROWS, GROUPS // 128
    keys = torch.randint(0, GROUPS, (n,), generator=gen, device=dev)
    # the main path's filter keeps ~45% of rows (qty <= 50, price > 10)
    ok = torch.rand((n,), generator=gen, device=dev) < 0.45
    k, okc, words, recipe = _kernel_inputs(gen, n, keys, ok)
    P, W = len(recipe), len(words)
    max_err = _check_equal("main-path", k, okc, words, recipe, gh)

    # ragged length, masked rows, skewed keys
    m = n - 12345
    max_err = max(max_err, _check_equal(
        "ragged", k[:m].contiguous(), okc[:m].contiguous(),
        [w[:m].contiguous() for w in words], recipe, gh))
    none_ok = torch.zeros_like(okc)
    max_err = max(max_err, _check_equal("all-masked", k, none_ok, words,
                                        recipe, gh))
    hot = torch.randint(0, 8, (n,), generator=gen, device=dev) * 4099
    skew = torch.where(torch.rand((n,), generator=gen, device=dev) < 0.9,
                       hot, keys)
    ks, oks, wss, rs = _kernel_inputs(gen, n, skew, ok)
    max_err = max(max_err, _check_equal("skewed", ks, oks, wss, rs, gh))

    # times at the main-path shape
    kern_ms = _cuda_ms(lambda: mxu_agg._accumulate_planes_cuda(
        k, okc, words, recipe, gh))
    plain_ms = _cuda_ms(lambda: mxu_agg._accumulate_planes_ref(
        k, okc, words, recipe, gh))
    skew_ms = _cuda_ms(lambda: mxu_agg._accumulate_planes_cuda(
        ks, oks, wss, rs, gh))
    # yardstick: one index_add_ over precomputed flat indices and digits
    D = mxu_agg._expand_words(words, recipe) * okc[:, None]
    base = (k >> 7).to(torch.int64) * (P * 128) + (k & 127)
    idx = (base[:, None] + torch.arange(P, device=dev) * 128).reshape(-1)
    vals = D.reshape(-1).contiguous()
    table = torch.zeros(gh * P * 128, dtype=torch.int32, device=dev)

    def lib():
        table.zero_()
        table.index_add_(0, idx, vals)

    lib_ms = _cuda_ms(lib)
    n_ok = int(okc.sum())
    nbytes = (2 + W) * n * 4 + gh * P * 128 * 4
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ok * P / INT32_OPS_PER_S * 1e3
    res = {"phase": "kernel", "name": "mxu_accumulate", "n": n, "gh": gh,
           "planes": P, "words": W, "rows_ok": n_ok,
           "bytes": nbytes, "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "ms": kern_ms, "plain_ms": plain_ms, "library_ms": lib_ms,
           "skewed_ms": skew_ms, "max_abs_err": max_err,
           "checked": ["main-path", "ragged", "all-masked", "skewed"]}
    _emit(res)
    return res


def _digest(out):
    """Weighted checksums over every output column (bench.py's digest)."""
    cap = out.columns[0].data.shape[0]
    dev = out.device
    w = (torch.arange(cap, dtype=torch.float64, device=dev) % 8191.0) + 1.0
    live = torch.arange(cap, device=dev) < out.num_rows
    wl = torch.where(live, w, torch.zeros_like(w))
    return torch.stack([out.num_rows.to(torch.float64)] + [
        torch.dot(c.data.to(torch.float64), wl) for c in out.columns[:3]])


def _full(out):
    return torch.cat([out.num_rows.to(torch.float64)[None]] + [
        c.data.to(torch.float64) for c in out.columns[:3]])


def phase_main_path(kernel: dict):
    t0 = time.perf_counter()
    datas = [_make_data(seed) for seed in range(N_BATCHES)]
    input_bytes = sum(sum(a.nbytes for a in d.values()) for d in datas)
    batches = [ColumnBatch.from_numpy(d, SCHEMA, capacity=ROWS)
               for d in datas]
    torch.cuda.synchronize()
    _require(batches[0].device.type == "cuda", "batches not on cuda")
    ref_sums, ref_cnts = _numpy_pipeline(datas)
    setup_s = time.perf_counter() - t0

    rid = resources.register(lambda: iter(batches))
    plan, _ = decode_task_definition(_build_task(SCHEMA_PB, rid))

    # the run whose launches count and whose result is checked in full
    mxu_agg.KERNEL_LAUNCHES = 0
    t1 = time.perf_counter()
    packed = collect_fetch(plan, _full)
    first_s = time.perf_counter() - t1
    launches = mxu_agg.KERNEL_LAUNCHES
    if launches != N_BATCHES:
        raise AssertionError(f"main path launched mxu_accumulate {launches} "
                             f"times for {N_BATCHES} batches")
    cap = (len(packed) - 1) // 3
    n = int(packed[0])
    keys = packed[1:1 + cap][:n].astype(np.int64)
    sums = packed[1 + cap:1 + 2 * cap][:n]
    cnts = packed[1 + 2 * cap:][:n].astype(np.int64)
    order = np.argsort(keys, kind="stable")
    keys, sums, cnts = keys[order], sums[order], cnts[order]
    nz = ref_cnts > 0
    np.testing.assert_array_equal(keys, np.nonzero(nz)[0])
    np.testing.assert_array_equal(cnts, ref_cnts[nz])
    np.testing.assert_allclose(sums, ref_sums[nz], rtol=1e-9)
    _require(bool(np.all(np.isfinite(sums))), "non-finite sums")

    w = (np.arange(cap, dtype=np.float64) % 8191.0) + 1.0
    wl = np.where(np.arange(cap) < n, w, 0.0)
    host_digest = np.array([float(n), packed[1:1 + cap] @ wl,
                            packed[1 + cap:1 + 2 * cap] @ wl,
                            packed[1 + 2 * cap:] @ wl])
    for _ in range(WARM_REPS):  # allocator and launch caches settle
        collect_fetch(plan, _digest)
    times = []
    for _ in range(REPS):
        t2 = time.perf_counter()
        d = collect_fetch(plan, _digest)
        times.append(time.perf_counter() - t2)
        np.testing.assert_allclose(d, host_digest, rtol=1e-9)
    best, med = min(times), float(np.median(times))
    total_rows = N_BATCHES * ROWS
    _emit({"phase": "main_path", "batches": N_BATCHES, "rows": total_rows,
           "groups": n, "input_bytes": input_bytes, "setup_s": setup_s,
           "first_run_s": first_s, "launches": launches,
           "rep_s": times, "best_rep_s": best, "median_rep_s": med,
           "rows_per_s": total_rows / med,
           "input_GB_per_s": input_bytes / med / 1e9,
           "kernel_share": kernel["ms"] * N_BATCHES / 1e3 / med,
           "max_abs_err_sum": float(np.max(np.abs(sums - ref_sums[nz])))})
    return launches, plan, med


def phase_profile(plan, rep_s: float) -> None:
    """One warm rep of the main path under torch.profiler: device time by
    kernel name and the device's idle share against an unprofiled rep."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        collect_fetch(plan, _digest)
    rows = []
    for e in prof.key_averages():
        if "CUDA" not in str(getattr(e, "device_type", "")):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        rows.append((float(us), e.key, int(e.count)))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    _emit({"phase": "profile", "rep_ms": rep_s * 1e3,
           "device_busy_ms": busy_ms,
           "idle_share": 1.0 - busy_ms / (rep_s * 1e3),
           "top": [{"kernel": k[:100], "ms": us / 1e3, "calls": c}
                   for us, k, c in rows[:12]]})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    smi = phase_card()
    phase_build()
    kern = phase_kernel()
    launches, plan, rep_s = phase_main_path(kern)
    phase_profile(plan, rep_s)
    _emit({"kernels": [{
        "name": "mxu_accumulate", "route": "cuda",
        "source": "blaze_tpu_torch/csrc/mxu_accumulate.cu",
        "replaces": "blaze_tpu/ops/mxu_agg.py:135",
        "launches": launches, "max_abs_err": kern["max_abs_err"],
        "ms": kern["ms"], "plain_ms": kern["plain_ms"],
        "bound_ms": kern["bound_ms"], "bound_by": kern["bound_by"],
        "library_ms": kern["library_ms"]}]})
    print(smi, flush=True)
    _emit({"ok": True, "device": {"platform": "gpu",
                                  "kind": torch.cuda.get_device_name(0),
                                  "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
