"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repo root; needs a CUDA card + nvcc

Drives `blaze_tpu_torch` only (no jax, nothing of `blaze_tpu`), on `cuda`:

  1. card       nvidia-smi name + power limit, torch and CUDA versions
  2. build      compiles every kernel of the path from blaze_tpu_torch/csrc/
  3. kernel     the digit-plane accumulate kernel chain at the main path's
                shape (2^21 rows, 2^16 groups, 7 planes, 3 words), adding
                into an int64 carry, held to its plain torch version with
                torch.equal on uniform keys, on two skews (90% of rows on
                8 keys in 8 slices of the chain, or in one), on one key,
                and on ragged, all-masked and 32-plane inputs. For each
                key distribution: kernel-only device time from the
                profiler's kernel durations (and CUDA events around a
                stretch of prepared launches) and the wrapper's wall time
                a call; the plain version and `index_add_` (yardstick
                only) beside the byte bound
  4. main_path  bench.py's q06 plan (ffi_reader -> filter -> project ->
                partial/final agg) over 64 x 2^21 rows and 2^16 groups, as
                TaskDefinition bytes through decode_task_definition ->
                collect_fetch; checked against a numpy oracle (keys and
                counts exact, sums rtol 1e-9); the chain's launch count,
                and the launches of each of its kernels as the C entry
                reports them, must rise by one per batch; warm reps timed
  5. profile    one more rep under torch.profiler: device time by kernel,
                the device's idle share of a rep, and each chain kernel
                seen on the device once per batch

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


def _stretch_ms(fn, iters: int = 20, stretches: int = 5,
                warmup: int = 3) -> float:
    """Device time of one call (ms): CUDA events around a stretch of
    `iters` back-to-back calls, median over `stretches`. Whatever host work
    a call does is queued behind the device, so a call that the host
    issues faster than the device runs it reads as device time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(stretches):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / iters)
    return float(np.median(times))


def _wall_ms(fn, iters: int = 20, stretches: int = 5) -> float:
    """Host wall time of one call (ms), with the device drained at the end
    of each stretch: median over `stretches` of `iters` calls."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(stretches):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3 / iters)
    return float(np.median(times))


def _profiled_ms(fn, iters: int = 20):
    """Kernel-only device time of one call (ms) from torch.profiler's
    kernel durations, and the per-kernel split {name: (ms, launches)}."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    split = {}
    for e in prof.key_averages():
        if "CUDA" not in str(getattr(e, "device_type", "")):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        ms, calls = split.get(e.key[:80], (0.0, 0.0))
        split[e.key[:80]] = (ms + float(us) / 1e3 / iters,
                             calls + int(e.count) / iters)
    total = sum(ms for ms, _ in split.values())
    return total, split


def _kernel_inputs(gen: torch.Generator, n: int, keys: torch.Tensor,
                   valid: torch.Tensor):
    """Main-path-shaped accumulate inputs: the presence count plane plus
    the 6 float-sum digit planes of amount = qty * price at a fixed probed
    scale, exactly as runtime/stage_compiler.py builds them."""
    dev = keys.device
    qty = torch.randint(1, 100, (n,), generator=gen, device=dev)
    price = torch.rand((n,), generator=gen, device=dev,
                       dtype=torch.float64) * 100
    amount = qty.to(torch.float64) * price
    ones = torch.ones_like(valid)
    cap_bits = 8.0 * mxu_agg.f64_chunks() - 4.0
    scale = cap_bits - (np.floor(np.log2(float(amount.abs().max()))) + 1.0)
    words, recipe, _, _, bad = mxu_agg.digitize(
        valid, [("count", ones), ("sum", amount, ones)],
        fixed_scales={1: scale})
    _require(not bool(bad), "kernel inputs digitized as bad")
    return keys.to(torch.int32).contiguous(), valid, words, recipe


def _check_equal(name, keys, valid, words, recipe, rng) -> int:
    """The chain against its plain version, both adding into one carry of
    random int64 values; returns max |diff| (0, or it raises)."""
    gh = (rng + 127) // 128
    gen = torch.Generator(device=keys.device)
    gen.manual_seed(len(name))
    start = torch.randint(-2**62, 2**62, (gh, len(recipe), 128),
                          generator=gen, device=keys.device)
    got, want = start.clone(), start.clone()
    mxu_agg.accumulate_into(got, keys, valid, words, recipe, rng)
    mxu_agg._accumulate_into_ref(want, keys, valid, words, recipe, rng)
    torch.cuda.synchronize()
    err = int((got - want).abs().max())
    if not torch.equal(got, want):
        raise AssertionError(f"mxu_accumulate != plain version on {name} "
                             f"input (max |diff| {err})")
    return err


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


def _time_case(keys, valid, words, recipe, rng) -> dict:
    """Kernel-only (profiler and event stretch) and wrapper times of the
    chain on one input. Launches made here count; the main path resets the
    counters before its run."""
    gh = (rng + 127) // 128
    acc = torch.zeros((gh, len(recipe), 128), dtype=torch.int64,
                      device=keys.device)
    launch = mxu_agg._chain_call(acc, keys, valid, words, recipe, rng)
    ms, split = _profiled_ms(launch)
    return {"ms": ms, "chain": split,
            "stretch_ms": _stretch_ms(launch),
            "wrapper_ms": _wall_ms(lambda: mxu_agg.accumulate_into(
                acc, keys, valid, words, recipe, rng))}


CHAIN_KERNELS = ("mxu_count_kernel", "mxu_scan_kernel", "mxu_scatter_kernel",
                 "mxu_accumulate_kernel")


def main_path_inputs():
    """The accumulate inputs of one main-path batch, made on the card from
    seed 0, under four key distributions: uniform; 90% of rows on 8 hot
    keys 4099 apart (in 8 key slices of the chain); 90% on keys 0..7 (all
    in one slice); every row on key 4099. Each is (keys, valid, words,
    recipe); only the keys differ."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    n = ROWS
    keys = torch.randint(0, GROUPS, (n,), generator=gen, device=dev)
    # the main path's filter keeps ~45% of rows (qty <= 50, price > 10)
    valid = torch.rand((n,), generator=gen, device=dev) < 0.45
    k, v, words, recipe = _kernel_inputs(gen, n, keys, valid)
    hot = torch.randint(0, 8, (n,), generator=gen, device=dev,
                        dtype=torch.int32)
    on_hot = torch.rand((n,), generator=gen, device=dev) < 0.9

    def case(keys):
        return keys.contiguous(), v, words, recipe

    return {"uniform": case(k),
            "skewed": case(torch.where(on_hot, hot * 4099, k)),
            "skewed-one-slice": case(torch.where(on_hot, hot, k)),
            "one-key": case(torch.full_like(k, 4099))}


def phase_kernel() -> dict:
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    n, rng = ROWS, GROUPS
    gh = rng // 128
    cases = main_path_inputs()
    k, v, words, recipe = cases["uniform"]
    P, W = len(recipe), len(words)
    max_err = max(_check_equal(name, *case, rng)
                  for name, case in cases.items())

    # ragged length, masked rows, 32 planes
    m = n - 12345
    max_err = max(max_err, _check_equal(
        "ragged", k[:m].contiguous(), v[:m].contiguous(),
        [w[:m].contiguous() for w in words], recipe, rng))
    max_err = max(max_err, _check_equal(
        "all-masked", k, torch.zeros_like(v), words, recipe, rng))
    wide = [torch.randint(-2**31, 2**31, (n,), generator=gen, device=dev,
                          dtype=torch.int32) for _ in range(8)]
    wide_recipe = tuple(("digit", w, sh) for w in range(8)
                        for sh in (0, 8, 16, 24))
    max_err = max(max_err, _check_equal("P=32", k, v, wide, wide_recipe,
                                        rng))

    # times at the main-path shape, for each key distribution
    t = {name: _time_case(*case, rng) for name, case in cases.items()}
    uni = t["uniform"]
    plain_acc = torch.zeros((gh, P, 128), dtype=torch.int64, device=dev)
    plain_ms = _stretch_ms(lambda: mxu_agg._accumulate_into_ref(
        plain_acc, k, v, words, recipe, rng))
    # yardstick: one index_add_ into the carry, indices and masked digits
    # computed beforehand
    idx = mxu_agg._plane_index(k, P).reshape(-1)
    vals = (mxu_agg._expand_words(words, recipe).to(torch.int64)
            * v[:, None]).reshape(-1)
    lib_acc = torch.zeros((gh * P * 128,), dtype=torch.int64, device=dev)
    lib_ms = _stretch_ms(lambda: lib_acc.index_add_(0, idx, vals))
    n_ok = int(v.sum())
    # each input read once, the carry read and written once
    nbytes = (4 + 1 + 4 * W) * n + 2 * gh * P * 128 * 8
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ok * P / INT32_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    res = {"phase": "kernel", "name": "mxu_accumulate", "n": n, "gh": gh,
           "planes": P, "words": W, "rows_ok": n_ok,
           "bytes": nbytes, "bound_ms": bound_ms,
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "ms": uni["ms"], "stretch_ms": uni["stretch_ms"],
           "wrapper_ms": uni["wrapper_ms"],
           "skewed_ms": t["skewed"]["ms"],
           "skewed_one_slice_ms": t["skewed-one-slice"]["ms"],
           "one_key_ms": t["one-key"]["ms"],
           "skewed_wrapper_ms": t["skewed"]["wrapper_ms"],
           "bound_fraction": bound_ms / uni["ms"],
           "plain_ms": plain_ms, "library_ms": lib_ms,
           "ms_over_library": uni["ms"] / lib_ms,
           "wrapper_over_library": uni["wrapper_ms"] / lib_ms,
           "cases": t, "max_abs_err": max_err,
           "checked": list(cases) + ["ragged", "all-masked", "P=32"]}
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
    for name in mxu_agg.CHAIN_LAUNCHES:
        mxu_agg.CHAIN_LAUNCHES[name] = 0
    t1 = time.perf_counter()
    packed = collect_fetch(plan, _full)
    first_s = time.perf_counter() - t1
    launches = mxu_agg.KERNEL_LAUNCHES
    chain = dict(mxu_agg.CHAIN_LAUNCHES)
    if launches != N_BATCHES or set(chain.values()) != {N_BATCHES}:
        raise AssertionError(f"main path launched mxu_accumulate {launches} "
                             f"times ({chain}) for {N_BATCHES} batches")
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
           "chain_launches": chain,
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
    # the chain's kernels as the device ran them: once per batch each
    chain = {name: sum(c for _, key, c in rows if name in key)
             for name in CHAIN_KERNELS}
    if set(chain.values()) != {N_BATCHES}:
        raise AssertionError(f"profiled rep ran the chain's kernels {chain} "
                             f"times for {N_BATCHES} batches")
    _emit({"phase": "profile", "rep_ms": rep_s * 1e3,
           "device_busy_ms": busy_ms,
           "device_launches": sum(r[2] for r in rows),
           "idle_share": 1.0 - busy_ms / (rep_s * 1e3),
           "chain_kernel_calls": chain,
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
        "library_ms": kern["library_ms"],
        "skewed_ms": kern["skewed_ms"],
        "skewed_one_slice_ms": kern["skewed_one_slice_ms"],
        "one_key_ms": kern["one_key_ms"],
        "bound_fraction": kern["bound_fraction"],
        "wrapper_ms": kern["wrapper_ms"],
        "skewed_wrapper_ms": kern["skewed_wrapper_ms"],
        "ms_over_library": kern["ms_over_library"],
        "wrapper_over_library": kern["wrapper_over_library"]}]})
    print(smi, flush=True)
    _emit({"ok": True, "device": {"platform": "gpu",
                                  "kind": torch.cuda.get_device_name(0),
                                  "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
