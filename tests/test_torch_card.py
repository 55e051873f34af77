"""Tests of the port that need a CUDA card: the hand-written kernel chain
against its plain torch version, bench.py's q06 plan through it at test
size, and the later paths (general aggregation, sort, hash, partition sort,
serde, spill, joins, the Parquet scan, CASE and IN, the string functions
and a dictionary column's serde round trip, spark/tpcds.py's q02, q03,
q07, q08 and q09 through run_plan, the nested slice: segmented scans,
list take and concatenation, collect_list/collect_set, a window and a
generate batch, the decimal slice: 128-bit limb arithmetic, wide
decimal arithmetic, comparison, CheckOverflow, hash, sort keys and
segmented sum/min/max, the casts that round or parse, and the bitwise and
shift ops, and the Spark-facing slice: every registered scalar function,
the host crossings of hostfns and the UDF wrapper, a row-interpreter
export bridged onto the card, the task runtime: a real device OOM's
classification and the resilience ladder under a fault spec, and the
device-mesh exchange on one device and on four logical devices of the
card, and the executor pool: a worker's kernel launches, its real OOM
and its device memory after a SIGKILL) on the card against the port's
own CPU route.

The kernels have no CPU mode, so every test here skips without a card. The
file imports neither jax nor `blaze_tpu`, so that it runs on a machine that
has only the port's dependencies. On the card, from the repo root:

    python -m pytest --noconftest -m cuda tests/test_torch_card.py -q
"""

import zlib

import numpy as np
import pytest
import torch

import chip_smoke as cs
from blaze_tpu_torch.columnar.batch import ColumnBatch
from blaze_tpu_torch.ops import mxu_agg as M
from blaze_tpu_torch.plan.from_proto import decode_task_definition
from blaze_tpu_torch.runtime import resources
from blaze_tpu_torch.runtime.executor import collect, collect_fetch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _planes(rng, n, recipe_kind):
    """Word columns and recipe of n rows, made on the CPU from a seeded
    numpy generator: "float" is the main path's presence plane plus six
    float-sum digit planes (P = 7), "count" one raw count plane (P = 1),
    "int" an int64 sum's eight digit planes (P = 8), "wide" 32 digit planes
    of eight random words."""
    ones = torch.ones(n, dtype=torch.bool)
    if recipe_kind == "wide":
        words = [torch.from_numpy(rng.integers(-2**31, 2**31, n)
                                  .astype(np.int32)) for _ in range(8)]
        recipe = tuple(("digit", w, sh) for w in range(8)
                       for sh in (0, 8, 16, 24))
        return words, recipe
    if recipe_kind == "count":
        specs = [("count", torch.from_numpy(rng.random(n) < 0.7))]
    elif recipe_kind == "int":
        specs = [("sum", torch.from_numpy(rng.integers(-2**60, 2**60, n)),
                  ones)]
    else:
        specs = [("count", ones),
                 ("sum", torch.from_numpy(rng.standard_normal(n) * 1e3),
                  ones)]
    words, recipe, _, _, _ = M.digitize(ones, specs)
    return words, recipe


def _case(name):
    """(keys, valid, words, recipe, rng) of one named input, on the CPU."""
    n, key_range, recipe_kind, valid_p = 1 << 16, 1 << 14, "float", 0.5
    if name in ("ragged", "unaligned"):
        n = (1 << 16) + 37
    elif name == "one-row":
        n = 1
    elif name == "2^23+1000":
        n, key_range = (1 << 23) + 1000, 1 << 10
    elif name in ("P=1", "P=8", "P=32"):
        recipe_kind = {"P=1": "count", "P=8": "int", "P=32": "wide"}[name]
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    keys = rng.integers(0, key_range, n)
    if name == "skewed":  # 90% of rows on 8 keys
        hot = rng.integers(0, 8, n) * 1031
        keys = np.where(rng.random(n) < 0.9, hot, keys)
    elif name == "one-key":
        keys = np.full(n, 777)
    elif name == "out-of-range":
        keys = rng.integers(-3000, key_range + 3000, n)
    valid = rng.random(n) < (0.0 if name == "all-masked" else valid_p)
    words, recipe = _planes(rng, n, recipe_kind)
    return (torch.from_numpy(keys.astype(np.int32)),
            torch.from_numpy(valid), words, recipe, key_range)


CASES = ["uniform", "skewed", "one-key", "all-masked", "out-of-range",
         "ragged", "unaligned", "one-row", "2^23+1000", "P=1", "P=8", "P=32"]


@pytest.mark.parametrize("name", CASES)
def test_kernel_matches_plain_version_on_card(cuda, name):
    """The chain adds into a carry that already holds random int64 values,
    bit for bit as the plain version does, with one launch a call and one
    of each of its kernels."""
    keys, valid, words, recipe, rng = _case(name)
    keys, valid = keys.to(cuda), valid.to(cuda)
    words = [w.to(cuda) for w in words]
    if name == "unaligned":  # views one row in: the wrapper copies them
        keys, valid, words = keys[1:], valid[1:], [w[1:] for w in words]
    gh = (rng + 127) // 128
    start = torch.from_numpy(np.random.default_rng(5).integers(
        -2**62, 2**62, (gh, len(recipe), 128))).to(cuda)
    got, want = start.clone(), start.clone()
    before, chain_before = M.KERNEL_LAUNCHES, dict(M.CHAIN_LAUNCHES)
    M.accumulate_into(got, keys, valid, words, recipe, rng)
    assert M.KERNEL_LAUNCHES == before + 1
    assert all(M.CHAIN_LAUNCHES[k] == chain_before[k] + 1
               for k in chain_before)
    M._accumulate_into_ref(want, keys, valid, words, recipe, rng)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    if name == "all-masked":
        assert torch.equal(got, start)


def test_carry_over_three_batches_on_card(cuda):
    """A carry accumulated over 3 batches equals the sum of the plain
    version's per-batch tables."""
    acc = torch.zeros((128, 7, 128), dtype=torch.int64, device=cuda)
    want = torch.zeros_like(acc)
    for name in ("uniform", "skewed", "out-of-range"):
        keys, valid, words, recipe, rng = _case(name)
        args = (keys.to(cuda), valid.to(cuda), [w.to(cuda) for w in words],
                recipe, rng)
        M.accumulate_into(acc, *args)
        table = torch.zeros_like(acc)
        M._accumulate_into_ref(table, *args)
        want += table
    torch.cuda.synchronize()
    assert torch.equal(acc, want)


def test_kernel_launches_once_per_2_23_row_block(cuda):
    """accumulate_raw keeps the reference's int32 table: past 2^23 rows it
    is no longer exact, so the wrapper launches once per block and sums
    the blocks."""
    keys, valid, words, recipe, rng = _case("2^23+1000")
    keys, valid = keys.to(cuda), valid.to(cuda)
    words = [w.to(cuda) for w in words]
    before = M.KERNEL_LAUNCHES
    got = M.accumulate_raw(keys, valid, words, recipe, rng)
    assert M.KERNEL_LAUNCHES == before + 2
    assert got.dtype == torch.int32
    want = torch.zeros((rng // 128, len(recipe), 128), dtype=torch.int64,
                       device=cuda)
    for s in (0, 1 << 23):
        part = torch.zeros_like(want)
        M._accumulate_into_ref(part, keys[s:s + (1 << 23)],
                               valid[s:s + (1 << 23)],
                               [w[s:s + (1 << 23)] for w in words], recipe,
                               rng)
        want += part.to(torch.int32)
    assert torch.equal(got, want.to(torch.int32))


def test_bench_plan_on_card(cuda, monkeypatch):
    """q06 at 4 x 2^12 rows and 2^10 groups on the card: one chain launch a
    batch, keys and counts equal to the numpy oracle, sums within rtol
    1e-9."""
    monkeypatch.setattr(cs, "ROWS", 1 << 12)
    monkeypatch.setattr(cs, "GROUPS", 1 << 10)
    datas = [cs._make_data(s) for s in range(4)]
    batches = [ColumnBatch.from_numpy(d, cs.SCHEMA) for d in datas]
    assert batches[0].device.type == "cuda"
    rid = resources.register(lambda: iter(batches))
    plan, _ = decode_task_definition(cs._build_task(cs.SCHEMA_PB, rid))
    before = M.KERNEL_LAUNCHES
    chain_before = dict(M.CHAIN_LAUNCHES)
    packed = collect_fetch(plan, cs._full)
    assert M.KERNEL_LAUNCHES == before + 4
    assert all(M.CHAIN_LAUNCHES[k] == chain_before[k] + 4
               for k in chain_before)
    cap = (len(packed) - 1) // 3
    n = int(packed[0])
    keys = packed[1:1 + cap][:n].astype(np.int64)
    order = np.argsort(keys, kind="stable")
    sums = packed[1 + cap:1 + 2 * cap][:n][order]
    cnts = packed[1 + 2 * cap:][:n].astype(np.int64)[order]
    ref = cs._item_oracle(datas)
    ref_sums, ref_cnts = ref["sum_amount"], ref["cnt"]
    nz = ref_cnts > 0
    np.testing.assert_array_equal(keys[order], np.nonzero(nz)[0])
    np.testing.assert_array_equal(cnts, ref_cnts[nz])
    np.testing.assert_allclose(sums, ref_sums[nz], rtol=1e-9)


# ---------------------------------------------------------------------------
# the general aggregation, sort and limit path at test size: the card
# against the port's own CPU route on the same numpy-made batches
# ---------------------------------------------------------------------------

def _general_workload(device, rows=1 << 12, n_batches=3, customers=3000):
    """chip_smoke's general_agg batches (q06 rows with a nullable
    ss_customer_sk) cut to test size, on `device`."""
    from blaze_tpu_torch.columnar import types as T
    from blaze_tpu_torch.columnar.batch import Column

    batches = []
    for s in range(n_batches):
        rng = np.random.default_rng(100 + s)
        d = {"ss_item_sk": rng.integers(0, 1 << 10, rows).astype(np.int32),
             "ss_quantity": rng.integers(1, 100, rows).astype(np.int32),
             "ss_sales_price": rng.random(rows) * 100,
             "ss_ext_sales_price": rng.random(rows) * 500}
        keys = rng.integers(1, customers + 1, rows).astype(np.int32)
        valid = rng.random(rows) >= 0.05
        b = ColumnBatch.from_numpy(d, cs.SCHEMA, capacity=rows,
                                   device=device)
        k = torch.from_numpy(np.where(valid, keys, 0)).to(device)
        v = torch.from_numpy(valid).to(device)
        batches.append(ColumnBatch(cs.GENERAL_SCHEMA,
                                   [Column(T.INT32, k, v)] + b.columns,
                                   b.num_rows, b.capacity))
    return batches


def _provider(batches):
    return lambda: iter(batches)


# six float sums and averages: 37 digit planes, past the 32 that one
# launch of the accumulate kernel takes, so two launch groups
MANY_PLANE_AGGS = [(fn, arg, "f64", f"{fn}_{arg}")
                   for fn in ("sum", "avg")
                   for arg in ("amount", "ss_sales_price",
                               "ss_ext_sales_price")]

GENERAL_PLANS = {
    "general_agg": dict(key="ss_customer_sk", aggs=cs.GENERAL_AGGS),
    "partial_only": dict(key="ss_customer_sk", aggs=cs.GENERAL_AGGS,
                         final=False),
    "top100": dict(key="ss_customer_sk", aggs=cs.GENERAL_AGGS,
                   sort=cs.TOP_SORT, fetch=cs.TOP_N),
    "dense_minmax": dict(aggs=cs.MINMAX_AGGS),
    "many_planes": dict(aggs=MANY_PLANE_AGGS),
    "chain_stage": dict(agg=False),
}
# the dense plans' chain launches a batch
DENSE_LAUNCHES = {"dense_minmax": 1, "many_planes": 2}


def _assert_card_equals_cpu(got, want):
    assert got.device.type == "cuda" and want.device.type == "cpu"
    assert got.schema.names() == want.schema.names()
    n = int(want.num_rows)
    assert int(got.num_rows) == n
    for name, g, w in zip(want.schema.names(), got.columns, want.columns):
        gv, wv = g.valid_mask()[:n].cpu(), w.valid_mask()[:n]
        assert torch.equal(gv, wv), name
        zero = torch.zeros((), dtype=w.data.dtype)
        gd = torch.where(gv, g.data[:n].cpu(), zero)
        wd = torch.where(wv, w.data[:n], zero)
        if gd.dtype.is_floating_point and ("sum" in name or "avg" in name):
            torch.testing.assert_close(gd, wd, rtol=1e-12, atol=0)
        elif gd.dtype.is_floating_point:  # NaN equals NaN, nothing else
            torch.testing.assert_close(gd, wd, rtol=0, atol=0,
                                       equal_nan=True, msg=name)
        else:
            assert torch.equal(gd, wd), name


@pytest.mark.parametrize("name", list(GENERAL_PLANS))
def test_general_path_on_card_matches_cpu(cuda, name):
    """Each later path of chip_smoke.py at test size, and a dense stage of
    two launch groups (many_planes): the card's answer
    equals the CPU route's, integer, key, min/max and row-order columns
    with torch.equal and f64 sums within rtol 1e-12. Rows come out in the
    same order on both: the sort-based path orders them by key, the dense
    path by dense slot, the chain stage by input row."""
    kw = GENERAL_PLANS[name]
    schema_pb = cs.GENERAL_SCHEMA_PB
    outs = {}
    for dev in ("cpu", cuda):
        batches = _general_workload(dev)
        if "key" not in kw:  # the q06 plans read q06's columns
            batches = [ColumnBatch(cs.SCHEMA, b.columns[1:], b.num_rows,
                                   b.capacity) for b in batches]
            schema_pb = cs.SCHEMA_PB
        rid = resources.register(_provider(batches))
        plan, _ = decode_task_definition(cs._build_task(schema_pb, rid, **kw))
        before = M.KERNEL_LAUNCHES
        outs[dev] = collect(plan)
        if name in DENSE_LAUNCHES:
            assert plan.metrics["stage_compiled"] == 1
            if dev is cuda:
                assert M.KERNEL_LAUNCHES == before + 3 * DENSE_LAUNCHES[name]
        if name in ("general_agg", "partial_only"):
            assert plan.metrics["stage_fallbacks"] == 1
    _assert_card_equals_cpu(outs[cuda], outs["cpu"])


def test_sort_keys_on_card_match_cpu(cuda):
    """sort_batch over each key kind, both directions and null orders,
    with ties: the card's permutation equals the CPU's (stable sorts)."""
    from blaze_tpu_torch.columnar import types as T
    from blaze_tpu_torch.ops.sort_keys import SortSpec, sort_batch

    rng = np.random.default_rng(3)
    n = 5000
    kinds = ["INT8", "INT16", "INT32", "INT64", "FLOAT32", "FLOAT64",
             "BOOLEAN"]
    floats = [np.nan, np.inf, -np.inf, 0.0, -0.0, 1.5]
    data = {f"c{i}": (rng.choice(floats, n) if k.startswith("FLOAT")
                      else rng.integers(-3, 3, n))
            for i, k in enumerate(kinds)}
    data["rid"] = np.arange(n)
    valid = {f"c{i}": rng.random(n) > 0.2 for i in range(len(kinds))}
    schema = T.Schema([T.Field(f"c{i}", getattr(T, k))
                       for i, k in enumerate(kinds)]
                      + [T.Field("rid", T.INT32)])
    for asc in (True, False):
        for nf in (True, False):
            specs = [SortSpec(i, asc ^ (i % 2 == 1), nf)
                     for i in range(len(kinds))]
            got = sort_batch(ColumnBatch.from_numpy(
                data, schema, capacity=8192, validity=valid,
                device=cuda), specs)
            want = sort_batch(ColumnBatch.from_numpy(
                data, schema, capacity=8192, validity=valid,
                device="cpu"), specs)
            assert torch.equal(got.columns[-1].data[:n].cpu(),
                               want.columns[-1].data[:n])


# ---------------------------------------------------------------------------
# the shuffle and spill path at test size: the card against the CPU route
# ---------------------------------------------------------------------------

HASH_KINDS = ["INT8", "INT16", "INT32", "DATE", "BOOLEAN", "INT64",
              "TIMESTAMP", "FLOAT32", "FLOAT64"]


def _kinds_batch(device, n=3000, cap=4096, seed=11):
    """One batch of every hashed kind with extremes, -0.0, NaN and
    infinities, 20% nulls; made with numpy, then put on `device`."""
    from blaze_tpu_torch.columnar import types as T

    rng = np.random.default_rng(seed)
    data, valid = {}, {}
    for i, k in enumerate(HASH_KINDS):
        if k == "BOOLEAN":
            v = rng.random(n) < 0.5
        elif k.startswith("FLOAT"):
            ft = np.float32 if k == "FLOAT32" else np.float64
            v = (rng.standard_normal(n) * 1e3).astype(ft)
            v[:6] = np.array([np.nan, -0.0, 0.0, np.inf, -np.inf,
                              np.finfo(ft).max], ft)
        else:
            it = {"INT8": np.int8, "INT16": np.int16, "INT32": np.int32,
                  "DATE": np.int32}.get(k, np.int64)
            info = np.iinfo(it)
            v = rng.integers(info.min, info.max, n, endpoint=True,
                             dtype=np.int64).astype(it)
            v[:2] = [info.min, info.max]
        data[f"c{i}"] = v
        valid[f"c{i}"] = rng.random(n) > 0.2
    schema = T.Schema([T.Field(f"c{i}", getattr(T, k))
                       for i, k in enumerate(HASH_KINDS)])
    return ColumnBatch.from_numpy(data, schema, capacity=cap, validity=valid,
                                  device=device)


def test_hash_on_card_matches_cpu(cuda):
    """Spark murmur3 of every kind, doubles included, and a chain of all
    of them, then pmod: bit-equal on the card and the CPU."""
    from blaze_tpu_torch.exprs import hash as H

    gb, wb = _kinds_batch(cuda), _kinds_batch("cpu")
    for i in range(len(HASH_KINDS)):
        got = H.hash_columns([gb.columns[i]], row_mask=gb.row_mask())
        want = H.hash_columns([wb.columns[i]], row_mask=wb.row_mask())
        assert got.device.type == "cuda"
        assert torch.equal(got.cpu(), want), HASH_KINDS[i]
    got = H.hash_columns(gb.columns, row_mask=gb.row_mask())
    want = H.hash_columns(wb.columns, row_mask=wb.row_mask())
    assert torch.equal(got.cpu(), want)
    assert torch.equal(H.pmod(got, 200).cpu(), H.pmod(want, 200))


@pytest.mark.parametrize("kind", ["hash", "single", "round_robin"])
def test_partition_and_sort_on_card_matches_cpu(cuda, kind):
    """The partition-grouped rows and per-partition counts of one batch:
    equal on the card and the CPU, rows in input order inside a
    partition."""
    from blaze_tpu_torch.exprs import ir
    from blaze_tpu_torch.exprs.compiler import compile_expr
    from blaze_tpu_torch.ops.shuffle import Partitioning, partition_and_sort

    P = 1 if kind == "single" else 7
    keys = (ir.col("c0"), ir.col("c8"), ir.col("c4")) if kind == "hash" \
        else ()
    part = Partitioning(kind, P, keys)
    outs = {}
    for dev in ("cpu", cuda):
        b = _kinds_batch(dev)
        fns = [compile_expr(e, b.schema) for e in keys]
        outs[dev] = partition_and_sort(b, part, fns, row_offset=5,
                                       rr_start=3)
    (gb, gc), (wb, wc) = outs[cuda], outs["cpu"]
    assert torch.equal(gc.cpu(), wc)
    assert int(gc.sum()) == 3000
    _assert_card_equals_cpu(gb, wb)


def test_serde_round_trip_on_card(cuda):
    """A batch on the card serializes to the same frame bytes as on the
    CPU (one device->host pull), and the frame decodes back onto the card
    equal to the batch."""
    from blaze_tpu_torch.columnar import serde
    from blaze_tpu_torch.runtime import metrics

    gb, wb = _kinds_batch(cuda), _kinds_batch("cpu")
    pulls = metrics.HOST_PULLS
    frame = serde.serialize_batch(gb)
    assert metrics.HOST_PULLS == pulls + 1
    assert frame == serde.serialize_batch(wb)
    back = serde.deserialize_batch(frame, gb.schema, device=cuda)
    assert back.device.type == "cuda"
    _assert_card_equals_cpu(back, wb)
    assert serde.serialize_batch(back) == frame  # bit for bit, -0.0 kept


def test_spill_on_card_matches_cpu(cuda):
    """The general plan and a full sort under budgets that force spills:
    agg state and sorted runs go to host files and come back onto the
    card; the answers equal the CPU route's under the same budgets."""
    from blaze_tpu_torch.ops.base import ExecContext
    from blaze_tpu_torch.runtime import memory

    plans = {"agg": dict(key="ss_customer_sk", aggs=cs.GENERAL_AGGS),
             "sort": dict(agg=False, sort=cs.SPILL_SORT)}
    for name, kw in plans.items():
        outs = {}
        for dev in ("cpu", cuda):
            batches = _general_workload(dev, n_batches=6)
            rid = resources.register(_provider(batches))
            plan, _ = decode_task_definition(cs._build_task(
                cs.GENERAL_SCHEMA_PB, rid, **kw))
            budget = 48 << 10 if name == "agg" else 64 << 10
            outs[dev] = collect(plan, ExecContext(
                device=dev, mem_manager=memory.MemManager(budget)))
            op = plan.children[0] if name == "agg" else plan
            assert op.metrics["spill_count"] >= 2, (name, dev)
        _assert_card_equals_cpu(outs[cuda], outs["cpu"])


# ---------------------------------------------------------------------------
# joins and the Parquet scan
# ---------------------------------------------------------------------------

JOIN_TYPES = ["INNER", "LEFT", "RIGHT", "FULL", "LEFT_SEMI", "LEFT_ANTI",
              "EXISTENCE"]


def _join_side(rng, prefix, n, cap, device, null_p=0.15):
    """One side of a join, made on the CPU from a seeded generator: a
    nullable int64 key, a float key with NaN and -0.0, a payload."""
    from blaze_tpu_torch.columnar import types as TT

    schema = TT.Schema([TT.Field(f"{prefix}k", TT.INT64),
                        TT.Field(f"{prefix}f", TT.FLOAT64),
                        TT.Field(f"{prefix}v", TT.FLOAT64)])
    data = {f"{prefix}k": rng.integers(0, 40, n),
            f"{prefix}f": rng.choice(np.array([np.nan, -0.0, 0.0, 1.5]), n),
            f"{prefix}v": rng.random(n)}
    valid = {f"{prefix}k": rng.random(n) >= null_p}
    return ColumnBatch.from_numpy(data, schema,
                                  capacity=max(cap, 1 << (n - 1).bit_length()),
                                  validity=valid, device=device)


def _stream_on(op_fn, device):
    """All batches of a freshly built operator on `device`, as one."""
    from blaze_tpu_torch.ops.base import ExecContext
    from blaze_tpu_torch.ops.common import concat_batches

    op = op_fn(device)
    outs = list(op.execute(ExecContext(device=device)))
    if not outs:
        return ColumnBatch.empty(op.schema, device=device), op
    return concat_batches(outs, op.schema), op


def _hash_join(cls_name, jt, build_is_left=False, nkeys=1, nl=3000,
               nr=1500):
    from blaze_tpu_torch.ops import join as J
    from blaze_tpu_torch.ops.basic import MemorySourceExec

    def make(device):
        rng = np.random.default_rng(5)
        left = [_join_side(rng, "l", nl, 4096, device) for _ in range(2)]
        right = [_join_side(rng, "r", nr, 2048, device)]
        keys = [J.JoinKey(i, i, null_safe=(i == 1)) for i in range(nkeys)]
        return getattr(J, cls_name)(
            MemorySourceExec(left), MemorySourceExec(right), keys,
            J.JoinType[jt], build_is_left=build_is_left)

    return make


@pytest.mark.parametrize("cls_name", ["SortMergeJoinExec",
                                      "BroadcastJoinExec"])
@pytest.mark.parametrize("jt", JOIN_TYPES)
def test_join_on_card_matches_cpu(cuda, cls_name, jt):
    """Every join type on an int64 key and a null-safe float key (NaN
    matches NaN, -0.0 matches 0.0): same rows, in the same order."""
    make = _hash_join(cls_name, jt, build_is_left=(cls_name[0] == "B"),
                      nkeys=2)
    got, _ = _stream_on(make, cuda)
    want, _ = _stream_on(make, "cpu")
    assert int(want.num_rows) > 0
    _assert_card_equals_cpu(got, want)


@pytest.mark.parametrize("jt", ["INNER", "LEFT_ANTI"])
def test_chunked_build_on_card_matches_cpu(cuda, monkeypatch, jt):
    from blaze_tpu_torch.config import conf

    monkeypatch.setattr(conf, "bhj_fallback_rows_threshold", 1000)
    make = _hash_join("BroadcastJoinExec", jt, nr=3000)
    got, op = _stream_on(make, cuda)
    assert op.metrics["bhj_fallback_to_smj"] == 1
    want, _ = _stream_on(make, "cpu")
    _assert_card_equals_cpu(got, want)


@pytest.mark.parametrize("jt", ["INNER", "FULL", "EXISTENCE"])
def test_bnlj_on_card_matches_cpu(cuda, jt):
    from blaze_tpu_torch.exprs import ir
    from blaze_tpu_torch.ops import join as J
    from blaze_tpu_torch.ops.basic import MemorySourceExec

    def make(device):
        rng = np.random.default_rng(9)
        left = [_join_side(rng, "l", 300, 512, device)]
        right = [_join_side(rng, "r", 40, 64, device)]
        cond = ir.Binary(ir.BinOp.GT, ir.col("lv"), ir.col("rv"))
        return J.BroadcastNestedLoopJoinExec(
            MemorySourceExec(left), MemorySourceExec(right),
            J.JoinType[jt], cond)

    got, _ = _stream_on(make, cuda)
    want, _ = _stream_on(make, "cpu")
    _assert_card_equals_cpu(got, want)


def test_parquet_scan_on_card_matches_cpu(cuda, tmp_path):
    """Two files of several row groups, nulls, pruning: each batch lands
    on the card in one copy a column, equal to the CPU route's."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    from blaze_tpu_torch.columnar import types as TT
    from blaze_tpu_torch.exprs import ir
    from blaze_tpu_torch.ops.parquet import ParquetScanExec

    rng = np.random.default_rng(3)
    files = []
    for i in range(2):
        n = 5000
        p = str(tmp_path / f"f{i}.parquet")
        pq.write_table(pa.table({
            "a": pa.array(np.arange(i * n, (i + 1) * n)),
            "b": pa.array(rng.random(n), mask=rng.random(n) < 0.1),
            "d": pa.array(rng.integers(0, 9000, n).astype(np.int32),
                          pa.date32())}), p, row_group_size=1000)
        files.append((p, []))
    schema = TT.Schema([TT.Field("a", TT.INT64), TT.Field("b", TT.FLOAT64),
                        TT.Field("d", TT.DATE)])
    pred = ir.Binary(ir.BinOp.GE, ir.col("a"), ir.lit(2500))

    def make(device):
        return ParquetScanExec(files, schema, [0, 1, 2],
                               pruning_predicates=[pred])

    got, op = _stream_on(make, cuda)
    want, _ = _stream_on(make, "cpu")
    assert op.metrics["row_groups_pruned"] == 2
    _assert_card_equals_cpu(got, want)


@pytest.fixture(scope="module")
def tpcds_tables(tmp_path_factory):
    from blaze_tpu_torch.spark import tpcds

    d = tmp_path_factory.mktemp("tpcds")
    return tpcds.generate_tables(str(d), rows=6000)


@pytest.mark.parametrize("q", ["q02", "q09", "q03", "q07", "q08"])
def test_run_plan_on_card_matches_cpu(cuda, tpcds_tables, tmp_path, q):
    """spark/tpcds.py's q02 and q09 (BHJ), and the string queries q03, q07
    and q08, through run_plan on the card: the same rows in order as the
    CPU route (integers and strings exact, floats rtol 1e-12), the same
    stages and routes."""
    from blaze_tpu_torch.spark import tpcds
    from blaze_tpu_torch.spark.local_runner import run_plan

    paths, frames = tpcds_tables
    runs = {}
    for dev in ("cuda", "cpu"):
        plan, _ = tpcds.QUERIES[q](paths, frames, "bhj")
        info = {}
        out = run_plan(plan, work_dir=str(tmp_path / dev), run_info=info,
                       device=dev)
        assert out.device.type == dev
        runs[dev] = out.to_numpy(), info
    (got, ginfo), (want, winfo) = runs["cuda"], runs["cpu"]
    keys = ("mesh_stages", "file_stages", "broadcast_stages",
            "map_tasks_run", "stage_compiled", "stage_fallbacks")
    assert {k: ginfo[k] for k in keys} == {k: winfo[k] for k in keys}
    assert list(got) == list(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=1e-12, err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


def _source(batches):
    """An ffi_reader provider of no parameter (ops/shuffle._call_provider
    passes as many task arguments as a provider names)."""
    return lambda: iter(batches)


@pytest.mark.parametrize("logical", [1, 4])
def test_mesh_exchange_on_card_matches_cpu(cuda, monkeypatch, logical):
    """run_mesh_shuffle_stage over one map batch of every hashed kind,
    keyed on three of them, on the card (one device, or four logical
    devices all this card) and on the CPU route: every partition holds
    the same rows in the same order."""
    from blaze_tpu_torch.parallel import stage_exchange
    from blaze_tpu_torch.plan import plan_pb2 as pb
    from blaze_tpu_torch.plan.to_proto import encode_schema

    parts = {}
    for dev in (cuda, torch.device("cpu")):
        b = _kinds_batch(dev)
        monkeypatch.setattr(stage_exchange, "mesh_devices",
                            lambda d, dev=dev: [dev] * logical)
        rid = resources.register(_source([b]))
        node = pb.PlanNode()
        w = node.shuffle_writer
        w.input.ffi_reader.schema.CopyFrom(encode_schema(b.schema))
        w.input.ffi_reader.export_iter_resource_id = rid
        w.partitioning.kind = pb.HashRepartition.HASH
        w.partitioning.num_partitions = 8
        for k in ("c0", "c8", "c4"):
            w.partitioning.keys.add().column.name = k
        assert stage_exchange.run_mesh_shuffle_stage(node, 993, 1,
                                                     device=dev)
        reader = resources.get("shuffle:993")
        parts[dev.type] = [list(reader(p)) for p in range(8)]
        resources.pop("shuffle:993")
        resources.pop(rid)
    for got, want in zip(parts["cuda"], parts["cpu"]):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.device.type == "cuda"
            _assert_card_equals_cpu(g, w)
    assert sum(int(b.num_rows) for p in parts["cuda"] for b in p) == 3000


def test_real_device_oom_classifies_as_resource(cuda):
    """A real allocation past the card's memory raises the caching
    allocator's torch.cuda.OutOfMemoryError, which the taxonomy maps to
    "resource" (the degradation ladder), and the card keeps working."""
    from blaze_tpu_torch.runtime import faults

    free, total = torch.cuda.mem_get_info()
    with pytest.raises(torch.cuda.OutOfMemoryError) as ei:
        torch.empty(total * 4, dtype=torch.uint8, device=cuda)
    assert faults.classify(ei.value) == "resource"
    assert torch.ones(4, device=cuda).sum().item() == 4.0


@pytest.mark.parametrize("spec", [
    {"seed": 7, "points": {"serde.encode": {"kind": "io", "nth": 2}}},
    {"seed": 8, "points": {"op.ParquetScanExec": {"kind": "oom",
                                                  "fail_times": 10 ** 9}}}])
def test_ladder_on_card_matches_cpu(cuda, tpcds_tables, tmp_path, spec):
    """tpcds.py's q02 (SMJ) under a fault spec at the default runtime (the
    supervisor's pool, the pipeline) with the mesh exchange off, so that
    the map tasks run under the ladder: on the card, the rows and the
    resilience counters of the CPU route."""
    from blaze_tpu_torch.runtime import faults
    from blaze_tpu_torch.spark import tpcds
    from blaze_tpu_torch.spark.local_runner import run_plan

    paths, frames = tpcds_tables
    runs = {}
    for dev in ("cuda", "cpu"):
        plan, _ = tpcds.QUERIES["q02"](paths, frames, "smj")
        info = {}
        faults.install(spec)
        try:
            out = run_plan(plan, work_dir=str(tmp_path / dev),
                           mesh_exchange="off", run_info=info, device=dev)
        finally:
            faults.install(None)
        runs[dev] = out.to_numpy(), {
            k: v for k, v in info.items()
            if k in ("retries", "degradations", "ladder_rung",
                     "task_fallbacks", "faults_injected")
            or k.startswith(("errors.", "degraded."))}
    (got, ginfo), (want, winfo) = runs["cuda"], runs["cpu"]
    assert ginfo == winfo and ginfo["faults_injected"] >= 1
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=1e-12, err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


def test_case_and_in_on_card_match_cpu(cuda):
    """CASE WHEN (null conditions, no ELSE), IF and [NOT] IN with a null
    in the list, on the card against the CPU route."""
    from blaze_tpu_torch.columnar import types as TT
    from blaze_tpu_torch.exprs import ir
    from blaze_tpu_torch.exprs.compiler import compile_expr

    rng = np.random.default_rng(9)
    n = 5000
    schema = TT.Schema([TT.Field("q", TT.INT32), TT.Field("p", TT.FLOAT64),
                        TT.Field("f", TT.BOOLEAN)])
    data = {"q": rng.integers(0, 12, n).astype(np.int32),
            "p": rng.random(n) * 100, "f": rng.random(n) < 0.5}
    validity = {k: rng.random(n) < 0.8 for k in data}
    i32 = [ir.Literal(TT.INT32, v) for v in (1, 3, None)]
    exprs = [
        ir.CaseWhen(((ir.Binary(ir.BinOp.LE, ir.col("q"), i32[1]),
                      ir.col("p")), (ir.col("f"), ir.Negate(ir.col("p")))),
                    None),
        ir.If(ir.col("f"), ir.col("q"), i32[0]),
        ir.InList(ir.col("q"), tuple(i32)),
        ir.InList(ir.col("q"), tuple(i32[:2]), True),
    ]
    for e in exprs:
        cols = {}
        for dev in ("cuda", "cpu"):
            b = ColumnBatch.from_numpy(data, schema, validity=validity,
                                       device=dev)
            cols[dev] = compile_expr(e, schema)(b)
        g, w = cols["cuda"], cols["cpu"]
        gv, wv = g.valid_mask()[:n].cpu(), w.valid_mask()[:n]
        assert torch.equal(gv, wv), e
        assert torch.equal(g.data[:n].cpu()[wv], w.data[:n][wv]), e


def _string_batch(dev, n=3000, seed=13):
    """Strings over all 256 byte values, lengths 0..40, 10% null."""
    from blaze_tpu_torch.columnar import types as TT

    rng = np.random.default_rng(seed)
    words = [bytes(rng.integers(0, 256, ln).astype(np.uint8))
             for ln in rng.integers(0, 41, 64)] + [b"", b"ab", b"abab%"]
    vals = [None if rng.random() < 0.1 else words[i]
            for i in rng.integers(0, len(words), n)]
    schema = TT.Schema([TT.Field("s", TT.BINARY), TT.Field("i", TT.INT32)])
    return ColumnBatch.from_numpy(
        {"s": vals, "i": rng.integers(-50, 50, n).astype(np.int32)}, schema,
        device=dev)


def test_string_functions_on_card_match_cpu(cuda):
    """hash_bytes, the string_words sort order, compare/equals, substring
    and like_match on the card equal the CPU route bit for bit."""
    from blaze_tpu_torch.exprs import hash as H
    from blaze_tpu_torch.exprs import strings as S
    from blaze_tpu_torch.ops.sort_keys import SortSpec, sort_batch

    out = {}
    for dev in ("cuda", "cpu"):
        b = _string_batch(dev)
        s = b.columns[0].data
        other = S.reverse(s)
        start = b.columns[1].data
        res = [H.hash_columns(b.columns, row_mask=b.row_mask()),
               *S.compare(s, other), S.equals(s, other),
               S.substring(s, start, (start.abs() % 7)).bytes,
               S.like_match(s, b"%ab%"), S.like_match(s, b"_\\%_")]
        sb = sort_batch(b, [SortSpec(0, False, False), SortSpec(1)])
        res += [sb.columns[0].data.bytes, sb.columns[0].data.lengths,
                sb.columns[1].data]
        out[dev] = [r.cpu() for r in res]
    for g, w in zip(out["cuda"], out["cpu"]):
        assert torch.equal(g, w)


def test_dict_serde_round_trip_onto_card(cuda, monkeypatch):
    """A frame with a dictionary-encoded string column decodes onto the
    card as DictData equal to the CPU decode, and the card's batch writes
    the same frame back."""
    from blaze_tpu_torch.columnar import serde
    from blaze_tpu_torch.config import conf

    monkeypatch.setattr(conf, "dict_encode_strings", True)
    cpu = _string_batch("cpu")
    frame = serde.serialize_batch(cpu)
    on_card = serde.deserialize_batch(frame, cpu.schema, device="cuda")
    on_cpu = serde.deserialize_batch(frame, cpu.schema, device="cpu")
    gd, wd = on_card.columns[0], on_cpu.columns[0]
    assert gd.is_dict and wd.is_dict and gd.data.codes.is_cuda
    for a, b in ((gd.data.codes, wd.data.codes),
                 (gd.data.dict_bytes, wd.data.dict_bytes),
                 (gd.data.dict_lengths, wd.data.dict_lengths),
                 (gd.validity, wd.validity)):
        assert torch.equal(a.cpu(), b)
    assert serde.serialize_batch(on_card) == serde.serialize_batch(on_cpu)
    assert on_card.to_numpy()["s"] == cpu.to_numpy()["s"]


def test_segmented_scan_on_card_matches_cpu(cuda):
    """The window's doubling scan over sum, fmin, max and or, and the
    integer segmented_cumsum, on the card against the CPU route (float
    sums: the same association on both, so bit for bit)."""
    from blaze_tpu_torch.ops import segment as S

    rng = np.random.default_rng(21)
    n = (1 << 18) + 17
    starts = torch.from_numpy(rng.random(n) < 0.01)
    x = torch.from_numpy(rng.choice([np.nan, 1.0, -3.5, 2.25, np.inf], n)
                         * rng.random(n))
    ints = torch.from_numpy(rng.integers(-(1 << 40), 1 << 40, n))
    bits = torch.from_numpy(rng.random(n) < 0.1)
    cases = [(ints, lambda a, b: a + b), (x, lambda a, b: a + b),
             (x, torch.fmin), (x, torch.maximum), (bits, lambda a, b: a | b)]
    for v, op in cases:
        want = S.segmented_scan(v, starts, op)
        got = S.segmented_scan(v.cuda(), starts.cuda(), op).cpu()
        assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))
        assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(S.segmented_cumsum(ints.cuda(), starts.cuda()).cpu(),
                       S.segmented_cumsum(ints, starts))


def _nested_batch(dev, n=4000, seed=22):
    """Lists of int64 and of strings (null rows, empty rows, null
    elements) and a struct, from seeded host values."""
    from blaze_tpu_torch.columnar import types as TT

    rng = np.random.default_rng(seed)
    xs = [None if rng.random() < 0.1 else
          [None if rng.random() < 0.1 else int(v)
           for v in rng.integers(-99, 99, int(rng.integers(0, 6)))]
          for _ in range(n)]
    ls = [None if rng.random() < 0.1 else
          ["w" * int(k) for k in rng.integers(0, 9, int(rng.integers(0, 4)))]
          for _ in range(n)]
    st = [None if rng.random() < 0.1 else (int(k), "s" * int(k % 5))
          for k in rng.integers(0, 50, n)]
    schema = TT.Schema([
        TT.Field("id", TT.INT64), TT.Field("xs", TT.list_of(TT.INT64)),
        TT.Field("ls", TT.list_of(TT.STRING)),
        TT.Field("st", TT.struct_of([TT.Field("a", TT.INT64),
                                     TT.Field("b", TT.STRING)]))])
    return ColumnBatch.from_numpy(
        {"id": rng.permutation(n).astype(np.int64), "xs": xs, "ls": ls,
         "st": st}, schema, device=dev)


def test_list_take_and_concat_on_card_match_cpu(cuda):
    """List and struct columns through a permutation (a sort), a subset
    (a filter), a concatenation and the serde, on the card against the
    CPU route."""
    from blaze_tpu_torch.columnar import serde
    from blaze_tpu_torch.exprs import ir
    from blaze_tpu_torch.exprs.compiler import compile_expr
    from blaze_tpu_torch.ops.common import concat_batches
    from blaze_tpu_torch.ops.sort_keys import SortSpec, sort_batch

    out = {}
    for dev in ("cuda", "cpu"):
        b = _nested_batch(dev)
        keep = compile_expr(ir.Binary(ir.BinOp.GT, ir.col("id"),
                                      ir.lit(1500)), b.schema)(b)
        parts = [sort_batch(b, [SortSpec(0)]), b.compact(keep.data),
                 _nested_batch(dev, 77, 23)]
        cat = concat_batches(parts)
        out[dev] = (cat.to_numpy(), serde.serialize_batch(cat))
    assert out["cuda"][1] == out["cpu"][1]
    assert repr(out["cuda"][0]) == repr(out["cpu"][0])


def test_collect_on_card_matches_cpu(cuda):
    """collect_list and collect_set (ints, floats with NaN and -0.0,
    strings) through PARTIAL -> PARTIAL_MERGE -> FINAL with repeated
    collapses, on the card against the CPU route, element order
    included."""
    from blaze_tpu_torch.columnar import types as TT
    from blaze_tpu_torch.exprs import ir
    from blaze_tpu_torch.ops import agg
    from blaze_tpu_torch.ops.base import ExecContext
    from blaze_tpu_torch.ops.basic import MemorySourceExec

    rng = np.random.default_rng(24)
    schema = TT.Schema([TT.Field("k", TT.INT64), TT.Field("v", TT.INT64),
                        TT.Field("f", TT.FLOAT64), TT.Field("s", TT.STRING)])
    datas = []
    for n in (3000, 2100):
        datas.append(({"k": rng.integers(0, 300, n),
                       "v": rng.integers(0, 40, n),
                       "f": rng.choice([np.nan, 0.0, -0.0, 1.5, 2.0], n),
                       "s": ["s" * int(j) for j in rng.integers(0, 9, n)]},
                      {c: rng.random(n) > 0.2 for c in "kvfs"}))
    calls = [agg.AggCall(fn, (ir.col(c),),
                         TT.list_of(schema.field(c).dtype), f"{fn}_{c}")
             for fn in ("collect_list", "collect_set") for c in "vfs"]
    out = {}
    for dev in ("cuda", "cpu"):
        node = MemorySourceExec([ColumnBatch.from_numpy(
            d, schema, validity=v, device=dev) for d, v in datas], schema)
        for mode in ("PARTIAL", "PARTIAL_MERGE", "FINAL"):
            node = agg.AggExec(node, [ir.col("k")], ["k"], calls,
                               getattr(agg.AggMode, mode),
                               collapse_threshold=2000)
        out[dev] = collect(node, ExecContext(device=dev)).to_numpy()
    assert repr(out["cuda"]) == repr(out["cpu"])


def test_window_and_generate_on_card_match_cpu(cuda):
    """A window batch (row_number, rank, dense_rank, count, int and float
    sums, avg, min, max, by partition and order with ties, nulls and NaN)
    and a generate batch (posexplode outer with a struct riding along) on
    the card against the CPU route: integers and ranks exact, float sums
    within 1e-12 x the frame's running sum of |x|."""
    from blaze_tpu_torch.columnar import types as TT
    from blaze_tpu_torch.exprs import ir
    from blaze_tpu_torch.ops.base import ExecContext
    from blaze_tpu_torch.ops.basic import MemorySourceExec
    from blaze_tpu_torch.ops.expand import GenerateExec
    from blaze_tpu_torch.ops.sort_keys import SortSpec
    from blaze_tpu_torch.ops.window import WindowCall, WindowExec

    rng = np.random.default_rng(25)
    n = 20_000
    v = rng.choice([np.nan, 1.5, -2.25, 7.0, 1e6], n) * rng.random(n)
    vv = rng.random(n) > 0.2
    data = {"g": rng.integers(0, 40, n), "o": rng.integers(0, 50, n),
            "v": v, "i": rng.integers(-9, 9, n).astype(np.int32),
            "a": np.where(vv & ~np.isnan(v), np.abs(v), 0.0)}
    valid = {"g": rng.random(n) > 0.05, "o": rng.random(n) > 0.05, "v": vv}
    schema = TT.Schema([TT.Field("g", TT.INT64), TT.Field("o", TT.INT64),
                        TT.Field("v", TT.FLOAT64), TT.Field("i", TT.INT32),
                        TT.Field("a", TT.FLOAT64)])
    calls = [WindowCall("row_number", (), TT.INT32, "rn"),
             WindowCall("rank", (), TT.INT32, "rk"),
             WindowCall("dense_rank", (), TT.INT32, "dr"),
             WindowCall("count", (ir.col("v"),), TT.INT64, "c"),
             WindowCall("sum", (ir.col("i"),), TT.INT32, "si"),
             WindowCall("min", (ir.col("v"),), TT.FLOAT64, "mn"),
             WindowCall("max", (ir.col("v"),), TT.FLOAT64, "mx"),
             WindowCall("sum", (ir.col("v"),), TT.FLOAT64, "s"),
             WindowCall("avg", (ir.col("v"),), TT.FLOAT64, "av"),
             WindowCall("sum", (ir.col("a"),), TT.FLOAT64, "sa")]
    out = {}
    for dev in ("cuda", "cpu"):
        b = ColumnBatch.from_numpy(data, schema, validity=valid, device=dev)
        w = WindowExec(MemorySourceExec([b], schema), calls, [ir.col("g")],
                       [SortSpec(1)])
        nb = _nested_batch(dev)
        g = GenerateExec(MemorySourceExec([nb], nb.schema), ir.col("xs"),
                         [0, 3], ["pos", "x"], pos=True, outer=True)
        ctx = ExecContext(device=dev)
        out[dev] = (collect(w, ctx).to_numpy(), collect(g, ctx).to_numpy())
    (gw, gg), (ww, wg) = out["cuda"], out["cpu"]
    assert repr(gg) == repr(wg)
    bound = np.asarray(ww["sa"], np.float64) * 1e-12 + 1e-300
    for k in ww:
        gv = np.array([np.nan if x is None else x for x in gw[k]], float)
        wv = np.array([np.nan if x is None else x for x in ww[k]], float)
        assert np.array_equal(np.isnan(gv), np.isnan(wv)), k
        tol = bound if k in ("s", "sa", "av") else 0.0
        ok = ~np.isnan(wv)
        assert (np.abs(gv - wv)[ok] <= np.broadcast_to(tol, wv.shape)[ok]
                ).all(), k


# ---------------------------------------------------------------------------
# decimals: columnar/int128.py, exprs/wide_decimal.py, exprs/cast.py
# ---------------------------------------------------------------------------

def _edge_ints(seed, n=4000):
    """Python ints over the whole 128-bit range, with the edge rows: zero,
    +-1, the int64 limbs' extremes, +-(10^38 - 1), 2^64 +- 1 and the
    int128 extremes."""
    rng = np.random.default_rng(seed)
    edges = [0, 1, -1, (1 << 63) - 1, -(1 << 63), 1 << 63, (1 << 64) - 1,
             1 << 64, -(1 << 64), 10 ** 38 - 1, -(10 ** 38 - 1),
             (1 << 127) - 1, -(1 << 127), 5, -5, 15, -15, 25, -25]
    out = list(edges)
    while len(out) < n:
        bits = int(rng.integers(1, 127))
        v = int(rng.integers(0, 1 << 62)) << max(bits - 62, 0)
        out.append(v if rng.random() < 0.5 else -v)
    return out


def _planes_on(vals, dev):
    from blaze_tpu_torch.columnar import int128 as i128

    return tuple(torch.from_numpy(p).to(dev)
                 for p in i128.np_from_ints(vals))


def _card_and_cpu(fn):
    """fn(device) on the card and on the CPU: each tensor of its results
    equal bit for bit."""
    got, want = fn(torch.device("cuda")), fn(torch.device("cpu"))
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.device.type == "cuda"
        assert torch.equal(g.cpu(), w), i


def test_int128_on_card_matches_cpu(cuda):
    """mul_i64 and mul_small (wrapping 32x32-bit partial products),
    divmod_full (the 128-step long division, zero divisors included) and
    rescale_checked up and down (HALF_UP at .5 ties): bit-equal on the
    card and the CPU over the edge rows."""
    from blaze_tpu_torch.columnar import int128 as i128

    a, b = _edge_ints(1), _edge_ints(2)
    b[:3] = [0, 0, 0]

    def run(dev):
        ah, al = _planes_on(a, dev)
        bh, bl = _planes_on(b, dev)
        out = [*i128.mul_i64(al, bl), *i128.mul_small(ah, al, 10 ** 9 + 7),
               *i128.divmod_full(ah, al, bh, bl),
               i128.cmp(ah, al, bh, bl)]
        for delta in (20, 3, -1, -7, -19):
            out += i128.rescale_checked(ah, al, delta)
        return out

    _card_and_cpu(run)


def _wide_cols(dev):
    from blaze_tpu_torch.columnar import types as TT
    from blaze_tpu_torch.exprs.wide_decimal import build

    vals = _edge_ints(3)
    rng = np.random.default_rng(4)
    narrow = rng.integers(-10 ** 17, 10 ** 17, len(vals))
    narrow[:4] = [0, 10 ** 17, -(10 ** 17), 5]
    valid = torch.from_numpy(rng.random(len(vals)) > 0.1).to(dev)
    wide = build(TT.decimal(38, 4), *_planes_on(vals, dev), valid)
    from blaze_tpu_torch.columnar.batch import Column

    small = Column(TT.decimal(18, 2), torch.from_numpy(narrow).to(dev), None)
    return wide, small


def test_wide_arith_compare_check_overflow_on_card_match_cpu(cuda):
    """Wide add, sub, mul and the HALF_UP division, the limb comparison
    with unequal scales, negation and CheckOverflow, on the card against
    the CPU."""
    from blaze_tpu_torch.columnar import types as TT
    from blaze_tpu_torch.exprs import ir
    from blaze_tpu_torch.exprs import wide_decimal as W

    def run(dev):
        wide, small = _wide_cols(dev)
        out = []
        for op, rt in ((ir.BinOp.ADD, TT.decimal(38, 4)),
                       (ir.BinOp.SUB, TT.decimal(38, 4)),
                       (ir.BinOp.MUL, TT.decimal(38, 6)),
                       (ir.BinOp.DIV, TT.decimal(38, 6))):
            c = W.arith(wide, small, op, rt, None)
            out += [*W.planes(c), c.valid_mask()]
        c = W.arith(small, small, ir.BinOp.DIV, TT.decimal(37, 20), None)
        out += [*W.planes(c), c.valid_mask()]
        out += list(W.compare(wide, small))
        out += list(W.planes(W.negate(wide)))
        c = W.check_overflow(wide, 20, 2, TT.decimal(20, 2))
        out += [*W.planes(c), c.valid_mask()]
        c = W.cast_from_wide(wide, TT.FLOAT64)
        out += [c.data]
        return out

    _card_and_cpu(run)


def test_wide_hash_and_sort_keys_on_card_match_cpu(cuda):
    """The wide hash (minimal big-endian bytes through hash_bytes) and its
    partition ids, and a sort by a wide key both ways: equal on the card
    and the CPU."""
    from blaze_tpu_torch.columnar import types as TT
    from blaze_tpu_torch.columnar.batch import ColumnBatch
    from blaze_tpu_torch.exprs import hash as H
    from blaze_tpu_torch.ops.sort_keys import SortSpec, sort_batch

    vals = _edge_ints(5)
    vals = [None if i % 9 == 4 else v for i, v in enumerate(vals)]
    schema = TT.Schema([TT.Field("d", TT.decimal(38, 0)),
                        TT.Field("i", TT.INT32)])
    ids = np.arange(len(vals), dtype=np.int32)

    def run(dev):
        b = ColumnBatch.from_numpy({"d": vals, "i": ids}, schema,
                                   device=dev)
        h = H.hash_columns(b.columns[:1], row_mask=b.row_mask())
        out = [h, H.pmod(h, 200)]
        for asc in (True, False):
            sb = sort_batch(b, [SortSpec(0, asc, asc)])
            out.append(sb.columns[1].data)
        return out

    _card_and_cpu(run)


def test_wide_segment_sums_on_card_match_cpu(cuda):
    """seg_sum_wide (four limb sums and the overflow shadow) and
    seg_minmax_wide over 40 groups of the edge rows: equal on the card and
    the CPU."""
    from blaze_tpu_torch.columnar import types as TT
    from blaze_tpu_torch.columnar.batch import ColumnBatch
    from blaze_tpu_torch.exprs import wide_decimal as W
    from blaze_tpu_torch.ops import segment as seg
    from blaze_tpu_torch.ops.sort_keys import SortSpec, sort_batch

    vals = _edge_ints(6)
    keys = np.random.default_rng(7).integers(0, 40, len(vals)).astype(
        np.int32)
    schema = TT.Schema([TT.Field("k", TT.INT32),
                        TT.Field("d", TT.decimal(38, 0))])

    def run(dev):
        b = ColumnBatch.from_numpy({"k": keys, "d": vals}, schema,
                                   device=dev)
        sb = sort_batch(b, [SortSpec(0)])
        layout = seg.group_layout(sb, [0])
        h, l = W.planes(sb.columns[1])
        live = layout.row_mask
        out = list(W.seg_sum_wide(h, l, live, layout, seg))
        for is_min in (True, False):
            out += W.seg_minmax_wide(h, l, live, layout, seg, is_min)
        g = layout.group_mask
        return [torch.where(g, t, torch.zeros_like(t)) for t in out]

    _card_and_cpu(run)


def test_rounding_and_parsing_casts_on_card_match_cpu(cuda):
    """float -> decimal at .5 ties (HALF_UP as floor(x + 0.5) / ceil(x -
    0.5)), int32/int64 bounds -> decimal, decimal rescale down, and string
    -> int, double, decimal, date and boolean over malformed strings, and
    date and int -> string: equal on the card and the CPU."""
    from blaze_tpu_torch.columnar import types as TT
    from blaze_tpu_torch.columnar.batch import ColumnBatch
    from blaze_tpu_torch.exprs.cast import cast_column

    floats = np.array([0.5, -0.5, 1.5, -1.5, 2.5, -2.5, 0.125, -0.125,
                       0.005, 1e17, -1e17, np.nan, np.inf, 123.456])
    strs = ["42", " -7 ", "abc", "", "99999999999999999999", "+5",
            "1.5", "-2.25e2", "1e3", ".5", "3.", "1e", "--1", "1.2.3",
            "2001-03-04", "1969-07-20", "0001-01-01", "2023-2-9",
            "2000-13-01", "1600-02-29", " true", "N", "yes", "0", "e5"]
    ints = np.array([0, 1, -1, 2**31 - 1, -2**31, 2**63 - 1, -2**63,
                     12345678901234], np.int64)
    dates = np.array([0, -1, -719162, 11385, -165, 2932896], np.int32)

    def run(dev):
        f = ColumnBatch.from_numpy({"f": floats}, TT.Schema(
            [TT.Field("f", TT.FLOAT64)]), device=dev).columns[0]
        s = ColumnBatch.from_numpy({"s": strs}, TT.Schema(
            [TT.Field("s", TT.STRING)]), device=dev).columns[0]
        i = ColumnBatch.from_numpy({"i": ints}, TT.Schema(
            [TT.Field("i", TT.INT64)]), device=dev).columns[0]
        d = ColumnBatch.from_numpy({"d": dates}, TT.Schema(
            [TT.Field("d", TT.DATE)]), device=dev).columns[0]
        cols = [cast_column(f, TT.decimal(10, 0)),
                cast_column(f, TT.decimal(18, 2)),
                cast_column(i, TT.decimal(18, 0)),
                cast_column(i, TT.decimal(10, 2)),
                cast_column(cast_column(i, TT.INT32), TT.decimal(12, 2)),
                cast_column(cast_column(f, TT.decimal(18, 2)),
                            TT.decimal(18, 0))]
        cols += [cast_column(s, t) for t in (
            TT.INT64, TT.INT32, TT.FLOAT64, TT.decimal(12, 3), TT.DATE,
            TT.BOOLEAN)]
        out = []
        for c in cols:
            v = c.valid_mask()
            out += [v, torch.where(v, c.data, torch.zeros_like(c.data))]
        for c in (cast_column(d, TT.STRING), cast_column(i, TT.STRING)):
            out += [c.data.bytes, c.data.lengths]
        return out

    _card_and_cpu(run)


def test_bitwise_and_shift_ops_on_card_match_cpu(cuda):
    """BIT_AND, BIT_OR, BIT_XOR, SHIFT_LEFT and SHIFT_RIGHT over int32 and
    int64, shift counts 0 and 63 and out of range included: equal on the
    card and the CPU."""
    from blaze_tpu_torch.columnar import types as TT
    from blaze_tpu_torch.columnar.batch import ColumnBatch
    from blaze_tpu_torch.exprs import ir
    from blaze_tpu_torch.exprs.compiler import compile_expr

    rng = np.random.default_rng(8)
    n = 3000
    counts = rng.integers(-3, 70, n)
    counts[:4] = [0, 63, 64, -1]
    data = {"a": rng.integers(-2**63, 2**63 - 1, n, dtype=np.int64),
            "b": rng.integers(-2**31, 2**31 - 1, n).astype(np.int32),
            "c": counts.astype(np.int64)}
    schema = TT.Schema([TT.Field("a", TT.INT64), TT.Field("b", TT.INT32),
                        TT.Field("c", TT.INT64)])
    exprs = [ir.Binary(getattr(ir.BinOp, op), ir.col(x), ir.col(y))
             for op in ("BIT_AND", "BIT_OR", "BIT_XOR", "SHIFT_LEFT",
                        "SHIFT_RIGHT")
             for x, y in (("a", "c"), ("b", "c"), ("a", "b"))]

    def run(dev):
        b = ColumnBatch.from_numpy(data, schema, device=dev)
        return [compile_expr(e, schema)(b).data for e in exprs]

    _card_and_cpu(run)


# ---- the function library, the host crossings and the FFI bridge ----

# units in the last place allowed between CUDA's libm and the CPU's: the
# sum of each side's documented error bound against the true value (CUDA
# C Programming Guide, double-precision functions). Every other function
# is bitwise equal (division, sqrt and rounding are IEEE on both)
CARD_ULPS = {"exp": 2, "ln": 2, "log": 2, "log10": 2, "log2": 2, "sin": 3,
             "cos": 3, "tan": 3, "asin": 3, "acos": 3, "atan": 3,
             "atan2": 3, "pow": 3, "power": 3}


def _edge_batch(dev):
    from blaze_tpu_torch.columnar import types as TT

    from torch_function_cases import CAP, FIELDS, _table

    data, validity = _table()
    schema = TT.Schema([TT.Field(n, getattr(TT, k)) for n, k in FIELDS])
    return ColumnBatch.from_numpy(data, schema, capacity=CAP,
                                  validity=validity, device=dev)


@pytest.mark.parametrize("ulps", [0, 1])
def test_registered_functions_on_card_match_cpu(cuda, ulps):
    """Every case of every registered scalar function (the edge rows of
    tests/torch_function_cases.py: NaN, ±0, ±inf, a subnormal, values
    past 2^63, INT64_MIN, dates before 1970, empty and full-width strings,
    JSON) on the card against the CPU route: validity and integer, date
    and string values bitwise, floats bitwise except the transcendental
    functions, within CARD_ULPS. `ulps` 0 takes the bitwise cases, 1 the
    others."""
    from blaze_tpu_torch.columnar import types as TT
    from blaze_tpu_torch.exprs import ir
    from blaze_tpu_torch.exprs.compiler import compile_expr

    from torch_function_cases import CASES, N, _ulp_diff

    batches = {dev: _edge_batch(dev) for dev in ("cuda", "cpu")}
    checked = 0
    for name, make in sorted(CASES.items()):
        fn = name.split("[")[0]
        if (fn in CARD_ULPS) != bool(ulps):
            continue
        cols = {dev: compile_expr(make(ir, TT), b.schema)(b)
                for dev, b in batches.items()}
        g, w = cols["cuda"], cols["cpu"]
        assert g.data.device.type == "cuda" if not g.dtype.is_nested \
            else True
        rows = {dev: ColumnBatch(TT.Schema([TT.Field("o", c.dtype)]), [c],
                                 N, c.capacity).to_numpy()["o"]
                for dev, c in cols.items()}
        gv, wv = list(rows["cuda"]), list(rows["cpu"])
        assert [x is None for x in gv] == [x is None for x in wv], name
        gv = [x for x in gv if x is not None]
        wv = [x for x in wv if x is not None]
        if g.dtype.is_floating:
            diff = _ulp_diff(np.array(gv, np.float64),
                             np.array(wv, np.float64))
            assert diff.max(initial=0) <= CARD_ULPS.get(fn, 0), (
                name, int(diff.max(initial=0)))
        elif g.dtype.is_nested:
            assert [list(map(repr, x)) for x in gv] == \
                [list(map(repr, x)) for x in wv], name
        else:
            assert [repr(x) for x in gv] == [repr(x) for x in wv], name
        checked += 1
    assert checked > (10 if ulps else 80)


def test_host_crossings_on_card(cuda):
    """hostfns (md5, crc32, a JSON path) and the UDF wrapper on a card
    batch: one pull and one upload a call, results on the card, equal to
    the CPU route."""
    from blaze_tpu_torch.columnar import types as TT
    from blaze_tpu_torch.exprs import ir
    from blaze_tpu_torch.exprs.compiler import compile_expr
    from blaze_tpu_torch.runtime import metrics
    from blaze_tpu_torch.spark import hive_udf

    hive_udf.register_udf("card_twice", lambda v: np.asarray(
        [None if x is None else 2 * (int(x) % 1000) for x in v], object),
        TT.INT64)
    exprs = [ir.ScalarFn("md5", (ir.col("s"),)),
             ir.ScalarFn("crc32", (ir.col("s"),)),
             ir.ScalarFn("get_json_object", (ir.col("js"),
                                             ir.lit("$.a"))),
             ir.UdfWrapper("udf:card_twice", TT.INT64, True,
                           (ir.col("l"),))]
    out = {}
    for dev in ("cuda", "cpu"):
        b = _edge_batch(dev)
        res = []
        for e in exprs:
            pulls = metrics.HOST_PULLS
            c = compile_expr(e, b.schema)(b)
            assert metrics.HOST_PULLS - pulls == 1, e
            data = c.data.bytes if c.is_string else c.data
            assert data.device.type == dev
            res.append((data.cpu(), c.valid_mask().cpu()))
        out[dev] = res
    for (gd, gv), (wd, wv) in zip(out["cuda"], out["cpu"]):
        assert torch.equal(gv, wv)
        assert torch.equal(gd[gv], wd[wv])


def test_ffi_bridge_lands_on_card(cuda, tpcds_tables, tmp_path,
                                  monkeypatch):
    """A NeverConvert subtree (filters switched off) runs on the row
    interpreter and enters the native pipeline through FfiReaderExec: the
    bridged batches are on the card (run_info's bridge counts), and the
    rows equal the CPU route's."""
    from blaze_tpu_torch.config import conf
    from blaze_tpu_torch.spark import tpcds
    from blaze_tpu_torch.spark.local_runner import run_plan

    monkeypatch.setattr(conf, "enable_ops", {"filter": False})
    paths, frames = tpcds_tables
    runs = {}
    for dev in ("cuda", "cpu"):
        info = {}
        plan, _ = tpcds.QUERIES["q03"](paths, frames, "bhj")
        out = run_plan(plan, work_dir=str(tmp_path / dev), run_info=info,
                       device=dev)
        assert info["fallback_exports"] >= 1 and info["bridge_rows"] > 0
        assert info["bridge_batches"] > 0
        assert info["bridge_card_batches"] == (
            info["bridge_batches"] if dev == "cuda" else 0)
        runs[dev] = out.to_numpy()
    got, want = runs["cuda"], runs["cpu"]
    assert list(got) == list(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=1e-12, err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


def test_observability_taps_share_one_pull_a_batch(cuda, monkeypatch,
                                                   tmp_path):
    """count_stream on the card: with the trace, the history store and
    live progress all on, each batch's row count is read once and shared
    by the three taps; with the trace alone, once a batch too; with all
    three off, the counts stay on the card and are summed by one pull at
    the stream's end. The taps see the same rows."""
    from blaze_tpu_torch.config import conf
    from blaze_tpu_torch.ops.base import count_stream
    from blaze_tpu_torch.ops.basic import MemorySourceExec
    from blaze_tpu_torch.runtime import history, metrics, progress, trace

    n_batches = 6
    from blaze_tpu_torch.columnar import types as T

    schema = T.Schema([T.Field("a", T.INT64)])
    batches = [ColumnBatch.from_numpy(
        {"a": np.arange(100 + i, dtype=np.int64)}, schema, capacity=512,
        device=cuda) for i in range(n_batches)]
    rows = sum(100 + i for i in range(n_batches))
    pulls = {}
    for case, knobs in (("all", dict(trace_enabled=True,
                                     history_dir=str(tmp_path / "h"),
                                     progress_enabled=True)),
                        ("trace", dict(trace_enabled=True, history_dir="",
                                       progress_enabled=False)),
                        ("off", dict(trace_enabled=False, history_dir="",
                                     progress_enabled=False))):
        for k, v in knobs.items():
            monkeypatch.setattr(conf, k, v)
        trace.reset()
        history.reset()
        progress.reset()
        qid = f"qPull-{case}"
        history.begin_query(qid)
        progress.begin_query(qid)
        progress.stage_begin(qid, 0, "result")
        op = MemorySourceExec(batches, batches[0].schema)
        before = metrics.HOST_PULLS
        with trace.context(query_id=qid, stage_id=0):
            out = list(count_stream(op, iter(batches)))
        pulls[case] = metrics.HOST_PULLS - before
        assert len(out) == n_batches
        assert op.metrics.snapshot()["output_rows"] == rows
        if case == "all":
            snap = progress.snapshot_query(qid)
            assert snap["rows"] == rows
            assert snap["stages"][0]["batches"] == n_batches
            rec = history.record_run(qid, {})
            assert rec["ops"][0]["rows"] == rows
            assert sum(r["kind"] == "batch" for r in
                       trace.query_records(qid)) == n_batches
        progress.finish_query(qid)
    assert pulls == {"all": n_batches, "trace": n_batches, "off": 1}


def test_profiler_attributes_a_kernel_launch_to_its_query(cuda,
                                                          monkeypatch):
    """A thread in a task's trace context launches the accumulate kernel
    in a loop; samples taken meanwhile (the ctypes launch releases the
    GIL) fold stacks that pass through the kernel's wrapper, attributed
    to the task's query, stage and task."""
    import threading

    from blaze_tpu_torch.config import conf
    from blaze_tpu_torch.runtime import profiler, trace

    monkeypatch.setattr(conf, "profile_enabled", True)
    profiler.reset()
    keys, valid, words, recipe, rng = _case("uniform")
    args = (keys.to(cuda), valid.to(cuda), [w.to(cuda) for w in words],
            recipe, rng)
    acc = torch.zeros(((rng + 127) // 128, len(recipe), 128),
                      dtype=torch.int64, device=cuda)
    stop = threading.Event()

    def task():
        with trace.context(query_id="qK", stage_id=2, task_id="map[2:0]"):
            while not stop.is_set():
                M.accumulate_into(acc, *args)
                torch.cuda.synchronize()

    t = threading.Thread(target=task)
    t.start()
    try:
        for _ in range(5000):
            profiler.sample_once()
            if any("mxu_agg." in r[5] for r in profiler.rows("qK")):
                break
    finally:
        stop.set()
        t.join()
    hits = [r for r in profiler.rows("qK") if "mxu_agg." in r[5]]
    assert hits and all(r[2] == "2" and r[3] == "map[2:0]" for r in hits)
    profiler.reset()


def test_dossier_after_a_card_oom(cuda, monkeypatch, tmp_path):
    """A real torch.cuda.OutOfMemoryError from the card, ending a query:
    the flight recorder writes its failure dossier (a capture makes no
    device call), and the card keeps working."""
    from blaze_tpu_torch.config import conf
    from blaze_tpu_torch.runtime import flight_recorder, trace

    monkeypatch.setattr(conf, "flight_dir", str(tmp_path / "flight"))
    monkeypatch.setattr(conf, "trace_enabled", True)
    flight_recorder.reset()
    free, total = torch.cuda.mem_get_info()
    with trace.context(query_id="qOom"):
        with pytest.raises(torch.cuda.OutOfMemoryError):
            try:
                torch.empty(total * 4, dtype=torch.uint8, device=cuda)
            finally:
                flight_recorder.on_query_end("qOom", {"query_id": "qOom"})
    assert flight_recorder.last_error() is None
    (entry,) = flight_recorder.list_dossiers()
    doc = flight_recorder.load(entry["path"])
    assert doc["trigger"] == "failure" and doc["query_id"] == "qOom"
    assert doc["error"]["type"] == "OutOfMemoryError"
    assert torch.ones(4, device=cuda).sum().item() == 4.0
    flight_recorder.reset()


# ---------------------------------------------------------------------------
# the process-isolated executor pool on the card: each worker a fresh
# interpreter with its own CUDA context
# ---------------------------------------------------------------------------


def _pool_env(**env):
    """Start an ExecutorPool(2, 2) with `env` set in the environment its
    workers inherit (and only there)."""
    import os

    from blaze_tpu_torch.runtime import executor_pool as ep

    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        return ep.ExecutorPool(count=2, slots=2).start()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _pooled(pool, fn):
    """fn(), with the workers' stderr tails and the pool's state in the
    message of any failure (a worker's log dies with the pool's dir)."""
    import os

    try:
        return fn()
    except Exception as e:  # noqa: BLE001 — re-raised with context
        logs = {}
        for name in sorted(os.listdir(pool._dir)):
            if name.endswith(".err"):
                with open(os.path.join(pool._dir, name), "rb") as f:
                    logs[name] = f.read()[-2000:].decode(errors="replace")
        raise AssertionError(f"{e!r}; stats {pool.stats()}; "
                             f"executors {pool.executors()}; "
                             f"logs {logs}") from e


def _fill_card(hog, dev, leave, settle_s=20.0):
    """Hold all but `leave` bytes of the card in `hog`, topping up until
    two reads half a second apart agree: processes that just exited (an
    earlier test's workers) hand their memory back a little later.
    Returns the bytes left free."""
    import time

    deadline = time.monotonic() + settle_s
    last = None
    while True:
        torch.cuda.empty_cache()
        free, _ = torch.cuda.mem_get_info()
        if free > leave + (64 << 20):
            hog.append(torch.empty(free - leave, dtype=torch.uint8,
                                   device=dev))
            free, _ = torch.cuda.mem_get_info()
        if last is not None and abs(free - last) < (64 << 20) \
                or time.monotonic() > deadline:
            return free
        last = free
        time.sleep(0.5)


def _card_used_mib() -> float:
    """The card's used memory, all processes together, as nvidia-smi
    reads it (its per-process list names pids of another namespace in a
    container, so the tests read the card's total)."""
    import subprocess

    out = subprocess.run(["nvidia-smi", "--query-gpu=memory.used",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout
    return float(out.split()[0])


@pytest.fixture(scope="module")
def core_tables(tmp_path_factory):
    from blaze_tpu_torch.spark import validator

    d = tmp_path_factory.mktemp("core")
    return validator.generate_tables(str(d), rows=6000)


def _core_q06(tables, work_dir, device, info):
    from blaze_tpu_torch.spark import validator
    from blaze_tpu_torch.spark.local_runner import run_plan

    paths, frames = tables
    plan, _ = validator.QUERIES["q2_q06_core_agg"](paths, frames, "bhj")
    return run_plan(plan, work_dir=work_dir, mesh_exchange="off",
                    run_info=info, device=device).to_numpy()


def test_pooled_dense_stage_reports_its_launches(cuda, core_tables,
                                                 tmp_path):
    """The core catalogue's q06 (scan -> filter -> project -> the dense
    partial aggregate -> shuffle) with a pool active: its map stage runs
    in a worker on the card, which reports as many launches of the
    kernel chain as the in-process run counts, and the driver launches
    none; the rows equal the in-process run's (floats rtol 1e-12)."""
    from blaze_tpu_torch.runtime import executor_pool as ep

    inproc = {}
    before = M.KERNEL_LAUNCHES
    want = _core_q06(core_tables, str(tmp_path / "in"), "cuda", inproc)
    inproc_launches = M.KERNEL_LAUNCHES - before
    assert inproc_launches > 0 and inproc["stage_compiled"] > 0
    pool = _pool_env(OMP_NUM_THREADS="1")
    ep.activate(pool)
    try:
        info = {}
        before = M.KERNEL_LAUNCHES
        got = _pooled(pool, lambda: _core_q06(
            core_tables, str(tmp_path / "pool"), "cuda", info))
        assert M.KERNEL_LAUNCHES - before == 0
        assert info["pool_stages"] >= 1
        assert info["pool_kernel_launches"] == inproc_launches
        assert info["stage_compiled"] == inproc["stage_compiled"]
        assert info["pool_engine_start_s"] > 0
    finally:
        ep.deactivate(pool)
        pool.close()
    assert list(got) == list(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=1e-12, err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


def test_pool_worker_oom_taken_by_its_ladder(cuda, core_tables, tmp_path,
                                             monkeypatch):
    """A real torch.cuda.OutOfMemoryError inside a worker: the workers'
    conf snapshot has min_capacity 2^28 rows (2 GiB an 8-byte column), and
    this process holds all but 1.5 GiB of the card, so the worker's first
    upload of its map task fails. The worker's own ladder takes it as a
    resource error (its task_error and ladder_rung events come back over
    the telemetry plane); once the card is freed the task completes, no
    worker dies, and the rows equal the in-process run's."""
    import threading
    import time

    from blaze_tpu_torch.config import conf
    from blaze_tpu_torch.runtime import executor_pool as ep
    from blaze_tpu_torch.runtime import trace

    want = _core_q06(core_tables, str(tmp_path / "in"), "cuda", {})
    monkeypatch.setattr(conf, "trace_enabled", True)
    monkeypatch.setattr(conf, "telemetry_ship_ms", 50)
    monkeypatch.setattr(conf, "retry_backoff_ms", 1000)
    trace.reset()
    with monkeypatch.context() as m:
        m.setattr(conf, "min_capacity", 1 << 28)
        pool = _pool_env(OMP_NUM_THREADS="1")
    ep.activate(pool)
    hog, box = [], {}
    try:
        free_left = _fill_card(hog, cuda, leave=3 << 29)

        def run():
            try:
                box["rows"] = _pooled(pool, lambda: _core_q06(
                    core_tables, str(tmp_path / "oom"), "cuda",
                    box.setdefault("info", {})))
            except Exception as e:  # noqa: BLE001 — asserted below
                box["err"] = e

        t = threading.Thread(target=run)
        t.start()

        def worker_oom():
            return [r for r in trace.TRACE.snapshot()
                    if r.get("exec") and r.get("kind") == "task_error"
                    and (r.get("attrs") or {}).get("category") == "resource"]

        deadline = time.monotonic() + 120
        while not worker_oom() and time.monotonic() < deadline \
                and t.is_alive():
            time.sleep(0.01)
        seen = worker_oom()
        hog.clear()
        torch.cuda.empty_cache()
        t.join(timeout=300)
        kinds = sorted({r.get("kind") for r in trace.TRACE.snapshot()
                        if r.get("exec")})
        assert seen, (f"no worker reported a resource error; "
                      f"{free_left >> 20} MiB left free, {box}, {kinds}")
        assert seen[0]["attrs"]["error"] == "OutOfMemoryError", seen
        assert "err" not in box, (box.get("err"), kinds)
        rungs = [r for r in trace.TRACE.snapshot() if r.get("exec")
                 and r.get("kind") == "ladder_rung"]
        assert rungs and rungs[0]["attrs"]["action"] == "halve_batch", (
            rungs, kinds)
        assert pool.stats()["deaths_total"] == 0, pool.stats()
        assert box["info"]["pool_stages"] >= 1
    finally:
        hog.clear()
        torch.cuda.empty_cache()
        ep.deactivate(pool)
        pool.close()
        trace.reset()
    got = box["rows"]
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=1e-12, err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


def test_sigkilled_worker_returns_its_device_memory(cuda, core_tables,
                                                    tmp_path):
    """Workers holding CUDA contexts (and the cached blocks of a map
    task), SIGKILLed: the card's free memory rises by at least a context
    once they are gone (read against the card after the query, so the
    driver's own growth does not count), and both seats respawn."""
    import os
    import signal
    import time

    from blaze_tpu_torch.runtime import executor_pool as ep

    pool = _pool_env(OMP_NUM_THREADS="1")
    ep.activate(pool)
    try:
        info = {}
        _pooled(pool, lambda: _core_q06(core_tables, str(tmp_path / "run"),
                                        "cuda", info))
        assert info["pool_engine_start_s"] > 0
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        free_live, _ = torch.cuda.mem_get_info()
        victims = pool.pids()
        for pid in victims.values():
            os.kill(pid, signal.SIGKILL)
        deadline = time.monotonic() + 60
        while (torch.cuda.mem_get_info()[0] - free_live < (256 << 20)
               and time.monotonic() < deadline):
            time.sleep(0.2)
        free_after, _ = torch.cuda.mem_get_info()
        assert free_after - free_live >= (256 << 20), (
            free_live, free_after, victims, pool.executors())
        while pool.live_count() < 2 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert pool.live_count() == 2
        assert not set(victims.values()) & set(pool.pids().values())
        assert pool.stats()["deaths_total"] >= len(victims)
    finally:
        ep.deactivate(pool)
        pool.close()
