"""The decimal slice end to end in the port against the JAX package, on the
CPU: wide columns through the shuffle files and Arrow, decimal literals and
expressions through the plan protobuf, the planner's wide-decimal walk,
and chip_smoke.py's DECIMAL_QUERIES through both packages' `run_plan`.

DECIMAL_QUERIES (q02_dec, q04_dec, q03_rev) run over decimal copies of the
fact tables that chip_smoke.py's `write_tpcds` writes at 2^14-row files
(its constants cut as its rehearsal cuts them), in both join modes. Rows
must be equal in order (unscaled values, counts and keys bit for bit) and
pass chip_smoke.py's numpy oracles; the routes (`stage_compiled`,
`stage_fallbacks`: the JAX package's tallied from its operators' metric
updates and `_fallback` calls) and the stage counts must be equal. Shuffle
files holding wide columns must be byte-identical to the JAX package's.
"""

import decimal

import numpy as np
import pyarrow as pa
import pytest

import chip_smoke as cs
from blaze_tpu.columnar import types as JT
from blaze_tpu.columnar.batch import ColumnBatch as JBatch
from blaze_tpu.config import conf as jconf
from blaze_tpu.exprs import ir as jir
from blaze_tpu.ops import shuffle as JS
from blaze_tpu.ops.base import ExecContext as JCtx
from blaze_tpu.ops.basic import MemorySourceExec as JMem
from blaze_tpu.plan import from_proto as jfrom
from blaze_tpu.plan import to_proto as jto
from blaze_tpu.runtime import metrics as jmetrics
from blaze_tpu.runtime import stage_compiler as jstage
from blaze_tpu.runtime.executor import execute_plan as jexec
from blaze_tpu.spark import tpcds as jtpcds
from blaze_tpu.spark.convert_strategy import apply_strategy as japply
from blaze_tpu.spark.local_runner import run_plan as jrun_plan
from blaze_tpu.spark.stages import plan_stages as jplan_stages
from blaze_tpu_torch.columnar import arrow_io as tio
from blaze_tpu_torch.columnar import types as TT
from blaze_tpu_torch.columnar.batch import ColumnBatch
from blaze_tpu_torch.config import conf
from blaze_tpu_torch.exprs import ir
from blaze_tpu_torch.ops import shuffle as S
from blaze_tpu_torch.ops.base import ExecContext
from blaze_tpu_torch.ops.basic import MemorySourceExec
from blaze_tpu_torch.plan import from_proto as tfrom
from blaze_tpu_torch.plan import to_proto as tto
from blaze_tpu_torch.spark import tpcds
from blaze_tpu_torch.spark.convert_strategy import apply_strategy
from blaze_tpu_torch.spark.local_runner import run_plan
from blaze_tpu_torch.spark.stages import plan_stages
from torch_parity import assert_same_stages, no_jax_native

CHECKS = {"q02_dec": cs.check_q02_dec, "q04_dec": cs.check_q04_dec,
          "q03_rev": cs.check_q03_rev}


def _wide_pair(n, cap, seed):
    """The same batch in both packages: an int64 key, a wide decimal with
    its edge rows (INT64_MIN limbs, +-(10^38 - 1)) and a narrow one, 10%
    nulls."""
    rng = np.random.default_rng(seed)
    wide = [int(rng.integers(-2**62, 2**62)) * int(rng.integers(1, 2**62))
            % (10 ** 38) * (1 if rng.random() < 0.5 else -1)
            for _ in range(n)]
    wide[:4] = [10 ** 38 - 1, -(10 ** 38 - 1), -(1 << 63), 0]
    wide = [None if rng.random() < 0.1 else v for v in wide]
    data = {"k": rng.integers(-50, 50, n), "d": wide,
            "x": rng.integers(-10 ** 17, 10 ** 17, n)}
    out = []
    for T, Batch, kw in ((JT, JBatch, {}),
                         (TT, ColumnBatch, {"device": "cpu"})):
        schema = T.Schema([T.Field("k", T.INT64),
                           T.Field("d", T.decimal(38, 4)),
                           T.Field("x", T.decimal(18, 2))])
        out.append(Batch.from_numpy(
            {k: np.array(v, object) for k, v in data.items()}, schema,
            capacity=cap, **kw))
    return tuple(out)


@pytest.mark.parametrize("key", ["k", "d"])
def test_shuffle_files_with_wide_columns_byte_identical(tmp_path,
                                                        monkeypatch, key):
    """Hash partitioning by a narrow key and by the wide column itself
    (its murmur3 over the minimal big-endian bytes): the committed .data
    and .index files equal the JAX package's, and each package reads the
    other's partitions."""
    monkeypatch.setattr(conf, "spill_dir", str(tmp_path / "spill"))
    pairs = [_wide_pair(n, cap, s) for s, (n, cap) in
             enumerate([(500, 512), (61, 128)])]
    jbs, tbs = [j for j, _ in pairs], [t for _, t in pairs]
    paths = [str(tmp_path / f) for f in ("j.data", "j.index", "t.data",
                                         "t.index")]
    jw = JS.ShuffleWriterExec(JMem(jbs, jbs[0].schema), JS.Partitioning(
        "hash", 7, (jir.col(key),)), paths[0], paths[1])
    list(jexec(jw, JCtx(partition=1, num_partitions=2)))
    tw = S.ShuffleWriterExec(MemorySourceExec(tbs, tbs[0].schema),
                             S.Partitioning("hash", 7, (ir.col(key),)),
                             paths[2], paths[3])
    list(tw.execute(ExecContext(partition=1, num_partitions=2,
                                device="cpu")))
    for a, b in ((paths[0], paths[2]), (paths[1], paths[3])):
        with open(a, "rb") as f, open(b, "rb") as g:
            assert f.read() == g.read()
    rows = 0
    for p in range(7):
        mine = list(S.read_shuffle_partition(paths[0], paths[1], p,
                                             tbs[0].schema, device="cpu"))
        theirs = list(JS.read_shuffle_partition(paths[2], paths[3], p,
                                                jbs[0].schema))
        assert [b.to_numpy()["d"] for b in mine] == [
            b.to_numpy()["d"] for b in theirs]
        rows += sum(int(b.num_rows) for b in mine)
    assert rows == 561


def test_arrow_decimal128_30_4_round_trip():
    """decimal128(30, 4) in and out, nulls and a sliced array included:
    the (lo, hi) words are the limb planes, read as the JAX package reads
    them, and written back to the same Arrow array."""
    from blaze_tpu.columnar import arrow_io as jio

    vals = [decimal.Decimal("12345678901234567890123456.7890"), None,
            decimal.Decimal("-99999999999999999999999999.9999"),
            decimal.Decimal("0.0001"), decimal.Decimal("-0.0001"),
            decimal.Decimal("922337203685477.5808")]
    arr = pa.array(vals, pa.decimal128(30, 4))
    for a in (arr, arr.slice(1, 4)):
        rb = pa.record_batch([a], names=["x"])
        tb = tio.batch_from_arrow(rb, device="cpu")
        assert tb.to_numpy()["x"] == jio.batch_from_arrow(rb).to_numpy()["x"]
        # out from the words themselves (the JAX package's way out goes
        # through Python Decimals at the context's 28 digits, and cannot
        # write 30)
        back = tio.batch_to_arrow(tb)
        assert back.column(0).equals(a)
        assert back.schema.field("x").type == pa.decimal128(30, 4)


def _exprs(m, T):
    """Every decimal arm of the expression protobuf, in one package."""
    c = m.col
    d38, d10 = T.decimal(38, 4), T.decimal(10, 2)
    return [
        m.Literal(d38, 10 ** 30 + 7), m.Literal(d38, -(10 ** 37)),
        m.Literal(d38, None), m.Literal(d10, -12345),
        m.MakeDecimal(c("i"), 17, 2), m.UnscaledValue(c("p")),
        m.CheckOverflow(c("p"), 35, 4),
        m.Cast(c("p"), d38), m.Cast(c("w"), T.FLOAT64),
        m.Negate(c("w")),
        m.Binary(m.BinOp.DIV, c("w"), c("p"), result_type=T.decimal(38, 10)),
        m.Binary(m.BinOp.MUL, c("p"), c("p"), result_type=T.decimal(21, 4)),
        m.Binary(m.BinOp.GT, c("w"), m.Literal(d38, 10 ** 30)),
    ] + [m.Binary(getattr(m.BinOp, op), c("i"), c("i"))
         for op in ("BIT_AND", "BIT_OR", "BIT_XOR", "SHIFT_LEFT",
                    "SHIFT_RIGHT")]


def test_decimal_expressions_round_trip_the_protobuf():
    """Wide literals (`decimal_unscaled_hi`) and every decimal, bitwise
    and shift arm encode to the JAX package's bytes and decode back to
    the same expression in either package."""
    for te, je in zip(_exprs(ir, TT), _exprs(jir, JT)):
        tb = tto.encode_expr(te).SerializeToString()
        assert tb == jto.encode_expr(je).SerializeToString()
        back = tfrom.decode_expr(type(tto.encode_expr(te)).FromString(tb))
        assert back.key() == te.key()
        jback = jfrom.decode_expr(type(jto.encode_expr(je)).FromString(tb))
        assert jback.key() == je.key()


def test_decimal_expressions_compile_like_jax():
    """The same decimal, bitwise and shift expressions compile and run in
    the port on a batch of the kinds they read, equal to the JAX
    package's."""
    from blaze_tpu.exprs.compiler import compile_expr as jcompile
    from blaze_tpu_torch.exprs.compiler import compile_expr

    rng = np.random.default_rng(5)
    n = 300
    data = {"i": rng.integers(-2**40, 2**40, n),
            "p": [int(v) for v in rng.integers(-10**9, 10**9, n)],
            "w": [int(v) * 10**15 for v in rng.integers(-10**9, 10**9, n)]}
    data["p"][:2] = [0, 0]
    out = []
    for T, Batch, kw in ((TT, ColumnBatch, {"device": "cpu"}),
                         (JT, JBatch, {})):
        schema = T.Schema([T.Field("i", T.INT64),
                           T.Field("p", T.decimal(10, 2)),
                           T.Field("w", T.decimal(38, 4))])
        out.append((schema, Batch.from_numpy(
            {k: np.array(v, object) for k, v in data.items()}, schema,
            **kw)))
    (ts, tb), (js, jb) = out
    for te, je in zip(_exprs(ir, TT), _exprs(jir, JT)):
        tc, jc = compile_expr(te, ts)(tb), jcompile(je, js)(jb)
        assert repr(tc.dtype) == repr(jc.dtype)
        name = "r"
        got = ColumnBatch(TT.Schema([TT.Field(name, tc.dtype)]), [tc],
                          tb.num_rows, tb.capacity).to_numpy()[name]
        want = JBatch(JT.Schema([JT.Field(name, jc.dtype)]), [jc],
                      jb.num_rows, jb.capacity).to_numpy()[name]
        assert [None if v is None else v.item() if hasattr(v, "item")
                else v for v in got] == [
            None if v is None else v.item() if hasattr(v, "item") else v
            for v in want], te


@pytest.fixture(scope="module")
def dec_tables(tmp_path_factory):
    """chip_smoke.py's TPC-DS files and oracle inputs, its decimal copies
    included, at 2^14-row fact files."""
    mp = pytest.MonkeyPatch()
    mp.setattr(cs, "FACT_FILE_ROWS", 1 << 14)
    mp.setattr(cs, "TPCDS_FILES", {"web_sales": 2, "catalog_sales": 2,
                                   "store_sales": 2})
    mp.setattr(cs, "CUSTOMERS", 3000)
    mp.setattr(cs, "SS_DIMS", (("item", 2000), ("cdemo", 2000),
                               ("store", 40), ("promo", 100)))
    mp.setattr(cs, "DIM_ROWS", {"item": 2000, "customer": 3000,
                                "customer_address": 1000,
                                "customer_demographics": 2000,
                                "store": 40, "promotion": 100})
    mp.setattr(cs, "STORES", 40)
    mp.setattr(cs, "SR_ROWS", 1 << 12)
    root = tmp_path_factory.mktemp("decimal")
    paths, orc = cs.write_tpcds(str(root / "data"), seed=7)
    yield paths, orc, mp
    mp.undo()


@pytest.fixture
def jax_routes(monkeypatch):
    """The JAX package's whole-stage routes under the port's names."""
    from blaze_tpu.runtime import compile_service

    counts = {"stage_compiled": 0, "stage_fallbacks": 0}
    real_add, real_fallback = jmetrics.MetricsSet.add, jstage._fallback

    def add(self, name, delta):
        if name in counts and self is not compile_service.TELEMETRY:
            counts[name] += int(delta)
        return real_add(self, name, delta)

    def fallback(root, *args):
        counts["stage_fallbacks"] += 1
        return real_fallback(root, *args)

    monkeypatch.setattr(jmetrics.MetricsSet, "add", add)
    monkeypatch.setattr(jstage, "_fallback", fallback)
    monkeypatch.setattr(jconf, "enable_supervisor", False)
    monkeypatch.setattr(jconf, "enable_pipeline", False)
    no_jax_native(monkeypatch)
    return counts


def _tags(plan):
    out = [(plan.kind, plan.convertible, plan.strategy)]
    for c in plan.children:
        out += _tags(c)
    return out


@pytest.mark.parametrize("q", sorted(cs.DECIMAL_QUERIES))
@pytest.mark.parametrize("mode", ["bhj", "smj"])
def test_decimal_queries_convert_like_jax(dec_tables, q, mode):
    """The wide-decimal walk of spark/converters.py tags each plan node as
    the JAX package's does (every node converts: q04_dec's decimal(37,20)
    quotients pass, delta 20 and 17 + 20 <= 38), and the stages are
    byte-identical protobufs."""
    paths = dec_tables[0]
    plan = cs._runner_plan(q, paths, mode)
    jplan = cs._runner_plan(q, paths, mode, jtpcds)
    apply_strategy(plan)
    japply(jplan)
    assert _tags(plan) == _tags(jplan)
    assert all(s in ("Default", "AlwaysConvert") for _, _, s in _tags(plan))
    stages = plan_stages(plan, default_partitions=4, namespace="")
    jstages = jplan_stages(jplan, default_partitions=4, namespace="")
    assert [s.plan.SerializeToString() for s in stages] == [
        s.plan.SerializeToString() for s in jstages]


@pytest.mark.parametrize("q", sorted(cs.DECIMAL_QUERIES))
@pytest.mark.parametrize("mode", ["bhj", "smj"])
def test_decimal_queries_run_plan_like_jax(dec_tables, jax_routes, tmp_path,
                                           q, mode):
    paths, orc, _ = dec_tables
    info, jinfo = {}, {}
    out = run_plan(cs._runner_plan(q, paths, mode), num_partitions=4,
                   work_dir=str(tmp_path / "port"), run_info=info,
                   device="cpu")
    want = jrun_plan(cs._runner_plan(q, paths, mode, jtpcds),
                     num_partitions=4, work_dir=str(tmp_path / "jax"),
                     mesh_exchange="off", run_info=jinfo).to_numpy()
    got = out.to_numpy()
    assert list(got) == list(want)
    for k in want:
        assert [None if v is None else v.item() if hasattr(v, "item")
                else v for v in got[k]] == [
            None if v is None else v.item() if hasattr(v, "item") else v
            for v in want[k]], k
    assert len(got[next(iter(got))]) > 0
    CHECKS[q](out, orc)
    assert_same_stages(info, jinfo)
    assert {k: info[k] for k in jax_routes} == jax_routes
