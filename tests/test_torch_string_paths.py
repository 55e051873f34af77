"""String columns through the port's engine against the JAX package, on
the CPU.

The same seeded batches with string columns (plain and dictionary, of
different width buckets, with nulls, bytes >= 0x80 and ties) go through
both packages: sort keys and sort order (ascending and descending, nulls
first and last), serde frames (byte-identical in the plain and the
dictionary forms, a dictionary block decoded back into `DictData`), Arrow
and Parquet round trips of string, large_string, binary, large_binary and
dictionary columns, the streaming aggregate over string keys with string
min/max/first, SMJ and BHJ on string keys whose sides have different
width buckets, concatenation, a spilled sort, and the compiled string
expressions (literals, comparisons, CASE, IN, LIKE, the predicates and
substring). Strings and integers must be equal, floats within rtol 1e-12.
"""

import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from blaze_tpu.columnar import arrow_io as jio
from blaze_tpu.columnar import serde as JSerde
from blaze_tpu.columnar import types as JT
from blaze_tpu.columnar.batch import ColumnBatch as JBatch
from blaze_tpu.config import conf as jconf
from blaze_tpu.exprs import ir as jir
from blaze_tpu.exprs.compiler import compile_expr as jcompile
from blaze_tpu.ops import agg as jagg
from blaze_tpu.ops import common as jcommon
from blaze_tpu.ops import join as JJ
from blaze_tpu.ops import sort_keys as JK
from blaze_tpu.ops.base import ExecContext as JCtx
from blaze_tpu.ops.basic import MemorySourceExec as JMem
from blaze_tpu.ops.parquet import ParquetScanExec as JScan
from blaze_tpu.ops.parquet import ParquetSinkExec as JSink
from blaze_tpu.runtime import memory as JM
from blaze_tpu_torch.columnar import arrow_io as tio
from blaze_tpu_torch.columnar import serde
from blaze_tpu_torch.columnar import types as TT
from blaze_tpu_torch.columnar.batch import ColumnBatch
from blaze_tpu_torch.config import conf
from blaze_tpu_torch.exprs import ir
from blaze_tpu_torch.exprs.compiler import compile_expr as tcompile
from blaze_tpu_torch.ops import agg
from blaze_tpu_torch.ops import common
from blaze_tpu_torch.ops import join as J
from blaze_tpu_torch.ops import sort_keys as TK
from blaze_tpu_torch.ops.base import ExecContext
from blaze_tpu_torch.ops.basic import MemorySourceExec
from blaze_tpu_torch.ops.parquet import ParquetScanExec, ParquetSinkExec
from blaze_tpu_torch.ops.sort import SortExec
from blaze_tpu_torch.runtime import memory
from test_torch_strings import assert_same

WORDS = [b"", b"a", b"ab", b"abc", b"ABCD", b"abcd\x00", b"abcd",
         b"\x80\xff", b"\xc3\xa9t\xc3\xa9", b"zz", b"same-prefix-long-1",
         b"same-prefix-long-2", b"a" * 30]


def _fields(mod, fields):
    return mod.Schema([mod.Field(n, getattr(mod, k)) for n, k in fields])


def pair(fields, data, cap=None, dictionary=False):
    """The same batch in both packages. Strings are lists with None for
    null; the port's batch is rebuilt from the JAX batch's host arrays,
    padding rows included. `dictionary` passes both through a frame with
    dictionary encoding on, so string columns arrive as `DictData`."""
    n = len(next(iter(data.values())))
    jdata = {k: (np.array(v, object) if isinstance(v, list) else v)
             for k, v in data.items()}
    jb = JBatch.from_numpy(jdata, _fields(JT, fields), capacity=cap)
    if dictionary:
        frame = JSerde.serialize_batch(jb)
        jb = JSerde.deserialize_batch(frame, jb.schema, jb.capacity)
        tb = serde.deserialize_batch(frame, _fields(TT, fields), jb.capacity,
                                     device="cpu")
        assert all(c.is_dict for c, (_, k) in zip(tb.columns, fields)
                   if k in ("STRING", "BINARY"))
        return jb, tb
    arrays = []
    for c in jb.columns:
        v = None if c.validity is None else np.asarray(c.validity)
        if c.is_string:
            arrays.append(((np.asarray(c.data.bytes),
                            np.asarray(c.data.lengths)), v))
        else:
            arrays.append((np.asarray(c.data), v))
    return jb, ColumnBatch.from_host_arrays(_fields(TT, fields), arrays, n,
                                            jb.capacity, device="cpu")


def rows(batches):
    """Live rows of a stream, per column (bytes or None for strings)."""
    out = {}
    for b in batches:
        for k, v in b.to_numpy().items():
            out.setdefault(k, []).extend(list(v))
    return out


def assert_rows_equal(touts, jouts, float_tol=("sum", "avg")):
    got, want = rows(touts), rows(jouts)
    assert list(got) == list(want)
    for k in want:
        g, w = got[k], want[k]
        assert len(g) == len(w), k
        assert [x is None for x in g] == [x is None for x in w], k
        gv = [x for x in g if x is not None]
        wv = [x for x in w if x is not None]
        if any(s in k for s in float_tol):
            np.testing.assert_allclose(np.array(gv, float),
                                       np.array(wv, float), rtol=1e-12)
        elif wv and isinstance(wv[0], bytes):
            assert gv == wv, k
        else:
            np.testing.assert_array_equal(np.array(gv), np.array(wv), k)


def _strings(rng, n, null_p=0.15, words=WORDS):
    idx = rng.integers(0, len(words), n)
    return [None if rng.random() < null_p else words[i] for i in idx]


def _table(seed, n, null_p=0.15, words=WORDS):
    rng = np.random.default_rng(seed)
    return {"s": _strings(rng, n, null_p, words),
            "i": rng.integers(-3, 3, n).astype(np.int64),
            "x": rng.standard_normal(n)}


FIELDS = [("s", "STRING"), ("i", "INT64"), ("x", "FLOAT64")]


# ---------------------------------------------------------------------------
# sort keys
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("max_words,exact", [(None, None), (8, None),
                                             (1, None), (None, 6)])
def test_string_words_match_jax(max_words, exact):
    jb, tb = pair(FIELDS, _table(0, 300))
    jw = JK.string_words(jb.columns[0].data, max_words, exact)
    tw = TK.string_words(tb.columns[0].data, max_words, exact)
    assert len(jw) == len(tw)
    for a, b in zip(jw, tw):
        # the port's words are the unsigned words with the sign bit flipped
        np.testing.assert_array_equal(
            (b.numpy() ^ np.int64(-(1 << 63))).view(np.uint64),
            np.asarray(a))


@pytest.mark.parametrize("dictionary", [False, True])
@pytest.mark.parametrize("asc,nulls_first", [(True, True), (True, False),
                                             (False, True), (False, False)])
def test_string_sort_order_matches_jax(asc, nulls_first, dictionary):
    jb, tb = pair(FIELDS, _table(1, 700), cap=1024, dictionary=dictionary)
    jspecs = [JK.SortSpec(0, asc, nulls_first), JK.SortSpec(1)]
    tspecs = [TK.SortSpec(0, asc, nulls_first), TK.SortSpec(1)]
    assert_rows_equal([TK.sort_batch(tb, tspecs)],
                      [JK.sort_batch(jb, jspecs)], ())


def test_spilled_string_sort_matches_in_memory(tmp_path, monkeypatch):
    """Sorted runs of a string key spill and merge on the host (memcmp keys
    of the 64-byte prefix and the length) into the in-memory order."""
    monkeypatch.setattr(conf, "spill_dir", str(tmp_path))
    tbs = []
    for seed in range(6):
        t = _table(10 + seed, 600)
        t["id"] = np.arange(600, dtype=np.int64) + 600 * seed
        tbs.append(pair(FIELDS + [("id", "INT64")], t, cap=1024)[1])
    specs = [TK.SortSpec(0, False, False), TK.SortSpec(3)]
    ext = SortExec(MemorySourceExec(tbs), specs)
    out = list(ext.execute(ExecContext(
        device="cpu", mem_manager=memory.MemManager(40 << 10))))
    assert ext.metrics["spill_count"] >= 2
    whole = list(SortExec(MemorySourceExec(tbs), specs).execute(
        ExecContext(device="cpu")))
    assert rows(out) == rows(whole)


# ---------------------------------------------------------------------------
# serde
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dict_encode", [True, False])
@pytest.mark.parametrize("null_p", [0.0, 0.3])
def test_serde_frames_byte_identical(monkeypatch, dict_encode, null_p):
    monkeypatch.setattr(conf, "dict_encode_strings", dict_encode)
    monkeypatch.setattr(jconf, "dict_encode_strings", dict_encode)
    jb, tb = pair(FIELDS, _table(2, 900, null_p), cap=1024)
    assert serde.serialize_batch(tb) == JSerde.serialize_batch(jb)
    th, jh = serde.to_host(tb), JSerde.to_host(jb)
    for lo, hi in ((0, 1), (5, 400), (400, 900), (900, 900)):
        assert th.serialize(lo, hi) == jh.serialize(lo, hi)
    # a JAX frame decodes in the port, and the port's frame in the JAX
    # package, to the same rows
    frame = JSerde.serialize_batch(jb)
    back = serde.deserialize_batch(frame, tb.schema, device="cpu")
    assert back.columns[0].is_dict == dict_encode
    assert_rows_equal([back], [jb], ("x",))
    assert serde.serialize_batch(back) == JSerde.serialize_batch(
        JSerde.deserialize_batch(frame, jb.schema))


def test_dictionary_block_decodes_to_dict_data():
    """A dictionary column ships its dictionary and the slice's codes, and
    decodes back into DictData on both the host and the device route."""
    jb, tb = pair(FIELDS, _table(3, 500), cap=512, dictionary=True)
    d = tb.columns[0].data
    assert d.dict_capacity >= 8 and d.width == 32
    assert int(d.dict_lengths[0]) == 0  # entry 0: the empty string
    assert serde.serialize_batch(tb) == JSerde.serialize_batch(jb)
    hb = serde.deserialize_batch_host(serde.serialize_batch(tb), tb.schema)
    assert hb.cols[0].kind == "dict"
    assert_same(JSerde.deserialize_batch(JSerde.serialize_batch(jb),
                                         jb.schema).columns[0].data,
                serde.deserialize_batch(serde.serialize_batch(tb),
                                        tb.schema, device="cpu")
                .columns[0].data)


def test_dictionary_serde_emits_the_jax_trace_events(monkeypatch):
    """With the trace on, encoding a low-cardinality string column in the
    dictionary form records a dict_encode event, and reading the block a
    dict_decode event, with the JAX package's rows and entries."""
    from blaze_tpu.runtime import trace as jtrace
    from blaze_tpu_torch.runtime import trace

    jb, tb = pair(FIELDS, _table(3, 500), cap=512)
    events = []
    for c, tr, ser, b in ((conf, trace, serde, tb),
                          (jconf, jtrace, JSerde, jb)):
        monkeypatch.setattr(c, "trace_enabled", True)
        tr.reset()
        frame = ser.serialize_batch(b)
        ser.deserialize_batch(frame, b.schema, b.capacity,
                              **({"device": "cpu"} if ser is serde else {}))
        events.append([(r["kind"], r["attrs"]["rows"], r["attrs"]["entries"])
                       for r in tr.TRACE.snapshot()
                       if r.get("type") == "event"
                       and r["kind"] in ("dict_encode", "dict_decode")])
        tr.reset()
    assert events[0] == events[1]
    assert [e[0] for e in events[0]] == ["dict_encode", "dict_decode"]


def test_high_cardinality_slice_writes_plain(monkeypatch):
    monkeypatch.setattr(conf, "dict_max_cardinality", 256)
    monkeypatch.setattr(jconf, "dict_max_cardinality", 256)
    words = [b"w%05d" % i for i in range(600)]
    jb, tb = pair(FIELDS, _table(4, 600, 0.0, words), cap=1024)
    frame = serde.serialize_batch(tb)
    assert frame == JSerde.serialize_batch(jb)
    assert serde.deserialize_batch_host(frame, tb.schema).cols[0].kind == "str"


# ---------------------------------------------------------------------------
# Arrow and Parquet
# ---------------------------------------------------------------------------

def _arrow_strings(kind, vals):
    if kind == "dictionary":
        return pa.array(vals, pa.string()).dictionary_encode()
    at = {"string": pa.string(), "large_string": pa.large_string(),
          "binary": pa.binary(), "large_binary": pa.large_binary()}[kind]
    if "string" in kind:
        vals = [None if v is None else v.decode("utf-8", "replace")
                for v in vals]
    return pa.array(vals, at)


@pytest.mark.parametrize("kind", ["string", "large_string", "binary",
                                  "large_binary", "dictionary"])
def test_arrow_string_kinds_match_jax(kind):
    rng = np.random.default_rng(5)
    vals = _strings(rng, 700)
    if kind != "binary":  # text kinds hold valid UTF-8
        vals = [None if v is None else v.decode("utf-8", "replace").encode()
                for v in vals]
    rb = pa.record_batch([pa.array(np.arange(700)),
                          _arrow_strings(kind, vals)], names=["a", "s"])
    rb = rb.slice(3, 650)
    for cap in (None, 1024):
        jb = jio.batch_from_arrow(rb, capacity=cap)
        tb = tio.batch_from_arrow(rb, capacity=cap, device="cpu")
        assert repr(tb.schema.fields[1].dtype) == \
            repr(jb.schema.fields[1].dtype)
        assert_same(jb.columns[1].data, tb.columns[1].data)
        np.testing.assert_array_equal(tb.columns[1].validity.numpy(),
                                      np.asarray(jb.columns[1].validity))
        assert tio.batch_to_arrow(tb).equals(jio.batch_to_arrow(jb))
    assert tio.batch_to_arrow(tb).column(1).to_pylist() == \
        rb.column(1).to_pylist()


def test_parquet_string_scan_and_sink_match_jax(tmp_path):
    rng = np.random.default_rng(6)
    paths = []
    for f in range(2):
        vals = _strings(rng, 3000)
        t = pa.table({"k": pa.array(np.arange(3000) + 3000 * f),
                      "s": pa.array([None if v is None else
                                     v.decode("utf-8", "replace")
                                     for v in vals]),
                      "b": pa.array(vals, pa.binary())})
        p = str(tmp_path / f"f{f}.parquet")
        pq.write_table(t, p, row_group_size=1000)
        paths.append((p, []))
    fields = [("k", "INT64"), ("s", "STRING"), ("b", "BINARY")]
    jop = JScan(paths, _fields(JT, fields), [0, 1, 2],
                pruning_predicates=[jir.Binary(
                    jir.BinOp.GE, jir.col("k"), jir.lit(2500))])
    top = ParquetScanExec(paths, _fields(TT, fields), [0, 1, 2],
                          pruning_predicates=[ir.Binary(
                              ir.BinOp.GE, ir.col("k"), ir.lit(2500))])
    jouts = list(jop.execute(JCtx()))
    touts = list(top.execute(ExecContext(device="cpu")))
    assert top.metrics["row_groups_pruned"] == \
        jop.metrics["row_groups_pruned"] == 2
    assert len(touts) == len(jouts)
    for jb, tb in zip(jouts, touts):
        for jc, tc in zip(jb.columns[1:], tb.columns[1:]):
            assert_same(jc.data, tc.data)
    assert_rows_equal(touts, jouts, ())
    jsink = JSink(JMem(jouts, jouts[0].schema), str(tmp_path / "j.parquet"))
    tsink = ParquetSinkExec(MemorySourceExec(touts, touts[0].schema),
                            str(tmp_path / "t.parquet"))
    (jstat,) = list(jsink.execute(JCtx()))
    (tstat,) = list(tsink.execute(ExecContext(device="cpu")))
    assert tstat.to_numpy()["path"] == [str(tmp_path / "t.parquet").encode()]
    assert int(tstat.columns[1].data[0]) == int(jstat.columns[1].data[0])
    assert pq.read_table(str(tmp_path / "t.parquet")).equals(
        pq.read_table(str(tmp_path / "j.parquet")))


# ---------------------------------------------------------------------------
# aggregation
# ---------------------------------------------------------------------------

AGG_CALLS = [("min", "s", "STRING", "min_s"), ("max", "s", "STRING", "max_s"),
             ("first", "s", "STRING", "first_s"),
             ("first_ignores_null", "s", "STRING", "fin_s"),
             ("count", "s", "INT64", "cnt_s"), ("sum", "x", "FLOAT64", "sum_x")]
AGG_MODES = {"partial": ["PARTIAL"], "final": ["PARTIAL", "FINAL"],
             "merge": ["PARTIAL", "PARTIAL_MERGE", "FINAL"]}


def _agg_plan(mod_ir, T_, A, Mem, batches, keys, modes):
    node = Mem(batches)
    calls = [A.AggCall(fn, (mod_ir.col(c),), getattr(T_, t), name)
             for fn, c, t, name in AGG_CALLS]
    for mode in modes:
        node = A.AggExec(node, [mod_ir.col(k) for k in keys], list(keys),
                         calls, getattr(A.AggMode, mode),
                         collapse_threshold=500)
    return node


@pytest.mark.parametrize("keys", [["g"], ["g", "i"], ["i"]])
@pytest.mark.parametrize("modes", list(AGG_MODES))
def test_agg_string_keys_and_min_max_first_match_jax(keys, modes):
    """String group keys (a null group, keys past 64 bytes) and string
    min/max/first/first_ignores_null; the batches' string widths differ
    (buckets 8 and 32), so state batches concatenate across widths."""
    fields = [("g", "STRING")] + FIELDS
    jbs, tbs = [], []
    for seed, (n, words) in enumerate([(500, WORDS[:8]), (300, WORDS),
                                       (0, WORDS), (450, WORDS[:5])]):
        t = _table(20 + seed, n, words=words)
        t["g"] = _strings(np.random.default_rng(40 + seed), n, 0.1, words)
        t = {k: t[k] for k, _ in fields}
        jb, tb = pair(fields, t, cap=512, dictionary=seed == 1)
        jbs.append(jb)
        tbs.append(tb)
    t = _agg_plan(ir, TT, agg, MemorySourceExec, tbs, keys, AGG_MODES[modes])
    j = _agg_plan(jir, JT, jagg, JMem, jbs, keys, AGG_MODES[modes])
    tout = list(t.execute(ExecContext(device="cpu")))
    jout = list(j.execute(JCtx()))
    assert_rows_equal(tout, jout)


# ---------------------------------------------------------------------------
# joins
# ---------------------------------------------------------------------------

def _join_sides(seed, dictionary=False):
    """Left keys of at most 4 bytes (bucket 4), right keys up to 30 bytes
    (bucket 32): the match phase must pad both to one word count."""
    rng = np.random.default_rng(seed)
    sides = []
    for prefix, words, n, cap in (("l", WORDS[:4], 300, 512),
                                  ("r", WORDS, 200, 256)):
        fields = [(f"{prefix}k", "STRING"), (f"{prefix}id", "INT64")]
        data = {f"{prefix}k": _strings(rng, n, 0.1, words),
                f"{prefix}id": np.arange(n, dtype=np.int64)}
        sides.append(pair(fields, data, cap,
                          dictionary=dictionary and prefix == "r"))
    return sides


@pytest.mark.parametrize("cls_name", ["SortMergeJoinExec",
                                      "BroadcastJoinExec"])
@pytest.mark.parametrize("build_is_left", [False, True])
@pytest.mark.parametrize("jt", [t.name for t in J.JoinType])
def test_string_join_keys_of_different_widths_match_jax(cls_name, jt,
                                                        build_is_left):
    """The narrow side builds or probes: either way the match phase pads
    both sides' keys to the wider one's word count."""
    (jl, tl), (jr, tr) = _join_sides(7, dictionary=cls_name ==
                                     "BroadcastJoinExec")
    assert tl.columns[0].data.width != tr.columns[0].data.width
    jop = getattr(JJ, cls_name)(JMem([jl]), JMem([jr]), [JJ.JoinKey(0, 0)],
                                JJ.JoinType[jt], build_is_left=build_is_left)
    top = getattr(J, cls_name)(MemorySourceExec([tl]), MemorySourceExec([tr]),
                               [J.JoinKey(0, 0)], J.JoinType[jt],
                               build_is_left=build_is_left)
    jouts = list(jop.execute(JCtx()))
    touts = list(top.execute(ExecContext(device="cpu")))
    assert_rows_equal(touts, jouts, ())
    if jt == "INNER":
        got = rows(touts)
        assert len(got["lk"]) > 0 and got["lk"] == got["rk"]


def test_null_safe_string_keys_match_jax():
    (jl, tl), (jr, tr) = _join_sides(8)
    jop = JJ.SortMergeJoinExec(JMem([jl]), JMem([jr]),
                               [JJ.JoinKey(0, 0, True)], JJ.JoinType.FULL)
    top = J.SortMergeJoinExec(MemorySourceExec([tl]), MemorySourceExec([tr]),
                              [J.JoinKey(0, 0, True)], J.JoinType.FULL)
    assert_rows_equal(list(top.execute(ExecContext(device="cpu"))),
                      list(jop.execute(JCtx())), ())


def test_concat_of_string_widths_matches_jax():
    parts = [pair(FIELDS, _table(s, n, words=w), cap=c,
                  dictionary=(s == 2))
             for s, n, w, c in ((0, 100, WORDS[:3], 128), (1, 0, WORDS, 64),
                                (2, 250, WORDS, 256), (3, 7, WORDS[:6], 8))]
    t = common.concat_batches([p[1] for p in parts])
    j = jcommon.concat_batches([p[0] for p in parts])
    assert t.capacity == j.capacity
    assert t.columns[0].data.width == 32 and not t.columns[0].is_dict
    assert_rows_equal([t], [j], ())
    assert memory.batch_nbytes(t) == JM.batch_nbytes(j)
    assert memory.batch_nbytes(parts[2][1]) == JM.batch_nbytes(parts[2][0])


# ---------------------------------------------------------------------------
# expressions
# ---------------------------------------------------------------------------

def _lit(m, T_, v):
    return m.Literal(T_.STRING, v)


def _bin(m, op, a, b):
    return m.Binary(getattr(m.BinOp, op), a, b)


EXPRS = {
    "s = 'abcd'": lambda m, T_: _bin(m, "EQ", m.col("s"), _lit(m, T_, "abcd")),
    "s < t": lambda m, T_: _bin(m, "LT", m.col("s"), m.col("t")),
    "s <= t": lambda m, T_: _bin(m, "LE", m.col("s"), m.col("t")),
    "s > 'ab'": lambda m, T_: _bin(m, "GT", m.col("s"), _lit(m, T_, "ab")),
    "'zz' >= s": lambda m, T_: _bin(m, "GE", _lit(m, T_, "zz"), m.col("s")),
    "s != t": lambda m, T_: _bin(m, "NEQ", m.col("s"), m.col("t")),
    "s <=> t": lambda m, T_: _bin(m, "EQ_NULLSAFE", m.col("s"), m.col("t")),
    "s = NULL": lambda m, T_: _bin(m, "EQ", m.col("s"), _lit(m, T_, None)),
    "CASE": lambda m, T_: m.CaseWhen(
        ((_bin(m, "GT", m.col("i"), m.lit(0)), m.col("t")),
         (_bin(m, "EQ", m.col("i"), m.lit(0)),
          _lit(m, T_, "a much longer literal than any")),), m.col("s")),
    "CASE no ELSE": lambda m, T_: m.CaseWhen(
        ((_bin(m, "LT", m.col("i"), m.lit(0)), _lit(m, T_, "neg")),), None),
    "IF": lambda m, T_: m.If(_bin(m, "GT", m.col("i"), m.lit(1)),
                             _lit(m, T_, "big"), m.col("s")),
    "s IN (...)": lambda m, T_: m.InList(
        m.col("s"), (_lit(m, T_, "ab"), _lit(m, T_, "zz"),
                     _lit(m, T_, "a" * 30)), False),
    "s NOT IN (..., NULL)": lambda m, T_: m.InList(
        m.col("s"), (_lit(m, T_, "ab"), _lit(m, T_, None)), True),
    "LIKE": lambda m, T_: m.Like(m.col("s"), b"%b%"),
    "LIKE escape": lambda m, T_: m.Like(m.col("s"), b"a!_%", b"!"),
    "starts_with": lambda m, T_: m.StringPredicate("starts_with", m.col("s"),
                                                   b"ab"),
    "ends_with": lambda m, T_: m.StringPredicate("ends_with", m.col("s"),
                                                 b"cd"),
    "contains": lambda m, T_: m.StringPredicate("contains", m.col("s"),
                                                b"\xc3\xa9"),
    "substring": lambda m, T_: m.ScalarFn(
        "substring", (m.col("s"), m.lit(2), m.lit(3)), T_.STRING),
    "substr from end": lambda m, T_: m.ScalarFn(
        "substr", (m.col("s"), m.lit(-3)), T_.STRING),
    "substr = literal": lambda m, T_: _bin(m, "EQ", m.ScalarFn(
        "substr", (m.col("t"), m.lit(1), m.lit(2)), T_.STRING),
        _lit(m, T_, "ab")),
}


@pytest.mark.parametrize("name", list(EXPRS))
def test_string_expression_matches_jax(name):
    rng = np.random.default_rng(9)
    fields = [("s", "STRING"), ("t", "STRING"), ("i", "INT64")]
    data = {"s": _strings(rng, 600), "t": _strings(rng, 600, 0.1, WORDS[:6]),
            "i": rng.integers(-2, 3, 600).astype(np.int64)}
    jb, tb = pair(fields, data, cap=1024)
    je, te = EXPRS[name](jir, JT), EXPRS[name](ir, TT)
    assert je.key() == te.key()
    jc = jcompile(je, jb.schema)(jb)
    tc = tcompile(te, tb.schema)(tb)
    assert repr(tc.dtype) == repr(jc.dtype)
    out_j = JBatch(JT.Schema([JT.Field("o", jc.dtype)]), [jc], jb.num_rows,
                   jb.capacity)
    out_t = ColumnBatch(TT.Schema([TT.Field("o", tc.dtype)]), [tc],
                        tb.num_rows, tb.capacity)
    assert_rows_equal([out_t], [out_j], ())


def test_unported_string_paths_raise_naming_module():
    """String paths that used to raise NotImplementedError naming their
    module (upper and concat from exprs/functions.py, the casts to and
    from strings from exprs/cast.py) now equal the JAX package's, row for
    row; a name outside the registry still raises as unsupported."""
    jb, tb = pair(FIELDS, _table(0, 10))
    for name, nargs in (("upper", 1), ("concat", 2)):
        jc = jcompile(jir.ScalarFn(name, (jir.col("s"),) * nargs,
                                   JT.STRING), jb.schema)(jb)
        tc = tcompile(ir.ScalarFn(name, (ir.col("s"),) * nargs, TT.STRING),
                      tb.schema)(tb)
        assert_rows_equal(
            [ColumnBatch(TT.Schema([TT.Field("o", tc.dtype)]), [tc],
                         tb.num_rows, tb.capacity)],
            [JBatch(JT.Schema([JT.Field("o", jc.dtype)]), [jc],
                    jb.num_rows, jb.capacity)], ())
    for src, dst in (("s", "INT64"), ("i", "STRING")):
        jc = jcompile(jir.Cast(jir.col(src), getattr(JT, dst)),
                      jb.schema)(jb)
        tc = tcompile(ir.Cast(ir.col(src), getattr(TT, dst)),
                      tb.schema)(tb)
        assert_rows_equal(
            [ColumnBatch(TT.Schema([TT.Field("o", tc.dtype)]), [tc],
                         tb.num_rows, tb.capacity)],
            [JBatch(JT.Schema([JT.Field("o", jc.dtype)]), [jc],
                    jb.num_rows, jb.capacity)], ())
    with pytest.raises(NotImplementedError, match="not supported"):
        tcompile(ir.ScalarFn("soundex", (ir.col("s"),)), tb.schema)
