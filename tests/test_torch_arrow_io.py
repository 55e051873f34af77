"""columnar/arrow_io.py of the port against the JAX package's, on the CPU.

The same seeded Arrow arrays (every dense kind, with and without nulls,
sliced at an offset, chunked and dictionary-encoded) go through
`batch_from_arrow` in both packages: data, validity and its presence must
be bitwise equal over the whole capacity. `batch_to_arrow` must give back
the arrays it was given; the kinds the port cannot hold yet raise
NotImplementedError naming the module that will carry them; the
FfiReaderExec of both packages ingests the same RecordBatches.
"""

import datetime
import decimal

import numpy as np
import pyarrow as pa
import pytest

from blaze_tpu.columnar import arrow_io as jio
from blaze_tpu.ops.base import ExecContext as JCtx
from blaze_tpu.ops.shuffle import FfiReaderExec as JFfi
from blaze_tpu.runtime import resources as jres
from blaze_tpu_torch.columnar import arrow_io as tio
from blaze_tpu_torch.columnar import types as TT
from blaze_tpu_torch.ops.base import ExecContext
from blaze_tpu_torch.ops.shuffle import FfiReaderExec
from blaze_tpu_torch.runtime import resources

N = 300


def _arrow(kind, rng, n, nulls):
    """An Arrow array of `kind` with n values (a fifth null if `nulls`)."""
    mask = (rng.random(n) < 0.2) if nulls else None
    if kind == "bool":
        return pa.array(rng.random(n) < 0.5, pa.bool_(), mask=mask)
    if kind in ("int8", "int16", "int32", "int64"):
        info = np.iinfo(kind)
        v = rng.integers(info.min, info.max, n, dtype=kind, endpoint=True)
        return pa.array(v, getattr(pa, kind)(), mask=mask)
    if kind in ("float32", "float64"):
        v = rng.choice(np.array([np.nan, np.inf, -0.0, 1.5, -3e30]), n)
        return pa.array(v.astype(kind), getattr(pa, kind)(), mask=mask)
    if kind == "date32":
        return pa.array(rng.integers(-30000, 60000, n).astype(np.int32),
                        pa.date32(), mask=mask)
    if kind.startswith("timestamp"):
        unit = kind.split("_")[1]
        return pa.array(rng.integers(-2**40, 2**40, n), pa.timestamp(unit),
                        mask=mask)
    if kind == "decimal":
        v = [decimal.Decimal(int(x)).scaleb(-2)
             for x in rng.integers(-10**15, 10**15, n)]
        return pa.array(v, pa.decimal128(18, 2),
                        mask=mask)
    if kind == "null":
        return pa.nulls(n)
    raise AssertionError(kind)


KINDS = ["bool", "int8", "int16", "int32", "int64", "float32", "float64",
         "date32", "timestamp_us", "timestamp_ms", "decimal", "null"]


def _same(jb, tb):
    assert jb.capacity == tb.capacity
    assert int(jb.num_rows) == int(tb.num_rows)
    for jc, tc in zip(jb.columns, tb.columns):
        assert (jc.validity is None) == (tc.validity is None)
        if jc.validity is not None:
            np.testing.assert_array_equal(np.asarray(jc.validity),
                                          tc.validity.numpy())
        jd, td = np.asarray(jc.data), tc.data.numpy()
        assert jd.dtype == td.dtype
        np.testing.assert_array_equal(jd.view(np.uint8), td.view(np.uint8))


def _both(rb, cap=None):
    jschema = jio.schema_from_arrow(rb.schema)
    tschema = tio.schema_from_arrow(rb.schema)
    return (jio.batch_from_arrow(rb, capacity=cap, schema=jschema),
            tio.batch_from_arrow(rb, capacity=cap, schema=tschema,
                                 device="cpu"))


@pytest.mark.parametrize("nulls", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_batch_from_arrow_equal(kind, nulls):
    rng = np.random.default_rng(KINDS.index(kind))
    arr = _arrow(kind, rng, N, nulls)
    rb = pa.record_batch([arr], names=["c"])
    for cap in (None, 1024):
        _same(*_both(rb, cap))


@pytest.mark.parametrize("kind", KINDS)
def test_sliced_chunked_and_dictionary_arrays_equal(kind):
    """Offsets into the Arrow buffers (data and validity bitmap) are
    honoured: a slice starting at an odd row equals its copy."""
    rng = np.random.default_rng(100 + KINDS.index(kind))
    arr = _arrow(kind, rng, N, True)
    sliced = arr.slice(37, 200)
    jb, tb = _both(pa.record_batch([sliced], names=["c"]))
    _same(jb, tb)
    _, tcopy = _both(pa.record_batch([pa.concat_arrays([sliced])],
                                     names=["c"]))
    _same(jb, tcopy)
    chunked = pa.chunked_array([arr.slice(0, 100), arr.slice(100)])
    dt = tio.dtype_from_arrow(arr.type)
    tc = tio.column_from_arrow(chunked, dt, 512, device="cpu")
    jc = jio.column_from_arrow(chunked, jio.dtype_from_arrow(arr.type), 512)
    np.testing.assert_array_equal(np.asarray(jc.data), tc.data.numpy())
    if kind in ("int32", "int64"):
        d = pa.array(rng.integers(0, 5, N), pa.int64()).cast(arr.type)
        enc = d.dictionary_encode()
        assert pa.types.is_dictionary(enc.type)
        tc = tio.column_from_arrow(enc, dt, 512, device="cpu")
        np.testing.assert_array_equal(tc.data.numpy()[:N],
                                      d.to_numpy(zero_copy_only=False))


@pytest.mark.parametrize("kind", KINDS)
def test_round_trip(kind):
    rng = np.random.default_rng(200 + KINDS.index(kind))
    arr = _arrow(kind, rng, N, True)
    rb = pa.record_batch([arr.slice(5)], names=["c"])
    _, tb = _both(rb)
    back = tio.batch_to_arrow(tb)
    want = rb.column(0)
    if kind == "timestamp_ms":   # the port holds microseconds
        want = want.cast(pa.timestamp("us"))
    _arrays_equal(back.column(0), want)
    assert back.schema == tio.schema_to_arrow(tb.schema)
    jback = jio.batch_to_arrow(jio.batch_from_arrow(
        rb, schema=jio.schema_from_arrow(rb.schema)))
    _arrays_equal(back.column(0), jback.column(0))


def _arrays_equal(a, b):
    """Same type, nulls and values (NaN equal to NaN)."""
    assert a.type == b.type
    assert a.is_valid().equals(b.is_valid())
    if pa.types.is_floating(a.type):
        np.testing.assert_array_equal(a.fill_null(0).to_numpy(),
                                      b.fill_null(0).to_numpy())
    else:
        assert a.to_pylist() == b.to_pylist()


def test_dtype_and_schema_mapping_equal():
    types = [pa.bool_(), pa.int8(), pa.int16(), pa.int32(), pa.int64(),
             pa.float32(), pa.float64(), pa.date32(), pa.timestamp("ns"),
             pa.decimal128(10, 3), pa.decimal128(30, 4), pa.string(),
             pa.large_binary(), pa.list_(pa.int32()),
             pa.map_(pa.string(), pa.int64()),
             pa.struct([pa.field("x", pa.int32())]),
             pa.dictionary(pa.int32(), pa.string()), pa.null()]
    for at in types:
        jd, td = jio.dtype_from_arrow(at), tio.dtype_from_arrow(at)
        assert repr(jd) == repr(td), at
        assert jio.dtype_to_arrow(jd) == tio.dtype_to_arrow(td)
    s = pa.schema([pa.field(f"f{i}", t) for i, t in enumerate(types)])
    assert tio.schema_to_arrow(tio.schema_from_arrow(s)) == \
        jio.schema_to_arrow(jio.schema_from_arrow(s))
    with pytest.raises(TypeError):
        tio.dtype_from_arrow(pa.month_day_nano_interval())


@pytest.mark.parametrize("arr,module", [
    pytest.param(pa.array([decimal.Decimal("1.5")], pa.decimal128(30, 2)),
                 "columnar/int128.py", id="arr3-columnar/int128.py"),
])
def test_unsupported_kinds_raise(arr, module):
    """A decimal128 of precision > 18 used to raise naming `module`; it
    reads now as the JAX package reads it (two limb planes), a sliced
    array included, and writes back to the same Arrow values."""
    rb = pa.record_batch([pa.array([1] * len(arr)), arr], names=["a", "x"])
    tb = tio.batch_from_arrow(rb, device="cpu")
    assert module == "columnar/int128.py"
    assert tb.to_numpy()["x"] == jio.batch_from_arrow(rb).to_numpy()["x"]
    assert tio.batch_to_arrow(tb).column(1).equals(arr)
    vals = [decimal.Decimal("-12345678901234567890.12"), None,
            decimal.Decimal("99999999999999999999999999.99"),
            decimal.Decimal("0.01")]
    big = pa.array(vals, pa.decimal128(28, 2)).slice(1)
    rb = pa.record_batch([pa.array([1, 2, 3]), big], names=["a", "x"])
    tb = tio.batch_from_arrow(rb, device="cpu")
    assert tb.to_numpy()["x"] == jio.batch_from_arrow(rb).to_numpy()["x"]
    assert tio.batch_to_arrow(tb).column(1).equals(big)


def test_ffi_reader_ingests_arrow_like_jax():
    """A provider of RecordBatches (and one ready batch) through both
    packages' FfiReaderExec."""
    rng = np.random.default_rng(7)
    rbs = [pa.record_batch([_arrow("int64", rng, n, True),
                            _arrow("float64", rng, n, False),
                            _arrow("date32", rng, n, True)],
                           names=["k", "v", "d"]).slice(3)
           for n in (100, 2000)]
    jschema = jio.schema_from_arrow(rbs[0].schema)
    tschema = tio.schema_from_arrow(rbs[0].schema)
    jres.put("arrow:src", lambda: iter(rbs))
    resources.put("arrow:src", lambda: iter(rbs))
    jouts = list(JFfi(jschema, "arrow:src").execute(JCtx()))
    touts = list(FfiReaderExec(tschema, "arrow:src").execute(
        ExecContext(device="cpu")))
    assert len(jouts) == len(touts) == 2
    for jb, tb in zip(jouts, touts):
        _same(jb, tb)


def test_date_and_timestamp_values():
    """Dates arrive as int32 days, timestamps as int64 microseconds."""
    rb = pa.record_batch(
        [pa.array([datetime.date(1970, 1, 2), None]),
         pa.array([datetime.datetime(1970, 1, 1, 0, 0, 1), None],
                  pa.timestamp("ms"))], names=["d", "t"])
    tb = tio.batch_from_arrow(rb, device="cpu")
    assert tb.schema.fields[0].dtype == TT.DATE
    assert tb.columns[0].data.numpy()[:2].tolist() == [1, 0]
    assert tb.columns[1].data.numpy()[:2].tolist() == [1_000_000, 0]
    assert tb.columns[1].validity.numpy()[:2].tolist() == [True, False]
