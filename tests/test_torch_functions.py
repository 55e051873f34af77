"""Parity of the port's scalar-function registry (blaze_tpu_torch/exprs/
functions.py) with the JAX package's, on the CPU.

One seeded edge table goes through both packages' compilers: doubles with
NaN, ±0, ±inf, HALF_UP boundaries and values past 2^63; int32 and int64
columns with their minimum and maximum; dates before 1970; strings with
nulls, empty strings, JSON documents and strings at the full width of
their bucket. Every registered name has at least one case. Integer,
boolean, date and string outputs (values of valid rows, and validity) are
bitwise equal. Float outputs are bitwise equal, except the functions in
`ULPS`, whose results differ from XLA's CPU ones in the last place: each
is held within the units in the last place given there, which is the
largest difference measured on this table.

One row holds a subnormal double (1e-310). XLA's CPU backend flushes
subnormals to zero, so the JAX package computes sqrt, ceil, signum, the
log domains, nullifzero and the hash of that row as if it were 0; the
port (and Java) keep its value. The parity test leaves that row out and
`test_subnormal_doubles_keep_their_value` pins both sides on it.
"""

import numpy as np
import pytest

from blaze_tpu.columnar import types as JT
from blaze_tpu.columnar.batch import ColumnBatch as JBatch
from blaze_tpu.exprs import functions as jfunctions
from blaze_tpu.exprs import ir as jir
from blaze_tpu.exprs.compiler import compile_expr as jcompile
from blaze_tpu_torch.columnar import types as TT
from blaze_tpu_torch.columnar.batch import ColumnBatch
from blaze_tpu_torch.exprs import functions
from blaze_tpu_torch.exprs import ir as tir
from blaze_tpu_torch.exprs.compiler import compile_expr as tcompile
from torch_function_cases import (
    CAP, CASES, D, FIELDS, N, SUBNORMAL_ROW, SUBNORMAL_VALUE, ULPS,
    _table, _ulp_diff, case,
)

@pytest.fixture(scope="module")
def batches():
    data, validity = _table()
    js = JT.Schema([JT.Field(n, getattr(JT, k)) for n, k in FIELDS])
    ts = TT.Schema([TT.Field(n, getattr(TT, k)) for n, k in FIELDS])
    jb = JBatch.from_numpy(data, js, capacity=CAP, validity=validity)
    arrays = []
    for c in jb.columns:
        v = None if c.validity is None else np.asarray(c.validity)
        if c.is_string:
            arrays.append(((np.asarray(c.data.bytes),
                            np.asarray(c.data.lengths)), v))
        else:
            arrays.append((np.asarray(c.data), v))
    tb = ColumnBatch.from_host_arrays(ts, arrays, N, CAP, device="cpu")
    return jb, tb


def _rows(jc, tc):
    jout = JBatch(JT.Schema([JT.Field("o", jc.dtype)]), [jc],
                  np.int32(N), CAP).to_numpy()["o"]
    tout = ColumnBatch(TT.Schema([TT.Field("o", tc.dtype)]), [tc],
                       N, CAP).to_numpy()["o"]
    return jout, tout


def test_every_registered_name_has_a_case():
    names = {k.split("[")[0] for k in CASES}
    assert sorted(functions.registered_names()) == sorted(
        jfunctions.registered_names())
    assert set(functions.registered_names()) <= names
    assert functions.HOST_EVAL_FNS == jfunctions.HOST_EVAL_FNS
    for n in functions.registered_names():
        assert functions.is_supported(n) == jfunctions.is_supported(n)
        assert functions.is_host_fn(n) == jfunctions.is_host_fn(n)


@pytest.mark.parametrize("name", sorted(CASES))
def test_function_matches_jax(batches, name):
    jb, tb = batches
    make = CASES[name]
    jc = jcompile(make(jir, JT), jb.schema)(jb)
    tc = tcompile(make(tir, TT), tb.schema)(tb)
    assert repr(tc.dtype) == repr(jc.dtype)
    live = (np.arange(CAP) < N) & (np.arange(CAP) != SUBNORMAL_ROW)
    np.testing.assert_array_equal(tc.valid_mask().numpy() & live,
                                  np.asarray(jc.valid_mask()) & live)
    jrows, trows = _rows(jc, tc)
    assert len(jrows) == len(trows) == N
    jrows, trows = ([x for k, x in enumerate(r) if k != SUBNORMAL_ROW]
                    for r in (jrows, trows))
    fn = name.split("[")[0]
    jnull = np.array([x is None for x in jrows])
    tnull = np.array([x is None for x in trows])
    np.testing.assert_array_equal(tnull, jnull)
    jv = [x for x in jrows if x is not None]
    tv = [x for x in trows if x is not None]
    if tc.dtype.is_floating:
        diff = _ulp_diff(np.array(tv, np.float64), np.array(jv, np.float64))
        assert diff.max(initial=0) <= ULPS.get(fn, 0), (
            name, int(diff.max(initial=0)))
    elif tc.dtype.is_nested:
        assert [[None if e is None else (e if isinstance(e, bytes)
                                         else int(e)) for e in x]
                for x in tv] == [[None if e is None else (
                    e if isinstance(e, bytes) else int(e)) for e in x]
                    for x in jv]
    elif tc.is_string:
        assert tv == jv
    else:
        np.testing.assert_array_equal(np.array(tv, np.int64),
                                      np.array(jv, np.int64))


def test_unknown_name_is_unsupported(batches):
    _, tb = batches
    with pytest.raises(NotImplementedError, match="not supported"):
        tcompile(tir.ScalarFn("soundex", (tir.col("s"),)), tb.schema)


def test_subnormal_doubles_keep_their_value(batches):
    """The subnormal row: the port keeps 1e-310 as Java does (its sqrt,
    ceil, signum, log-domain validity, nullifzero and murmur3 hash are
    numpy's and the row interpreter's); the JAX package, on XLA's CPU
    backend, flushes it to zero."""
    from blaze_tpu_torch.spark.fallback import PYTHON_FNS

    jb, tb = batches
    x = SUBNORMAL_VALUE
    want = {"sqrt": np.sqrt(x), "ceil": 1, "signum": 1.0, "ln": np.log(x),
            "nullifzero": x,
            "hash": int(PYTHON_FNS["hash"](np.array([x]))[0])}
    flushed = {"sqrt": 0.0, "ceil": 0, "signum": 0.0, "ln": None,
               "nullifzero": None, "hash": int(PYTHON_FNS["hash"](
                   np.array([0.0]))[0])}
    for name, value in want.items():
        make = case(name, D)
        jc = jcompile(make(jir, JT), jb.schema)(jb)
        tc = tcompile(make(tir, TT), tb.schema)(tb)
        jrows, trows = _rows(jc, tc)
        assert data_d(jb)[SUBNORMAL_ROW] == x
        assert trows[SUBNORMAL_ROW] == value, name
        assert jrows[SUBNORMAL_ROW] == flushed[name], name


def data_d(jb):
    return np.asarray(jb.columns[0].data)
