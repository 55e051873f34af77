"""The port's Spark murmur3 (exprs/hash.py) against the JAX package's, bit for
bit on the CPU.

Every covered kind (int8/16/32, date, bool, int64, timestamp, decimal
p <= 18, float32, float64) over seeded numpy values with the kind's
extremes, -0.0, NaN and infinities, nulls and padding rows; multi-column
chains; pmod into several partition counts; and the round-robin start. The
inputs are the same arrays in both packages (a port batch is rebuilt from
the JAX batch's host arrays, padding included).
"""

import numpy as np
import pytest
import torch

from blaze_tpu.columnar import types as JT
from blaze_tpu.columnar.batch import ColumnBatch as JBatch
from blaze_tpu.exprs import hash as JH
from blaze_tpu.ops.shuffle import round_robin_start as j_rr_start
from blaze_tpu_torch.columnar import types as TT
from blaze_tpu_torch.columnar.batch import Column, ColumnBatch
from blaze_tpu_torch.exprs import hash as H
from blaze_tpu_torch.ops.shuffle import round_robin_start

KINDS = ["INT8", "INT16", "INT32", "DATE", "BOOLEAN", "INT64", "TIMESTAMP",
         "DECIMAL", "FLOAT32", "FLOAT64"]
N, CAP = 300, 512


def _dtype(mod, kind):
    return mod.decimal(18, 2) if kind == "DECIMAL" else getattr(mod, kind)


def _values(rng, kind, n):
    """Seeded values of one kind with its extremes and special values."""
    if kind == "BOOLEAN":
        return rng.random(n) < 0.5
    if kind in ("FLOAT32", "FLOAT64"):
        ft = np.float32 if kind == "FLOAT32" else np.float64
        v = (rng.standard_normal(n) * 1e3).astype(ft)
        special = np.array([np.nan, -0.0, 0.0, np.inf, -np.inf, 1.5,
                            np.finfo(ft).max, np.finfo(ft).tiny, -2.25], ft)
        v[:len(special)] = special
        return v
    it = {"INT8": np.int8, "INT16": np.int16, "INT32": np.int32,
          "DATE": np.int32}.get(kind, np.int64)
    info = np.iinfo(it)
    if kind == "DECIMAL":  # unscaled values of decimal(18, 2)
        info = np.iinfo(np.int64)
        lo, hi = -(10 ** 18) + 1, 10 ** 18 - 1
    else:
        lo, hi = int(info.min), int(info.max)
    v = rng.integers(lo, hi, n, endpoint=True, dtype=np.int64).astype(it)
    v[:5] = np.array([lo, hi, 0, -1, 1], np.int64).astype(it)
    return v


def _pair(kinds, seed, nulls=True, n=N, cap=CAP):
    """(JAX batch, port batch) over the same arrays: seeded values per kind,
    20% nulls where `nulls`, rows >= n padding."""
    rng = np.random.default_rng(seed)
    names = [f"c{i}" for i in range(len(kinds))]
    js = JT.Schema([JT.Field(nm, _dtype(JT, k))
                    for nm, k in zip(names, kinds)])
    ts = TT.Schema([TT.Field(nm, _dtype(TT, k))
                    for nm, k in zip(names, kinds)])
    data = {nm: _values(rng, k, n) for nm, k in zip(names, kinds)}
    valid = ({nm: rng.random(n) > 0.2 for nm in names} if nulls else None)
    jb = JBatch.from_numpy(data, js, capacity=cap, validity=valid)
    tb = ColumnBatch.from_host_arrays(
        ts, [(np.asarray(c.data),
              None if c.validity is None else np.asarray(c.validity))
             for c in jb.columns], int(jb.num_rows), jb.capacity,
        device="cpu")
    return jb, tb


def _both(jb, tb, cols=None, seed=H.SPARK_SHUFFLE_SEED):
    """hash_columns of the chosen columns in both packages, live rows
    masked (padding keeps the seed)."""
    cols = range(len(tb.columns)) if cols is None else cols
    j = np.asarray(JH.hash_columns([jb.columns[i] for i in cols], seed,
                                   row_mask=jb.row_mask()))
    t = H.hash_columns([tb.columns[i] for i in cols], seed,
                       row_mask=tb.row_mask())
    assert t.dtype == torch.int32
    return j, t.numpy()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("nulls", [False, True])
def test_hash_of_each_kind_matches_jax(kind, nulls):
    jb, tb = _pair([kind], seed=KINDS.index(kind), nulls=nulls)
    j, t = _both(jb, tb)
    np.testing.assert_array_equal(t, j)
    # padding rows and null rows keep the seed
    seed_i32 = np.int32(H.SPARK_SHUFFLE_SEED)
    assert (t[N:] == seed_i32).all()
    if nulls:
        v = np.asarray(jb.columns[0].validity)[:N]
        assert (t[:N][~v] == seed_i32).all()


def test_spark_golden_values():
    """Spark's own answers: hash(1) = -559580957 and hash(1L) =
    -1712319331 (seed 42), and a double hashes its doubleToLongBits."""
    one = torch.tensor([1], dtype=torch.int32)
    assert H.hash_columns([Column(TT.INT32, one)])[0] == -559580957
    assert H.hash_columns([Column(TT.INT64, one.long())])[0] == -1712319331
    d = torch.tensor([1.0], dtype=torch.float64)
    bits = torch.tensor([np.float64(1.0).view(np.int64)])
    assert H.hash_columns([Column(TT.FLOAT64, d)])[0] == \
        H.hash_columns([Column(TT.INT64, bits)])[0]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_multi_column_chain_matches_jax(seed):
    """All kinds hashed as one 10-column key (each column's hash seeds the
    next), and a 3-column key of int, double and bool."""
    jb, tb = _pair(KINDS, seed=100 + seed)
    np.testing.assert_array_equal(*_both(jb, tb))
    cols = [KINDS.index("INT32"), KINDS.index("FLOAT64"),
            KINDS.index("BOOLEAN")]
    np.testing.assert_array_equal(*_both(jb, tb, cols))
    np.testing.assert_array_equal(*_both(jb, tb, cols, seed=0))


@pytest.mark.parametrize("P", [1, 7, 200, 4096])
def test_pmod_matches_jax(P):
    jb, tb = _pair(["INT64", "FLOAT64"], seed=P)
    j, t = _both(jb, tb)
    jp = np.asarray(JH.pmod(np.asarray(j), P))
    tp = H.pmod(torch.from_numpy(t), P)
    np.testing.assert_array_equal(tp.numpy(), jp)
    assert tp.dtype == torch.int32
    assert (tp >= 0).all() and (tp < P).all()
    assert (t < 0).any()  # negative hashes were folded, not truncated


def test_negative_zero_and_nans_hash_as_canonical():
    """-0.0 hashes as 0.0 and every NaN payload as the canonical NaN
    (doubleToLongBits / floatToIntBits)."""
    f64 = np.array([0.0, -0.0, np.nan, np.nan, np.nan], np.float64)
    f64[3:4] = np.array([0x7FF8000000000001], np.int64).view(np.float64)
    f64[4:5] = np.array([-1], np.int64).view(np.float64)  # 0xFFFF... NaN
    f32 = np.array([0.0, -0.0, np.nan, np.nan, np.nan], np.float32)
    f32[3:4] = np.array([0x7FC00001], np.int32).view(np.float32)
    f32[4:5] = np.array([-1], np.int32).view(np.float32)
    for arr, dt in ((f64, TT.FLOAT64), (f32, TT.FLOAT32)):
        h = H.hash_columns([Column(dt, torch.from_numpy(arr))]).numpy()
        assert h[0] == h[1]
        assert h[2] == h[3] == h[4]


def test_round_robin_start_matches_jax():
    for P in (1, 4, 200):
        got = [round_robin_start(t, P) for t in range(40)]
        assert got == [j_rr_start(t, P) for t in range(40)]
        assert all(0 <= s < P for s in got)
    assert len({round_robin_start(t, 200) for t in range(40)}) > 20


def test_string_and_wide_decimal_hashes_raise_by_module():
    """Strings hash (tests/test_torch_strings.py), and so do wide decimals
    now: murmur3 over the minimal big-endian bytes of the unscaled value,
    equal to the JAX package's bit for bit, and their partition ids too
    (seeded values, the 128-bit extremes and the byte-length edges, nulls
    and padding rows)."""
    rng = np.random.default_rng(30)
    edges = [0, 1, -1, 127, 128, -128, -129, 255, 256, -(1 << 63),
             (1 << 63) - 1, 1 << 63, -(1 << 64), (1 << 64) - 1,
             10 ** 38 - 1, -(10 ** 38 - 1), (1 << 127) - 1, -(1 << 127)]
    vals = edges + [int(rng.integers(-2**62, 2**62)) * int(
        rng.integers(1, 2**40)) for _ in range(N - len(edges))]
    vals = [None if i % 7 == 3 else v for i, v in enumerate(vals)]
    jb = JBatch.from_numpy({"d": vals}, JT.Schema(
        [JT.Field("d", JT.decimal(38, 0))]), capacity=CAP)
    tb = ColumnBatch.from_numpy({"d": vals}, TT.Schema(
        [TT.Field("d", TT.decimal(38, 0))]), capacity=CAP, device="cpu")
    want = np.asarray(JH.hash_columns(jb.columns, 42, jb.row_mask()))
    got = H.hash_columns(tb.columns, 42, tb.row_mask()).numpy()
    np.testing.assert_array_equal(got, want)
    for P in (1, 7, 200):
        np.testing.assert_array_equal(H.pmod(torch.from_numpy(got),
                                             P).numpy(),
                                      np.asarray(JH.pmod(want, P)))
