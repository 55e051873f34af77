"""Parity of the port's batch model (blaze_tpu_torch/columnar) with the JAX
package's (blaze_tpu/columnar), on the CPU.

Both packages build batches from the same numpy inputs made from a seed;
integer, boolean and float arrays must come out bitwise equal, padding
rows included where both define them.
"""

import numpy as np
import pytest
import torch

from blaze_tpu.columnar import types as JT
from blaze_tpu.columnar.batch import ColumnBatch as JBatch
from blaze_tpu_torch.columnar import types as TT
from blaze_tpu_torch.columnar.batch import ColumnBatch, bucket_capacity

KINDS = ["BOOLEAN", "INT8", "INT16", "INT32", "INT64", "FLOAT32", "FLOAT64",
         "DATE", "TIMESTAMP"]


@pytest.mark.parametrize("kind", KINDS)
def test_dtype_maps_like_jax(kind):
    jdt = getattr(JT, kind)
    tdt = getattr(TT, kind)
    assert tdt.np_dtype() == jdt.np_dtype()
    assert tdt.byte_width() == jdt.byte_width()
    assert repr(tdt) == repr(jdt)
    assert (tdt.is_integral, tdt.is_floating, tdt.is_numeric) == (
        jdt.is_integral, jdt.is_floating, jdt.is_numeric)


def test_decimal_maps_like_jax():
    assert TT.decimal(10, 2).np_dtype() == JT.decimal(10, 2).np_dtype()
    assert repr(TT.decimal(10, 2)) == repr(JT.decimal(10, 2))
    assert TT.decimal(38, 2).wide_decimal


@pytest.mark.parametrize("dtype", [TT.list_of(TT.INT32),
                                   TT.decimal(38, 0)])
def test_unported_storage_raises(dtype):
    """Neither kind has a dense dtype, and both have storage of their own:
    an empty batch holds empty lists, and a wide decimal column is held
    as its two int64 limb planes (zeros), as in the JAX package."""
    with pytest.raises(NotImplementedError):
        dtype.torch_dtype()
    schema = TT.Schema([TT.Field("x", dtype)])
    b = ColumnBatch.empty(schema, device="cpu").with_num_rows(2)
    if dtype.is_nested:
        assert b.to_numpy()["x"] == [[], []]
        return
    planes = b.columns[0].data.children
    assert [p.data.dtype for p in planes] == [torch.int64, torch.int64]
    assert b.to_numpy()["x"] == [0, 0]
    jb = JBatch.empty(JT.Schema([JT.Field("x", JT.decimal(38, 0))]))
    assert jb.with_num_rows(2).to_numpy()["x"] == [0, 0]


def _schemas(seed, n):
    rng = np.random.default_rng(seed)
    data = {
        "b": rng.random(n) < 0.5,
        "i8": rng.integers(-128, 128, n).astype(np.int8),
        "i32": rng.integers(-2**31, 2**31, n).astype(np.int32),
        "i64": rng.integers(-2**62, 2**62, n).astype(np.int64),
        "f32": rng.standard_normal(n).astype(np.float32),
        "f64": rng.standard_normal(n) * 1e6,
        "d": rng.integers(-10000, 10000, n).astype(np.int32),
    }
    kinds = {"b": "BOOLEAN", "i8": "INT8", "i32": "INT32", "i64": "INT64",
             "f32": "FLOAT32", "f64": "FLOAT64", "d": "DATE"}
    js = JT.Schema([JT.Field(k, getattr(JT, v)) for k, v in kinds.items()])
    ts = TT.Schema([TT.Field(k, getattr(TT, v)) for k, v in kinds.items()])
    validity = {k: rng.random(n) < 0.8 for k in ("i32", "f64", "b")}
    return data, js, ts, validity


def _full_arrays(jb):
    return [(np.asarray(c.data),
             None if c.validity is None else np.asarray(c.validity))
            for c in jb.columns]


@pytest.mark.parametrize("n,cap", [(1000, None), (1500, 4096), (4096, None)])
@pytest.mark.parametrize("with_validity", [False, True])
def test_from_numpy_matches_jax(n, cap, with_validity):
    data, js, ts, validity = _schemas(n, n)
    v = validity if with_validity else None
    jb = JBatch.from_numpy(data, js, capacity=cap, validity=v)
    tb = ColumnBatch.from_numpy(data, ts, capacity=cap, validity=v,
                                device="cpu")
    assert tb.capacity == jb.capacity
    assert int(tb.num_rows) == int(jb.num_rows) == n
    assert tb.shape_key() == ColumnBatch.from_numpy(
        data, ts, capacity=cap, validity=v, device="cpu").shape_key()
    for (jd, jv), tc in zip(_full_arrays(jb), tb.columns):
        np.testing.assert_array_equal(tc.data.numpy(), jd)
        assert (tc.validity is None) == (jv is None)
        if jv is not None:
            np.testing.assert_array_equal(tc.validity.numpy(), jv)
    jn, tn = jb.to_numpy(), tb.to_numpy()
    for k in jn:
        np.testing.assert_array_equal(tn[k], jn[k])


def test_from_numpy_object_nulls():
    data = {"x": np.array([1, None, 3, None], dtype=object)}
    jb = JBatch.from_numpy(data, JT.Schema([JT.Field("x", JT.INT64)]))
    tb = ColumnBatch.from_numpy(data, TT.Schema([TT.Field("x", TT.INT64)]),
                                device="cpu")
    assert list(tb.to_numpy()["x"]) == list(jb.to_numpy()["x"]) == [
        1, None, 3, None]
    # invalid slots hold the dtype's zero (batch invariant)
    assert tb.columns[0].data[1].item() == 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_from_host_arrays_carries_a_jax_batch(seed):
    data, js, ts, validity = _schemas(seed, 3000)
    jb = JBatch.from_numpy(data, js, capacity=4096, validity=validity)
    tb = ColumnBatch.from_host_arrays(ts, _full_arrays(jb),
                                      int(jb.num_rows), jb.capacity,
                                      device="cpu")
    assert tb.shape_key() == ColumnBatch.from_numpy(
        data, ts, capacity=4096, validity=validity, device="cpu").shape_key()
    for (jd, jv), tc in zip(_full_arrays(jb), tb.columns):
        np.testing.assert_array_equal(tc.data.numpy(), jd)
        np.testing.assert_array_equal(tc.valid_mask().numpy(),
                                      np.ones(4096, bool) if jv is None
                                      else jv)


def test_from_host_arrays_checks_shapes():
    ts = TT.Schema([TT.Field("x", TT.INT32)])
    with pytest.raises(ValueError):
        ColumnBatch.from_host_arrays(ts, [(np.zeros(10, np.int32), None)],
                                     10, 16, device="cpu")
    with pytest.raises(ValueError):
        ColumnBatch.from_host_arrays(ts, [], 0, 16, device="cpu")


@pytest.mark.parametrize("seed", [3, 4])
def test_compact_matches_jax(seed):
    data, js, ts, validity = _schemas(seed, 2500)
    jb = JBatch.from_numpy(data, js, validity=validity)
    tb = ColumnBatch.from_host_arrays(ts, _full_arrays(jb),
                                      int(jb.num_rows), jb.capacity,
                                      device="cpu")
    keep = np.random.default_rng(seed).random(jb.capacity) < 0.3
    import jax.numpy as jnp

    jc = jb.compact(jnp.asarray(keep))
    tc = tb.compact(torch.from_numpy(keep))
    assert int(tc.num_rows) == int(jc.num_rows)
    assert tc.capacity == jc.capacity
    jn, tn = jc.to_numpy(), tc.to_numpy()
    for k in jn:
        np.testing.assert_array_equal(tn[k], jn[k])


def test_row_mask_take_and_num_rows():
    ts = TT.Schema([TT.Field("x", TT.INT32)])
    tb = ColumnBatch.from_numpy({"x": np.arange(10, dtype=np.int32)}, ts,
                                capacity=16, device="cpu")
    assert tb.row_mask().tolist() == [True] * 10 + [False] * 6
    assert tb.with_num_rows(3).row_mask().sum().item() == 3
    t = tb.take(torch.tensor([9, 0, 20]), 3)
    assert t.columns[0].data.tolist() == [9, 0, 0]  # out of range clamps
    assert t.capacity == 3 and int(t.num_rows) == 3
    assert tb.device == torch.device("cpu")
    assert bucket_capacity(1) == 1024 and bucket_capacity(1025) == 2048
