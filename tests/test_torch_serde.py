"""The port's frame serde (columnar/serde.py) against the JAX package's, on the
CPU.

With `zstandard` installed both packages compress with it, so the same batch
must serialize to byte-identical frames: `BTB1 | raw_len | comp_len |
zstd(payload)`, LSB-first packed validity, little-endian values. Each
package decodes the other's frames: whole batches, row slices, streams of
frames, empty batches, nulls, and a NULL-typed column. String columns raise
by name in the port, written or read.
"""

import io
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blaze_tpu.columnar import serde as JS
from blaze_tpu.columnar import types as JT
from blaze_tpu.columnar.batch import Column as JColumn
from blaze_tpu.columnar.batch import ColumnBatch as JBatch
from blaze_tpu_torch.columnar import serde as S
from blaze_tpu_torch.columnar import types as TT
from blaze_tpu_torch.columnar.batch import Column, ColumnBatch
from blaze_tpu_torch.runtime import metrics

KINDS = ["INT8", "INT16", "INT32", "DATE", "BOOLEAN", "INT64", "TIMESTAMP",
         "DECIMAL", "FLOAT32", "FLOAT64"]


def _dtype(mod, kind):
    return mod.decimal(18, 2) if kind == "DECIMAL" else getattr(mod, kind)


def _values(rng, kind, n):
    if kind == "BOOLEAN":
        return rng.random(n) < 0.5
    if kind in ("FLOAT32", "FLOAT64"):
        ft = np.float32 if kind == "FLOAT32" else np.float64
        v = (rng.standard_normal(n) * 1e3).astype(ft)
        v[:min(n, 5)] = np.array([np.nan, -0.0, np.inf, -np.inf, 1.5],
                                 ft)[:min(n, 5)]
        return v
    it = {"INT8": np.int8, "INT16": np.int16, "INT32": np.int32,
          "DATE": np.int32}.get(kind, np.int64)
    info = np.iinfo(it)
    return rng.integers(info.min, info.max, n, endpoint=True,
                        dtype=np.int64).astype(it)


def _pair(n=300, cap=512, nulls=True, seed=0):
    """(JAX batch, port batch) of every dense kind over the same arrays:
    seeded values, 20% nulls in every column when `nulls`, rows >= n
    padding."""
    rng = np.random.default_rng(seed)
    names = [f"c{i}" for i in range(len(KINDS))]
    js = JT.Schema([JT.Field(nm, _dtype(JT, k)) for nm, k in zip(names,
                                                                 KINDS)])
    ts = TT.Schema([TT.Field(nm, _dtype(TT, k)) for nm, k in zip(names,
                                                                 KINDS)])
    data = {nm: _values(rng, k, n) for nm, k in zip(names, KINDS)}
    valid = {nm: rng.random(n) > 0.2 for nm in names} if nulls else None
    jb = JBatch.from_numpy(data, js, capacity=cap, validity=valid)
    tb = ColumnBatch.from_host_arrays(
        ts, [(np.asarray(c.data),
              None if c.validity is None else np.asarray(c.validity))
             for c in jb.columns], int(jb.num_rows), jb.capacity,
        device="cpu")
    return jb, tb


def _bits(a):
    a = np.asarray(a)
    if a.dtype.kind == "f":
        return a.view(np.int32 if a.itemsize == 4 else np.int64)
    return a


def _assert_rows_equal(t, j):
    """Live rows of a port batch and a JAX batch, bit for bit (invalid
    slots read as 0 on both sides)."""
    n = int(j.num_rows)
    assert int(t.num_rows) == n
    for tc, jc in zip(t.columns, j.columns):
        tv = tc.valid_mask()[:n].numpy()
        jv = np.asarray(jc.valid_mask())[:n]
        np.testing.assert_array_equal(tv, jv)
        td = _bits(tc.data[:n].numpy())
        jd = _bits(np.asarray(jc.data)[:n]).astype(td.dtype)
        np.testing.assert_array_equal(np.where(tv, td, 0),
                                      np.where(jv, jd, 0))


@pytest.mark.parametrize("n,cap,nulls", [(300, 512, True), (300, 512, False),
                                         (1, 1024, True), (0, 1024, True),
                                         (4096, 4096, True)])
def test_frames_byte_identical(n, cap, nulls):
    jb, tb = _pair(n, cap, nulls, seed=n)
    frame = S.serialize_batch(tb)
    assert frame == JS.serialize_batch(jb)
    assert frame[:4] == b"BTB1"
    raw_len, comp_len = struct.unpack("<II", frame[4:12])
    assert len(frame) == 12 + comp_len and raw_len > 0


@pytest.mark.parametrize("lo,hi", [(0, 300), (0, 1), (7, 8), (13, 250),
                                   (299, 300), (150, 150)])
def test_row_slices_byte_identical(lo, hi):
    """HostBatch.serialize(lo, hi): the shuffle writer's per-partition
    frames; bool validity packing at odd offsets and lengths."""
    jb, tb = _pair(seed=lo + hi)
    frame = S.to_host(tb).serialize(lo, hi)
    assert frame == JS.to_host(jb).serialize(lo, hi)
    assert S.serialize_slice(S.to_host(tb), lo, hi) == frame
    back = S.deserialize_batch(frame, tb.schema, device="cpu")
    want = JS.deserialize_batch(frame, jb.schema)
    _assert_rows_equal(back, want)
    assert int(back.num_rows) == hi - lo


@pytest.mark.parametrize("nulls", [True, False])
def test_each_package_decodes_the_others_frames(nulls):
    jb, tb = _pair(nulls=nulls, seed=3)
    # JAX frame -> port batch, port frame -> JAX batch
    _assert_rows_equal(S.deserialize_batch(JS.serialize_batch(jb),
                                           tb.schema, device="cpu"), jb)
    _assert_rows_equal(tb, JS.deserialize_batch(S.serialize_batch(tb),
                                                jb.schema))
    # host decode of each other's frames
    hb = S.deserialize_batch_host(JS.serialize_batch(jb), tb.schema)
    jhb = JS.deserialize_batch_host(S.serialize_batch(tb), jb.schema)
    for c, jc in zip(hb.cols, jhb.cols):
        np.testing.assert_array_equal(_bits(c.data), _bits(jc.data))
        if nulls:
            np.testing.assert_array_equal(c.validity, jc.validity)
        else:
            assert c.validity is None and jc.validity is None


def test_frame_streams_cross_decode():
    """A file of several frames (a spill file or a shuffle segment) written
    by one package reads back in the other, frame for frame."""
    pairs = [_pair(n, 512, seed=n) for n in (300, 0, 17, 512)]
    jbuf = io.BytesIO()
    tbuf = io.BytesIO()
    for jb, tb in pairs:
        jbuf.write(JS.serialize_batch(jb))
        assert S.write_batch(tbuf, tb) > 12
    assert jbuf.getvalue() == tbuf.getvalue()
    jbuf.seek(0)
    got = list(S.read_batches(jbuf, pairs[0][1].schema, device="cpu"))
    assert len(got) == len(pairs)
    for b, (jb, _) in zip(got, pairs):
        _assert_rows_equal(b, jb)
    tbuf.seek(0)
    hosts = list(S.read_batches_host(tbuf, pairs[0][1].schema))
    assert [h.num_rows for h in hosts] == [300, 0, 17, 512]
    tbuf.seek(0)
    jgot = list(JS.read_batches(tbuf, pairs[0][0].schema))
    for jb2, (_, tb) in zip(jgot, pairs):
        _assert_rows_equal(tb, jb2)


def test_read_batch_at_eof_and_torn_frames():
    _, tb = _pair(seed=9)
    frame = S.serialize_batch(tb)
    assert S.read_batch(io.BytesIO(b""), tb.schema, device="cpu") is None
    with pytest.raises(EOFError):
        S.read_batch(io.BytesIO(frame[:-3]), tb.schema, device="cpu")
    with pytest.raises(ValueError, match="header"):
        S.read_batch(io.BytesIO(b"XXXX" + frame[4:]), tb.schema,
                     device="cpu")
    with pytest.raises(ValueError, match="empty"):
        S.deserialize_batch_host(b"", tb.schema)


def test_capacity_and_padding_of_decoded_batch():
    """A decoded batch pads to the requested capacity, invalid slots zeroed
    (the batch invariant), on the device asked for."""
    jb, tb = _pair(seed=4)
    frame = S.serialize_batch(tb)
    b = S.deserialize_batch(frame, tb.schema, capacity=2048, device="cpu")
    assert b.capacity == 2048 and b.device.type == "cpu"
    for c in b.columns:
        assert c.data.shape == (2048,)
        assert not bool(c.valid_mask()[300:].any())
        assert bool((c.data[~c.valid_mask()] == 0).all())
    _assert_rows_equal(b, jb)


def test_null_typed_column_matches_jax():
    js = JT.Schema([JT.Field("n", JT.NULL), JT.Field("x", JT.INT32)])
    ts = TT.Schema([TT.Field("n", TT.NULL), TT.Field("x", TT.INT32)])
    jb = JBatch(js, [JColumn(JT.NULL, jnp.zeros(1024, jnp.int8),
                             jnp.zeros(1024, jnp.bool_)),
                     JColumn(JT.INT32, jnp.arange(1024, dtype=jnp.int32))],
                jnp.asarray(10, jnp.int32), 1024)
    tb = ColumnBatch(ts, [Column(TT.NULL, torch.zeros(1024, dtype=torch.int8),
                                 torch.zeros(1024, dtype=torch.bool)),
                          Column(TT.INT32, torch.arange(1024,
                                                        dtype=torch.int32))],
                     torch.tensor(10, dtype=torch.int32), 1024)
    frame = S.serialize_batch(tb)
    assert frame == JS.serialize_batch(jb)
    back = S.deserialize_batch(frame, ts, device="cpu")
    assert not bool(back.columns[0].valid_mask().any())
    assert back.columns[1].data[:10].tolist() == list(range(10))


def test_one_host_pull_a_batch():
    """to_host packs every column, validity and the row count into one
    device->host copy."""
    _, tb = _pair(seed=5)
    before = metrics.HOST_PULLS
    hb = S.to_host(tb)
    assert metrics.HOST_PULLS == before + 1
    assert hb.num_rows == 300
    assert S.host_batch_nbytes(hb) == sum(
        c.data.nbytes + (0 if c.validity is None else c.validity.nbytes)
        for c in hb.cols)


def test_serde_time_is_counted():
    _, tb = _pair(seed=6)
    enc, dec = metrics.SERDE_NS["encode"], metrics.SERDE_NS["decode"]
    S.deserialize_batch_host(S.serialize_batch(tb), tb.schema)
    assert metrics.SERDE_NS["encode"] > enc
    assert metrics.SERDE_NS["decode"] > dec
