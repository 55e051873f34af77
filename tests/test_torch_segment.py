"""ops/segment.py of the port against the JAX package's, on the CPU.

Each case makes a batch from a seeded numpy generator with nulls, NaN,
+-inf and -0.0 (for floats) and few distinct keys, sorts it with the JAX
package's sort_batch, and hands the identical sorted batch to both
packages. group_layout and every seg_* reduction must agree: integers,
row indices, counts, flags and min/max/first values bitwise (NaN equal to
NaN, -0.0 to 0.0), f64 sums within rtol 1e-12.
"""

import numpy as np
import pytest
import torch

from blaze_tpu.columnar import types as JT
from blaze_tpu.columnar.batch import ColumnBatch as JBatch
from blaze_tpu.ops import segment as jseg
from blaze_tpu.ops.sort_keys import SortSpec as JSpec
from blaze_tpu.ops.sort_keys import sort_batch as jsort
from blaze_tpu_torch.columnar import types as TT
from blaze_tpu_torch.columnar.batch import ColumnBatch
from blaze_tpu_torch.ops import segment as seg

KINDS = ["INT8", "INT16", "INT32", "INT64", "DATE", "FLOAT32", "FLOAT64"]
N, CAP = 700, 1024


def _values(rng, kind, n, distinct):
    """n values of `kind` drawn from `distinct` candidates, floats with
    NaN, +-inf, 0.0 and -0.0 among them."""
    if kind.startswith("FLOAT"):
        specials = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0])
        pool = np.concatenate([specials, rng.standard_normal(distinct)])
        return rng.choice(pool, n).astype(JT.DataType(
            getattr(JT.TypeKind, kind)).np_dtype())
    info = np.iinfo({"INT8": np.int8, "INT16": np.int16,
                     "DATE": np.int32, "INT32": np.int32}.get(kind, np.int64))
    pool = np.concatenate([[info.min, info.max, 0, -1],
                           rng.integers(info.min // 2, info.max // 2,
                                        distinct)])
    return rng.choice(pool, n)


def _pair(rng, key_kinds, val_kind="FLOAT64", null_p=0.15):
    """A JAX batch of keys k0.. and value v (nulls in every column), sorted
    by the keys in the JAX package, and the same batch in the port."""
    fields = [(f"k{i}", k) for i, k in enumerate(key_kinds)] + \
        [("v", val_kind)]
    jschema = JT.Schema([JT.Field(n, getattr(JT, k)) for n, k in fields])
    tschema = TT.Schema([TT.Field(n, getattr(TT, k)) for n, k in fields])
    data, valid = {}, {}
    for name, kind in fields:
        data[name] = _values(rng, kind, N, 6 if name != "v" else 50)
        valid[name] = rng.random(N) >= null_p
    jb = JBatch.from_numpy(data, jschema, capacity=CAP, validity=valid)
    jb = jsort(jb, [JSpec(i) for i in range(len(key_kinds))])
    arrays = [(np.asarray(c.data),
               None if c.validity is None else np.asarray(c.validity))
              for c in jb.columns]
    tb = ColumnBatch.from_host_arrays(tschema, arrays, int(jb.num_rows), CAP,
                                      device="cpu")
    return jb, tb


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("kind", KINDS)
def test_group_layout_matches_jax(kind):
    rng = np.random.default_rng(KINDS.index(kind))
    jb, tb = _pair(rng, [kind, "INT32"])
    keys = [0, 1]
    jl, tl = jseg.group_layout(jb, keys), seg.group_layout(tb, keys)
    live = _np(jl.row_mask)
    np.testing.assert_array_equal(_np(tl.row_mask), live)
    np.testing.assert_array_equal(_np(tl.starts), _np(jl.starts))
    np.testing.assert_array_equal(_np(tl.gid)[live], _np(jl.gid)[live])
    assert int(tl.num_groups) == int(jl.num_groups)
    np.testing.assert_array_equal(_np(tl.start_idx), _np(jl.start_idx))
    np.testing.assert_array_equal(_np(tl.end_idx), _np(jl.end_idx))
    np.testing.assert_array_equal(_np(tl.group_mask), _np(jl.group_mask))
    ng = int(jl.num_groups)
    assert 1 < ng < N


def test_single_global_group_layout():
    rng = np.random.default_rng(9)
    jb, tb = _pair(rng, ["INT32"])
    jl, tl = jseg.group_layout(jb, []), seg.group_layout(tb, [])
    assert int(tl.num_groups) == int(jl.num_groups) == 1
    np.testing.assert_array_equal(_np(tl.starts), _np(jl.starts))
    np.testing.assert_array_equal(_np(tl.end_idx), _np(jl.end_idx))


@pytest.mark.parametrize("kind", KINDS)
def test_seg_reductions_match_jax(kind):
    rng = np.random.default_rng(100 + KINDS.index(kind))
    jb, tb = _pair(rng, ["INT16"], val_kind=kind)
    jl, tl = jseg.group_layout(jb, [0]), seg.group_layout(tb, [0])
    jv, tv = jb.columns[1], tb.columns[1]
    jvalid, tvalid = jv.valid_mask(), tv.valid_mask()
    ng = int(jl.num_groups)

    def eq(t, j):
        np.testing.assert_array_equal(_np(t)[:ng], _np(j)[:ng])

    for name in ("seg_min", "seg_max"):
        tval, thas = getattr(seg, name)(tv.data, tl, tvalid)
        jval, jhas = getattr(jseg, name)(jv.data, jl, jvalid)
        eq(thas, jhas)
        eq(tval, jval)
    for ign in (False, True):
        tval, tok = seg.seg_first(tv.data, tl, tvalid, ign)
        jval, jok = jseg.seg_first(jv.data, jl, jvalid, ign)
        eq(tok, jok)
        eq(tval, jval)
    eq(seg.seg_count(tvalid, tl), jseg.seg_count(jvalid, jl))
    eq(seg.seg_any(tvalid & (tv.data > 0), tl),
       jseg.seg_any(jvalid & (jv.data > 0), jl))
    if kind.startswith("FLOAT"):
        # sums of finite values only: inf - inf orders differ by nothing,
        # but keep the comparison to finite sums
        fin_t = tvalid & torch.isfinite(tv.data)
        fin_j = jvalid & np.isfinite(np.asarray(jv.data))
        ts = seg.seg_sum(tv.data.to(torch.float64), tl, fin_t)
        js = jseg.seg_sum(np.asarray(jv.data, np.float64), jl, fin_j)
        np.testing.assert_allclose(_np(ts)[:ng], _np(js)[:ng], rtol=1e-12)
    else:
        eq(seg.seg_sum(tv.data.to(torch.int64), tl, tvalid),
           jseg.seg_sum(np.asarray(jv.data, np.int64), jl, jvalid))


def test_seg_min_max_nan_groups():
    """Spark's NaN order by hand: min skips NaN unless a group is all NaN,
    max is NaN when a group has one; null-only groups are (0, False)."""
    nan = float("nan")
    keys = [1, 1, 2, 2, 3, 3, 4]
    vals = [nan, 2.0, nan, nan, -0.0, 0.0, 5.0]
    valid = [True, True, True, True, True, True, False]
    schema = TT.Schema([TT.Field("k", TT.INT32), TT.Field("v", TT.FLOAT64)])
    b = ColumnBatch.from_numpy({"k": np.array(keys), "v": np.array(vals)},
                               schema, validity={"v": np.array(valid)},
                               device="cpu")
    lay = seg.group_layout(b, [0])
    mn, has = seg.seg_min(b.columns[1].data, lay, b.columns[1].valid_mask())
    mx, _ = seg.seg_max(b.columns[1].data, lay, b.columns[1].valid_mask())
    np.testing.assert_array_equal(mn[:4].numpy(), [2.0, nan, 0.0, 0.0])
    np.testing.assert_array_equal(mx[:4].numpy(), [nan, nan, 0.0, 0.0])
    np.testing.assert_array_equal(has[:4].numpy(), [True, True, True, False])
