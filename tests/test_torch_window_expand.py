"""WindowExec, ExpandExec and GenerateExec of the port against the JAX
package's, on the CPU.

Both packages run the same seeded batches: partition keys with a null
partition, order keys with ties and nulls, float values with NaN and
nulls, int32 values. Every window function (row_number, rank,
dense_rank, count, sum, avg, min, max), with and without ORDER BY, with
and without partition keys, in memory and across spilled chunks under a
small memory budget; Expand's grouping sets; explode, posexplode and
outer. Then chip_smoke.py's window and basket queries through both
packages' `run_plan`.

Tolerance: integers, ranks, counts, min, max and row order are equal bit
for bit (NaN equal to NaN). f64 window sums and averages are not: the
port's running sum adds in doubling-scan order and XLA's associative scan
in its own tree order, so each must agree within 1e-12 x the running sum
of |x| over the row's frame (plus 1e-300, for frames that sum to zero).
"""

import numpy as np
import pytest

import chip_smoke as cs
from blaze_tpu.columnar import types as JT
from blaze_tpu.columnar.batch import ColumnBatch as JBatch
from blaze_tpu.exprs import ir as jir
from blaze_tpu.ops import expand as JE
from blaze_tpu.ops import window as JW
from blaze_tpu.ops.base import ExecContext as JCtx
from blaze_tpu.ops.basic import MemorySourceExec as JMem
from blaze_tpu.ops.sort_keys import SortSpec as JSpec
from blaze_tpu.runtime import memory as JM
from blaze_tpu.runtime.executor import collect as jcollect
from blaze_tpu_torch.columnar import types as TT
from blaze_tpu_torch.columnar.batch import ColumnBatch
from blaze_tpu_torch.exprs import ir
from blaze_tpu_torch.ops import expand as E
from blaze_tpu_torch.ops import window as W
from blaze_tpu_torch.ops.base import ExecContext
from blaze_tpu_torch.ops.basic import MemorySourceExec
from blaze_tpu_torch.ops.sort_keys import SortSpec
from blaze_tpu_torch.runtime import memory as M
from blaze_tpu_torch.runtime.executor import collect
from torch_parity import assert_same_stages, no_jax_native

FIELDS = [("g", "INT64"), ("o", "INT32"), ("v", "FLOAT64"), ("i", "INT32"),
          ("a", "FLOAT64")]

PKG = {"jax": (JT, JBatch, jir, JMem, JW, JSpec, JE, JM),
       "torch": (TT, ColumnBatch, ir, MemorySourceExec, W, SortSpec, E, M)}


def _data(seed, sizes, ties=True):
    """Seeded batches' host values; column a is |v| (0 where v is null or
    NaN), the bound's weights."""
    rng = np.random.default_rng(seed)
    out = []
    for n in sizes:
        v = rng.choice([np.nan, 1.5, -2.25, 0.0, 1e6, -1e-3, 7.0], n) * \
            rng.random(n)
        vv = rng.random(n) > 0.2
        d = {"g": rng.integers(0, 6, n).astype(np.int64),
             "o": rng.integers(0, 8 if ties else 1 << 30, n).astype(np.int32),
             "v": v, "i": rng.integers(-1000, 1000, n).astype(np.int32),
             "a": np.where(vv & ~np.isnan(v), np.abs(v), 0.0)}
        valid = {"g": rng.random(n) > 0.1, "o": rng.random(n) > 0.15,
                 "v": vv, "i": rng.random(n) > 0.2}
        out.append((d, valid))
    return out


def _batches(pkg, data):
    T, B = PKG[pkg][0], PKG[pkg][1]
    schema = T.Schema([T.Field(n, getattr(T, k)) for n, k in FIELDS])
    kw = {} if pkg == "jax" else {"device": "cpu"}
    return [B.from_numpy(d, schema, validity=v, **kw) for d, v in data]


CALLS = [("row_number", None, "INT32"), ("rank", None, "INT32"),
         ("dense_rank", None, "INT32"), ("count", "v", "INT64"),
         ("sum", "v", "FLOAT64"), ("sum", "i", "INT32"),
         ("avg", "v", "FLOAT64"), ("avg", "i", "FLOAT64"),
         ("min", "v", "FLOAT64"), ("max", "v", "FLOAT64"),
         ("min", "i", "INT32"), ("max", "i", "INT32"),
         ("sum", "a", "FLOAT64")]


def _window(pkg, data, parts, order, budget=None, calls=CALLS):
    T, _, I, Mem, Wm, Spec, _, Mm = PKG[pkg]
    bs = _batches(pkg, data)
    wc = [Wm.WindowCall(fn, () if c is None else (I.col(c),),
                        getattr(T, dt), f"{fn}_{c}")
          for fn, c, dt in calls]
    node = Wm.WindowExec(Mem(bs, bs[0].schema), wc,
                         [I.col(p) for p in parts],
                         [Spec(*s) for s in order])
    mgr = Mm.MemManager(budget) if budget else None
    if pkg == "jax":
        return jcollect(node, JCtx(mem_manager=mgr)).to_numpy(), node
    return collect(node, ExecContext(device="cpu",
                                     mem_manager=mgr)).to_numpy(), node


def _col(v):
    return np.array([np.nan if x is None else x for x in v], np.float64), \
        np.array([x is None for x in v])


def _assert_windows_equal(got, want, order_free=False):
    """Bit-equal but for the f64 sums and averages (module docstring);
    `order_free` compares rows as sorted by the input columns and the
    values that do not depend on the order of tied rows."""
    assert list(got) == list(want)
    keys = [k for k in want if not k.startswith("row_number")]
    if order_free:
        def perm(d):
            cols = [_col(d[k]) for k in ("g", "o", "v", "i")]
            return np.lexsort([c for v, m in reversed(cols)
                               for c in (np.nan_to_num(v, nan=np.inf), m)])
        pg, pw = perm(got), perm(want)
    else:
        pg = pw = slice(None)
    bound = _col(want["sum_a"])[0][pw] * 1e-12 + 1e-300
    for k in keys if order_free else list(want):
        g, gn = _col(got[k])
        w, wn = _col(want[k])
        g, gn, w, wn = g[pg], gn[pg], w[pw], wn[pw]
        np.testing.assert_array_equal(gn, wn, err_msg=k)
        if k in ("sum_v", "avg_v", "sum_a"):
            scale = bound if k != "avg_v" else bound / np.maximum(
                _col(want["count_v"])[0][pw], 1)
            ok = np.isnan(w) == np.isnan(g)
            assert ok.all(), k
            fin = ~np.isnan(w)
            assert (np.abs(g - w)[fin] <= scale[fin]).all(), k
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


ORDERS = {"asc": [(1, True, True)], "desc_nulls_last": [(1, False, False)],
          "two_keys": [(1, True, False), (3, False, True)], "none": []}


@pytest.mark.parametrize("order", sorted(ORDERS))
@pytest.mark.parametrize("parts", [["g"], []], ids=["by_g", "global"])
def test_window_matches_jax(order, parts):
    data = _data(1, [300, 77])
    want, _ = _window("jax", data, parts, ORDERS[order])
    got, _ = _window("torch", data, parts, ORDERS[order])
    _assert_windows_equal(got, want)


@pytest.mark.parametrize("ties", [True, False])
def test_window_across_spilled_chunks(ties):
    """Under a 20 kB budget the window's sort spills runs and merges them
    back on the host in chunks; partitions span chunks and carry. Row
    numbers of tied rows follow the merge's tie order (ROADMAP Queue 3),
    so with ties the rows compare sorted by their input values and
    row_number is left out."""
    data = _data(2, [400] * 6, ties=ties)
    want, _ = _window("jax", data, ["g"], ORDERS["asc"],
                      budget=20_000)
    got, node = _window("torch", data, ["g"], ORDERS["asc"],
                        budget=20_000)
    assert node.metrics["spill_count"] >= 2
    _assert_windows_equal(got, want, order_free=ties)
    full, _ = _window("torch", data, ["g"], ORDERS["asc"])
    _assert_windows_equal(got, full, order_free=ties)


def test_segmented_scans_match_jax():
    """segmented_scan over +, fmin, maximum and |, and segmented_cumsum,
    equal to the JAX package's segmented_scan (sums of integers exact)."""
    import jax.numpy as jnp
    import torch

    from blaze_tpu.ops import segment as JS
    from blaze_tpu_torch.ops import segment as TS

    rng = np.random.default_rng(3)
    for n in (1, 2, 5, 64, 1000, 4099):
        starts = rng.random(n) < 0.05
        ints = rng.integers(-(1 << 40), 1 << 40, n)
        fl = rng.choice([np.nan, 1.0, -3.5, 2.0, np.inf], n)
        bits = rng.random(n) < 0.1
        cases = [(ints, lambda a, b: a + b, lambda a, b: a + b),
                 (fl, jnp.fmin, torch.fmin),
                 (fl, jnp.maximum, torch.maximum),
                 (bits, lambda a, b: a | b, lambda a, b: a | b)]
        for x, jop, top in cases:
            want = np.asarray(JS.segmented_scan(jnp.asarray(x),
                                                jnp.asarray(starts), jop))
            got = TS.segmented_scan(torch.from_numpy(x),
                                    torch.from_numpy(starts), top).numpy()
            np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            TS.segmented_cumsum(torch.from_numpy(ints),
                                torch.from_numpy(starts)).numpy(),
            np.asarray(JS.segmented_scan(jnp.asarray(ints),
                                         jnp.asarray(starts),
                                         lambda a, b: a + b)))


def test_element_rows_match_jax():
    import jax.numpy as jnp
    import torch

    from blaze_tpu.ops import segment as JS
    from blaze_tpu_torch.ops import segment as TS

    rng = np.random.default_rng(4)
    lens = rng.integers(0, 4, 50).astype(np.int32)
    offs = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    for cap, ecap in ((50, 256), (20, 256), (50, 64)):
        want = JS.element_rows(jnp.asarray(offs), cap, ecap)
        got = TS.element_rows(torch.from_numpy(offs), cap, ecap)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _run_op(pkg, make):
    if pkg == "jax":
        return jcollect(make(*PKG[pkg])).to_numpy()
    return collect(make(*PKG[pkg]), ExecContext(device="cpu")).to_numpy()


def _same_rows(got, want):
    assert list(got) == list(want)
    for k in want:
        assert [None if x is None else (x.item() if hasattr(x, "item")
                                        else x) for x in got[k]] == \
            [None if x is None else (x.item() if hasattr(x, "item") else x)
             for x in want[k]], k


def test_expand_grouping_sets_match_jax():
    """ROLLUP-style projections, with a null string literal of another
    width than the column's: one batch per list, then the rows through
    a concatenation."""
    rng = np.random.default_rng(5)
    n = 50
    d = {"g": rng.integers(0, 5, n).astype(np.int64),
         "s": ["name" * int(k) for k in rng.integers(1, 5, n)],
         "v": rng.random(n)}

    def make(T, B, I, Mem, Wm, Spec, Em, Mm):
        schema = T.Schema([T.Field("g", T.INT64), T.Field("s", T.STRING),
                           T.Field("v", T.FLOAT64)])
        kw = {} if T is JT else {"device": "cpu"}
        b = B.from_numpy(d, schema, **kw)
        out = T.Schema([T.Field("g", T.INT64), T.Field("s", T.STRING),
                        T.Field("v", T.FLOAT64),
                        T.Field("gid", T.INT32, False)])
        return Em.ExpandExec(Mem([b], schema), [
            [I.col("g"), I.col("s"), I.col("v"), I.lit(0, T.INT32)],
            [I.col("g"), I.Literal(T.STRING, None), I.col("v"),
             I.lit(1, T.INT32)],
            [I.Literal(T.INT64, None), I.Literal(T.STRING, None),
             I.col("v"), I.lit(3, T.INT32)]], out)

    want, got = _run_op("jax", make), _run_op("torch", make)
    _same_rows(got, want)
    assert len(got["gid"]) == 150


@pytest.mark.parametrize("pos,outer", [(False, False), (True, False),
                                       (False, True), (True, True)])
@pytest.mark.parametrize("elem", ["INT64", "STRING"])
def test_generate_matches_jax(pos, outer, elem):
    """explode and posexplode, outer or not, of a list column with null
    rows, empty rows and null elements; a struct column rides along."""
    rng = np.random.default_rng(6)
    n = 60

    def value(k):
        return int(k) if elem == "INT64" else "x" * int(k)

    xs = [None if rng.random() < 0.15 else
          [None if rng.random() < 0.1 else value(k)
           for k in rng.integers(0, 9, int(rng.integers(0, 5)))]
          for _ in range(n)]
    st = [None if rng.random() < 0.2 else (int(k), "s" * int(k))
          for k in rng.integers(0, 5, n)]
    d = {"id": np.arange(n, dtype=np.int64), "xs": xs, "st": st}

    def make(T, B, I, Mem, Wm, Spec, Em, Mm):
        schema = T.Schema([
            T.Field("id", T.INT64),
            T.Field("xs", T.list_of(getattr(T, elem))),
            T.Field("st", T.struct_of([T.Field("a", T.INT64),
                                       T.Field("b", T.STRING)]))])
        kw = {} if T is JT else {"device": "cpu"}
        b = B.from_numpy(d, schema, capacity=64, **kw)
        names = ["pos", "x"] if pos else ["x"]
        return Em.GenerateExec(Mem([b, b], schema), I.col("xs"), [0, 2],
                               names, pos=pos, outer=outer)

    want, got = _run_op("jax", make), _run_op("torch", make)
    _same_rows(got, want)
    rows = sum((max(len(x), 1) if outer else len(x)) if x is not None
               else int(outer) for x in xs)
    assert len(got["id"]) == 2 * rows


def test_generate_refuses_list_required_columns():
    schema = TT.Schema([TT.Field("xs", TT.list_of(TT.INT64))])
    b = ColumnBatch.from_numpy({"xs": [[1]]}, schema, device="cpu")
    with pytest.raises(NotImplementedError, match="list-typed required"):
        E.GenerateExec(MemorySourceExec([b], schema), ir.col("xs"), [0],
                       ["x"])


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    """Each package's TPC-DS tables from the same seed."""
    from blaze_tpu.spark import tpcds as jtpcds
    from blaze_tpu_torch.spark import tpcds

    d = tmp_path_factory.mktemp("nested")
    (d / "port").mkdir()
    (d / "jax").mkdir()
    return (tpcds.generate_tables(str(d / "port"), rows=6000),
            jtpcds.generate_tables(str(d / "jax"), rows=6000))


@pytest.mark.parametrize("q", sorted(cs.NESTED_QUERIES))
@pytest.mark.parametrize("mode", ["bhj", "smj"])
def test_nested_queries_run_plan_like_jax(tables, tmp_path, monkeypatch, q,
                                          mode):
    """chip_smoke.py's q51_store, basket_items and basket_stores, built by
    the same function over each package's spark/tpcds.py, through each
    package's run_plan: equal rows (float sums within rtol 1e-12), and
    the routes and stage counts equal."""
    from blaze_tpu.config import conf as jconf
    from blaze_tpu.spark import tpcds as jtpcds
    from blaze_tpu.spark.local_runner import run_plan as jrun_plan
    from blaze_tpu_torch.spark import tpcds
    from blaze_tpu_torch.spark.local_runner import run_plan

    monkeypatch.setattr(jconf, "enable_supervisor", False)
    monkeypatch.setattr(jconf, "enable_pipeline", False)
    no_jax_native(monkeypatch)
    (paths, _), (jpaths, _) = tables
    info, jinfo = {}, {}
    out = run_plan(cs.NESTED_QUERIES[q](tpcds, paths, mode),
                   num_partitions=4, work_dir=str(tmp_path / "port"),
                   run_info=info, device="cpu").to_numpy()
    want = jrun_plan(cs.NESTED_QUERIES[q](jtpcds, jpaths, mode),
                     num_partitions=4, work_dir=str(tmp_path / "jax"),
                     mesh_exchange="off", run_info=jinfo).to_numpy()
    assert list(out) == list(want)
    if q == "basket_items":  # unordered: sort both by customer
        def perm(d):
            return np.argsort([-1 if k is None else k
                               for k in d["ss_customer_sk"]], kind="stable")
        out = {k: [v[i] for i in perm(out)] for k, v in out.items()}
        want = {k: [v[i] for i in perm(want)] for k, v in want.items()}
    for k in want:
        g, w = _col(list(out[k]))
        jg, jw = _col(list(want[k]))
        np.testing.assert_array_equal(w, jw, err_msg=k)
        np.testing.assert_allclose(g[~w], jg[~jw], rtol=1e-12, err_msg=k)
    assert len(want[next(iter(want))]) > 0
    assert_same_stages(info, jinfo)


@pytest.mark.parametrize("share", [0.0, 0.05, 0.9, 1.0])
def test_last_marked_matches_cummax(share):
    """segment.last_marked (the last marked row at or before each row, 0
    before the first) equals torch.cummax over the marked row indices."""
    import torch

    from blaze_tpu_torch.ops.segment import last_marked

    rng = np.random.default_rng(7)
    for n in (1, 2, 3, 1000, 4097):
        mask = torch.from_numpy(rng.random(n) < share)
        row = torch.arange(n)
        want = torch.cummax(torch.where(mask, row, 0), 0).values
        assert torch.equal(last_marked(mask), want)
