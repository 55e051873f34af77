"""Query-level correctness gate: BASELINE configs as query shapes, each run
through the FULL driver path (tagging -> conversion -> stage splitting ->
multi-stage execution) against a pandas oracle, across BOTH join configs.

Port of blaze_tpu/spark/validator.py, and with its `__main__` the port's
validate.py:

    python -m blaze_tpu_torch.spark.validator [--device cpu] [--suite tpcds]

Ref: the reference's north-star gate is the TPC-DS validator matrix —
every query x {BHJ, forced-SMJ (autoBroadcastJoinThreshold=-1)} x spark
version, executed with the plugin and diffed against vanilla answers
(dev/run-tpcds-test:52-57, .github/workflows/tpcds.yml:92-147). pandas
is imported only by the data generator, the oracles and the report, so
the module imports where pandas is not installed.
"""

from __future__ import annotations

import dataclasses
import time
import traceback
from typing import Callable, Dict, List, Optional

import numpy as np
import pyarrow as pa

from blaze_tpu_torch.columnar import types as T
from blaze_tpu_torch.device import DeviceLike
from blaze_tpu_torch.exprs import ir
from blaze_tpu_torch.exprs.ir import BinOp, col, lit
from blaze_tpu_torch.spark import plan_model as P
from blaze_tpu_torch.spark.local_runner import run_plan

# ---------------------------------------------------------------------------
# TPC-DS-shaped data
# ---------------------------------------------------------------------------

SS_SCHEMA = T.Schema([
    T.Field("ss_sold_date_sk", T.INT64),
    T.Field("ss_item_sk", T.INT64),
    T.Field("ss_customer_sk", T.INT64),
    T.Field("ss_store_sk", T.INT64),
    T.Field("ss_quantity", T.INT32),
    T.Field("ss_sales_price", T.FLOAT64),
    T.Field("ss_ext_sales_price", T.FLOAT64),
])
DD_SCHEMA = T.Schema([
    T.Field("d_date_sk", T.INT64),
    T.Field("d_year", T.INT32),
    T.Field("d_moy", T.INT32),
])
ITEM_SCHEMA = T.Schema([
    T.Field("i_item_sk", T.INT64),
    T.Field("i_category_id", T.INT32),
    T.Field("i_category", T.STRING),
    T.Field("i_current_price", T.FLOAT64),
])

_CATEGORIES = ["Books", "Children", "Electronics", "Home", "Jewelry",
               "Men", "Music", "Shoes", "Sports", "Women"]


def _zipf_keys(rng, n, lo, hi, a=1.3):
    """Zipf-skewed keys over [lo, hi) — real TPC-DS fact keys are skewed
    (hot items/customers); uniform keys hide collision-heavy paths."""
    z = rng.zipf(a, n)
    return lo + (z - 1) % (hi - lo)


def _with_nulls(rng, values, frac=0.05):
    """~frac nulls (pandas: float + NaN; parquet writes real nulls)."""
    v = values.astype(np.float64)
    v[rng.random(len(v)) < frac] = np.nan
    return v


def generate_tables(tmpdir: str, rows: int = 20_000, seed: int = 7):
    """Write store_sales/date_dim/item parquet; returns (paths, frames).

    Data realism (ref: the reference validates against real TPC-DS data,
    tpcds.yml:122-126): ~5% nulls in every nullable measure column, a
    string dim column (i_category) for LIKE/substr filters, and
    Zipf-skewed fact keys (hot items dominate, as in real sales data).
    """
    import pandas as pd
    import pyarrow.parquet as pq

    rng = np.random.default_rng(seed)
    n_dd, n_item = 730, 400
    ss = pd.DataFrame({
        "ss_sold_date_sk": rng.integers(0, n_dd, rows),
        "ss_item_sk": _zipf_keys(rng, rows, 1, n_item + 1),
        "ss_customer_sk": _with_nulls(
            rng, rng.integers(1, 500, rows), 0.03),
        "ss_store_sk": rng.integers(1, 8, rows),
        "ss_quantity": _with_nulls(
            rng, rng.integers(1, 100, rows), 0.05),
        "ss_sales_price": _with_nulls(
            rng, np.round(rng.random(rows) * 200, 2), 0.05),
        "ss_ext_sales_price": _with_nulls(
            rng, np.round(rng.random(rows) * 1000, 2), 0.05),
    })
    dd = pd.DataFrame({
        "d_date_sk": np.arange(n_dd),
        "d_year": (1998 + np.arange(n_dd) // 365).astype(np.int32),
        "d_moy": ((np.arange(n_dd) // 30) % 12 + 1).astype(np.int32),
    })
    item = pd.DataFrame({
        "i_item_sk": np.arange(1, n_item + 1),
        "i_category_id": rng.integers(1, 11, n_item).astype(np.int32),
        "i_category": [_CATEGORIES[i % len(_CATEGORIES)]
                       for i in range(n_item)],
        "i_current_price": np.round(rng.random(n_item) * 90 + 10, 2),
    })
    schemas = {"store_sales": SS_SCHEMA, "date_dim": DD_SCHEMA,
               "item": ITEM_SCHEMA}
    paths = {}
    for name, df in (("store_sales", ss), ("date_dim", dd), ("item", item)):
        path = f"{tmpdir}/{name}.parquet"
        pq.write_table(_to_arrow_typed(df, schemas[name]), path,
                       row_group_size=65536)
        paths[name] = path
    return paths, {"store_sales": ss, "date_dim": dd, "item": item}


def _to_arrow_typed(df, schema: T.Schema) -> pa.Table:
    """pandas -> arrow with the DECLARED column types: float-with-NaN
    columns become nullable int64/int32 where the schema says integer
    (pandas can't hold null ints natively)."""
    from blaze_tpu_torch.columnar.arrow_io import dtype_to_arrow

    arrays = []
    for f in schema.fields:
        col = df[f.name]
        at = dtype_to_arrow(f.dtype)
        if pa.types.is_integer(at) and col.dtype.kind == "f":
            mask = col.isna().to_numpy()
            vals = np.where(mask, 0, col.to_numpy()).astype(np.int64)
            arrays.append(pa.array(vals, type=at, mask=mask))
        else:
            arrays.append(pa.array(col, type=at))
    return pa.Table.from_arrays(
        arrays, schema=pa.schema(
            [pa.field(f.name, dtype_to_arrow(f.dtype), f.nullable)
             for f in schema.fields]))


# ---------------------------------------------------------------------------
# query catalogue (BASELINE configs 1-5 shapes)
# ---------------------------------------------------------------------------


def _join(left, right, lkeys, rkeys, how, schema, mode, build="right"):
    """BHJ or forced-SMJ — the matrix axis (ref: tpcds.yml runs every query
    with and without autoBroadcastJoinThreshold=-1)."""
    if mode == "bhj":
        return P.bhj(left, P.broadcast_exchange(right), lkeys, rkeys, how,
                     build, schema)
    lx = P.shuffle_exchange(left, lkeys, 4)
    rx = P.shuffle_exchange(right, rkeys, 4)
    return P.smj(lx, rx, lkeys, rkeys, how, schema)


def q1_scan_filter_project(paths, frames, mode):
    """BASELINE config 1: scan + filter + project."""
    sc = P.scan(SS_SCHEMA, [(paths["store_sales"], [])])
    flt = P.filter_(sc, ir.Binary(
        BinOp.AND,
        ir.Binary(BinOp.LE, col("ss_quantity"), lit(50)),
        ir.Binary(BinOp.GT, col("ss_sales_price"), lit(10.0))))
    proj = P.project(
        flt,
        [col("ss_item_sk"),
         ir.Binary(BinOp.MUL, ir.Cast(col("ss_quantity"), T.FLOAT64),
                   col("ss_sales_price"))],
        ["item", "amount"],
        T.Schema([T.Field("item", T.INT64), T.Field("amount", T.FLOAT64)]))
    srt = P.sort(proj, [(col("item"), True, True),
                        (col("amount"), True, True)])

    def oracle():
        import pandas as pd

        ss = frames["store_sales"]
        f = ss[(ss.ss_quantity <= 50) & (ss.ss_sales_price > 10.0)]
        out = pd.DataFrame({
            "item": f.ss_item_sk,
            "amount": f.ss_quantity.astype(np.float64) * f.ss_sales_price})
        return out.sort_values(["item", "amount"]).reset_index(drop=True)

    return srt, oracle


def q2_q06_core_agg(paths, frames, mode):
    """BASELINE config 2: scan + two-phase grouped agg (q06 core)."""
    sc = P.scan(SS_SCHEMA, [(paths["store_sales"], [])])
    flt = P.filter_(sc, ir.Binary(BinOp.GT, col("ss_ext_sales_price"),
                                  lit(100.0)))
    aggs = [{"fn": "sum", "args": [col("ss_ext_sales_price")],
             "dtype": T.FLOAT64, "name": "total"},
            {"fn": "count", "args": [col("ss_ext_sales_price")],
             "dtype": T.INT64, "name": "cnt"},
            {"fn": "avg", "args": [col("ss_sales_price")],
             "dtype": T.FLOAT64, "name": "avg_price"}]
    partial = P.hash_agg(flt, "partial", [col("ss_item_sk")], ["item"],
                         aggs, T.Schema([T.Field("item", T.INT64)]))
    x = P.shuffle_exchange(partial, [col("item")], 4)
    final = P.hash_agg(
        x, "final", [col("ss_item_sk")], ["item"], aggs,
        T.Schema([T.Field("item", T.INT64), T.Field("total", T.FLOAT64),
                  T.Field("cnt", T.INT64), T.Field("avg_price", T.FLOAT64)]))
    srt = P.sort(final, [(col("item"), True, True)])

    def oracle():
        import pandas as pd

        ss = frames["store_sales"]
        f = ss[ss.ss_ext_sales_price > 100.0]
        g = f.groupby("ss_item_sk").agg(
            total=("ss_ext_sales_price", lambda s: s.sum(min_count=1)),
            cnt=("ss_ext_sales_price", "count"),
            avg_price=("ss_sales_price", "mean")).reset_index()
        g = g.rename(columns={"ss_item_sk": "item"})
        return g.sort_values("item").reset_index(drop=True)

    return srt, oracle


def q3_join_agg_sort(paths, frames, mode):
    """BASELINE config 3: q03 — ss x date_dim, grouped sum, sort desc."""
    ss = P.scan(SS_SCHEMA, [(paths["store_sales"], [])])
    dd = P.scan(DD_SCHEMA, [(paths["date_dim"], [])])
    ddf = P.filter_(dd, ir.Binary(BinOp.EQ, col("d_moy"), lit(11)))
    jschema = T.Schema(list(SS_SCHEMA.fields) + list(DD_SCHEMA.fields))
    j = _join(ss, ddf, [col("ss_sold_date_sk")], [col("d_date_sk")],
              "inner", jschema, mode)
    aggs = [{"fn": "sum", "args": [col("ss_ext_sales_price")],
             "dtype": T.FLOAT64, "name": "sumsales"}]
    partial = P.hash_agg(j, "partial",
                         [col("ss_item_sk"), col("d_year")],
                         ["item", "year"], aggs,
                         T.Schema([T.Field("item", T.INT64),
                                   T.Field("year", T.INT32)]))
    x = P.shuffle_exchange(partial, [col("item")], 4)
    final = P.hash_agg(
        x, "final", [col("ss_item_sk"), col("d_year")], ["item", "year"],
        aggs, T.Schema([T.Field("item", T.INT64), T.Field("year", T.INT32),
                        T.Field("sumsales", T.FLOAT64)]))
    srt = P.sort(final, [(col("sumsales"), False, True),
                         (col("item"), True, True)])

    def oracle():
        import pandas as pd

        ssd, ddd = frames["store_sales"], frames["date_dim"]
        m = ssd.merge(ddd[ddd.d_moy == 11], left_on="ss_sold_date_sk",
                      right_on="d_date_sk")
        g = m.groupby(["ss_item_sk", "d_year"])["ss_ext_sales_price"].agg(
            lambda s: s.sum(min_count=1)).reset_index()
        g.columns = ["item", "year", "sumsales"]
        # nulls-first to match the plan's (desc, nulls_first) spec
        return g.sort_values(["sumsales", "item"],
                             ascending=[False, True],
                             na_position="first").reset_index(drop=True)

    return srt, oracle


def q4_repartition_sort(paths, frames, mode):
    """BASELINE config 4: repartition across 8 + per-partition sort +
    global order (q01 WITH-clause shape)."""
    sc = P.scan(SS_SCHEMA, [(paths["store_sales"], [])])
    proj = P.project(
        sc, [col("ss_customer_sk"), col("ss_store_sk"),
             col("ss_ext_sales_price")],
        ["customer", "store", "price"],
        T.Schema([T.Field("customer", T.INT64), T.Field("store", T.INT64),
                  T.Field("price", T.FLOAT64)]))
    x = P.shuffle_exchange(proj, [col("customer")], 8)
    srt = P.sort(x, [(col("customer"), True, True),
                     (col("store"), True, True),
                     (col("price"), False, True)])

    def oracle():
        import pandas as pd

        ss = frames["store_sales"]
        out = pd.DataFrame({"customer": ss.ss_customer_sk,
                            "store": ss.ss_store_sk,
                            "price": ss.ss_ext_sales_price})
        return out.sort_values(["customer", "store", "price"],
                               ascending=[True, True, False],
                               na_position="first"
                               ).reset_index(drop=True)

    return srt, oracle


def q5_multijoin_limit(paths, frames, mode):
    """BASELINE config 5 (lite): 3-table multi-stage — ss x dd x item,
    grouped agg, sort, limit."""
    ss = P.scan(SS_SCHEMA, [(paths["store_sales"], [])])
    dd = P.scan(DD_SCHEMA, [(paths["date_dim"], [])])
    it = P.scan(ITEM_SCHEMA, [(paths["item"], [])])
    ddf = P.filter_(dd, ir.Binary(BinOp.EQ, col("d_year"), lit(1998)))
    j1s = T.Schema(list(SS_SCHEMA.fields) + list(DD_SCHEMA.fields))
    j1 = _join(ss, ddf, [col("ss_sold_date_sk")], [col("d_date_sk")],
               "inner", j1s, mode)
    j2s = T.Schema(list(j1s.fields) + list(ITEM_SCHEMA.fields))
    j2 = _join(j1, it, [col("ss_item_sk")], [col("i_item_sk")],
               "inner", j2s, mode)
    aggs = [{"fn": "sum", "args": [col("ss_ext_sales_price")],
             "dtype": T.FLOAT64, "name": "rev"},
            {"fn": "count", "args": [col("ss_item_sk")],
             "dtype": T.INT64, "name": "n"}]
    partial = P.hash_agg(j2, "partial", [col("i_category_id")], ["cat"],
                         aggs, T.Schema([T.Field("cat", T.INT32)]))
    x = P.shuffle_exchange(partial, [col("cat")], 4)
    final = P.hash_agg(
        x, "final", [col("i_category_id")], ["cat"], aggs,
        T.Schema([T.Field("cat", T.INT32), T.Field("rev", T.FLOAT64),
                  T.Field("n", T.INT64)]))
    srt = P.sort(final, [(col("rev"), False, True)])
    lim = P.limit(srt, 5, True)

    def oracle():
        import pandas as pd

        ssd, ddd, itd = (frames["store_sales"], frames["date_dim"],
                         frames["item"])
        m = ssd.merge(ddd[ddd.d_year == 1998], left_on="ss_sold_date_sk",
                      right_on="d_date_sk")
        m = m.merge(itd, left_on="ss_item_sk", right_on="i_item_sk")
        g = m.groupby("i_category_id").agg(
            rev=("ss_ext_sales_price", lambda s: s.sum(min_count=1)),
            n=("ss_item_sk", "count")).reset_index()
        g.columns = ["cat", "rev", "n"]
        return g.sort_values("rev", ascending=False,
                             na_position="first").head(5).reset_index(
            drop=True)

    return lim, oracle


def q6_semi_join(paths, frames, mode):
    """LEFT SEMI over a filtered dimension (EXISTS subquery shape)."""
    ss = P.scan(SS_SCHEMA, [(paths["store_sales"], [])])
    dd = P.scan(DD_SCHEMA, [(paths["date_dim"], [])])
    ddf = P.filter_(dd, ir.Binary(BinOp.EQ, col("d_moy"), lit(12)))
    j = _join(ss, ddf, [col("ss_sold_date_sk")], [col("d_date_sk")],
              "left_semi", SS_SCHEMA, mode)
    aggs = [{"fn": "count", "args": [col("ss_item_sk")],
             "dtype": T.INT64, "name": "n"}]
    partial = P.hash_agg(j, "partial", [col("ss_store_sk")], ["store"],
                         aggs, T.Schema([T.Field("store", T.INT64)]))
    x = P.shuffle_exchange(partial, [col("store")], 4)
    final = P.hash_agg(x, "final", [col("ss_store_sk")], ["store"], aggs,
                       T.Schema([T.Field("store", T.INT64),
                                 T.Field("n", T.INT64)]))
    srt = P.sort(final, [(col("store"), True, True)])

    def oracle():
        import pandas as pd

        ssd, ddd = frames["store_sales"], frames["date_dim"]
        keys = set(ddd[ddd.d_moy == 12].d_date_sk)
        f = ssd[ssd.ss_sold_date_sk.isin(keys)]
        g = f.groupby("ss_store_sk")["ss_item_sk"].count().reset_index()
        g.columns = ["store", "n"]
        return g.sort_values("store").reset_index(drop=True)

    return srt, oracle


def q7_left_outer_join(paths, frames, mode):
    """LEFT OUTER item x sales counts (null-extension correctness)."""
    it = P.scan(ITEM_SCHEMA, [(paths["item"], [])])
    ss = P.scan(SS_SCHEMA, [(paths["store_sales"], [])])
    ssf = P.filter_(ss, ir.Binary(BinOp.GT, col("ss_ext_sales_price"),
                                  lit(950.0)))
    jschema = T.Schema(list(ITEM_SCHEMA.fields) + list(SS_SCHEMA.fields))
    j = _join(it, ssf, [col("i_item_sk")], [col("ss_item_sk")], "left",
              jschema, mode)
    aggs = [{"fn": "count", "args": [col("ss_item_sk")],
             "dtype": T.INT64, "name": "n"}]
    partial = P.hash_agg(j, "partial", [col("i_item_sk")], ["item"],
                         aggs, T.Schema([T.Field("item", T.INT64)]))
    x = P.shuffle_exchange(partial, [col("item")], 4)
    final = P.hash_agg(x, "final", [col("i_item_sk")], ["item"], aggs,
                       T.Schema([T.Field("item", T.INT64),
                                 T.Field("n", T.INT64)]))
    srt = P.sort(final, [(col("item"), True, True)])

    def oracle():
        import pandas as pd

        itd, ssd = frames["item"], frames["store_sales"]
        f = ssd[ssd.ss_ext_sales_price > 950.0]
        m = itd.merge(f, left_on="i_item_sk", right_on="ss_item_sk",
                      how="left")
        g = m.groupby("i_item_sk")["ss_item_sk"].count().reset_index()
        g.columns = ["item", "n"]
        return g.sort_values("item").reset_index(drop=True)

    return srt, oracle


def q8_category_like(paths, frames, mode):
    """String dim predicate: i_category LIKE 'S%' through the join, count
    + revenue by category (STRING group key end-to-end)."""
    ss = P.scan(SS_SCHEMA, [(paths["store_sales"], [])])
    it = P.scan(ITEM_SCHEMA, [(paths["item"], [])])
    itf = P.filter_(it, ir.Like(col("i_category"), b"S%"))
    jschema = T.Schema(list(SS_SCHEMA.fields) + list(ITEM_SCHEMA.fields))
    j = _join(ss, itf, [col("ss_item_sk")], [col("i_item_sk")], "inner",
              jschema, mode)
    aggs = [{"fn": "count", "args": [col("ss_item_sk")],
             "dtype": T.INT64, "name": "n"},
            {"fn": "sum", "args": [col("ss_ext_sales_price")],
             "dtype": T.FLOAT64, "name": "rev"}]
    partial = P.hash_agg(j, "partial", [col("i_category")], ["category"],
                         aggs, T.Schema([T.Field("category", T.STRING)]))
    x = P.shuffle_exchange(partial, [col("category")], 4)
    final = P.hash_agg(
        x, "final", [col("i_category")], ["category"], aggs,
        T.Schema([T.Field("category", T.STRING), T.Field("n", T.INT64),
                  T.Field("rev", T.FLOAT64)]))
    srt = P.sort(final, [(col("category"), True, True)])

    def oracle():
        import pandas as pd

        ssd, itd = frames["store_sales"], frames["item"]
        f = itd[itd.i_category.str.startswith("S")]
        m = ssd.merge(f, left_on="ss_item_sk", right_on="i_item_sk")
        g = m.groupby("i_category").agg(
            n=("ss_item_sk", "count"),
            rev=("ss_ext_sales_price",
                 lambda s: s.sum(min_count=1))).reset_index()
        g.columns = ["category", "n", "rev"]
        return g.sort_values("category").reset_index(drop=True)

    return srt, oracle


def q9_substr_group(paths, frames, mode):
    """substr(i_category, 1, 3) as a computed STRING group key (the
    LIKE/substr axis of real TPC-DS string processing, e.g. q08's
    substr(ca_zip,1,5))."""
    ss = P.scan(SS_SCHEMA, [(paths["store_sales"], [])])
    it = P.scan(ITEM_SCHEMA, [(paths["item"], [])])
    jschema = T.Schema(list(SS_SCHEMA.fields) + list(ITEM_SCHEMA.fields))
    j = _join(ss, it, [col("ss_item_sk")], [col("i_item_sk")], "inner",
              jschema, mode)
    pschema = T.Schema([T.Field("cat3", T.STRING),
                        T.Field("qty", T.FLOAT64)])
    proj = P.project(
        j,
        [ir.ScalarFn("substring",
                     (col("i_category"), lit(1), lit(3)), T.STRING),
         ir.Cast(col("ss_quantity"), T.FLOAT64)],
        ["cat3", "qty"], pschema)
    aggs = [{"fn": "count", "args": [col("cat3")],
             "dtype": T.INT64, "name": "n"},
            {"fn": "avg", "args": [col("qty")],
             "dtype": T.FLOAT64, "name": "avg_qty"}]
    partial = P.hash_agg(proj, "partial", [col("cat3")], ["cat3"], aggs,
                         T.Schema([T.Field("cat3", T.STRING)]))
    x = P.shuffle_exchange(partial, [col("cat3")], 4)
    final = P.hash_agg(
        x, "final", [col("cat3")], ["cat3"], aggs,
        T.Schema([T.Field("cat3", T.STRING), T.Field("n", T.INT64),
                  T.Field("avg_qty", T.FLOAT64)]))
    srt = P.sort(final, [(col("cat3"), True, True)])

    def oracle():
        import pandas as pd

        ssd, itd = frames["store_sales"], frames["item"]
        m = ssd.merge(itd, left_on="ss_item_sk", right_on="i_item_sk")
        m = m.assign(cat3=m.i_category.str[:3])
        g = m.groupby("cat3").agg(
            n=("cat3", "count"),
            avg_qty=("ss_quantity", "mean")).reset_index()
        return g.sort_values("cat3").reset_index(drop=True)

    return srt, oracle


QUERIES: Dict[str, Callable] = {
    "q1_scan_filter_project": q1_scan_filter_project,
    "q2_q06_core_agg": q2_q06_core_agg,
    "q3_join_agg_sort": q3_join_agg_sort,
    "q4_repartition_sort": q4_repartition_sort,
    "q5_multijoin_limit": q5_multijoin_limit,
    "q6_semi_join": q6_semi_join,
    "q7_left_outer_join": q7_left_outer_join,
    "q8_category_like": q8_category_like,
    "q9_substr_group": q9_substr_group,
}

# join-less queries run once (the axis changes nothing)
_JOINLESS = {"q1_scan_filter_project", "q2_q06_core_agg",
             "q4_repartition_sort"}


# ---------------------------------------------------------------------------
# runner
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Result:
    query: str
    mode: str
    ok: bool
    seconds: float
    error: Optional[str] = None
    diff: Optional[str] = None
    spill_count: int = 0
    spilled_bytes: int = 0


def _compare(got, want) -> Optional[str]:
    if len(got) != len(want):
        return f"row count {len(got)} != {len(want)}"
    for c in want.columns:
        if c not in got.columns:
            return f"missing column {c}"
        g = got[c].to_numpy()
        w = want[c].to_numpy()
        if _is_stringy(w):
            gs = np.array([x.decode() if isinstance(x, bytes) else x
                           for x in g], object)
            bad = gs != w.astype(object)
        elif w.dtype.kind == "f" or g.dtype.kind == "f" or \
                w.dtype.kind == "O" or g.dtype.kind == "O":
            # None/NaN-bearing numerics: object->float maps None to nan
            bad = ~np.isclose(_as_f64(g), _as_f64(w),
                              rtol=1e-6, equal_nan=True)
        else:
            bad = g.astype(np.int64) != w.astype(np.int64)
        if bad.any():
            i = int(np.argmax(bad))
            return (f"column {c}: {int(bad.sum())} mismatches, first at row "
                    f"{i}: got={g[i]} want={w[i]}")
    return None


def _is_stringy(w: np.ndarray) -> bool:
    if w.dtype.kind in ("U", "S"):
        return True
    if w.dtype.kind == "O":
        for x in w:
            if x is None:
                continue
            return isinstance(x, (str, bytes))
    return False


def _as_f64(a: np.ndarray) -> np.ndarray:
    if a.dtype.kind == "O":
        return np.array([np.nan if x is None else float(x) for x in a],
                        np.float64)
    return a.astype(np.float64)


def _to_pandas(batch):
    import pandas as pd

    d = batch.to_numpy()
    return pd.DataFrame({k: list(v) for k, v in d.items()})


def run_matrix(tmpdir: str, rows: int = 20_000,
               queries: Optional[List[str]] = None,
               spill_budget: Optional[int] = None,
               suite: str = "core",
               device: DeviceLike = None) -> List[Result]:
    """spill_budget: when set, MemManager is (re)initialized to this many
    bytes before every cell so sort/agg/shuffle spill fires IN QUERY
    CONTEXT (the reference fuzz-gates a 1.23M-row external sort under
    MemManager::init(10000), sort_exec.rs:954) — each Result then records
    the spill counters the run produced.

    suite: "core" = the BASELINE config shapes in this module;
    "tpcds" = the hand-constructed TPC-DS q01-q10 catalogue
    (spark/tpcds.py, the north-star queries).

    device: where every query runs (None: the CUDA card)."""
    from blaze_tpu_torch.runtime import memory as M

    if suite == "tpcds":
        from blaze_tpu_torch.spark import tpcds

        paths, frames = tpcds.generate_tables(tmpdir, rows=rows)
        catalogue, joinless = tpcds.QUERIES, tpcds.JOINLESS
    else:
        paths, frames = generate_tables(tmpdir, rows=rows)
        catalogue, joinless = QUERIES, _JOINLESS
    results: List[Result] = []
    for name, build in catalogue.items():
        if queries and name not in queries:
            continue
        modes = ["bhj"] if name in joinless else ["bhj", "smj"]
        for mode in modes:
            t0 = time.time()
            mgr = M.init(spill_budget) if spill_budget else M.get_manager()
            # deltas, not totals: without spill_budget the SHARED global
            # manager carries counts from earlier cells/process activity
            sc0, sb0 = mgr.spill_count, mgr.spilled_bytes
            try:
                plan, oracle = build(paths, frames, mode)
                out = run_plan(plan, num_partitions=4, device=device)
                got = _to_pandas(out)
                want = oracle()
                # order-insensitive where the plan has no global sort tail
                diff = _compare(got.reset_index(drop=True),
                                want.reset_index(drop=True))
                results.append(Result(name, mode, diff is None,
                                      time.time() - t0, diff=diff,
                                      spill_count=mgr.spill_count - sc0,
                                      spilled_bytes=mgr.spilled_bytes
                                      - sb0))
            except Exception:
                results.append(Result(name, mode, False, time.time() - t0,
                                      error=traceback.format_exc(limit=8),
                                      spill_count=mgr.spill_count - sc0,
                                      spilled_bytes=mgr.spilled_bytes
                                      - sb0))
            r = results[-1]
            # incremental progress: long matrices run under timeouts in
            # background shells — per-cell lines must not be lost to a
            # buffered final report
            print(f"[cell] {r.query} {r.mode} "
                  f"{'PASS' if r.ok else 'FAIL'} {r.seconds:.1f}s "
                  f"spills={r.spill_count}", flush=True)
    return results


def print_report(results: List[Result]) -> bool:
    ok = True
    show_spill = any(r.spill_count for r in results)
    hdr = f"{'query':34s} {'join':5s} {'status':8s} {'sec':>6s}"
    print(hdr + ("  spills  spill_mb" if show_spill else ""))
    for r in results:
        status = "PASS" if r.ok else "FAIL"
        ok = ok and r.ok
        line = f"{r.query:34s} {r.mode:5s} {status:8s} {r.seconds:6.1f}"
        if show_spill:
            line += f"  {r.spill_count:6d}  {r.spilled_bytes / 1e6:8.1f}"
        print(line)
        if r.diff:
            print(f"    diff: {r.diff}")
        if r.error:
            print("    " + r.error.replace("\n", "\n    "))
    n_pass = sum(1 for r in results if r.ok)
    print(f"\n{n_pass}/{len(results)} passed")
    return ok


def main(argv=None) -> int:
    """validate.py's arguments, plus --device (default: the CUDA card)."""
    import argparse
    import json
    import os
    import tempfile

    ap = argparse.ArgumentParser(
        prog="python -m blaze_tpu_torch.spark.validator")
    ap.add_argument("--rows", type=int, default=20_000,
                    help="store_sales row count")
    ap.add_argument("--queries", type=str, default="",
                    help="comma-separated subset of query names")
    ap.add_argument("--spill-budget", type=int, default=0,
                    help="force-spill mode: MemManager byte budget per cell")
    ap.add_argument("--json-out", type=str, default="",
                    help="also write the per-cell results as JSON")
    ap.add_argument("--suite", type=str, default="core",
                    choices=["core", "tpcds", "all"],
                    help="core = BASELINE config shapes; tpcds = the "
                    "hand-constructed TPC-DS q01-q10 catalogue")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device to run on (default: the CUDA card)")
    args = ap.parse_args(argv)

    queries = [q for q in args.queries.split(",") if q] or None
    suites = (["core", "tpcds"] if args.suite == "all" else [args.suite])
    results = []
    with tempfile.TemporaryDirectory(
            prefix="blaze_tpu_torch_validate_") as tmp:
        for suite in suites:
            os.makedirs(f"{tmp}/{suite}", exist_ok=True)
            results += run_matrix(f"{tmp}/{suite}", rows=args.rows,
                                  queries=queries,
                                  spill_budget=args.spill_budget or None,
                                  suite=suite, device=args.device)
    ok = print_report(results)
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump({"rows": args.rows, "device": args.device,
                       "spill_budget": args.spill_budget,
                       "results": [dataclasses.asdict(r) for r in results]},
                      f, indent=1)
    if args.spill_budget and ok and not any(r.spill_count for r in results):
        print("FORCE-SPILL MODE: no spill observed — budget too large?")
        return 1
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
