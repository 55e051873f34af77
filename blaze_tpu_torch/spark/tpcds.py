"""TPC-DS q01-q10 catalogue: the BASELINE.json north-star queries as
plan shapes + pandas oracles.

Port of blaze_tpu/spark/tpcds.py: the same schemas, tables and query
functions, each making the same plan tree as the JAX package's. pandas is
imported inside `generate_tables` and the oracles only, so the plans can
be made where pandas is not installed.

Ref: the reference's correctness gate runs the real TPC-DS queries
against a generated dataset and diffs plugin-on vs plugin-off answers
(dev/run-tpcds-test:52-57, .github/workflows/tpcds.yml:92-147);
BASELINE.json names q01-q10 specifically. This module hand-constructs
each query's physical-plan SHAPE — the actual joins over
store_returns/customer/customer_address/date_dim, CASE-filtered
aggregates, correlated-subquery-as-join rewrites (what Catalyst itself
produces), rollup via Expand, EXISTS via semi/existence joins — over
generated tables carrying the columns those queries touch, with pandas
oracles, runnable at 2M+ fact rows in BOTH join modes.

Simplifications (documented per query): surrogate-key domains are
scaled-down, and q02/q04/q05 use two sales channels instead of three —
the plan OPERATOR structure (union / self-join lattice / rollup) is
preserved; only the fan-in width shrinks.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np

from blaze_tpu_torch.columnar import types as T
from blaze_tpu_torch.exprs import ir
from blaze_tpu_torch.exprs.ir import BinOp, col, lit
from blaze_tpu_torch.spark import plan_model as P

# ---------------------------------------------------------------------------
# schemas
# ---------------------------------------------------------------------------

SS = T.Schema([
    T.Field("ss_sold_date_sk", T.INT64),
    T.Field("ss_item_sk", T.INT64),
    T.Field("ss_customer_sk", T.INT64),
    T.Field("ss_cdemo_sk", T.INT64),
    T.Field("ss_store_sk", T.INT64),
    T.Field("ss_promo_sk", T.INT64),
    T.Field("ss_quantity", T.INT32),
    T.Field("ss_list_price", T.FLOAT64),
    T.Field("ss_sales_price", T.FLOAT64),
    T.Field("ss_coupon_amt", T.FLOAT64),
    T.Field("ss_ext_sales_price", T.FLOAT64),
    T.Field("ss_net_profit", T.FLOAT64),
])
SR = T.Schema([
    T.Field("sr_returned_date_sk", T.INT64),
    T.Field("sr_customer_sk", T.INT64),
    T.Field("sr_store_sk", T.INT64),
    T.Field("sr_return_amt", T.FLOAT64),
])
DD = T.Schema([
    T.Field("d_date_sk", T.INT64),
    T.Field("d_year", T.INT32),
    T.Field("d_moy", T.INT32),
    T.Field("d_qoy", T.INT32),
])
STORE = T.Schema([
    T.Field("s_store_sk", T.INT64),
    T.Field("s_store_name", T.STRING),
    T.Field("s_state", T.STRING),
    T.Field("s_zip", T.STRING),
])
ITEM = T.Schema([
    T.Field("i_item_sk", T.INT64),
    T.Field("i_item_id", T.STRING),
    T.Field("i_brand_id", T.INT32),
    T.Field("i_brand", T.STRING),
    T.Field("i_manufact_id", T.INT32),
    T.Field("i_category", T.STRING),
    T.Field("i_current_price", T.FLOAT64),
])
CUST = T.Schema([
    T.Field("c_customer_sk", T.INT64),
    T.Field("c_customer_id", T.STRING),
    T.Field("c_current_addr_sk", T.INT64),
    T.Field("c_current_cdemo_sk", T.INT64),
])
CA = T.Schema([
    T.Field("ca_address_sk", T.INT64),
    T.Field("ca_state", T.STRING),
    T.Field("ca_zip", T.STRING),
])
CD = T.Schema([
    T.Field("cd_demo_sk", T.INT64),
    T.Field("cd_gender", T.STRING),
    T.Field("cd_marital_status", T.STRING),
    T.Field("cd_education_status", T.STRING),
])
PROMO = T.Schema([
    T.Field("p_promo_sk", T.INT64),
    T.Field("p_channel_email", T.STRING),
    T.Field("p_channel_event", T.STRING),
])
WS = T.Schema([
    T.Field("ws_sold_date_sk", T.INT64),
    T.Field("ws_bill_customer_sk", T.INT64),
    T.Field("ws_ext_sales_price", T.FLOAT64),
])
CS = T.Schema([
    T.Field("cs_sold_date_sk", T.INT64),
    T.Field("cs_ship_customer_sk", T.INT64),
    T.Field("cs_ext_sales_price", T.FLOAT64),
])

_STATES = ["TN", "GA", "SC", "AL", "KY", "VA", "OH", "TX"]
_CATS = ["Books", "Children", "Electronics", "Home", "Jewelry",
         "Men", "Music", "Shoes", "Sports", "Women"]


def _nulls(rng, v, frac):
    v = v.astype(np.float64)
    v[rng.random(len(v)) < frac] = np.nan
    return v


def generate_tables(tmpdir: str, rows: int = 20_000, seed: int = 11):
    """All ten tables; `rows` sizes store_sales (other tables scale)."""
    import pandas as pd
    import pyarrow.parquet as pq

    rng = np.random.default_rng(seed)
    n_dd, n_item, n_store = 1461, 600, 12  # 4 years of dates
    n_cust, n_ca, n_cd, n_promo = max(rows // 40, 500), \
        max(rows // 50, 400), 360, 30

    def zipf(n, lo, hi, a=1.25):
        z = rng.zipf(a, n)
        return lo + (z - 1) % (hi - lo)

    ss = pd.DataFrame({
        "ss_sold_date_sk": rng.integers(0, n_dd, rows),
        "ss_item_sk": zipf(rows, 1, n_item + 1),
        "ss_customer_sk": _nulls(rng, rng.integers(1, n_cust + 1, rows),
                                 0.02),
        "ss_cdemo_sk": rng.integers(1, n_cd + 1, rows),
        "ss_store_sk": rng.integers(1, n_store + 1, rows),
        "ss_promo_sk": rng.integers(1, n_promo + 1, rows),
        "ss_quantity": _nulls(rng, rng.integers(1, 101, rows), 0.04),
        "ss_list_price": _nulls(rng, np.round(rng.random(rows) * 250, 2),
                                0.04),
        "ss_sales_price": _nulls(rng, np.round(rng.random(rows) * 200, 2),
                                 0.04),
        "ss_coupon_amt": _nulls(rng, np.round(rng.random(rows) * 40, 2),
                                0.04),
        "ss_ext_sales_price": _nulls(
            rng, np.round(rng.random(rows) * 1000, 2), 0.04),
        "ss_net_profit": _nulls(rng, np.round(rng.random(rows) * 400 - 100,
                                              2), 0.04),
    })
    n_sr = max(rows // 10, 1000)
    sr = pd.DataFrame({
        "sr_returned_date_sk": rng.integers(0, n_dd, n_sr),
        "sr_customer_sk": rng.integers(1, n_cust + 1, n_sr),
        "sr_store_sk": rng.integers(1, n_store + 1, n_sr),
        "sr_return_amt": _nulls(rng, np.round(rng.random(n_sr) * 300, 2),
                                0.04),
    })
    dd = pd.DataFrame({
        "d_date_sk": np.arange(n_dd),
        "d_year": (1998 + np.arange(n_dd) // 365).astype(np.int32),
        "d_moy": ((np.arange(n_dd) // 30) % 12 + 1).astype(np.int32),
        "d_qoy": (((np.arange(n_dd) // 30) % 12) // 3 + 1).astype(np.int32),
    })
    store = pd.DataFrame({
        "s_store_sk": np.arange(1, n_store + 1),
        "s_store_name": [f"Store#{i}" for i in range(1, n_store + 1)],
        "s_state": [_STATES[i % 4] for i in range(n_store)],
        "s_zip": [f"{35000 + 137 * i % 65000:05d}" for i in range(n_store)],
    })
    item = pd.DataFrame({
        "i_item_sk": np.arange(1, n_item + 1),
        "i_item_id": [f"ITEM{i:08d}" for i in range(1, n_item + 1)],
        "i_brand_id": (np.arange(n_item) % 50 + 1).astype(np.int32),
        "i_brand": [f"Brand#{i % 50 + 1}" for i in range(n_item)],
        "i_manufact_id": (np.arange(n_item) % 100 + 1).astype(np.int32),
        "i_category": [_CATS[i % len(_CATS)] for i in range(n_item)],
        "i_current_price": np.round(rng.random(n_item) * 95 + 5, 2),
    })
    cust = pd.DataFrame({
        "c_customer_sk": np.arange(1, n_cust + 1),
        "c_customer_id": [f"AAAA{i:012d}" for i in range(1, n_cust + 1)],
        "c_current_addr_sk": rng.integers(1, n_ca + 1, n_cust),
        "c_current_cdemo_sk": rng.integers(1, n_cd + 1, n_cust),
    })
    ca = pd.DataFrame({
        "ca_address_sk": np.arange(1, n_ca + 1),
        "ca_state": [_STATES[i % len(_STATES)] for i in range(n_ca)],
        "ca_zip": [f"{35000 + 61 * i % 65000:05d}" for i in range(n_ca)],
    })
    cd = pd.DataFrame({
        "cd_demo_sk": np.arange(1, n_cd + 1),
        "cd_gender": ["M" if i % 2 else "F" for i in range(n_cd)],
        "cd_marital_status": ["SMDWU"[i % 5] for i in range(n_cd)],
        "cd_education_status": [
            ["Primary", "Secondary", "College", "2 yr Degree",
             "4 yr Degree", "Advanced Degree"][i % 6] for i in range(n_cd)],
    })
    promo = pd.DataFrame({
        "p_promo_sk": np.arange(1, n_promo + 1),
        "p_channel_email": ["N" if i % 3 else "Y" for i in range(n_promo)],
        "p_channel_event": ["N" if i % 2 else "Y" for i in range(n_promo)],
    })
    n_w = max(rows // 8, 1000)
    ws = pd.DataFrame({
        "ws_sold_date_sk": rng.integers(0, n_dd, n_w),
        "ws_bill_customer_sk": rng.integers(1, n_cust + 1, n_w),
        "ws_ext_sales_price": _nulls(rng, np.round(rng.random(n_w) * 900,
                                                   2), 0.04),
    })
    cs = pd.DataFrame({
        "cs_sold_date_sk": rng.integers(0, n_dd, n_w),
        "cs_ship_customer_sk": rng.integers(1, n_cust + 1, n_w),
        "cs_ext_sales_price": _nulls(rng, np.round(rng.random(n_w) * 900,
                                                   2), 0.04),
    })

    from blaze_tpu_torch.spark.validator import _to_arrow_typed

    schemas = {"store_sales": SS, "store_returns": SR, "date_dim": DD,
               "store": STORE, "item": ITEM, "customer": CUST,
               "customer_address": CA, "customer_demographics": CD,
               "promotion": PROMO, "web_sales": WS, "catalog_sales": CS}
    frames = {"store_sales": ss, "store_returns": sr, "date_dim": dd,
              "store": store, "item": item, "customer": cust,
              "customer_address": ca, "customer_demographics": cd,
              "promotion": promo, "web_sales": ws, "catalog_sales": cs}
    paths = {}
    for name, df in frames.items():
        path = f"{tmpdir}/{name}.parquet"
        pq.write_table(_to_arrow_typed(df, schemas[name]), path,
                       row_group_size=65536)
        paths[name] = path
    return paths, frames


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _join(left, right, lkeys, rkeys, how, schema, mode, build="right"):
    if mode == "bhj":
        return P.bhj(left, P.broadcast_exchange(right), lkeys, rkeys, how,
                     build, schema)
    lx = P.shuffle_exchange(left, lkeys, 4)
    rx = P.shuffle_exchange(right, rkeys, 4)
    return P.smj(lx, rx, lkeys, rkeys, how, schema)


def _fields(*schemas):
    out = []
    for s in schemas:
        out.extend(s.fields)
    return out


def _two_phase_agg(child, keys, key_names, aggs, key_fields, mode_cols=4):
    """partial -> exchange -> final (the physical shape Catalyst emits)."""
    out_fields = list(key_fields) + [
        T.Field(a["name"], a["dtype"]) for a in aggs]
    partial = P.hash_agg(child, "partial", keys, key_names, aggs,
                         T.Schema(key_fields))
    # the exchange reads the PARTIAL's output schema (renamed key cols)
    x = P.shuffle_exchange(partial, [col(n) for n in key_names],
                           mode_cols)
    return P.hash_agg(x, "final", keys, key_names, aggs,
                      T.Schema(out_fields))


def _sum(c, name, dtype=T.FLOAT64):
    return {"fn": "sum", "args": [col(c)], "dtype": dtype, "name": name}


def _cnt(c, name):
    return {"fn": "count", "args": [col(c)], "dtype": T.INT64, "name": name}


def _avg(c, name):
    return {"fn": "avg", "args": [col(c)], "dtype": T.FLOAT64, "name": name}


def _psum(s, col_, min_count=1):
    return s[col_].sum(min_count=min_count)


# ---------------------------------------------------------------------------
# q01 — store_returns above 1.2x the store average (correlated subquery
# rewritten as agg + self-join, the plan Catalyst produces)
# ---------------------------------------------------------------------------

def q01(paths, frames, mode):
    sr = P.scan(SR, [(paths["store_returns"], [])])
    dd = P.scan(DD, [(paths["date_dim"], [])])
    ddf = P.filter_(dd, ir.Binary(BinOp.EQ, col("d_year"), lit(2000)))
    j = _join(sr, ddf, [col("sr_returned_date_sk")], [col("d_date_sk")],
              "inner", T.Schema(_fields(SR, DD)), mode)
    ctr_fields = [T.Field("ctr_customer_sk", T.INT64),
                  T.Field("ctr_store_sk", T.INT64)]
    ctr = _two_phase_agg(
        j, [col("sr_customer_sk"), col("sr_store_sk")],
        ["ctr_customer_sk", "ctr_store_sk"],
        [_sum("sr_return_amt", "ctr_total_return")], ctr_fields)
    # per-store avg of customer totals (the correlated subquery)
    avg_fields = [T.Field("avg_store_sk", T.INT64)]
    # rename ctr columns for the self-join's right side
    ctr_r = P.project(
        ctr, [col("ctr_store_sk"), col("ctr_total_return")],
        ["avg_store_sk", "avg_input"],
        T.Schema([T.Field("avg_store_sk", T.INT64),
                  T.Field("avg_input", T.FLOAT64)]))
    store_avg = _two_phase_agg(
        ctr_r, [col("avg_store_sk")], ["avg_store_sk"],
        [_avg("avg_input", "avg_return")], avg_fields)
    j2_schema = T.Schema([T.Field("ctr_customer_sk", T.INT64),
                          T.Field("ctr_store_sk", T.INT64),
                          T.Field("ctr_total_return", T.FLOAT64),
                          T.Field("avg_store_sk", T.INT64),
                          T.Field("avg_return", T.FLOAT64)])
    j2 = _join(ctr, store_avg, [col("ctr_store_sk")], [col("avg_store_sk")],
               "inner", j2_schema, mode)
    f = P.filter_(j2, ir.Binary(
        BinOp.GT, col("ctr_total_return"),
        ir.Binary(BinOp.MUL, col("avg_return"), lit(1.2))))
    st = P.scan(STORE, [(paths["store"], [])])
    stf = P.filter_(st, ir.Binary(BinOp.EQ, col("s_state"), lit("TN")))
    j3 = _join(f, stf, [col("ctr_store_sk")], [col("s_store_sk")], "inner",
               T.Schema(list(j2_schema.fields) + list(STORE.fields)), mode)
    cust = P.scan(CUST, [(paths["customer"], [])])
    j4 = _join(j3, cust, [col("ctr_customer_sk")], [col("c_customer_sk")],
               "inner",
               T.Schema(list(j3.schema.fields) + list(CUST.fields)), mode)
    proj = P.project(j4, [col("c_customer_id")], ["c_customer_id"],
                     T.Schema([T.Field("c_customer_id", T.STRING)]))
    srt = P.sort(proj, [(col("c_customer_id"), True, True)])
    out = P.limit(srt, 100, True)

    def oracle():
        import pandas as pd

        srd, ddd = frames["store_returns"], frames["date_dim"]
        m = srd.merge(ddd[ddd.d_year == 2000], left_on="sr_returned_date_sk",
                      right_on="d_date_sk")
        ctr = m.groupby(["sr_customer_sk", "sr_store_sk"])[
            "sr_return_amt"].agg(lambda s: s.sum(min_count=1)).reset_index()
        ctr.columns = ["cust", "store", "total"]
        avg = ctr.groupby("store")["total"].mean().reset_index()
        avg.columns = ["store", "avg_return"]
        m2 = ctr.merge(avg, on="store")
        m2 = m2[m2.total > 1.2 * m2.avg_return]
        st = frames["store"]
        m3 = m2.merge(st[st.s_state == "TN"], left_on="store",
                      right_on="s_store_sk")
        m4 = m3.merge(frames["customer"], left_on="cust",
                      right_on="c_customer_sk")
        out = m4[["c_customer_id"]].sort_values("c_customer_id")
        return out.head(100).reset_index(drop=True)

    return out, oracle


# ---------------------------------------------------------------------------
# q02 — union of two sales channels by quarter (q02's channel-union +
# calendar-join core; 2 channels instead of 3, quarters instead of weeks)
# ---------------------------------------------------------------------------

def q02(paths, frames, mode):
    u_schema = T.Schema([T.Field("sold_date_sk", T.INT64),
                         T.Field("price", T.FLOAT64)])
    ws = P.scan(WS, [(paths["web_sales"], [])])
    wsp = P.project(ws, [col("ws_sold_date_sk"), col("ws_ext_sales_price")],
                    ["sold_date_sk", "price"], u_schema)
    cs = P.scan(CS, [(paths["catalog_sales"], [])])
    csp = P.project(cs, [col("cs_sold_date_sk"), col("cs_ext_sales_price")],
                    ["sold_date_sk", "price"], u_schema)
    u = P.union([wsp, csp])
    dd = P.scan(DD, [(paths["date_dim"], [])])
    j = _join(u, dd, [col("sold_date_sk")], [col("d_date_sk")], "inner",
              T.Schema(_fields(u_schema, DD)), mode)
    out = _two_phase_agg(
        j, [col("d_year"), col("d_qoy")], ["d_year", "d_qoy"],
        [_sum("price", "total"), _cnt("price", "n")],
        [T.Field("d_year", T.INT32), T.Field("d_qoy", T.INT32)])
    srt = P.sort(out, [(col("d_year"), True, True),
                       (col("d_qoy"), True, True)])

    def oracle():
        import pandas as pd

        w = frames["web_sales"].rename(columns={
            "ws_sold_date_sk": "sold_date_sk",
            "ws_ext_sales_price": "price"})[["sold_date_sk", "price"]]
        c = frames["catalog_sales"].rename(columns={
            "cs_sold_date_sk": "sold_date_sk",
            "cs_ext_sales_price": "price"})[["sold_date_sk", "price"]]
        u = pd.concat([w, c])
        m = u.merge(frames["date_dim"], left_on="sold_date_sk",
                    right_on="d_date_sk")
        g = m.groupby(["d_year", "d_qoy"])["price"].agg(
            total=lambda s: s.sum(min_count=1), n="count").reset_index()
        return g.sort_values(["d_year", "d_qoy"]).reset_index(drop=True)

    return srt, oracle


# ---------------------------------------------------------------------------
# q03 — ss x dd x item, brand revenue for one manufacturer in November
# ---------------------------------------------------------------------------

def q03(paths, frames, mode):
    ss = P.scan(SS, [(paths["store_sales"], [])])
    dd = P.scan(DD, [(paths["date_dim"], [])])
    ddf = P.filter_(dd, ir.Binary(BinOp.EQ, col("d_moy"), lit(11)))
    it = P.scan(ITEM, [(paths["item"], [])])
    itf = P.filter_(it, ir.Binary(BinOp.EQ, col("i_manufact_id"), lit(28)))
    j1 = _join(ss, ddf, [col("ss_sold_date_sk")], [col("d_date_sk")],
               "inner", T.Schema(_fields(SS, DD)), mode)
    j2 = _join(j1, itf, [col("ss_item_sk")], [col("i_item_sk")], "inner",
               T.Schema(_fields(SS, DD, ITEM)), mode)
    out = _two_phase_agg(
        j2, [col("d_year"), col("i_brand_id"), col("i_brand")],
        ["d_year", "brand_id", "brand"],
        [_sum("ss_ext_sales_price", "sum_agg")],
        [T.Field("d_year", T.INT32), T.Field("brand_id", T.INT32),
         T.Field("brand", T.STRING)])
    srt = P.sort(out, [(col("d_year"), True, True),
                       (col("sum_agg"), False, True),
                       (col("brand_id"), True, True)])
    lim = P.limit(srt, 100, True)

    def oracle():
        import pandas as pd

        ssd = frames["store_sales"]
        ddd = frames["date_dim"]
        itd = frames["item"]
        m = ssd.merge(ddd[ddd.d_moy == 11], left_on="ss_sold_date_sk",
                      right_on="d_date_sk")
        m = m.merge(itd[itd.i_manufact_id == 28], left_on="ss_item_sk",
                    right_on="i_item_sk")
        g = m.groupby(["d_year", "i_brand_id", "i_brand"])[
            "ss_ext_sales_price"].agg(
                lambda s: s.sum(min_count=1)).reset_index()
        g.columns = ["d_year", "brand_id", "brand", "sum_agg"]
        g = g.sort_values(["d_year", "sum_agg", "brand_id"],
                          ascending=[True, False, True],
                          na_position="first")
        return g.head(100).reset_index(drop=True)

    return lim, oracle


# ---------------------------------------------------------------------------
# q04 — cross-channel year-over-year growth (2 channels x 2 years;
# the real q04's year_total self-join lattice with 4 arms)
# ---------------------------------------------------------------------------

def _year_total(paths, frames, mode, scan_schema, table, date_col,
                cust_col, price_col, year, cname, tname):
    s = P.scan(scan_schema, [(paths[table], [])])
    dd = P.scan(DD, [(paths["date_dim"], [])])
    ddf = P.filter_(dd, ir.Binary(BinOp.EQ, col("d_year"), lit(year)))
    j = _join(s, ddf, [col(date_col)], [col("d_date_sk")], "inner",
              T.Schema(_fields(scan_schema, DD)), mode)
    return _two_phase_agg(
        j, [col(cust_col)], [cname], [_sum(price_col, tname)],
        [T.Field(cname, T.INT64)])


def q04(paths, frames, mode):
    s1 = _year_total(paths, frames, mode, SS, "store_sales",
                     "ss_sold_date_sk", "ss_customer_sk",
                     "ss_ext_sales_price", 1999, "c1", "t_s1")
    s2 = _year_total(paths, frames, mode, SS, "store_sales",
                     "ss_sold_date_sk", "ss_customer_sk",
                     "ss_ext_sales_price", 2000, "c2", "t_s2")
    w1 = _year_total(paths, frames, mode, WS, "web_sales",
                     "ws_sold_date_sk", "ws_bill_customer_sk",
                     "ws_ext_sales_price", 1999, "c3", "t_w1")
    w2 = _year_total(paths, frames, mode, WS, "web_sales",
                     "ws_sold_date_sk", "ws_bill_customer_sk",
                     "ws_ext_sales_price", 2000, "c4", "t_w2")

    def jschema(*plans):
        fs = []
        for p in plans:
            fs.extend(p.schema.fields)
        return T.Schema(fs)

    j1 = _join(s1, s2, [col("c1")], [col("c2")], "inner", jschema(s1, s2),
               mode)
    j2 = _join(j1, w1, [col("c1")], [col("c3")], "inner", jschema(j1, w1),
               mode)
    j3 = _join(j2, w2, [col("c1")], [col("c4")], "inner", jschema(j2, w2),
               mode)
    # growth(web) > growth(store): w2*s1 > s2*w1, all arms positive
    pos = ir.Binary(BinOp.AND,
                    ir.Binary(BinOp.GT, col("t_s1"), lit(0.0)),
                    ir.Binary(BinOp.GT, col("t_w1"), lit(0.0)))
    growth = ir.Binary(
        BinOp.GT,
        ir.Binary(BinOp.MUL, col("t_w2"), col("t_s1")),
        ir.Binary(BinOp.MUL, col("t_s2"), col("t_w1")))
    f = P.filter_(j3, ir.Binary(BinOp.AND, pos, growth))
    proj = P.project(f, [col("c1")], ["customer_sk"],
                     T.Schema([T.Field("customer_sk", T.INT64)]))
    srt = P.sort(proj, [(col("customer_sk"), True, True)])
    out = P.limit(srt, 100, True)

    def oracle():
        import pandas as pd

        dd = frames["date_dim"]

        def yt(df, date_col, cust_col, price_col, year):
            m = df.merge(dd[dd.d_year == year], left_on=date_col,
                         right_on="d_date_sk")
            g = m.groupby(cust_col)[price_col].agg(
                lambda s: s.sum(min_count=1)).reset_index()
            g.columns = ["cust", "total"]
            return g.dropna(subset=["cust"])

        ssd, wsd = frames["store_sales"], frames["web_sales"]
        s1 = yt(ssd, "ss_sold_date_sk", "ss_customer_sk",
                "ss_ext_sales_price", 1999)
        s2 = yt(ssd, "ss_sold_date_sk", "ss_customer_sk",
                "ss_ext_sales_price", 2000)
        w1 = yt(wsd, "ws_sold_date_sk", "ws_bill_customer_sk",
                "ws_ext_sales_price", 1999)
        w2 = yt(wsd, "ws_sold_date_sk", "ws_bill_customer_sk",
                "ws_ext_sales_price", 2000)
        m = s1.merge(s2, on="cust", suffixes=("_s1", "_s2"))
        m = m.merge(w1.rename(columns={"total": "total_w1"}), on="cust")
        m = m.merge(w2.rename(columns={"total": "total_w2"}), on="cust")
        m = m[(m.total_s1 > 0) & (m.total_w1 > 0)
              & (m.total_w2 * m.total_s1 > m.total_s2 * m.total_w1)]
        out = pd.DataFrame({"customer_sk": m.cust.astype(np.int64)})
        return out.sort_values("customer_sk").head(100).reset_index(
            drop=True)

    return out, oracle


# ---------------------------------------------------------------------------
# q05 — sales+returns per store with ROLLUP (Expand-based grouping sets,
# store channel; the real q05 unions three channels)
# ---------------------------------------------------------------------------

def q05(paths, frames, mode):
    u_schema = T.Schema([T.Field("store_sk", T.INT64),
                         T.Field("sales", T.FLOAT64),
                         T.Field("returns", T.FLOAT64)])
    ss = P.scan(SS, [(paths["store_sales"], [])])
    ssp = P.project(
        ss, [col("ss_store_sk"), col("ss_ext_sales_price"),
             ir.Literal(T.FLOAT64, 0.0)],
        ["store_sk", "sales", "returns"], u_schema)
    sr = P.scan(SR, [(paths["store_returns"], [])])
    srp = P.project(
        sr, [col("sr_store_sk"), ir.Literal(T.FLOAT64, 0.0),
             col("sr_return_amt")],
        ["store_sk", "sales", "returns"], u_schema)
    u = P.union([ssp, srp])
    st = P.scan(STORE, [(paths["store"], [])])
    j = _join(u, st, [col("store_sk")], [col("s_store_sk")], "inner",
              T.Schema(_fields(u_schema, STORE)), mode)
    # ROLLUP(s_store_name): Expand emits (name, 0) and (null, 1) rows
    exp_schema = T.Schema([T.Field("s_store_name", T.STRING),
                           T.Field("sales", T.FLOAT64),
                           T.Field("returns", T.FLOAT64),
                           T.Field("spark_grouping_id", T.INT64)])
    exp = P.SparkPlan(
        "ExpandExec", exp_schema, [j],
        {"projections": [
            [col("s_store_name"), col("sales"), col("returns"),
             ir.Literal(T.INT64, 0)],
            [ir.Literal(T.STRING, None), col("sales"), col("returns"),
             ir.Literal(T.INT64, 1)],
        ]})
    out = _two_phase_agg(
        exp, [col("s_store_name"), col("spark_grouping_id")],
        ["s_store_name", "spark_grouping_id"],
        [_sum("sales", "total_sales"), _sum("returns", "total_returns")],
        [T.Field("s_store_name", T.STRING),
         T.Field("spark_grouping_id", T.INT64)])
    srt = P.sort(out, [(col("spark_grouping_id"), True, True),
                       (col("s_store_name"), True, True)])

    def oracle():
        import pandas as pd

        ssd, srd = frames["store_sales"], frames["store_returns"]
        st = frames["store"]
        a = ssd.rename(columns={"ss_store_sk": "store_sk",
                                "ss_ext_sales_price": "sales"})[
            ["store_sk", "sales"]].assign(returns=0.0)
        b = srd.rename(columns={"sr_store_sk": "store_sk",
                                "sr_return_amt": "returns"})[
            ["store_sk", "returns"]].assign(sales=0.0)
        u = pd.concat([a, b])
        m = u.merge(st, left_on="store_sk", right_on="s_store_sk")
        per = m.groupby("s_store_name").agg(
            total_sales=("sales", lambda s: s.sum(min_count=1)),
            total_returns=("returns",
                           lambda s: s.sum(min_count=1))).reset_index()
        per["spark_grouping_id"] = 0
        tot = pd.DataFrame({
            "s_store_name": [None],
            "total_sales": [m["sales"].sum(min_count=1)],
            "total_returns": [m["returns"].sum(min_count=1)],
            "spark_grouping_id": [1]})
        out = pd.concat([per, tot], ignore_index=True)
        return out[["s_store_name", "spark_grouping_id", "total_sales",
                    "total_returns"]].sort_values(
            ["spark_grouping_id", "s_store_name"],
            na_position="first").reset_index(drop=True)

    return srt, oracle


# ---------------------------------------------------------------------------
# q06 — state-level counts of items priced over 1.2x their category avg
# ---------------------------------------------------------------------------

def q06(paths, frames, mode):
    it = P.scan(ITEM, [(paths["item"], [])])
    itc = P.project(
        it, [col("i_category"), col("i_current_price")],
        ["avg_cat", "avg_in"],
        T.Schema([T.Field("avg_cat", T.STRING),
                  T.Field("avg_in", T.FLOAT64)]))
    cat_avg = _two_phase_agg(
        itc, [col("avg_cat")], ["avg_cat"], [_avg("avg_in", "cat_price")],
        [T.Field("avg_cat", T.STRING)])
    j_item = _join(it, cat_avg, [col("i_category")], [col("avg_cat")],
                   "inner",
                   T.Schema(list(ITEM.fields) + list(cat_avg.schema.fields)),
                   mode)
    hot = P.filter_(j_item, ir.Binary(
        BinOp.GT, col("i_current_price"),
        ir.Binary(BinOp.MUL, col("cat_price"), lit(1.2))))
    ss = P.scan(SS, [(paths["store_sales"], [])])
    dd = P.scan(DD, [(paths["date_dim"], [])])
    ddf = P.filter_(dd, ir.Binary(
        BinOp.AND, ir.Binary(BinOp.EQ, col("d_year"), lit(2000)),
        ir.Binary(BinOp.EQ, col("d_moy"), lit(1))))
    j1 = _join(ss, ddf, [col("ss_sold_date_sk")], [col("d_date_sk")],
               "inner", T.Schema(_fields(SS, DD)), mode)
    j2 = _join(j1, hot, [col("ss_item_sk")], [col("i_item_sk")], "inner",
               T.Schema(list(j1.schema.fields) + list(hot.schema.fields)),
               mode)
    cust = P.scan(CUST, [(paths["customer"], [])])
    j3 = _join(j2, cust, [col("ss_customer_sk")], [col("c_customer_sk")],
               "inner",
               T.Schema(list(j2.schema.fields) + list(CUST.fields)), mode)
    ca = P.scan(CA, [(paths["customer_address"], [])])
    j4 = _join(j3, ca, [col("c_current_addr_sk")], [col("ca_address_sk")],
               "inner",
               T.Schema(list(j3.schema.fields) + list(CA.fields)), mode)
    agg = _two_phase_agg(
        j4, [col("ca_state")], ["state"], [_cnt("ss_item_sk", "cnt")],
        [T.Field("state", T.STRING)])
    having = P.filter_(agg, ir.Binary(BinOp.GE, col("cnt"),
                                      lit(10, T.INT64)))
    srt = P.sort(having, [(col("cnt"), True, True),
                          (col("state"), True, True)])
    out = P.limit(srt, 100, True)

    def oracle():
        import pandas as pd

        itd = frames["item"]
        cat = itd.groupby("i_category")["i_current_price"].mean()
        hot = itd[itd.i_current_price >
                  1.2 * itd.i_category.map(cat)]
        ssd, ddd = frames["store_sales"], frames["date_dim"]
        m = ssd.merge(ddd[(ddd.d_year == 2000) & (ddd.d_moy == 1)],
                      left_on="ss_sold_date_sk", right_on="d_date_sk")
        m = m.merge(hot, left_on="ss_item_sk", right_on="i_item_sk")
        m = m.merge(frames["customer"], left_on="ss_customer_sk",
                    right_on="c_customer_sk")
        m = m.merge(frames["customer_address"],
                    left_on="c_current_addr_sk", right_on="ca_address_sk")
        g = m.groupby("ca_state")["ss_item_sk"].count().reset_index()
        g.columns = ["state", "cnt"]
        g = g[g.cnt >= 10]
        return g.sort_values(["cnt", "state"]).head(100).reset_index(
            drop=True)

    return out, oracle


# ---------------------------------------------------------------------------
# q07 — demographic averages over promoted items
# ---------------------------------------------------------------------------

def q07(paths, frames, mode):
    ss = P.scan(SS, [(paths["store_sales"], [])])
    cd = P.scan(CD, [(paths["customer_demographics"], [])])
    cdf = P.filter_(cd, ir.Binary(
        BinOp.AND,
        ir.Binary(BinOp.AND,
                  ir.Binary(BinOp.EQ, col("cd_gender"), lit("M")),
                  ir.Binary(BinOp.EQ, col("cd_marital_status"), lit("S"))),
        ir.Binary(BinOp.EQ, col("cd_education_status"), lit("College"))))
    j1 = _join(ss, cdf, [col("ss_cdemo_sk")], [col("cd_demo_sk")], "inner",
               T.Schema(_fields(SS, CD)), mode)
    dd = P.scan(DD, [(paths["date_dim"], [])])
    ddf = P.filter_(dd, ir.Binary(BinOp.EQ, col("d_year"), lit(2000)))
    j2 = _join(j1, ddf, [col("ss_sold_date_sk")], [col("d_date_sk")],
               "inner",
               T.Schema(list(j1.schema.fields) + list(DD.fields)), mode)
    pr = P.scan(PROMO, [(paths["promotion"], [])])
    prf = P.filter_(pr, ir.Binary(
        BinOp.OR, ir.Binary(BinOp.EQ, col("p_channel_email"), lit("N")),
        ir.Binary(BinOp.EQ, col("p_channel_event"), lit("N"))))
    j3 = _join(j2, prf, [col("ss_promo_sk")], [col("p_promo_sk")], "inner",
               T.Schema(list(j2.schema.fields) + list(PROMO.fields)), mode)
    it = P.scan(ITEM, [(paths["item"], [])])
    j4 = _join(j3, it, [col("ss_item_sk")], [col("i_item_sk")], "inner",
               T.Schema(list(j3.schema.fields) + list(ITEM.fields)), mode)
    qty = P.project(
        j4, [col("i_item_id"), ir.Cast(col("ss_quantity"), T.FLOAT64),
             col("ss_list_price"), col("ss_coupon_amt"),
             col("ss_sales_price")],
        ["i_item_id", "q", "lp", "ca", "sp"],
        T.Schema([T.Field("i_item_id", T.STRING), T.Field("q", T.FLOAT64),
                  T.Field("lp", T.FLOAT64), T.Field("ca", T.FLOAT64),
                  T.Field("sp", T.FLOAT64)]))
    agg = _two_phase_agg(
        qty, [col("i_item_id")], ["i_item_id"],
        [_avg("q", "agg1"), _avg("lp", "agg2"), _avg("ca", "agg3"),
         _avg("sp", "agg4")],
        [T.Field("i_item_id", T.STRING)])
    srt = P.sort(agg, [(col("i_item_id"), True, True)])
    out = P.limit(srt, 100, True)

    def oracle():
        import pandas as pd

        cdd = frames["customer_demographics"]
        cdf = cdd[(cdd.cd_gender == "M") & (cdd.cd_marital_status == "S")
                  & (cdd.cd_education_status == "College")]
        m = frames["store_sales"].merge(cdf, left_on="ss_cdemo_sk",
                                        right_on="cd_demo_sk")
        ddd = frames["date_dim"]
        m = m.merge(ddd[ddd.d_year == 2000], left_on="ss_sold_date_sk",
                    right_on="d_date_sk")
        prd = frames["promotion"]
        prf = prd[(prd.p_channel_email == "N")
                  | (prd.p_channel_event == "N")]
        m = m.merge(prf, left_on="ss_promo_sk", right_on="p_promo_sk")
        m = m.merge(frames["item"], left_on="ss_item_sk",
                    right_on="i_item_sk")
        g = m.groupby("i_item_id").agg(
            agg1=("ss_quantity", "mean"), agg2=("ss_list_price", "mean"),
            agg3=("ss_coupon_amt", "mean"),
            agg4=("ss_sales_price", "mean")).reset_index()
        return g.sort_values("i_item_id").head(100).reset_index(drop=True)

    return out, oracle


# ---------------------------------------------------------------------------
# q08 — store net profit for stores whose 5-digit zip prefix has
# customers (substr + semi join; the real q08's zip-list core)
# ---------------------------------------------------------------------------

def q08(paths, frames, mode):
    ss = P.scan(SS, [(paths["store_sales"], [])])
    dd = P.scan(DD, [(paths["date_dim"], [])])
    ddf = P.filter_(dd, ir.Binary(
        BinOp.AND, ir.Binary(BinOp.EQ, col("d_year"), lit(2000)),
        ir.Binary(BinOp.EQ, col("d_qoy"), lit(2))))
    j1 = _join(ss, ddf, [col("ss_sold_date_sk")], [col("d_date_sk")],
               "inner", T.Schema(_fields(SS, DD)), mode)
    st = P.scan(STORE, [(paths["store"], [])])
    stz = P.project(
        st, [col("s_store_sk"), col("s_store_name"),
             ir.ScalarFn("substring", (col("s_zip"), lit(1), lit(5)),
                         T.STRING)],
        ["s_store_sk", "s_store_name", "zip5"],
        T.Schema([T.Field("s_store_sk", T.INT64),
                  T.Field("s_store_name", T.STRING),
                  T.Field("zip5", T.STRING)]))
    ca = P.scan(CA, [(paths["customer_address"], [])])
    caz = P.project(
        ca, [ir.ScalarFn("substring", (col("ca_zip"), lit(1), lit(5)),
                         T.STRING)],
        ["ca_zip5"], T.Schema([T.Field("ca_zip5", T.STRING)]))
    stsemi = _join(stz, caz, [col("zip5")], [col("ca_zip5")], "left_semi",
                   stz.schema, mode)
    j2 = _join(j1, stsemi, [col("ss_store_sk")], [col("s_store_sk")],
               "inner",
               T.Schema(list(j1.schema.fields) + list(stsemi.schema.fields)),
               mode)
    agg = _two_phase_agg(
        j2, [col("s_store_name")], ["s_store_name"],
        [_sum("ss_net_profit", "net_profit")],
        [T.Field("s_store_name", T.STRING)])
    srt = P.sort(agg, [(col("s_store_name"), True, True)])
    out = P.limit(srt, 100, True)

    def oracle():
        import pandas as pd

        ssd, ddd = frames["store_sales"], frames["date_dim"]
        m = ssd.merge(ddd[(ddd.d_year == 2000) & (ddd.d_qoy == 2)],
                      left_on="ss_sold_date_sk", right_on="d_date_sk")
        st = frames["store"].copy()
        st["zip5"] = st.s_zip.str[:5]
        zips = set(frames["customer_address"].ca_zip.str[:5])
        st = st[st.zip5.isin(zips)]
        m = m.merge(st, left_on="ss_store_sk", right_on="s_store_sk")
        g = m.groupby("s_store_name")["ss_net_profit"].agg(
            lambda s: s.sum(min_count=1)).reset_index()
        g.columns = ["s_store_name", "net_profit"]
        return g.sort_values("s_store_name").head(100).reset_index(
            drop=True)

    return out, oracle


# ---------------------------------------------------------------------------
# q09 — CASE-filtered bucket aggregates over one scan (the real q09's
# quantity-bucket counts/averages, as conditional aggregation)
# ---------------------------------------------------------------------------

def q09(paths, frames, mode):
    ss = P.scan(SS, [(paths["store_sales"], [])])
    buckets = [(1, 20), (21, 40), (41, 60), (61, 80), (81, 100)]
    exprs = []
    names = []
    fields = []
    for i, (lo, hi) in enumerate(buckets, 1):
        inb = ir.Binary(
            BinOp.AND,
            ir.Binary(BinOp.GE, col("ss_quantity"), lit(lo)),
            ir.Binary(BinOp.LE, col("ss_quantity"), lit(hi)))
        exprs.append(ir.CaseWhen(
            ((inb, lit(1.0)),), lit(0.0)))
        names.append(f"in_b{i}")
        fields.append(T.Field(f"in_b{i}", T.FLOAT64))
        exprs.append(ir.CaseWhen(
            ((inb, col("ss_ext_sales_price")),), None))
        names.append(f"price_b{i}")
        fields.append(T.Field(f"price_b{i}", T.FLOAT64))
    proj = P.project(ss, exprs, names, T.Schema(fields))
    aggs = []
    for i in range(1, len(buckets) + 1):
        aggs.append(_sum(f"in_b{i}", f"cnt_b{i}"))
        aggs.append(_avg(f"price_b{i}", f"avg_b{i}"))
    agg = _two_phase_agg(proj, [], [], aggs, [], mode_cols=1)
    # the outer CASE: pick avg_b{i} or avg_b{i+1} per bucket count
    out_exprs = []
    out_names = []
    out_fields = []
    for i in range(1, len(buckets)):
        pick = ir.CaseWhen(
            ((ir.Binary(BinOp.GT, col(f"cnt_b{i}"), lit(float(0))),
              col(f"avg_b{i}")),), col(f"avg_b{i + 1}"))
        out_exprs.append(pick)
        out_names.append(f"bucket{i}")
        out_fields.append(T.Field(f"bucket{i}", T.FLOAT64))
    out = P.project(agg, out_exprs, out_names, T.Schema(out_fields))

    def oracle():
        import pandas as pd

        ssd = frames["store_sales"]
        row = {}
        for i, (lo, hi) in enumerate(buckets, 1):
            inb = (ssd.ss_quantity >= lo) & (ssd.ss_quantity <= hi)
            row[f"cnt_b{i}"] = float(inb.sum())
            sel = ssd.ss_ext_sales_price[inb]
            row[f"avg_b{i}"] = sel.mean()
        res = {}
        for i in range(1, len(buckets)):
            res[f"bucket{i}"] = (row[f"avg_b{i}"] if row[f"cnt_b{i}"] > 0
                                 else row[f"avg_b{i + 1}"])
        return pd.DataFrame([res])

    return out, oracle


# ---------------------------------------------------------------------------
# q10 — customer demographic counts gated on EXISTS store_sales AND
# (EXISTS web_sales OR EXISTS catalog_sales)
# ---------------------------------------------------------------------------

def q10(paths, frames, mode):
    cust = P.scan(CUST, [(paths["customer"], [])])
    ca = P.scan(CA, [(paths["customer_address"], [])])
    caf = P.filter_(ca, ir.InList(col("ca_state"),
                                  (lit("TN"), lit("GA"), lit("SC"))))
    j1 = _join(cust, caf, [col("c_current_addr_sk")],
               [col("ca_address_sk")], "inner",
               T.Schema(_fields(CUST, CA)), mode)
    ss = P.scan(SS, [(paths["store_sales"], [])])
    dd = P.scan(DD, [(paths["date_dim"], [])])
    ddf = P.filter_(dd, ir.Binary(BinOp.EQ, col("d_year"), lit(2000)))
    ssd = _join(ss, ddf, [col("ss_sold_date_sk")], [col("d_date_sk")],
                "inner", T.Schema(_fields(SS, DD)), mode)
    # EXISTS store_sales in range: semi join
    j2 = _join(j1, ssd, [col("c_customer_sk")], [col("ss_customer_sk")],
               "left_semi", j1.schema, mode)
    # EXISTS web / EXISTS catalog: existence joins add boolean columns
    ws = P.scan(WS, [(paths["web_sales"], [])])
    j3_schema = T.Schema(list(j2.schema.fields) +
                         [T.Field("exists_w", T.BOOLEAN, False)])
    j3 = P.SparkPlan(
        "SortMergeJoinExec" if mode == "smj" else "BroadcastHashJoinExec",
        j3_schema,
        [P.shuffle_exchange(j2, [col("c_customer_sk")], 4)
         if mode == "smj" else j2,
         P.shuffle_exchange(ws, [col("ws_bill_customer_sk")], 4)
         if mode == "smj" else P.broadcast_exchange(ws)],
        {"left_keys": [col("c_customer_sk")],
         "right_keys": [col("ws_bill_customer_sk")],
         "join_type": "existence", "condition": None,
         "existence_name": "exists_w", "build_side": "right"})
    cs = P.scan(CS, [(paths["catalog_sales"], [])])
    j4_schema = T.Schema(list(j3_schema.fields) +
                         [T.Field("exists_c", T.BOOLEAN, False)])
    j4 = P.SparkPlan(
        "SortMergeJoinExec" if mode == "smj" else "BroadcastHashJoinExec",
        j4_schema,
        [P.shuffle_exchange(j3, [col("c_customer_sk")], 4)
         if mode == "smj" else j3,
         P.shuffle_exchange(cs, [col("cs_ship_customer_sk")], 4)
         if mode == "smj" else P.broadcast_exchange(cs)],
        {"left_keys": [col("c_customer_sk")],
         "right_keys": [col("cs_ship_customer_sk")],
         "join_type": "existence", "condition": None,
         "existence_name": "exists_c", "build_side": "right"})
    f = P.filter_(j4, ir.Binary(BinOp.OR, col("exists_w"),
                                col("exists_c")))
    cd = P.scan(CD, [(paths["customer_demographics"], [])])
    j5 = _join(f, cd, [col("c_current_cdemo_sk")], [col("cd_demo_sk")],
               "inner",
               T.Schema(list(j4_schema.fields) + list(CD.fields)), mode)
    agg = _two_phase_agg(
        j5, [col("cd_gender"), col("cd_marital_status"),
             col("cd_education_status")],
        ["cd_gender", "cd_marital_status", "cd_education_status"],
        [_cnt("cd_demo_sk", "cnt")],
        [T.Field("cd_gender", T.STRING),
         T.Field("cd_marital_status", T.STRING),
         T.Field("cd_education_status", T.STRING)])
    srt = P.sort(agg, [(col("cd_gender"), True, True),
                       (col("cd_marital_status"), True, True),
                       (col("cd_education_status"), True, True)])
    out = P.limit(srt, 100, True)

    def oracle():
        import pandas as pd

        cu = frames["customer"]
        cad = frames["customer_address"]
        m = cu.merge(cad[cad.ca_state.isin(["TN", "GA", "SC"])],
                     left_on="c_current_addr_sk", right_on="ca_address_sk")
        ssd, ddd = frames["store_sales"], frames["date_dim"]
        sr = ssd.merge(ddd[ddd.d_year == 2000],
                       left_on="ss_sold_date_sk", right_on="d_date_sk")
        m = m[m.c_customer_sk.isin(set(sr.ss_customer_sk.dropna()))]
        wset = set(frames["web_sales"].ws_bill_customer_sk)
        cset = set(frames["catalog_sales"].cs_ship_customer_sk)
        m = m[m.c_customer_sk.isin(wset | cset)]
        m = m.merge(frames["customer_demographics"],
                    left_on="c_current_cdemo_sk", right_on="cd_demo_sk")
        g = m.groupby(["cd_gender", "cd_marital_status",
                       "cd_education_status"])["cd_demo_sk"].count(
            ).reset_index()
        g.columns = ["cd_gender", "cd_marital_status",
                     "cd_education_status", "cnt"]
        return g.sort_values(["cd_gender", "cd_marital_status",
                              "cd_education_status"]).head(100
                                                           ).reset_index(
            drop=True)

    return out, oracle


QUERIES: Dict[str, Callable] = {
    "q01": q01, "q02": q02, "q03": q03, "q04": q04, "q05": q05,
    "q06": q06, "q07": q07, "q08": q08, "q09": q09, "q10": q10,
}

# single-channel/global-agg queries where the join axis changes nothing
JOINLESS: set = {"q09"}


def warm_cells(queries=None, modes=("bhj", "smj")):
    """The catalogue's enumerated (query, join-mode) shape cells, as the
    validator runs them. Joinless queries enumerate one mode (the axis is
    inert)."""
    names = list(queries) if queries else sorted(QUERIES)
    for name in names:
        if name not in QUERIES:
            raise KeyError(f"unknown catalogue query: {name}")
        for mode in (modes[:1] if name in JOINLESS else modes):
            yield name, mode
