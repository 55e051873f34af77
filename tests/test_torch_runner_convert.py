"""The port's driver-side conversion against the JAX package's, on the CPU.

For every query of the TPC-DS catalogue (spark/tpcds.py) in both join
modes, and every query of the validator's core catalogue
(spark/validator.py) in its modes, each package makes the SparkPlan with
its own query function, tags it (`apply_strategy`) and splits it into
stages (`plan_stages(..., namespace="")`, so that resource ids carry no
query id). The strategy tags must be equal node for node, and the stages
equal in kind, partition count and dependencies, with byte-identical plan
protobufs and equal fingerprints. Conversion needs no data, so this also
covers the queries the port cannot run yet.
"""

import pytest

from blaze_tpu.plan.fingerprint import fingerprint_plan as jfingerprint
from blaze_tpu.plan.fingerprint import fingerprint_query as jfingerprint_query
from blaze_tpu.spark import tpcds as jtpcds
from blaze_tpu.spark import validator as jvalidator
from blaze_tpu.spark.convert_strategy import apply_strategy as japply
from blaze_tpu.spark.stages import plan_stages as jplan_stages
from blaze_tpu_torch.plan import fingerprint_plan, fingerprint_query
from blaze_tpu_torch.spark import tpcds, validator
from blaze_tpu_torch.spark.convert_strategy import apply_strategy
from blaze_tpu_torch.spark.stages import plan_stages

TABLES = ["store_sales", "store_returns", "date_dim", "store", "item",
          "customer", "customer_address", "customer_demographics",
          "promotion", "web_sales", "catalog_sales"]
PATHS = {t: f"/data/{t}.parquet" for t in TABLES}


def _cells():
    for q in sorted(tpcds.QUERIES):
        for mode in ("bhj", "smj"):
            yield "tpcds", q, mode
    for q in validator.QUERIES:
        for mode in (["bhj"] if q in validator._JOINLESS else ["bhj", "smj"]):
            yield "core", q, mode


CATALOGUES = {"tpcds": (tpcds, jtpcds), "core": (validator, jvalidator)}


def _tags(plan):
    out = [(plan.kind, plan.convertible, plan.strategy)]
    for c in plan.children:
        out += _tags(c)
    return out


def _staged(module, apply, plan_stages_fn, q, mode):
    plan, _ = module.QUERIES[q](PATHS, None, mode)
    apply(plan)
    tags = _tags(plan)
    return tags, plan_stages_fn(plan, default_partitions=4, namespace="")


@pytest.mark.parametrize("suite,q,mode", list(_cells()))
def test_stages_byte_identical(suite, q, mode):
    port, jax = CATALOGUES[suite]
    tags, stages = _staged(port, apply_strategy, plan_stages, q, mode)
    jtags, jstages = _staged(jax, japply, jplan_stages, q, mode)
    assert tags == jtags
    assert all(s == "Default" or s == "AlwaysConvert" for _, _, s in tags)
    assert len(stages) == len(jstages)
    for s, js in zip(stages, jstages):
        assert (s.stage_id, s.kind, s.num_partitions, s.depends_on) == \
            (js.stage_id, js.kind, js.num_partitions, js.depends_on)
        assert s.plan.SerializeToString() == js.plan.SerializeToString()
        assert fingerprint_plan(s.plan) == jfingerprint(js.plan)
    assert fingerprint_query([fingerprint_plan(s.plan) for s in stages]) \
        == jfingerprint_query([jfingerprint(s.plan) for s in jstages])
