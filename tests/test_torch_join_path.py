"""TPC-DS q02 and q04 from Parquet files through both packages, on the CPU.

chip_smoke.py writes the tables (date_dim in full, the fact tables cut to
a few files of 2^12 rows, 1000 customers) and builds each query's stages
as TaskDefinition bytes: the broadcast of date_dim, the map tasks
(Parquet scan -> broadcast hash join -> partial aggregate -> shuffle
writer), the reduce tasks (q04: three sort-merge joins of the four
year-total arms), and the final task. Both packages run the same bytes,
each over its own map files: the map tasks must take the same route
(`stage_compiled`, and `stage_fallbacks`, which the JAX package does not
count: the test counts its `_fallback` calls), and the results must equal each
other (keys and counts exact, sums within rtol 1e-12) and the numpy
oracle (sums within rtol 1e-9).
"""

import os

import numpy as np
import pytest

import chip_smoke as cs
from blaze_tpu.ops.base import ExecContext as JCtx
from blaze_tpu.ops.shuffle import read_shuffle_partition_host as jread
from blaze_tpu.plan.from_proto import decode_task_definition as jdecode
from blaze_tpu.runtime import resources as jres
from blaze_tpu.runtime import stage_compiler as jstage
from blaze_tpu.runtime.executor import collect as jcollect
from blaze_tpu.runtime.executor import execute_plan as jexec
from blaze_tpu_torch.config import conf
from blaze_tpu_torch.runtime import metrics

PARTS = 4


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setattr(cs, "FACT_FILE_ROWS", 1 << 12)
    mp.setattr(cs, "TPCDS_FILES", {"web_sales": 2, "catalog_sales": 4,
                                   "store_sales": 2})
    mp.setattr(cs, "CUSTOMERS", 1000)
    root = tmp_path_factory.mktemp("tpcds")
    mp.setattr(conf, "spill_dir", str(root / "spill"))
    paths, orc = cs.write_tpcds(str(root / "data"), seed=7)
    yield paths, orc, root
    mp.undo()


def _jax_reader(outputs, state):
    def provide(partition):
        for d, i in outputs:
            yield from jread(d, i, partition, state)

    return provide


def _run_jax(q):
    """The JAX package over the same task bytes: its own frames, shuffle
    readers and final source under the ids the bytes name."""
    for task, sink, build in q["bcasts"]:
        frames = []
        jres.put(sink, frames.append)
        plan, _ = jdecode(task)
        list(jexec(plan, JCtx()))
        jres.put(build, cs._replay(frames))
    for src, outputs, m in q["shuffles"]:
        state = jdecode(q["maps"][m])[0].children[0].schema
        jres.put(src, _jax_reader(outputs, state))
    plans = []
    for task in q["maps"]:
        plan, td = jdecode(task)
        list(jexec(plan, JCtx(partition=td.partition_id,
                              num_partitions=len(q["maps"]))))
        plans.append(plan)
    outs = []
    for task in q["reduces"]:
        plan, td = jdecode(task)
        outs.append(jcollect(plan, JCtx(partition=td.partition_id,
                                        num_partitions=len(q["reduces"]))))
    jres.put(q["final_src"], lambda: iter(outs))
    return jcollect(jdecode(q["final"])[0], JCtx()), plans


def _routes(plans):
    return [(p.children[0].metrics["stage_compiled"],
             p.children[0].metrics["stage_fallbacks"]) for p in plans]


@pytest.fixture
def jax_fallbacks(monkeypatch):
    """Count the JAX package's whole-stage fallbacks on the stage root,
    under the port's metric name."""
    real = jstage._fallback

    def counted(root, *args):
        root.metrics.add("stage_fallbacks", 1)
        return real(root, *args)

    monkeypatch.setattr(jstage, "_fallback", counted)


def _both(build, tables, name):
    paths, orc, root = tables
    port_dir, jax_dir = str(root / f"{name}_port"), str(root / f"{name}_jax")
    for d in (port_dir, jax_dir):
        os.makedirs(d, exist_ok=True)
    q = build(paths, port_dir, PARTS)
    metrics.HOST_PULLS = 0
    r = cs.run_tpcds(q, device="cpu")
    jout, jplans = _run_jax(build(paths, jax_dir, PARTS))
    assert _routes(r["map_plans"]) == _routes(jplans)
    return r, jout, orc


def _same_rows(tout, jout):
    t, j = tout.to_numpy(), jout.to_numpy()
    assert list(t) == list(j)
    for k in t:
        assert len(t[k]) == len(j[k])
        if np.asarray(j[k]).dtype.kind == "f":
            np.testing.assert_allclose(t[k], j[k], rtol=1e-12)
        else:
            np.testing.assert_array_equal(t[k], j[k])


def test_q02_broadcast_join_from_parquet(tables, jax_fallbacks):
    r, jout, orc = _both(cs.tpcds_q02, tables, "q02")
    _same_rows(r["out"], jout)
    cs.check_q02(r["out"], orc)
    assert _routes(r["map_plans"]) == [(1, 0)] * 2   # the dense stage
    assert r["rows"] == len(cs._q02_oracle(orc)[0]) == 21


def test_q04_sort_merge_lattice_from_parquet(tables, jax_fallbacks):
    r, jout, orc = _both(cs.tpcds_q04, tables, "q04")
    _same_rows(r["out"], jout)
    cs.check_q04(r["out"], orc)
    # null customer keys: every map task falls back to the streaming agg
    assert _routes(r["map_plans"]) == [(0, 1)] * 8
    assert 0 < r["rows"] <= cs.Q04_TOP
