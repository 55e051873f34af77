"""The whole shuffle slice of the port against the JAX package, on the CPU.

q06 (`GROUP BY ss_item_sk`, the dense stage on the map side) and the
customer query (`GROUP BY` a nullable ss_customer_sk, the streaming
AggExec) run as two stages from the same TaskDefinition bytes (chip_smoke's
`_shuffle_query`) through both packages: 2 map tasks of 2 batches each,
each committing a .data/.index pair hash-partitioned into 4, then 4 reduce
tasks (ipc_reader -> Agg FINAL). The map outputs must hold the same rows in
the same partitions and frames; each package's reduce stage reads the
other's map files; the final rows agree with each other (keys and counts
exact, float sums and averages within rtol 1e-12) and with numpy (rtol
1e-9).
"""

import io
import os
import shutil

import numpy as np
import pytest

import chip_smoke as cs
from blaze_tpu.columnar import serde as JSerde
from blaze_tpu.columnar.batch import ColumnBatch as JBatch
from blaze_tpu.ops import shuffle as JShuffle
from blaze_tpu.ops.base import ExecContext as JCtx
from blaze_tpu.plan import plan_pb2 as jpb
from blaze_tpu.plan.from_proto import decode_task_definition as jdecode
from blaze_tpu.runtime import resources as jres
from blaze_tpu.runtime.executor import collect as jcollect
from blaze_tpu.runtime.executor import execute_plan as jexec
from blaze_tpu_torch.columnar import serde
from blaze_tpu_torch.columnar.batch import ColumnBatch
from blaze_tpu_torch.config import conf
from blaze_tpu_torch.runtime import artifacts, resources
from test_torch_general_path import JSCHEMA, ROWS, _register, _workload

MAPS, PARTS = 2, 4
JSCHEMA_Q06 = type(JSCHEMA)(list(JSCHEMA.fields)[1:])   # no customer key


@pytest.fixture
def small(monkeypatch, tmp_path):
    monkeypatch.setattr(cs, "ROWS", ROWS)
    monkeypatch.setattr(cs, "GROUPS", 1 << 10)
    monkeypatch.setattr(cs, "SHUFFLE_PARTITIONS", PARTS)
    monkeypatch.setattr(conf, "spill_dir", str(tmp_path / "spill"))
    return cs


def _rids(maps, reduces):
    """(ffi_reader resource id, ipc_reader provider id) named in the bytes."""
    m = jpb.TaskDefinition.FromString(maps[0])
    r = jpb.TaskDefinition.FromString(reduces[0])
    src = m.plan.shuffle_writer.input.agg.input.projection.input.filter.input
    return (src.ffi_reader.export_iter_resource_id,
            r.plan.agg.input.ipc_reader.provider_resource_id)


def _jax_side(maps, reduces, outputs, jbatches):
    """The JAX package's resources under the ids the bytes name: the same
    batch slices for each map task, and a provider reading partition p of
    every map output with the JAX package's reader."""
    src, red = _rids(maps, reduces)
    per = len(jbatches) // len(maps)
    jres.put(src, lambda task: iter(jbatches[task * per:(task + 1) * per]))
    jstate = jdecode(maps[0])[0].children[0].schema

    def provide(partition):
        for d, i in outputs:
            yield from JShuffle.read_shuffle_partition_host(d, i, partition,
                                                            jstate)

    jres.put(red, provide)


def _run_jax_maps(maps):
    for task in maps:
        plan, td = jdecode(task)
        list(jexec(plan, JCtx(partition=td.partition_id,
                              num_partitions=len(maps))))


def _jax_union(reduces, ncols):
    """The JAX reduce stage's rows in chip_smoke's packed layout."""
    cols = []
    for task in reduces:
        plan, td = jdecode(task)
        out = jcollect(plan, JCtx(partition=td.partition_id,
                                  num_partitions=len(reduces)))
        n = int(out.num_rows)
        part = []
        for c in out.columns[:ncols]:
            v = np.asarray(c.valid_mask())[:n]
            part.append(np.where(v, np.asarray(c.data)[:n].astype(np.float64),
                                 -1.0))
        cols.append(part)
    cols = [np.concatenate(c) for c in zip(*cols)]
    order = np.argsort(cols[0], kind="stable")
    return np.concatenate([[len(order)]] + [c[order] for c in cols])


def _copy(outputs, dst):
    os.makedirs(dst, exist_ok=True)
    out = []
    for d, i in outputs:
        for p in (d, i):
            shutil.copy(p, dst)
        out.append((os.path.join(dst, os.path.basename(d)),
                    os.path.join(dst, os.path.basename(i))))
    return out


def _compare_map_outputs(port, jax, state_schema, jstate_schema):
    """Same partition sizes in rows and frames; the rows of each frame
    equal (integers and flags bitwise, float state within rtol 1e-12)."""
    for (td, ti), (jd, ji) in zip(port, jax):
        assert artifacts.verify_pair(td, ti) and artifacts.verify_pair(jd, ji)
        assert artifacts.read_index(ti)[1]["n_frames"] == \
            artifacts.read_index(ji)[1]["n_frames"]
        for p in range(PARTS):
            mine = list(serde.read_batches_host(
                _seg(td, ti, p), state_schema))
            theirs = list(JSerde.read_batches_host(
                _seg(jd, ji, p), jstate_schema))
            assert [h.num_rows for h in mine] == \
                [h.num_rows for h in theirs]
            for h, jh in zip(mine, theirs):
                for f, c, jc in zip(state_schema, h.cols, jh.cols):
                    if c.validity is not None or jc.validity is not None:
                        np.testing.assert_array_equal(c.validity,
                                                      jc.validity)
                    if c.data.dtype.kind == "f":
                        np.testing.assert_allclose(c.data, jc.data,
                                                   rtol=1e-12, err_msg=f.name)
                    else:
                        np.testing.assert_array_equal(c.data, jc.data,
                                                      err_msg=f.name)


def _seg(d, i, p):
    return io.BytesIO(artifacts.fetch_segment(d, i, p))


def _two_stages(tmp_path, tbs, jbs, schema_pb, ncols, **kw):
    """Both packages through both stages; returns (port union, JAX union,
    port map plans)."""
    maps, reduces, outputs = cs._shuffle_query(
        tbs, schema_pb, str(tmp_path / "shuffle"), "q", tasks=MAPS, **kw)
    _jax_side(maps, reduces, outputs, jbs)
    os.makedirs(tmp_path / "shuffle", exist_ok=True)
    plans, _ = cs._run_map_stage(maps)
    port_files = _copy(outputs, tmp_path / "port")
    _run_jax_maps(maps)
    jax_files = _copy(outputs, tmp_path / "jax")
    state = plans[0].children[0].schema
    jstate = jdecode(maps[0])[0].children[0].schema
    _compare_map_outputs(port_files, jax_files, state, jstate)
    # the paths now hold the JAX package's files: the port's reduce stage
    # reads them; then the port's files go back for the JAX reduce stage
    got = cs._run_reduce_stage(reduces, ncols, device="cpu")
    for (d, i), (pd, pi) in zip(outputs, port_files):
        shutil.copy(pd, d)
        shutil.copy(pi, i)
    want = _jax_union(reduces, ncols)
    return got, want, plans


def _assert_unions(got, want, float_cols):
    assert got[0] == want[0]
    n = int(got[0])
    g, w = got[1:].reshape(-1, n), want[1:].reshape(-1, n)
    for k in range(g.shape[0]):
        if k in float_cols:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-12)
        else:
            np.testing.assert_array_equal(g[k], w[k])


def test_q06_across_a_shuffle(small, tmp_path):
    datas = [cs._make_data(s) for s in range(2 * MAPS)]
    jbs = [JBatch.from_numpy(d, JSCHEMA_Q06, capacity=ROWS) for d in datas]
    tbs = [ColumnBatch.from_numpy(d, cs.SCHEMA, capacity=ROWS, device="cpu")
           for d in datas]
    got, want, plans = _two_stages(tmp_path, tbs, jbs, cs.SCHEMA_PB, 3)
    assert [p.children[0].metrics["stage_compiled"] for p in plans] == \
        [1] * MAPS
    _assert_unions(got, want, {1})
    n, (keys, sums, cnts) = cs._unpack(got, 3)
    ref = cs._item_oracle(datas)
    nz = ref["cnt"] > 0
    np.testing.assert_array_equal(keys, np.nonzero(nz)[0])
    np.testing.assert_array_equal(cnts, ref["cnt"][nz])
    np.testing.assert_allclose(sums, ref["sum_amount"][nz], rtol=1e-9)


def test_customer_query_across_a_shuffle(small, tmp_path):
    datas, cust = _workload(customers=3000)
    datas, cust = datas + datas[:1], cust + cust[:1]  # 4 batches
    rid = _register(datas, cust)
    tbs = list(resources.get(rid)())
    jbs = list(jres.get(rid)())
    ncols = 1 + len(cs.GENERAL_AGGS)
    got, want, plans = _two_stages(tmp_path, tbs, jbs, cs.GENERAL_SCHEMA_PB,
                                   ncols, key="ss_customer_sk",
                                   aggs=cs.GENERAL_AGGS)
    assert [p.children[0].metrics["stage_fallbacks"] for p in plans] == \
        [1] * MAPS
    _assert_unions(got, want, {1, 3})
    cs._check_general(got, *cs._general_oracle(datas, cust))

