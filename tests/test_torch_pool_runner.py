"""The port's `run_plan` with an active executor pool, on the CPU.

- Stage eligibility: `_pool_stage_rids` gives the JAX package's list (or
  None) for every stage of both catalogues in every join mode.
- The pooled `run_plan` (device="cpu", so the workers run on the CPU):
  the q3-shaped plan of the JAX package's pool test, and tpcds q02 and
  q04 in both join modes, give the rows of the JAX package's inline
  `run_plan` and of the port's own in-process run; `pool_stages` is the
  number of shuffle-map stages eligibility accepts, and the task metrics
  the workers report add up to the in-process run's.
- No fallback: a `plan` task whose payload names no device takes the
  card, and on a machine without CUDA it fails the task and the query.
- A pool that cannot run a stage degrades it to the in-process route
  (`pool_to_thread`), where the JAX package's run_plan raises.
- A live worker imports neither jax nor `blaze_tpu`: the pool's workers
  run with PYTHONPROFILEIMPORTTIME set, and the import log each writes to
  its `<token>.err` is read after a plan task.
- `get_all_partitions_reader` reads every partition, as the JAX
  package's does.

The pool's workers share one pool per module (count 2, slots 2), with
OMP_NUM_THREADS=1 in the environment they inherit. Float columns are held
to rtol 1e-12 against the JAX package (`_same_rows`), as
test_torch_runner.py does; integers and strings exactly.
"""

import os
import time

import numpy as np
import pytest

from blaze_tpu.columnar import types as JT
from blaze_tpu.exprs import ir as jir
from blaze_tpu.runtime import executor_pool as jep
from blaze_tpu.spark import local_runner as jlocal_runner
from blaze_tpu.spark import plan_model as JP
from blaze_tpu.spark import tpcds as jtpcds
from blaze_tpu.spark import validator as jvalidator
from blaze_tpu.spark.convert_strategy import apply_strategy as japply
from blaze_tpu.spark.stages import plan_stages as jplan_stages
from blaze_tpu_torch.columnar import types as T
from blaze_tpu_torch.exprs import ir
from blaze_tpu_torch.runtime import executor_pool as ep
from blaze_tpu_torch.runtime import faults, metrics
from blaze_tpu_torch.runtime.executor import TASK_METRICS
from blaze_tpu_torch.spark import local_runner
from blaze_tpu_torch.spark import plan_model as P
from blaze_tpu_torch.spark import tpcds, validator
from blaze_tpu_torch.spark.convert_strategy import apply_strategy
from blaze_tpu_torch.spark.stages import plan_stages
from test_torch_runner import _same_rows
from torch_parity import both_tables, no_jax_native, run_both

ROWS = 6000
TABLES = ["store_sales", "store_returns", "date_dim", "store", "item",
          "customer", "customer_address", "customer_demographics",
          "promotion", "web_sales", "catalog_sales"]
PATHS = {t: f"/data/{t}.parquet" for t in TABLES}
CATALOGUES = {"tpcds": (tpcds, jtpcds), "core": (validator, jvalidator)}


def _cells():
    for q in sorted(tpcds.QUERIES):
        for mode in ("bhj", "smj"):
            yield "tpcds", q, mode
    for q in validator.QUERIES:
        for mode in (["bhj"] if q in validator._JOINLESS else ["bhj", "smj"]):
            yield "core", q, mode


def _stages(module, apply, plan_stages_fn, q, mode, paths=PATHS,
            frames=None):
    plan, _ = module.QUERIES[q](paths, frames, mode)
    apply(plan)
    return plan_stages_fn(plan, default_partitions=4, namespace="")


@pytest.mark.parametrize("suite,q,mode", list(_cells()))
def test_pool_stage_rids_match_jax(suite, q, mode):
    port, jax = CATALOGUES[suite]
    stages = _stages(port, apply_strategy, plan_stages, q, mode)
    jstages = _stages(jax, japply, jplan_stages, q, mode)
    got = [local_runner._pool_stage_rids(s) for s in stages]
    want = [jlocal_runner._pool_stage_rids(s) for s in jstages]
    assert got == want


# ---- the shared pool ----


@pytest.fixture(scope="module")
def pool():
    saved = {k: os.environ.get(k) for k in ("OMP_NUM_THREADS",
                                            "PYTHONPROFILEIMPORTTIME")}
    os.environ["OMP_NUM_THREADS"] = "1"
    os.environ["PYTHONPROFILEIMPORTTIME"] = "1"
    try:
        p = ep.ExecutorPool(count=2, slots=2).start()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    yield p
    p.close()


@pytest.fixture
def active(pool, monkeypatch):
    no_jax_native(monkeypatch)
    ep.activate(pool)
    yield pool
    ep.deactivate(pool)


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    return both_tables(tmp_path_factory, ROWS)


def _q3_plan(tmp_path, rng, Pm, Tm, irm, n_ss=1200, n_dd=120):
    """The q3-shaped plan of the JAX package's pool test, built with one
    package's plan model over shared Parquet files."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    ss_path = str(tmp_path / "ss.parquet")
    dd_path = str(tmp_path / "dd.parquet")
    if not os.path.exists(ss_path):
        pq.write_table(pa.table({
            "ss_sold_date_sk": pa.array(rng.integers(0, n_dd, n_ss),
                                        pa.int64()),
            "ss_item_sk": pa.array(rng.integers(0, 30, n_ss), pa.int64()),
            "ss_ext_sales_price": pa.array(rng.random(n_ss) * 100),
        }), ss_path)
        pq.write_table(pa.table({
            "d_date_sk": pa.array(np.arange(n_dd), pa.int64()),
            "d_moy": pa.array((np.arange(n_dd) // 30) % 12 + 1, pa.int32()),
        }), dd_path)
    SS = Tm.Schema([Tm.Field("ss_sold_date_sk", Tm.INT64),
                    Tm.Field("ss_item_sk", Tm.INT64),
                    Tm.Field("ss_ext_sales_price", Tm.FLOAT64)])
    DD = Tm.Schema([Tm.Field("d_date_sk", Tm.INT64),
                    Tm.Field("d_moy", Tm.INT32)])
    aggs = [{"fn": "sum", "args": [irm.col("ss_ext_sales_price")],
             "dtype": Tm.FLOAT64, "name": "s"}]
    ss_x = Pm.shuffle_exchange(Pm.scan(SS, [(ss_path, [])]),
                               [irm.col("ss_sold_date_sk")], 4)
    dd_flt = Pm.filter_(Pm.scan(DD, [(dd_path, [])]),
                        irm.Binary(irm.BinOp.EQ, irm.col("d_moy"),
                                   irm.lit(3)))
    dd_x = Pm.shuffle_exchange(dd_flt, [irm.col("d_date_sk")], 4)
    j = Pm.smj(ss_x, dd_x, [irm.col("ss_sold_date_sk")],
               [irm.col("d_date_sk")], "inner",
               Tm.Schema(list(SS.fields) + list(DD.fields)))
    partial = Pm.hash_agg(j, "partial", [irm.col("ss_item_sk")], ["item"],
                          aggs, Tm.Schema([Tm.Field("item", Tm.INT64)]))
    final = Pm.hash_agg(Pm.shuffle_exchange(partial, [irm.col("item")], 4),
                        "final", [irm.col("item")], ["item"], aggs,
                        Tm.Schema([Tm.Field("item", Tm.INT64),
                                   Tm.Field("s", Tm.FLOAT64)]))
    return Pm.sort(final, [(irm.col("s"), False, True)])


def test_pooled_q3_plan_matches_jax_and_inprocess(active, tmp_path):
    rng = np.random.default_rng(0)
    info = {}
    out = local_runner.run_plan(_q3_plan(tmp_path, rng, P, T, ir), 4,
                                mesh_exchange="off", run_info=info,
                                device="cpu")
    assert info["pool_stages"] == 3 and info["file_stages"] == 0
    assert info["map_tasks_run"] == 2 + 4
    assert info["pool_kernel_launches"] == 0  # no card, no launch
    assert info.get("degradations", 0) == 0
    ep.deactivate(active)
    local = {}
    lout = local_runner.run_plan(_q3_plan(tmp_path, rng, P, T, ir), 4,
                                 mesh_exchange="off", run_info=local,
                                 device="cpu")
    assert local["pool_stages"] == 0 and local["file_stages"] == 3
    jinfo = {}
    jout = jlocal_runner.run_plan(_q3_plan(tmp_path, rng, JP, JT, jir), 4,
                                  mesh_exchange="off", run_info=jinfo)
    assert jinfo["pool_stages"] == 0
    got, want = out.to_numpy(), jout.to_numpy()
    _same_rows(got, want)
    _same_rows(lout.to_numpy(), want)
    _same_task_metrics(info, local)


def _same_task_metrics(info, local):
    """The workers' task metrics add up to the in-process run's: counts
    exactly, the scan's host time (io_time_ns) only as present or not."""
    for key in TASK_METRICS:
        if key == "io_time_ns":
            assert (info[key] > 0) == (local[key] > 0)
        else:
            assert info[key] == local[key], key


def _eligible(q, mode, paths, frames):
    """Shuffle-map stages eligibility accepts, from the static stages."""
    stages = _stages(tpcds, apply_strategy, plan_stages, q, mode, paths,
                     frames)
    return sum(1 for s in stages if s.kind == "shuffle_map"
               and local_runner._pool_stage_rids(s) is not None)


@pytest.mark.parametrize("q", ["q02", "q04"])
@pytest.mark.parametrize("mode", ["bhj", "smj"])
def test_pooled_tpcds_matches_jax_and_inprocess(active, tables, tmp_path,
                                                q, mode):
    (paths, frames), _ = tables["tpcds"]
    (rows, info), (jrows, jinfo) = run_both(tables, tmp_path / "pool",
                                            "tpcds", q, mode)
    _same_rows(rows, jrows)
    assert info["pool_stages"] == _eligible(q, mode, paths, frames) >= 1
    assert info["pool_stages"] + info["file_stages"] == \
        jinfo["file_stages"]
    assert info["map_tasks_run"] == jinfo["map_tasks_run"]
    assert info.get("degradations", 0) == 0
    ep.deactivate(active)
    plan, _ = tpcds.QUERIES[q](paths, frames, mode)
    local = {}
    lout = local_runner.run_plan(plan, 4, work_dir=str(tmp_path / "local"),
                                 mesh_exchange="off", run_info=local,
                                 device="cpu")
    _same_rows(lout.to_numpy(), rows)
    _same_task_metrics(info, local)


def test_no_device_in_payload_fails_without_cuda(active, tables, tmp_path,
                                                 monkeypatch):
    """The driver sends the run's device; strip it and the workers must
    take the card, which this machine lacks: the task and the query
    fail, and nothing runs on the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    real = active.run_tasks

    def stripped(specs, timeout=None):
        for s in specs:
            s.payload.pop("device", None)
        return real(specs, timeout)

    monkeypatch.setattr(active, "run_tasks", stripped)
    (paths, frames), _ = tables["tpcds"]
    plan, _ = tpcds.QUERIES["q02"](paths, frames, "bhj")
    info = {}
    with pytest.raises(faults.FatalError, match="CUDA"):
        local_runner.run_plan(plan, 4, work_dir=str(tmp_path),
                              mesh_exchange="off", run_info=info,
                              device="cpu")
    assert info["pool_stages"] == 0 and info["file_stages"] == 0
    assert info.get("degradations", 0) == 0


class _NoPool:
    """A pool with no live executor: every batch raises
    PoolUnavailableError, as ExecutorPool.run_tasks does once every seat
    is retired."""

    def __init__(self, mod):
        self.mod = mod
        self.server = self
        self.rids = set()

    def run_tasks(self, specs, timeout=None):
        raise self.mod.PoolUnavailableError(
            "no live executors and no replacement pending")

    def register_frames(self, rid, frames):
        self.rids.add(rid)

    def register_shuffle(self, rid, outputs):
        self.rids.add(rid)

    def registered(self):
        return sorted(self.rids)

    def unregister(self, rid):
        self.rids.discard(rid)


def test_unavailable_pool_degrades_to_thread(tables, tmp_path,
                                             monkeypatch):
    """The port degrades each stage to the in-process file route and
    answers; the JAX package's run_plan classifies PoolUnavailableError
    (a ConnectionError) fatal and raises (ROADMAP Queue 3)."""
    no_jax_native(monkeypatch)
    (paths, frames), (jpaths, jframes) = tables["tpcds"]
    ep.activate(_NoPool(ep))
    try:
        plan, _ = tpcds.QUERIES["q02"](paths, frames, "bhj")
        info = {}
        out = local_runner.run_plan(plan, 4, work_dir=str(tmp_path / "p"),
                                    mesh_exchange="off", run_info=info,
                                    device="cpu")
    finally:
        ep.deactivate()
    assert info["pool_stages"] == 0 and info["file_stages"] >= 1
    assert info["degraded.pool_to_thread"] == info["file_stages"]
    assert info["errors.resource"] == info["file_stages"]
    jep.activate(_NoPool(jep))
    try:
        jplan, _ = jtpcds.QUERIES["q02"](jpaths, jframes, "bhj")
        with pytest.raises(jep.PoolUnavailableError):
            jlocal_runner.run_plan(jplan, 4, work_dir=str(tmp_path / "j"),
                                   mesh_exchange="off")
    finally:
        jep.deactivate()
    # the port's rows are the in-process rows
    plan, _ = tpcds.QUERIES["q02"](paths, frames, "bhj")
    lout = local_runner.run_plan(plan, 4, work_dir=str(tmp_path / "l"),
                                 mesh_exchange="off", device="cpu")
    _same_rows(out.to_numpy(), lout.to_numpy())


def test_live_worker_imports_no_jax(active, tmp_path):
    rng = np.random.default_rng(1)
    info = {}
    local_runner.run_plan(_q3_plan(tmp_path, rng, P, T, ir), 4,
                          mesh_exchange="off", run_info=info, device="cpu")
    assert info["pool_stages"] == 3
    logs = {}
    for name in os.listdir(active._dir):
        if name.endswith(".err"):
            with open(os.path.join(active._dir, name)) as f:
                logs[name] = f.read()
    imported = set()
    for text in logs.values():
        for line in text.splitlines():
            if line.startswith("import time:") and "|" in line:
                imported.add(line.rsplit("|", 1)[1].strip())
    assert "blaze_tpu_torch.runtime.executor" in imported
    assert "torch" in imported
    bad = sorted(m for m in imported if m in ("jax", "blaze_tpu")
                 or m.startswith(("jax.", "blaze_tpu.")))
    assert bad == []


def test_task_tally_follows_pipeline_threads():
    """A kernel launch counts into the tally of the task it ran for,
    also on the pipeline's I/O threads (their context snapshot carries
    the tally), and nowhere else."""
    from blaze_tpu_torch.runtime import pipeline

    seen = []

    def src():
        for i in range(5):
            metrics.tally_add("kernel_launches")
            seen.append(i)
            yield i

    with metrics.task_tally() as tally:
        snap = pipeline._CtxSnapshot()
        import threading

        def run():
            with snap.replay():
                list(src())

        t = threading.Thread(target=run)
        t.start()
        t.join(timeout=30)
        metrics.tally_add("kernel_launches", 2)
    assert seen == list(range(5))
    assert tally == {"kernel_launches": 7}
    assert metrics.current_tally() is None
    metrics.tally_add("kernel_launches")  # no open tally: dropped
    assert tally == {"kernel_launches": 7}


def test_all_partitions_reader_matches_jax(tmp_path):
    """Every row of every map output comes back once through
    get_all_partitions_reader, in the JAX package's order."""
    from blaze_tpu.columnar.batch import ColumnBatch as JBatch
    from blaze_tpu.ops.base import ExecContext as JCtx
    from blaze_tpu.ops.basic import MemorySourceExec as JSrc
    from blaze_tpu.ops.shuffle import Partitioning as JPart
    from blaze_tpu.ops.shuffle import ShuffleWriterExec as JWriter
    from blaze_tpu.spark.shuffle_manager import BlazeShuffleManager as JMgr
    from blaze_tpu_torch.columnar.batch import ColumnBatch
    from blaze_tpu_torch.ops.base import ExecContext
    from blaze_tpu_torch.ops.basic import MemorySourceExec
    from blaze_tpu_torch.ops.shuffle import Partitioning, ShuffleWriterExec
    from blaze_tpu_torch.spark.shuffle_manager import BlazeShuffleManager

    rng = np.random.default_rng(3)
    datas = [{"k": rng.integers(0, 100, n).astype(np.int64),
              "v": rng.random(n)} for n in (200, 150)]
    out = []
    for tag, (Mgr, Batch, Src, Part, Writer, Ctx, Tm, irm, kw) in {
            "p": (BlazeShuffleManager, ColumnBatch, MemorySourceExec,
                  Partitioning, ShuffleWriterExec, ExecContext, T, ir,
                  {"device": "cpu"}),
            "j": (JMgr, JBatch, JSrc, JPart, JWriter, JCtx, JT, jir,
                  {})}.items():
        d = tmp_path / tag
        d.mkdir()
        schema = Tm.Schema([Tm.Field("k", Tm.INT64),
                            Tm.Field("v", Tm.FLOAT64)])
        mgr = Mgr(str(d))
        handle = mgr.register_shuffle(3, 4, schema)
        for map_id, data in enumerate(datas):
            b = Batch.from_numpy(data, schema, **kw)
            slot = mgr.get_writer(handle, map_id)
            op = Writer(Src([b], schema),
                        Part("hash", 4, [irm.col("k")]),
                        slot.data_path, slot.index_path)
            list(op.execute(Ctx(partition=map_id, num_partitions=2, **kw)))
            slot.commit()
        rows = []
        reader = (mgr.get_all_partitions_reader(handle, device="cpu")
                  if tag == "p" else mgr.get_all_partitions_reader(handle))
        for b in reader:
            d2 = b.to_numpy()
            rows.extend(zip((int(x) for x in d2["k"]),
                            (float(x) for x in d2["v"])))
        out.append(rows)
    assert len(out[0]) == 350
    assert out[0] == out[1]
    want = sorted(zip(np.concatenate([d["k"] for d in datas]).tolist(),
                      np.concatenate([d["v"] for d in datas]).tolist()))
    assert sorted(out[0]) == want


def test_dossier_executor_pool_is_pool_stats(active, tmp_path, monkeypatch):
    from blaze_tpu_torch.runtime import flight_recorder

    monkeypatch.setattr(flight_recorder.conf, "flight_dir",
                        str(tmp_path / "flight"))
    flight_recorder.reset()
    path = flight_recorder.capture("breaker_trip", f"qd{time.time_ns()}",
                                   detail={"op": "FilterExec"})
    doc = flight_recorder.load(path)
    st = doc["executor_pool"]
    assert st["count"] == 2 and st["slots"] == 2
    assert sorted(e["exec_id"] for e in st["executors"]) == [
        "exec0", "exec1"]
    ep.deactivate(active)
    path = flight_recorder.capture("breaker_trip", f"qe{time.time_ns()}",
                                   detail={})
    assert flight_recorder.load(path)["executor_pool"] is None


def test_served_requires_registered_rids():
    """A stage goes to the pool only when every rid it reads is on the
    pool's server: a shuffle the mesh kept on the card, or that a
    degraded stage wrote, is not there (`:all` reads name their base)."""

    class _Server:
        def registered(self):
            return ["q/broadcast:0", "q/shuffle:1"]

    pool = type("Pool", (), {"server": _Server()})()
    assert local_runner._served(pool, [])
    assert local_runner._served(pool, ["q/broadcast:0", "q/shuffle:1",
                                       "q/shuffle:1:all"])
    assert not local_runner._served(pool, ["q/shuffle:1", "q/shuffle:2"])
    assert not local_runner._served(pool, ["q/shuffle:2:all"])
