"""The port's durable streaming (runtime/streaming.py) against the JAX
package's, on the CPU.

Both packages tail their own directory of the same seeded Parquet files,
published one file a tick (each publish waits for the previous file to be
consumed and checkpointed, so the batches are the same in both):

- the spec's JSON round trip, its per-batch plan (stage bytes equal) and
  the TailSource's discovery;
- the state after every batch, and the checkpoint records (epochs,
  offsets, state) of the journal, across a crash after a checkpoint, a
  crash before one, and a torn checkpoint tail, each resumed by
  resume_stream;
- the recovery scan registering a dead writer's stream for adoption;
- a stream through the service: every micro-batch admitted, the stream
  left adoptable when the service closes; the per-batch log names each
  batch's route;
- the Prometheus stream series; the stall dossier, once;
- a stream that names no device fails its batches without CUDA and
  merges nothing.

Integers and keys are exact; float aggregates within rtol 1e-12. Waits
are bounded by deadlines.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest

from blaze_tpu.columnar import types as JT
from blaze_tpu.config import conf as jconf
from blaze_tpu.runtime import flight_recorder as jflight
from blaze_tpu.runtime import journal as jjournal
from blaze_tpu.runtime import monitor as jmonitor
from blaze_tpu.runtime import progress as jprogress
from blaze_tpu.runtime import service as jservice
from blaze_tpu.runtime import streaming as jstreaming
from blaze_tpu.runtime import trace as jtrace
from blaze_tpu_torch.columnar import types as T
from blaze_tpu_torch.config import conf
from blaze_tpu_torch.runtime import (flight_recorder, journal, monitor,
                                     progress, service, streaming, trace)
from torch_parity import no_jax_native

# name -> (streaming, journal, service, types, conf, run kwargs)
PKGS = {"port": (streaming, journal, service, T, conf, {"device": "cpu"}),
        "jax": (jstreaming, jjournal, jservice, JT, jconf, {})}

KNOBS = ("journal_dir", "journal_retention", "recovery_enabled",
         "flight_dir", "flight_triggers", "progress_enabled",
         "monitor_enabled", "trace_enabled", "stream_poll_ms",
         "stream_checkpoint_interval", "stream_max_lag_ms", "spill_dir")


@pytest.fixture(autouse=True)
def env(monkeypatch, tmp_path):
    no_jax_native(monkeypatch)
    for name, c in (("port", conf), ("jax", jconf)):
        for k in KNOBS:
            monkeypatch.setattr(c, k, getattr(c, k))
        c.journal_dir = str(tmp_path / name / "journal")
        c.spill_dir = str(tmp_path / name / "spill")
        c.journal_retention = 256
        c.recovery_enabled = True
        c.flight_dir = ""
        c.progress_enabled = True
        c.stream_poll_ms = 10
        c.stream_checkpoint_interval = 1
        c.stream_max_lag_ms = 10000
    mods = (journal, flight_recorder, progress, jjournal, jflight,
            jprogress)
    for m in mods:
        m.reset()
    yield
    for m in (streaming, jstreaming) + mods + (trace, monitor, jtrace,
                                               jmonitor):
        m.reset()


def _spec(mod, types):
    schema = types.Schema([types.Field("k", types.INT64),
                           types.Field("amount", types.FLOAT64)])
    return mod.StreamSpec(
        schema, keys=[{"col": "k", "name": "k"}],
        aggs=[{"fn": "sum", "col": "amount", "name": "amount_sum"},
              {"fn": "count", "col": "amount", "name": "n"},
              {"fn": "min", "col": "amount", "name": "amount_min"},
              {"fn": "max", "col": "amount", "name": "amount_max"}])


def _frame(seed, rows=60):
    r = np.random.default_rng(seed)
    return pd.DataFrame({"k": r.integers(0, 5, rows).astype("int64"),
                         "amount": r.normal(10.0, 3.0, rows)})


def _publish(src, i, df):
    src.publish(f"part-{i:04d}.parquet",
                pa.Table.from_pandas(df, preserve_index=False))


def _oracle(frames):
    return (pd.concat(frames).groupby("k", as_index=False)
            .agg(amount_sum=("amount", "sum"), n=("amount", "count"),
                 amount_min=("amount", "min"), amount_max=("amount", "max"))
            .sort_values("k").reset_index(drop=True))


FLOATS = ("amount_sum", "amount_min", "amount_max")


def _same_state(rows, jrows):
    """result_rows of the two packages: keys and counts exact, floats
    within rtol 1e-12."""
    assert [r["k"] for r in rows] == [r["k"] for r in jrows]
    assert [r["n"] for r in rows] == [r["n"] for r in jrows]
    for c in FLOATS:
        np.testing.assert_allclose([r[c] for r in rows],
                                   [r[c] for r in jrows], rtol=1e-12)


def _oracle_equal(rows, frames):
    want = _oracle(frames)
    assert [r["k"] for r in rows] == list(want["k"])
    assert [r["n"] for r in rows] == list(want["n"])
    for c in FLOATS:
        np.testing.assert_allclose([r[c] for r in rows],
                                   want[c].to_numpy(), rtol=1e-12)


def _checkpoints(jmod, stream_id, c):
    """(epoch, offsets, rows_total, state) of every checkpoint record."""
    recs = jmod.load_records(jmod.journal_path(stream_id, c.journal_dir))
    return [(r["epoch"], r["offsets"], r["rows_total"], r["state"])
            for r in recs if r.get("kind") == "stream_checkpoint"]


def _same_checkpoints(a, b):
    assert [x[:3] for x in a] == [x[:3] for x in b]
    for (*_, sa), (*_, sb) in zip(a, b):
        assert [k for k, _ in sa] == [k for k, _ in sb]
        for (_, va), (_, vb) in zip(sa, sb):
            assert va["n"] == vb["n"]
            for c in FLOATS:
                assert va[c] == pytest.approx(vb[c], rel=1e-12)


def _wait(cond, timeout=60.0, what="condition"):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, f"timed out waiting: {what}"
        time.sleep(0.02)


def _both(tmp_path, body):
    """Run body(name, streaming, journal, service, types, conf, kw, dir)
    for each package; returns {name: result}."""
    out = {}
    for name, (mod, jmod, svc, types, c, kw) in PKGS.items():
        out[name] = body(name, mod, jmod, svc, types, c, kw,
                         tmp_path / name)
    return out


# ---- spec, plan and source ----


def test_spec_plan_and_source_match_jax(tmp_path):
    from blaze_tpu.spark.convert_strategy import apply_strategy as japply
    from blaze_tpu.spark.stages import plan_stages as jstages
    from blaze_tpu_torch.spark.convert_strategy import apply_strategy
    from blaze_tpu_torch.spark.stages import plan_stages

    docs, stage_bytes = [], []
    for name, (mod, _j, _s, types, _c, _kw) in PKGS.items():
        spec = _spec(mod, types)
        doc = json.loads(json.dumps(spec.to_doc()))
        spec2 = mod.StreamSpec.from_doc(doc)
        assert spec2.key_names() == ["k"]
        assert spec2.agg_names() == ["amount_sum", "n", "amount_min",
                                     "amount_max"]
        docs.append(doc)
        with pytest.raises(ValueError):
            mod.StreamSpec(spec.schema, [{"col": "k", "name": "k"}],
                           [{"fn": "median", "col": "amount", "name": "m"}])
        with pytest.raises(ValueError):
            mod.StreamSpec(spec.schema, [], [])
        plan = spec2.build_plan(["/data/a.parquet", "/data/b.parquet"], 3)
        apply, stages = ((apply_strategy, plan_stages) if name == "port"
                         else (japply, jstages))
        apply(plan)
        stage_bytes.append([s.plan.SerializeToString()
                            for s in stages(plan, default_partitions=2,
                                            namespace="")])
        src = mod.TailSource(str(tmp_path / name / "in"))
        assert src.discover({}) == []
        _publish(src, 0, _frame(0))
        with open(os.path.join(src.directory, "part-x.parquet.inprogress"),
                  "wb") as f:
            f.write(b"torn")
        assert src.discover({}) == ["part-0000.parquet"]
        assert src.rows_in("part-0000.parquet") == 60
        assert src.lag_ms({"part-0000.parquet": 60}) == 0.0
        src2 = mod.TailSource.from_doc(src.to_doc())
        assert (src2.directory, src2.pattern) == (src.directory,
                                                  src.pattern)
    assert docs[0] == docs[1]
    assert stage_bytes[0] == stage_bytes[1] and len(stage_bytes[0]) == 2


# ---- the micro-batch loop and the checkpoint protocol ----


def _feed(mod, sq, src, frames, start=0):
    for i, df in enumerate(frames[start:], start):
        _publish(src, i, df)
        assert sq.wait_consumed(i + 1), (mod.__name__, i)


def test_incremental_batches_match_jax(tmp_path):
    frames = [_frame(i) for i in range(4)]

    def body(name, mod, jmod, _svc, types, c, kw, d):
        src = mod.TailSource(str(d / "in"))
        sq = mod.open_stream(src, _spec(mod, types), stream_id="st-inc",
                             work_dir=str(d / "work"), **kw)
        try:
            states = []
            for i in range(len(frames)):
                _feed(mod, sq, src, frames[:i + 1], start=i)
                states.append(sq.result_rows())
            st = sq.stats()
        finally:
            sq.stop(graceful=True)
        recs = jmod.load_records(jmod.journal_path("st-inc", c.journal_dir))
        assert jmod.is_complete(recs)
        return states, st, _checkpoints(jmod, "st-inc", c), sq

    out = _both(tmp_path, body)
    (states, st, ckpts, sq), (jstates, jst, jckpts, _) = (out["port"],
                                                         out["jax"])
    for rows, jrows in zip(states, jstates):
        _same_state(rows, jrows)
    _oracle_equal(states[-1], frames)
    keys = ("epoch", "batches_total", "rows_total", "files_consumed",
            "groups", "batch_failures", "resumed_batches")
    assert {k: st[k] for k in keys} == {k: jst[k] for k in keys}
    assert st["batches_total"] == 4 and st["rows_total"] == 240
    _same_checkpoints(ckpts, jckpts)
    assert [e for e, *_ in ckpts] == [1, 2, 3, 4]
    # the port's per-batch log: one entry a batch, each naming its route
    assert [b["epoch"] for b in sq.batch_log] == [1, 2, 3, 4]
    for b in sq.batch_log:
        assert b["files"] == 1 and b["rows"] == 60
        assert b["stage_compiled"] + b["stage_fallbacks"] >= 1


def test_crash_after_checkpoint_resumes_like_jax(tmp_path):
    frames = [_frame(10 + i) for i in range(3)]

    def body(name, mod, jmod, _svc, types, c, kw, d):
        src = mod.TailSource(str(d / "in"))
        sq = mod.open_stream(src, _spec(mod, types), stream_id="st-res",
                             work_dir=str(d / "work"), **kw)
        _feed(mod, sq, src, frames[:2])
        first_epoch = sq.stats()["epoch"]
        sq.stop(graceful=False)  # crash posture: journal NOT settled
        recs = jmod.load_records(jmod.journal_path("st-res", c.journal_dir))
        assert not jmod.is_complete(recs)
        _publish(src, 2, frames[2])
        sq2 = mod.resume_stream("st-res", work_dir=str(d / "w2"), **kw)
        try:
            assert sq2.resumed_from_epoch == first_epoch == 2
            assert sq2.wait_consumed(3)
            return (sq2.result_rows(), sq2.stats(),
                    _checkpoints(jmod, "st-res", c))
        finally:
            sq2.stop(graceful=True)

    out = _both(tmp_path, body)
    (rows, st, ck), (jrows, jst, jck) = out["port"], out["jax"]
    _same_state(rows, jrows)
    _oracle_equal(rows, frames)  # nothing dropped, nothing merged twice
    assert st["batches_total"] == jst["batches_total"] == 1
    assert st["resumed_batches"] == jst["resumed_batches"] == 1
    assert st["epoch"] == jst["epoch"] == 3
    _same_checkpoints(ck, jck)
    assert [e for e, *_ in ck] == [1, 2, 3]


def test_crash_before_checkpoint_reprocesses_like_jax(tmp_path):
    frames = [_frame(20), _frame(21)]

    def body(name, mod, jmod, _svc, types, c, kw, d):
        c.stream_checkpoint_interval = 100  # batch commits, no checkpoint
        src = mod.TailSource(str(d / "in"))
        _publish(src, 0, frames[0])
        sq = mod.open_stream(src, _spec(mod, types), stream_id="st-pre",
                             work_dir=str(d / "work"), **kw)
        _wait(lambda: sq.stats()["files_consumed"] >= 1)
        assert _checkpoints(jmod, "st-pre", c) == []
        sq.stop(graceful=False)
        c.stream_checkpoint_interval = 1
        _publish(src, 1, frames[1])
        sq2 = mod.resume_stream("st-pre", work_dir=str(d / "w2"), **kw)
        try:
            assert sq2.resumed_from_epoch is None
            assert sq2.wait_consumed(2)
            return sq2.result_rows(), _checkpoints(jmod, "st-pre", c)
        finally:
            sq2.stop(graceful=True)

    out = _both(tmp_path, body)
    (rows, ck), (jrows, jck) = out["port"], out["jax"]
    _same_state(rows, jrows)
    _oracle_equal(rows, frames)  # the in-flight batch merged once
    _same_checkpoints(ck, jck)


def test_torn_checkpoint_tail_falls_back_like_jax(tmp_path):
    frames = [_frame(30 + i) for i in range(3)]

    def body(name, mod, jmod, _svc, types, c, kw, d):
        src = mod.TailSource(str(d / "in"))
        sq = mod.open_stream(src, _spec(mod, types), stream_id="st-torn",
                             work_dir=str(d / "work"), **kw)
        _feed(mod, sq, src, frames[:2])
        good_epoch = sq.stats()["epoch"]
        sq.stop(graceful=False)
        jpath = jmod.journal_path("st-torn", c.journal_dir)
        with open(jpath, "ab") as f:
            f.write(b'{"kind": "stream_checkpoint", "epoch": 99, '
                    b'"offsets": {"bogus-file.parquet": 1, "tr')
        _publish(src, 2, frames[2])
        sq2 = mod.resume_stream("st-torn", work_dir=str(d / "w2"), **kw)
        try:
            assert sq2.resumed_from_epoch == good_epoch
            assert "bogus-file.parquet" not in sq2.offsets
            assert sq2.wait_consumed(3)
            rows = sq2.result_rows()
        finally:
            sq2.stop(graceful=True)
        with open(jpath, "rb") as f:
            lines = f.read().splitlines()
        assert sum(1 for ln in lines if b'"epoch": 99' in ln) == 1
        json.loads(lines[-1])  # post-heal appends are whole records
        return rows, [json.loads(ln)["kind"] for ln in lines
                      if b'"epoch": 99' not in ln]

    out = _both(tmp_path, body)
    (rows, kinds), (jrows, jkinds) = out["port"], out["jax"]
    _same_state(rows, jrows)
    _oracle_equal(rows, frames)
    assert kinds == jkinds


def _dead_pid() -> int:
    p = subprocess.Popen([sys.executable, "-c", "pass"])
    p.wait()
    return p.pid


def test_recovery_scan_adopts_dead_writer_streams_like_jax(tmp_path):
    frame = _frame(41)

    def body(name, mod, jmod, _svc, types, c, kw, d):
        c.flight_dir = str(d / "flight")
        src = mod.TailSource(str(d / "in"))
        _publish(src, 0, frame)
        jnl = jmod.QueryJournal("st-dead")
        jnl.record("admitted", tenant_id="acme", pid=_dead_pid())
        jnl.record("stream_open", pid=0, tenant_id="acme",
                   spec=_spec(mod, types).to_doc(), source=src.to_doc(),
                   num_partitions=2, shuffle_parts=2, mesh_exchange="off",
                   resumed_from_epoch=None)
        summary = jmod.ensure_recovery_scan(force=True)
        assert os.path.exists(jnl.path)
        adoptable = sorted(mod.adoptable_streams())
        sq = mod.resume_stream("st-dead", work_dir=str(d / "w"), **kw)
        try:
            assert mod.adoptable_streams() == {}  # consume-once
            assert sq.wait_consumed(1)
            return (summary, adoptable, sq.result_rows(), sq.tenant_id,
                    os.listdir(c.flight_dir)
                    if os.path.isdir(c.flight_dir) else [])
        finally:
            sq.stop(graceful=True)

    out = _both(tmp_path, body)
    port, jax = out["port"], out["jax"]
    assert port[0] == jax[0]
    assert port[0]["streams_adoptable"] == 1 and port[0]["billed_failed"] == 0
    assert port[1] == jax[1] == ["st-dead"]
    _same_state(port[2], jax[2])
    _oracle_equal(port[2], [frame])
    assert port[3] == jax[3] == "acme"
    assert port[4] == jax[4] == []  # adopted, not billed: no dossier


# ---- the service, the exporters, the stall dossier, the device ----


def test_service_stream_admitted_per_batch_like_jax(tmp_path):
    frames = [_frame(60), _frame(61)]

    def body(name, mod, jmod, svc_mod, types, c, kw, d):
        src = mod.TailSource(str(d / "in"))
        _publish(src, 0, frames[0])
        with svc_mod.QueryService(max_concurrent=2) as svc:
            sq = svc.open_stream(src, _spec(mod, types), tenant_id="acme",
                                 stream_id="st-svc",
                                 work_dir=str(d / "work"), **kw)
            assert sq.wait_consumed(1)
            _publish(src, 1, frames[1])
            assert sq.wait_consumed(2)
            st = svc.stats()
            rows = sq.result_rows()
        assert not sq.alive()
        recs = jmod.load_records(jmod.journal_path("st-svc", c.journal_dir))
        assert not jmod.is_complete(recs)  # adoptable for the next driver
        sq2 = mod.resume_stream("st-svc", work_dir=str(d / "w2"), **kw)
        try:
            resumed = sq2.resumed_from_epoch
            rows2 = sq2.result_rows()
        finally:
            sq2.stop(graceful=True)
        return st, rows, resumed, rows2

    out = _both(tmp_path, body)
    (st, rows, resumed, rows2), (jst, jrows, jresumed, jrows2) = (
        out["port"], out["jax"])
    assert st == jst
    assert st["streams"] == 1 and st["admitted"] == 2
    assert st["rejected"] == 0 and st["running"] == 0
    _same_state(rows, jrows)
    _oracle_equal(rows, frames)
    assert resumed == jresumed == 2
    _same_state(rows2, rows)


def test_stream_gauges_match_jax(tmp_path):
    def body(name, mod, jmod, _svc, types, c, kw, d):
        mon = monitor if name == "port" else jmonitor
        c.monitor_enabled = True
        mon.reset()
        src = mod.TailSource(str(d / "in"))
        _publish(src, 0, _frame(51))
        sq = mod.open_stream(src, _spec(mod, types), stream_id="st-gauge",
                             work_dir=str(d / "work"), **kw)
        try:
            assert sq.wait_consumed(1)
            text = mon.prometheus_text()
        finally:
            sq.stop(graceful=True)
        assert 'blaze_query_progress_ratio{qid="st-gauge"}' not in text
        return [ln.rsplit(" ", 1)[0] for ln in text.splitlines()
                if "blaze_stream_" in ln]

    out = _both(tmp_path, body)
    assert out["port"] == out["jax"]
    assert 'blaze_stream_batches_total{qid="st-gauge"}' in out["port"]


def test_stream_stall_dossier_exactly_once(tmp_path):
    conf.flight_dir = str(tmp_path / "flight")
    conf.flight_triggers = "all"
    conf.stream_max_lag_ms = 1
    src = streaming.TailSource(str(tmp_path / "in"))
    bad = os.path.join(src.directory, "part-0000.parquet")
    os.makedirs(src.directory)
    with open(bad, "wb") as f:
        f.write(b"not a parquet file")
    old = time.time() - 120
    os.utime(bad, (old, old))
    sq = streaming.open_stream(src, _spec(streaming, T),
                               stream_id="st-stall",
                               work_dir=str(tmp_path / "work"),
                               device="cpu")
    try:
        _wait(lambda: sq.stats()["batch_failures"] >= 2)
        stalls = [d for d in flight_recorder.list_dossiers()
                  if d["trigger"] == "stream_stall"]
        assert len(stalls) == 1
        assert stalls[0]["query_id"] == "st-stall"
    finally:
        sq.stop(graceful=False)


def test_stream_without_a_device_fails_its_batches_without_cuda(tmp_path):
    """No device named: each micro-batch's run_plan takes the card, and
    with no CUDA it raises; the stream counts the failure, merges
    nothing and consumes no file."""
    import torch

    assert not torch.cuda.is_available()
    src = streaming.TailSource(str(tmp_path / "in"))
    _publish(src, 0, _frame(70))
    sq = streaming.open_stream(src, _spec(streaming, T), stream_id="st-dev",
                               work_dir=str(tmp_path / "work"))
    try:
        _wait(lambda: sq.stats()["batch_failures"] >= 1)
        st = sq.stats()
        assert "needs a CUDA device" in sq.error
        assert st["files_consumed"] == 0 and st["groups"] == 0
        assert st["batches_total"] == 0 and sq.batch_log == []
    finally:
        sq.stop(graceful=False)
