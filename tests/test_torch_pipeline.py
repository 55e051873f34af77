"""The port's pipelined streams (runtime/pipeline.py) against the JAX
package's, on the CPU.

Each of the five contracts of the module holds, as in
tests/test_pipeline.py: ordered (a pipelined stream yields the serial
stream's items in order, as the JAX package's does on the same seeded
stream), bounded (at most `depth` items produced ahead, their bytes
reserved against the MemManager, one item always allowed), error relay
(a producer's error surfaces after the items before it, classified
unchanged), kill relay (a kill surfaces through a blocked producer within
a poll tick, and teardown leaks no stream or reservation) and correlated
(the trace ids and the supervisor's attempt of the opening thread are
replayed on the pool). The write-side Sink keeps submit order, relays its
worker's error and aborts cleanly. A shuffle map stage written with the
pipeline on gives `.data`/`.index` files byte-identical to the port's
with it off and to the JAX package's.
"""

import threading
import time

import numpy as np
import pytest

from blaze_tpu.exprs import ir as jir
from blaze_tpu.ops import shuffle as JS
from blaze_tpu.ops.base import ExecContext as JCtx
from blaze_tpu.ops.basic import MemorySourceExec as JMem
from blaze_tpu.runtime import pipeline as jpipeline
from blaze_tpu.runtime.executor import execute_plan as jexec
from blaze_tpu_torch.config import conf
from blaze_tpu_torch.exprs import ir
from blaze_tpu_torch.ops import shuffle as S
from blaze_tpu_torch.ops.base import (
    ExecContext, SpeculationLostError, TaskKilledError,
)
from blaze_tpu_torch.ops.basic import MemorySourceExec
from blaze_tpu_torch.runtime import faults, pipeline, trace
from blaze_tpu_torch.runtime import memory as M
from blaze_tpu_torch.runtime import supervisor
from torch_parity import no_jax_native


@pytest.fixture(autouse=True)
def _clean_pipeline(monkeypatch, tmp_path):
    saved = {k: getattr(conf, k) for k in
             ("enable_pipeline", "io_threads", "prefetch_batches",
              "trace_enabled")}
    monkeypatch.setattr(conf, "spill_dir", str(tmp_path / "spill"))
    no_jax_native(monkeypatch)
    yield
    for k, v in saved.items():
        setattr(conf, k, v)
    faults.install(None)
    faults.reset_telemetry()
    trace.reset()
    assert pipeline.live_streams() == 0


def _seeded(seed, n=257):
    return [int(x) for x in np.random.default_rng(seed).integers(0, 1 << 40,
                                                               n)]


# ---- ordered ----

@pytest.mark.parametrize("seed,depth", [(1, 1), (2, 4), (3, 16)])
def test_ordered_like_jax(seed, depth):
    items = _seeded(seed)
    got = list(pipeline.prefetch(iter(items), depth))
    assert got == list(jpipeline.prefetch(iter(items), depth)) == items
    assert pipeline.live_streams() == 0


def test_offload_applies_fn_in_order_like_jax():
    items = _seeded(4, 60)
    got = list(pipeline.offload(iter(items), lambda x: x % 97, 3))
    assert got == list(jpipeline.offload(iter(items), lambda x: x % 97, 3))


def test_disabled_and_nonconcurrent_specs_are_serial():
    conf.enable_pipeline = False
    s = pipeline.prefetch(iter(range(5)))
    assert not isinstance(s, pipeline.PrefetchStream)
    assert list(s) == list(range(5))
    conf.enable_pipeline = True
    faults.install({"seed": 1, "points": {}})
    assert not pipeline.enabled()
    faults.install({"seed": 1, "concurrent": True, "points": {}})
    assert pipeline.enabled()


# ---- bounded ----

def test_queue_holds_at_most_depth_ahead():
    produced = []

    def gen():
        i = 0
        while True:
            produced.append(i)
            yield i
            i += 1

    s = pipeline.prefetch(gen(), 3)
    time.sleep(0.2)
    assert len(produced) <= 4, produced  # 3 queued, 1 in the pump's hand
    next(s)
    next(s)
    time.sleep(0.2)
    assert len(produced) <= 6, produced
    s.close()


def test_reservations_and_backpressure():
    mgr = M.MemManager(total=500)
    produced = []

    def gen():
        for i in range(100):
            produced.append(i)
            yield i

    # every 600-byte item alone is over the budget: one undelivered item
    s = pipeline.prefetch(gen(), 8, manager=mgr, charge=lambda _: 600)
    deadline = time.monotonic() + 10
    while mgr.pipeline_reserved == 0 and time.monotonic() < deadline:
        time.sleep(0.01)
    time.sleep(0.2)  # room to run ahead, which it must not
    assert mgr.pipeline_reserved == 600 and len(produced) == 1
    assert [next(s), next(s), next(s)] == [0, 1, 2]
    s.close()
    assert mgr.pipeline_reserved == 0 and mgr.mem_used() == 0


def test_one_item_always_allowed():
    mgr = M.MemManager(total=1000)

    class Hog(M.MemConsumer):
        def mem_used(self):
            return 5000

    mgr.register(Hog())
    s = pipeline.prefetch(iter(range(10)), 4, manager=mgr,
                          charge=lambda _: 100)
    assert list(s) == list(range(10))
    assert mgr.pipeline_reserved == 0


# ---- error relay ----

def test_error_relays_after_preceding_items_like_jax():
    outs = []
    for mod in (pipeline, jpipeline):
        def gen():
            yield 1
            yield 2
            raise ValueError("boom")

        got = []
        with pytest.raises(ValueError, match="boom"):
            for x in mod.prefetch(gen(), 2):
                got.append(x)
        outs.append(got)
    assert outs == [[1, 2], [1, 2]]


def test_pool_error_stays_classified():
    def gen():
        yield 1
        raise faults.ResourceExhaustedError("device memory")

    with pytest.raises(faults.ResourceExhaustedError) as ei:
        list(pipeline.prefetch(gen(), 2))
    assert faults.classify(ei.value) == "resource"


def test_io_prefetch_point_fires_on_the_pool():
    faults.install({"seed": 3, "concurrent": True,
                    "points": {"io.prefetch": {"kind": "io", "nth": 3}}})
    got = []
    with pytest.raises(faults.RetryableError, match="io.prefetch"):
        for x in pipeline.prefetch(iter(range(10)), 2):
            got.append(x)
    assert got == [0, 1]


# ---- kill relay ----

def test_kill_surfaces_through_a_blocked_producer():
    killed = threading.Event()
    entered = threading.Event()

    def gen():
        yield 0
        entered.set()
        time.sleep(1.0)  # a blocked read
        yield 1

    ctx = ExecContext(is_running=lambda: not killed.is_set(), device="cpu")
    s = pipeline.prefetch(gen(), 2, ctx=ctx)
    assert next(s) == 0
    entered.wait(2.0)
    killed.set()
    t0 = time.monotonic()
    with pytest.raises(TaskKilledError):
        next(s)
        next(s)
    assert time.monotonic() - t0 < 0.9
    s.close()


def test_speculation_loser_quiesces():
    mgr = M.MemManager(total=1 << 30)
    lost = threading.Event()
    ctx = ExecContext(is_running=lambda: not lost.is_set(), device="cpu",
                      mem_manager=mgr)
    src = iter(range(1000))
    s = pipeline.prefetch(src, 4, ctx=ctx, manager=mgr, charge=lambda _: 10)
    assert next(s) == 0
    lost.set()
    with pytest.raises(TaskKilledError):
        while True:
            next(s)
    s.close()
    assert mgr.pipeline_reserved == 0
    before = next(src)
    time.sleep(0.1)
    assert next(src) == before + 1  # no production after teardown
    assert issubclass(SpeculationLostError, TaskKilledError)


# ---- correlated ----

def test_trace_ids_and_attempt_replayed_on_the_pool():
    conf.trace_enabled = True
    trace.reset()
    seen = []
    marker = object()

    def gen():
        seen.append((trace.current_context(),
                     getattr(supervisor._current, "attempt", None)))
        yield 1

    supervisor._current.attempt = marker
    try:
        with trace.context(query_id="qP", stage_id=7, task_id="map[7:0]"):
            assert list(pipeline.prefetch(gen(), 2)) == [1]
    finally:
        supervisor._current.attempt = None
    ctx, att = seen[0]
    assert (ctx["query_id"], ctx["stage_id"], ctx["task_id"]) == (
        "qP", 7, "map[7:0]")
    assert att is marker
    stats = [r for r in trace.TRACE.snapshot()
             if r["kind"] == "pipeline_stats"]
    assert stats and stats[0]["query_id"] == "qP"


# ---- the sink ----

def test_sink_keeps_submit_order_and_relays_errors():
    out = []
    sink = pipeline.Sink(out.append, depth=2)
    for i in range(50):
        sink.submit(i, 8)
    sink.close()
    assert out == list(range(50))

    def fail(x):
        if x == 3:
            raise faults.RetryableError("write failed")

    sink = pipeline.Sink(fail, depth=2)
    with pytest.raises(faults.RetryableError):
        for i in range(20):
            sink.submit(i)
            time.sleep(0.005)
        sink.close()
    sink.abort()


def test_sink_abort_releases_reservations():
    mgr = M.MemManager(total=1 << 30)
    gate = threading.Event()
    sink = pipeline.Sink(lambda x: gate.wait(2.0), depth=4, manager=mgr)
    for i in range(4):
        sink.submit(i, 100)
    assert mgr.pipeline_reserved > 0
    gate.set()
    sink.abort()
    assert mgr.pipeline_reserved == 0


def test_sink_inline_when_disabled():
    conf.enable_pipeline = False
    main = threading.current_thread()
    seen = []
    sink = pipeline.Sink(lambda x: seen.append(threading.current_thread()))
    sink.submit(1)
    sink.close()
    assert seen == [main]


# ---- the map stage's bytes ----

@pytest.mark.parametrize("kind,P", [("hash", 7), ("round_robin", 5)])
def test_map_output_bytes_pipelined_serial_and_jax(tmp_path, kind, P):
    from test_torch_serde import _pair

    pairs = [_pair(n, cap, seed=s) for s, (n, cap) in
             enumerate([(500, 512), (200, 1024), (61, 512), (300, 512)])]
    keys = ("c5", "c9", "c4") if kind == "hash" else ()
    files = {}
    for on in (True, False):
        conf.enable_pipeline = on
        d, i = str(tmp_path / f"t{on}.data"), str(tmp_path / f"t{on}.index")
        w = S.ShuffleWriterExec(
            MemorySourceExec([t for _, t in pairs], pairs[0][1].schema),
            S.Partitioning(kind, P, tuple(ir.col(k) for k in keys)), d, i)
        list(w.execute(ExecContext(partition=2, num_partitions=3,
                                   device="cpu")))
        files[on] = (open(d, "rb").read(), open(i, "rb").read())
    jd, ji = str(tmp_path / "j.data"), str(tmp_path / "j.index")
    jw = JS.ShuffleWriterExec(
        JMem([j for j, _ in pairs], pairs[0][0].schema),
        JS.Partitioning(kind, P, tuple(jir.col(k) for k in keys)), jd, ji)
    list(jexec(jw, JCtx(partition=2, num_partitions=3)))
    assert files[True] == files[False] == (open(jd, "rb").read(),
                                           open(ji, "rb").read())
    assert pipeline.TELEMETRY["sinks_opened"] >= 1
