"""The port's per-plan callable cache (runtime/jit_cache.py) against the
JAX package's, on the CPU.

The same key sequence through both `get_or_compile`s (the JAX side with
jit=False, which builds the bare callable as the port always does) gives
the same hit and miss counts and the same observer events; a miss runs
the `jit.compile` fault point in both. End to end, a plan run twice in one
process hits its cached probe, dense-stage and fused-chain callables on
the second run and gives the same rows, and no cached callable holds a
tensor or an operator of the task that built it.
"""

import itertools

import numpy as np
import pytest
import torch

import chip_smoke as cs
from blaze_tpu.runtime import compile_service as jcompile  # noqa: F401
from blaze_tpu.runtime import faults as jfaults
from blaze_tpu.runtime import jit_cache as jjit
from blaze_tpu_torch.columnar.batch import ColumnBatch
from blaze_tpu_torch.ops.base import ExecContext, Operator
from blaze_tpu_torch.plan.from_proto import decode_task_definition
from blaze_tpu_torch.runtime import (  # noqa: F401 (registers observer)
    compile_service, faults, jit_cache, resources,
)
from blaze_tpu_torch.runtime.executor import collect, execute_plan

_ids = itertools.count()


def _keys(n_distinct=4, length=12, seed=0):
    """A seeded sequence of keys unique to this call, with repeats."""
    tag = ("test_jit_cache", next(_ids))
    rng = np.random.default_rng(seed)
    return [tag + (int(k),) for k in rng.integers(0, n_distinct, length)]


@pytest.fixture
def observed(monkeypatch):
    """Each package's observer replaced by a recorder for the test (the
    compile services' observers come back after it)."""
    events = {"port": [], "jax": []}
    for name, mod in (("port", jit_cache), ("jax", jjit)):
        monkeypatch.setattr(mod, "_observer",
                            lambda e, k, ns, out=events[name]:
                            out.append((e, k, ns)))
    return events


def _delta(before, after):
    return {k: after.get(k, 0) - before.get(k, 0) for k in after}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_stats_and_events_match_jax(observed, seed):
    keys = _keys(seed=seed)
    built = {"port": [], "jax": []}
    b0, jb0 = jit_cache.stats(), jjit.stats()
    for key in keys:
        fn = jit_cache.get_or_compile(
            key, lambda key=key: built["port"].append(key) or (lambda: key))
        jfn = jjit.get_or_compile(
            key, lambda key=key: built["jax"].append(key) or (lambda: key),
            jit=False)
        assert fn() == jfn() == key
    assert _delta(b0, jit_cache.stats()) == _delta(jb0, jjit.stats())
    assert observed["port"] == observed["jax"]
    # one build a distinct key, and a miss event before a hit of each
    assert built["port"] == built["jax"] == list(dict.fromkeys(keys))
    assert [e for e, _, _ in observed["port"]].count("miss") == len(
        set(keys))
    assert all(ns == 0 for _, _, ns in observed["port"])


def test_jit_argument_changes_nothing(observed):
    (key,) = _keys(1, 1)
    a = jit_cache.get_or_compile(key, lambda: (lambda: 1), jit=True,
                                 donate_argnums=0)
    b = jit_cache.get_or_compile(key, lambda: (lambda: 2), jit=False)
    assert a is b and a() == 1
    assert [e for e, _, _ in observed["port"]] == ["miss", "hit"]


def test_a_miss_runs_the_compile_fault_point():
    spec = {"seed": 3, "points": {"jit.compile": {"kind": "io", "nth": 1}}}
    raised = []
    for mod, flt, kw in ((jit_cache, faults, {}),
                         (jjit, jfaults, {"jit": False})):
        (key,) = _keys(1, 1)
        flt.install(spec)
        try:
            with pytest.raises(Exception) as e:
                mod.get_or_compile(key, lambda: (lambda: 0), **kw)
            raised.append((type(e.value).__name__, e.value.category))
            # the failed miss cached nothing: the next call builds
            assert mod.get_or_compile(key, lambda: (lambda: 7), **kw)() == 7
        finally:
            flt.install(None)
    assert raised[0] == raised[1] == ("RetryableError", "retryable")


def test_clear_resets_the_counts(monkeypatch):
    monkeypatch.setattr(jit_cache, "_cache", {})
    monkeypatch.setattr(jit_cache, "_stats", {"hits": 0, "misses": 0})
    (key,) = _keys(1, 1)
    jit_cache.get_or_compile(key, lambda: (lambda: 0))
    jit_cache.get_or_compile(key, lambda: (lambda: 0))
    assert jit_cache.stats() == {"hits": 1, "misses": 1}
    jit_cache.clear()
    assert jit_cache.stats() == {"hits": 0, "misses": 0}
    assert jit_cache._cache == {}


# ---- end to end ----

ROWS, N_BATCHES = 1 << 12, 4


@pytest.fixture
def small(monkeypatch):
    monkeypatch.setattr(cs, "ROWS", ROWS)
    monkeypatch.setattr(cs, "GROUPS", 1 << 10)
    batches = [ColumnBatch.from_numpy(cs._make_data(s), cs.SCHEMA,
                                      capacity=ROWS, device="cpu")
               for s in range(N_BATCHES)]
    rid = resources.register(lambda: iter(batches))
    yield rid
    resources.pop(rid)


def _rows(out) -> dict:
    d = out.to_numpy()
    order = np.argsort(np.asarray(d["ss_item_sk"]), kind="stable")
    return {k: np.asarray(v)[order] for k, v in d.items()}


def _kinds(events, kind):
    return [e for e, k, _ in events if k[0] == kind]


def test_plan_run_twice_hits_and_gives_the_same_rows(small, observed):
    """bench.py's q06 plan (the dense stage) and its agg-less chain
    streamed, each run twice from the same task bytes: the second run's
    lookups all hit, and the rows are the first run's."""
    task = cs._build_task(cs.SCHEMA_PB, small)
    first = _rows(collect(decode_task_definition(task)[0]))
    ev1 = list(observed["port"])
    second = _rows(collect(decode_task_definition(task)[0]))
    ev2 = observed["port"][len(ev1):]
    assert first.keys() == second.keys()
    for k in first:
        np.testing.assert_array_equal(first[k], second[k])
    assert _kinds(ev1, "stage") == ["miss"]
    assert _kinds(ev1, "stage_probe") == ["miss"]
    # the probe's range is memoized per plan: the second run skips it
    assert _kinds(ev2, "stage") == ["hit"] and not _kinds(ev2, "stage_probe")

    chain = pb_chain(task)
    outs = []
    for _ in range(2):
        n0 = len(observed["port"])
        plan = decode_task_definition(chain)[0]
        outs.append([b.to_numpy() for b in execute_plan(plan,
                                                        ExecContext())])
        outs[-1] = (outs[-1], _kinds(observed["port"][n0:], "fused"))
    (rows1, ev1), (rows2, ev2) = outs
    assert ev1[0] == "miss" and ev1[1:] == ["hit"] * (N_BATCHES - 1)
    assert ev2 == ["hit"] * N_BATCHES
    for a, b in zip(rows1, rows2):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def pb_chain(task: bytes) -> bytes:
    """`task` cut below its aggregates: the ffi_reader -> filter ->
    project chain alone."""
    from blaze_tpu_torch.plan import plan_pb2 as pb

    td = pb.TaskDefinition.FromString(task)
    node = td.plan
    while node.WhichOneof("node") == "agg":
        node = node.agg.input
    td.plan.CopyFrom(pb.PlanNode.FromString(node.SerializeToString()))
    return td.SerializeToString()


def _reachable(obj, seen=None):
    """Every object a callable's closures, default arguments and
    containers reach."""
    seen = set() if seen is None else seen
    if id(obj) in seen:
        return
    seen.add(id(obj))
    yield obj
    kids = []
    if callable(obj) and hasattr(obj, "__closure__"):
        kids += [c.cell_contents for c in obj.__closure__ or ()]
        kids += list(obj.__defaults__ or ())
    if isinstance(obj, (list, tuple, set, frozenset)):
        kids += list(obj)
    if isinstance(obj, dict):
        kids += list(obj.values())
    for k in kids:
        yield from _reachable(k, seen)


def test_cached_callables_hold_no_task_state(small):
    task = cs._build_task(cs.SCHEMA_PB, small)
    collect(decode_task_definition(task)[0])
    list(execute_plan(decode_task_definition(pb_chain(task))[0],
                      ExecContext()))
    cached = {k: fn for k, fn in jit_cache._cache.items()
              if k[0] in ("stage", "stage_probe", "fused")}
    assert {k[0] for k in cached} == {"stage", "stage_probe", "fused"}
    for key, fn in cached.items():
        held = list(_reachable(fn))
        assert not [o for o in held if isinstance(o, torch.Tensor)], key
        assert not [o for o in held if isinstance(o, (Operator,
                                                      ColumnBatch))], key
