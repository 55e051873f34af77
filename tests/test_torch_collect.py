"""collect_list and collect_set in the port's AggExec against the JAX
package's, on the CPU.

Both packages aggregate the same seeded batches: int64 keys with a null
group, int64, float64 (NaN, -0.0 and 0.0 among the values) and string
values with nulls, in PARTIAL -> FINAL and PARTIAL -> PARTIAL_MERGE ->
FINAL, with a collapse threshold low enough that state merges run
repeatedly, and under a memory budget small enough that the state spills
through the serde. The outputs must be equal bit for bit: keys, list
lengths, list elements and their order inside each list (Spark leaves the
order open; the JAX package's is the parity target), and a group whose
values are all null collects an empty list.
"""

import numpy as np
import pytest

from blaze_tpu.columnar import types as JT
from blaze_tpu.columnar.batch import ColumnBatch as JBatch
from blaze_tpu.exprs import ir as jir
from blaze_tpu.ops import agg as jagg
from blaze_tpu.ops.base import ExecContext as JCtx
from blaze_tpu.ops.basic import MemorySourceExec as JMem
from blaze_tpu.runtime import memory as JM
from blaze_tpu.runtime.executor import collect as jcollect
from blaze_tpu_torch.columnar import serde
from blaze_tpu_torch.columnar import types as TT
from blaze_tpu_torch.columnar.batch import ColumnBatch
from blaze_tpu_torch.exprs import ir
from blaze_tpu_torch.ops import agg
from blaze_tpu_torch.ops.base import ExecContext
from blaze_tpu_torch.ops.basic import MemorySourceExec
from blaze_tpu_torch.runtime import memory as M
from blaze_tpu_torch.runtime.executor import collect

FIELDS = [("k", "INT64"), ("v", "INT64"), ("f", "FLOAT64"),
          ("s", "STRING")]
CHAINS = {"two": ("PARTIAL", "FINAL"),
          "three": ("PARTIAL", "PARTIAL_MERGE", "FINAL")}


def _batches(seed, sizes, nkeys=7, null_frac=0.25, key_nulls=True):
    rng = np.random.default_rng(seed)
    js = JT.Schema([JT.Field(n, getattr(JT, k)) for n, k in FIELDS])
    ts = TT.Schema([TT.Field(n, getattr(TT, k)) for n, k in FIELDS])
    jbs, tbs = [], []
    for n in sizes:
        data = {"k": rng.integers(0, nkeys, n).astype(np.int64),
                "v": rng.integers(0, 5, n).astype(np.int64),
                "f": rng.choice([np.nan, 0.0, -0.0, 1.5, -2.25, np.inf], n),
                "s": ["s" * int(j) + str(int(j)) for j in
                      rng.integers(0, 6, n)]}
        valid = {c: rng.random(n) > null_frac for c in ("v", "f", "s")}
        if key_nulls:
            valid["k"] = rng.random(n) > 0.1
        jbs.append(JBatch.from_numpy(data, js, validity=valid))
        tbs.append(ColumnBatch.from_numpy(data, ts, validity=valid,
                                          device="cpu"))
    return jbs, tbs


def _calls(A, I, T, fns):
    out = []
    for fn, col in fns:
        dt = getattr(T, dict(FIELDS)[col])
        if fn.startswith("collect"):
            dt = T.list_of(dt)
        out.append(A.AggCall(fn, (I.col(col),), dt, f"{fn}_{col}"))
    return out


def _run(pkg, batches, fns, chain, threshold, budget=None):
    if pkg == "jax":
        A, I, T, Mem = jagg, jir, JT, JMem
    else:
        A, I, T, Mem = agg, ir, TT, MemorySourceExec
    node = Mem(batches, batches[0].schema)
    calls = _calls(A, I, T, fns)
    for mode in chain:
        node = A.AggExec(node, [I.col("k")], ["k"], calls,
                         getattr(A.AggMode, mode),
                         collapse_threshold=threshold)
    if pkg == "jax":
        ctx = JCtx(mem_manager=JM.MemManager(budget) if budget else None)
        return jcollect(node, ctx).to_numpy(), node
    ctx = ExecContext(device="cpu",
                      mem_manager=M.MemManager(budget) if budget else None)
    return collect(node, ctx).to_numpy(), node


def _norm(v):
    if isinstance(v, (list, tuple, np.ndarray)):
        return [_norm(x) for x in v]
    if isinstance(v, float) and np.isnan(v):
        return "nan"
    if hasattr(v, "item"):
        return _norm(v.item())
    return v


def _assert_equal(got, want):
    assert list(got) == list(want)
    for k in want:
        g, w = _norm(got[k]), _norm(want[k])
        assert g == w, k
        if not k.startswith("collect"):
            continue
        # bit for bit: -0.0 and 0.0 are different elements of a list
        gb = [np.signbit(x) for row in got[k] if row is not None
              for x in row if isinstance(x, (float, np.floating))]
        wb = [np.signbit(x) for row in want[k] if row is not None
              for x in row if isinstance(x, (float, np.floating))]
        assert gb == wb, k


FNS = [("collect_list", "v"), ("collect_set", "v"), ("collect_list", "f"),
       ("collect_set", "f"), ("collect_list", "s"), ("collect_set", "s")]


@pytest.mark.parametrize("chain", sorted(CHAINS))
@pytest.mark.parametrize("seed,threshold", [(0, 1 << 20), (1, 70)])
def test_collect_matches_jax(chain, seed, threshold):
    jbs, tbs = _batches(seed, [150, 83, 97])
    want, _ = _run("jax", jbs, FNS, CHAINS[chain], threshold)
    got, _ = _run("torch", tbs, FNS, CHAINS[chain], threshold)
    _assert_equal(got, want)
    # a set holds each value once (NaN once, -0.0 and 0.0 once)
    for row in got["collect_set_f"]:
        assert len(row) == len({"nan" if np.isnan(x) else x + 0.0
                                for x in row})


@pytest.mark.parametrize("fn", ["collect_list", "collect_set"])
def test_empty_group_collects_an_empty_list(fn):
    """A group whose values are all null collects an EMPTY list, not null;
    a global collect over no rows gives one empty list."""
    data = {"k": np.array([1, 1, 2], np.int64),
            "v": np.array([0, 0, 5], np.int64),
            "f": np.zeros(3), "s": ["a", "b", "c"]}
    valid = {"v": np.array([False, False, True])}
    js = JT.Schema([JT.Field(n, getattr(JT, k)) for n, k in FIELDS])
    ts = TT.Schema([TT.Field(n, getattr(TT, k)) for n, k in FIELDS])
    jb = JBatch.from_numpy(data, js, validity=valid)
    tb = ColumnBatch.from_numpy(data, ts, validity=valid, device="cpu")
    want, _ = _run("jax", [jb], [(fn, "v")], CHAINS["two"], 1 << 20)
    got, _ = _run("torch", [tb], [(fn, "v")], CHAINS["two"], 1 << 20)
    _assert_equal(got, want)
    assert [list(x) for x in got[f"{fn}_v"]] == [[], [5]]
    empty = ColumnBatch.empty(ts, device="cpu")
    node = MemorySourceExec([empty], ts)
    for mode in ("PARTIAL", "FINAL"):
        node = agg.AggExec(node, [], [], _calls(agg, ir, TT, [(fn, "v")]),
                           getattr(agg.AggMode, mode))
    out = collect(node, ExecContext(device="cpu")).to_numpy()
    assert [list(x) for x in out[f"{fn}_v"]] == [[]]


@pytest.mark.parametrize("chain", sorted(CHAINS))
def test_collect_under_spill_matches_jax(chain):
    """A 6000-byte budget: the partial's list state, beside a sum and a
    count, spills to host files (list colblocks through the serde) and
    merges back, in both packages, with the same element order."""
    jbs, tbs = _batches(2, [64] * 6, nkeys=40)
    fns = [("collect_list", "v"), ("collect_set", "s"), ("sum", "v"),
           ("count", "v")]
    want, _ = _run("jax", jbs, fns, CHAINS[chain], 70, budget=6000)
    got, node = _run("torch", tbs, fns, CHAINS[chain], 70, budget=6000)
    _assert_equal(got, want)
    partial = node
    while partial.children and not isinstance(
            partial.children[0], MemorySourceExec):
        partial = partial.children[0]
    assert partial.metrics["spill_count"] >= 1


def test_collect_state_through_the_serde_like_jax():
    """The partial's list state is the two-phase shuffle's payload: its
    frames are byte-identical to the JAX package's."""
    from blaze_tpu.columnar import serde as jserde

    jbs, tbs = _batches(3, [120])
    fns = [("collect_list", "s"), ("collect_set", "f")]
    jnode = jagg.AggExec(JMem(jbs, jbs[0].schema), [jir.col("k")], ["k"],
                         _calls(jagg, jir, JT, fns), jagg.AggMode.PARTIAL)
    tnode = agg.AggExec(MemorySourceExec(tbs, tbs[0].schema),
                        [ir.col("k")], ["k"], _calls(agg, ir, TT, fns),
                        agg.AggMode.PARTIAL)
    jstate = jcollect(jnode)
    tstate = collect(tnode, ExecContext(device="cpu"))
    assert serde.serialize_batch(tstate) == jserde.serialize_batch(jstate)
    assert M.batch_nbytes(tstate) > 0


def test_collect_merge_with_fewer_elements_than_rows():
    """Mostly null values over many groups: the merged state's element
    storage (the bucket of its element count) is smaller than its row
    capacity, through PARTIAL -> PARTIAL_MERGE -> FINAL."""
    jbs, tbs = _batches(4, [5000, 3000], nkeys=4000, null_frac=0.99,
                        key_nulls=False)
    fns = [("collect_list", "v"), ("collect_set", "s")]
    want, _ = _run("jax", jbs, fns, CHAINS["three"], 1 << 20)
    got, _ = _run("torch", tbs, fns, CHAINS["three"], 1 << 20)
    _assert_equal(got, want)
    assert 0 < sum(len(x) for x in got["collect_list_v"]) < 200
