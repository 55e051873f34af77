"""conf.enable_input_batch_statistics in the port against the JAX package,
on the CPU.

With the knob on, every operator's output stream records `stat_bytes`
(its batches' device bytes, from capacities and dtypes) and
`stat_max_batch_rows` (the largest batch's rows) at the same boundary as
the JAX package's count_stream: a catalogue query's result stage, decoded
in each package from its own stage plan over the same tables and streamed,
gives each operator the same two numbers. A stage that runs whole on the
stage compiler has no batch stream: it records nothing and warns once, as
the JAX package's does. With the knob off nothing is recorded.
"""

import logging

import numpy as np
import pytest

from blaze_tpu.config import conf as jconf
from blaze_tpu.ops.base import ExecContext as JCtx
from blaze_tpu.plan.from_proto import decode_plan as jdecode_plan
from blaze_tpu.runtime import stage_compiler as jstage
from blaze_tpu.runtime.executor import collect as jcollect
from blaze_tpu.runtime.executor import execute_plan as jexecute_plan
from blaze_tpu.spark import validator as jvalidator
from blaze_tpu.spark.convert_strategy import apply_strategy as japply
from blaze_tpu.spark.stages import plan_stages as jplan_stages
from blaze_tpu_torch.config import conf
from blaze_tpu_torch.ops.base import ExecContext
from blaze_tpu_torch.plan.from_proto import decode_plan
from blaze_tpu_torch.runtime import stage_compiler
from blaze_tpu_torch.runtime.executor import collect, execute_plan
from blaze_tpu_torch.spark import validator
from blaze_tpu_torch.spark.convert_strategy import apply_strategy
from blaze_tpu_torch.spark.stages import plan_stages
from torch_parity import both_tables

STATS = ("stat_bytes", "stat_max_batch_rows")


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    return both_tables(tmp_path_factory, rows=3000)


BATCH_ROWS = 512  # the scan's batches: several, the last one short


@pytest.fixture
def stats_on(monkeypatch):
    for c in (conf, jconf):
        monkeypatch.setattr(c, "enable_input_batch_statistics", True)


def _result_stage(tables, q):
    """(port operator root, JAX operator root) of q's result stage, each
    scan reading BATCH_ROWS rows a batch."""
    (paths, frames), (jpaths, jframes) = tables["core"]
    roots = []
    for mod, apply, stages_fn, decode, p, f in (
            (validator, apply_strategy, plan_stages, decode_plan, paths,
             frames),
            (jvalidator, japply, jplan_stages, jdecode_plan, jpaths,
             jframes)):
        plan, _ = mod.QUERIES[q](p, f, "bhj")
        apply(plan)
        stages = stages_fn(plan, default_partitions=4, namespace="")
        root = decode(stages[-1].plan)
        for op in _walk(root):
            if not op.children:
                op.batch_rows = BATCH_ROWS
        roots.append(root)
    return roots


def _walk(op):
    yield op
    for c in op.children:
        yield from _walk(c)


def _stats(root):
    return [(type(op).__name__, {k: op.metrics.values.get(k) for k in
                                 STATS + ("output_rows",)})
            for op in _walk(root)]


@pytest.mark.parametrize("q", ["q1_scan_filter_project"])
def test_streamed_stage_records_the_jax_statistics(tables, stats_on, q):
    root, jroot = _result_stage(tables, q)
    out = list(execute_plan(root, ExecContext(device="cpu")))
    jout = list(jexecute_plan(jroot, JCtx()))
    assert len(out) == len(jout)
    scan = [op for op in _walk(root) if not op.children][0]
    assert scan.metrics["output_batches"] > 1
    got, want = _stats(root), _stats(jroot)
    assert got == want
    # every operator with a stream of its own (a filter fused into the
    # project above it has none, in both packages) recorded both numbers
    streamed = [s for _, s in got if s["output_rows"]]
    assert len(streamed) == 3 and all(
        s["stat_bytes"] > 0 and 0 < s["stat_max_batch_rows"] <= BATCH_ROWS
        for s in streamed[1:])


def test_statistics_off_records_nothing(tables):
    root, _ = _result_stage(tables, "q1_scan_filter_project")
    list(execute_plan(root, ExecContext(device="cpu")))
    assert all(s["stat_bytes"] is None and s["stat_max_batch_rows"] is None
               for _, s in _stats(root))


def test_a_compiled_stage_warns_once(tables, stats_on, monkeypatch, caplog):
    """The agg-less chain stage under the result stage's sort (scan ->
    filter -> project) runs whole on the stage compiler: no batch stream
    above the scan, so no statistics there, and one warning for the
    process (the JAX package's words)."""
    for mod in (stage_compiler, jstage):
        monkeypatch.setattr(mod, "_stats_warned", False)
    caplog.set_level(logging.WARNING)
    records = []
    for run, ctx, mod in ((collect, ExecContext(device="cpu"),
                           stage_compiler), (jcollect, JCtx(), jstage)):
        for _ in range(2):
            root = _result_stage(tables, "q1_scan_filter_project")[
                0 if mod is stage_compiler else 1].children[0]
            out = run(root, ctx)
            assert root.metrics["stage_compiled"] == 1
            assert int(np.asarray(out.num_rows)) > 0
            # the drained source streamed; the chain above it did not
            assert [name for name, s in _stats(root)
                    if s["stat_bytes"] is not None] == \
                [type(op).__name__ for op in _walk(root)
                 if not op.children]
        records.append([r.getMessage() for r in caplog.records
                        if r.name == mod.__name__])
    assert len(records[0]) == 1 and records[0] == records[1]
    assert "enable_input_batch_statistics" in records[0][0]
