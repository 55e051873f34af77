"""The port's pipeline_bench (blaze_tpu_torch/tools/pipeline_bench.py)
against the JAX package's tools/pipeline_bench.py, loaded by file path, on
the CPU.

- `_make_frames` gives frames byte-identical to the JAX tool's at the
  same rows (the same seeded batches through each package's serde).
- `catalogue_ab` runs the validator catalogue with the pipeline off and
  on: every run's rows equal the JAX tool's run of the same query and arm
  and its pandas oracle, and no stream is left live after it.
- The microbench's rows and the report's gate read as the JAX tool's.

No timing is asserted.
"""

import argparse
import importlib.util
import os

import pandas as pd
import pytest

from blaze_tpu_torch.runtime import pipeline
from blaze_tpu_torch.tools import pipeline_bench
from torch_parity import no_jax_native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_tools_pipeline_bench",
        os.path.join(REPO, "tools", "pipeline_bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def cpu(monkeypatch):
    monkeypatch.setattr(pipeline_bench, "DEVICE", "cpu")
    no_jax_native(monkeypatch)


def _args(**kw):
    base = dict(frames=4, rows=256, io_ms=1.0, compute_ms=1.0, depth=2,
                catalogue_rows=2000)
    base.update(kw)
    return argparse.Namespace(**base)


@pytest.mark.parametrize("rows,n_frames", [(64, 3), (1000, 2)])
def test_frames_equal_jax(cpu, rows, n_frames):
    schema, frames = pipeline_bench._make_frames(rows, n_frames)
    jschema, jframes = _jax_tool()._make_frames(rows, n_frames)
    assert [f.name for f in schema] == [f.name for f in jschema]
    assert len(frames) == n_frames
    assert [bytes(f) for f in frames] == [bytes(f) for f in jframes]


def _recording(monkeypatch, runner, validator):
    """Each package's run_plan, recording every answer as pandas rows."""
    outs = []
    real = runner.run_plan

    def recording(plan, *a, **kw):
        out = real(plan, *a, **kw)
        outs.append(validator._to_pandas(out))
        return out

    monkeypatch.setattr(runner, "run_plan", recording)
    return outs


def test_catalogue_rows_equal_jax(cpu, monkeypatch):
    from blaze_tpu.spark import local_runner as jrunner
    from blaze_tpu.spark import validator as jvalidator
    from blaze_tpu_torch.spark import local_runner, validator

    got = _recording(monkeypatch, local_runner, validator)
    report = pipeline_bench.catalogue_ab(_args())
    assert pipeline.live_streams() == 0
    want = _recording(monkeypatch, jrunner, jvalidator)
    jreport = _jax_tool().catalogue_ab(_args())
    assert set(report) == set(jreport) | {"catalogue_checks"}
    # warm, off and on: each query of the catalogue in turn
    assert len(got) == len(want) == 3 * len(pipeline_bench.QUERIES)
    for frame, jframe in zip(got, want):
        pd.testing.assert_frame_equal(frame.reset_index(drop=True),
                                      jframe.reset_index(drop=True))
    checks = report["catalogue_checks"]
    assert set(checks) == {"warm", "off", "on"}
    assert all(c["oracle_equal"] for runs in checks.values()
               for c in runs.values())


def test_microbench_and_gate(cpu):
    rec = pipeline_bench.microbench(_args())
    jrec = _jax_tool().microbench(_args())
    assert set(rec) == set(jrec)
    assert rec["frames"] == 4 and rec["rows_per_frame"] == 256
    assert pipeline.live_streams() == 0
    report = dict(rec, speedup=2.0, catalogue_pipeline_off_s=1.0,
                  catalogue_pipeline_on_s=1.0, live_streams_after=1,
                  catalogue_checks={"on": {"q": {"oracle_equal": False,
                                                 "diff": "x"}}})
    problems = pipeline_bench.gate(report)
    assert problems == ["1 leaked streams",
                        "q (on) differs from its oracle: x"]
