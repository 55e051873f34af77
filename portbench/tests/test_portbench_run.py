"""Whole runs of a cell on the CPU at a small size: the result line, the
import check, the refusals, the control and the faults that `correct`
must catch."""

import io
import json
import random
import shutil
import subprocess
import sys
import time

import pytest
import torch

from portbench import harness, spec
from portbench import task as T
from portbench.tests.conftest import SMALL

ROOT = spec.ROOT
CELL = "custagg.store_sales_sf1000_exec8"
SEED = 2**31 + 977  # past 32 signed bits, as the driver's seeds are


def _run(workload, small, traced=False, seconds=0.5):
    out = io.StringIO()
    t = time.perf_counter()
    rc = harness.run(workload, SEED, seconds, traced, t_process=t,
                     t_imported=t, device="cpu", shrink=small, out=out)
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("workload", [CELL])
def test_dry_run_is_correct_and_loads_no_jax(workload, tmp_path):
    """A CPU dry run in a fresh process: its last line is the result, and
    no module whose top-level name is jax, jaxlib, flax or blaze_tpu is
    loaded when it ends (blaze_tpu_torch is not blaze_tpu)."""
    code = (
        "import sys, time, json\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from portbench import harness\n"
        "t = time.perf_counter()\n"
        f"rc = harness.run({workload!r}, {SEED}, 0.5, False, t_process=t, "
        f"t_imported=t, device='cpu', shrink={SMALL!r})\n"
        "print(json.dumps({'rc': rc, 'loaded': harness.forbidden_modules(),"
        " 'port': 'blaze_tpu_torch' in sys.modules}))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    tail = json.loads(lines[-1])
    assert tail == {"rc": 0, "loaded": [], "port": True}
    result = json.loads(lines[-2])
    assert result["correct"] is True
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) == {"rows_per_s", "task_p95_ms",
                                      "work_mem_gb", "setup_s"}
    assert list(result)[-1] == "compared"
    info = json.loads(lines[-3])
    assert info["route"]["spill_count"] == 0


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "blaze_tpu_torch_x", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert harness.forbidden_modules() == ["jax"]


def test_traced_dry_run_reports_per_layer_metrics(small):
    result = _run(CELL, small, traced=True)
    assert result["correct"] is True
    assert "decode_ms" in result["metrics"]
    # no device on the CPU: the device readers find nothing and are left out
    assert "device_idle_pct" not in result["metrics"]
    assert "window_s" in result["device"] and "busy_s" in result["device"]
    assert "idle_gaps" in result["breakdown"]


def test_without_the_card_the_command_fails_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELL, "--seed",
         str(SEED), "--seconds", "1", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=600)
    assert proc.returncode != 0
    assert '"correct"' not in proc.stdout


def test_outside_a_checkout_the_command_fails(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELL, "--seed",
         "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
        capture_output=True, text=True, timeout=600)
    assert proc.returncode != 0
    assert '"correct"' not in proc.stdout


@pytest.mark.parametrize("workload", [CELL])
def test_control_fails_where_the_program_passes(workload, small):
    """The reference in float32 in the program's place breaks a limit."""
    cell = spec.cell(workload)
    prep = harness.prepare(cell, SEED, torch.device("cpu"), small)
    sample = prep.window(0.3, 3, random.Random(SEED)).answers()
    program = harness.check(prep, sample)
    control = harness.check(prep, sample, control=True)
    prep.close()
    assert program["failed"] == 0
    assert control["failed"] == len(sample)
    assert control["sum_rel_err"] > cell.limits["sum_rel_err"]


def _stale(monkeypatch):
    """Every task hands back the task before it's rows: its state
    unchanged from the last task."""
    orig = T.collect_fetch_async
    last = {}

    def stale(plan, pack, ctx):
        raw = orig(plan, pack, ctx)()
        prev = dict(last) or {"raw": raw, "n": pack.n,
                              "layout": pack.layout}
        last.update(raw=raw, n=pack.n, layout=pack.layout)
        pack.n, pack.layout = prev["n"], prev["layout"]
        return lambda: prev["raw"]

    monkeypatch.setattr(T, "collect_fetch_async", stale)


def _half(monkeypatch):
    """The reader hands the task half of its batches."""
    from blaze_tpu_torch.runtime import resources

    orig = resources.put

    def put(key, provider):
        def half(partition, num_partitions):
            items = list(provider(partition, num_partitions))
            return iter(items[:len(items) // 2])
        return orig(key, half)

    monkeypatch.setattr(resources, "put", put)


def _altered(monkeypatch):
    """One value of the task's answer changed where it is produced."""
    orig = T.collect_fetch_async

    def altered(plan, pack, ctx):
        def pack_altered(out):
            col = out.columns[1].data
            col[0] = col[0] + 1
            return pack(out)
        return orig(plan, pack_altered, ctx)

    monkeypatch.setattr(T, "collect_fetch_async", altered)


@pytest.mark.parametrize("workload", [CELL])
@pytest.mark.parametrize("fault", [_stale, _half, _altered],
                         ids=["state_unchanged", "half_the_batches",
                              "answer_altered"])
def test_a_broken_timed_path_reads_not_correct(workload, fault, small,
                                               monkeypatch):
    fault(monkeypatch)
    result = _run(workload, small)
    assert result["correct"] is False
    assert result["failed"] > 0


@pytest.mark.cuda
def test_control_on_the_card_at_the_cells_size(card):
    """On the card, at the custagg SF1000 cell's own size: three seeds of
    the program within the limits and of the control beyond them."""
    seeds = "3500000001,3500000002,3500000003"
    proc = subprocess.run(
        [sys.executable, "portbench/control.py", "--workload", CELL,
         "--seeds", seeds, "--control-seeds", seeds, "--seconds", "2"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    limits = spec.cell(CELL).limits
    lines = [json.loads(x) for x in proc.stdout.splitlines()
             if x.startswith("{")]
    assert len(lines) == 3
    for line in lines:
        assert all(line["program"][k] <= limits[k] for k in limits)
        assert any(line["control"][k] > limits[k] for k in limits)


@pytest.mark.parametrize("depth", [1, 3])
def test_the_closed_loop_at_other_depths_is_correct(depth, small):
    """The loop's depth is read from the traffic file: one task in flight,
    or three, give the same correct answers."""
    cell = spec.cell(CELL)
    cell.traffic = dict(cell.traffic,
                        loop=dict(cell.traffic["loop"], depth=depth))
    prep = harness.prepare(cell, SEED, torch.device("cpu"), small)
    win = prep.window(0, 3, random.Random(SEED), count=depth + 2)
    nums = harness.check(prep, win.answers())
    parts = prep.partitions
    prep.close()
    assert [t.partition for t in win.tasks] == [
        i % parts for i in range(depth + 2)]
    assert nums["failed"] == 0


def test_a_loop_the_harness_cannot_run_is_refused_before_set_up(small):
    cell = spec.cell(CELL)
    cell.traffic = dict(cell.traffic,
                        loop=dict(cell.traffic["loop"], slots=2))
    with pytest.raises(ValueError, match="slot"):
        harness.prepare(cell, SEED, torch.device("cpu"), small)
