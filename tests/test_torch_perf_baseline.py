"""The port's perf_baseline (blaze_tpu_torch/tools/perf_baseline.py)
against the JAX package's tools/perf_baseline.py, loaded by file path, on
the CPU.

- `_catalogue_records` at 2,000 rows, one task at a time in both packages
  (the supervisor's pool otherwise decides how many partial aggregate
  states are alive at once, and so the peak): every copy counter,
  peak_mem_bytes, spill_bytes and resource_leaks equal the JAX tool's,
  but for q2's and q3's shuffle bytes. There the partial aggregate's
  groups come out in another order than the JAX package's, so the shuffle
  frames hold the same raw bytes but compress to other sizes, and
  bytes_copied_shuffle, bytes_copied_total and bytes_moved_total differ;
  every other boundary's bytes are equal.
- `_compare` gives the same problems as the JAX tool on crafted
  baseline/current pairs.
- An `--update` then gate round trip exits 0, writing only where asked,
  and the copy counters of the two passes are equal.
- `--obs` at small rows reports no leak, a valid mid-query scrape and a
  chaos cell that recovers through the port's chaos_soak.
- The JAX package's PERF_BASELINE.json is never the port's baseline.

No timing is asserted.
"""

import copy
import importlib.util
import json
import os

import pytest

from blaze_tpu_torch.config import conf
from blaze_tpu_torch.tools import perf_baseline
from torch_parity import no_jax_native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the keys where the two packages' shuffle frames compress differently
COMPRESSED = {"q2_q06_core_agg": {"bytes_copied_shuffle",
                                  "bytes_copied_total", "bytes_moved_total"},
              "q3_join_agg_sort": {"bytes_copied_shuffle",
                                   "bytes_copied_total",
                                   "bytes_moved_total"}}


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_tools_perf_baseline",
        os.path.join(REPO, "tools", "perf_baseline.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def cpu(monkeypatch):
    monkeypatch.setattr(perf_baseline, "DEVICE", "cpu")
    no_jax_native(monkeypatch)


def test_catalogue_records_equal_jax(cpu, monkeypatch, tmp_path):
    from blaze_tpu.config import conf as jconf
    from blaze_tpu.spark import validator as jvalidator
    from blaze_tpu_torch.spark import validator

    for c in (conf, jconf):
        monkeypatch.setattr(c, "trace_enabled", True)
        monkeypatch.setattr(c, "monitor_enabled", True)
        monkeypatch.setattr(c, "max_concurrent_tasks", 1)
    (tmp_path / "p").mkdir()
    (tmp_path / "j").mkdir()
    tables = validator.generate_tables(str(tmp_path / "p"), rows=2000)
    jtables = jvalidator.generate_tables(str(tmp_path / "j"), rows=2000)
    jax = _jax_tool()
    perf_baseline._catalogue_records(tables, collect=False)
    jax._catalogue_records(jtables, collect=False)
    got, _ = perf_baseline._catalogue_records(tables)
    want, _ = jax._catalogue_records(jtables)
    assert set(got) == set(want) == {q for q, _ in perf_baseline.QUERIES}
    keys = perf_baseline.COPY_KEYS + ("peak_mem_bytes", "spill_bytes",
                                      "resource_leaks")
    assert keys == jax.COPY_KEYS + ("peak_mem_bytes", "spill_bytes",
                                    "resource_leaks")
    for q in got:
        assert set(got[q]) == set(want[q]) == set(keys) | {"duration_s"}
        same = [k for k in keys if k not in COMPRESSED.get(q, ())]
        assert {k: got[q][k] for k in same} == {k: want[q][k] for k in same}
        assert got[q]["resource_leaks"] == 0
    assert got["q2_q06_core_agg"]["peak_mem_bytes"] > 0
    assert got["q3_join_agg_sort"]["bytes_copied_serde"] > 0


def _rec(**kw):
    rec = {"duration_s": 1.0, "peak_mem_bytes": 0, "spill_bytes": 0,
           "resource_leaks": 0}
    rec.update({k: 1000 for k in perf_baseline.COPY_KEYS})
    rec.update(kw)
    return rec


CASES = {
    "clean": {"q1": _rec()},
    "slow": {"q1": _rec(duration_s=5.0)},
    "copies": {"q1": _rec(bytes_copied_serde=200_000,
                          bytes_moved_total=1_000_000)},
    "within_grace": {"q1": _rec(bytes_copied_total=60_000)},
    "leak": {"q1": _rec(resource_leaks=2)},
    "missing": {},
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_compare_problems_equal_jax(case):
    baseline = {"queries": {"q1": _rec()}}
    current = CASES[case]
    got = perf_baseline._compare(copy.deepcopy(baseline),
                                 copy.deepcopy(current))
    want = _jax_tool()._compare(baseline, current)
    assert got == want
    assert bool(got) == (case not in ("clean", "within_grace"))


def test_update_then_gate_round_trip(cpu, tmp_path, capsys):
    base = str(tmp_path / "base.json")
    out = str(tmp_path / "gate.json")
    argv = ["--device", "cpu", "--rows", "2000", "--baseline", base]
    assert perf_baseline.main(argv + ["--update"]) == 0
    assert perf_baseline.main(argv + ["--json-out", out]) == 0
    with open(base) as f:
        written = json.load(f)
    with open(out) as f:
        gated = json.load(f)
    assert sorted(os.listdir(tmp_path)) == ["base.json", "gate.json"]
    assert written["rows"] == gated["rows"] == 2000
    assert gated["problems"] == []
    for q, rec in written["queries"].items():
        assert {k: rec[k] for k in perf_baseline.COPY_KEYS} == \
            {k: gated["queries"][q][k] for k in perf_baseline.COPY_KEYS}
    assert "[perf] OK" in capsys.readouterr().out


def test_jax_baseline_is_refused(capsys):
    with pytest.raises(SystemExit):
        perf_baseline.main(["--device", "cpu", "--update",
                            "--baseline", "PERF_BASELINE.json"])
    assert "JAX package's baseline" in capsys.readouterr().err


def test_obs_reports_no_leak(cpu, tmp_path):
    from blaze_tpu_torch.tools import chaos_soak

    out = str(tmp_path / "obs.json")
    device = chaos_soak.DEVICE
    perf_baseline.main(["--device", "cpu", "--rows", "2000", "--obs",
                        "--json-out", out])
    with open(out) as f:
        rec = json.load(f)
    assert rec["leaks"] == 0
    scrape = rec["scrape_during_query"]
    assert scrape["has_copy_metric"] and not scrape["format_errors"]
    assert rec["chaos_cell"]["outcome"] == "recovered"
    assert not rec["chaos_cell"]["mem_leaked"]
    assert not rec["chaos_cell"]["pipeline_leaked"]
    assert chaos_soak.DEVICE == device  # put back after the cell
    assert [p for p in rec["problems"] if "leak" in p] == []
