"""The port's report and inspection CLIs (blaze_tpu_torch/tools/) against
the JAX package's (tools/), each loaded by file path.

One module fixture runs the validator's core q3 through the port's
QueryService on the CPU with every file writer on: the trace export
(ledger.jsonl, trace_<qid>.json), the history store (two runs), the
flight recorder (an unmeetable tenant SLO, so one slo_breach dossier)
and the sampling profiler's export (.collapsed, .speedscope.json). Every
reader of both packages then reads those same files, and its output must
be the same once the directory is replaced: trace_report's and
history_report's summaries, history_report's bench trend, blaze_doctor's
summary with and without --history, blaze_inspect's list, show and
waterfall (and the waterfall of a /queries payload), and blaze_prof's
--list, top table, collapsed and speedscope forms of a directory, a
.collapsed file and a dossier. blaze_top's render reads the same
Prometheus text in both. Then every entry point of the port's tools
refuses to run on a host without a card unless asked for --device cpu.
"""

import argparse
import glob
import importlib
import importlib.util
import json
import os
import types

import pytest
import torch

from blaze_tpu_torch.config import conf

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
READERS = ("trace_report", "history_report", "blaze_doctor",
           "blaze_inspect", "blaze_top", "blaze_prof")


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_tools_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def pairs():
    """{name: (port module, JAX module)} of the six readers."""
    return {n: (importlib.import_module(f"blaze_tpu_torch.tools.{n}"),
                _jax_tool(n)) for n in READERS}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The directories one traced, recorded, profiled port run wrote."""
    from blaze_tpu_torch.runtime import (flight_recorder, history, monitor,
                                         profiler, service, trace)
    from blaze_tpu_torch.spark import validator

    root = tmp_path_factory.mktemp("tools")
    dirs = {k: str(root / k) for k in ("trace", "history", "flight",
                                        "profile", "tables")}
    for d in dirs.values():
        os.makedirs(d)
    paths, frames = validator.generate_tables(dirs["tables"], rows=2000)
    knobs = dict(trace_enabled=True, monitor_enabled=True,
                 trace_export_dir=dirs["trace"], history_dir=dirs["history"],
                 flight_dir=dirs["flight"], doctor_enabled=True,
                 profile_enabled=True, profile_sample_ms=1,
                 profile_export_dir=dirs["profile"],
                 tenant_slo_spec={"t": {"latency_ms": 1.0, "target": 0.9}})
    saved = {k: getattr(conf, k) for k in knobs}
    conf.update(**knobs)
    service.reset_slo()
    flight_recorder.reset()
    profiler.reset()
    try:
        with service.QueryService() as svc:
            for i in range(2):
                plan, _ = validator.QUERIES["q3_join_agg_sort"](
                    paths, frames, "smj")
                svc.run(plan, "t", num_partitions=4,
                        work_dir=str(root / f"w{i}"), mesh_exchange="off",
                        device="cpu")
        prom = monitor.prometheus_text()
    finally:
        profiler.stop()
        for k, v in saved.items():
            setattr(conf, k, v)
        service.reset_slo()
        flight_recorder.reset()
        profiler.reset()
        history.reset()
        trace.reset()
    dirs["dossier"] = sorted(glob.glob(os.path.join(dirs["flight"],
                                                    "dossier_*.json")))[0]
    dirs["collapsed"] = sorted(glob.glob(os.path.join(dirs["profile"],
                                                      "*.collapsed")))[0]
    dirs["prom"] = prom
    return dirs


def _same(capsys, pairs, name, call, files):
    """call(module) in the port's then the JAX module: (return values,
    outputs with every directory written as <name>)."""
    outs = []
    for mod in pairs[name]:
        rc = call(mod)
        text = capsys.readouterr().out
        for k in ("trace", "history", "flight", "profile"):
            text = text.replace(files[k], f"<{k}>")
        outs.append((rc, text))
    assert outs[0] == outs[1]
    assert outs[0][1].strip()
    return outs[0]


def test_the_run_wrote_every_file(files):
    trace_files = os.listdir(files["trace"])
    assert "ledger.jsonl" in trace_files
    assert any(f.startswith("trace_") for f in trace_files)
    assert glob.glob(os.path.join(files["history"], "*.jsonl"))
    with open(files["dossier"]) as f:
        assert json.load(f)["trigger"] == "slo_breach"
    assert glob.glob(os.path.join(files["profile"], "*.speedscope.json"))


def test_trace_report_summary_matches_jax(pairs, files, capsys):
    rc, text = _same(capsys, pairs, "trace_report",
                     lambda m: m.summarize(files["trace"]), files)
    assert rc == 0 and "(2 queries)" in text


def test_history_report_matches_jax(pairs, files, capsys):
    rc, text = _same(capsys, pairs, "history_report",
                     lambda m: m.summarize(files["history"]), files)
    assert rc == 0 and "2 runs" in text
    _same(capsys, pairs, "history_report", lambda m: m.bench_trend(), files)


@pytest.mark.parametrize("with_history", [False, True])
def test_doctor_summary_matches_jax(pairs, files, capsys, with_history):
    hist = files["history"] if with_history else None
    rc, text = _same(capsys, pairs, "blaze_doctor",
                     lambda m: m.summarize(files["trace"],
                                           history_dir=hist), files)
    assert rc == 0 and "(2 queries)" in text


@pytest.mark.parametrize("mode", ["list", "show", "waterfall"])
def test_inspect_readers_match_jax(pairs, files, capsys, mode):
    args = argparse.Namespace(dir=files["flight"], path=files["dossier"])
    call = {"list": lambda m: m.list_mode(args),
            "show": lambda m: m.show(args),
            "waterfall": lambda m: m.waterfall(args)}[mode]
    rc, text = _same(capsys, pairs, "blaze_inspect", call, files)
    assert rc == 0 and "slo_breach" in text + mode


def test_inspect_live_waterfall_matches_jax(pairs, files, capsys):
    doc = {"query_id": "q1", "phase": "running", "elapsed_ms": 1500.0,
           "stages": [{"stage_id": 0, "kind": "shuffle_map",
                       "started_offset_ms": 0.0, "elapsed_ms": 900.0,
                       "rows": 10, "retries": 1, "rungs": ["retry"]},
                      {"stage_id": 1, "kind": "result",
                       "started_offset_ms": 900.0, "elapsed_ms": 600.0,
                       "rows": 3, "error": "IOError"}]}
    _same(capsys, pairs, "blaze_inspect",
          lambda m: m._print_waterfall(doc), files)


@pytest.mark.parametrize("argv", [
    ["{profile}", "--list"],
    ["{profile}"],
    ["{profile}", "--format", "collapsed"],
    ["{collapsed}", "--format", "speedscope"],
    ["{collapsed}", "--top", "3"],
    ["{dossier}", "--format", "collapsed"],
], ids=["list", "top", "collapsed", "speedscope", "file_top", "dossier"])
def test_prof_matches_jax(pairs, files, capsys, argv):
    argv = [a.format(**files) for a in argv]
    port, jax = pairs["blaze_prof"]
    outs = []
    for mod, extra in ((port, ["--device", "cpu"]), (jax, [])):
        try:
            rc = mod.main(argv + extra)
        except SystemExit as e:  # a dossier without a profile window
            rc = str(e)
        outs.append((rc, capsys.readouterr().out))
    assert outs[0] == outs[1]


def test_top_render_matches_jax(pairs, files, capsys, monkeypatch):
    outs = []
    for mod in pairs["blaze_top"]:
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(
            strftime=lambda fmt: "12:00:00"))
        metrics = mod.parse_prometheus(files["prom"])
        outs.append(mod.render(metrics, "scrape") + mod.render_queries(
            dict(metrics, __queries__=[{
                "query_id": "q7", "seconds": 1.5, "bytes_copied": 4096,
                "bytes_moved": 1 << 20}])))
    assert outs[0] == outs[1]
    assert "memory" in outs[0] and "q7" in outs[0]


ENTRY_ARGV = {
    "chaos_soak": ["--rows", "100"],
    "trace_report": ["--bench", "--rows", "100"],
    "history_report": ["--gate", "--rows", "100"],
    "blaze_doctor": ["--gate", "--rows", "100"],
    "blaze_inspect": ["--gate", "--rows", "100"],
    "blaze_top": ["--once"],
    "blaze_prof": ["{profile}", "--list"],
}


@pytest.mark.parametrize("name", sorted(ENTRY_ARGV))
def test_entry_point_refuses_without_a_card(name, files, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    mod = importlib.import_module(f"blaze_tpu_torch.tools.{name}")
    argv = [a.format(**files) for a in ENTRY_ARGV[name]]
    assert mod.main(argv) == 2
    captured = capsys.readouterr()
    assert "pass --device cpu" in captured.err and not captured.out
    assert mod.main(argv + ["--device", "cuda"]) == 2
