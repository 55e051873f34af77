"""Every cell of BENCHMARK.json finds its parts by name, and a part that
is not there, or a loop the harness cannot run, is refused by name."""

import json
import subprocess
import sys

import pytest

from portbench import spec

BENCH = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
WORKLOADS = [w["name"] for w in BENCH["workloads"]]


def _steps(steps):
    for step in steps:
        yield step
        for value in step.values():
            if isinstance(value, list) and value and all(
                    isinstance(v, dict) and "op" in v for v in value):
                yield from _steps(value)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_finds_config_traffic_and_limits(workload):
    cell = spec.cell(workload)
    entry = next(w for w in BENCH["workloads"] if w["name"] == workload)
    assert cell.config["name"] == entry["config"]
    assert cell.traffic["name"] == entry["traffic"]
    assert set(cell.limits) == {"mismatched", "sum_rel_err"}
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer
    tables = {t["name"]: {c["name"]: c for c in t["columns"]}
              for t in cell.config["tables"]}
    for leaf in spec.leaves(cell.traffic["plan"]):
        assert set(leaf["columns"]) <= set(tables[leaf["table"]])
        assert f"{leaf['table']}_rows" in cell.config
        for c in leaf["columns"]:
            spec.part("draws", tables[leaf["table"]][c]["dist"])


@pytest.mark.parametrize("workload", WORKLOADS)
def test_every_step_and_the_loop_are_found_on_both_sides(workload):
    traffic = spec.cell(workload).traffic
    for step in _steps(traffic["plan"]):
        assert callable(spec.part("operators", step["op"]).build)
        assert callable(spec.part("reference/operators",
                                  step["op"]).evaluate)
    loop = spec.part("loops", traffic["loop"]["kind"])
    loop.validate(traffic["loop"])


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_reader_found_by_name(metric):
    read = spec.metric_reader(metric)
    assert callable(read)


@pytest.mark.parametrize("kind,name", [
    ("operators", "no_such_op"), ("reference/operators", "no_such_op"),
    ("draws", "no_such_dist"), ("loops", "no_such_loop"),
    ("metrics", "no_such_metric"), ("operators", "../harness")])
def test_a_missing_part_is_refused_by_its_file_name(kind, name):
    with pytest.raises(KeyError, match="expected portbench/"):
        spec.part(kind, name)


@pytest.mark.parametrize("loop", [
    {"kind": "closed", "slots": 2, "depth": 2, "order": "in_turn"},
    {"kind": "closed", "slots": 1, "depth": 0, "order": "in_turn"},
    {"kind": "closed", "slots": 1, "depth": 2, "order": "shuffled"}])
def test_the_closed_loop_refuses_what_it_cannot_run(loop):
    with pytest.raises(ValueError):
        spec.part("loops", "closed").validate(loop)


def test_leaves_walk_the_plan_and_the_inputs_that_steps_hold():
    plan = [{"op": "ffi_reader", "table": "a", "columns": ["x"]},
            {"op": "join", "build": [
                {"op": "ffi_reader", "table": "b", "columns": ["y"]},
                {"op": "filter", "predicates": []}]}]
    assert [leaf["table"] for leaf in spec.leaves(plan)] == ["a", "b"]


def test_unknown_workload_is_refused():
    with pytest.raises(KeyError):
        spec.cell("no_such.cell")


def test_config_files_hold_the_named_reductions():
    for c in BENCH["configs"]:
        data = json.loads((spec.ROOT / c["file"]).read_text())
        assert data["name"] == c["name"]
        for key in c["reduced"]:
            assert key in data and key in data["published"]
            assert data[key] < data["published"][key]


def test_the_reference_loads_nothing_of_the_program():
    """The reference and its steps, loaded in a fresh process, bring in
    neither torch nor the port nor JAX."""
    code = (
        "import sys\n"
        f"sys.path.insert(0, {str(spec.ROOT)!r})\n"
        "from portbench import spec\n"
        "from portbench.reference import numpy_ref\n"
        "import pathlib\n"
        "for p in (spec.HERE / 'reference' / 'operators').glob('*.py'):\n"
        "    spec.part('reference/operators', p.stem)\n"
        "top = {m.split('.')[0] for m in sys.modules}\n"
        "print(sorted(top & {'torch', 'blaze_tpu_torch', 'blaze_tpu',"
        " 'jax', 'jaxlib', 'flax'}))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == "[]"
