"""The port's compile_warm_bench (blaze_tpu_torch/tools/
compile_warm_bench.py) against the JAX package's tools/compile_warm_bench.py,
loaded by file path, on the CPU.

- `--child-matrix` with one query at 2,000 rows, each package in a fresh
  shape registry and an empty manifest: the pass records have the
  reference's keys and telemetry keys, the same cells and whole-stage
  counts, and the same `shape_reduction` (the port notes the shapes where
  the JAX package pads them).
- The three-phase `main --device cpu` at tiny rows builds every library
  into a temporary directory through BLAZE_TPU_TORCH_BUILD_DIR, reports
  what it built or why it could not, and leaves the package's `build/`
  as it was.

No timing is asserted: the cold <= 2 x warm acceptance is not read.
"""

import argparse
import importlib.util
import json
import os

from blaze_tpu.runtime import compile_service as jcs
from blaze_tpu_torch import kernels
from blaze_tpu_torch.runtime import compile_service as cs
from blaze_tpu_torch.tools import compile_warm_bench
from torch_parity import no_jax_native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAGE_KEYS = ("stage_attempts", "stage_compiled", "whole_stage_coverage_pct")


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_tools_compile_warm_bench",
        os.path.join(REPO, "tools", "compile_warm_bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _payload(out):
    (line,) = [ln for ln in out.splitlines() if ln.startswith("CWB_JSON ")]
    return json.loads(line[len("CWB_JSON "):])


def test_child_matrix_equals_jax(monkeypatch, tmp_path, capsys):
    no_jax_native(monkeypatch)
    args = argparse.Namespace(queries="q01", rows="2000", passes=1,
                              device="cpu")
    runs = {}
    for name, mod, child in (("port", cs, compile_warm_bench),
                             ("jax", jcs, _jax_tool())):
        monkeypatch.setattr(mod, "_REGISTRY", mod.ShapeRegistry())
        monkeypatch.setenv("BLAZE_TPU_COMPILE_MANIFEST",
                           str(tmp_path / f"{name}.json"))
        assert child._matrix_child(args) == 0
        runs[name] = _payload(capsys.readouterr().out)
    got, want = runs["port"], runs["jax"]
    assert set(got) == set(want) | {"libraries"}
    assert got["manifest_path"] == str(tmp_path / "port.json")
    (p,), (jp,) = got["passes"], want["passes"]
    assert set(p) == set(jp)
    assert set(p["telemetry"]) == set(jp["telemetry"])
    assert (p["rows"], p["cells"], p["failed"]) == \
        (jp["rows"], jp["cells"], jp["failed"]) == (2000, 2, [])
    assert {k: p["telemetry"][k] for k in STAGE_KEYS} == \
        {k: jp["telemetry"][k] for k in STAGE_KEYS}
    assert got["shape_reduction"] == want["shape_reduction"]
    assert got["shape_reduction"]["join_build"]["raw_rowcounts"] > 0
    assert os.path.exists(tmp_path / "port.json")


def _libraries_in(d):
    """{library file: mtime} of a build directory (other test processes
    may add a library there meanwhile, never replace one)."""
    if not os.path.isdir(d):
        return {}
    return {f: os.stat(os.path.join(d, f)).st_mtime_ns
            for f in os.listdir(d) if f.endswith(".so")}


def test_three_phases_build_into_a_temp_dir(tmp_path, capsys):
    package_build = str(kernels.BUILD_DIR)
    before = _libraries_in(package_build)
    out = str(tmp_path / "cwb.json")
    rc = compile_warm_bench.main(
        ["--device", "cpu", "--rows", "1000", "--extra-scales", "800",
         "--queries", "q01", "--json-out", out])
    after = _libraries_in(package_build)
    assert {f: after.get(f) for f in before} == before
    with open(out) as f:
        doc = json.load(f)
    assert rc == (0 if doc["acceptance_cold_le_2x_warm"] else 1)
    assert doc["device"] == "cpu"
    assert [p["rows"] for p in doc["phase1_passes"]] == [1000, 800]
    assert all(not p["failed"] for p in doc["phase1_passes"])
    libs = doc["phase1_libraries"]
    # the host builds the native library with g++ and no CUDA kernel; a
    # library it cannot build is reported with the reason
    assert libs["kernels_built"] == [] and libs["kernels_loaded"] == []
    assert libs["native_available"] or libs["native_error"]
    built = doc["phase1_build_dir"]
    assert compile_warm_bench.MANIFEST in built
    if libs["native_available"]:
        assert libs["native_build_s"] > 0
        assert any(f.startswith("libblaze_tpu_torch_native-")
                   and f.endswith(".so") for f in built)
        # phase 3 found the library phase 2 rebuilt: no compile
        assert doc["telemetry_cold_pass"]["compile_count"] == 0
        assert doc["phase3_libraries"]["native_build_s"] is None
    assert doc["sortjoin_raw_rowcounts"] >= 1
    assert set(doc["shape_reduction"]) >= {"join_build"}
    assert capsys.readouterr().out.count("[bench] phase") == 3
