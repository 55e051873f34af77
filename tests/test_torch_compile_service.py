"""The port's compile service (runtime/compile_service.py) against the JAX
package's, on the CPU.

- canonical_capacity and canonical_batch_count are the JAX package's pure
  functions: equal over n in [0, 2^22] (every n to 2^13 and at every
  power-of-two boundary above, where the value can change, plus a seeded
  sample) for both knob settings and two limits.
- stage_attempts, stage_compiled and whole_stage_coverage_pct of one
  catalogue query in `task_scope` equal the JAX package's on each route:
  the dense stage (tpcds q02), the streaming fallback (tpcds q04) and the
  agg-less chain stage (core q1_scan_filter_project); and one run_plan of
  the port's tpcds q02 on the inline route counts chip_smoke.py's
  Q02_STAGE_COUNTS, the counts runner_native expects on the card.
- task_scope deltas, the telemetry_summary line and the manifest round
  trip (persist, load, fingerprint check, sort replay, the --warm CLI)
  behave as the JAX package's.
- Canonicalization is inert in the port (a pinned departure):
  pad_batch_list and canonical_batch return their input and count no
  waste rows, where the JAX package pads (they only note the shapes).
- A g++ build of the native library into a private directory counts one
  compile with its nanoseconds; the second lookup is a hit. With
  BLAZE_TPU_TORCH_BUILD_DIR set, both libraries and the manifest lie
  under it, and a build there counts the same way.
"""

import json
import os

import numpy as np
import pytest

import chip_smoke as smoke
from blaze_tpu.columnar import types as JT
from blaze_tpu.columnar.batch import ColumnBatch as JBatch
from blaze_tpu.config import conf as jconf
from blaze_tpu.runtime import compile_service as jcs
from blaze_tpu.runtime.metrics import MetricsSet as JMetricsSet
from blaze_tpu_torch import kernels, native
from blaze_tpu_torch.columnar import types as T
from blaze_tpu_torch.columnar.batch import ColumnBatch
from blaze_tpu_torch.config import conf
from blaze_tpu_torch.ops.sort_keys import SortSpec
from blaze_tpu_torch.runtime import compile_service as cs
from blaze_tpu_torch.runtime.executor import metric_tree
from blaze_tpu_torch.runtime.metrics import MetricsSet
from torch_parity import both_tables, no_jax_native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAGE_KEYS = ("stage_attempts", "stage_compiled")


def _ns():
    rng = np.random.default_rng(5)
    edges = {(1 << k) + d for k in range(23) for d in (-1, 0, 1)}
    ns = set(range(1 << 13)) | edges | set(
        int(n) for n in rng.integers(0, (1 << 22) + 1, 4096))
    return sorted(n for n in ns if 0 <= n <= 1 << 22)


@pytest.mark.parametrize("enabled", [True, False])
@pytest.mark.parametrize("limit", [1 << 14, 1 << 12])
def test_canonical_functions_equal_jax(monkeypatch, enabled, limit):
    for c in (conf, jconf):
        monkeypatch.setattr(c, "enable_compile_canonicalization", enabled)
        monkeypatch.setattr(c, "canonical_pow2_limit", limit)
    assert conf.min_capacity == jconf.min_capacity
    ns = _ns()
    assert [cs.canonical_capacity(n) for n in ns] == \
        [jcs.canonical_capacity(n) for n in ns]
    assert [cs.canonical_batch_count(n) for n in ns] == \
        [jcs.canonical_batch_count(n) for n in ns]


def test_canonicalization_is_inert():
    """The port pads nothing (an eager program has no per-shape compile);
    the JAX package pads three batches to four."""
    data = {"x": np.arange(10, dtype=np.int64)}
    batches = tuple(ColumnBatch.from_numpy(data, T.Schema(
        [T.Field("x", T.INT64)]), device="cpu") for _ in range(3))
    jbatches = tuple(JBatch.from_numpy(data, JT.Schema(
        [JT.Field("x", JT.INT64)])) for _ in range(3))
    waste = cs.TELEMETRY["canonicalization_waste_rows"]
    assert cs.pad_batch_list(batches, "stage_agg") is batches
    assert cs.canonical_batch(batches[0], "sort_kernel") is batches[0]
    assert cs.TELEMETRY["canonicalization_waste_rows"] == waste
    assert cs.canonical_batch_count(3) == 4
    assert len(jcs.pad_batch_list(jbatches, "stage_agg")) == 4


# ---- the stage counters on each route ----

@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    return both_tables(tmp_path_factory, rows=1 << 12)


def _scoped_runs(tables, tmp_path, suite, q, mode):
    """q through each package's run_plan (mesh off) in its task_scope:
    (port deltas, JAX deltas, port run_info)."""
    from blaze_tpu.spark import tpcds as jtpcds
    from blaze_tpu.spark import validator as jvalidator
    from blaze_tpu.spark.local_runner import run_plan as jrun_plan
    from blaze_tpu_torch.spark import tpcds, validator
    from blaze_tpu_torch.spark.local_runner import run_plan

    port, jax = {"core": (validator, jvalidator),
                 "tpcds": (tpcds, jtpcds)}[suite]
    (paths, frames), (jpaths, jframes) = tables[suite]
    out = []
    for mod, run, svc, ms, p, f, extra in (
            (port, run_plan, cs, MetricsSet(), paths, frames,
             {"device": "cpu"}),
            (jax, jrun_plan, jcs, JMetricsSet(), jpaths, jframes, {})):
        ms.reset()
        info = {}
        plan, _ = mod.QUERIES[q](p, f, mode)
        with svc.task_scope(ms):
            run(plan, num_partitions=4, mesh_exchange="off", run_info=info,
                work_dir=str(tmp_path / mod.__name__), **extra)
        got = {k: ms.values.get(k, 0) for k in STAGE_KEYS}
        got["coverage_pct"] = round(100 * got["stage_compiled"]
                                    / max(got["stage_attempts"], 1))
        out.append((got, info))
    return out[0][0], out[1][0], out[0][1]


@pytest.mark.parametrize("suite,q,route", [
    ("tpcds", "q02", "dense"), ("tpcds", "q04", "fallback"),
    ("core", "q1_scan_filter_project", "chain")])
def test_stage_counters_match_jax(tables, tmp_path, monkeypatch, suite, q,
                                  route):
    no_jax_native(monkeypatch)
    got, want, info = _scoped_runs(tables, tmp_path, suite, q, "bhj")
    assert got == want
    assert got["stage_attempts"] > 0
    # the route: the operators' own tallies (run_info) agree
    assert info["stage_compiled"] == got["stage_compiled"]
    if route == "fallback":
        assert info["stage_fallbacks"] > 0
        assert got["stage_compiled"] < got["stage_attempts"]
    else:
        assert got["stage_compiled"] > 0


def test_q02_inline_counts_are_the_smoke_expectation(tmp_path, monkeypatch):
    """chip_smoke.py's runner_native runs tpcds.py's q02 (BHJ, widened
    scans) inline with the mesh off in task_scope and expects these
    counts: the CPU rehearsal of the same plan."""
    from blaze_tpu_torch.spark.local_runner import run_plan

    for k, v in (("FACT_FILE_ROWS", 1 << 12),
                 ("TPCDS_FILES", {"web_sales": 2, "catalog_sales": 2,
                                  "store_sales": 2}),
                 ("CUSTOMERS", 3000),
                 ("SS_DIMS", (("item", 2000), ("cdemo", 2000),
                              ("store", 40), ("promo", 100))),
                 ("DIM_ROWS", {"item": 2000, "customer": 3000,
                               "customer_address": 1000,
                               "customer_demographics": 2000,
                               "store": 40, "promotion": 100}),
                 ("STORES", 40), ("SR_ROWS", 1 << 10)):
        monkeypatch.setattr(smoke, k, v)
    for k in ("enable_supervisor", "enable_pipeline"):
        monkeypatch.setattr(conf, k, False)
    paths, orc = smoke.write_tpcds(str(tmp_path / "data"), seed=7)
    ms = MetricsSet()
    ms.reset()
    with cs.task_scope(ms):
        out = run_plan(smoke._runner_plan("q02", paths), mesh_exchange="off",
                       work_dir=str(tmp_path / "run"), device="cpu")
    smoke.check_q02(out, orc)
    assert {k: ms.values.get(k, 0) for k in STAGE_KEYS} == \
        smoke.Q02_STAGE_COUNTS


# ---- task_scope, the summary line, metric_tree ----

@pytest.fixture
def fresh(monkeypatch):
    """Each package's TELEMETRY a fresh set for the test."""
    for mod, ms_cls in ((cs, MetricsSet), (jcs, JMetricsSet)):
        tel = ms_cls()
        tel.reset()
        for c in mod._COUNTERS:
            tel.values[c] = 0
        tel.values["whole_stage_coverage_pct"] = 0
        monkeypatch.setattr(mod, "TELEMETRY", tel)


def _script(mod):
    for _ in range(3):
        mod.note_stage_attempt()
    for _ in range(2):
        mod.note_stage_compiled()
    mod._observer("miss", ("stage", 1), 0)
    mod._observer("hit", ("stage", 1), 0)
    mod._observer("hit", ("fused", 2), 0)
    mod._observer("compiled", ("kernel_build", "x"), 2_500_000)


def test_task_scope_and_summary_match_jax(fresh):
    assert cs.telemetry_summary() == jcs.telemetry_summary() == ""
    scoped = []
    for mod, ms_cls in ((cs, MetricsSet), (jcs, JMetricsSet)):
        ms = ms_cls()
        ms.reset()
        with mod.task_scope(ms):
            _script(mod)
        scoped.append(dict(ms.values))
    assert scoped[0] == scoped[1] == {
        "stage_attempts": 3, "stage_compiled": 2, "cache_misses": 1,
        "cache_hits": 2, "compile_count": 1, "compile_ns": 2_500_000}
    assert cs.TELEMETRY.snapshot() == jcs.TELEMETRY.snapshot()
    assert cs.TELEMETRY["whole_stage_coverage_pct"] == 67
    line = cs.telemetry_summary()
    assert line == jcs.telemetry_summary() == (
        "compile_service: compiles=1 compile_ms=2.5 hits=2 misses=1 "
        "waste_rows=0 stage_coverage=67%")


def test_counters_in_metric_tree_and_reports(fresh):
    from blaze_tpu_torch.ops.basic import MemorySourceExec
    from blaze_tpu_torch.runtime import trace

    schema = T.Schema([T.Field("x", T.INT64)])
    root = MemorySourceExec([ColumnBatch.from_numpy(
        {"x": np.arange(4, dtype=np.int64)}, schema, device="cpu")], schema)
    node = metric_tree(root)
    assert node.children[-2].metrics is cs.TELEMETRY
    assert cs.telemetry_summary() == ""
    assert "compile_service:" not in trace.metric_report(root)
    cs.note_build("mxu_accumulate", 1_000_000)
    line = cs.telemetry_summary()
    assert line.startswith("compile_service: compiles=1 compile_ms=1.0")
    assert line in trace.metric_report(root).splitlines()
    assert line in trace.explain_analyze(root, {}).splitlines()


# ---- builds ----

def test_kernel_library_on_disk_is_a_hit(fresh, tmp_path, monkeypatch):
    lib = tmp_path / "libmxu_accumulate-cached.so"
    lib.write_bytes(b"")
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(kernels, "_lib_path", lambda name: lib)
    assert kernels.build_all(["mxu_accumulate"]) == {"mxu_accumulate": lib}
    snap = cs.TELEMETRY.snapshot()
    assert (snap["cache_hits"], snap["compile_count"]) == (1, 0)
    assert cs.registry().entries[repr(("kernel_build", "mxu_accumulate"))][
        "hits"] >= 1


def test_native_build_counts_one_compile_then_a_hit(fresh, tmp_path):
    import shutil

    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the native library")
    path = native.build(tmp_path)
    assert path.parent == tmp_path and path.exists()
    snap = cs.TELEMETRY.snapshot()
    assert (snap["compile_count"], snap["cache_misses"],
            snap["cache_hits"]) == (1, 1, 0)
    assert snap["compile_ns"] > 0
    assert native.build(tmp_path) == path
    snap = cs.TELEMETRY.snapshot()
    assert (snap["compile_count"], snap["cache_hits"]) == (1, 1)
    # the library, renamed into place, and its build lock: no temporary
    # left behind
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        path.name, path.name + ".lock"]


def test_build_dir_override_holds_both_libraries(tmp_path):
    """BLAZE_TPU_TORCH_BUILD_DIR, read at import, is where both libraries
    and the manifest lie; a build there still counts once, then hits."""
    import shutil
    import subprocess
    import sys

    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the native library")
    build = tmp_path / "build"
    code = (
        "import json\n"
        "from blaze_tpu_torch import kernels, native\n"
        "from blaze_tpu_torch.runtime import compile_service as cs\n"
        "paths = [str(kernels.BUILD_DIR), str(kernels._lib_path("
        "'mxu_accumulate').parent), str(native.library_path().parent),\n"
        "         cs.default_manifest_path()]\n"
        "lib = native.build()\n"
        "first = cs.TELEMETRY.snapshot()\n"
        "assert native.build() == lib\n"
        "second = cs.TELEMETRY.snapshot()\n"
        "print(json.dumps({'paths': paths, 'lib': str(lib),\n"
        "                  'first': first, 'second': second}))\n")
    env = dict(os.environ, BLAZE_TPU_TORCH_BUILD_DIR=str(build))
    env.pop("BLAZE_TPU_COMPILE_MANIFEST", None)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["paths"][:3] == [str(build)] * 3
    assert out["paths"][3] == str(build / "compile_manifest.json")
    assert os.path.dirname(out["lib"]) == str(build)
    first, second = out["first"], out["second"]
    assert (first["compile_count"], first["cache_misses"],
            first["cache_hits"]) == (1, 1, 0)
    assert (second["compile_count"], second["cache_hits"]) == (1, 1)
    assert sorted(p.name for p in build.iterdir()) == [
        os.path.basename(out["lib"]), os.path.basename(out["lib"]) + ".lock"]


# ---- the manifest and the warm driver ----

def test_manifest_round_trip_and_replay(tmp_path, monkeypatch):
    schema = T.Schema([T.Field("x", T.INT64), T.Field("s", T.STRING)])
    b = ColumnBatch.from_numpy({"x": np.arange(50, dtype=np.int64)[::-1],
                                "s": [f"k{i}" for i in range(50)]}, schema,
                               device="cpu")
    reg = cs.ShapeRegistry()
    monkeypatch.setattr(cs, "_REGISTRY", reg)
    key = ("sort_kernel", (SortSpec(0).key(),), b.shape_key())
    cs.record_sort_shape(key, b, [SortSpec(0)])
    reg.observe("miss", ("stage", "p"), 0)
    reg.observe("compiled", ("kernel_build", "native"), 7)
    path = str(tmp_path / "m" / "compile_manifest.json")
    assert reg.persist(path) == path
    doc = json.load(open(path))
    assert doc["version"] == cs.MANIFEST_VERSION == jcs.MANIFEST_VERSION
    assert doc["fingerprint"] == cs.fingerprint()
    other = cs.ShapeRegistry()
    assert other.load(path) == 3
    assert other.entries == reg.entries
    assert other.stats()["per_kind"]["kernel_build"]["compile_ns"] == 7
    doc["fingerprint"] = "another-engine"
    assert cs.ShapeRegistry().merge_manifest(doc) == 0
    (entry,) = [e for e in other.entries.values() if e["replay"]]
    assert entry["replay"]["cols"][1]["kind"] == "STRING"
    assert cs.replay_entry(entry, "cpu") is True


def test_warm_cli_builds_and_replays(tmp_path, monkeypatch):
    import shutil

    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the native library")
    # a private build of the native library
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)
    monkeypatch.setattr(cs, "_REGISTRY", cs.ShapeRegistry())
    schema = T.Schema([T.Field("x", T.INT64)])
    b = ColumnBatch.from_numpy({"x": np.arange(9, dtype=np.int64)}, schema,
                               device="cpu")
    seed = cs.ShapeRegistry()
    seed.attach_replay(("sort_kernel", "k"), {
        "type": "sort", "capacity": int(b.capacity), "specs": [[0, True,
                                                                True]],
        "cols": [{"name": "x", "kind": "INT64", "nullable": True,
                  "valid": False}]}, "test")
    manifest = str(tmp_path / "manifest.json")
    seed.persist(manifest)
    out = str(tmp_path / "warm.json")
    assert cs.main(["--warm", "--skip-catalogue", "--device", "cpu",
                    "--manifest", manifest, "--json-out", out]) == 0
    stats = json.load(open(out))
    assert stats["replayed_shapes"] == 1 and stats["cells_run"] == 0
    assert stats["libraries"] == {"native": True}
    assert stats["telemetry"]["compile_count"] >= 1
    with pytest.raises(SystemExit):
        cs.main([])
