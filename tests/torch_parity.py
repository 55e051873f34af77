"""Helpers the port's parity tests share with no jax import of their own.

`no_jax_native(monkeypatch)` takes the JAX package's native layer
(blaze_tpu/native, the ctypes-loaded C++ library) out of a test: its
`available()` answers False, which is the JAX package's own pure-Python
route when the library is absent (blaze_tpu/native/__init__.py). Its
serde then encodes frames in Python and its shuffle writer is the Python
one; both write the bytes the native ones write. This steadies the tests
that run the JAX package's `run_plan` next to the port's: the library is
built by tests/test_native.py (`make -C native`) in another worker, and a
test that loads it half-written fails ("file too short"); and a native
call from a pipeline thread has crashed a worker before. Only
tests/test_torch_shuffle.py's native-writer case loads the library, from
a copy it builds itself.
"""


def no_jax_native(monkeypatch) -> None:
    from blaze_tpu import native

    monkeypatch.setattr(native, "available", lambda: False)


# run_info counters the resilience ladder, the breaker and the supervisor
# write (the names are the JAX package's)
RESILIENCE_KEYS = ("retries", "degradations", "ladder_rung",
                   "task_fallbacks", "faults_injected", "breaker_trips",
                   "breaker_reroutes", "hangs_detected", "stalls_injected",
                   "deadline_kills", "speculations_launched",
                   "speculations_won")


def assert_same_stages(info: dict, jinfo: dict) -> None:
    """The port at its defaults (the mesh exchange on, one device) against
    the JAX package with the mesh off: as many shuffle stages, mesh and
    file together, and broadcast stages; and as many map tasks on the
    file path exactly when no stage took the mesh (a mesh stage runs its
    own map tasks, which map_tasks_run does not count)."""
    assert info["mesh_stages"] + info["file_stages"] == jinfo["file_stages"]
    assert info["broadcast_stages"] == jinfo["broadcast_stages"]
    assert (info["map_tasks_run"] == jinfo["map_tasks_run"]) == (
        info["mesh_stages"] == 0)
    assert info["map_tasks_run"] <= jinfo["map_tasks_run"]


def resilience(info: dict) -> dict:
    """The resilience counters of a run_info dict."""
    return {k: v for k, v in info.items()
            if k in RESILIENCE_KEYS
            or k.startswith(("errors.", "degraded."))}


def both_tables(tmp_path_factory, rows: int) -> dict:
    """{suite: ((port paths, frames), (JAX paths, frames))} for the
    validator's core catalogue and the TPC-DS catalogue, each package's
    tables written from the same seed by its own generator."""
    from blaze_tpu.spark import tpcds as jtpcds
    from blaze_tpu.spark import validator as jvalidator
    from blaze_tpu_torch.spark import tpcds, validator

    out = {}
    for suite, (port, jax) in {"core": (validator, jvalidator),
                               "tpcds": (tpcds, jtpcds)}.items():
        d = tmp_path_factory.mktemp(suite)
        (d / "port").mkdir()
        (d / "jax").mkdir()
        out[suite] = (port.generate_tables(str(d / "port"), rows=rows),
                      jax.generate_tables(str(d / "jax"), rows=rows))
    return out


def run_both(tables, tmp_path, suite, q, mode, spec=None, parts=4):
    """One query through each package's run_plan at its defaults but for
    the mesh exchange, off on both sides (the shuffle stages' map tasks
    then run under the supervisor and the ladder, where the fault points
    act), under the same fault spec installed in each: ((port rows,
    run_info), (JAX rows, run_info)). Each package's answer is checked
    against its validator's pandas oracle."""
    from blaze_tpu.runtime import faults as jfaults
    from blaze_tpu.spark import tpcds as jtpcds
    from blaze_tpu.spark import validator as jvalidator
    from blaze_tpu.spark.local_runner import run_plan as jrun_plan
    from blaze_tpu_torch.runtime import faults
    from blaze_tpu_torch.spark import tpcds, validator
    from blaze_tpu_torch.spark.local_runner import run_plan

    port, jax = {"core": (validator, jvalidator),
                 "tpcds": (tpcds, jtpcds)}[suite]
    (paths, frames), (jpaths, jframes) = tables[suite]
    runs = []
    for mod, val, run, flt, p, f, extra in (
            (port, validator, run_plan, faults, paths, frames,
             {"device": "cpu", "mesh_exchange": "off"}),
            (jax, jvalidator, jrun_plan, jfaults, jpaths, jframes,
             {"mesh_exchange": "off"})):
        plan, oracle = mod.QUERIES[q](p, f, mode)
        info = {}
        flt.install(spec)
        try:
            out = run(plan, num_partitions=parts,
                      work_dir=str(tmp_path / mod.__name__), run_info=info,
                      **extra)
        finally:
            flt.install(None)
        assert val._compare(val._to_pandas(out).reset_index(drop=True),
                            oracle().reset_index(drop=True)) is None
        runs.append((out.to_numpy(), info))
    return runs[0], runs[1]
