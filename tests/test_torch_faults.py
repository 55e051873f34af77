"""The port's fault injection, error taxonomy and resilience ladder
(runtime/faults.py, executor.run_task_with_resilience) against the JAX
package's, on the CPU.

- The taxonomy: `classify` of the same exceptions gives the same
  category in both packages; the card's own errors map as XLA's do: a
  `torch.cuda.OutOfMemoryError` (tested by type, with a message no marker
  matches) is "resource", and a sticky CUDA error (illegal address, launch
  failure, device-side assert) is "fatal".
- The schedule: for the same spec and seed, the fire decisions of a few
  hundred `inject` calls per point, interleaved over several points, are
  equal list for list to the JAX package's, and so are the injection log,
  `_mix`, `backoff_ms` for the same jitter seed and the byte that
  `maybe_corrupt` flips.
- The ladder: the same attempt behaviour gives the same run_info counters
  (retries, degradations by rung, ladder_rung, errors by category) and the
  same outcome in both packages.
"""

import errno
import os

import pytest
import torch

from blaze_tpu.ops.base import TaskKilledError as JKilled
from blaze_tpu.runtime import faults as jfaults
from blaze_tpu.runtime.executor import run_task_with_resilience as jrun_task
from blaze_tpu_torch.config import conf
from blaze_tpu_torch.ops.base import TaskKilledError
from blaze_tpu_torch.runtime import faults
from blaze_tpu_torch.runtime.executor import run_task_with_resilience


@pytest.fixture(autouse=True)
def _clean_faults():
    yield
    for f in (faults, jfaults):
        f.install(None)
        f.reset_telemetry()


# ---- taxonomy ----

PLAIN = [
    lambda: MemoryError("x"),
    lambda: RuntimeError("RESOURCE_EXHAUSTED: out of HBM"),
    lambda: RuntimeError("CUDA out of memory. Tried to allocate 2.00 GiB"),
    lambda: OSError(errno.ECONNRESET, "reset"),
    lambda: OSError(errno.EINTR, "interrupted"),
    lambda: OSError(errno.ENOENT, "missing"),
    lambda: RuntimeError("UNAVAILABLE: device tunnel"),
    lambda: RuntimeError("Connection reset by peer"),
    lambda: NotImplementedError("no such op"),
    lambda: ValueError("boom"),
    lambda: KeyError("k"),
]
TYPED = ["RetryableError", "ResourceExhaustedError", "HungError",
         "CorruptArtifactError", "PlanError", "FatalError", "DeadlineError",
         "StaleAttemptError"]


@pytest.mark.parametrize("make", PLAIN)
def test_classify_plain_errors_match_jax(make):
    assert faults.classify(make()) == jfaults.classify(make())


@pytest.mark.parametrize("name", TYPED)
def test_classify_taxonomy_classes_match_jax(name):
    assert (faults.classify(getattr(faults, name)("x"))
            == jfaults.classify(getattr(jfaults, name)("x")))
    assert getattr(faults, name).category == getattr(jfaults, name).category


def test_classify_killed_matches_jax():
    assert faults.classify(TaskKilledError("k")) == "killed"
    assert jfaults.classify(JKilled("k")) == "killed"


def test_device_oom_is_resource_by_type():
    """The caching allocator's OOM, whatever its message says."""
    e = torch.cuda.OutOfMemoryError("allocator refused the block")
    assert faults.classify(e) == "resource"
    assert isinstance(faults.ensure_classified(e),
                      faults.ResourceExhaustedError)


@pytest.mark.parametrize("msg", [
    "CUDA error: an illegal memory access was encountered",
    "CUDA error: unspecified launch failure",
    "CUDA error: device-side assert triggered",
    "CUDA error: misaligned address",
    "mxu_accumulate launch failed: invalid configuration argument",
])
def test_sticky_cuda_errors_are_fatal(msg):
    """A poisoned context is never retried as a fresh attempt: the ladder
    relays these on the first failure."""
    assert faults.classify(RuntimeError(msg)) == "fatal"
    calls = []

    def attempt():
        calls.append(1)
        raise RuntimeError(msg)

    with pytest.raises(RuntimeError, match=msg.split(": ", 1)[-1]):
        run_task_with_resilience(attempt, run_info={})
    assert calls == [1]


def test_ensure_classified_matches_jax():
    for make in PLAIN:
        a = faults.ensure_classified(make())
        b = jfaults.ensure_classified(make())
        assert type(a).__name__ == type(b).__name__, make()
        assert str(a) == str(b)


# ---- the schedule ----

SPECS = [
    {"seed": 7, "points": {"serde.encode": {"kind": "io", "nth": 3},
                           "op": {"kind": "oom", "nth": 17}}},
    {"seed": 8, "points": {"spill.write": {"kind": "oom", "prob": 0.2},
                           "op.FilterExec": {"kind": "retryable",
                                             "fail_times": 2}}},
    {"seed": 9, "points": {"serde.decode": {"kind": "io", "prob": 0.05},
                           "op": {"kind": "plan", "prob": 0.3},
                           "device.put": {"kind": "fatal", "nth": 250}}},
    {"seed": 123456789, "points": {"io.prefetch": {"kind": "io",
                                                   "prob": 0.5}}},
]
POINTS = ["serde.encode", "serde.decode", "spill.write", "op.FilterExec",
          "op.ParquetScanExec", "device.put", "io.prefetch", "op"]


def _fires(mod, spec, calls=300):
    mod.install(spec)
    seq = []
    for i in range(calls):
        point = POINTS[(i * 7 + i // 3) % len(POINTS)]
        try:
            mod.inject(point)
            seq.append((point, None))
        except mod.FaultError as e:
            seq.append((point, (type(e).__name__, str(e))))
    return seq, list(mod.injection_log)


@pytest.mark.parametrize("spec", SPECS)
def test_fire_sequences_match_jax(spec):
    seq, log = _fires(faults, spec)
    jseq, jlog = _fires(jfaults, spec)
    assert seq == jseq
    assert log == jlog
    assert any(e is not None for _, e in seq)


@pytest.mark.parametrize("seed", [0, 1, 7, 2 ** 40 + 3])
def test_mix_matches_jax(seed):
    for key in ("op", "serde.encode", "__jitter__", "corrupt.spill#3", ""):
        assert faults._mix(seed, key) == jfaults._mix(seed, key)


@pytest.mark.parametrize("seed", [3, 7, 99])
def test_backoff_matches_jax(seed):
    spec = {"seed": seed, "points": {}}
    faults.install(spec)
    jfaults.install(spec)
    got = [faults.backoff_ms(a) for a in range(6)]
    assert got == [jfaults.backoff_ms(a) for a in range(6)]
    base = conf.retry_backoff_ms
    for a, ms in enumerate(got):
        assert base * 2 ** a * 0.75 <= ms <= base * 2 ** a * 1.25


def test_maybe_corrupt_flips_the_jax_byte(tmp_path):
    spec = {"seed": 5, "points": {"corrupt.shuffle_data": {
        "kind": "corrupt", "fail_times": 3}}}
    payload = bytes(range(256)) * 40
    paths = []
    for mod in (faults, jfaults):
        mod.install(spec)
        p = tmp_path / f"{mod.__name__}.data"
        p.write_bytes(payload)
        for _ in range(4):
            mod.maybe_corrupt("corrupt.shuffle_data", str(p))
        paths.append(p)
    got, want = (p.read_bytes() for p in paths)
    assert got == want != payload
    assert faults.TELEMETRY["faults_injected"] == 3


def test_corrupt_rules_never_raise_through_inject():
    faults.install({"points": {"serde.encode": {"kind": "corrupt"}}})
    faults.inject("serde.encode")
    assert faults.injection_log == []


def test_stall_delays_then_continues():
    faults.install({"points": {"op": {"kind": "stall", "nth": 1,
                                      "ms": 30}}})
    faults.inject("op.FilterExec")  # returns after ~30 ms, no raise
    assert faults.TELEMETRY["stalls_injected"] == 1


def test_net_points_name_the_shuffle_server():
    """A net.* point arms the shuffle server's NET_HOOK, as in the JAX
    package; an empty spec disarms it."""
    from blaze_tpu_torch.runtime import shuffle_server

    faults.install({"points": {"net.shuffle.fetch": {"kind": "reset"}}})
    assert shuffle_server.NET_HOOK is faults.net_rule
    assert shuffle_server.net_rule("net.shuffle.fetch")["kind"] == "reset"
    faults.install(None)
    assert shuffle_server.NET_HOOK is None
    assert conf.fault_injection_spec == {}


def test_known_points_match_jax():
    assert faults.KNOWN_POINTS == jfaults.KNOWN_POINTS
    assert faults.CORRUPT_POINTS == jfaults.CORRUPT_POINTS
    assert faults.NATIVE_CATEGORY_CODES == jfaults.NATIVE_CATEGORY_CODES


# ---- the ladder ----


@pytest.fixture
def no_sleep(monkeypatch):
    slept = []
    monkeypatch.setattr(faults, "_sleep", slept.append)
    monkeypatch.setattr(jfaults, "_sleep", lambda s: None)
    return slept


def _scenario(mod, kind):
    """An attempt that fails by `kind`'s script, and its fallback."""
    calls = []

    def attempt():
        calls.append(1)
        n = len(calls)
        if kind == "retry_twice" and n < 3:
            raise mod.RetryableError("flaky")
        if kind == "always_io":
            raise OSError(errno.ECONNRESET, "reset")
        if kind == "oom_once" and n == 1:
            raise mod.ResourceExhaustedError("oom")
        if kind == "oom_twice" and n < 3:
            raise mod.ResourceExhaustedError("oom")
        if kind == "oom_always":
            raise MemoryError("oom")
        if kind == "plan":
            raise NotImplementedError("no such op")
        if kind == "hung_twice" and n < 3:
            raise mod.HungError("hung")
        return f"ok{n}"

    return attempt, calls


LADDER = ["retry_twice", "always_io", "oom_once", "oom_twice",
          "oom_always", "plan", "hung_twice"]


@pytest.mark.parametrize("fallback", [False, True])
@pytest.mark.parametrize("kind", LADDER)
def test_ladder_counters_match_jax(no_sleep, kind, fallback):
    outs = []
    for mod, run in ((faults, run_task_with_resilience),
                     (jfaults, jrun_task)):
        attempt, calls = _scenario(mod, kind)
        info = {}
        try:
            got = run(attempt, run_info=info, what="t",
                      fallback=(lambda: "fb") if fallback else None)
        except Exception as e:  # noqa: BLE001 - the outcome compared
            got = (type(e).__name__, str(e))
        outs.append((got, len(calls), info))
    assert outs[0] == outs[1]


def test_ladder_restores_the_batch_target(no_sleep):
    old = conf.target_batch_bytes
    seen = []

    def attempt():
        seen.append(conf.target_batch_bytes)
        if len(seen) == 1:
            raise faults.ResourceExhaustedError("oom")
        return "ok"

    assert run_task_with_resilience(attempt) == "ok"
    assert seen == [old, max(old // 2, 1 << 20)]
    assert conf.target_batch_bytes == old


def test_deadline_clamps_backoff_and_reclassifies(no_sleep):
    import time

    def attempt():
        raise faults.RetryableError("flaky")

    with pytest.raises(faults.DeadlineError):
        run_task_with_resilience(attempt, deadline=time.monotonic() - 1)


def test_killed_is_never_retried(no_sleep):
    info = {}

    def attempt():
        raise TaskKilledError("stop")

    with pytest.raises(TaskKilledError):
        run_task_with_resilience(attempt, run_info=info)
    assert no_sleep == [] and info == {}


def test_orphans_swept_counted(tmp_path):
    dead = 2 ** 22 + 12345  # no such pid
    (tmp_path / f"x.data.inprogress.{dead}.0").write_bytes(b"x")
    from blaze_tpu_torch.runtime import artifacts

    before = faults.TELEMETRY.snapshot()
    assert len(artifacts.sweep_orphans([str(tmp_path)])) == 1
    info = {}
    faults.run_info_delta(before, info)
    assert info == {"orphans_swept": 1}
    assert os.listdir(tmp_path) == []
