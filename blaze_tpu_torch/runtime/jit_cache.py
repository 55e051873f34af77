"""Process-wide cache of built per-plan callables, keyed on plan structure.

Port of blaze_tpu/runtime/jit_cache.py. Operators are rebuilt per task, so
a task that builds a closure for its plan (the executor's fused map chain,
the stage compiler's probe, dense and chain programs) keys it on the
plan's structural key and shape: the same plan and batch layout reuse one
callable across tasks. The hit and miss counts and the observer protocol
are the JAX module's: the compile service (runtime/compile_service.py)
registers its shape registry as the observer, which turns the events into
its cache_hits / cache_misses counters and compile_* trace events.

What differs: PyTorch runs eagerly, so there is no program to compile.
`jit` is accepted and ignored; a miss builds `make_fn()` once, emits
"miss", and emits no "compiled" event (a library build does, see
`kernels.build_all` and `native`). The JAX module's stale-executable
retry guards an XLA dispatch inconsistency that has no counterpart here.

A cached callable outlives the task that built it, so it holds no tensor
of a task: the closures capture compiled expressions, schemas and plan
statics, and build their constants on each call's batch device.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Hashable

_lock = threading.Lock()
_cache: Dict[Hashable, Callable] = {}
_stats = {"hits": 0, "misses": 0}
# single observer slot (runtime/compile_service registers its shape
# registry here): called as observer(event, key, ns) with event in
# {"hit", "miss", "compiled"}, outside _lock, exceptions swallowed
_observer = None


def set_observer(fn) -> None:
    global _observer
    _observer = fn


def _notify(event: str, key: Hashable, ns: int = 0) -> None:
    obs = _observer
    if obs is not None:
        try:
            obs(event, key, ns)
        except Exception:
            pass


def get_or_compile(key: Hashable, make_fn: Callable[[], Callable],
                   jit: bool = True, **jit_kwargs) -> Callable:
    """Return the callable cached under `key`, building it once with
    `make_fn()`. `jit` and `jit_kwargs` are the JAX module's signature and
    change nothing here."""
    with _lock:
        fn = _cache.get(key)
        if fn is not None:
            _stats["hits"] += 1
    if fn is not None:
        _notify("hit", key)
        return fn
    with _lock:
        _stats["misses"] += 1
    _notify("miss", key)
    from blaze_tpu_torch.runtime import faults

    faults.inject("jit.compile")
    built = make_fn()
    with _lock:
        return _cache.setdefault(key, built)


def stats() -> Dict[str, int]:
    with _lock:
        return dict(_stats)


def clear() -> None:
    with _lock:
        _cache.clear()
        _stats.update(hits=0, misses=0)
