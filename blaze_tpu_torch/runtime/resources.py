"""Task-resource handoff registry.

Ref: JniBridge.resourcesMap (JniBridge.java:26,42-44) — the string-keyed map
the JVM uses to hand native tasks live objects (fs providers, shuffle IPC
iterators, FFI export iterators, broadcast consumers). Identical role: plan
nodes carry a resource id, the embedding layer registers the object before
execution, operators resolve it lazily.
"""

from __future__ import annotations

import threading
import uuid
from typing import Any, Dict

_lock = threading.Lock()
_resources: Dict[str, Any] = {}


def put(key: str, value: Any) -> str:
    with _lock:
        _resources[key] = value
    return key


def register(value: Any, prefix: str = "res") -> str:
    return put(f"{prefix}:{uuid.uuid4().hex}", value)


def get(key: str) -> Any:
    with _lock:
        if key not in _resources:
            raise KeyError(f"resource not registered: {key}")
        return _resources[key]


def try_get(key: str) -> Any:
    with _lock:
        return _resources.get(key)


def pop(key: str) -> Any:
    with _lock:
        return _resources.pop(key, None)


def keys() -> list:
    """Snapshot of registered resource ids — leak checks walk this for
    leftover query-namespaced entries after a run finishes."""
    with _lock:
        return sorted(_resources)


def clear() -> None:
    with _lock:
        _resources.clear()
