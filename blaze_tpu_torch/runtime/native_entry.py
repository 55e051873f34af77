"""Python side of the native callNative contract.

Port of blaze_tpu/runtime/native_entry.py, with its functions (ref: the
reference's callNative decodes a TaskDefinition, builds the plan and
streams Arrow batches back over FFI, blaze/src/exec.rs:86-131,
rt.rs:38-205). The C++ layer (csrc/task_runtime.cpp, built into the
library of blaze_tpu_torch/native) calls `run_task_serialized(bytes) ->
bytes`: decode the TaskDefinition, execute the plan on this process's
engine, and return the concatenated BTB1 result frames.

Each task runs on the CUDA card unless the embedding asked for the host
(`set_device("cpu")`, which `native.init(device=...)` calls: bn_init's C
signature carries no device). Without CUDA and without that request a task
raises. A task runs through the whole-stage path first, as the port's
driver runs its tasks (runtime/executor.execute_stage_or_plan: a dense
aggregation stage launches the accumulate kernel once a batch; agg-less
chains stream), where the JAX module streams every plan. Errors cross the
boundary classified (faults.ensure_classified); a host-requested kill
arrives as category 5.
"""

from __future__ import annotations

import struct
import threading

from blaze_tpu_torch.columnar import serde
from blaze_tpu_torch.config import conf
from blaze_tpu_torch.device import DeviceLike, resolve_device
from blaze_tpu_torch.ops.base import ExecContext
from blaze_tpu_torch.runtime import faults
from blaze_tpu_torch.runtime.executor import execute_stage_or_plan

# Host-requested kill flag (bn_request_kill / bn_clear_kill /
# bn_kill_requested). The host embedding has no reference to a running
# task's ExecContext, so the flag is process-global here: every native
# task entry wires `is_running` to it and execution notices at the next
# batch boundary — the JniBridge.isTaskRunning contract, over the C ABI.
_task_killed = threading.Event()
# where native tasks run: None is the CUDA card
_device: DeviceLike = None


def set_device(device: DeviceLike) -> None:
    """Where the following native tasks run (None: the CUDA card)."""
    global _device
    _device = device


def error_category_code(exc: BaseException) -> int:
    """faults category -> NATIVE_CATEGORY_CODES wire code for `exc`
    (what bn_last_error_category reports after a failed bn_call)."""
    return faults.NATIVE_CATEGORY_CODES.get(faults.classify(exc), 4)


def exception_for_code(code: int, msg: str = "") -> Exception:
    """Inverse mapping: rebuild a taxonomy exception from a wire code."""
    cat = faults.NATIVE_CODE_CATEGORIES.get(code, "fatal")
    if cat == "killed":
        from blaze_tpu_torch.ops.base import TaskKilledError

        return TaskKilledError(msg or "task killed")
    cls = faults.CATEGORY_CLASSES.get(cat, faults.FatalError)
    return cls(msg or f"native error category {cat}")


def init(mem_budget_bytes: bytes) -> None:
    """bn_init hook: set the engine memory budget (little-endian i64)."""
    from blaze_tpu_torch.runtime import memory

    (budget,) = struct.unpack("<q", mem_budget_bytes)
    if budget > 0:
        memory.init(budget)


def spill(bytes_needed_le: bytes) -> bytes:
    """bn_spill hook: the host asks the engine to release memory; operator
    state spills to disk and the freed byte count returns (little-endian
    i64). Ref: OnHeapSpillManager.scala:61-144."""
    from blaze_tpu_torch.runtime import memory

    (needed,) = struct.unpack("<q", bytes_needed_le)
    freed = memory.get_manager().release(max(int(needed), 0))
    return struct.pack("<q", freed)


def request_kill(_payload: bytes = b"") -> bytes:
    """bn_request_kill hook: cooperatively cancel the running native
    task(s); checked at every batch boundary."""
    _task_killed.set()
    return b""


def clear_kill(_payload: bytes = b"") -> bytes:
    """bn_clear_kill hook: re-arm after a kill (next task may run)."""
    _task_killed.clear()
    return b""


def kill_requested() -> bool:
    return _task_killed.is_set()


def kill_state(_payload: bytes = b"") -> bytes:
    """bn_kill_requested hook: the flag as one byte (b"\\x01"/b"\\x00")."""
    return b"\x01" if _task_killed.is_set() else b"\x00"


def _native_ctx(partition_id: int) -> ExecContext:
    return ExecContext(partition=partition_id,
                       is_running=lambda: not _task_killed.is_set(),
                       device=resolve_device(_device))


def _run(task_def: bytes, arrow: bool = False) -> bytes:
    """Decode and run one task: its result frames, after the Arrow
    payload's schema header when `arrow`."""
    from blaze_tpu_torch.plan import decode_task_definition

    plan, td = decode_task_definition(task_def)
    ctx = _native_ctx(td.partition_id)
    out = bytearray(arrow_payload_header(plan.schema) if arrow else b"")
    for batch in execute_stage_or_plan(plan, ctx):
        out += serde.serialize_batch(batch)
    if conf.monitor_enabled:
        from blaze_tpu_torch.runtime import monitor

        # result payload crossing the C ABI: the frames inside it were
        # already counted as serde copies when built
        monitor.count_move("ffi", len(out))
    return bytes(out)


def run_task_serialized(task_def: bytes) -> bytes:
    try:
        return _run(task_def)
    except Exception as e:  # noqa: BLE001 — classified for the C ABI
        # the faults taxonomy must cross the boundary labelled: the C++
        # layer reads `category` off the exception instance to fill
        # bn_last_error_category for the host scheduler
        raise faults.ensure_classified(e) from e


def _arrow_code(dtype):
    from blaze_tpu_torch.columnar.types import TypeKind as K

    if dtype.wide_decimal:
        return 13
    return {
        K.BOOLEAN: 1, K.INT8: 2, K.INT16: 3, K.INT32: 4, K.INT64: 5,
        K.FLOAT32: 6, K.FLOAT64: 7, K.STRING: 8, K.BINARY: 9,
        K.DATE: 10, K.TIMESTAMP: 11, K.DECIMAL: 12,
    }.get(dtype.kind)


def arrow_payload_header(schema) -> bytes:
    """BTAS header: field names + type codes so the C++ stream can build
    the ArrowSchema without parsing the plan protobuf."""
    out = bytearray(b"BTAS")
    out += struct.pack("<H", len(schema.fields))
    for f in schema.fields:
        name = f.name.encode()
        code = _arrow_code(f.dtype)
        if code is None:
            raise ValueError(
                f"arrow stream does not support {f.dtype.kind} columns")
        out += struct.pack("<H", len(name)) + name
        out += struct.pack("<BBii", code, 1 if f.nullable else 0,
                           f.dtype.precision, f.dtype.scale)
    return bytes(out)


def run_task_arrow_payload(task_def: bytes) -> bytes:
    """bn_call_arrow hook: BTAS schema header + the BTB1 result frames,
    which csrc's library turns into a standard Arrow C stream
    (ArrowArrayStream) any Arrow host imports (ref blaze/src/rt.rs:76-80,
    ArrowFFIStreamImportIterator.scala:63-75)."""
    try:
        return _run(task_def, arrow=True)
    except Exception as e:  # noqa: BLE001 — classified for the C ABI
        raise faults.ensure_classified(e) from e
