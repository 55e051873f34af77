"""Hive/Scala/Python UDF recognition + evaluator registry.

Port of blaze_tpu/spark/hive_udf.py.

Ref: HiveUDFUtil.scala detects Hive UDF expressions and serializes them
for the SparkUDFWrapper path (NativeConverters.scala:336-371): the JVM
keeps the closure, the native engine computes the param columns and ships
a row batch across FFI for evaluation (SparkUDFWrapperContext.scala).

Out of process, a JVM closure cannot be shipped, so the contract becomes
registration-by-name: the embedding registers a Python evaluator for each
UDF name it wants accelerated plans to keep (the analog of the wrapper
context living on the JVM). Plan-JSON decoding then lowers
HiveSimpleUDF / HiveGenericUDF / ScalaUDF / PythonUDF trees to
`ir.UdfWrapper` whose resource callback adapts the registered evaluator
to the engine's interleaved param-column crossing
(exprs/compiler._compile_udf_wrapper). Unregistered UDFs raise at decode
time — there is nothing on this side that could run them.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from blaze_tpu_torch.columnar import types as T
from blaze_tpu_torch.exprs import ir

# Catalyst expression classes that carry an engine-external function
UDF_CLASSES = ("HiveSimpleUDF", "HiveGenericUDF", "ScalaUDF", "PythonUDF")

# name(lower) -> (fn(*object_arrays) -> array, return_type, nullable)
_REGISTRY: Dict[str, Tuple[Callable, T.DataType, bool]] = {}


def register_udf(name: str, fn: Callable[..., np.ndarray],
                 return_type: T.DataType, nullable: bool = True) -> None:
    """Register an evaluator; also exposed to the row interpreter (under
    the collision-proof "udf:" spelling only — a bare-name registration
    would shadow builtin fallback fns) and refreshed in the engine's
    resource registry so re-registration doesn't leave a stale adapter."""
    from blaze_tpu_torch.runtime import resources
    from blaze_tpu_torch.spark.fallback import register_python_fn

    _REGISTRY[name.lower()] = (fn, return_type, nullable)
    register_python_fn(f"udf:{name}", fn)  # the ScalarFn spelling the
    # decoder emits for interpreter-only (string-returning) UDFs
    rid = f"udf:{name.lower()}"
    resources.pop(rid)
    if not (return_type.is_string_like
            or return_type.kind in (T.TypeKind.LIST, T.TypeKind.MAP,
                                    T.TypeKind.STRUCT)):
        resources.put(rid, _adapter(fn, return_type))


def lookup(name: str) -> Optional[Tuple[Callable, T.DataType, bool]]:
    return _REGISTRY.get(name.lower())


def udf_name(tree: dict) -> Optional[str]:
    """The UDF's registered name in the TreeNode JSON. HiveSimpleUDF /
    HiveGenericUDF carry `name` ("db.fn"); ScalaUDF an optional
    `udfName`; PythonUDF `name`."""
    for field in ("name", "udfName"):
        v = tree.get(field)
        if isinstance(v, str) and v:
            return v.rsplit(".", 1)[-1]
        if isinstance(v, list) and v and isinstance(v[0], str):
            return v[0].rsplit(".", 1)[-1]  # Option[String] as [value]
    return None


def _decode_strings(b: np.ndarray, lens: np.ndarray, ok: np.ndarray,
                    n: int) -> np.ndarray:
    out = np.empty(n, object)
    for r in range(n):
        out[r] = (bytes(b[r, :lens[r]]).decode("utf-8", "replace")
                  if ok[r] else None)
    return out


def _adapter(fn: Callable, ret: T.DataType):
    """Adapt a per-column evaluator to the engine's UdfWrapper resource
    contract: interleaved (values[, lengths], validity) arrays per param
    plus num_rows; returns (values, validity) at full capacity. String
    params are detected structurally (2-D uint8 byte matrices)."""

    def evaluate(*args):
        n = int(args[-1])
        arrs: List[np.ndarray] = []
        i = 0
        flat = args[:-1]
        while i < len(flat):
            a = np.asarray(flat[i])
            if a.ndim == 2 and a.dtype == np.uint8:
                lens = np.asarray(flat[i + 1])
                ok = np.asarray(flat[i + 2])
                arrs.append(_decode_strings(a, lens, ok, n))
                i += 3
            else:
                # an object column of numpy scalars (np.int64, np.float32,
                # np.bool_, as the JAX package's row loop hands them), None
                # where invalid; built whole, not row by row
                ok = np.asarray(flat[i + 1])
                col = np.fromiter(a[:n], object, n)
                col[~ok[:n]] = None
                arrs.append(col)
                i += 2
        import pandas as pd

        out = np.asarray(fn(*arrs))
        validity = ~pd.isna(out)
        vals = np.where(validity, out, 0)
        return vals.astype(ret.np_dtype()), validity.astype(bool)

    return evaluate


def decode_json_udf(tree: dict, decode_child) -> ir.Expr:
    """Lower a UDF TreeNode to ir.UdfWrapper with a registered resource
    (engine path); raises for unknown names or engine-unsupported return
    types so the caller's conversion falls back."""
    from blaze_tpu_torch.runtime import resources
    from blaze_tpu_torch.spark.plan_json import PlanJsonError

    name = udf_name(tree)
    if name is None:
        raise PlanJsonError(f"UDF without a name: {tree.get('class')}")
    hit = lookup(name)
    if hit is None:
        raise PlanJsonError(
            f"UDF '{name}' has no registered evaluator "
            "(blaze_tpu_torch.spark.hive_udf.register_udf)")
    fn, ret, nullable = hit
    if ret.is_string_like or ret.kind in (T.TypeKind.LIST, T.TypeKind.MAP,
                                          T.TypeKind.STRUCT):
        # the jit wrapper computes fixed-width returns only
        # (exprs/compiler.py); string-returning UDFs run on the row
        # interpreter via the PYTHON_FNS registration instead
        return ir.ScalarFn(f"udf:{name}", tuple(
            decode_child(c) for c in tree["children"]))
    rid = f"udf:{name.lower()}"
    # the adapter is installed by register_udf (and refreshed there on
    # re-registration); decode only references it
    if resources.try_get(rid) is None:
        resources.put(rid, _adapter(fn, ret))
    return ir.UdfWrapper(rid, ret, nullable,
                         tuple(decode_child(c) for c in tree["children"]))
