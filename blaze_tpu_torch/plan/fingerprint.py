"""Canonical plan fingerprints: stable hashes of operator-subtree SHAPE.

Port of blaze_tpu/plan/fingerprint.py, whole. "Same plan" must
survive what legitimately changes between runs of one logical query:
literal values in predicates (`price > 5` vs `price > 7`), scan file
paths and sizes (a regenerated table directory), and task-scoped
artifacts (shuffle data/index paths the runner rewrites per task). The
fingerprint is a sha256 over a canonical token walk of the plan proto
that masks exactly those:

  literals     a ScalarValue contributes only its DataType (the dtype
               changes the program; the value does not)
  file facts   PartitionedFile path/size/range/mtime and the shuffle
               writer's data_file/index_file are dropped; the scan
               *schema* and projection stay in
  namespaces   `*resource_id` fields hash only their local part: the
               per-query "<qid>/" prefix (spark/stages.py) varies every
               run; the local "shuffle:0" / "broadcast:1" form is shape
  everything   else (node kinds, expression operators, column names,
               function/agg enums, join types, partition counts) is
               hashed structurally, so any shape change re-keys

`fingerprint_plan(msg)` hashes one plan proto (a stage's task plan);
`fingerprint_query(stage_fps)` hashes a query's ordered stage hashes;
`fingerprint_operator(op)` hashes a decoded operator tree's `plan_key()`
(the literal-free structure key), the key of the history store's
operator taps and the whole-stage events. The walk and the keys are the
JAX package's, so both packages give one plan the same fingerprints: a
plan_key holds plain Python values (kinds, names, enum values, nested
tuples), whose repr is the same in both.
"""

from __future__ import annotations

import hashlib
from typing import List

# run-varying facts that must not re-key a plan: task-scoped shuffle
# artifact paths, and scan-file identity/stat fields (a re-generated
# table keeps its schema but not its paths or mtimes)
_MASKED_FIELDS = frozenset({
    "data_file", "index_file",           # ShuffleWriterNode (task-scoped)
    "path", "size", "range_start",       # PartitionedFile / ParquetSink
    "range_end", "last_modified_ns",
})

# resource ids carry a per-query namespace ("q123-4/shuffle:0" —
# spark/stages.py); only the local part is plan shape, the qid prefix
# varies every run
_RESOURCE_ID_SUFFIX = "resource_id"

_HEX_CHARS = 16  # 64 bits of sha256 — plenty for a per-project store


def _digest(tokens: List[str]) -> str:
    return hashlib.sha256("\x00".join(tokens).encode()).hexdigest()[
        :_HEX_CHARS]


def _is_repeated(fd) -> bool:
    # protobuf >= 5.x deprecates FieldDescriptor.label in favor of the
    # is_repeated property; support both without tripping the warning
    rep = getattr(fd, "is_repeated", None)
    if rep is not None and not callable(rep):
        return bool(rep)
    return fd.label == fd.LABEL_REPEATED


def _walk(msg, out: List[str]) -> None:
    desc = getattr(msg, "DESCRIPTOR", None)
    if desc is None:  # plain scalar (shouldn't happen at the top level)
        out.append(repr(msg))
        return
    out.append("(" + desc.name)
    if desc.name == "ScalarValue":
        # literal mask: type only — `x > 5` and `x > 7` fingerprint the
        # same; `x > 5` and `x > 'a'` do not
        out.append("lit")
        _walk(msg.dtype, out)
        out.append(")")
        return
    for fd, val in msg.ListFields():
        if fd.name in _MASKED_FIELDS:
            continue
        out.append(fd.name)
        if fd.type == fd.TYPE_MESSAGE:
            if _is_repeated(fd):
                for v in val:
                    _walk(v, out)
            else:
                _walk(val, out)
        elif _is_repeated(fd):
            out.extend(str(v) for v in val)
        elif fd.name.endswith(_RESOURCE_ID_SUFFIX):
            out.append(str(val).rsplit("/", 1)[-1])
        else:
            out.append(str(val))
    out.append(")")


def fingerprint_plan(msg) -> str:
    """Stable hex fingerprint of a plan proto message's shape (literals,
    file paths and task-scoped artifacts masked — see module doc)."""
    tokens: List[str] = []
    _walk(msg, tokens)
    return _digest(tokens)


def fingerprint_operator(op) -> str:
    """Stable hex fingerprint of a decoded Operator tree, derived from
    plan_key(). Hashed into the same opaque-key space history records
    index by (distinct from the proto-side keyspace, which carries more
    shape detail)."""
    return _digest(["opkey", repr(op.plan_key())])


def fingerprint_query(stage_fps: List[str]) -> str:
    """Query-level fingerprint: the ordered stage fingerprints hashed
    together (two runs match iff every stage shape matched, in order)."""
    return _digest(["query"] + list(stage_fps))
