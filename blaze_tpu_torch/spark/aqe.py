"""Adaptive re-optimization between stages (the AQE interplay).

Port of blaze_tpu/spark/aqe.py. Ref: Spark's AQE re-plans each query stage
with runtime statistics; the reference re-enters its conversion per stage
and forces AQE on (BlazeSparkSessionExtension.scala:33-34, shims AQE node
recognition, ShimsImpl.scala:271-299). The flagship AQE rewrite is dynamic
join selection: once a shuffle map stage has RUN and its output is small,
a planned sort-merge join over that shuffle becomes a broadcast join.

This module applies that rewrite at the PROTO level between stages in the
local runner: a `sort_merge_join` whose one input is an `ipc_reader` over
a completed shuffle with total bytes <= `conf.aqe_broadcast_threshold`
is replaced by a `broadcast_join` building from the small side — the
already-shuffled data is reused by reading ALL partitions of that shuffle
on every task (Spark's local-shuffle-reader + broadcast conversion).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

from blaze_tpu_torch.config import conf
from blaze_tpu_torch.plan import plan_pb2 as pb
from blaze_tpu_torch.runtime import resources


def _reader_shuffle_sid(node: pb.PlanNode) -> Optional[Tuple[int, str]]:
    """(shuffle sid, resource id) when the subtree is exactly an ipc_reader
    over a shuffle (optionally under a Sort — Spark plans SMJ children as
    Sort over the exchange)."""
    which = node.WhichOneof("node")
    if which == "sort":
        return _reader_shuffle_sid(node.sort.input)
    if which != "ipc_reader":
        return None
    rid = node.ipc_reader.provider_resource_id
    # rids may carry a "<query_id>/" namespace prefix (concurrent queries);
    # parse the local part, keep the full rid for resource lookups
    local = rid.rsplit("/", 1)[-1]
    if not local.startswith("shuffle:"):
        return None
    return int(local.split(":", 1)[1]), rid


def _all_partitions_resource(rid: str, nparts: int) -> str:
    """Register (once) a provider that chains every partition of a shuffle
    — the broadcast build side needs the WHOLE relation on each task."""
    all_rid = f"{rid}:all"
    if resources.try_get(all_rid) is None:
        base = resources.get(rid)

        def provider(_partition: int):
            for p in range(nparts):
                src = base(p)
                for item in src:
                    yield item

        resources.put(all_rid, provider)
    return all_rid


def _rewrite_reader(node: pb.PlanNode, all_rid: str) -> None:
    """Point the build-side subtree at the all-partitions resource AND
    strip any Sort wrapper — the broadcast join sorts its build side
    itself, so a retained Sort would re-sort the whole relation once per
    task for nothing."""
    which = node.WhichOneof("node")
    if which == "sort":
        inner = pb.PlanNode()
        inner.CopyFrom(node.sort.input)
        node.CopyFrom(inner)
        _rewrite_reader(node, all_rid)
        return
    node.ipc_reader.provider_resource_id = all_rid


def apply_dynamic_join_selection(plan: pb.PlanNode,
                                 shuffle_bytes: Dict[int, int],
                                 shuffle_parts: Dict[int, int]) -> int:
    """Rewrite eligible SMJs to broadcast joins in place; returns the
    number of conversions (for metrics/tests)."""
    threshold = int(conf.aqe_broadcast_threshold)
    if threshold <= 0:
        return 0
    converted = 0
    which = plan.WhichOneof("node")
    if which is None:
        return 0
    node = getattr(plan, which)

    if which == "sort_merge_join":
        left_info = _reader_shuffle_sid(node.left)
        right_info = _reader_shuffle_sid(node.right)

        def size_of(info):
            if info is None or info[0] not in shuffle_bytes:
                return None
            return shuffle_bytes[info[0]]

        lsize, rsize = size_of(left_info), size_of(right_info)
        # the build side must be the NON-PRESERVED side: per-task unmatched
        # emission of a broadcast preserved side would duplicate rows
        # across tasks (Spark's canBroadcastBySize + build-side rules).
        # FULL preserves both sides -> never convertible.
        jt = node.join_type
        can_build_left = jt in (pb.JOIN_INNER, pb.JOIN_RIGHT)
        can_build_right = jt in (pb.JOIN_INNER, pb.JOIN_LEFT,
                                 pb.JOIN_LEFT_SEMI, pb.JOIN_LEFT_ANTI,
                                 pb.JOIN_EXISTENCE)
        candidates = []
        if can_build_left and lsize is not None and lsize <= threshold:
            candidates.append(("left", left_info, lsize))
        if can_build_right and rsize is not None and rsize <= threshold:
            candidates.append(("right", right_info, rsize))
        if candidates:
            side, info, _ = min(candidates, key=lambda c: c[2])
            sid, rid = info
            bj = pb.BroadcastJoinNode()
            bj.left.CopyFrom(node.left)
            bj.right.CopyFrom(node.right)
            for o in node.on:
                bj.on.add().CopyFrom(o)
            bj.join_type = node.join_type
            bj.build_is_left = side == "left"
            if node.HasField("join_filter"):
                bj.join_filter.CopyFrom(node.join_filter)
            if node.existence_name:
                bj.existence_name = node.existence_name
            all_rid = _all_partitions_resource(rid, shuffle_parts[sid])
            _rewrite_reader(bj.left if side == "left" else bj.right,
                            all_rid)
            plan.broadcast_join.CopyFrom(bj)
            converted += 1
            node = plan.broadcast_join

    for fd, val in node.ListFields():
        if fd.message_type is not None and fd.message_type.name == "PlanNode":
            if fd.is_repeated:
                for child in val:
                    converted += apply_dynamic_join_selection(
                        child, shuffle_bytes, shuffle_parts)
            else:
                converted += apply_dynamic_join_selection(
                    val, shuffle_bytes, shuffle_parts)
    return converted
