"""Write-ahead query journal and driver-crash recovery.

Port of blaze_tpu/runtime/journal.py whole. A replayed journal writes a
`driver_restart` flight dossier under conf.flight_dir
(runtime/flight_recorder.py); a dead writer's stream journal is
registered for adoption (`adoptable_streams`, `claim_adoptable_stream`;
runtime/streaming.resume_stream).

The commit protocol (runtime/artifacts.py) makes each ARTIFACT durable;
this module makes the QUERY durable. Every query appends a crash-atomic
JSONL journal under `conf.journal_dir`: admission, the plan fingerprint,
each stage commit (artifact paths, epochs, checksums) and completion, so
a driver killed mid-query leaves a replayable record of which stages
finished.

At the next driver start `ensure_recovery_scan()` (called beside the
orphan sweep in the local runner) replays every incomplete journal:

  * each journaled stage commit whose artifacts still VERIFY
    (artifacts.verify_pair, plus the journaled data_crc) goes into an
    in-memory resume map keyed by the stage's plan fingerprint; when the
    query is submitted again, the runner reuses the committed pair instead
    of running the map tasks (`journal_replay` trace event,
    `recovered_stages` in run_info);
  * stages that never committed, or whose artifacts fail verification,
    are absent from the map and run normally;
  * the interrupted attempt is billed failed: a terminal
    `complete{status: failed, error: driver_restart}` record settles the
    journal, and a `driver_recovery` trace event marks the replay.

Appends heal a crash-torn tail before writing, then flush and fsync; every
loader skips lines that do not parse. Retention prunes the oldest COMPLETE
journals beyond `conf.journal_retention`; incomplete ones are never pruned.
Everything is gated on `conf.journal_dir`: unset (the default), each hook
costs one check.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
from typing import Any, Dict, List, Optional

from blaze_tpu_torch.config import conf
from blaze_tpu_torch.runtime import artifacts, trace

_JOURNAL_RE = re.compile(r"^journal_(.+)\.jsonl$")

_lock = threading.Lock()
# stage_fp -> harvested stage_commit record (consume-once: take_resume
# pops, so two queries with the same plan can't both claim one attempt's
# artifacts)
_resume: Dict[str, Dict[str, Any]] = {}
_scanned_dirs: set = set()          # recovery scan runs once per dir
_stats = {"journals_scanned": 0, "journals_resumable": 0,
          "journals_failed": 0, "stages_recovered": 0,
          "recovered_queries": 0, "streams_adoptable": 0}
_recovered_qids: set = set()        # exactly-once recovered_queries bump
# stream_id -> journal path of a dead-writer streaming journal found by
# the recovery scan: ADOPTED (streaming.resume_stream) rather than billed
_adoptable_streams: Dict[str, str] = {}

# record kinds that mark a journal as a durable STREAM journal
# (runtime/streaming.py): its checkpoints are the resume input for an
# unbounded query, so retention and the recovery scan treat it as live
# until the stream is settled by a graceful stop
STREAM_KINDS = ("stream_open", "stream_checkpoint")


def journal_path(qid: str, directory: Optional[str] = None) -> str:
    d = directory or conf.journal_dir
    # query ids are hex tokens (trace.new_query_id) but journals can be
    # opened for arbitrary callers — keep the filename shell-safe
    safe = re.sub(r"[^A-Za-z0-9_.-]", "_", qid)
    return os.path.join(d, f"journal_{safe}.jsonl")


class QueryJournal:
    """One query's append-only journal file.

    Records (one JSON object per line, `kind` discriminated):
      admitted      query_id, tenant_id — written at admission
      plan          fingerprint, num_partitions, stages (per-stage kind
                    + base64 serialized plan proto — the log's forensic
                    record of WHAT was admitted, independent of resubmit)
      stage_commit  stage_id, fingerprint, logical_bytes, outputs
                    (map_id, data_path, index_path, epoch, data_crc)
      complete      status ("ok"|"failed"), error — the terminal record
    """

    def __init__(self, qid: str, directory: Optional[str] = None) -> None:
        self.qid = qid
        self.dir = directory or conf.journal_dir
        self.path = journal_path(qid, self.dir)
        self._lock = threading.Lock()
        os.makedirs(self.dir, exist_ok=True)

    def record(self, kind: str, **fields: Any) -> None:
        """Append one record crash-atomically: heal a torn tail, write
        the full line, flush + fsync — after this returns the record
        survives a SIGKILL."""
        rec = {"kind": kind, "query_id": self.qid, "ts": time.time()}
        rec.update(fields)
        line = (json.dumps(rec, default=str) + "\n").encode()
        with self._lock:
            with open(self.path, "ab+") as f:
                if f.tell() > 0:
                    f.seek(-1, os.SEEK_END)
                    if f.read(1) != b"\n":
                        f.write(b"\n")
                f.write(line)
                f.flush()
                os.fsync(f.fileno())

    # -- typed appenders -------------------------------------------------

    def admitted(self, tenant_id: str = "") -> None:
        # the pid is the liveness tag the recovery scan keys on: an
        # incomplete journal whose driver still breathes is a RUNNING
        # query, not a crash (the orphan-sweep idiom)
        self.record("admitted", tenant_id=tenant_id, pid=os.getpid())

    def plan(self, fingerprint: str, num_partitions: int,
             stages: List[Dict[str, Any]]) -> None:
        self.record("plan", fingerprint=fingerprint,
                    num_partitions=num_partitions, stages=stages)

    def stage_commit(self, stage_id: int, fingerprint: str,
                     logical_bytes: int,
                     outputs: List[Dict[str, Any]]) -> None:
        self.record("stage_commit", stage_id=stage_id,
                    fingerprint=fingerprint, logical_bytes=logical_bytes,
                    outputs=outputs)

    def complete(self, status: str, error: str = "") -> None:
        self.record("complete", status=status, error=error)
        prune(self.dir)


def journal_for(qid: str) -> Optional["QueryJournal"]:
    """The query's journal when journaling is on, else None (the one
    truthiness check every hook site pays)."""
    if not conf.journal_dir or not qid:
        return None
    try:
        return QueryJournal(qid)
    except OSError:
        return None


def load_records(path: str) -> List[Dict[str, Any]]:
    """All parseable records of one journal; torn/garbage lines are
    skipped, never fatal (a crash can tear at most the last line)."""
    records: List[Dict[str, Any]] = []
    try:
        with open(path, "rb") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue  # crash-torn line
                if isinstance(rec, dict) and rec.get("kind"):
                    records.append(rec)
    except OSError:
        pass
    return records


def is_complete(records: List[Dict[str, Any]]) -> bool:
    return any(r.get("kind") == "complete" for r in records)


def is_stream(records: List[Dict[str, Any]]) -> bool:
    """True when the journal belongs to a streaming query
    (runtime/streaming.py writes stream_open/stream_checkpoint records)."""
    return any(r.get("kind") in STREAM_KINDS for r in records)


def _stream_settled(records: List[Dict[str, Any]]) -> bool:
    """A stream journal is settled only by a GRACEFUL stop (complete
    status ok) with no stream activity after it — re-opening a stopped
    stream appends fresh stream records and un-settles the journal. A
    complete{failed} record (e.g. billed by a pre-streaming recovery
    scan) never settles it: the checkpoints are still the only resume
    input the stream has."""
    settled = False
    for r in records:
        kind = r.get("kind")
        if kind == "complete" and r.get("status") == "ok":
            settled = True
        elif kind in STREAM_KINDS:
            settled = False
    return settled


def prune(directory: Optional[str] = None) -> int:
    """Drop the oldest COMPLETE journals beyond conf.journal_retention.
    Incomplete journals are never pruned — until the recovery scan
    settles them they are the crash-recovery input."""
    d = directory or conf.journal_dir
    if not d:
        return 0
    try:
        names = [n for n in os.listdir(d) if _JOURNAL_RE.match(n)]
    except OSError:
        return 0
    keep = max(int(conf.journal_retention), 1)
    complete: List[tuple] = []
    for name in names:
        path = os.path.join(d, name)
        records = load_records(path)
        if not is_complete(records):
            continue
        if is_stream(records) and not _stream_settled(records):
            # a long-lived stream's journal is its ONLY resume input:
            # never let retention pressure from a busy batch workload
            # drop it while the stream is live or adoptable, no matter
            # how old the file is or what billed it complete
            continue
        try:
            complete.append((os.path.getmtime(path), path))
        except OSError:
            continue
    complete.sort()
    removed = 0
    for _mtime, path in complete[:max(0, len(complete) - keep)]:
        try:
            os.unlink(path)
            removed += 1
        except OSError:
            pass
    return removed


# ---------------------------------------------------------------------------
# driver-crash recovery scan
# ---------------------------------------------------------------------------


def recovery_stats() -> Dict[str, int]:
    """Process-lifetime recovery counters (monitor exports
    blaze_recovered_queries_total from "recovered_queries")."""
    with _lock:
        return dict(_stats)


def reset() -> None:
    """Clear in-memory recovery state (test isolation) — journal files
    are left alone."""
    with _lock:
        _resume.clear()
        _scanned_dirs.clear()
        _recovered_qids.clear()
        _adoptable_streams.clear()
        for k in _stats:
            _stats[k] = 0


def ensure_recovery_scan(force: bool = False) -> Dict[str, int]:
    """Replay incomplete journals under conf.journal_dir (once per
    process per directory; `force` rescans for tests).

    For every incomplete journal: verified stage commits are harvested
    into the resume map (reused when the query is re-submitted), the
    interrupted attempt is billed failed with a terminal journal record.
    Never raises — recovery must not block a healthy start."""
    summary = {"scanned": 0, "resumable": 0, "billed_failed": 0,
               "stages_recovered": 0, "streams_adoptable": 0}
    d = conf.journal_dir
    if not d or not conf.recovery_enabled:
        return summary
    with _lock:
        if d in _scanned_dirs and not force:
            return summary
        _scanned_dirs.add(d)
    try:
        names = sorted(n for n in os.listdir(d) if _JOURNAL_RE.match(n))
    except OSError:
        return summary
    for name in names:
        path = os.path.join(d, name)
        records = load_records(path)
        if not records or is_complete(records):
            continue
        if _writer_alive(records):
            continue  # a LIVE driver's in-flight query, not a crash
        if is_stream(records):
            # a dead-writer STREAM journal is not billed failed — its
            # checkpoints are the resume input. Register it for adoption
            # (standby takeover / streaming.resume_stream) instead.
            qid = records[0].get("query_id", "")
            if qid and not _stream_settled(records):
                summary["streams_adoptable"] += 1
                with _lock:
                    _adoptable_streams[qid] = path
            continue
        try:
            summary["scanned"] += 1
            _replay_one(path, records, summary)
        except Exception:  # noqa: BLE001 — recovery must never block start
            summary["billed_failed"] += 1
    with _lock:
        _stats["journals_scanned"] += summary["scanned"]
        _stats["journals_resumable"] += summary["resumable"]
        _stats["journals_failed"] += summary["billed_failed"]
        _stats["stages_recovered"] += summary["stages_recovered"]
        _stats["streams_adoptable"] += summary["streams_adoptable"]
    prune(d)
    return summary


def _writer_alive(records: List[Dict[str, Any]]) -> bool:
    """True when the journal's admitted record names a pid that is still
    running (this process included). No admitted record (the crash tore
    the very first line) means no liveness claim — replay it. The LAST
    admitted pid wins: a resumed stream re-stamps its adopter's pid onto
    the same journal, and liveness must track the current writer."""
    pid = next((r.get("pid") for r in reversed(records)
                if r.get("kind") == "admitted" and r.get("pid")), None)
    if not pid:
        return False
    try:
        os.kill(int(pid), 0)
    except ProcessLookupError:
        return False
    except (PermissionError, OSError, ValueError):
        return True  # can't prove it dead: never bill a live query
    return True


def _replay_one(path: str, records: List[Dict[str, Any]],
                summary: Dict[str, int]) -> None:
    qid = records[0].get("query_id", "")
    tenant = next((r.get("tenant_id", "") for r in records
                   if r.get("kind") == "admitted"), "")
    plan_fp = next((r.get("fingerprint", "") for r in records
                    if r.get("kind") == "plan"), "")
    recovered = 0
    discarded = 0
    for rec in records:
        if rec.get("kind") != "stage_commit":
            continue
        fp = rec.get("fingerprint") or ""
        outputs = rec.get("outputs") or []
        if fp and outputs and all(_output_verifies(o) for o in outputs):
            with _lock:
                _resume[fp] = rec
            recovered += 1
        else:
            discarded += 1
    trace.event("driver_recovery", query_id=qid,
                stages_recovered=recovered, stages_discarded=discarded,
                fingerprint=plan_fp)
    if recovered:
        summary["resumable"] += 1
        summary["stages_recovered"] += recovered
    # bill the interrupted attempt failed: the terminal record settles
    # the journal (making it prunable) whether or not anything was
    # salvageable — a RESUMED run writes its own journal under a new qid
    summary["billed_failed"] += 1
    try:
        jnl = QueryJournal(qid or os.path.basename(path),
                           os.path.dirname(path))
        jnl.path = path  # bill the file we scanned, not a re-derived name
        jnl.record("complete", status="failed", error="driver_restart",
                   stages_recovered=recovered, stages_discarded=discarded)
    except OSError:
        pass
    _flight_dossier(qid, tenant, recovered, discarded, plan_fp)


def _flight_dossier(qid: str, tenant: str, recovered: int,
                    discarded: int, plan_fp: str) -> None:
    from blaze_tpu_torch.runtime import flight_recorder

    if not flight_recorder.enabled("driver_restart"):
        return
    flight_recorder.capture(
        "driver_restart", qid or "unknown", tenant_id=tenant or None,
        error="driver restarted with this query in flight",
        detail={"stages_recovered": recovered,
                "stages_discarded": discarded,
                "plan_fingerprint": plan_fp})


def _output_verifies(out: Dict[str, Any]) -> bool:
    data = out.get("data_path", "")
    index = out.get("index_path", "")
    if not data or not index:
        return False
    if not artifacts.verify_pair(data, index):
        return False
    want_crc = out.get("data_crc")
    if want_crc is None:
        return True
    try:
        _offsets, meta = artifacts.read_index(index)
    except Exception:  # noqa: BLE001 — any read failure means unverifiable
        return False
    return meta is None or int(meta["data_crc"]) == int(want_crc)


# -- resume map ---------------------------------------------------------


def take_resume(stage_fp: str) -> Optional[Dict[str, Any]]:
    """Pop the harvested stage_commit record for a stage fingerprint
    (consume-once); None when nothing was recovered for it."""
    if not stage_fp:
        return None
    with _lock:
        return _resume.pop(stage_fp, None)


def resumable_stages() -> int:
    with _lock:
        return len(_resume)


def note_query_recovered(qid: str) -> None:
    """Count a query that reused >= 1 journaled stage (exactly once per
    qid) — the blaze_recovered_queries_total gauge."""
    with _lock:
        if qid in _recovered_qids:
            return
        _recovered_qids.add(qid)
        _stats["recovered_queries"] += 1


def recovered_queries_total() -> int:
    with _lock:
        return _stats["recovered_queries"]


def adoptable_streams() -> Dict[str, str]:
    """{stream_id: journal path} of dead-writer streaming journals the
    recovery scan registered for adoption (consume via
    streaming.resume_stream, which re-stamps the journal's writer pid)."""
    with _lock:
        return dict(_adoptable_streams)


def claim_adoptable_stream(stream_id: str) -> Optional[str]:
    """Pop one adoptable stream registration (consume-once, so two
    adopters can't both resume the same checkpoint chain)."""
    with _lock:
        return _adoptable_streams.pop(stream_id, None)
