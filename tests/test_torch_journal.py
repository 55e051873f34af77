"""The port's write-ahead query journal and driver-crash recovery
(runtime/journal.py, the runner's resume path) against the JAX package's,
on the CPU.

- Appends, as in tests/test_journal_recovery.py: typed records round
  trip, a torn tail is healed, garbage lines are skipped, retention keeps
  the newest complete journals and never an incomplete one.
- The recovery scan: a dead writer's verified stage commit becomes a
  consume-once resume record and the journal is billed failed
  (`driver_restart`); a live writer's journal is left alone; a commit
  whose artifact fails verification, or whose crc is not the journaled
  one, is discarded; the scan runs once a directory. The summary equals
  the JAX package's on the same journals.
- A journaled run of one query in each package: the same record kinds in
  the same order, the same plan fingerprint and stage fingerprints.
- A run that stops after a committed stage: the next run of the same
  query resumes it, with fewer `map_tasks_run` and the same rows.
"""

import os
import shutil
import struct
import subprocess
import sys

import pytest

from blaze_tpu.config import conf as jconf
from blaze_tpu.runtime import artifacts as jartifacts
from blaze_tpu.runtime import journal as jjournal
from blaze_tpu_torch.config import conf
from blaze_tpu_torch.runtime import artifacts, journal
from torch_parity import both_tables, no_jax_native, run_both


@pytest.fixture(autouse=True)
def _journal_env(tmp_path, monkeypatch):
    for c, d in ((conf, "journal"), (jconf, "jjournal")):
        monkeypatch.setattr(c, "journal_dir", str(tmp_path / d))
        monkeypatch.setattr(c, "journal_retention", 256)
        monkeypatch.setattr(c, "recovery_enabled", True)
    monkeypatch.setattr(conf, "spill_dir", str(tmp_path / "spill"))
    no_jax_native(monkeypatch)
    journal.reset()
    jjournal.reset()
    yield
    journal.reset()
    jjournal.reset()


def _dead_pid() -> int:
    p = subprocess.Popen([sys.executable, "-c", "pass"])
    p.wait()
    return p.pid


def _committed_pair(mod, tmp_path, name):
    data = str(tmp_path / f"{name}.data")
    index = str(tmp_path / f"{name}.index")
    frame = b"BTB1" + struct.pack("<II", 6, 6) + b"abcdef"

    def write(tmp_data, tmp_index):
        with open(tmp_data, "wb") as f:
            f.write(frame)
        with open(tmp_index, "wb") as f:
            f.write(struct.pack("<2Q", 0, len(frame)))
        return (len(frame),)

    mod.commit_shuffle_pair(write, data, index)
    _raw, meta = mod.read_index(index)
    return data, index, meta["data_crc"]


def _crashed(mod, qid, fp, out, pid):
    jnl = mod.QueryJournal(qid)
    jnl.record("admitted", tenant_id="t0", pid=pid)
    jnl.plan(fingerprint="qfp", num_partitions=2,
             stages=[{"stage_id": 0, "kind": "shuffle_map"}])
    data, index, crc = out
    jnl.stage_commit(0, fp, 123, [{"map_id": 0, "data_path": data,
                                   "index_path": index, "epoch": 0,
                                   "data_crc": crc}])
    return jnl


# ---- appends and retention ----

def test_records_round_trip_and_settle():
    jnl = journal.QueryJournal("q1")
    jnl.admitted(tenant_id="acme")
    jnl.plan(fingerprint="f", num_partitions=4, stages=[])
    jnl.stage_commit(0, "sf", 10, [])
    records = journal.load_records(jnl.path)
    assert [r["kind"] for r in records] == ["admitted", "plan",
                                            "stage_commit"]
    assert records[0]["pid"] == os.getpid()
    assert not journal.is_complete(records)
    jnl.complete("ok")
    assert journal.is_complete(journal.load_records(jnl.path))


def test_torn_tail_healed_and_garbage_skipped():
    jnl = journal.QueryJournal("q2")
    jnl.admitted()
    with open(jnl.path, "ab") as f:
        f.write(b'{"kind": "stage_com')  # a crash mid-line
    jnl.record("x_garbage_follows")
    with open(jnl.path, "ab") as f:
        f.write(b"\n\x00\xffgarbage\n[1,2]\n")
    jnl.complete("failed", error="x")
    assert [r["kind"] for r in journal.load_records(jnl.path)] == [
        "admitted", "x_garbage_follows", "complete"]


def test_prune_keeps_newest_complete_never_incomplete(monkeypatch):
    monkeypatch.setattr(conf, "journal_retention", 2)
    for i in range(4):
        jnl = journal.QueryJournal(f"done{i}")
        jnl.admitted()
        jnl.record("complete", status="ok")
        os.utime(jnl.path, (1000 + i, 1000 + i))
    hanging = journal.QueryJournal("hang")
    hanging.admitted()
    os.utime(hanging.path, (1, 1))
    assert journal.prune() == 2
    assert sorted(os.listdir(conf.journal_dir)) == [
        "journal_done2.jsonl", "journal_done3.jsonl", "journal_hang.jsonl"]


# ---- the recovery scan ----

@pytest.mark.parametrize("case", ["verified", "flipped", "crc", "live"])
def test_recovery_scan_matches_jax(tmp_path, case):
    dead = _dead_pid()
    got = {}
    for mod, art, sub in ((journal, artifacts, "p"),
                          (jjournal, jartifacts, "j")):
        (tmp_path / sub).mkdir()
        out = _committed_pair(art, tmp_path / sub, "shuffle_0_0")
        if case == "flipped":
            with open(out[0], "r+b") as f:
                f.seek(14)
                f.write(b"\xff")
        if case == "crc":
            out = (out[0], out[1], 12345)
        jnl = _crashed(mod, "crashed", f"fp-{case}", out,
                       os.getpid() if case == "live" else dead)
        summary = mod.ensure_recovery_scan(force=True)
        records = mod.load_records(jnl.path)
        rec = mod.take_resume(f"fp-{case}")
        got[sub] = (summary, [r["kind"] for r in records],
                    records[-1].get("error"),
                    None if rec is None else rec["stage_id"],
                    mod.take_resume(f"fp-{case}"))
    assert got["p"] == got["j"]
    summary, kinds, error, stage, again = got["p"]
    assert again is None
    if case == "verified":
        assert summary["resumable"] == 1 and stage == 0
        assert kinds[-1] == "complete" and error == "driver_restart"
    elif case == "live":
        assert summary["scanned"] == 0 and kinds[-1] == "stage_commit"
    else:
        assert summary["resumable"] == 0 and stage is None


def test_scan_runs_once_a_directory(tmp_path):
    out = _committed_pair(artifacts, tmp_path, "a")
    _crashed(journal, "c5", "fp5", out, _dead_pid())
    assert journal.ensure_recovery_scan(force=True)["scanned"] == 1
    assert journal.ensure_recovery_scan()["scanned"] == 0
    base = journal.recovered_queries_total()
    for q in ("qA", "qA", "qB"):
        journal.note_query_recovered(q)
    assert journal.recovered_queries_total() == base + 2


# ---- journaled runs ----

@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    return both_tables(tmp_path_factory, rows=2000)


@pytest.mark.parametrize("suite,q,mode", [("tpcds", "q02", "smj"),
                                          ("core", "q3_join_agg_sort",
                                           "smj")])
def test_journal_records_match_jax(tables, tmp_path, suite, q, mode):
    (rows, info), (_, jinfo) = run_both(tables, tmp_path, suite, q, mode)
    recs = journal.load_records(journal.journal_path(info["query_id"]))
    jrecs = jjournal.load_records(jjournal.journal_path(jinfo["query_id"]))
    assert [r["kind"] for r in recs] == [r["kind"] for r in jrecs]
    assert recs[-1]["status"] == jrecs[-1]["status"] == "ok"
    plan = [r for r in recs if r["kind"] == "plan"][0]
    jplan = [r for r in jrecs if r["kind"] == "plan"][0]
    assert plan["fingerprint"] == jplan["fingerprint"]
    assert [(s["stage_id"], s["kind"], s["num_partitions"])
            for s in plan["stages"]] == [
        (s["stage_id"], s["kind"], s["num_partitions"])
        for s in jplan["stages"]]

    def commits(rs):
        return [(r["stage_id"], r["fingerprint"], len(r["outputs"]))
                for r in rs if r["kind"] == "stage_commit"]

    assert commits(recs) == commits(jrecs) and commits(recs)


def test_a_stopped_run_resumes_its_committed_stage(tables, tmp_path,
                                                   monkeypatch):
    """The first run stops in its last stage, as a killed driver would: no
    terminal record and its map outputs left on disk. A restarted driver
    (its recovery scan) reuses them: no map task of the recovered stages
    runs again, and the rows are the same."""
    from blaze_tpu_torch.spark import local_runner, tpcds
    from blaze_tpu_torch.spark.shuffle_manager import BlazeShuffleManager

    (paths, frames), _ = tables["tpcds"]

    def run(work, info):
        plan, _ = tpcds.QUERIES["q02"](paths, frames, "smj")
        return local_runner.run_plan(plan, num_partitions=4,
                                     work_dir=str(tmp_path / work),
                                     mesh_exchange="off", run_info=info,
                                     device="cpu")

    full = {}
    want = run("full", full).to_numpy()

    class Killed(BaseException):
        pass

    def stop(*args, **kwargs):
        raise Killed()

    with monkeypatch.context() as m:
        m.setattr(local_runner, "_run_result_stage", stop)
        m.setattr(BlazeShuffleManager, "unregister_shuffle",
                  lambda self, sid, delete_files=True: None)
        m.setattr(journal.QueryJournal, "complete", lambda *a, **k: None)
        crashed = {}
        with pytest.raises(Killed):
            run("crashed", crashed)
    path = journal.journal_path(crashed["query_id"])
    records = journal.load_records(path)
    assert not journal.is_complete(records)
    # the crashed driver's pid: rewrite it to one provably dead
    lines = open(path).read().replace(f'"pid": {os.getpid()}',
                                      f'"pid": {_dead_pid()}')
    open(path, "w").write(lines)
    journal.reset()  # a new driver process
    resumed = {}
    got = run("resumed", resumed).to_numpy()
    from test_torch_runner import _same_rows

    _same_rows(got, want)
    assert resumed["recovered_stages"] >= 1
    assert resumed["map_tasks_run"] < full["map_tasks_run"]
    assert journal.is_complete(journal.load_records(path))
    shutil.rmtree(tmp_path / "crashed", ignore_errors=True)
