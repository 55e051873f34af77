"""The port's zerocopy_bench (blaze_tpu_torch/tools/zerocopy_bench.py)
against the JAX package's tools/zerocopy_bench.py, loaded by file path, on
the CPU.

- `_fetch_ab` over each package's live ShuffleServer/ShuffleClient: the
  committed pair holds the same bytes, the mmap arm answers identically to
  the socket arm, and both arms' `bytes_copied_shuffle`,
  `bytes_moved_shuffle`, mmap hits and fallbacks equal the JAX tool's.
- `_dict_ab` at 20,000 rows: both arms oracle-equal, the same encoded
  kinds, `dict_cols_encoded` and frame bytes as the JAX tool's arms.
- `_pooled_ab` runs once on fresh 2-seat pools: oracle-equal arms, pooled
  stages, mmap hits on the on-arm only and fewer copied shuffle bytes.

No timing is asserted (the fetch round's speedup gate is not read).
"""

import importlib.util
import os

import pytest

from blaze_tpu_torch.tools import zerocopy_bench
from torch_parity import no_jax_native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COUNTERS = ("bytes_copied_shuffle", "bytes_moved_shuffle", "mmap_hits",
            "mmap_fallbacks")


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_tools_zerocopy_bench",
        os.path.join(REPO, "tools", "zerocopy_bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def cpu(monkeypatch):
    monkeypatch.setattr(zerocopy_bench, "DEVICE", "cpu")
    no_jax_native(monkeypatch)


def test_committed_pair_equals_jax(cpu, tmp_path):
    (tmp_path / "p").mkdir()
    (tmp_path / "j").mkdir()
    data, index, frames = zerocopy_bench._commit_string_pair(
        str(tmp_path / "p"), rows=8000)
    jdata, jindex, jframes = _jax_tool()._commit_string_pair(
        str(tmp_path / "j"), rows=8000)
    assert frames == jframes
    with open(data, "rb") as f, open(jdata, "rb") as g:
        assert f.read() == g.read()
    with open(index, "rb") as f, open(jindex, "rb") as g:
        assert f.read() == g.read()


def test_fetch_ab_counters_equal_jax(cpu):
    rec = zerocopy_bench._fetch_ab()
    jrec = _jax_tool()._fetch_ab()
    assert set(rec) == set(jrec)
    assert rec["answers_identical"] and jrec["answers_identical"]
    assert rec["segment_bytes"] == jrec["segment_bytes"]
    for arm in ("off", "on"):
        assert {k: rec[arm][k] for k in COUNTERS} == \
            {k: jrec[arm][k] for k in COUNTERS}, arm
    on, off = rec["on"], rec["off"]
    assert on["mmap_hits"] == zerocopy_bench.FETCH_ITERS * \
        zerocopy_bench.FETCH_PARTITIONS
    assert on["bytes_copied_shuffle"] == 0 < on["bytes_moved_shuffle"]
    assert off["mmap_hits"] == 0 < off["bytes_copied_shuffle"]


def test_dict_ab_equals_jax(cpu):
    rec = zerocopy_bench._dict_ab(20_000)
    jrec = _jax_tool()._dict_ab(20_000)
    for arm in ("off", "on"):
        got, want = rec[arm], jrec[arm]
        assert got["oracle_equal"] and want["oracle_equal"], arm
        for k in ("encoded_kind", "dict_cols_encoded", "frame_bytes",
                  "bytes_copied_serde", "rows"):
            assert got[k] == want[k], (arm, k)
    assert rec["on"]["encoded_kind"] == "dict"
    assert rec["off"]["encoded_kind"] == "str"
    assert rec["frame_bytes_ratio"] == jrec["frame_bytes_ratio"]


def test_pooled_ab_on_fresh_pools(cpu, tmp_path):
    from blaze_tpu_torch.spark import validator

    tables = validator.generate_tables(str(tmp_path), rows=2000)
    rec = zerocopy_bench._pooled_ab(tables)
    on, off = rec["on"], rec["off"]
    assert on["oracle_equal"] and off["oracle_equal"], rec
    assert on["pool_stages"] > 0 and off["pool_stages"] > 0
    assert on["shuffle_mmap_hits"] > 0 == off["shuffle_mmap_hits"]
    assert on["bytes_copied_shuffle"] < off["bytes_copied_shuffle"]
    assert rec["ok"]
