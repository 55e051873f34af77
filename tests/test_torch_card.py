"""Tests of the port that need a CUDA card: the hand-written kernel against
its plain torch version, and bench.py's q06 plan through it at test size.

The kernel has no CPU mode, so every test here skips without a card. The
file imports neither jax nor `blaze_tpu`, so that it runs on a machine that
has only the port's dependencies. On the card, from the repo root:

    python -m pytest --noconftest -m cuda tests/test_torch_card.py -q
"""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from blaze_tpu_torch.columnar.batch import ColumnBatch
from blaze_tpu_torch.ops import mxu_agg as M
from blaze_tpu_torch.plan.from_proto import decode_task_definition
from blaze_tpu_torch.runtime import resources
from blaze_tpu_torch.runtime.executor import collect_fetch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(cuda, n, key_range, seed):
    """Keys, ok flags and the presence + float-sum digit planes of n rows,
    made from a seed with numpy."""
    rng = np.random.default_rng(seed)
    keys = torch.from_numpy(rng.integers(0, key_range, n).astype(np.int32))
    valid = torch.from_numpy(rng.random(n) < 0.5)
    v = torch.from_numpy(rng.standard_normal(n) * 1e3)
    ones = torch.ones(n, dtype=torch.bool)
    words, recipe, _, _, _ = M.digitize(
        valid.to(cuda), [("count", ones.to(cuda)),
                         ("sum", v.to(cuda), ones.to(cuda))])
    return keys.to(cuda), valid.to(cuda), words, recipe


@pytest.mark.parametrize("n", [1 << 12, (1 << 16) + 37])
def test_kernel_matches_plain_version_on_card(cuda, n):
    k, valid, words, recipe = _inputs(cuda, n, 1 << 14, n)
    ok = valid.to(torch.int32)
    before = M.KERNEL_LAUNCHES
    got = M._accumulate_planes_cuda(k, ok, words, recipe, 128)
    assert M.KERNEL_LAUNCHES == before + 1
    want = M._accumulate_planes_ref(k, ok, words, recipe, 128)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_kernel_launches_once_per_2_23_row_block(cuda):
    """Past 2^23 rows the int32 table is no longer exact, so the wrapper
    launches once per block and sums the blocks."""
    n, rng = (1 << 23) + 1000, 1 << 10
    k, valid, words, recipe = _inputs(cuda, n, rng, 7)
    before = M.KERNEL_LAUNCHES
    got = M.accumulate_raw(k, valid, words, recipe, rng)
    assert M.KERNEL_LAUNCHES == before + 2
    ok = valid.to(torch.int32)
    words = [w.to(torch.int32).contiguous() for w in words]
    want = sum(M._accumulate_planes_ref(
        k[s:s + (1 << 23)], ok[s:s + (1 << 23)],
        [w[s:s + (1 << 23)] for w in words], recipe, rng // 128)
        for s in (0, 1 << 23))
    assert torch.equal(got, want)


def test_bench_plan_on_card(cuda, monkeypatch):
    """q06 at 4 x 2^12 rows and 2^10 groups on the card: one launch a
    batch, keys and counts equal to the numpy oracle, sums within rtol
    1e-9."""
    monkeypatch.setattr(cs, "ROWS", 1 << 12)
    monkeypatch.setattr(cs, "GROUPS", 1 << 10)
    datas = [cs._make_data(s) for s in range(4)]
    batches = [ColumnBatch.from_numpy(d, cs.SCHEMA) for d in datas]
    assert batches[0].device.type == "cuda"
    rid = resources.register(lambda: iter(batches))
    plan, _ = decode_task_definition(cs._build_task(cs.SCHEMA_PB, rid))
    before = M.KERNEL_LAUNCHES
    packed = collect_fetch(plan, cs._full)
    assert M.KERNEL_LAUNCHES == before + 4
    cap = (len(packed) - 1) // 3
    n = int(packed[0])
    keys = packed[1:1 + cap][:n].astype(np.int64)
    order = np.argsort(keys, kind="stable")
    sums = packed[1 + cap:1 + 2 * cap][:n][order]
    cnts = packed[1 + 2 * cap:][:n].astype(np.int64)[order]
    ref_sums, ref_cnts = cs._numpy_pipeline(datas)
    nz = ref_cnts > 0
    np.testing.assert_array_equal(keys[order], np.nonzero(nz)[0])
    np.testing.assert_array_equal(cnts, ref_cnts[nz])
    np.testing.assert_allclose(sums, ref_sums[nz], rtol=1e-9)
