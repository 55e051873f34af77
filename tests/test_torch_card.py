"""Tests of the port that need a CUDA card: the hand-written kernel chain
against its plain torch version, and bench.py's q06 plan through it at test
size.

The kernels have no CPU mode, so every test here skips without a card. The
file imports neither jax nor `blaze_tpu`, so that it runs on a machine that
has only the port's dependencies. On the card, from the repo root:

    python -m pytest --noconftest -m cuda tests/test_torch_card.py -q
"""

import zlib

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


def _planes(rng, n, recipe_kind):
    """Word columns and recipe of n rows, made on the CPU from a seeded
    numpy generator: "float" is the main path's presence plane plus six
    float-sum digit planes (P = 7), "count" one raw count plane (P = 1),
    "int" an int64 sum's eight digit planes (P = 8), "wide" 32 digit planes
    of eight random words."""
    ones = torch.ones(n, dtype=torch.bool)
    if recipe_kind == "wide":
        words = [torch.from_numpy(rng.integers(-2**31, 2**31, n)
                                  .astype(np.int32)) for _ in range(8)]
        recipe = tuple(("digit", w, sh) for w in range(8)
                       for sh in (0, 8, 16, 24))
        return words, recipe
    if recipe_kind == "count":
        specs = [("count", torch.from_numpy(rng.random(n) < 0.7))]
    elif recipe_kind == "int":
        specs = [("sum", torch.from_numpy(rng.integers(-2**60, 2**60, n)),
                  ones)]
    else:
        specs = [("count", ones),
                 ("sum", torch.from_numpy(rng.standard_normal(n) * 1e3),
                  ones)]
    words, recipe, _, _, _ = M.digitize(ones, specs)
    return words, recipe


def _case(name):
    """(keys, valid, words, recipe, rng) of one named input, on the CPU."""
    n, key_range, recipe_kind, valid_p = 1 << 16, 1 << 14, "float", 0.5
    if name in ("ragged", "unaligned"):
        n = (1 << 16) + 37
    elif name == "one-row":
        n = 1
    elif name == "2^23+1000":
        n, key_range = (1 << 23) + 1000, 1 << 10
    elif name in ("P=1", "P=8", "P=32"):
        recipe_kind = {"P=1": "count", "P=8": "int", "P=32": "wide"}[name]
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    keys = rng.integers(0, key_range, n)
    if name == "skewed":  # 90% of rows on 8 keys
        hot = rng.integers(0, 8, n) * 1031
        keys = np.where(rng.random(n) < 0.9, hot, keys)
    elif name == "one-key":
        keys = np.full(n, 777)
    elif name == "out-of-range":
        keys = rng.integers(-3000, key_range + 3000, n)
    valid = rng.random(n) < (0.0 if name == "all-masked" else valid_p)
    words, recipe = _planes(rng, n, recipe_kind)
    return (torch.from_numpy(keys.astype(np.int32)),
            torch.from_numpy(valid), words, recipe, key_range)


CASES = ["uniform", "skewed", "one-key", "all-masked", "out-of-range",
         "ragged", "unaligned", "one-row", "2^23+1000", "P=1", "P=8", "P=32"]


@pytest.mark.parametrize("name", CASES)
def test_kernel_matches_plain_version_on_card(cuda, name):
    """The chain adds into a carry that already holds random int64 values,
    bit for bit as the plain version does, with one launch a call and one
    of each of its kernels."""
    keys, valid, words, recipe, rng = _case(name)
    keys, valid = keys.to(cuda), valid.to(cuda)
    words = [w.to(cuda) for w in words]
    if name == "unaligned":  # views one row in: the wrapper copies them
        keys, valid, words = keys[1:], valid[1:], [w[1:] for w in words]
    gh = (rng + 127) // 128
    start = torch.from_numpy(np.random.default_rng(5).integers(
        -2**62, 2**62, (gh, len(recipe), 128))).to(cuda)
    got, want = start.clone(), start.clone()
    before, chain_before = M.KERNEL_LAUNCHES, dict(M.CHAIN_LAUNCHES)
    M.accumulate_into(got, keys, valid, words, recipe, rng)
    assert M.KERNEL_LAUNCHES == before + 1
    assert all(M.CHAIN_LAUNCHES[k] == chain_before[k] + 1
               for k in chain_before)
    M._accumulate_into_ref(want, keys, valid, words, recipe, rng)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    if name == "all-masked":
        assert torch.equal(got, start)


def test_carry_over_three_batches_on_card(cuda):
    """A carry accumulated over 3 batches equals the sum of the plain
    version's per-batch tables."""
    acc = torch.zeros((128, 7, 128), dtype=torch.int64, device=cuda)
    want = torch.zeros_like(acc)
    for name in ("uniform", "skewed", "out-of-range"):
        keys, valid, words, recipe, rng = _case(name)
        args = (keys.to(cuda), valid.to(cuda), [w.to(cuda) for w in words],
                recipe, rng)
        M.accumulate_into(acc, *args)
        table = torch.zeros_like(acc)
        M._accumulate_into_ref(table, *args)
        want += table
    torch.cuda.synchronize()
    assert torch.equal(acc, want)


def test_kernel_launches_once_per_2_23_row_block(cuda):
    """accumulate_raw keeps the reference's int32 table: past 2^23 rows it
    is no longer exact, so the wrapper launches once per block and sums
    the blocks."""
    keys, valid, words, recipe, rng = _case("2^23+1000")
    keys, valid = keys.to(cuda), valid.to(cuda)
    words = [w.to(cuda) for w in words]
    before = M.KERNEL_LAUNCHES
    got = M.accumulate_raw(keys, valid, words, recipe, rng)
    assert M.KERNEL_LAUNCHES == before + 2
    assert got.dtype == torch.int32
    want = torch.zeros((rng // 128, len(recipe), 128), dtype=torch.int64,
                       device=cuda)
    for s in (0, 1 << 23):
        part = torch.zeros_like(want)
        M._accumulate_into_ref(part, keys[s:s + (1 << 23)],
                               valid[s:s + (1 << 23)],
                               [w[s:s + (1 << 23)] for w in words], recipe,
                               rng)
        want += part.to(torch.int32)
    assert torch.equal(got, want.to(torch.int32))


def test_bench_plan_on_card(cuda, monkeypatch):
    """q06 at 4 x 2^12 rows and 2^10 groups on the card: one chain launch a
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
    chain_before = dict(M.CHAIN_LAUNCHES)
    packed = collect_fetch(plan, cs._full)
    assert M.KERNEL_LAUNCHES == before + 4
    assert all(M.CHAIN_LAUNCHES[k] == chain_before[k] + 4
               for k in chain_before)
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
