"""The port's 128-bit limb arithmetic (blaze_tpu_torch/columnar/int128.py)
against the JAX package's (blaze_tpu/columnar/int128.py), on the CPU.

Every case of tests/test_int128.py, each fed the same seeded Python ints
through both packages and, where that test has one, a Python-int oracle;
then the edge rows: INT64_MIN limbs, +-(10^38 - 1), the int128 extremes,
HALF_UP ties at .5, zero divisors of the long division and the
`abs(INT64_MIN)` wrap. Tolerance: limbs equal bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blaze_tpu.columnar import int128 as J
from blaze_tpu_torch.columnar import int128 as T

I64_MIN = -(1 << 63)
EDGES = [0, 1, -1, (1 << 63) - 1, I64_MIN, 1 << 63, (1 << 64) - 1, 1 << 64,
         -(1 << 64), 10 ** 38 - 1, -(10 ** 38 - 1), (1 << 127) - 1,
         -(1 << 127), 5, -5, 15, -15, 10 ** 19, -(10 ** 19)]


def rand_i128(rng, n, bits=126):
    """tests/test_int128.py's generator, with its fixed rows."""
    out = []
    for _ in range(n):
        b = int(rng.integers(1, bits))
        v = int(rng.integers(0, 1 << 30)) | (int(rng.integers(0, 2)) << b)
        out.append(v * (1 if rng.integers(0, 2) else -1))
    return out + [0, 1, -1, (1 << 64) - 1, 1 << 64, -(1 << 64),
                  10 ** 38 - 1, -(10 ** 38 - 1)]


def wrap128(v):
    u = v & ((1 << 128) - 1)
    return u - (1 << 128) if u >= (1 << 127) else u


def both(vals):
    """(port planes, JAX planes) of the same ints."""
    hi, lo = T.np_from_ints(vals)
    return ((torch.from_numpy(hi), torch.from_numpy(lo)),
            (jnp.asarray(hi), jnp.asarray(lo)))


def same(tp, jp):
    """Each port tensor equals its JAX array bit for bit."""
    for t, j in zip(tp, jp):
        j = np.asarray(j)
        assert t.numpy().dtype == j.dtype
        np.testing.assert_array_equal(t.numpy(), j)


def back(h, l):
    return T.ints_from_np(np.asarray(h), np.asarray(l))


def test_roundtrip(rng):
    vals = rand_i128(rng, 50) + EDGES
    (th, tl), (jh, jl) = both(vals)
    assert back(th, tl) == vals
    same((th, tl), J.np_from_ints(vals))
    assert T.ints_from_np(*J.np_from_ints(vals)) == J.ints_from_np(
        *J.np_from_ints(vals))


def test_add_sub_neg(rng):
    a, b = rand_i128(rng, 60) + EDGES, rand_i128(rng, 60) + EDGES[::-1]
    (ah, al), (jah, jal) = both(a)
    (bh, bl), (jbh, jbl) = both(b)
    for tf, jf in ((T.add, J.add), (T.sub, J.sub)):
        same(tf(ah, al, bh, bl), jf(jah, jal, jbh, jbl))
    same(T.neg(ah, al), J.neg(jah, jal))
    same(T.abs_(ah, al), J.abs_(jah, jal))
    assert back(*T.add(ah, al, bh, bl)) == [wrap128(x + y)
                                            for x, y in zip(a, b)]
    assert back(*T.abs_(ah, al)) == [wrap128(abs(x)) for x in a]


def test_cmp(rng):
    a, b = rand_i128(rng, 60) + EDGES, rand_i128(rng, 60) + EDGES[::-1]
    b[:10] = a[:10]
    (ah, al), (jah, jal) = both(a)
    (bh, bl), (jbh, jbl) = both(b)
    same([T.cmp(ah, al, bh, bl), T.eq(ah, al, bh, bl)],
         [J.cmp(jah, jal, jbh, jbl), J.eq(jah, jal, jbh, jbl)])
    assert T.cmp(ah, al, bh, bl).tolist() == [(x > y) - (x < y)
                                              for x, y in zip(a, b)]


def test_mul_i64(rng):
    a = [int(x) for x in rng.integers(-2**62, 2**62, 80)] + \
        [2**63 - 1, I64_MIN, 0, -1, I64_MIN]
    b = [int(x) for x in rng.integers(-2**62, 2**62, 80)] + \
        [2**63 - 1, I64_MIN, 7, I64_MIN, -1]
    ta, tb = (torch.tensor(v, dtype=torch.int64) for v in (a, b))
    got = T.mul_i64(ta, tb)
    same(got, J.mul_i64(jnp.asarray(np.array(a, np.int64)),
                        jnp.asarray(np.array(b, np.int64))))
    assert back(*got) == [wrap128(x * y) for x, y in zip(a, b)]


def test_mul_small_and_rescale(rng):
    vals = rand_i128(rng, 40, bits=90) + EDGES
    (h, l), (jh, jl) = both(vals)
    same(T.mul_small(h, l, 10 ** 9), J.mul_small(jh, jl, 10 ** 9))
    for delta in (12, 1, -1, -7, -18, -19, -38):
        same(T.rescale(h, l, delta), J.rescale(jh, jl, delta))
        same(T.rescale(h, l, delta, half_up=False),
             J.rescale(jh, jl, delta, half_up=False))
        same(T.rescale_checked(h, l, delta),
             J.rescale_checked(jh, jl, delta))
    got = back(*T.rescale(h, l, -7))
    for g, v in zip(got, vals):
        q, r = divmod(abs(wrap128(v)), 10 ** 7)
        w = q + (1 if 2 * r >= 10 ** 7 else 0)
        assert g == wrap128(w if v >= 0 else -w)


def test_half_up_ties():
    """.5 rounds away from zero on the magnitude: 5 -> 1, -5 -> -1, 15 ->
    2, 25 -> 3 at one place; 4 and -4 round to 0."""
    vals = [5, -5, 15, -15, 25, -25, 4, -4, 14, 149, 150, -150]
    (h, l), (jh, jl) = both(vals)
    got = T.rescale(h, l, -1)
    same(got, J.rescale(jh, jl, -1))
    assert back(*got) == [1, -1, 2, -2, 3, -3, 0, 0, 1, 15, 15, -15]


def test_divmod_small(rng):
    vals = rand_i128(rng, 40, bits=120) + EDGES
    (h, l), (jh, jl) = both(vals)
    got = T.divmod_small(h, l, 999_999_937)
    same(got, J.divmod_small(jh, jl, 999_999_937))
    for gq, gr, v in zip(back(got[0], got[1]), got[2].tolist(), vals):
        if abs(v) < (1 << 127):
            assert (gq, gr) == divmod(abs(v), 999_999_937)
    # per-row divisors, as the avg finalize passes them
    d = torch.from_numpy(rng.integers(1, 1 << 31, len(vals)))
    same(T.divmod_small(h, l, d),
         J.divmod_small(jh, jl, jnp.asarray(d.numpy())))


def test_divmod_full(rng):
    """The 128-step long division: quotient and remainder of the
    magnitudes, zero divisors giving an all-ones quotient, as the JAX
    package's lax.fori_loop does."""
    a = rand_i128(rng, 50) + EDGES
    b = rand_i128(rng, 50, bits=70) + EDGES[::-1]
    b[:3] = [0, 0, 0]
    (ah, al), (jah, jal) = both(a)
    (bh, bl), (jbh, jbl) = both(b)
    got = T.divmod_full(ah, al, bh, bl)
    same(got, J.divmod_full(jah, jal, jbh, jbl))
    q, r = back(got[0], got[1]), back(got[2], got[3])
    for x, y, gq, gr in zip(a, b, q, r):
        if y and abs(x) < (1 << 127) and abs(y) < (1 << 127):
            assert (gq, gr) == divmod(abs(x), abs(y))
    assert q[0] == -1  # all ones


def test_to_i64_and_precision(rng):
    vals = [0, 5, -5, 2**63 - 1, I64_MIN, 2**63, I64_MIN - 1, 10**19,
            -(10**19), 10**37] + EDGES
    (h, l), (jh, jl) = both(vals)
    same(T.to_i64_checked(h, l), J.to_i64_checked(jh, jl))
    for p in (0, 18, 19, 38):
        same([T.in_precision(h, l, p)], [J.in_precision(jh, jl, p)])
    for x, f in zip(vals, T.in_precision(h, l, 19).tolist()):
        assert f == (abs(x) < 10 ** 19)


@pytest.mark.parametrize("k", [0, 1, 18, 19, 20, 37, 38])
def test_pow10_128(k):
    th, tl = T._pow10_128(k)
    jh, jl = J._pow10_128(k)
    assert (th, tl) == (int(jh), int(jl))
    assert T.ints_from_np(np.array([th]), np.array([tl])) == [10 ** k]


def test_from_i64():
    x = [5, -5, 2**63 - 1, I64_MIN, 0]
    got = T.from_i64(torch.tensor(x, dtype=torch.int64))
    same(got, J.from_i64(jnp.asarray(np.array(x, np.int64))))
    assert back(*got) == x
