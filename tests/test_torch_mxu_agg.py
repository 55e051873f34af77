"""Parity of the port's digit-plane aggregation (blaze_tpu_torch/ops/mxu_agg)
with the JAX package's (blaze_tpu/ops/mxu_agg), on the CPU.

On the JAX side `_accumulate_planes` takes its portable route
(`_xla_accumulate`) off the TPU; on the port's side a CPU tensor takes the
plain version `_accumulate_into_ref` of the kernel chain. Inputs are made with numpy from a
seed. Integers (words, plane sums, int sums, counts) must be equal; float
sums within rtol 1e-12 — both recombine the same exact plane sums in the
same order. The kernel itself runs only on the card: its tests are in
test_torch_card.py.

Float digitization scales by 2^s. XLA's CPU `exp2` is not exact at integer
arguments (exp2(30) comes out 2^30 * (1 - 8.9e-16)), so the unpatched
reference rounds about 0.6% of scaled values to a neighbour of the exact
round(v * 2^s) that the port computes. The parity tests therefore run the
reference with an exact `exp2` for the integral scales it uses
(`exact_exp2`), and one test bounds the unpatched reference's difference to
one unit of the scaled value.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from blaze_tpu.ops import mxu_agg as J
from blaze_tpu_torch.ops import mxu_agg as M


@pytest.fixture
def exact_exp2(monkeypatch):
    """jnp.exp2 made exact for the integral scales mxu_agg passes it."""
    def exp2(x):
        x = jnp.asarray(x, jnp.float64)
        return jnp.ldexp(jnp.ones_like(x), x.astype(jnp.int32))

    monkeypatch.setattr(jnp, "exp2", exp2)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _float_vals(rng, n, scale=1e3):
    return rng.standard_normal(n) * scale


# (name, numpy values) of int64 sums: mixed signs, near 2^53, near 2^62
INT_CASES = {
    "mixed": lambda rng, n: rng.integers(-10**6, 10**6, n),
    "near2^53": lambda rng, n: rng.integers(2**52 - 10**6, 2**52, n) //
    max(n, 1),
    "negative": lambda rng, n: -rng.integers(0, 2**40, n),
    "wide": lambda rng, n: rng.integers(-2**61, 2**61, n),
}


@pytest.mark.parametrize("case", sorted(INT_CASES))
def test_int_words_match(case):
    rng = np.random.default_rng(1)
    v = INT_CASES[case](rng, 5000).astype(np.int64)
    jw, je = J._int_words(jnp.asarray(v))
    tw, te = M._int_words(_t(v))
    assert te == je
    for a, b in zip(tw, jw):
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("fixed_s", [None, 20.0, 30.0, -10.0])
def test_float_words_match(exact_exp2, fixed_s):
    rng = np.random.default_rng(2)
    v = _float_vals(rng, 5000, 1e3 if fixed_s != -10.0 else 1e14)
    ok = rng.random(5000) < 0.7
    jw, je, js, jbad = J._float_words(jnp.asarray(v), jnp.asarray(ok),
                                      fixed_s=fixed_s)
    tw, te, ts, tbad = M._float_words(_t(v), _t(ok), fixed_s=fixed_s)
    assert te == je
    assert float(ts) == float(js)
    assert bool(tbad) == bool(jbad)
    for a, b in zip(tw, jw):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _scaled(words):
    """The int64 round(v * 2^s) + bias that a float's two words encode."""
    lo, hi = (np.asarray(w).astype(np.int64) for w in words)
    return (hi << 32) | (lo & 0xFFFFFFFF)


@pytest.mark.parametrize("fixed_s", [None, 30.0, 17.0])
def test_float_words_within_one_unit_of_unpatched_reference(fixed_s):
    rng = np.random.default_rng(12)
    v = _float_vals(rng, 5000)
    ok = np.ones(5000, bool)
    jw, _, _, _ = J._float_words(jnp.asarray(v), jnp.asarray(ok),
                                 fixed_s=fixed_s)
    tw, _, s, _ = M._float_words(_t(v), _t(ok), fixed_s=fixed_s)
    diff = np.abs(_scaled([w.numpy() for w in tw]) - _scaled(jw))
    assert diff.max() <= 1
    # the port's value is the exact one
    exact = np.round(v * 2.0 ** float(s)).astype(np.int64) + M._bias_f(
        M.f64_chunks())
    np.testing.assert_array_equal(_scaled([w.numpy() for w in tw]), exact)


def _specs(pkg_np, rng, n, valid):
    """Spec list with counts, a float sum, an int sum and a nullable sum."""
    f = _float_vals(rng, n)
    i = rng.integers(-10**9, 10**9, n).astype(np.int64)
    fv = rng.random(n) < 0.8
    cv = rng.random(n) < 0.5
    arr = pkg_np
    return [("count", arr(np.ones(n, bool))), ("sum", arr(f), arr(fv)),
            ("sum", arr(i), arr(np.ones(n, bool))), ("count", arr(cv))]


@pytest.mark.parametrize("fixed", [False, True])
def test_digitize_matches(exact_exp2, fixed):
    rng = np.random.default_rng(3)
    n = 4000
    valid = rng.random(n) < 0.9
    seed_state = rng.bit_generator.state
    jspecs = _specs(jnp.asarray, rng, n, valid)
    rng.bit_generator.state = seed_state
    tspecs = _specs(_t, rng, n, valid)
    fs = {1: 12.0} if fixed else None
    jw, jr, jl, jwt, jbad = J.digitize(jnp.asarray(valid), jspecs,
                                       fixed_scales=fs)
    tw, tr, tl, twt, tbad = M.digitize(_t(valid), tspecs, fixed_scales=fs)
    assert tr == jr and tl == jl
    assert len(tw) == len(jw)
    for a, b in zip(tw, jw):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(twt.numpy(), np.asarray(jwt))
    assert bool(tbad) == bool(jbad) is False


def _accumulate_both(rng, n, rng_keys, valid_p, raw=True):
    keys = rng.integers(-50, rng_keys + 50, n).astype(np.int32)
    valid = rng.random(n) < valid_p
    v = rng.integers(-2**40, 2**40, n).astype(np.int64)
    ones = np.ones(n, bool)
    jw, jr, _, _, _ = J.digitize(jnp.asarray(valid), [
        ("count", jnp.asarray(ones)), ("sum", jnp.asarray(v),
                                       jnp.asarray(ones))])
    tw, tr, _, _, _ = M.digitize(_t(valid), [
        ("count", _t(ones)), ("sum", _t(v), _t(ones))])
    f_j = J.accumulate_raw if raw else J.accumulate
    f_t = M.accumulate_raw if raw else M.accumulate
    ja = f_j(jnp.asarray(keys), jnp.asarray(valid), jw, jr, rng_keys)
    ta = f_t(_t(keys), _t(valid), tw, tr, rng_keys)
    return np.asarray(ja), ta


@pytest.mark.parametrize("n,rng_keys,valid_p", [
    (5000, 1024, 0.8), (3001, 640, 0.5), (2048, 512, 0.0), (7000, 4096, 1.0),
])
def test_accumulate_raw_matches(n, rng_keys, valid_p):
    ja, ta = _accumulate_both(np.random.default_rng(n), n, rng_keys, valid_p)
    assert ta.dtype == torch.int32
    assert ta.shape == ja.shape == ((rng_keys + 127) // 128, 9, 128)
    np.testing.assert_array_equal(ta.numpy(), ja)
    if valid_p == 0.0:
        assert not ta.any()


def test_accumulate_f64_matches():
    ja, ta = _accumulate_both(np.random.default_rng(9), 3000, 1024, 0.7,
                              raw=False)
    assert ta.dtype == torch.float64
    np.testing.assert_array_equal(ta.numpy(), ja)


def test_accumulate_blocks_like_jax(monkeypatch):
    """Inputs longer than the exactness block run block by block and sum
    the blocks; a shrunken block exercises that loop at test size."""
    monkeypatch.setattr(M, "_I32_EXACT_ROWS", 1000)
    ja, ta = _accumulate_both(np.random.default_rng(11), 4321, 1024, 0.9)
    np.testing.assert_array_equal(ta.numpy(), ja)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_grouped_multi_and_finalize_match(exact_exp2, seed):
    rng = np.random.default_rng(seed)
    n, r = 6000, 2048
    keys = rng.integers(0, r, n).astype(np.int32)
    valid = rng.random(n) < 0.85
    state = rng.bit_generator.state
    jspecs = _specs(jnp.asarray, rng, n, valid)
    rng.bit_generator.state = state
    tspecs = _specs(_t, rng, n, valid)
    jouts, jbad = J.grouped_multi(jnp.asarray(keys), jnp.asarray(valid),
                                  jspecs, r)
    touts, tbad = M.grouped_multi(_t(keys), _t(valid), tspecs, r)
    assert bool(tbad) == bool(jbad) is False
    kinds = ["count", "sumf", "sumi", "count"]
    for kind, a, b in zip(kinds, touts, jouts):
        b = np.asarray(b)
        assert a.numpy().dtype == b.dtype
        if kind == "sumf":
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-12, atol=0)
        else:
            np.testing.assert_array_equal(a.numpy(), b)
    # and against numpy itself: counts and int sums are exact
    ok = valid
    np.testing.assert_array_equal(touts[0].numpy(),
                                  np.bincount(keys[ok], minlength=r))
    want = np.zeros(r, np.int64)
    np.add.at(want, keys[ok], tspecs[2][1].numpy()[ok])
    np.testing.assert_array_equal(touts[2].numpy(), want)


def test_finalize_fixed_scale_matches(exact_exp2):
    rng = np.random.default_rng(5)
    n, r = 5000, 1024
    keys = rng.integers(0, r, n).astype(np.int32)
    valid = np.ones(n, bool)
    v = _float_vals(rng, n)
    s = 8.0 * J.f64_chunks() - 4.0 - (np.floor(np.log2(np.abs(v).max())) + 1)
    jw, jr, jl, _, _ = J.digitize(jnp.asarray(valid), [
        ("sum", jnp.asarray(v), jnp.asarray(valid))], fixed_scales={0: s})
    tw, tr, tl, _, _ = M.digitize(_t(valid), [
        ("sum", _t(v), _t(valid))], fixed_scales={0: s})
    ja = J.accumulate_raw(jnp.asarray(keys), jnp.asarray(valid), jw, jr, r)
    ta = M.accumulate_raw(_t(keys), _t(valid), tw, tr, r)
    jo = J.finalize(ja.astype(jnp.int64), jl, r, scales={0: s})[0]
    to = M.finalize(ta.to(torch.int64), tl, r, scales={0: s})[0]
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-12)
    np.testing.assert_allclose(
        to.numpy(), np.bincount(keys, weights=v, minlength=r), rtol=1e-9,
        atol=1e-9)


@pytest.mark.parametrize("bad_value", [np.nan, np.inf, -np.inf])
def test_non_finite_raises_bad_flag(bad_value):
    rng = np.random.default_rng(6)
    n = 2000
    keys = rng.integers(0, 512, n).astype(np.int32)
    v = _float_vals(rng, n)
    v[17] = bad_value
    valid = np.ones(n, bool)
    _, jbad = J.grouped_multi(jnp.asarray(keys), jnp.asarray(valid), [
        ("sum", jnp.asarray(v), jnp.asarray(valid))], 512)
    _, tbad = M.grouped_multi(_t(keys), _t(valid), [
        ("sum", _t(v), _t(valid))], 512)
    assert bool(jbad) and bool(tbad)
    # masked-out non-finite values do not trip it
    valid[17] = False
    _, tbad = M.grouped_multi(_t(keys), _t(valid), [
        ("sum", _t(v), _t(valid))], 512)
    assert not bool(tbad)


def test_fixed_scale_overflow_raises_bad_flag():
    v = np.array([1.0, 2.0, 1e6])
    ok = np.ones(3, bool)
    *_, jbad = J._float_words(jnp.asarray(v), jnp.asarray(ok), fixed_s=40.0)
    *_, tbad = M._float_words(_t(v), _t(ok), fixed_s=40.0)
    assert bool(jbad) and bool(tbad)


def test_grouped_sum_and_count():
    rng = np.random.default_rng(8)
    keys = rng.integers(0, 600, 3000).astype(np.int32)
    valid = rng.random(3000) < 0.6
    v = rng.integers(-1000, 1000, 3000).astype(np.int64)
    np.testing.assert_array_equal(
        M.grouped_count(_t(keys), _t(valid), 600).numpy(),
        np.asarray(J.grouped_count(jnp.asarray(keys), jnp.asarray(valid),
                                   600)))
    np.testing.assert_array_equal(
        M.grouped_sum(_t(keys), _t(v), _t(valid), 600).numpy(),
        np.asarray(J.grouped_sum(jnp.asarray(keys), jnp.asarray(v),
                                 jnp.asarray(valid), 600)))


@pytest.mark.parametrize("sign", [1, -1])
def test_int_sums_near_2_53_are_exact(sign):
    """~125 rows a group of values in [2^45, 2^46): group sums reach
    ~2^52.9, where an f64 recombination would round; finalize's int64
    recombination must give numpy's exact int64 sums."""
    rng = np.random.default_rng(13)
    n, r = 2000, 16
    keys = rng.integers(0, r, n).astype(np.int32)
    v = sign * rng.integers(2**45, 2**46, n).astype(np.int64)
    valid = np.ones(n, bool)
    want = np.zeros(r, np.int64)
    np.add.at(want, keys, v)
    assert np.abs(want).max() > 2**52
    got = M.grouped_sum(_t(keys), _t(v), _t(valid), 512)[:r].numpy()
    ref = np.asarray(J.grouped_sum(jnp.asarray(keys), jnp.asarray(v),
                                   jnp.asarray(valid), 512))[:r]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, ref)


def test_wrapper_rejects_other_devices():
    keys = torch.zeros(8, dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError, match="no digit-plane accumulate"):
        M._accumulate_planes(keys, torch.ones(8, dtype=torch.bool,
                                              device="meta"),
                             [keys], (("raw", 0, 0),), 1, 128)


def _into_inputs(n=64, P=2, W=1, rng=256):
    """Valid arguments of accumulate_into at a small size on the CPU."""
    keys = torch.arange(n, dtype=torch.int32) % rng
    valid = torch.ones(n, dtype=torch.bool)
    words = [torch.full((n,), 0x01020304, dtype=torch.int32)
             for _ in range(W)]
    recipe = tuple(("digit", i % W, 8 * (i % 4)) for i in range(P))
    acc = torch.zeros(((rng + 127) // 128, P, 128), dtype=torch.int64)
    return dict(acc=acc, keys=keys, valid=valid, words=words, recipe=recipe,
                rng=rng)


def _bad(field, fn):
    def make():
        kw = _into_inputs()
        kw[field] = fn(kw)
        return kw
    return make


BAD_INPUTS = {
    "keys-int64": (_bad("keys", lambda kw: kw["keys"].to(torch.int64)),
                   "keys must be"),
    "valid-int32": (_bad("valid", lambda kw: kw["valid"].to(torch.int32)),
                    "valid must be"),
    "words-int64": (_bad("words", lambda kw: [kw["words"][0].long()]),
                    r"words\[0\] must be"),
    "keys-strided": (_bad("keys", lambda kw: torch.zeros(
        128, dtype=torch.int32)[::2]), "keys must be"),
    "valid-short": (_bad("valid", lambda kw: kw["valid"][:10]),
                    "valid must be"),
    "valid-meta": (_bad("valid", lambda kw: kw["valid"].to("meta")),
                   "valid must be"),
    "carry-int32": (_bad("acc", lambda kw: kw["acc"].to(torch.int32)),
                    "carry must be"),
    "carry-meta": (_bad("acc", lambda kw: kw["acc"].to("meta")),
                   "carry must be"),
    "carry-too-few-keys": (_bad("acc", lambda kw: kw["acc"][:1]),
                           "carry must be"),
    "carry-planes": (_bad("acc", lambda kw: torch.zeros(
        (2, 3, 128), dtype=torch.int64)), "carry must be"),
    "planes-33": (lambda: _into_inputs(P=33), "33 planes"),
    "words-17": (lambda: _into_inputs(W=17), "17 words"),
    "recipe-word": (_bad("recipe", lambda kw: (("digit", 3, 0),) * 2),
                    "recipe reads a word"),
    "recipe-shift": (_bad("recipe", lambda kw: (("digit", 0, 4),) * 2),
                     "bad recipe entry"),
    "recipe-kind": (_bad("recipe", lambda kw: (("sum", 0, 0),) * 2),
                    "bad recipe entry"),
}


@pytest.mark.parametrize("case", sorted(BAD_INPUTS))
def test_kernel_wrapper_checks_inputs(case):
    """accumulate_into raises before it touches the carry on any input the
    kernel chain does not take, on the CPU route as on the card."""
    make, match = BAD_INPUTS[case]
    kw = make()
    with pytest.raises(ValueError, match=match):
        M.accumulate_into(**kw)


def test_kernel_wrapper_checks_key_range():
    """A carry of more keys than the kernel's 2^17 raises, on the CPU route
    as on the card."""
    kw = _into_inputs(P=2, rng=256)
    kw["acc"] = torch.zeros(((1 << 17) // 128 + 1, 2, 128),
                            dtype=torch.int64)
    with pytest.raises(ValueError, match="exceeds the kernel's"):
        M.accumulate_into(**kw)


def test_kernel_wrapper_accepts_its_own_inputs():
    kw = _into_inputs(P=3)
    M.accumulate_into(**kw)
    # every row keeps 3 digits of 0x01020304: 0x04, 0x03, 0x02 - 128
    want = torch.tensor([4 - 128, 3 - 128, 2 - 128], dtype=torch.int64)
    assert torch.equal(kw["acc"][0, :, 0], want)
    assert int(kw["acc"].count_nonzero()) == 3 * 64


def _into_batches(seed, n_batches, n, rng_keys, valid_p, kind):
    """Seeded batches of keys (some outside [0, rng)), valid flags and the
    spec list of one accumulate recipe kind, as numpy."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        keys = rng.integers(-40, rng_keys + 40, n).astype(np.int32)
        valid = rng.random(n) < valid_p
        ones = np.ones(n, bool)
        if kind == "int":
            specs = [("count", ones),
                     ("sum", rng.integers(-2**50, 2**50, n), ones)]
        elif kind == "float":
            specs = [("count", ones), ("sum", _float_vals(rng, n), ones),
                     ("count", rng.random(n) < 0.5)]
        else:  # one count plane
            specs = [("count", rng.random(n) < 0.7)]
        out.append((keys, valid, specs))
    return out


def _specs_as(conv, specs):
    return [(s[0],) + tuple(conv(a) for a in s[1:]) for s in specs]


@pytest.mark.parametrize("kind,n,rng_keys,valid_p", [
    ("int", 3000, 1024, 0.8), ("float", 2500, 700, 0.6),
    ("count", 4001, 2048, 0.9), ("int", 1, 128, 1.0),
    ("float", 2048, 512, 0.0),
])
def test_accumulate_into_matches_reference_carry(exact_exp2, kind, n,
                                                 rng_keys, valid_p):
    """accumulate_into over several batches equals the reference stage's
    carry, the JAX accumulate_raw of each batch summed in int64
    (blaze_tpu/runtime/stage_compiler.py:568-569), bit for bit."""
    batches = _into_batches(n + rng_keys, 3, n, rng_keys, valid_p, kind)
    gh = (rng_keys + 127) // 128
    jcarry = None
    tcarry = None
    for keys, valid, specs in batches:
        fs = {1: 20.0} if kind == "float" else None
        jw, jr, _, _, _ = J.digitize(jnp.asarray(valid),
                                     _specs_as(jnp.asarray, specs),
                                     fixed_scales=fs)
        tw, tr, _, _, _ = M.digitize(_t(valid), _specs_as(_t, specs),
                                     fixed_scales=fs)
        assert tr == jr
        part = J.accumulate_raw(jnp.asarray(keys), jnp.asarray(valid), jw,
                                jr, rng_keys).astype(jnp.int64)
        jcarry = part if jcarry is None else jcarry + part
        if tcarry is None:
            tcarry = torch.zeros((gh, len(tr), 128), dtype=torch.int64)
        M.accumulate_into(tcarry, _t(keys), _t(valid), tw, tr, rng_keys)
    np.testing.assert_array_equal(tcarry.numpy(), np.asarray(jcarry))
    if valid_p == 0.0:
        assert not tcarry.any()


def test_accumulate_into_adds_to_the_carry_with_wrap():
    """The carry is updated in place, and int64 sums wrap in two's
    complement as the kernel's 64-bit adds do."""
    kw = _into_inputs(P=1, rng=128)
    start = torch.full_like(kw["acc"], 2**63 - 1)
    kw["acc"].copy_(start)
    kw["words"] = [torch.full((64,), 0x81, dtype=torch.int32)]  # digit 1
    before = kw["acc"].data_ptr()
    M.accumulate_into(**kw)
    assert kw["acc"].data_ptr() == before
    hit = kw["acc"][0, 0, :64]
    assert bool((hit == -2**63).all())
    assert bool((kw["acc"][0, 0, 64:] == 2**63 - 1).all())


@pytest.mark.parametrize("P", [1, 2, 3, 4, 7, 8, 16, 32])
def test_kernel_takes_the_widest_dense_key_range(P):
    """The kernel's key limit covers the widest dense key range the stage
    compiler sends (dense_agg_range <= 2^16) at every plane count: a carry
    of 2^17 keys is accepted and adds like the plain sum."""
    n = 4096
    rng = np.random.default_rng(P)
    keys = rng.integers(0, 1 << 17, n).astype(np.int32)
    words = [torch.from_numpy(rng.integers(-2**31, 2**31, n)
                              .astype(np.int32)) for _ in range(8)]
    recipe = tuple(("digit", p // 4, 8 * (p % 4)) for p in range(P))
    acc = torch.zeros(((1 << 17) // 128, P, 128), dtype=torch.int64)
    M.accumulate_into(acc, _t(keys), torch.ones(n, dtype=torch.bool),
                      words, recipe, 1 << 17)
    want = np.zeros((1 << 17, P), np.int64)
    for p, (_, wi, sh) in enumerate(recipe):
        d = ((words[wi].numpy().astype(np.int64) >> sh) & 0xFF) - 128
        np.add.at(want[:, p], keys, d)
    got = acc.permute(0, 2, 1).reshape(1 << 17, P).numpy()
    np.testing.assert_array_equal(got, want)
