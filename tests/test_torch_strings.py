"""exprs/strings.py, string storage and string hashing of the port against
the JAX package's, on the CPU.

The same seeded byte strings (a small alphabet with bytes >= 0x80, zero
bytes and the LIKE wildcards, lengths 0 to the width) go through every
public function of both packages' strings.py; byte matrices, lengths,
flags and integers must be equal. `hash_bytes` and `hash_column` must be
bit-equal with bytes >= 0x80, lengths 0-3 past a word boundary, nulls and
dictionary columns. Batches with string columns are built, gathered,
normalized and pulled back equal to the JAX package's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blaze_tpu.columnar import types as JT
from blaze_tpu.columnar.batch import ColumnBatch as JBatch
from blaze_tpu.columnar.batch import Column as JColumn
from blaze_tpu.columnar.batch import DictData as JDict
from blaze_tpu.columnar.batch import StringData as JStr
from blaze_tpu.exprs import hash as JH
from blaze_tpu.exprs import strings as JS
from blaze_tpu_torch.columnar import types as TT
from blaze_tpu_torch.columnar.batch import Column, ColumnBatch, DictData
from blaze_tpu_torch.columnar.batch import StringData
from blaze_tpu_torch.exprs import hash as TH
from blaze_tpu_torch.exprs import strings as TS

ALPHABET = np.frombuffer(b"ab%_\\\x00\x80\xffc\xc3\xa9 ", np.uint8)
N = 200


def random_strings(seed, n=N, max_len=16, alphabet=ALPHABET):
    """n byte strings of lengths 0..max_len over `alphabet`."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, max_len + 1, n)
    return [bytes(rng.choice(alphabet, ln)) for ln in lens]


def string_matrix(vals, cap=None, width=None):
    """(bytes (cap, W), lengths (cap,)) of `vals`, zero-padded."""
    cap = cap or len(vals)
    w = width or max(4, -(-max((len(v) for v in vals), default=1) // 4) * 4)
    mat = np.zeros((cap, w), np.uint8)
    lens = np.zeros((cap,), np.int32)
    for i, v in enumerate(vals):
        mat[i, :len(v)] = np.frombuffer(v, np.uint8)
        lens[i] = len(v)
    return mat, lens


def both_strings(vals, width=None):
    mat, lens = string_matrix(vals, width=width)
    return (JStr(jnp.asarray(mat), jnp.asarray(lens)),
            StringData(torch.from_numpy(mat.copy()),
                       torch.from_numpy(lens.copy())))


def assert_same(j, t):
    """Equal results of the two packages, whatever their structure."""
    if isinstance(j, (tuple, list)):
        assert len(j) == len(t)
        for a, b in zip(j, t):
            assert_same(a, b)
        return
    if isinstance(j, (JStr, JDict)):
        assert isinstance(t, (StringData, DictData))
        np.testing.assert_array_equal(t.lengths.numpy(),
                                      np.asarray(j.lengths))
        np.testing.assert_array_equal(t.bytes.numpy(), np.asarray(j.bytes))
        return
    jv = np.asarray(j)
    tv = t.numpy()
    if jv.dtype == np.bool_:
        assert tv.dtype == np.bool_
    np.testing.assert_array_equal(tv.astype(np.int64), jv.astype(np.int64))


@pytest.fixture(scope="module")
def inputs():
    a = random_strings(1)
    b = random_strings(2, max_len=7)
    # about a third of b equal to a's rows, so comparisons tie
    b = [a[i] if i % 3 == 0 else v for i, v in enumerate(b)]
    rng = np.random.default_rng(3)
    ints = rng.integers(-20, 21, N).astype(np.int32)
    big = rng.integers(-(1 << 40), 1 << 40, N).astype(np.int64)
    return both_strings(a), both_strings(b), ints, big


def _i(mod, x):
    return jnp.asarray(x) if mod is JS else torch.from_numpy(x.copy())


# (id, fn(S, a, b, ints, big)); S is either package's strings module
CASES = [
    ("ensure_width", lambda S, a, b, i, g: S.ensure_width(b, 32)),
    ("common_width", lambda S, a, b, i, g: S.common_width(a, b)),
    ("pack_words_be", lambda S, a, b, i, g: S.pack_words_be(a)),
    ("compare", lambda S, a, b, i, g: S.compare(a, b)),
    ("compare_self", lambda S, a, b, i, g: S.compare(a, a)),
    ("equals", lambda S, a, b, i, g: S.equals(a, b)),
    ("starts_with", lambda S, a, b, i, g: [
        S.starts_with(a, p) for p in (b"", b"a", b"ab", b"\x80\xff",
                                      b"x" * 20)]),
    ("ends_with", lambda S, a, b, i, g: [
        S.ends_with(a, p) for p in (b"", b"b", b"ab", b"\xc3\xa9",
                                    b"x" * 20)]),
    ("match_positions", lambda S, a, b, i, g: S.match_positions(a, b"ab")),
    ("contains", lambda S, a, b, i, g: [
        S.contains(a, p) for p in (b"", b"a", b"ba", b"\x00a", b"x" * 20)]),
    ("like_match", lambda S, a, b, i, g: [
        S.like_match(a, p) for p in (b"%", b"", b"a%", b"%b", b"%ab%",
                                     b"_", b"a_b%", b"%\\%%", b"%\\_",
                                     b"\xc3\xa9%", b"_%_")]),
    ("upper_ascii", lambda S, a, b, i, g: S.upper_ascii(a)),
    ("lower_ascii", lambda S, a, b, i, g: S.lower_ascii(S.upper_ascii(a))),
    ("char_length", lambda S, a, b, i, g: S.char_length(a)),
    ("octet_length", lambda S, a, b, i, g: S.octet_length(a)),
    ("substring", lambda S, a, b, i, g: S.substring(
        a, _i(S, i), _i(S, np.abs(i[::-1])))),
    ("concat", lambda S, a, b, i, g: S.concat([a, b])),
    ("repeat", lambda S, a, b, i, g: [S.repeat(b, 3), S.repeat(b, 0)]),
    ("reverse", lambda S, a, b, i, g: S.reverse(a)),
    ("initcap", lambda S, a, b, i, g: S.initcap(a)),
    ("lpad", lambda S, a, b, i, g: [S.lpad(a, 12, b"xy"),
                                    S.lpad(a, 5, b"")]),
    ("rpad", lambda S, a, b, i, g: [S.rpad(a, 20, b"-"),
                                    S.rpad(a, 3, b"")]),
    ("strpos", lambda S, a, b, i, g: [
        S.strpos(a, p) for p in (b"", b"a", b"b%", b"x" * 20)]),
    ("greedy_matches", lambda S, a, b, i, g: S.greedy_matches(a, b"aa")),
    ("replace", lambda S, a, b, i, g: [S.replace(a, b"a", b"XYZ"),
                                       S.replace(a, b"ab", b""),
                                       S.replace(a, b"", b"q")]),
    ("split_part", lambda S, a, b, i, g: [
        S.split_part(a, b"a", _i(S, np.clip(i, -4, 4))),
        S.split_part(a, b"", _i(S, np.clip(i, -1, 1)))]),
    ("translate", lambda S, a, b, i, g: S.translate(a, b"abca", b"xy")),
    ("chr_fn", lambda S, a, b, i, g: S.chr_fn(_i(S, g), N)),
    ("to_hex", lambda S, a, b, i, g: S.to_hex(_i(S, g), N)),
    ("trim", lambda S, a, b, i, g: [S.trim(a), S.trim(a, True, False),
                                    S.trim(a, False, True, b"ab ")]),
]


@pytest.mark.parametrize("name,fn", CASES, ids=[c[0] for c in CASES])
def test_strings_function_matches_jax(inputs, name, fn):
    (ja, ta), (jb, tb), ints, big = inputs
    assert_same(fn(JS, ja, jb, ints, big), fn(TS, ta, tb, ints, big))


def test_every_public_function_has_a_case():
    import inspect

    public = {n for n, f in inspect.getmembers(JS, inspect.isfunction)
              if f.__module__ == JS.__name__ and not n.startswith("_")}
    covered = {c[0] for c in CASES}
    assert public <= covered, public - covered
    for n in public:
        assert callable(getattr(TS, n)), n


@pytest.mark.parametrize("pattern,escape", [
    (b"a\\%b", b"\\"), (b"a!_%", b"!"), (b"%\\\\%", b"\\"),
    (b"\xc3_", b"\\"), (b"_", b"\\"), (b"__", b"\\"), (b"", b"\\"),
    (b"%", b"\\"), (b"%%a", b"\\"), (b"a\\", b"\\")])
def test_like_escapes_and_multibyte(pattern, escape):
    """LIKE counts bytes: `_` matches one byte of a two-byte UTF-8
    character, as in the JAX package; escapes make `%` and `_` literal."""
    vals = [b"a%b", b"a_x", b"a_", b"\\", b"a\\b", "é".encode(), b"",
            b"e", b"ab", b"\xc3x", b"aa%", b"a\\", b"xa"]
    js, ts = both_strings(vals)
    got = TS.like_match(ts, pattern, escape).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(JS.like_match(js, pattern, escape)))
    if pattern == b"_":
        # one byte only: the two-byte character does not match `_`
        assert list(got) == [len(v) == 1 for v in vals]


# ---------------------------------------------------------------------------
# hashing
# ---------------------------------------------------------------------------

def _hash_inputs(seed):
    """Strings of lengths 0..19 (every tail length past every word) over
    all 256 byte values, one row in five null."""
    rng = np.random.default_rng(seed)
    vals = [bytes(rng.integers(0, 256, ln).astype(np.uint8))
            for ln in list(range(20)) * 6]
    valid = rng.random(len(vals)) >= 0.2
    return vals, valid


@pytest.mark.parametrize("seed", [0, 1])
def test_hash_bytes_bit_equal(seed):
    vals, _ = _hash_inputs(seed)
    js, ts = both_strings(vals)
    seeds = np.random.default_rng(seed).integers(0, 1 << 32, len(vals))
    want = np.asarray(JH.hash_bytes(js, jnp.asarray(seeds, jnp.uint32)))
    got = TH.hash_bytes(ts, torch.from_numpy(seeds.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    # a scalar seed, and a wider width bucket, give the same hashes
    wide = both_strings(vals, width=64)[1]
    np.testing.assert_array_equal(TH.hash_bytes(wide, 42).numpy(),
                                  TH.hash_bytes(ts, 42).numpy())


@pytest.mark.parametrize("dictionary", [False, True])
def test_hash_columns_with_nulls_bit_equal(dictionary):
    """Spark's multi-column hash over (string, int) with nulls; a dictionary
    column hashes as its expansion."""
    vals, valid = _hash_inputs(5)
    n = len(vals)
    ints = np.arange(n, dtype=np.int32) * 7 - 300
    jschema = JT.Schema([JT.Field("s", JT.STRING), JT.Field("i", JT.INT32)])
    objs = np.array([v if ok else None for v, ok in zip(vals, valid)],
                    object)
    jb = JBatch.from_numpy({"s": objs, "i": ints}, jschema)
    tb = ColumnBatch.from_numpy(
        {"s": list(objs), "i": ints},
        TT.Schema([TT.Field("s", TT.STRING), TT.Field("i", TT.INT32)]),
        device="cpu")
    if dictionary:
        tb = tb.with_columns(tb.schema, [_as_dict(tb.columns[0]),
                                         tb.columns[1]])
    want = np.asarray(JH.hash_columns(jb.columns, row_mask=jb.row_mask()))
    got = TH.hash_columns(tb.columns, row_mask=tb.row_mask())
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(TH.pmod(got, 200).numpy(),
                                  np.asarray(JH.pmod(jnp.asarray(want), 200)))


def _as_dict(col: Column) -> Column:
    """The same strings as a DictData column (entry 0 the empty string)."""
    b, ln = col.data.bytes.numpy(), col.data.lengths.numpy()
    keys = [bytes(r[:k]) for r, k in zip(b, ln)]
    uniq = sorted(set(keys) | {b""})
    code = {k: i for i, k in enumerate(uniq)}
    mat, lens = string_matrix(uniq, width=b.shape[1])
    codes = np.array([code[k] for k in keys], np.int32)
    d = DictData(torch.from_numpy(codes), torch.from_numpy(mat),
                 torch.from_numpy(lens))
    return Column(col.dtype, d, col.validity)


# ---------------------------------------------------------------------------
# storage
# ---------------------------------------------------------------------------

def test_batch_round_trip_matches_jax():
    """from_numpy (str, bytes and None), to_numpy, take with null
    extension and normalized() equal the JAX package's, padding zero."""
    vals = ["x", None, b"\x80\x00", "", "été", None, b"abcdefghij"]
    jschema = JT.Schema([JT.Field("s", JT.BINARY)])
    tschema = TT.Schema([TT.Field("s", TT.BINARY)])
    jb = JBatch.from_numpy({"s": np.array(vals, object)}, jschema,
                           capacity=16)
    tb = ColumnBatch.from_numpy({"s": vals}, tschema, capacity=16,
                                device="cpu")
    assert tb.to_numpy()["s"] == jb.to_numpy()["s"]
    assert_same(jb.columns[0].data, tb.columns[0].data)
    assert tb.shape_key() == (16, ("s", 16, True))
    idx = np.array([6, 1, 0, 0, 3] + [0] * 11, np.int32)
    ok = np.arange(16) % 2 == 0
    jt = jb.columns[0].take(jnp.asarray(idx),
                            index_valid=jnp.asarray(ok)).normalized()
    tt = tb.columns[0].take(torch.from_numpy(idx.astype(np.int64)),
                            index_valid=torch.from_numpy(ok)).normalized()
    assert_same(jt.data, tt.data)
    np.testing.assert_array_equal(tt.validity.numpy(), np.asarray(jt.validity))


def test_dict_column_take_normalize_and_pull():
    col = ColumnBatch.from_numpy(
        {"s": [b"aa", b"b", None, b"aa", b""]},
        TT.Schema([TT.Field("s", TT.STRING)]), device="cpu").columns[0]
    d = _as_dict(col)
    assert d.is_dict and d.is_string
    jd = JColumn(JT.STRING, JDict(jnp.asarray(d.data.codes.numpy()),
                                  jnp.asarray(d.data.dict_bytes.numpy()),
                                  jnp.asarray(d.data.dict_lengths.numpy())),
                 jnp.asarray(d.validity.numpy()))
    idx = np.array([3, 2, 1, 0, 4, 0, 0, 0])
    assert_same(jd.take(jnp.asarray(idx)).normalized().data,
                d.take(torch.from_numpy(idx)).normalized().data)
    assert d.take(torch.from_numpy(idx)).data.dict_bytes is d.data.dict_bytes
    b = ColumnBatch(TT.Schema([TT.Field("s", TT.STRING)]), [d],
                    torch.tensor(5, dtype=torch.int32), 8)
    assert b.to_numpy()["s"] == [b"aa", b"b", None, b"aa", b""]


def test_bucket_width_matches_jax():
    from blaze_tpu.columnar.batch import bucket_dict_rows as jrows
    from blaze_tpu.columnar.batch import bucket_width as jwidth
    from blaze_tpu_torch.columnar.batch import bucket_dict_rows, bucket_width

    for w in (0, 1, 4, 5, 17, 64, 4096):
        assert bucket_width(w) == jwidth(w)
    for k in (0, 1, 8, 9, 1000):
        assert bucket_dict_rows(k) == jrows(k)
    with pytest.raises(ValueError, match="max_string_width"):
        bucket_width(5000)
