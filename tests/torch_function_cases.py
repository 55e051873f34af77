"""The edge table and the cases of every registered scalar function, shared
by the port's CPU parity test (tests/test_torch_functions.py, against the
JAX package) and its card test (tests/test_torch_card.py, CUDA against the
port's CPU route). Imports neither jax nor blaze_tpu."""

import numpy as np

N, CAP = 300, 512
SUBNORMAL_VALUE = 1e-310
SUBNORMAL_ROW = 15
FIELDS = [("d", "FLOAT64"), ("f", "FLOAT32"), ("i", "INT32"),
          ("l", "INT64"), ("j", "INT64"), ("dt", "DATE"), ("s", "STRING"),
          ("t", "STRING"), ("js", "STRING")]
WORDS = ["", "a", "Hello World", "  padded  ", "x,y,z", "ABCdef",
         "hello", "sixteen bytes!!!", "é ascii", "aaa", "a,b", "  ",
         "the quick brown fox jumps over!!"]     # the last: full width 32
JSON = ['{"a": 1, "b": {"c": [1, 2, "x"]}}', '{"a": "str"}', "{bad",
        '[1, 2, 3]', '{"a": null}', "", '{"b": {"c": []}}',
        '{"a": [{"k": true}, {"k": false}]}']


def _table():
    rng = np.random.default_rng(20260)
    d = rng.standard_normal(N) * 10.0 ** rng.integers(-3, 6, N)
    edges = [np.nan, np.inf, -np.inf, 0.0, -0.0, 2.5, -2.5, 0.5, -0.5,
             1.005, 2.675, 1e19, -1e19, 9.3e18, 4503599627370497.0,
             SUBNORMAL_VALUE, 1.0, -1.0, 0.9999999999999999]
    d[:len(edges)] = edges
    i = rng.integers(-1000, 1000, N).astype(np.int32)
    i[:5] = [np.iinfo(np.int32).min, np.iinfo(np.int32).max, 0, -1, 1]
    l = rng.integers(-2**62, 2**62, N).astype(np.int64)
    l[:5] = [np.iinfo(np.int64).min, np.iinfo(np.int64).max, 0, -1, 255]
    data = {
        "d": d, "f": d.astype(np.float32), "i": i, "l": l,
        "j": rng.integers(-4, 5, N).astype(np.int64),
        "dt": rng.integers(-800_000, 2_900_000, N).astype(np.int32),
        "s": np.array([WORDS[k] for k in rng.integers(0, len(WORDS), N)],
                      object),
        "t": np.array([WORDS[k] for k in rng.integers(0, len(WORDS), N)],
                      object),
        "js": np.array([JSON[k] for k in rng.integers(0, len(JSON), N)],
                       object),
    }
    data["dt"][:4] = [0, -1, -719_468, 2_932_896]
    validity = {k: rng.random(N) < 0.85 for k in ("d", "i", "l", "s", "t",
                                                 "dt", "js")}
    return data, validity


def _fn(ir, T, name, *args):
    return ir.ScalarFn(name, tuple(args))


def _c(name):
    return lambda ir, T: ir.col(name)


def _lit(kind, v):
    return lambda ir, T: ir.Literal(getattr(T, kind), v)


def case(name, *args):
    return lambda ir, T: _fn(ir, T, name, *(a(ir, T) for a in args))


D, F, I, L, J, DT = (_c(n) for n in ("d", "f", "i", "l", "j", "dt"))
S, TS, JS = _c("s"), _c("t"), _c("js")

CASES = {}
for _n in ("sqrt", "exp", "ln", "log", "log10", "log2", "sin", "cos", "tan",
           "asin", "acos", "atan", "signum", "abs", "ceil", "floor",
           "trunc"):
    CASES[f"{_n}[d]"] = case(_n, D)
for _n in ("abs", "ceil", "floor", "trunc", "signum", "sqrt"):
    CASES[f"{_n}[i]"] = case(_n, I)
    CASES[f"{_n}[l]"] = case(_n, L)
CASES.update({
    "ceil[f]": case("ceil", F), "trunc[f]": case("trunc", F),
    "abs[f]": case("abs", F),
    "round[d]": case("round", D),
    "round[d,2]": case("round", D, _lit("INT32", 2)),
    "round[d,-2]": case("round", D, _lit("INT32", -2)),
    "round[f,1]": case("round", F, _lit("INT32", 1)),
    "round[i,-1]": case("round", I, _lit("INT32", -1)),
    "round[l,-3]": case("round", L, _lit("INT32", -3)),
    "round[l,2]": case("round", L, _lit("INT32", 2)),
    "pow[d,j]": case("pow", D, J), "power[i,d]": case("power", I, D),
    "atan2[d,i]": case("atan2", D, I),
    "nullif[i,j]": case("nullif", I, J), "nullif[s,t]": case("nullif", S, TS),
    "nullifzero[j]": case("nullifzero", J),
    "null_if_zero[d]": case("null_if_zero", D),
    "coalesce[d,f]": case("coalesce", D, F),
    "coalesce[l,j,i]": case("coalesce", L, J, I),
    "coalesce[s,t,js]": case("coalesce", S, TS, JS),
    "upper": case("upper", S), "lower": case("lower", S),
    "length": case("length", S), "char_length": case("char_length", S),
    "character_length": case("character_length", S),
    "octet_length": case("octet_length", S),
    "bit_length": case("bit_length", S), "ascii": case("ascii", S),
    "substr[s,j]": case("substr", S, J),
    "substring[s,j,i]": case("substring", S, J, _lit("INT32", 3)),
    "concat": case("concat", S, TS),
    "concat_ws": case("concat_ws", _lit("STRING", "-"), S, TS, JS),
    "concat_ws[sep]": case("concat_ws", TS, S),
    "concat_ws[none]": case("concat_ws", _lit("STRING", ",")),
    "trim": case("trim", S), "btrim": case("btrim", S),
    "ltrim": case("ltrim", S), "rtrim": case("rtrim", S),
    "repeat": case("repeat", S, _lit("INT32", 3)),
    "repeat[0]": case("repeat", S, _lit("INT32", 0)),
    "string_space": case("string_space", J),
    "string_space[i]": case("string_space", I),
    "reverse": case("reverse", S), "initcap": case("initcap", S),
    "left": case("left", S, J), "right": case("right", S, J),
    "lpad": case("lpad", S, _lit("INT32", 8), _lit("STRING", "xy")),
    "lpad[short]": case("lpad", S, _lit("INT32", 3)),
    "rpad": case("rpad", S, _lit("INT32", 40), _lit("STRING", "-=")),
    "strpos": case("strpos", S, _lit("STRING", "l")),
    "instr": case("instr", S, _lit("STRING", "")),
    "position": case("position", S, _lit("STRING", "lo W")),
    "replace": case("replace", S, _lit("STRING", "a"),
                    _lit("STRING", "XYZ")),
    "replace[del]": case("replace", S, _lit("STRING", "l")),
    "translate": case("translate", S, _lit("STRING", "abcl"),
                      _lit("STRING", "x")),
    "split_part": case("split_part", S, _lit("STRING", ","), J),
    "chr": case("chr", L), "chr[j]": case("chr", J),
    "hex": case("hex", L), "to_hex": case("to_hex", J),
    "year": case("year", DT), "month": case("month", DT),
    "day": case("day", DT), "dayofmonth": case("dayofmonth", DT),
    "dayofweek": case("dayofweek", DT),
    "date_add": case("date_add", DT, J), "date_sub": case("date_sub", DT, I),
    "datediff": case("datediff", DT, DT),
    "hash": case("hash", I, L, D, S),
    "murmur3_hash": case("murmur3_hash", S, F, DT),
    "md5": case("md5", S), "sha224": case("sha224", S),
    "sha256": case("sha256", S), "sha384": case("sha384", TS),
    "sha512": case("sha512", JS), "crc32": case("crc32", S),
    "get_json_object": case("get_json_object", JS, _lit("STRING", "$.a")),
    "get_json_object[nested]": case("get_json_object", JS,
                                    _lit("STRING", "$.b.c[*]")),
    "get_json_object[bad]": case("get_json_object", JS,
                                 _lit("STRING", "a.b")),
    "get_parsed_json_object": case("get_parsed_json_object", JS,
                                   _lit("STRING", "$.a[0].k")),
    "parse_json": case("parse_json", JS),
    "make_array[l,j]": case("make_array", L, J),
    "make_array[s,t]": case("make_array", S, TS),
})

# units in the last place allowed against the JAX package on XLA's CPU
# backend, the largest measured on this table; every other float output
# is bitwise equal (sqrt too: both sides are correctly rounded)
ULPS = {"acos": 1, "asin": 1, "atan2": 1, "exp": 1, "log10": 1, "log2": 1,
        "pow": 1, "power": 1, "tan": 1}


def _ulp_diff(a, b):
    """Distance in units in the last place between float arrays (NaN ==
    NaN, +0 == -0 counts as one unit apart)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    both_nan = np.isnan(a) & np.isnan(b)
    ia, ib = a.view(np.int64), b.view(np.int64)
    ia = np.where(ia < 0, np.iinfo(np.int64).min - ia, ia)
    ib = np.where(ib < 0, np.iinfo(np.int64).min - ib, ib)
    return np.where(both_nan, 0, np.abs(ia - ib))
