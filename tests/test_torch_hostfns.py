"""Parity of the port's host-evaluated kernels (blaze_tpu_torch/exprs/
hostfns.py) with the JAX package's, on the CPU.

The JSON path parser, evaluator and renderer, the digests and CRC32 are
held equal to the JAX package's on the same inputs; the row crossings
(`host_bytes_to_string`, `host_bytes_to_int64`) give bitwise-equal
columns on the same string batch, nulls, empty strings, invalid JSON and
strings at full width included. Each crossing is one device->host copy
and one host->device copy, counted in `metrics.HOST_PULLS` and
`metrics.HOST_EVAL`.
"""

import numpy as np
import pytest

from blaze_tpu.columnar import types as JT
from blaze_tpu.columnar.batch import ColumnBatch as JBatch
from blaze_tpu.exprs import hostfns as jhost
from blaze_tpu_torch.columnar import types as TT
from blaze_tpu_torch.columnar.batch import ColumnBatch
from blaze_tpu_torch.exprs import hostfns
from blaze_tpu_torch.runtime import metrics

DOCS = ['{"a": 1, "b": {"c": [1, 2, "x"]}, "f": 1.5, "t": true}',
        '{"a": "str", "b": {"c": {"d": null}}}', "{bad", "[1, [2, 3]]",
        '{"a": null}', "", "null", '{"b": {"c": []}, "k": [{"v": 1}]}',
        '"just a string"', '{"a": [{"k": true}, {"k": false}]}',
        '{"long": "0123456789abcdef0123456789abcde"}']
PATHS = ["$", "$.a", "$.b.c", "$.b.c[0]", "$.b.c[-1]", "$.b.c[*]",
         "$['a']", '$["b"].c', "$.a[*].k", "$.k[0].v", "$.f", "$.t",
         "a", "$.", "$[", "$[x]", "$..a", "$.b.c[5]", "$.long"]


@pytest.mark.parametrize("path", PATHS)
def test_json_path_matches_jax(path):
    steps = hostfns.parse_json_path(path)
    assert steps == jhost.parse_json_path(path)
    if steps is None:
        return
    for doc in DOCS:
        raw = doc.encode()
        assert hostfns.get_json_object_row(raw, steps) == \
            jhost.get_json_object_row(raw, steps), (path, doc)


def test_parse_cache_and_validation():
    for doc in DOCS + ["\xff".encode("latin-1").decode("latin-1")]:
        raw = doc.encode("utf-8", "surrogatepass")
        assert hostfns.validate_json_row(raw) == jhost.validate_json_row(raw)
    assert hostfns.validate_json_row(b"\xff\xfe") is None
    hostfns._PARSE_CACHE.clear()
    for k in range(hostfns._PARSE_CACHE_MAX + 10):
        hostfns.cached_parse(str(k).encode())
    assert len(hostfns._PARSE_CACHE) == hostfns._PARSE_CACHE_MAX
    assert b"0" not in hostfns._PARSE_CACHE      # least recently used out
    assert hostfns._PARSE_CACHE_MAX == jhost._PARSE_CACHE_MAX


def test_digests_and_crc32_match_jax():
    assert {k: w for k, (w, _) in hostfns.DIGESTS.items()} == \
        {k: w for k, (w, _) in jhost.DIGESTS.items()}
    for raw in (b"", b"blaze", bytes(range(256)), "é".encode()):
        for name, (_, fn) in hostfns.DIGESTS.items():
            assert fn(raw) == jhost.DIGESTS[name][1](raw)
        assert hostfns.crc32_value(raw) == jhost.crc32_value(raw)


def _pair(values, valid, cap=64):
    n = len(values)
    data = {"s": np.array(values, object)}
    jb = JBatch.from_numpy(data, JT.Schema([JT.Field("s", JT.STRING)]),
                           capacity=cap, validity={"s": valid})
    c = jb.columns[0]
    tb = ColumnBatch.from_host_arrays(
        TT.Schema([TT.Field("s", TT.STRING)]),
        [((np.asarray(c.data.bytes), np.asarray(c.data.lengths)),
          np.asarray(c.validity))], n, cap, device="cpu")
    return jb, tb


def _same(tc, jc, n):
    live = np.arange(tc.capacity) < n
    tv = tc.valid_mask().numpy() & live
    np.testing.assert_array_equal(tv, np.asarray(jc.valid_mask()) & live)
    if tc.is_string:
        tl, jl = tc.data.lengths.numpy(), np.asarray(jc.data.lengths)
        tb, jb = tc.data.bytes.numpy(), np.asarray(jc.data.bytes)
        assert tb.shape == jb.shape
        for i in np.nonzero(tv)[0]:
            assert tb[i, :tl[i]].tobytes() == jb[i, :jl[i]].tobytes()
    else:
        np.testing.assert_array_equal(tc.data.numpy()[tv],
                                      np.asarray(jc.data)[tv])


@pytest.mark.parametrize("kind", ["md5", "sha512", "json", "crc32",
                                  "too_wide"])
def test_row_crossing_matches_jax(kind):
    rng = np.random.default_rng(3)
    n = 50
    values = [DOCS[k] for k in rng.integers(0, len(DOCS), n)]
    valid = rng.random(n) < 0.8
    jb, tb = _pair(values, valid)
    steps = hostfns.parse_json_path("$.b.c")
    pulls, crossings = metrics.HOST_PULLS, metrics.HOST_EVAL["hostfn"][0]
    if kind == "crc32":
        tc = hostfns.host_bytes_to_int64(tb.columns[0], tb,
                                         hostfns.crc32_value)
        jc = jhost.host_bytes_to_int64(jb.columns[0], jb, jhost.crc32_value)
    else:
        width, fn, jfn = {
            "md5": (32, hostfns.DIGESTS["md5"][1], jhost.DIGESTS["md5"][1]),
            "sha512": (128, hostfns.DIGESTS["sha512"][1],
                       jhost.DIGESTS["sha512"][1]),
            "json": (32, lambda r: hostfns.get_json_object_row(r, steps),
                     lambda r: jhost.get_json_object_row(r, steps)),
            # results past the output width are nulled, never cut
            "too_wide": (8, hostfns.DIGESTS["md5"][1],
                         jhost.DIGESTS["md5"][1])}[kind]
        tc = hostfns.host_bytes_to_string(tb.columns[0], tb, width, fn)
        jc = jhost.host_bytes_to_string(jb.columns[0], jb, width, jfn)
    assert metrics.HOST_PULLS - pulls == 1
    assert metrics.HOST_EVAL["hostfn"][0] - crossings == 1
    _same(tc, jc, n)


def test_pull_and_upload_round_trip():
    ts = [torch_t for torch_t in _tensors()]
    pulls = metrics.HOST_PULLS
    arrs = hostfns.pull(ts)
    assert metrics.HOST_PULLS - pulls == 1
    back = hostfns.upload(arrs, "cpu")
    for t, a, b in zip(ts, arrs, back):
        assert a.shape == tuple(t.shape)
        assert b.dtype == t.dtype and b.shape == t.shape
        assert bool((b == t).all())


def _tensors():
    import torch

    g = torch.Generator().manual_seed(1)
    return [torch.randint(0, 255, (7, 5), generator=g).to(torch.uint8),
            torch.randint(-9, 9, (7,), generator=g).to(torch.int32),
            torch.rand(7, generator=g) < 0.5,
            torch.randn(3, generator=g, dtype=torch.float64),
            torch.tensor([5], dtype=torch.int64)]
