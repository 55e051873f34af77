"""Dense-key grouped aggregation over base-256 digit planes.

Port of blaze_tpu/ops/mxu_agg.py. When the grouping key is integral with a
bounded range, grouped sums and counts become exact integer sums of small
digits per group:

  * values decompose into BALANCED base-256 digits d in [-128, 127]
    (digits of v + bias, bias = 0x80 per byte, minus 128 — signs fold
    into the digits). Floats are first scaled by 2^s and rounded, so the
    digits carry 8*planes-2 bits of the batch (or stage) max magnitude;
  * per batch, every plane of every aggregate is summed per key and added
    into ONE int64 (gh, P, 128) carry (`accumulate_into`; the reference's
    per-batch int32 table, exact for up to 2^23 rows per block since
    127 * 2^23 < 2^31, stays available as `accumulate_raw`);
  * digits recombine once per stage (`finalize`): in f64 for float sums,
    in int64 for int sums (exact modulo 2^64) and counts.

The per-batch accumulate is the one hand-written kernel on this path:
`accumulate_into` adds a batch's plane sums straight into the stage's int64
carry, launching the kernel chain of csrc/mxu_accumulate.cu on a CUDA
tensor and running the plain torch version `_accumulate_into_ref` on a CPU
tensor. There is no other route: a CUDA tensor gets the kernel or an error.
`accumulate_raw` and `accumulate` keep the reference's per-batch int32
table contract on top of it.

Non-finite float values cannot ride digit planes (their digits would be
garbage in every group's slot): digitization reports a `bad` flag so the
caller declines the batch, the same contract as the stage compiler's
out-of-range key flag.

All 64-bit bit work is done in int64 with two's-complement wrap (torch's
uint32/uint64 arithmetic is patchy on CUDA): the int64 bias 0x8080...80
exceeds int64 max, so its wrapped negative value is used — the add wraps
to the same bits.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Sequence, Tuple

import torch

from blaze_tpu_torch import kernels
from blaze_tpu_torch.runtime.metrics import COUNTER_LOCK, tally_add

CHUNK_BITS = 8
I64_CHUNKS = 8          # full int64 (|v| < 2^62; sums exact within 2^53)
_GL = 128
_I32_EXACT_ROWS = 1 << 23   # 127 * 2^23 < 2^31: int32 block-exactness bound

# limits of the kernel chain (csrc/mxu_accumulate.cu)
_MAX_WORDS = 16
_MAX_PLANES = 32
_MAX_KEYS = 1 << 17        # 2^16 is dense_agg_range's most

# launches of the accumulate kernel chain since import: one per call that
# reaches the card with rows to add (one per <= 2^23-row block on the
# accumulate_raw route); and beside it, per kernel of the chain, the
# launches that the C entry reports it made. chip_smoke.py resets both and
# reads them around the main path
KERNEL_LAUNCHES = 0
CHAIN_LAUNCHES = {"count": 0, "scan": 0, "scatter": 0, "accumulate": 0}


def f64_chunks() -> int:
    """Float-sum digit plane count (conf.float_sum_digit_planes), clamped
    to [4, 7] — the signed-int64 bias arithmetic of _float_words caps at
    2^56-scale magnitudes."""
    from blaze_tpu_torch.config import conf

    return max(4, min(int(conf.float_sum_digit_planes), 7))


def _bias_f(nch: int) -> int:
    """Balanced-digit bias for an nch-chunk float path: digits of
    (v + bias) are the balanced digits + 128."""
    return 128 * ((1 << (CHUNK_BITS * nch)) - 1) // 255


# 8-chunk (i64 path) bias 0x8080808080808080, wrapped into int64
_BIAS8 = 128 * ((1 << 64) - 1) // 255 - (1 << 64)


def _i32_bits(x: torch.Tensor) -> torch.Tensor:
    """Low 32 bits of an int64 tensor reinterpreted as int32."""
    return (((x & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000).to(torch.int32)


# ---------------------------------------------------------------------------
# the per-batch accumulate: kernel wrapper + plain version
# ---------------------------------------------------------------------------


def _expand_words(words: Sequence[torch.Tensor], recipe) -> torch.Tensor:
    """Materialize the (n, P) int8 digit matrix from word columns (raw
    planes are 0/1 counts; the cast to int8 is the reference's)."""
    planes = []
    for kind, wi, sh in recipe:
        w = words[wi]
        planes.append(((w >> sh) & 0xFF) - 128 if kind == "digit" else w)
    return torch.stack(planes, dim=1).to(torch.int8)


def _plane_index(keys: torch.Tensor, P: int) -> torch.Tensor:
    """(n, P) int64 flat offsets of each row's planes in a (gh, P, 128)
    table; keys (n,) in [0, gh*128)."""
    k = keys.to(torch.int64)
    base = (k >> 7) * (P * _GL) + (k & (_GL - 1))
    return base[:, None] + torch.arange(P, device=keys.device) * _GL


def _accumulate_into_ref(acc: torch.Tensor, keys: torch.Tensor,
                         valid: torch.Tensor, words, recipe,
                         rng: int) -> None:
    """Plain torch version of the kernel chain, same contract as
    accumulate_into: acc += the batch's (gh, P, 128) plane sums, in place,
    over rows with valid and 0 <= key < rng."""
    ok = valid & (keys >= 0) & (keys < rng)
    k = torch.where(ok, keys, torch.zeros_like(keys))
    D = _expand_words(words, recipe).to(torch.int64) * ok[:, None]
    acc.view(-1).index_add_(0, _plane_index(k, len(recipe)).reshape(-1),
                            D.reshape(-1))


_RECIPES: Dict[tuple, Tuple[ctypes.Array, int]] = {}


def _recipe_arg(recipe) -> Tuple[ctypes.Array, int]:
    """The kernel's flat (kind, word, shift) int32 recipe and the highest
    word index it reads, built once per recipe tuple."""
    recipe = tuple(recipe)
    hit = _RECIPES.get(recipe)
    if hit is None:
        flat = []
        for kind, wi, sh in recipe:
            if kind not in ("digit", "raw") or wi < 0 \
                    or sh not in (0, 8, 16, 24):
                raise ValueError(f"mxu_accumulate: bad recipe entry "
                                 f"{(kind, wi, sh)}")
            flat += [1 if kind == "digit" else 0, wi, sh]
        hit = ((ctypes.c_int32 * len(flat))(*flat),
               max(wi for _, wi, _ in recipe))
        _RECIPES[recipe] = hit
    return hit


def _check_into(acc, keys, valid, words, recipe, rng: int) -> None:
    """Raise ValueError on anything accumulate_into does not take."""
    n, P, W = keys.shape[0], len(recipe), len(words)
    if not (1 <= P <= _MAX_PLANES and 1 <= W <= _MAX_WORDS):
        raise ValueError(f"mxu_accumulate: {P} planes / {W} words exceed "
                         f"the kernel's {_MAX_PLANES}/{_MAX_WORDS}")
    dev = keys.device
    for name, t, dtype in [("keys", keys, torch.int32),
                           ("valid", valid, torch.bool)] + [
            (f"words[{i}]", w, torch.int32) for i, w in enumerate(words)]:
        if t.device != dev or t.dtype != dtype or t.dim() != 1 \
                or t.shape[0] != n or not t.is_contiguous():
            raise ValueError(
                f"mxu_accumulate: {name} must be a contiguous (n,) {dtype} "
                f"tensor on {dev}, got {tuple(t.shape)} {t.dtype} on "
                f"{t.device}")
    gh = (rng + _GL - 1) // _GL
    if acc.device != dev or acc.dtype != torch.int64 or acc.dim() != 3 \
            or acc.shape[0] < gh or tuple(acc.shape[1:]) != (P, _GL) \
            or not acc.is_contiguous():
        raise ValueError(
            f"mxu_accumulate: the carry must be a contiguous int64 "
            f"(>= {gh}, {P}, {_GL}) tensor on {dev}, got "
            f"{tuple(acc.shape)} {acc.dtype} on {acc.device}")
    if _recipe_arg(recipe)[1] >= W:
        raise ValueError(f"mxu_accumulate: recipe reads a word past {W}")
    n_keys = acc.shape[0] * _GL
    if n_keys > _MAX_KEYS:
        raise ValueError(f"mxu_accumulate: a carry of {n_keys} keys exceeds "
                         f"the kernel's {_MAX_KEYS}")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t, or a fresh copy where its data is not 16-byte aligned: the
    chain's loads are 16-byte vector loads."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _chain_call(acc, keys, valid, words, recipe, rng: int):
    """The kernel chain's launch on PyTorch's current stream, as a function
    of no arguments with every host step done: the library loaded, the
    scratch allocated, the ctypes arguments built (inputs already checked
    by _check_into, n > 0). Each call adds the batch into acc once more and
    counts its launches; it raises on anything the chain refuses."""
    n, P, W = keys.shape[0], len(recipe), len(words)
    lib = kernels.load("mxu_accumulate")
    n_keys = acc.shape[0] * _GL
    dev = keys.device
    keys, valid = _aligned(keys), _aligned(valid)
    words = [_aligned(w) for w in words]
    nbytes = lib.mxu_accumulate_scratch_bytes(n, P, n_keys)
    scratch = torch.empty(max(nbytes, 16), dtype=torch.uint8, device=dev)
    rc, _ = _recipe_arg(recipe)
    word_ptrs = (ctypes.c_void_p * W)(*[w.data_ptr() for w in words])
    launched = (ctypes.c_int * len(CHAIN_LAUNCHES))()
    args = (keys.data_ptr(), valid.data_ptr(), ctypes.addressof(word_ptrs),
            W, ctypes.addressof(rc), P, n, rng, n_keys, acc.data_ptr(),
            scratch.data_ptr(), nbytes, dev.index or 0,
            torch.cuda.current_stream(dev).cuda_stream,
            ctypes.addressof(launched))

    def launch():
        global KERNEL_LAUNCHES
        err = lib.mxu_accumulate_into(*args)
        # pool threads launch at once: the counts go under the lock
        with COUNTER_LOCK:
            for name, c in zip(CHAIN_LAUNCHES, launched):
                CHAIN_LAUNCHES[name] += c
            if err == 0:
                KERNEL_LAUNCHES += 1
        if err == 0:
            tally_add("kernel_launches")
        if err != 0:
            raise RuntimeError("mxu_accumulate launch failed: "
                               + lib.mxu_accumulate_error(err).decode())

    launch.keep = (scratch, word_ptrs, launched, acc, keys, valid, words)
    return launch


def _accumulate_into_cuda(acc, keys, valid, words, recipe, rng: int) -> None:
    """Launch the kernel chain of csrc/mxu_accumulate.cu (inputs already
    checked by _check_into)."""
    if keys.shape[0]:
        _chain_call(acc, keys, valid, words, recipe, rng)()


def _route(dev: torch.device):
    if dev.type == "cpu":
        return _accumulate_into_ref
    if dev.type == "cuda":
        return _accumulate_into_cuda
    raise RuntimeError(f"no digit-plane accumulate for {dev}")


def accumulate_into(acc: torch.Tensor, keys: torch.Tensor,
                    valid: torch.Tensor, words, recipe, rng: int) -> None:
    """Add one batch's digit-plane sums into the stage's carry, IN PLACE
    (the JAX package returns a new array; the port updates the carry).

    acc: contiguous int64 (gh, P, 128), gh*128 >= rng, updated with two's-
    complement wrap. keys (n,) int32, valid (n,) bool, words: (n,) int32
    columns, all contiguous on acc's device. Rows with valid false or a key
    outside [0, rng) add nothing. Any n: the carry is int64. On a CUDA
    tensor this launches the kernel chain or raises; on a CPU tensor it
    runs the plain version."""
    _check_into(acc, keys, valid, words, recipe, rng)
    _route(keys.device)(acc, keys, valid, words, recipe, rng)


def _accumulate_planes(keys: torch.Tensor, valid: torch.Tensor, words,
                       recipe, gh: int, rng: int) -> torch.Tensor:
    """Rows outside [0, rng) or invalid contribute nothing. Returns
    (gh, P, GL) int32 — exact per-batch plane sums (per 2^23-row block;
    longer inputs sum their blocks in int32, as the JAX package does)."""
    route = _route(keys.device)
    if keys.dtype != torch.int32:
        valid = valid & (keys >= 0) & (keys < rng)
        keys = keys.clamp(0, max(rng - 1, 0)).to(torch.int32)
    keys = keys.contiguous()
    valid = valid.to(torch.bool).contiguous()
    words = [w.to(torch.int32).contiguous() for w in words]
    n, P = keys.shape[0], len(recipe)

    def carry():
        return torch.zeros((gh, P, _GL), dtype=torch.int64,
                           device=keys.device)

    _check_into(carry(), keys, valid, words, recipe, rng)
    acc = None
    for s in range(0, max(n, 1), _I32_EXACT_ROWS):
        e = min(s + _I32_EXACT_ROWS, n)
        part = carry()
        route(part, keys[s:e], valid[s:e], [w[s:e] for w in words], recipe,
              rng)
        part = part.to(torch.int32)
        acc = part if acc is None else acc + part
    return acc


# ---------------------------------------------------------------------------
# digitization
# ---------------------------------------------------------------------------


def _float_words(v: torch.Tensor, ok: torch.Tensor, fixed_s=None):
    """Balanced base-256 digitization of round(v * 2^s), as int32 word
    columns + recipe entries (f64_chunks() planes).

    s scales the batch max to 8*nch-2 bits. Returns (words, entries, s,
    bad): bad is True when any contributing value is non-finite, or — with
    a caller-fixed scale — overflows its headroom."""
    nch = f64_chunks()
    cap_bits = float(CHUNK_BITS * nch - 2)
    finite = torch.isfinite(v)
    bad = (ok & ~finite).any()
    v = torch.where(ok & finite, v, torch.zeros_like(v)).to(torch.float64)
    absv = v.abs()
    if fixed_s is None:
        maxv = absv.max()
        exp = torch.floor(torch.log2(maxv.clamp(min=1e-300))) + 1.0
        # clamp so exp2(s) stays finite when the batch max is 0/denormal
        s = (cap_bits - exp).clamp(max=1000.0)
        scale = torch.exp2(s)
    else:
        s = float(fixed_s)
        scale = 2.0 ** s
        # overflow must be tested in the FLOAT domain, before the cast: an
        # out-of-range f64->i64 conversion is undefined (and differs
        # between the CPU and CUDA)
        bad = bad | (ok & (absv > 2.0 ** (cap_bits - s))).any()
    scaled = torch.round(v * scale).to(torch.int64)
    u = scaled + _bias_f(nch)     # non-negative, < 2^56
    words = [_i32_bits(u), (u >> 32).to(torch.int32)]
    entries = ([("digit", 0, sh) for sh in (0, 8, 16, 24)[:min(nch, 4)]]
               + [("digit", 1, sh) for sh in (0, 8, 16, 24)[:nch - 4]])
    return words, entries, s, bad


def _int_words(v: torch.Tensor):
    """Balanced base-256 digitization of an int64, as int32 word columns +
    recipe entries (8 planes). Exact for |v| < 2^62; grouped sums come out
    exact modulo 2^64."""
    u = v.to(torch.int64) + _BIAS8          # wraps like the uint64 add
    words = [_i32_bits(u), _i32_bits(u >> 32)]
    entries = [("digit", 0, 0), ("digit", 0, 8), ("digit", 0, 16),
               ("digit", 0, 24), ("digit", 1, 0), ("digit", 1, 8),
               ("digit", 1, 16), ("digit", 1, 24)]
    return words, entries


def digitize(valid: torch.Tensor, specs, fixed_scales=None):
    """Digitize a batch's aggregate inputs into int32 word columns plus a
    static per-plane extraction recipe.

    Each spec is ("sum", values, value_valid) or ("count", count_valid).
    Returns (words, recipe, layout, weights, bad):
      * words — list of (n,) int32 columns
      * recipe — per plane: ("digit", word_idx, shift) | ("raw", wi, 0)
      * layout — per spec: ("sumf"|"sumi"|"count", start_plane)
      * weights — (P,) f64 per-plane carry weight: 2^-s for float-sum
        planes of a per-batch scale, 1.0 otherwise (all 1.0 with
        fixed_scales — pass the scales to finalize instead)
      * bad — 0-d bool: a contributing float was non-finite or overflowed
        a fixed scale (the caller must discard the batch)

    fixed_scales: optional dict {spec_index: static scale} for float sums.
    """
    dev = valid.device
    words: List[torch.Tensor] = []
    recipe: List[Tuple[str, int, int]] = []
    layout = []
    weights = []
    bad = torch.zeros((), dtype=torch.bool, device=dev)
    one = torch.ones((), dtype=torch.float64, device=dev)
    for si, spec in enumerate(specs):
        if spec[0] == "count":
            _, cvalid = spec
            words.append((valid & cvalid).to(torch.int32))
            recipe.append(("raw", len(words) - 1, 0))
            weights.append(one)
            layout.append(("count", len(recipe) - 1))
            continue
        _, values, vvalid = spec
        ok = valid & vvalid
        start = len(recipe)
        if values.dtype.is_floating_point:
            fs = None if fixed_scales is None else fixed_scales.get(si)
            ws, entries, s, b = _float_words(values, ok, fixed_s=fs)
            bad = bad | b
            weights.extend([one if fs is not None else torch.exp2(-s)]
                           * len(entries))
            layout.append(("sumf", start))
        else:
            # masked rows digitize as v=0, whose balanced digits are all
            # zero (the bias byte is exactly 0x80)
            v = torch.where(ok, values.to(torch.int64),
                            torch.zeros((), dtype=torch.int64, device=dev))
            ws, entries = _int_words(v)
            weights.extend([one] * len(entries))
            layout.append(("sumi", start))
        base = len(words)
        words.extend(ws)
        recipe.extend([(kind, base + wi, sh) for kind, wi, sh in entries])
    return words, tuple(recipe), layout, torch.stack(weights), bad


# ---------------------------------------------------------------------------
# accumulate / finalize
# ---------------------------------------------------------------------------


def accumulate(keys, valid, words, recipe, rng: int) -> torch.Tensor:
    """One batch's digit-plane accumulation: (gh, P, GL) f64."""
    gh = (rng + _GL - 1) // _GL
    return _accumulate_planes(keys, valid, words, recipe, gh,
                              rng).to(torch.float64)


def accumulate_raw(keys, valid, words, recipe, rng: int) -> torch.Tensor:
    """One batch's digit-plane accumulation as RAW (gh, P, GL) int32 —
    for callers carrying exact integer plane sums across batches."""
    gh = (rng + _GL - 1) // _GL
    return _accumulate_planes(keys, valid, words, recipe, gh, rng)


def _recombine(acc_gpl: torch.Tensor, start: int, nch: int) -> torch.Tensor:
    """f64 digit recombination, descending power first (keeps partial
    coefficients < 2^53 whenever the total is)."""
    gh = acc_gpl.shape[0]
    total = torch.zeros((gh, _GL), dtype=torch.float64, device=acc_gpl.device)
    for c in range(nch - 1, -1, -1):
        total = total + acc_gpl[:, start + c, :] * float(
            2 ** (CHUNK_BITS * c))
    return total


def _plane_i64(plane: torch.Tensor) -> torch.Tensor:
    if plane.dtype.is_floating_point:
        plane = torch.round(plane)
    return plane.to(torch.int64)


def finalize(acc: torch.Tensor, layout, rng: int, scales=None):
    """Recombine a (weighted-summed) plane carrier into per-spec outputs:
    f64 for float sums, int64 for int sums and counts.

    scales: optional dict {spec_index: static scale s} for fixed-scale
    float sums: the 2^-s deferred from the per-batch weights is applied
    here, once per stage. Int sums recombine in int64 arithmetic, exact
    modulo 2^64 (Spark long-sum overflow wraps)."""
    gh = acc.shape[0]
    outs = []
    for si, (kind, start) in enumerate(layout):
        if kind == "count":
            plane = acc[:, start, :].reshape(gh * _GL)[:rng]
            outs.append(_plane_i64(plane))
            continue
        if kind == "sumf":
            flat = _recombine(acc.to(torch.float64), start, f64_chunks()
                              ).reshape(gh * _GL)[:rng]
            if scales is not None and si in scales:
                flat = flat * torch.exp2(torch.tensor(
                    -float(scales[si]), dtype=torch.float64,
                    device=flat.device))
            outs.append(flat)
            continue
        total = torch.zeros((gh, _GL), dtype=torch.int64, device=acc.device)
        for c in range(I64_CHUNKS - 1, -1, -1):
            total = total + (_plane_i64(acc[:, start + c, :])
                             << (CHUNK_BITS * c))
        outs.append(total.reshape(gh * _GL)[:rng])
    return outs


def grouped_multi(keys, valid, specs, rng: int):
    """Compute several grouped aggregates in one accumulate pass.

    Returns (outs, bad): outs aligned with specs (f64/int64 (rng,)
    tensors); bad True when any contributing float value was non-finite —
    those rows contributed 0, so the caller MUST discard the result."""
    words, recipe, layout, weights, bad = digitize(valid, specs)
    acc = accumulate(keys, valid, words, recipe, rng)
    acc = acc * weights[None, :, None]
    return finalize(acc, layout, rng), bad


def grouped_sum(keys, values, valid, rng: int) -> torch.Tensor:
    """Per-key sums over keys in [0, rng). f64 or int64 (rng,)."""
    outs, _ = grouped_multi(keys, valid,
                            [("sum", values, torch.ones_like(valid))], rng)
    return outs[0]


def grouped_count(keys, valid, rng: int) -> torch.Tensor:
    """Per-key counts of valid rows (exact). int64 (rng,)."""
    outs, _ = grouped_multi(keys, torch.ones_like(valid),
                            [("count", valid)], rng)
    return outs[0]
