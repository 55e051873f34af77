"""Bit-exact Spark Murmur3 (x86_32): the partitioning and hash-agg hash.

Port of blaze_tpu/exprs/hash.py (ref: datafusion-ext-commons
spark_hash.rs:27-90, itself a port of Spark's Murmur3_x86_32, and the
shuffle partition id hash(seed=42) then pmod, datafusion-ext-plans
shuffle/mod.rs:94-119). Semantics:

  * int8/16/32/date, and boolean (as 1/0): hashInt(v), sign-extended
  * int64/timestamp/decimal(p<=18 unscaled): hashLong(v), two 32-bit halves
  * float32: hashInt(floatToIntBits(f)); float64: hashLong(doubleToLongBits
    (d)); -0.0 hashes as 0.0 and every NaN as the canonical NaN
  * null and padding rows keep the running hash (multi-column hashes chain
    their seeds)

Uint32 arithmetic: CUDA has no usable uint32 multiply in torch, so every
value is held in int64 within [0, 2^32). A product of two such values can
pass 2^63 and wrap; its low 32 bits, kept by `& 0xFFFFFFFF`, are still the
uint32 product. Right shifts act on masked (non-negative) values, so they
are logical.

The JAX package hashes doubles through columnar/bits64.py, which gets
Spark's bits only on its CPU backend (the TPU has no 64-bit bitcast); here
`Tensor.view(torch.int64)` gives them on every device. The JAX package
does not canonicalise float32 NaN payloads; Spark's floatToIntBits does,
and so does this module.

  * string/binary (plain or dictionary): hashUnsafeBytes over the bytes
    up to the row's length, the 0-3 tail bytes mixed one at a time as
    SIGNED bytes

  * decimal(p>18) (two limb planes): hashUnsafeBytes over the minimal
    big-endian two's-complement bytes of the unscaled value (Java's
    BigInteger.toByteArray), as JVM Spark hashes such a decimal
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

from blaze_tpu_torch.columnar.batch import Column, StringData
from blaze_tpu_torch.columnar.types import TypeKind

SPARK_SHUFFLE_SEED = 42

_M32 = 0xFFFFFFFF
_C1 = 0xCC9E2D51
_C2 = 0x1B873593
_M5 = 0xE6546B64

Seed = Union[int, torch.Tensor]


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def _mix_k1(k1: torch.Tensor) -> torch.Tensor:
    k1 = (k1 * _C1) & _M32
    k1 = _rotl(k1, 15)
    return (k1 * _C2) & _M32


def _mix_h1(h1: Seed, k1: torch.Tensor) -> torch.Tensor:
    h1 = _rotl(h1 ^ k1, 13)
    return (h1 * 5 + _M5) & _M32


def _fmix(h1: torch.Tensor, length: Seed) -> torch.Tensor:
    h1 = h1 ^ length
    h1 = h1 ^ (h1 >> 16)
    h1 = (h1 * 0x85EBCA6B) & _M32
    h1 = h1 ^ (h1 >> 13)
    h1 = (h1 * 0xC2B2AE35) & _M32
    return h1 ^ (h1 >> 16)


def u32(v: torch.Tensor) -> torch.Tensor:
    """The uint32 bit pattern of an int32-valued tensor, in int64."""
    return v.to(torch.int64) & _M32


def hash_int32(v: torch.Tensor, seed: Seed) -> torch.Tensor:
    """Spark hashInt of int32 values (sign-extended for narrower types).
    Returns uint32 values held in int64."""
    return _fmix(_mix_h1(seed, _mix_k1(u32(v))), 4)


def i64_halves(x: torch.Tensor):
    """(high, low) uint32 words of an int64, held in int64."""
    x = x.to(torch.int64)
    return (x >> 32) & _M32, x & _M32


def hash_int64(v: torch.Tensor, seed: Seed) -> torch.Tensor:
    high, low = i64_halves(v)
    return hash_u32_halves(high, low, seed)


def hash_u32_halves(high: torch.Tensor, low: torch.Tensor,
                    seed: Seed) -> torch.Tensor:
    """hashLong over pre-split 64-bit words (low mixed first, like Spark)."""
    h1 = _mix_h1(seed, _mix_k1(low))
    h1 = _mix_h1(h1, _mix_k1(high))
    return _fmix(h1, 8)


def hash_bytes(s: StringData, seed: Seed) -> torch.Tensor:
    """Spark hashUnsafeBytes over the fixed-width matrix, masked by length.
    Returns uint32 values held in int64."""
    cap, w = s.bytes.shape
    b = s.bytes.reshape(cap, w // 4, 4).to(torch.int64)
    words = b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16) | (b[..., 3] << 24)
    lens = s.lengths.to(torch.int64)
    nfull = lens // 4  # full 4-byte words
    h = torch.as_tensor(seed, dtype=torch.int64,
                        device=s.bytes.device).expand(cap)
    for j in range(w // 4):
        h = torch.where(j < nfull, _mix_h1(h, _mix_k1(words[:, j])), h)
    # tail: the remaining 0-3 bytes, each as a SIGNED byte
    aligned = nfull * 4
    for t in range(3):
        pos = aligned + t
        byte = torch.gather(s.bytes, 1, pos.clamp(0, w - 1)[:, None])[:, 0]
        sbyte = u32(byte.view(torch.int8))
        h = torch.where(pos < lens, _mix_h1(h, _mix_k1(sbyte)), h)
    return _fmix(h, lens)


def _canonical_float(x: torch.Tensor) -> torch.Tensor:
    """-0.0 -> 0.0 and every NaN -> the canonical NaN (floatToIntBits /
    doubleToLongBits)."""
    x = torch.where(x == 0, torch.zeros_like(x), x)
    return torch.where(torch.isnan(x), torch.full_like(x, float("nan")), x)


def _hash_wide_decimal(col: Column, seed: Seed) -> torch.Tensor:
    """Spark's hash of a decimal with precision > 18: murmur3 over the
    MINIMAL big-endian two's-complement bytes of the unscaled BigInteger
    (leading sign-filler bytes stripped while one sign bit stays), built
    as a (cap, 16) byte matrix and a length per row for `hash_bytes`."""
    hi, lo = (ch.data for ch in col.data.children)
    # the big-endian 16 bytes
    shifts = torch.arange(56, -8, -8, device=hi.device)
    be = torch.cat([(w[:, None] >> shifts) & 0xFF for w in (hi, lo)],
                   dim=1).to(torch.uint8)
    filler = torch.where(hi < 0, 0xFF, 0).to(torch.uint8)
    # a leading byte drops while it is the filler AND the next byte's
    # sign bit matches, so the bytes kept still encode the sign
    nxt = torch.cat([be[:, 1:], be[:, -1:]], dim=1)
    droppable = (be == filler[:, None]) & (
        (nxt >> 7) == (filler[:, None] >> 7))
    # the length of the leading run of droppable bytes, at most 15
    run = torch.cumprod(droppable.to(torch.int32), dim=1)
    strip = run.sum(dim=1).clamp(max=15)
    idx = (torch.arange(16, device=hi.device)[None, :]
           + strip[:, None]).clamp(max=15)
    aligned = torch.gather(be, 1, idx)
    return hash_bytes(StringData(aligned, (16 - strip).to(torch.int32)),
                      seed)


def hash_column(col: Column, seed: Seed,
                row_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Chainable per-column hash: null (or padding) rows keep `seed`."""
    k = col.dtype.kind
    cap = col.capacity
    if col.is_string:
        h = hash_bytes(col.data, seed)
    elif col.dtype.wide_decimal:
        h = _hash_wide_decimal(col, seed)
    elif k in (TypeKind.INT8, TypeKind.INT16, TypeKind.INT32, TypeKind.DATE,
             TypeKind.BOOLEAN):
        h = hash_int32(col.data.to(torch.int32), seed)
    elif k in (TypeKind.INT64, TypeKind.TIMESTAMP, TypeKind.DECIMAL):
        h = hash_int64(col.data, seed)
    elif k == TypeKind.FLOAT32:
        h = hash_int32(_canonical_float(col.data).view(torch.int32), seed)
    elif k == TypeKind.FLOAT64:
        h = hash_int64(_canonical_float(col.data).view(torch.int64), seed)
    elif k == TypeKind.NULL:
        h = None
    else:
        raise TypeError(f"hash of {col.dtype} not supported")
    seed_t = torch.as_tensor(seed, dtype=torch.int64,
                             device=col.device).expand(cap)
    if h is None:
        return seed_t.clone()
    valid = col.valid_mask()
    if row_mask is not None:
        valid = valid & row_mask
    return torch.where(valid, h, seed_t)


def hash_columns(cols: Sequence[Column], seed: int = SPARK_SHUFFLE_SEED,
                 row_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Multi-column Spark hash h = hash_col_n(...hash_col_1(seed)), as the
    int32 Spark returns."""
    h: Seed = seed
    for c in cols:
        h = hash_column(c, h, row_mask)
    return torch.where(h >= (1 << 31), h - (1 << 32), h).to(torch.int32)


def pmod(hash_i32: torch.Tensor, num_partitions: int) -> torch.Tensor:
    """Spark's non-negative modulo: partition ids in [0, P). torch.remainder
    floors like jnp's `%`; torch.fmod truncates and would give negative
    ids."""
    return torch.remainder(hash_i32, num_partitions).to(torch.int32)
