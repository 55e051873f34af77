"""128-bit signed integer limb arithmetic for wide decimals (p > 18).

Port of blaze_tpu/columnar/int128.py (ref: the reference's Decimal128
type algebra; arrow-rs stores the unscaled value as a 128-bit
little-endian integer). A wide decimal column is two int64 planes: `hi`
(signed, carries the sign) and `lo` (the low 64 bits, read as UNSIGNED),
so value = hi * 2^64 + u64(lo). Every kernel is elementwise torch on those
planes, on the planes' device.

The arithmetic relies on what torch int64 does alike on the CPU and on
CUDA: products and sums wrap mod 2^64, `>>` is arithmetic (a logical shift
is `>>` then a mask), and unsigned order is `x ^ INT64_MIN` in signed
order. torch.uint64 lacks most arithmetic on CUDA and is not used. Shift
counts stay in [0, 63]: a shift by 64 or more differs between the CPU and
CUDA. Constants beyond int64 (10^19 .. 10^38) are split into signed
(hi, lo) Python ints on the host (`_pow10_128`) and never become tensors
whole.
"""

from __future__ import annotations

from typing import List, Tuple, Union

import torch

Planes = Tuple[torch.Tensor, torch.Tensor]
IntOrTensor = Union[int, torch.Tensor]

_I64_MIN = -(1 << 63)
_MASK32 = 0xFFFFFFFF


def _signed(v: int) -> int:
    """The low 64 bits of a Python int as a signed int64 value."""
    v &= (1 << 64) - 1
    return v - (1 << 64) if v >= (1 << 63) else v


def _u_lt(a: IntOrTensor, b: IntOrTensor) -> torch.Tensor:
    """unsigned(a) < unsigned(b) on int64 planes (one side may be a
    signed-int64 Python int)."""
    return (a ^ _I64_MIN) < (b ^ _I64_MIN)


def _i64(b: torch.Tensor) -> torch.Tensor:
    return b.to(torch.int64)


def from_i64(x: torch.Tensor) -> Planes:
    """Sign-extend an int64 to 128 bits."""
    x = x.to(torch.int64)
    return x >> 63, x


def add(ah, al, bh, bl) -> Planes:
    lo = al + bl
    return ah + bh + _i64(_u_lt(lo, al)), lo


def neg(h: torch.Tensor, l: torch.Tensor) -> Planes:
    return ~h + _i64(l == 0), -l


def sub(ah, al, bh, bl) -> Planes:
    nh, nl = neg(bh, bl)
    return add(ah, al, nh, nl)


def is_neg(h: torch.Tensor, l: torch.Tensor) -> torch.Tensor:
    return h < 0


def abs_(h: torch.Tensor, l: torch.Tensor) -> Planes:
    nh, nl = neg(h, l)
    n = h < 0
    return torch.where(n, nh, h), torch.where(n, nl, l)


def cmp(ah, al, bh, bl) -> torch.Tensor:
    """-1 / 0 / +1 as int32 (signed 128-bit order)."""
    same = ah == bh
    lt = (ah < bh) | (same & _u_lt(al, bl))
    gt = (ah > bh) | (same & _u_lt(bl, al))
    return gt.to(torch.int32) - lt.to(torch.int32)


def eq(ah, al, bh, bl) -> torch.Tensor:
    return (ah == bh) & (al == bl)


def _mul_u64(a: torch.Tensor, b: IntOrTensor) -> Planes:
    """Full 64x64 -> 128 product of UNSIGNED operands (int64 planes; `b`
    may be a non-negative Python int below 2^63)."""
    a0 = a & _MASK32
    a1 = (a >> 32) & _MASK32
    b0, b1 = b & _MASK32, (b >> 32) & _MASK32
    p00 = a0 * b0                     # < 2^64, exact under the u64 wrap
    p01 = a0 * b1
    p10 = a1 * b0
    p11 = a1 * b1
    # logical high halves: an arithmetic >> then the mask
    mid = ((p00 >> 32) & _MASK32) + (p01 & _MASK32) + (p10 & _MASK32)
    lo = (p00 & _MASK32) | ((mid & _MASK32) << 32)
    hi = (p11 + ((p01 >> 32) & _MASK32) + ((p10 >> 32) & _MASK32)
          + (mid >> 32))
    return hi, lo


def _abs64(a: torch.Tensor) -> torch.Tensor:
    """|a| with INT64_MIN wrapping to itself (read as unsigned below), as
    jnp.abs does."""
    return torch.where(a < 0, -a, a)


def mul_i64(a: torch.Tensor, b: torch.Tensor) -> Planes:
    """Signed 64x64 -> exact 128-bit product."""
    sign = (a < 0) ^ (b < 0)
    h, l = _mul_u64(_abs64(a), _abs64(b))
    nh, nl = neg(h, l)
    return torch.where(sign, nh, h), torch.where(sign, nl, l)


def mul_small(h: torch.Tensor, l: torch.Tensor, m: int) -> Planes:
    """(h, l) * m for a small positive Python int (< 2^62): schoolbook on
    the magnitude, the sign reapplied."""
    assert 0 < m < (1 << 62)
    sign = h < 0
    ah, al = abs_(h, l)
    mh, ml = _mul_u64(al, m)
    hi = mh + ah * m
    nh, nl = neg(hi, ml)
    return torch.where(sign, nh, hi), torch.where(sign, nl, ml)


def divmod_small(h: torch.Tensor, l: torch.Tensor, d: IntOrTensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Magnitude divmod by a small positive divisor (< 2^31): (qh, ql,
    rem) of |value|; the caller handles sign and rounding. Long division
    over four 32-bit limbs. `d` is a Python int or an int64 tensor of
    per-row divisors, whose < 2^31 bound is the caller's contract."""
    if isinstance(d, int):
        assert 0 < d < (1 << 31)
    ah, al = abs_(h, l)
    limbs = [(ah >> 32) & _MASK32, ah & _MASK32,
             (al >> 32) & _MASK32, al & _MASK32]
    q: List[torch.Tensor] = []
    rem = torch.zeros_like(ah)
    for limb in limbs:
        cur = (rem << 32) | limb      # < d * 2^32 <= 2^63: fits signed
        q.append(cur // d)
        rem = cur % d
    return (q[0] << 32) | q[1], (q[2] << 32) | q[3], rem


def _uge(xh, xl, yh, yl) -> torch.Tensor:
    """unsigned 128-bit x >= y."""
    return ~(_u_lt(xh, yh) | ((xh == yh) & _u_lt(xl, yl)))


def divmod_full(h: torch.Tensor, l: torch.Tensor, dh: torch.Tensor,
                dl: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           torch.Tensor]:
    """Full 128/128 magnitude divmod: (qh, ql, rh, rl) of |a| divmod |d|.

    Bit-serial restoring long division: 128 steps of shift, compare and
    subtract over the two limb planes, branch-free per row. The JAX
    package runs them as one `lax.fori_loop`; here each step is a handful
    of eager elementwise ops, and the step's bit position is a Python int.
    The caller handles signs and rounding. d == 0 gives q = all ones (the
    caller nulls those rows: Spark's divide by zero is null). Exact for
    |a|, |d| < 2^127 (decimals are < 10^38 < 2^127)."""
    ah, al = abs_(h, l)
    bh, bl = abs_(dh, dl)
    z = torch.zeros_like(ah)
    qh, ql, rh, rl = z, z, z, z
    for idx in range(127, -1, -1):
        if idx >= 64:
            bit = (ah >> (idx - 64)) & 1
        else:
            bit = (al >> idx) & 1
        rh = (rh << 1) | ((rl >> 63) & 1)
        rl = (rl << 1) | bit
        g = _uge(rh, rl, bh, bl)
        sh, sl = sub(rh, rl, bh, bl)
        rh = torch.where(g, sh, rh)
        rl = torch.where(g, sl, rl)
        if idx >= 64:
            qh = qh | (_i64(g) << (idx - 64))
        else:
            ql = ql | (_i64(g) << idx)
    return qh, ql, rh, rl


def rescale_checked(h: torch.Tensor, l: torch.Tensor, delta: int,
                    half_up: bool = True
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`rescale` plus a per-row ok flag: upscaling by 10^delta WRAPS mod
    2^128 when |v| >= 2^127 / 10^delta, and wrapped residues can alias
    back into valid ranges, so callers null (or saturate) rows with
    ok=False. Downscaling cannot overflow (ok all true)."""
    if delta > 0:
        # |v| < 10^(38-delta) guarantees |v * 10^delta| < 10^38 < 2^127
        ok = in_precision(h, l, max(38 - delta, 0))
    else:
        ok = torch.ones(h.shape, dtype=torch.bool, device=h.device)
    hh, ll = rescale(h, l, delta, half_up)
    return hh, ll, ok


def rescale(h: torch.Tensor, l: torch.Tensor, delta: int,
            half_up: bool = True) -> Planes:
    """Multiply by 10^delta (delta > 0) or divide by 10^-delta with HALF_UP
    rounding on the magnitude (Spark's decimal rescale)."""
    if delta == 0:
        return h, l
    if delta > 0:
        for step in _pow10_steps(delta):
            h, l = mul_small(h, l, step)
        return h, l
    sign = h < 0
    rh, rl = abs_(h, l)
    last_rem, last_div = None, 1
    for step in _pow10_steps(-delta):
        rh, rl, last_rem = divmod_small(rh, rl, step)
        last_div = step
    if half_up:
        bump = _i64(2 * last_rem >= last_div)
        rh, rl = add(rh, rl, torch.zeros_like(rh), bump)
    nh, nl = neg(rh, rl)
    return torch.where(sign, nh, rh), torch.where(sign, nl, rl)


def _pow10_steps(k: int) -> List[int]:
    """10^k as factors each < 2^31 (divmod_small's bound)."""
    out = []
    while k > 0:
        s = min(k, 9)
        out.append(10 ** s)
        k -= s
    return out


def to_i64_checked(h: torch.Tensor, l: torch.Tensor) -> Planes:
    """(value as int64, fits): fits where the 128-bit value is the sign
    extension of its low 64 bits."""
    return l, h == (l >> 63)


def in_precision(h: torch.Tensor, l: torch.Tensor, precision: int
                 ) -> torch.Tensor:
    """|value| < 10^precision (Spark's CheckOverflow bound), compared as
    unsigned 128-bit magnitudes (abs of the least 128-bit value wraps)."""
    bh, bl = _pow10_128(precision)
    ah, al = abs_(h, l)
    return _u_lt(ah, bh) | ((ah == bh) & _u_lt(al, bl))


def _pow10_128(k: int) -> Tuple[int, int]:
    """10^k as its (hi, lo) int64 words, each a signed Python int."""
    v = 10 ** k
    return _signed(v >> 64), _signed(v)


# -- host-side helpers (construction / extraction) -------------------------


def np_from_ints(values):
    """Python ints -> (hi, lo) numpy int64 planes."""
    import numpy as np

    hi = np.empty(len(values), np.int64)
    lo = np.empty(len(values), np.int64)
    for i, v in enumerate(values):
        v = int(v)
        lo[i] = _signed(v)
        hi[i] = _signed(v >> 64)
    return hi, lo


def ints_from_np(hi, lo) -> list:
    """(hi, lo) numpy planes -> Python ints."""
    out = []
    for h, l in zip(hi.tolist(), lo.tolist()):
        u = ((h & ((1 << 64) - 1)) << 64) | (l & ((1 << 64) - 1))
        out.append(u - (1 << 128) if u >= (1 << 127) else u)
    return out
