"""String kernels over fixed-width byte matrices, as torch ops.

Port of blaze_tpu/exprs/strings.py (ref: datafusion-ext-exprs
string_starts_with.rs / string_ends_with.rs / string_contains.rs and the
Spark string kernels of datafusion-ext-functions spark_strings.rs). Every
function works on (capacity, width) uint8 matrices with static widths, so
it is a handful of vectorised tensor ops on whatever device the column
lives on.

Conventions: bytes beyond a row's length are zero; lexicographic order
over zero-padded matrices with a length tiebreak equals byte-wise order
(zero is the least byte; a content byte equal to zero matters only when
every earlier byte ties, and then the length tiebreak decides).

Uint32 words live in int64 in [0, 2^32), as the port's hashing holds them
(CUDA torch has no uint32 arithmetic). Matching is byte-wise throughout:
`_` in LIKE and `substring` count bytes, not UTF-8 characters, as the JAX
package does.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from blaze_tpu_torch.columnar.batch import StringData, bucket_width


def _gather(b: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """`jnp.take_along_axis(b, idx, axis=1)`."""
    return torch.gather(b, 1, idx.long())


def _arange(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=like.device)


def _masked(s_bytes: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.where(mask, s_bytes, torch.zeros_like(s_bytes))


def ensure_width(s: StringData, width: int) -> StringData:
    """Pad (never truncate) the byte matrix to `width` columns."""
    if s.width == width:
        return s
    if s.width > width:
        raise ValueError("ensure_width cannot shrink")
    pad = torch.zeros((s.capacity, width - s.width), dtype=torch.uint8,
                      device=s.bytes.device)
    return StringData(torch.cat([s.bytes, pad], dim=1), s.lengths)


def common_width(a: StringData, b: StringData
                 ) -> Tuple[StringData, StringData]:
    w = max(a.width, b.width)
    return ensure_width(a, w), ensure_width(b, w)


def pack_words_be(s: StringData) -> torch.Tensor:
    """(cap, W) uint8 -> (cap, W//4) big-endian uint32 words in int64.

    Unsigned big-endian word order preserves byte-wise lexicographic
    order, so the words serve directly as sort, join and group keys."""
    cap, w = s.bytes.shape
    assert w % 4 == 0, "string width must be a multiple of 4"
    b = s.bytes.reshape(cap, w // 4, 4).to(torch.int64)
    return (b[..., 0] << 24) | (b[..., 1] << 16) | (b[..., 2] << 8) | b[..., 3]


def compare(a: StringData, b: StringData
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-wise (lt, eq) byte-wise comparison."""
    a, b = common_width(a, b)
    wa, wb = pack_words_be(a), pack_words_be(b)
    lt = a.lengths < b.lengths
    eq = a.lengths == b.lengths
    # fold from the last word to the first: the first differing word decides
    for j in range(wa.shape[1] - 1, -1, -1):
        wlt = wa[:, j] < wb[:, j]
        weq = wa[:, j] == wb[:, j]
        lt = torch.where(weq, lt, wlt)
        eq = weq & eq
    return lt, eq


def equals(a: StringData, b: StringData) -> torch.Tensor:
    a, b = common_width(a, b)
    return (a.bytes == b.bytes).all(dim=1) & (a.lengths == b.lengths)


def _pattern_array(pattern: bytes, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(np.frombuffer(pattern, np.uint8).copy()).to(
        like.device)


def _const(s: StringData, value: bool) -> torch.Tensor:
    return torch.full((s.capacity,), value, dtype=torch.bool,
                      device=s.bytes.device)


def starts_with(s: StringData, pattern: bytes) -> torch.Tensor:
    p = len(pattern)
    if p == 0:
        return _const(s, True)
    if p > s.width:
        return _const(s, False)
    pat = _pattern_array(pattern, s.bytes)
    return (s.bytes[:, :p] == pat[None, :]).all(dim=1) & (s.lengths >= p)


def ends_with(s: StringData, pattern: bytes) -> torch.Tensor:
    p = len(pattern)
    if p == 0:
        return _const(s, True)
    if p > s.width:
        return _const(s, False)
    start = (s.lengths - p).clamp(min=0)
    acc = s.lengths >= p
    for t, byte in enumerate(pattern):
        got = _gather(s.bytes, (start + t).clamp(0, s.width - 1)[:, None])
        acc = acc & (got[:, 0] == byte)
    return acc


def match_positions(s: StringData, pattern: bytes) -> torch.Tensor:
    """(cap, W-P+1) bool: the pattern matches at shift j (ignoring length)."""
    p = len(pattern)
    nshift = s.width - p + 1
    acc = torch.ones((s.capacity, nshift), dtype=torch.bool,
                     device=s.bytes.device)
    for t, byte in enumerate(pattern):
        acc = acc & (s.bytes[:, t:t + nshift] == byte)
    return acc


def _matches_in_length(s: StringData, pattern: bytes) -> torch.Tensor:
    pos = match_positions(s, pattern)
    shifts = _arange(pos.shape[1], s.bytes)
    return pos & (shifts[None, :] + len(pattern) <= s.lengths[:, None])


def contains(s: StringData, pattern: bytes) -> torch.Tensor:
    p = len(pattern)
    if p == 0:
        return _const(s, True)
    if p > s.width:
        return _const(s, False)
    return _matches_in_length(s, pattern).any(dim=1)


def _like_tokens(pattern: bytes, escape: bytes):
    """(kind, byte) tokens: kind 0 a literal byte, 1 `_`, 2 `%`."""
    esc = escape[0] if escape else 0x5C
    tokens = []
    i = 0
    while i < len(pattern):
        c = pattern[i]
        if c == esc and i + 1 < len(pattern):
            tokens.append((0, pattern[i + 1]))
            i += 2
            continue
        if c == 0x25:
            tokens.append((2, 0))
        elif c == 0x5F:
            tokens.append((1, 0))
        else:
            tokens.append((0, c))
        i += 1
    return tokens


def like_match(s: StringData, pattern: bytes,
               escape: bytes = b"\\") -> torch.Tensor:
    """SQL LIKE by a vectorised NFA over pattern positions.

    `reach[:, j]` = "the first i bytes can match the first j tokens". The
    byte loop runs over the static width, the token loop is unrolled
    (patterns are short). `_` matches one byte."""
    tokens = _like_tokens(pattern, escape)
    P = len(tokens)
    cap = s.capacity
    dev = s.bytes.device

    def closure(cols):
        # epsilon moves over `%` tokens
        out = [cols[0]]
        for j in range(1, P + 1):
            r = cols[j]
            if tokens[j - 1][0] == 2:
                r = r | out[j - 1]
            out.append(r)
        return out

    false = torch.zeros((cap,), dtype=torch.bool, device=dev)
    reach = closure([torch.ones_like(false)] + [false] * P)
    for pos in range(s.width):
        c = s.bytes[:, pos]
        in_range = pos < s.lengths
        nxt = [false]
        for j in range(1, P + 1):
            kind, tb = tokens[j - 1]
            if kind == 0:
                r = reach[j - 1] & (c == tb)
            elif kind == 1:
                r = reach[j - 1]
            else:  # `%` consumes this byte; the closure handles skipping
                r = reach[j]
            nxt.append(r)
        stepped = closure(nxt)
        reach = [torch.where(in_range, a, b) for a, b in zip(stepped, reach)]
    return reach[P]


def upper_ascii(s: StringData) -> StringData:
    b = s.bytes
    is_lower = (b >= 0x61) & (b <= 0x7A)
    return StringData(torch.where(is_lower, b - 32, b), s.lengths)


def lower_ascii(s: StringData) -> StringData:
    b = s.bytes
    is_upper = (b >= 0x41) & (b <= 0x5A)
    return StringData(torch.where(is_upper, b + 32, b), s.lengths)


def char_length(s: StringData) -> torch.Tensor:
    """UTF-8 character count = bytes that are not continuation bytes."""
    pos = _arange(s.width, s.bytes)
    in_len = pos[None, :] < s.lengths[:, None]
    is_cont = (s.bytes & 0xC0) == 0x80
    return (in_len & ~is_cont).sum(dim=1, dtype=torch.int32)


def octet_length(s: StringData) -> torch.Tensor:
    return s.lengths


def substring(s: StringData, start: torch.Tensor,
              length: torch.Tensor) -> StringData:
    """1-based SQL substring over BYTES.

    `start` may be negative (counted from the end, SQL semantics). The
    output keeps the input width (lengths shrink)."""
    slen = s.lengths
    zero = torch.zeros_like(slen)
    start = start.to(torch.int32)
    start0 = torch.where(start > 0, start - 1,
                         torch.where(start < 0,
                                     torch.maximum(slen + start, zero),
                                     zero))
    start0 = torch.minimum(start0, slen)
    out_len = torch.minimum(length.to(torch.int32), slen - start0).clamp(
        0, s.width)
    j = _arange(s.width, s.bytes)
    src = (start0[:, None] + j[None, :]).clamp(0, s.width - 1)
    mask = j[None, :] < out_len[:, None]
    return StringData(_masked(_gather(s.bytes, src), mask), out_len)


def concat(parts: list) -> StringData:
    """Concatenate StringData columns row-wise; the output width is the
    bucketed sum of the widths."""
    total_w = bucket_width(sum(p.width for p in parts))
    cap = parts[0].capacity
    dev = parts[0].bytes.device
    out_len = torch.zeros((cap,), dtype=torch.int32, device=dev)
    for p in parts:
        out_len = out_len + p.lengths
    j = _arange(total_w, parts[0].bytes)
    result = torch.zeros((cap, total_w), dtype=torch.uint8, device=dev)
    offset = torch.zeros((cap,), dtype=torch.int32, device=dev)
    for p in parts:
        # out[i, offset[i] + k] = p[i, k]
        rel = j[None, :] - offset[:, None]
        in_part = (rel >= 0) & (rel < p.lengths[:, None])
        gathered = _gather(p.bytes, rel.clamp(0, p.width - 1))
        result = torch.where(in_part, gathered, result)
        offset = offset + p.lengths
    return StringData(result, out_len)


def repeat(s: StringData, n: int) -> StringData:
    if n >= 1:
        return concat([s] * n)
    return StringData(torch.zeros_like(s.bytes), torch.zeros_like(s.lengths))


def reverse(s: StringData) -> StringData:
    """Reverse the bytes of each row (character-exact for ASCII only; the
    string kernels are byte-level throughout)."""
    j = _arange(s.width, s.bytes)
    src = (s.lengths[:, None] - 1 - j[None, :]).clamp(0, s.width - 1)
    mask = j[None, :] < s.lengths[:, None]
    return StringData(_masked(_gather(s.bytes, src), mask), s.lengths)


def initcap(s: StringData) -> StringData:
    """Uppercase the first letter of each whitespace-delimited word and
    lowercase the rest (ASCII)."""
    b = s.bytes
    is_ws = (b == 0x20) | ((b >= 0x09) & (b <= 0x0D))
    prev_ws = torch.cat([torch.ones((s.capacity, 1), dtype=torch.bool,
                                    device=b.device), is_ws[:, :-1]], dim=1)
    lo = torch.where((b >= 0x41) & (b <= 0x5A), b + 32, b)
    up = torch.where((lo >= 0x61) & (lo <= 0x7A), lo - 32, lo)
    return StringData(torch.where(prev_ws, up, lo), s.lengths)


def _pad(s: StringData, n: int, pad: bytes, left: bool) -> StringData:
    n = max(int(n), 0)
    if not pad:  # Spark: nothing to pad with -> the string cut to n
        return substring(s, torch.ones_like(s.lengths),
                         torch.full_like(s.lengths, n))
    w_out = bucket_width(max(n, 1))
    j = _arange(w_out, s.bytes)
    pat = _pattern_array(pad, s.bytes)
    if left:
        # byte j: pad[j % P] while j < npad, else input byte j - npad
        npad = (n - s.lengths).clamp(min=0)
        body = _gather(s.bytes, (j[None, :] - npad[:, None]).clamp(
            0, s.width - 1))
        out = torch.where(j[None, :] < npad[:, None],
                          pat[(j % len(pad)).long()][None, :], body)
    else:
        # byte j: input byte j while j < length, else pad[(j - len) % P]
        body = _gather(s.bytes, j.clamp(0, s.width - 1)[None, :].expand(
            s.capacity, w_out))
        rel = (j[None, :] - s.lengths[:, None]).clamp(min=0)
        out = torch.where(j[None, :] < s.lengths[:, None], body,
                          pat[(rel % len(pad)).long()])
    out_len = torch.full_like(s.lengths, n)  # pad or cut: always n
    mask = j[None, :] < out_len[:, None]
    return StringData(_masked(out, mask), out_len)


def lpad(s: StringData, n: int, pad: bytes) -> StringData:
    """Left-pad (cyclically) with `pad` to byte-length n; cut if longer.
    n and pad are plan-time literals (static output width)."""
    return _pad(s, n, pad, left=True)


def rpad(s: StringData, n: int, pad: bytes) -> StringData:
    """Right-pad (cyclically) with `pad` to byte-length n; cut if longer."""
    return _pad(s, n, pad, left=False)


def _first_true(m: torch.Tensor) -> torch.Tensor:
    """argmax of a bool matrix along dim 1: the first True, 0 if none."""
    return m.to(torch.uint8).argmax(dim=1).to(torch.int32)


def strpos(s: StringData, pattern: bytes) -> torch.Tensor:
    """1-based byte position of the first occurrence, 0 if absent (Spark
    instr/strpos). An empty pattern gives 1."""
    p = len(pattern)
    if p == 0:
        return torch.ones((s.capacity,), dtype=torch.int32,
                          device=s.bytes.device)
    if p > s.width:
        return torch.zeros((s.capacity,), dtype=torch.int32,
                           device=s.bytes.device)
    ok = _matches_in_length(s, pattern)
    return torch.where(ok.any(dim=1), _first_true(ok) + 1,
                       torch.zeros_like(s.lengths))


def greedy_matches(s: StringData, pattern: bytes):
    """Left-to-right non-overlapping matches of a literal pattern.

    Returns (emitted (cap, nshift) bool: a match chosen at shift j;
    inside (cap, W) bool: the byte lies within a chosen match;
    cum_em (cap, W) int32: chosen matches that start at or before j)."""
    p = len(pattern)
    cap = s.capacity
    dev = s.bytes.device
    if p == 0 or p > s.width:
        nshift = max(s.width - p + 1, 1)
        return (torch.zeros((cap, nshift), dtype=torch.bool, device=dev),
                torch.zeros((cap, s.width), dtype=torch.bool, device=dev),
                torch.zeros((cap, s.width), dtype=torch.int32, device=dev))
    ok = _matches_in_length(s, pattern)
    nshift = ok.shape[1]
    next_ok = torch.zeros((cap,), dtype=torch.int32, device=dev)
    em = []
    for j in range(nshift):
        emit = ok[:, j] & (j >= next_ok)
        next_ok = torch.where(emit, torch.full_like(next_ok, j + p), next_ok)
        em.append(emit)
    emitted = torch.stack(em, dim=1)
    em_w = torch.zeros((cap, s.width), dtype=torch.bool, device=dev)
    em_w[:, :nshift] = emitted
    inside = torch.zeros_like(em_w)
    for t in range(p):
        shifted = torch.roll(em_w, t, dims=1)
        if t:
            shifted[:, :t] = False
        inside = inside | shifted
    cum_em = torch.cumsum(em_w.to(torch.int32), dim=1, dtype=torch.int32)
    return emitted, inside, cum_em


def replace(s: StringData, search: bytes, rep: bytes) -> StringData:
    """Replace every (greedy, non-overlapping) occurrence of a literal.
    The output width bounds the worst-case growth: nothing is cut."""
    p, r = len(search), len(rep)
    if p == 0:  # Spark: an empty search leaves the string as it is
        return s
    cap = s.capacity
    dev = s.bytes.device
    emitted, inside, cum_em = greedy_matches(s, search)
    w_out = bucket_width(s.width + (s.width // p) * max(r - p, 0))
    j = _arange(s.width, s.bytes)
    # one spare column past w_out takes the dropped writes
    out = torch.zeros((cap, w_out + 1), dtype=torch.uint8, device=dev)
    keep = (j[None, :] < s.lengths[:, None]) & ~inside
    kept_idx = torch.where(keep, (j[None, :] + cum_em * (r - p)).clamp(
        0, w_out - 1), torch.full_like(cum_em, w_out))
    out.scatter_(1, kept_idx.long(), s.bytes)
    if r:
        nshift = emitted.shape[1]
        base = _arange(nshift, s.bytes)[None, :] + \
            (cum_em[:, :nshift] - 1) * (r - p)
        for t in range(r):
            idx = torch.where(emitted, (base + t).clamp(0, w_out - 1),
                              torch.full_like(base, w_out))
            out.scatter_(1, idx.long(), torch.full(
                (cap, nshift), rep[t], dtype=torch.uint8, device=dev))
    out = out[:, :w_out]
    nmatches = emitted.sum(dim=1, dtype=torch.int32)
    out_len = (s.lengths + nmatches * (r - p)).clamp(min=0)
    mask = _arange(w_out, s.bytes)[None, :] < out_len[:, None]
    return StringData(_masked(out, mask), out_len)


def split_part(s: StringData, delim: bytes, n: torch.Tensor
               ) -> Tuple[StringData, torch.Tensor]:
    """Spark split_part(str, delim, n): the n-th (1-based) piece; negative
    n counts from the end; out of range gives the empty string. Returns
    (result, defined), defined False where n == 0."""
    n = n.to(torch.int32)
    if len(delim) == 0 or len(delim) > s.width:
        # no splits: the one part is the whole string
        whole = (n == 1) | (n == -1)
        return StringData(
            _masked(s.bytes, whole[:, None]),
            torch.where(whole, s.lengths, torch.zeros_like(s.lengths))), n != 0
    _, inside, cum_em = greedy_matches(s, delim)
    j = _arange(s.width, s.bytes)
    in_len = j[None, :] < s.lengths[:, None]
    nparts = cum_em[:, -1] + 1
    eff = torch.where(n > 0, n - 1, nparts + n)  # 0-based part index
    keep = in_len & ~inside & (cum_em == eff[:, None])
    count = keep.sum(dim=1, dtype=torch.int32)
    res = substring(s, _first_true(keep) + 1, count)
    in_range = (eff >= 0) & (eff < nparts)
    return StringData(
        _masked(res.bytes, in_range[:, None]),
        torch.where(in_range, res.lengths, torch.zeros_like(res.lengths))), \
        n != 0


def translate(s: StringData, frm: bytes, to: bytes) -> StringData:
    """Spark translate: bytes of `frm` map to `to` by position; those past
    len(to) are deleted; the first occurrence in `frm` wins."""
    table = np.arange(256, dtype=np.uint8)
    delete = np.zeros(256, bool)
    seen = set()
    for i, c in enumerate(frm):
        if c in seen:
            continue
        seen.add(c)
        if i < len(to):
            table[c] = to[i]
        else:
            delete[c] = True
    dev = s.bytes.device
    idx = s.bytes.long()
    mapped = torch.from_numpy(table).to(dev)[idx]
    dele = torch.from_numpy(delete).to(dev)[idx]
    j = _arange(s.width, s.bytes)
    keep = (j[None, :] < s.lengths[:, None]) & ~dele
    # stable-compact the kept bytes to the front of each row
    order = torch.sort((~keep).to(torch.uint8), dim=1, stable=True).indices
    packed = torch.gather(mapped, 1, order)
    new_len = keep.sum(dim=1, dtype=torch.int32)
    mask = j[None, :] < new_len[:, None]
    return StringData(_masked(packed, mask), new_len)


def chr_fn(n: torch.Tensor, capacity: int) -> StringData:
    """Spark chr(bigint): the byte n % 256; negative gives empty."""
    w = bucket_width(4)
    x = n.to(torch.int64)
    neg = x < 0
    v = torch.remainder(x, 256).to(torch.uint8)
    mat = torch.zeros((capacity, w), dtype=torch.uint8, device=n.device)
    mat[:, 0] = torch.where(neg, torch.zeros_like(v), v)
    return StringData(mat, torch.where(neg, 0, 1).to(torch.int32))


def to_hex(n: torch.Tensor, capacity: int) -> StringData:
    """Spark hex(bigint): uppercase, no leading zeros; negatives print the
    full 16-digit two's complement (Java Long.toHexString)."""
    w = bucket_width(16)
    x = n.to(torch.int64)
    # an arithmetic shift then a 4-bit mask is the unsigned nibble
    nibbles = torch.stack([((x >> (4 * (15 - k))) & 0xF).to(torch.uint8)
                           for k in range(16)], dim=1)
    digit = torch.where(nibbles < 10, nibbles + 0x30, nibbles - 10 + 0x41)
    nz = nibbles != 0
    lead = torch.where(nz.any(dim=1), _first_true(nz),
                       torch.full((capacity,), 15, dtype=torch.int32,
                                  device=n.device))
    out_len = (16 - lead).to(torch.int32)
    j = _arange(w, x)
    src = (lead[:, None] + j[None, :]).clamp(0, 15)
    if w > 16:
        digit = torch.cat([digit, torch.zeros((capacity, w - 16),
                                              dtype=torch.uint8,
                                              device=n.device)], dim=1)
    shifted = _gather(digit, src)[:, :w]
    mask = j[None, :] < out_len[:, None]
    return StringData(_masked(shifted, mask), out_len)


def trim(s: StringData, left: bool = True, right: bool = True,
         chars: bytes = b" ") -> StringData:
    """Trim leading and trailing bytes found in `chars` (default space)."""
    j = _arange(s.width, s.bytes)
    in_len = j[None, :] < s.lengths[:, None]
    is_trim = torch.zeros_like(s.bytes, dtype=torch.bool)
    for c in chars:
        is_trim = is_trim | (s.bytes == c)
    keep = in_len & ~is_trim
    any_keep = keep.any(dim=1)
    first = _first_true(keep)
    last = s.width - 1 - _first_true(torch.flip(keep, dims=[1]))
    start = (torch.where(any_keep, first, s.lengths) if left
             else torch.zeros_like(s.lengths))
    end = (torch.where(any_keep, last + 1, start) if right
           else torch.maximum(s.lengths, start))
    new_len = (end - start).clamp(min=0)
    return substring(s, start + 1, new_len)
