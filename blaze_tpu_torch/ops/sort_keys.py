"""Sort-key encoding: columns -> int64 key words whose ascending order is the
requested Spark ordering (asc/desc, nulls first/last).

Port of blaze_tpu/ops/sort_keys.py. The JAX package feeds unsigned key
arrays to one variadic `lax.sort(num_keys=k, is_stable=True)`. PyTorch has
no multi-key sort and CUDA `torch.sort` takes no uint32/uint64, so here:

  * every key is a (word, bits) pair: a non-negative int64 below 2^bits
    for bits < 64, or, for bits == 64, an int64 whose SIGNED order is the
    key order (an unsigned 64-bit key XOR 1 << 63);
  * consecutive narrow keys pack into one int64 while they fit in 63 bits
    (the liveness bit, a null flag and a 32-bit value are one word, so one
    sort instead of three); a word of at most 31 bits sorts as int32;
  * rows are ordered by stable sorts from the least to the most
    significant word, which is the lexicographic, stable order of the
    variadic sort (`first` and the row order within a group rely on it).

Encodings (the JAX package's, in int64):
  * signed ints / date / timestamp / decimal: value + 2^(w-1) in w bits
    (int64 family: the value itself, already in signed order)
  * bool: 1 bit (false < true)
  * float32/64: IEEE total order; NaN canonical and greatest, -0.0 folded
    into +0.0. The JAX package splits f64 into two f32 words on the TPU,
    which has no 64-bit bitcast (blaze_tpu/columnar/bits64.py); here it is
    one `Tensor.view(torch.int64)`
  * nulls: a 1-bit flag key before the value; a null's value is the
    domain's least (its greatest when descending)
  * descending: the complement of the value within its width
  * strings: the first 8 big-endian 8-byte words of the zero-padded bytes
    (64-bit keys), then the length (32 bits). Strings longer than 64 bytes
    that share those 64 bytes and their length tie, as in the JAX package
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from blaze_tpu_torch.columnar.batch import Column, ColumnBatch, StringData
from blaze_tpu_torch.columnar.types import TypeKind

Key = Tuple[torch.Tensor, int]   # (int64 word, bits)

_I64_MIN = -(1 << 63)
_LOW63 = (1 << 63) - 1

# default prefix words of a string ORDER BY key (8 bytes each)
DEFAULT_MAX_STRING_WORDS = 8

_INT_BITS = {TypeKind.INT8: 8, TypeKind.INT16: 16, TypeKind.INT32: 32,
             TypeKind.DATE: 32}


@dataclasses.dataclass(frozen=True)
class SortSpec:
    """One ORDER BY term (ref: PhysicalExprNode sort field asc/nulls_first)."""
    col: int
    asc: bool = True
    nulls_first: bool = True

    def key(self) -> tuple:
        return (self.col, self.asc, self.nulls_first)


def _float_word(x: torch.Tensor) -> Key:
    """Total-order key of a float column (NaN last, -0.0 == 0.0)."""
    x = torch.where(torch.isnan(x), torch.full_like(x, float("nan")), x)
    x = torch.where(x == 0, torch.zeros_like(x), x)
    if x.dtype == torch.float32:
        u = x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
        neg = u >= (1 << 31)
        return torch.where(neg, u ^ 0xFFFFFFFF, u ^ (1 << 31)), 32
    s = x.to(torch.float64).view(torch.int64)
    # negative floats: flip every bit but the sign, so larger magnitudes
    # order lower; non-negative floats already order as their bits
    return torch.where(s < 0, s ^ _LOW63, s), 64


def string_words(s: StringData, max_words: Optional[int] = None,
                 exact_words: Optional[int] = None) -> List[torch.Tensor]:
    """Big-endian 64-bit words of the padded byte matrix, each an int64
    whose signed order is the words' unsigned order (XOR the sign bit).

    `exact_words` pads or cuts to a fixed word count, so the two sides of
    a join emit the same key layout whatever their width buckets."""
    cap, w = s.bytes.shape
    nwords = (w + 7) // 8
    if max_words is not None:
        nwords = min(nwords, max_words)
    if exact_words is not None:
        nwords = exact_words
    padded_w = nwords * 8
    b = s.bytes[:, :padded_w]
    if padded_w > w:
        b = torch.nn.functional.pad(b, (0, padded_w - w))
    b = b.reshape(cap, nwords, 8).to(torch.int64)
    packed = b[..., 0] << 56
    for i in range(1, 8):
        packed = packed | (b[..., i] << (56 - 8 * i))
    packed = packed ^ _I64_MIN
    return [packed[:, i] for i in range(nwords)]


def encode_column(col: Column, asc: bool, nulls_first: bool,
                  row_mask: torch.Tensor,
                  max_string_words: int = DEFAULT_MAX_STRING_WORDS,
                  exact_string_words: Optional[int] = None) -> List[Key]:
    """Key words of one column; earlier words are more significant."""
    keys: List[Key] = []
    valid = col.valid_mask() & row_mask
    if col.validity is not None:
        # 0 sorts first: null -> 0 iff nulls_first
        flag = valid if nulls_first else ~valid
        keys.append((flag.to(torch.int64), 1))
    k = col.dtype.kind
    if col.dtype.wide_decimal:
        # the limb planes: hi in signed order, then lo in unsigned order
        # (sign-flipped into a signed word)
        hi, lo = (ch.data for ch in col.data.children)
        keys.append(_directed(hi, 64, valid, asc))
        keys.append(_directed(lo ^ _I64_MIN, 64, valid, asc))
        return keys
    if col.dtype.is_nested:
        raise TypeError(f"no sort keys for {col.dtype}")
    if k == TypeKind.NULL:
        return keys
    if col.is_string:
        words = [(w, 64) for w in string_words(
            col.data, max_string_words, exact_string_words)]
        words.append((col.data.lengths.to(torch.int64), 32))
        for word, bits in words:
            keys.append(_directed(word, bits, valid, asc))
        return keys
    if k == TypeKind.BOOLEAN:
        word, bits = col.data.to(torch.int64), 1
    elif k in (TypeKind.FLOAT32, TypeKind.FLOAT64):
        word, bits = _float_word(col.data)
    elif k in _INT_BITS:
        bits = _INT_BITS[k]
        word = col.data.to(torch.int64) + (1 << (bits - 1))
    else:  # int64, timestamp, decimal: signed order is the key order
        word, bits = col.data.to(torch.int64), 64
    keys.append(_directed(word, bits, valid, asc))
    return keys


def _directed(word: torch.Tensor, bits: int, valid: torch.Tensor,
              asc: bool) -> Key:
    # nulls take the domain's least value (the JAX package zeroes its
    # unsigned encoding); the flag already ranks them
    least = _I64_MIN if bits == 64 else 0
    word = torch.where(valid, word, torch.full_like(word, least))
    if not asc:
        word = ~word if bits == 64 else ((1 << bits) - 1) - word
    return word, bits


def pack_keys(keys: Sequence[Key]) -> List[torch.Tensor]:
    """Pack consecutive narrow words into as few int64 words as keep their
    lexicographic order (at most 63 bits each, so they stay non-negative);
    a 64-bit word stands alone. Words of at most 31 bits become int32."""
    out: List[torch.Tensor] = []
    acc, acc_bits = None, 0

    def flush():
        if acc is not None:
            out.append(acc.to(torch.int32) if acc_bits <= 31 else acc)

    for word, bits in keys:
        if bits == 64 or acc_bits + bits > 63:
            flush()
            acc, acc_bits = None, 0
            if bits == 64:
                out.append(word)
                continue
        acc = word if acc is None else (acc << bits) | word
        acc_bits += bits
    flush()
    return out


def batch_sort_keys(batch: ColumnBatch, specs: Sequence[SortSpec]
                    ) -> List[torch.Tensor]:
    """Packed key words of a multi-column sort, padding rows last: the
    leading liveness bit sends rows >= num_rows to the end whatever the
    directions and null flags, so sorted outputs stay front-compact."""
    mask = batch.row_mask()
    keys: List[Key] = [((~mask).to(torch.int64), 1)]
    for spec in specs:
        keys.extend(encode_column(batch.columns[spec.col], spec.asc,
                                  spec.nulls_first, mask))
    return pack_keys(keys)


def sort_batch(batch: ColumnBatch, specs: Sequence[SortSpec]) -> ColumnBatch:
    """Reorder all rows by the sort specs (shape-preserving, stable)."""
    return permute_by_keys(batch, batch_sort_keys(batch, specs))


def sort_permutation(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """Stable lexicographic order of rows by `keys` (most significant
    first): one stable sort per word, least significant first."""
    perm = None
    for word in reversed(keys):
        if perm is None:
            perm = torch.sort(word, stable=True).indices
        else:
            perm = perm[torch.sort(word[perm], stable=True).indices]
    return perm


def permute_by_keys(batch: ColumnBatch, keys: Sequence[torch.Tensor]
                    ) -> ColumnBatch:
    """Sort the rows by the key words, then gather every column through
    the permutation (payload columns never ride the sort)."""
    perm = sort_permutation(keys)
    cols = [c.take(perm) for c in batch.columns]
    return ColumnBatch(batch.schema, cols, batch.num_rows, batch.capacity)
