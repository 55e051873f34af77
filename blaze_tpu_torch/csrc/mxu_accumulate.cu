// Per-group sums of base-256 digit planes, added into the whole-stage
// aggregation's int64 carry (ops/mxu_agg.accumulate_into).
//
// Replaces blaze_tpu/ops/mxu_agg.py::_pallas_accumulate. For each row r
// with valid[r] and 0 <= key[r] < rng, and each plane p of a recipe
// (kind, word, shift):
//     d = kind == digit ? ((words[word][r] >> shift) & 0xFF) - 128
//                       : (int8) words[word][r]          // raw 0/1 count
//     carry[key[r] >> 7][p][key[r] & 127] += d
// into the caller's int64 (gh, P, 128) carry, in place, with two's-
// complement wrap. Digits are int8, as in the reference (its kernel and
// _expand_words cast every plane to s8). The sums are integers, so any
// order of addition gives the same bits: the result equals the plain torch
// version bit for bit.
//
// Bound, at the main path's shape (n = 2^21 rows a batch, W = 3 words,
// P = 7 planes, 2^16 keys): the function must read keys, valid and words,
// (4 + 1 + 4 W) n = 35.7 MB, and read and write the 3.7 MB carry: 43 MB,
// 12.8 us at 3.35 TB/s. It is bound by bytes; the n P integer adds are
// noise beside them.
//
// Design. A row-per-thread scatter issues one global atomic per digit:
// 6.6 M L2 atomics a batch at this shape, and rows that share a key
// serialise on one address. This chain keeps the atomics in shared memory.
// The keys split into slices of S keys, the largest power of two whose
// S x P int32 table fits 16 KB of shared memory (the fastest table size
// measured; 512 keys at P = 7). At most 2^17 keys, so at most 1024
// slices:
//
//   1. count    rows per slice: a shared-memory histogram per tile of 4096
//               rows, then one global atomic per (tile, slice).
//   2. scan     one CTA: where each slice's records start, and its work
//               items (chunks of at most kChunk records), one table entry
//               per CTA of the accumulate.
//   3. scatter  per tile: reserve the tile's place in each slice's segment
//               (one global atomic per slice), sort the kept rows by slice
//               in shared memory, and write them as records: the key
//               within its slice (uint16) and the P digits as int8, padded
//               to 4, 8, 16 or 32 bytes.
//   4. accumulate  one CTA per work item: zero the slice's S x P int32
//               table in shared memory, walk its records with running sums
//               per thread that go into the table (one shared atomic per
//               plane) only when the thread's key changes, so hot keys do
//               not serialise; then add the table's nonzero entries into
//               the carry (a plain load-add-store where the CTA owns the
//               slice alone, else a 64-bit global atomic).
//
// Every kernel issues all the global loads of a thread's rows before it
// uses any of them: a loop with one load per turn waits out a memory round
// trip per turn and reaches a third of the card's bandwidth (PERF.md).
//
// Masked rows (valid false or a key outside [0, rng)) write no record. A
// work item's table sums at most kChunk records of |d| <= 128, so it
// stays int32-exact; the carry is int64, so one call takes any n < 2^30.
// Grids are sized from n and the slice count, never from the counts: no
// host synchronisation. All scratch comes from the caller; the chain
// allocates nothing. Every input must be 16-byte aligned (the wrapper
// copies one that is not), so the loads are vector loads throughout.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxWords = 16;     // must match mxu_agg._MAX_WORDS
constexpr int kMaxPlanes = 32;    // must match mxu_agg._MAX_PLANES
constexpr int kMaxKeys = 1 << 17;  // must match mxu_agg._MAX_KEYS
constexpr int kGL = 128;
constexpr int kMaxSlices = kMaxKeys / kGL;  // slices hold >= 128 keys
constexpr int kTableBytes = 16 * 1024;
constexpr int kChunk = 16384;     // records per work item
constexpr int kThreads = 256;     // count and scatter passes
constexpr int kVec = 4;           // rows per thread per load
constexpr int kCountItems = 4;    // load groups per thread in the count
constexpr int kCountTile = kThreads * kVec * kCountItems;
constexpr int kScanThreads = 1024;
constexpr int kAccThreads = 512;
constexpr int kAccUnroll = 8;     // records in flight per thread
constexpr int kWordsInFlight = 3;
constexpr unsigned kFull = 0xffffffffu;

// passed by value: lives in the kernel's constant parameter bank
struct Recipe {
  const int32_t* cols[kMaxWords];
  int32_t word[kMaxPlanes];
  int32_t shift[kMaxPlanes];
  int32_t digit[kMaxPlanes];       // 1 = digit, 0 = raw
  int32_t n_planes, n_words;
};

// digit words per record, and load groups of kVec rows per thread in the
// scatter, whose tile of kThreads * kVec * items rows stages in shared
// memory: under 48 KB for every record size at kMaxSlices, so no kernel
// needs the shared-memory opt-in
__host__ __device__ constexpr int words_per_record(int n_planes) {
  return n_planes <= 4 ? 1 : n_planes <= 8 ? 2 : n_planes <= 16 ? 4 : 8;
}
__host__ __device__ constexpr int scatter_items(int nw) {
  return nw <= 2 ? 2 : 1;
}
__host__ __device__ constexpr int scatter_tile(int nw) {
  return kThreads * kVec * scatter_items(nw);
}
__host__ __device__ constexpr int scatter_smem(int nw, int n_slices) {
  return (4 * nw + 4) * scatter_tile(nw) + 8 * (n_slices + 1);
}
static_assert(scatter_smem(1, kMaxSlices) <= 47 * 1024 &&
                  scatter_smem(2, kMaxSlices) <= 47 * 1024 &&
                  scatter_smem(4, kMaxSlices) <= 47 * 1024 &&
                  scatter_smem(8, kMaxSlices) <= 47 * 1024,
              "the scatter's staging must fit 48 KB without an opt-in");

// Scratch layout, in the caller's buffer: per-slice counters, the work
// items, then the records. Both the size query and the launch use it.
struct Layout {
  int max_items;
  long long total, cursor, items, rkey, rdig, bytes;
};

inline long long round16(long long x) { return (x + 15) & ~15LL; }

// log2 of the keys per slice: the most whose int32 table of n_planes
// planes fits kTableBytes (<= 2^12, so a key within its slice fits uint16)
int slice_log2_of(int n_planes) {
  int b = 7;
  while ((4 * n_planes << (b + 1)) <= kTableBytes) ++b;
  return b;
}

int n_slices_of(int n_keys, int slice_log2) {
  return (n_keys + (1 << slice_log2) - 1) >> slice_log2;
}

Layout layout_of(long long n, int n_planes, int n_slices) {
  Layout l;
  l.max_items = n_slices + static_cast<int>((n + kChunk - 1) / kChunk);
  l.total = 0;
  l.cursor = l.total + 4LL * n_slices;
  l.items = round16(l.cursor + 4LL * n_slices);
  l.rkey = round16(l.items + 16LL * l.max_items);
  l.rdig = round16(l.rkey + 2 * n);
  l.bytes = l.rdig + 4LL * words_per_record(n_planes) * n;
  return l;
}

// Loads of kVec rows from r0 (a multiple of kVec), one vector load but at
// the ragged end, issued unconditionally (from row 0 past the end) so that
// a thread's loads all go out before any is used.
__device__ __forceinline__ int4 load4(const int32_t* __restrict__ p, int n,
                                      int r0) {
  if (r0 + kVec <= n)
    return __ldg(reinterpret_cast<const int4*>(p + r0));
  int v[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) v[i] = __ldg(p + (r0 + i < n ? r0 + i : 0));
  return make_int4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ uchar4 load_valid4(const uint8_t* __restrict__ p,
                                              int n, int r0) {
  if (r0 + kVec <= n)
    return __ldg(reinterpret_cast<const uchar4*>(p + r0));
  uint8_t v[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) v[i] = __ldg(p + (r0 + i < n ? r0 + i : 0));
  return make_uchar4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ int lane_of(const int4& x, int i) {
  return i == 0 ? x.x : i == 1 ? x.y : i == 2 ? x.z : x.w;
}

__device__ __forceinline__ bool kept(const uchar4& v, const int4& k, int i,
                                     int n, int r0, int rng) {
  const uint8_t b = i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
  return r0 + i < n && b != 0 &&
         static_cast<unsigned>(lane_of(k, i)) < static_cast<unsigned>(rng);
}

// Exclusive scan of a[0..m) in shared memory by the whole block, in place;
// returns the total. `warp_sums` holds 33 ints: one per warp, and a total.
__device__ int block_exclusive_scan(int* a, int m, int* warp_sums) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int carry = 0;
  for (int base = 0; base < m; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const int x = i < m ? a[i] : 0;
    int incl = x;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += y;
    }
    if (lane == 31) warp_sums[wid] = incl;
    __syncthreads();
    if (wid == 0) {
      const int w0 = lane < nwarps ? warp_sums[lane] : 0;
      int w = w0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, w, o);
        if (lane >= o) w += y;
      }
      if (lane < nwarps) warp_sums[lane] = w - w0;
      if (lane == 31) warp_sums[32] = w;  // the stretch's total
    }
    __syncthreads();
    if (i < m) a[i] = carry + warp_sums[wid] + incl - x;
    carry += warp_sums[32];
    __syncthreads();
  }
  return carry;
}

// 1. rows per slice
__global__ void __launch_bounds__(kThreads)
mxu_count_kernel(const int32_t* __restrict__ keys,
                 const uint8_t* __restrict__ valid, int n, int rng,
                 int slice_log2, int n_slices, int* __restrict__ total) {
  extern __shared__ int hist[];
  int4 k[kCountItems];
  uchar4 v[kCountItems];
  const int tile0 = blockIdx.x * kCountTile;
#pragma unroll
  for (int j = 0; j < kCountItems; ++j) {
    const int r0 = tile0 + (j * kThreads + threadIdx.x) * kVec;
    k[j] = load4(keys, n, r0);
    v[j] = load_valid4(valid, n, r0);
  }
  for (int s = threadIdx.x; s < n_slices; s += blockDim.x) hist[s] = 0;
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kCountItems; ++j) {
    const int r0 = tile0 + (j * kThreads + threadIdx.x) * kVec;
#pragma unroll
    for (int i = 0; i < kVec; ++i)
      if (kept(v[j], k[j], i, n, r0, rng))
        atomicAdd(hist + (lane_of(k[j], i) >> slice_log2), 1);
  }
  __syncthreads();
  for (int s = threadIdx.x; s < n_slices; s += blockDim.x)
    if (hist[s] != 0) atomicAdd(total + s, hist[s]);
}

// 2. exclusive scans of the record counts and of the work items per
// slice; each work item as (slice, first record, end, shared), and a slice
// of -1 for the accumulate's CTAs past the last item
__global__ void __launch_bounds__(kScanThreads)
mxu_scan_kernel(const int* __restrict__ total, int n_slices, int max_items,
                int* __restrict__ cursor, int4* __restrict__ items) {
  __shared__ int warp_rec[kScanThreads / 32], warp_work[kScanThreads / 32];
  __shared__ int n_items;
  const int per = (n_slices + kScanThreads - 1) / kScanThreads;
  const int s0 = threadIdx.x * per;
  const int s1 = min(s0 + per, n_slices);
  int rec = 0, work = 0;
  for (int s = s0; s < s1; ++s) {
    rec += total[s];
    work += (total[s] + kChunk - 1) / kChunk;
  }
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  int ir = rec, iw = work;  // inclusive scans within the warp
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int a = __shfl_up_sync(kFull, ir, o);
    const int b = __shfl_up_sync(kFull, iw, o);
    if (lane >= o) { ir += a; iw += b; }
  }
  if (lane == 31) { warp_rec[wid] = ir; warp_work[wid] = iw; }
  __syncthreads();
  if (wid == 0) {
    const int a0 = warp_rec[lane], b0 = warp_work[lane];
    int a = a0, b = b0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int x = __shfl_up_sync(kFull, a, o);
      const int y = __shfl_up_sync(kFull, b, o);
      if (lane >= o) { a += x; b += y; }
    }
    warp_rec[lane] = a - a0;
    warp_work[lane] = b - b0;
  }
  __syncthreads();
  int r = warp_rec[wid] + ir - rec;
  int w = warp_work[wid] + iw - work;
  for (int s = s0; s < s1; ++s) {
    const int t = total[s];
    cursor[s] = r;
    for (int j = 0; j * kChunk < t; ++j, ++w)
      items[w] = make_int4(s, r + j * kChunk, r + min(t, (j + 1) * kChunk),
                           t > kChunk);
    r += t;
  }
  if (threadIdx.x == kScanThreads - 1) n_items = w;
  __syncthreads();
  for (int b = n_items + threadIdx.x; b < max_items; b += blockDim.x)
    items[b] = make_int4(-1, 0, 0, 0);
}

// 3. each tile's kept rows, sorted by slice, as records in their slices'
// segments
template <int NW>
__global__ void __launch_bounds__(kThreads, 3)
mxu_scatter_kernel(const int32_t* __restrict__ keys,
                   const uint8_t* __restrict__ valid, const Recipe rc, int n,
                   int rng, int slice_log2, int n_slices,
                   int* __restrict__ cursor, uint16_t* __restrict__ rkey,
                   uint32_t* __restrict__ rdig) {
  constexpr int kItems = scatter_items(NW);
  constexpr int kTile = scatter_tile(NW);
  // shared: the tile's records (digits, then keys), the runs' offsets in
  // the tile, and each run's shift to its place in the segment
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* st_dig = smem;
  int* st_key = reinterpret_cast<int*>(smem + kTile * NW);
  int* run = st_key + kTile;
  int* shift = run + n_slices + 1;
  __shared__ int warp_sums[33];

  // the keys, flags and first kWordsInFlight words go out together, so
  // that the words' latency overlaps the ranking below
  const int tile0 = blockIdx.x * kTile;
  int4 k[kItems];
  uchar4 v[kItems];
  int4 x[kWordsInFlight][kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int r0 = tile0 + (j * kThreads + threadIdx.x) * kVec;
    k[j] = load4(keys, n, r0);
    v[j] = load_valid4(valid, n, r0);
#pragma unroll
    for (int u = 0; u < kWordsInFlight; ++u)
      x[u][j] = u < rc.n_words ? load4(rc.cols[u], n, r0)
                               : make_int4(0, 0, 0, 0);
  }
  for (int s = threadIdx.x; s <= n_slices; s += blockDim.x) run[s] = 0;
  __syncthreads();

  // each kept row's rank among the tile's rows of its slice
  int rank[kItems][kVec];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int r0 = tile0 + (j * kThreads + threadIdx.x) * kVec;
#pragma unroll
    for (int i = 0; i < kVec; ++i)
      rank[j][i] = kept(v[j], k[j], i, n, r0, rng)
                       ? atomicAdd(run + (lane_of(k[j], i) >> slice_log2), 1)
                       : 0;
  }

  // digits, kVec rows of each load group at a time, kWordsInFlight words
  // of the recipe at a time
  uint32_t rec[kItems][kVec][NW];
#pragma unroll
  for (int j = 0; j < kItems; ++j)
#pragma unroll
    for (int i = 0; i < kVec; ++i)
#pragma unroll
      for (int w = 0; w < NW; ++w) rec[j][i][w] = 0u;
#pragma unroll
  for (int wb = 0; wb < kMaxWords; wb += kWordsInFlight) {
    if (wb >= rc.n_words) break;
    if (wb > 0) {
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        const int r0 = tile0 + (j * kThreads + threadIdx.x) * kVec;
#pragma unroll
        for (int u = 0; u < kWordsInFlight; ++u)
          x[u][j] = wb + u < rc.n_words
                        ? load4(rc.cols[wb + u], n, r0)
                        : make_int4(0, 0, 0, 0);
      }
    }
#pragma unroll
    for (int p = 0; p < 4 * NW; ++p) {
      const int u = p < rc.n_planes ? rc.word[p] - wb : -1;
      if (u < 0 || u >= kWordsInFlight) continue;
      const int sh = rc.shift[p];
      const bool digit = rc.digit[p] != 0;
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        const int4 xv = u == 0 ? x[0][j] : u == 1 ? x[1][j] : x[2][j];
#pragma unroll
        for (int i = 0; i < kVec; ++i) {
          // digit: ((v >> shift) & 0xFF) - 128 is that byte with its top
          // bit flipped; raw: the low byte, as the reference's s8 cast
          const uint32_t val = static_cast<uint32_t>(lane_of(xv, i));
          const uint32_t b = digit ? ((val >> sh) ^ 0x80u) & 0xFFu
                                   : val & 0xFFu;
          rec[j][i][p / 4] |= b << (8 * (p % 4));
        }
      }
    }
  }

  __syncthreads();  // the histogram is complete
  const int n_kept = block_exclusive_scan(run, n_slices + 1, warp_sums);
  for (int s = threadIdx.x; s < n_slices; s += blockDim.x) {
    const int c = run[s + 1] - run[s];
    shift[s] = c != 0 ? atomicAdd(cursor + s, c) - run[s] : 0;
  }
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int r0 = tile0 + (j * kThreads + threadIdx.x) * kVec;
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      if (!kept(v[j], k[j], i, n, r0, rng)) continue;
      const int key = lane_of(k[j], i);
      const int pos = run[key >> slice_log2] + rank[j][i];
      st_key[pos] = key;
#pragma unroll
      for (int w = 0; w < NW; ++w) st_dig[pos * NW + w] = rec[j][i][w];
    }
  }
  __syncthreads();

  const int in_slice = (1 << slice_log2) - 1;
  for (int t = threadIdx.x; t < n_kept; t += blockDim.x) {
    const int key = st_key[t];
    const int pos = t + shift[key >> slice_log2];
    rkey[pos] = static_cast<uint16_t>(key & in_slice);
    uint32_t* dst = rdig + static_cast<long long>(pos) * NW;
    const uint32_t* src = st_dig + t * NW;
    if constexpr (NW == 1) {
      *dst = *src;
    } else if constexpr (NW == 2) {
      *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(src);
    } else {
#pragma unroll
      for (int w = 0; w < NW; w += 4)
        *reinterpret_cast<uint4*>(dst + w) =
            *reinterpret_cast<const uint4*>(src + w);
    }
  }
}

template <int NW>
__device__ __forceinline__ void load_record(const uint32_t* src,
                                            uint32_t (&w)[NW]) {
  if constexpr (NW == 1) {
    w[0] = __ldg(src);
  } else if constexpr (NW == 2) {
    const uint2 x = __ldg(reinterpret_cast<const uint2*>(src));
    w[0] = x.x; w[1] = x.y;
  } else {
#pragma unroll
    for (int j = 0; j < NW; j += 4) {
      const uint4 x = __ldg(reinterpret_cast<const uint4*>(src + j));
      w[j] = x.x; w[j + 1] = x.y; w[j + 2] = x.z; w[j + 3] = x.w;
    }
  }
}

// Adds one key's running plane sums into the shared table.
template <int kPlanes>
__device__ __forceinline__ void add_run(int* table, int key, int n_planes,
                                        const int (&sum)[kPlanes]) {
  int* row = table + (key >> 7) * n_planes * kGL + (key & (kGL - 1));
#pragma unroll
  for (int p = 0; p < kPlanes; ++p)
    if (p < n_planes && sum[p] != 0) atomicAdd(row + p * kGL, sum[p]);
}

// 4. one CTA per (slice, chunk of its records): shared table, then carry
template <int NW>
__global__ void __launch_bounds__(kAccThreads)
mxu_accumulate_kernel(const int4* __restrict__ items,
                      const uint16_t* __restrict__ rkey,
                      const uint32_t* __restrict__ rdig, int n_planes,
                      int slice_log2, int n_keys,
                      int64_t* __restrict__ carry) {
  extern __shared__ __align__(16) int table[];  // (S / 128, P, 128) int32
  const int4 item = items[blockIdx.x];
  if (item.x < 0) return;  // the whole block: past the last item
  const int s = item.x, beg = item.y, end = item.z;
  const int keys_here = min(1 << slice_log2, n_keys - (s << slice_log2));
  const int entries = keys_here * n_planes;  // a multiple of 128

  int4* t4 = reinterpret_cast<int4*>(table);
  for (int e = threadIdx.x; e < entries / 4; e += blockDim.x)
    t4[e] = make_int4(0, 0, 0, 0);
  __syncthreads();

  // each thread keeps running sums while its key repeats and adds them to
  // the table when the key changes: a hot key costs one shared atomic a
  // plane per run of it, not per record
  constexpr int kPlanes = 4 * NW;
  int cur = -1;
  int sum[kPlanes];
#pragma unroll
  for (int p = 0; p < kPlanes; ++p) sum[p] = 0;
  for (int i0 = beg; i0 < end; i0 += kAccUnroll * kAccThreads) {
    int kl[kAccUnroll];
    uint32_t w[kAccUnroll][NW];
#pragma unroll
    for (int u = 0; u < kAccUnroll; ++u) {
      const int i = i0 + u * kAccThreads + threadIdx.x;
      const int at = i < end ? i : beg;
      kl[u] = __ldg(rkey + at);
      load_record<NW>(rdig + static_cast<long long>(at) * NW, w[u]);
      if (i >= end) kl[u] = -1;
    }
#pragma unroll
    for (int u = 0; u < kAccUnroll; ++u) {
      if (kl[u] < 0) continue;
      if (kl[u] != cur) {
        if (cur >= 0) add_run(table, cur, n_planes, sum);
        cur = kl[u];
#pragma unroll
        for (int p = 0; p < kPlanes; ++p) sum[p] = 0;
      }
#pragma unroll
      for (int p = 0; p < kPlanes; ++p)
        sum[p] += static_cast<int8_t>((w[u][p / 4] >> (8 * (p % 4))) & 0xFFu);
    }
  }
  if (cur >= 0) add_run(table, cur, n_planes, sum);
  __syncthreads();

  int64_t* dst = carry + static_cast<long long>(s << slice_log2) * n_planes;
  if (item.w) {  // other CTAs add into this slice too
    for (int e = threadIdx.x; e < entries; e += blockDim.x) {
      const int v = table[e];
      if (v != 0)
        atomicAdd(reinterpret_cast<unsigned long long*>(dst + e),
                  static_cast<unsigned long long>(static_cast<long long>(v)));
    }
    return;
  }
  // the slice's only CTA: load-add-store, every load of a turn in flight
  // before any store
  for (int e0 = 0; e0 < entries; e0 += kAccUnroll * kAccThreads) {
    int64_t c[kAccUnroll];
#pragma unroll
    for (int u = 0; u < kAccUnroll; ++u) {
      const int e = e0 + u * kAccThreads + threadIdx.x;
      c[u] = e < entries ? dst[e] : 0;
    }
#pragma unroll
    for (int u = 0; u < kAccUnroll; ++u) {
      const int e = e0 + u * kAccThreads + threadIdx.x;
      if (e < entries && table[e] != 0) dst[e] = c[u] + table[e];
    }
  }
}

// The chain's kernels, in launch order; launched[k] is set to 1 once the
// k-th launch is accepted.
enum { kCount, kScan, kScatter, kAccumulate, kChainKernels };

template <int NW>
cudaError_t launch(const int32_t* keys, const uint8_t* valid,
                   const Recipe& rc, int n, int rng, int n_keys,
                   int slice_log2, int n_slices, int64_t* carry,
                   const Layout& l, char* scratch, cudaStream_t stream,
                   int* launched) {
  int* total = reinterpret_cast<int*>(scratch + l.total);
  int* cursor = reinterpret_cast<int*>(scratch + l.cursor);
  int4* items = reinterpret_cast<int4*>(scratch + l.items);
  uint16_t* rkey = reinterpret_cast<uint16_t*>(scratch + l.rkey);
  uint32_t* rdig = reinterpret_cast<uint32_t*>(scratch + l.rdig);
  cudaError_t err =
      cudaMemsetAsync(total, 0, sizeof(int) * n_slices, stream);
  if (err != cudaSuccess) return err;
  mxu_count_kernel<<<(n + kCountTile - 1) / kCountTile, kThreads,
                     sizeof(int) * n_slices, stream>>>(
      keys, valid, n, rng, slice_log2, n_slices, total);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  launched[kCount] = 1;
  mxu_scan_kernel<<<1, kScanThreads, 0, stream>>>(total, n_slices,
                                                   l.max_items, cursor, items);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  launched[kScan] = 1;
  const int tile = scatter_tile(NW);
  mxu_scatter_kernel<NW>
      <<<(n + tile - 1) / tile, kThreads, scatter_smem(NW, n_slices),
         stream>>>(keys, valid, rc, n, rng, slice_log2, n_slices, cursor,
                   rkey, rdig);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  launched[kScatter] = 1;
  mxu_accumulate_kernel<NW>
      <<<l.max_items, kAccThreads, (4 * rc.n_planes) << slice_log2,
         stream>>>(items, rkey, rdig, rc.n_planes, slice_log2, n_keys, carry);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  launched[kAccumulate] = 1;
  return cudaSuccess;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// Bytes of scratch that mxu_accumulate_into needs, or -1 for arguments it
// does not take.
extern "C" long long mxu_accumulate_scratch_bytes(long long n, int n_planes,
                                                   int n_keys) {
  if (n < 0 || n >= (1LL << 30) || n_planes < 1 || n_planes > kMaxPlanes ||
      n_keys < 1)
    return -1;
  const int b = slice_log2_of(n_planes);
  return layout_of(n, n_planes, n_slices_of(n_keys, b)).bytes;
}

// Adds the digit-plane sums of n rows into carry, an int64 (n_keys / 128,
// n_planes, 128) tensor, on `stream`. Returns 0, a cudaError_t from a
// launch, or a negative code for arguments the chain does not take (see
// mxu_accumulate_error). Launches nothing when n == 0; otherwise a memset
// and the four kernels. launched[0..3] (count, scan, scatter, accumulate)
// is set to 1 for each kernel whose launch was accepted, else 0.
extern "C" int mxu_accumulate_into(const void* keys, const void* valid,
                                   const void* word_ptrs, int n_words,
                                   const void* recipe, int n_planes,
                                   long long n, int rng, int n_keys,
                                   void* carry, void* scratch,
                                   long long scratch_bytes, int device,
                                   void* stream, int* launched) {
  for (int k = 0; k < kChainKernels; ++k) launched[k] = 0;
  if (n_words < 1 || n_words > kMaxWords) return -1;
  if (n_planes < 1 || n_planes > kMaxPlanes) return -2;
  if (n < 0 || n >= (1LL << 30)) return -3;
  if (rng < 1 || n_keys < rng || n_keys % kGL != 0) return -5;
  if (n_keys > kMaxKeys) return -6;
  const int slice_log2 = slice_log2_of(n_planes);
  const int n_slices = n_slices_of(n_keys, slice_log2);
  const Layout l = layout_of(n, n_planes, n_slices);
  if (scratch_bytes < l.bytes) return -7;
  Recipe rc = {};
  const auto* wp = static_cast<const int32_t* const*>(word_ptrs);
  const auto* r = static_cast<const int32_t*>(recipe);
  bool aligned = aligned16(keys) && aligned16(valid) && aligned16(scratch) &&
                 reinterpret_cast<uintptr_t>(carry) % 8 == 0;
  for (int i = 0; i < n_words; ++i) {
    rc.cols[i] = wp[i];
    aligned = aligned && aligned16(wp[i]);
  }
  if (!aligned) return -8;
  for (int p = 0; p < n_planes; ++p) {
    const int32_t kind = r[3 * p], word = r[3 * p + 1], sh = r[3 * p + 2];
    if ((kind != 0 && kind != 1) || word < 0 || word >= n_words || sh < 0 ||
        sh > 24)
      return -4;
    rc.word[p] = word;
    rc.digit[p] = kind;
    rc.shift[p] = sh;
  }
  rc.n_planes = n_planes;
  rc.n_words = n_words;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n == 0) return 0;
  const auto* k = static_cast<const int32_t*>(keys);
  const auto* v = static_cast<const uint8_t*>(valid);
  auto* c = static_cast<int64_t*>(carry);
  auto* sc = static_cast<char*>(scratch);
  auto* st = static_cast<cudaStream_t>(stream);
  const int nn = static_cast<int>(n);
  const int nw = words_per_record(n_planes);
#define MXU_LAUNCH(NW)                                                      \
  err = launch<NW>(k, v, rc, nn, rng, n_keys, slice_log2, n_slices, c, l,   \
                   sc, st, launched)
  if (nw == 1) MXU_LAUNCH(1);
  else if (nw == 2) MXU_LAUNCH(2);
  else if (nw == 4) MXU_LAUNCH(4);
  else MXU_LAUNCH(8);
#undef MXU_LAUNCH
  return static_cast<int>(err);
}

extern "C" const char* mxu_accumulate_error(int code) {
  switch (code) {
    case -1: return "word count outside [1, 16]";
    case -2: return "plane count outside [1, 32]";
    case -3: return "row count outside [0, 2^30)";
    case -4: return "bad recipe entry";
    case -5: return "key range outside [1, n_keys], or n_keys not a multiple of 128";
    case -6: return "more than 2^17 keys";
    case -7: return "scratch buffer too small";
    case -8: return "an input or the scratch not 16-byte aligned, or the carry not 8-byte aligned";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}
