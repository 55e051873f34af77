// Per-group sums of base-256 digit planes: the dense grouped-aggregation
// accumulate of the whole-stage agg path (ops/mxu_agg.py).
//
// Replaces blaze_tpu/ops/mxu_agg.py::_pallas_accumulate. For each row r
// with ok[r] != 0 and each plane p of a recipe (kind, word, shift):
//     d = kind == digit ? ((words[word][r] >> shift) & 0xFF) - 128
//                       : words[word][r]                 // raw 0/1 count
//     out[key[r] >> 7][p][key[r] & 127] += d
// into an int32 (gh, P, 128) table that the caller zeroes. The result is an
// order-independent integer sum, exact for n <= 2^23 rows (127 * 2^23 <
// 2^31), so it matches the plain torch version bit for bit whatever order
// the atomics land in.
//
// Design: one row per thread in a grid-stride loop; each thread reads its
// key, ok flag and words (neighbouring threads on neighbouring words, so
// each warp's loads coalesce into 128-byte lines), extracts
// the P digits in registers and issues one global atomicAdd per nonzero
// digit. The table (1.8 MB at 2^16 keys and 7 planes) stays in the 50 MB L2,
// where the atomics resolve.
//
// Bound, at the main path's shape (n = 2^21 rows a batch, W = 3 words,
// P = 7 planes, 2^16 keys): the kernel must read (2 + W) * n * 4 B = 41.9 MB
// and write 1.8 MB, about 13 us at 3.35 TB/s, so it is bound by bytes; on
// top of that sit n_ok * P int32 atomics (about 14.7 M when every row
// passes). The TPU kernel's one-hot s8 matmul is not the card's best route:
// it needs 2 * n * R * P ~ 1.9 T int8 operations a batch, about 1 ms even at
// the tensor cores' 1979 TOP/s, which is why the direct scatter is used.
// Shared-memory privatisation or warp aggregation of hot keys is the next
// step when skewed keys make the atomics contend.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxWords = 16;   // must match mxu_agg._MAX_WORDS
constexpr int kMaxPlanes = 32;  // must match mxu_agg._MAX_PLANES
constexpr int kGL = 128;
constexpr int kThreads = 256;

// passed by value: lives in the kernel's constant parameter bank
struct Params {
  const int32_t* words[kMaxWords];
  int8_t kind[kMaxPlanes];   // 1 = digit, 0 = raw
  int8_t word[kMaxPlanes];
  int8_t shift[kMaxPlanes];
  int32_t n_planes;
};

__global__ void __launch_bounds__(kThreads)
mxu_accumulate_kernel(const int32_t* __restrict__ keys,
                      const int32_t* __restrict__ ok, int64_t n,
                      int32_t* __restrict__ out, const Params prm) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       r < n; r += stride) {
    if (__ldg(ok + r) == 0) continue;
    const int32_t key = __ldg(keys + r);
    int32_t* slot = out + static_cast<int64_t>(key >> 7) * prm.n_planes * kGL +
                    (key & (kGL - 1));
    for (int p = 0; p < prm.n_planes; ++p) {
      const int32_t w = __ldg(prm.words[prm.word[p]] + r);
      const int32_t d = prm.kind[p] ? ((w >> prm.shift[p]) & 0xFF) - 128 : w;
      if (d != 0) atomicAdd(slot + p * kGL, d);
    }
  }
}

}  // namespace

// Returns 0, a cudaError_t from the launch, or a negative code for
// arguments the kernel does not take (see mxu_accumulate_error).
extern "C" int mxu_accumulate(const void* keys, const void* ok,
                              const void* word_ptrs, int n_words,
                              const void* recipe, int n_planes, long long n,
                              void* out, int device, void* stream) {
  if (n_words < 1 || n_words > kMaxWords) return -1;
  if (n_planes < 1 || n_planes > kMaxPlanes) return -2;
  if (n < 0 || n > (1LL << 23)) return -3;
  Params prm = {};
  const auto* wp = static_cast<const int32_t* const*>(word_ptrs);
  for (int i = 0; i < n_words; ++i) prm.words[i] = wp[i];
  const auto* rc = static_cast<const int32_t*>(recipe);
  for (int p = 0; p < n_planes; ++p) {
    const int32_t kind = rc[3 * p], word = rc[3 * p + 1], sh = rc[3 * p + 2];
    if ((kind != 0 && kind != 1) || word < 0 || word >= n_words || sh < 0 ||
        sh > 24)
      return -4;
    prm.kind[p] = static_cast<int8_t>(kind);
    prm.word[p] = static_cast<int8_t>(word);
    prm.shift[p] = static_cast<int8_t>(sh);
  }
  prm.n_planes = n_planes;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n == 0) return 0;
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 65536) blocks = 65536;
  mxu_accumulate_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(keys), static_cast<const int32_t*>(ok), n,
      static_cast<int32_t*>(out), prm);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mxu_accumulate_error(int code) {
  switch (code) {
    case -1: return "word count outside [1, 16]";
    case -2: return "plane count outside [1, 32]";
    case -3: return "row count outside [0, 2^23]";
    case -4: return "bad recipe entry";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}
