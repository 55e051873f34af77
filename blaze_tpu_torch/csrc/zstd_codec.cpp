// zstd frames for the port's serde (columnar/serde.py) over the system's
// libzstd: where the `zstandard` wheel is missing, the serde compresses and
// decompresses its BTB1 frame bodies through these entries, so its frames
// are the zstd frames the C++ encoder (native/src/batch_serde.cpp) writes
// and the Arrow stream (native/src/arrow_stream.cpp) reads. One call is one
// whole zstd frame (ZSTD_compress / ZSTD_decompress, the simple API the C++
// layer uses), so the bytes equal the C++ encoder's at the same level.
// Host code: replaces no TPU kernel.

#include <cstdint>

#include <zstd.h>

extern "C" {

// libzstd's version as major * 10000 + minor * 100 + release
unsigned bt_zstd_version(void) { return ZSTD_versionNumber(); }

// the largest compressed size of `n` input bytes
int64_t bt_zstd_bound(int64_t n) {
  return static_cast<int64_t>(ZSTD_compressBound(static_cast<size_t>(n)));
}

// compress src[0, n) into dst[0, cap) as one frame at `level`: the frame's
// size, or -1 when libzstd reports an error
int64_t bt_zstd_compress(const uint8_t* src, int64_t n, uint8_t* dst,
                         int64_t cap, int32_t level) {
  size_t r = ZSTD_compress(dst, static_cast<size_t>(cap), src,
                           static_cast<size_t>(n), level);
  return ZSTD_isError(r) ? -1 : static_cast<int64_t>(r);
}

// decompress one frame src[0, n) into dst[0, cap): the decompressed size,
// or -1 when the frame is corrupt or does not fit
int64_t bt_zstd_decompress(const uint8_t* src, int64_t n, uint8_t* dst,
                           int64_t cap) {
  size_t r = ZSTD_decompress(dst, static_cast<size_t>(cap), src,
                             static_cast<size_t>(n));
  return ZSTD_isError(r) ? -1 : static_cast<int64_t>(r);
}

}  // extern "C"
