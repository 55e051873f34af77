/* The part of libzstd's public C API (zstd.h of zstd 1.x, whose simple
 * API and ABI are stable across the 1.x releases) that the native library
 * calls. It is found only on a host whose libzstd runtime has no
 * development header: the build passes this directory with -idirafter, so
 * a system zstd.h is always taken first, and links libzstd by its soname
 * (libzstd.so.1). The include guard is the system header's. */
#ifndef ZSTD_H_235446
#define ZSTD_H_235446

#include <stddef.h>

#ifdef __cplusplus
extern "C" {
#endif

unsigned ZSTD_versionNumber(void);
size_t ZSTD_compressBound(size_t srcSize);
size_t ZSTD_compress(void* dst, size_t dstCapacity, const void* src,
                     size_t srcSize, int compressionLevel);
size_t ZSTD_decompress(void* dst, size_t dstCapacity, const void* src,
                       size_t compressedSize);
unsigned ZSTD_isError(size_t code);
const char* ZSTD_getErrorName(size_t code);

#ifdef __cplusplus
}
#endif

#endif /* ZSTD_H_235446 */
