// Staging of an MB row's chunks between global and shared memory, for
// the column-loop kernels that run one warp per chain (K2, K3's carry
// pass). One warp issues a chunk's copies with cp.async, spread over its
// lanes, commits them as one group and, before it reads the chunk,
// waits for that group and runs __syncwarp. Each copy is as wide as the
// addresses allow: 16 bytes for luma rows (mbw * 16 bytes apart),
// 8 bytes for the chroma rows of an odd number of MB columns (mbw * 8),
// 4 bytes else; a base that is not even 4-byte aligned takes plain byte
// copies, which are right but wait for memory.

#pragma once

#include <cstdint>

#include <cuda_pipeline.h>

namespace row_stage {

// The widest of 16, 8, 4 and 1 bytes that divides the address, the
// row pitch and the row length.
__device__ __forceinline__ int copy_width(const void* p, size_t pitch,
                                          int row_bytes) {
    const size_t a = reinterpret_cast<uintptr_t>(p) | pitch
                     | static_cast<size_t>(row_bytes);
    return (a & 15) == 0 ? 16 : (a & 7) == 0 ? 8 : (a & 3) == 0 ? 4 : 1;
}

// Stage `rows` rows of `row_bytes` bytes, `spitch` apart in global
// memory, into shared memory `dpitch` apart (dst 16-byte aligned, dpitch
// a multiple of 16).
__device__ __forceinline__ void stage_rows(uint8_t* dst, int dpitch,
                                           const uint8_t* src, size_t spitch,
                                           int rows, int row_bytes,
                                           int lane) {
    const int w = copy_width(src, spitch, row_bytes);
    const int per_row = row_bytes / w;
    for (int i = lane; i < rows * per_row; i += 32) {
        const int r = i / per_row, p = (i - r * per_row) * w;
        uint8_t* d = dst + r * dpitch + p;
        const uint8_t* s = src + r * spitch + p;
        if (w == 16)
            __pipeline_memcpy_async(d, s, 16);
        else if (w == 8)
            __pipeline_memcpy_async(d, s, 8);
        else if (w == 4)
            __pipeline_memcpy_async(d, s, 4);
        else
            *d = *s;
    }
}

// Stage the 4-byte words that cover bytes [src, src + n) (n <= 12) into
// dst; returns where src's first byte lands in dst (0..3). The words lie
// inside the allocation that holds the bytes, since allocations are
// aligned far beyond 4 bytes.
__device__ __forceinline__ int stage_bytes(uint8_t* dst, const uint8_t* src,
                                           int n, int lane) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(src);
    const uintptr_t a0 = a & ~uintptr_t(3), a1 = (a + n + 3) & ~uintptr_t(3);
    const int words = static_cast<int>((a1 - a0) / 4);
    if (lane < words)
        __pipeline_memcpy_async(dst + 4 * lane,
                                reinterpret_cast<const uint8_t*>(a0)
                                    + 4 * lane,
                                4);
    return static_cast<int>(a - a0);
}

// Write `rows` rows of `row_bytes` bytes from shared memory (`spitch`
// apart) to global memory (`dpitch` apart), as wide as the addresses
// allow.
__device__ __forceinline__ void store_rows(uint8_t* dst, size_t dpitch,
                                           const uint8_t* src, int spitch,
                                           int rows, int row_bytes,
                                           int lane) {
    const int w = copy_width(dst, dpitch, row_bytes);
    const int per_row = row_bytes / w;
    for (int i = lane; i < rows * per_row; i += 32) {
        const int r = i / per_row, p = (i - r * per_row) * w;
        uint8_t* d = dst + r * dpitch + p;
        const uint8_t* s = src + r * spitch + p;
        switch (w) {
            case 16:
                *reinterpret_cast<uint4*>(d) =
                    *reinterpret_cast<const uint4*>(s);
                break;
            case 8:
                *reinterpret_cast<uint2*>(d) =
                    *reinterpret_cast<const uint2*>(s);
                break;
            case 4:
                *reinterpret_cast<uint32_t*>(d) =
                    *reinterpret_cast<const uint32_t*>(s);
                break;
            default:
                *d = *s;
        }
    }
}

}  // namespace row_stage
