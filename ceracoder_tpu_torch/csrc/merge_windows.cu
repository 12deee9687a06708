// K1: variable-length bitstream window merge, hand-written for Hopper.
//
// Replaces the Pallas TPU kernel ceracoder_tpu/ops/bitpack.py:merge_windows
// (_merge_kernel / _dyn_roll_lanes). It computes, per row r and chunk c,
//
//     words[r, sw[r,c] + k] += partials[r,c,k]      for k < WIN (= 64)
//
// mod 2^32, dropping every word at or past capw_pad and every negative
// index. It is exact for any input: starts in any order, nonzero words
// anywhere in a window. Unlike the TPU kernel, no word wraps around a
// 128-lane window: each word lands at its own index.
//
// Bound: bytes. At 1080p a P frame reads 68 x 215 x 64 x 4 B of partials
// (3.74 MB) and 58 KB of start words and writes 68 x 5888 x 4 B (1.60 MB):
// 1.6 us at 3.35 TB/s. The partials were written just before by
// pack_rows, so the reads mostly hit the 50 MB L2. The fixed cost of a
// launch is of the same order as the bound, so latency, not bandwidth,
// sets the time.
//
// What held the first design back (one 256-thread CTA per row, the row in
// shared memory, 16.6 us): each thread made about 54 4-byte loads, one
// after another behind a data-dependent branch and a shared-memory
// atomic, so few bytes were in flight per SM.
//
// This design keeps one CTA per row and the row's words in shared memory,
// but puts all of the row's loads in flight at once: 1024 threads each
// load kVecPerThread 16-byte vectors of the row's partials (and the start
// of each vector's chunk) into registers, all started before any is used,
// and the CTA zeroes the row while they are in flight. After
// __syncthreads each nonzero word goes into the row with a shared-memory
// atomic, and after a second __syncthreads the CTA stores the row with
// 16-byte coalesced stores. A row of more than kThreads * kVecPerThread
// vectors (256 chunks) takes further rounds of the same.
//
// Measured and not kept (see PERF.md): a cluster of 8 CTAs per row,
// each with a bulk asynchronous copy of a slab of chunks and remote adds
// through distributed shared memory (5.4 us: the cluster barriers cost
// more than the spread loads save, and the remote adds are generic
// GPU-scope atomics); and one CTA per row with the row's partials in one
// bulk asynchronous copy (3.7 us: one SM's copy engine takes the whole
// 55 KB slab alone).
//
// The launch goes on the caller's stream; the C entry point returns
// cudaGetLastError() so the wrapper can raise on a refused launch.

#include <cuda_runtime.h>

namespace {

constexpr int kWin = 64;                  // words per partial window
constexpr int kVecPerWin = kWin / 4;      // 16-byte vectors per window
constexpr int kVecShift = 4;              // log2(kVecPerWin)
constexpr int kThreads = 1024;            // ops/bitpack.py:MERGE_THREADS
constexpr int kVecPerThread = 4;          // ops/bitpack.py:MERGE_VECS

__device__ __forceinline__ void add_word(unsigned* words, int capw_pad,
                                         long long pos, unsigned v) {
    if (v != 0u && pos >= 0 && pos < capw_pad)
        atomicAdd(words + pos, v);
}

__global__ void __launch_bounds__(kThreads)
merge_windows_kernel(const int* __restrict__ sw,
                     const uint4* __restrict__ partials,
                     unsigned* __restrict__ out, int nch, int capw_pad) {
    // the row's words, rounded up to whole 16-byte vectors
    extern __shared__ uint4 row4[];
    unsigned* words = reinterpret_cast<unsigned*>(row4);
    const int nvec = (capw_pad + 3) / 4;

    const size_t row_c0 = static_cast<size_t>(blockIdx.x) * nch;
    const uint4* prow = partials + row_c0 * kVecPerWin;
    const int* srow = sw + row_c0;
    const int nv = nch * kVecPerWin;

    uint4 q[kVecPerThread];
    int st[kVecPerThread];
    // vector base + k * kThreads + threadIdx.x, for every k at once
    auto load = [&](int base) {
#pragma unroll
        for (int k = 0; k < kVecPerThread; ++k) {
            const int v = base + k * kThreads + threadIdx.x;
            q[k] = v < nv ? prow[v] : make_uint4(0u, 0u, 0u, 0u);
            st[k] = v < nv ? srow[v >> kVecShift] : 0;
        }
    };

    load(0);
    for (int i = threadIdx.x; i < nvec; i += kThreads)
        row4[i] = make_uint4(0u, 0u, 0u, 0u);
    __syncthreads();  // the row is zeroed before any add

    for (int base = 0;;) {
#pragma unroll
        for (int k = 0; k < kVecPerThread; ++k) {
            const uint4 v = q[k];
            if ((v.x | v.y | v.z | v.w) == 0u) continue;
            const int lane = (k * kThreads + threadIdx.x) & (kVecPerWin - 1);
            const long long pos = static_cast<long long>(st[k]) + lane * 4;
            add_word(words, capw_pad, pos, v.x);
            add_word(words, capw_pad, pos + 1, v.y);
            add_word(words, capw_pad, pos + 2, v.z);
            add_word(words, capw_pad, pos + 3, v.w);
        }
        base += kThreads * kVecPerThread;
        if (base >= nv) break;
        load(base);
    }
    __syncthreads();  // every add has landed

    unsigned* dst = out + static_cast<size_t>(blockIdx.x) * capw_pad;
    if ((capw_pad & 3) == 0) {  // rows 16-byte aligned
        uint4* dst4 = reinterpret_cast<uint4*>(dst);
        for (int i = threadIdx.x; i < nvec; i += kThreads) dst4[i] = row4[i];
    } else {
        for (int i = threadIdx.x; i < capw_pad; i += kThreads)
            dst[i] = words[i];
    }
}

}  // namespace

extern "C" int merge_windows_launch(const void* sw, const void* partials,
                                    void* out, int rows, int nch,
                                    int capw_pad, int smem_bytes,
                                    void* stream) {
    if (smem_bytes > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            merge_windows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            smem_bytes);
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    merge_windows_kernel<<<rows, kThreads, smem_bytes,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(sw), static_cast<const uint4*>(partials),
        static_cast<unsigned*>(out), nch, capw_pad);
    return static_cast<int>(cudaGetLastError());
}
