// K2: the H.264 in-loop deblocking filter under the slice-per-MB-row
// schedule, hand-written for Hopper.
//
// Replaces the column loop of ops/deblock.py:deblock_frame_rows_ref,
// which on the TPU is an XLA-lowered lax.scan over MB columns
// (ceracoder_tpu/ops/deblock.py:deblock_frame_rows, no Pallas source).
// With disable_deblocking_filter_idc == 2 and one slice per MB row, MB
// rows are independent, and inside a row the macroblocks are filtered in
// raster order: MB c's vertical edges (its left MB boundary first) filter
// the left MB's columns 13..15 AFTER that MB's own horizontal edges.
//
// Design: one CTA of one warp per MB row, looping over the MB columns.
// Shared memory holds the row's working tile: 16 luma rows of the left
// MB's columns 12..15 (the carry) and this MB's 16 columns, and 8 rows of
// the left MB's chroma columns 6..7 and this MB's 8, for u and v. Threads
// 0..15 own the luma, 16..23 the u and 24..31 the v samples:
//   1. each thread loads its sample row of this MB into the tile;
//   2. vertical edges, one thread per sample row, in order (luma x = 0,
//      4, 8, 12; chroma x = 0, 4);
//   3. __syncwarp, then the inner horizontal edges, one thread per sample
//      column (luma y = 4, 8, 12; chroma y = 4);
//   4. __syncwarp, then each thread writes its row: this MB's columns
//      that no later edge changes (luma 0..12, chroma 0..6), the left MB's
//      now final columns (luma 13..15, chroma 7), and shifts the carry.
// Tile column 0 (the left MB's column 12, chroma 6) is read as p3 (p1)
// and never written. bS is clipped to 1..3 to index tc0; bS 4 takes the
// strong filter; a chroma edge takes the co-located luma bS (chroma x = 4
// reads luma edge 2, chroma y = 4 reads luma edge y = 8, chroma sample r
// reads segment r / 2). Values stay int32 in the tile, as in the plain
// loop, and are clamped to 0..255 only when written out.
//
// Bound: bytes. At 1080p one call reads the three planes (3.13 MB) and
// the bS arrays (0.91 MB) and writes the three planes (3.13 MB): 7.2 MB,
// 2.1 us at 3.35 TB/s. The real floor is the dependency chain: 120 MB
// columns, each a load, 4 vertical and 3 horizontal edge filters one
// after another, and a store, on 68 of the 132 SMs.
//
// The launch goes on the caller's stream; the C entry point returns
// cudaGetLastError() so the wrapper can raise on a refused launch.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kLumaStride = 21;     // 4 carry + 16 + 1 pad (odd: no bank
constexpr int kChromaStride = 11;   // conflicts row- or column-wise)

struct Params {
    int alpha, beta, tc0[3];
};

__device__ __forceinline__ int iabs(int x) { return x < 0 ? -x : x; }
__device__ __forceinline__ int clampi(int x, int lo, int hi) {
    return x < lo ? lo : (x > hi ? hi : x);
}

// One luma edge on 8 samples p3..q3 at s[0], s[d], ..., s[7d]
// (spec 8.7.2.3 / 8.7.2.4); rewrites p2..q2 as ops/deblock.py's
// _filter_luma_edge does.
__device__ __forceinline__ void luma_edge(int* s, int d, int bs,
                                          const Params& pr) {
    const int p3 = s[0], p2 = s[d], p1 = s[2 * d], p0 = s[3 * d];
    const int q0 = s[4 * d], q1 = s[5 * d], q2 = s[6 * d], q3 = s[7 * d];
    const bool filt = iabs(p0 - q0) < pr.alpha && iabs(p1 - p0) < pr.beta
                      && iabs(q1 - q0) < pr.beta && bs > 0;
    if (!filt) return;
    const bool ap_b = iabs(p2 - p0) < pr.beta;
    const bool aq_b = iabs(q2 - q0) < pr.beta;
    if (bs == 4) {
        const bool small = iabs(p0 - q0) < ((pr.alpha >> 2) + 2);
        if (ap_b && small) {
            s[3 * d] = (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3;
            s[2 * d] = (p2 + p1 + p0 + q0 + 2) >> 2;
            s[d] = (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3;
        } else {
            s[3 * d] = (2 * p1 + p0 + q1 + 2) >> 2;
        }
        if (aq_b && small) {
            s[4 * d] = (q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3;
            s[5 * d] = (q2 + q1 + q0 + p0 + 2) >> 2;
            s[6 * d] = (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3;
        } else {
            s[4 * d] = (2 * q1 + q0 + p1 + 2) >> 2;
        }
        return;
    }
    const int tc0 = pr.tc0[clampi(bs, 1, 3) - 1];
    const int tc = tc0 + ap_b + aq_b;
    const int delta = clampi(((q0 - p0) * 4 + (p1 - q1) + 4) >> 3, -tc, tc);
    s[3 * d] = clampi(p0 + delta, 0, 255);
    s[4 * d] = clampi(q0 - delta, 0, 255);
    const int avg = (p0 + q0 + 1) >> 1;
    if (ap_b) s[2 * d] = p1 + clampi((p2 + avg - 2 * p1) >> 1, -tc0, tc0);
    if (aq_b) s[5 * d] = q1 + clampi((q2 + avg - 2 * q1) >> 1, -tc0, tc0);
}

// One chroma edge on p1, p0, q0, q1 at s[0], s[d], s[2d], s[3d]: only p0
// and q0 change (ops/deblock.py's _filter_chroma_edge).
__device__ __forceinline__ void chroma_edge(int* s, int d, int bs,
                                            const Params& pr) {
    const int p1 = s[0], p0 = s[d], q0 = s[2 * d], q1 = s[3 * d];
    const bool filt = iabs(p0 - q0) < pr.alpha && iabs(p1 - p0) < pr.beta
                      && iabs(q1 - q0) < pr.beta && bs > 0;
    if (!filt) return;
    if (bs == 4) {
        s[d] = (2 * p1 + p0 + q1 + 2) >> 2;
        s[2 * d] = (2 * q1 + q0 + p1 + 2) >> 2;
        return;
    }
    const int tc = pr.tc0[clampi(bs, 1, 3) - 1] + 1;
    const int delta = clampi(((q0 - p0) * 4 + (p1 - q1) + 4) >> 3, -tc, tc);
    s[d] = clampi(p0 + delta, 0, 255);
    s[2 * d] = clampi(q0 - delta, 0, 255);
}

__device__ __forceinline__ uint8_t to_u8(int x) {
    return static_cast<uint8_t>(clampi(x, 0, 255));
}

__global__ void __launch_bounds__(32)
h264_deblock_kernel(const uint8_t* __restrict__ y,
                    const uint8_t* __restrict__ u,
                    const uint8_t* __restrict__ v,
                    const int* __restrict__ bs_v,    // (mbh, mbw, 4, 4)
                    const int* __restrict__ bs_h,    // (mbh, mbw, 3, 4)
                    uint8_t* __restrict__ oy, uint8_t* __restrict__ ou,
                    uint8_t* __restrict__ ov, int mbw, Params luma,
                    Params chroma) {
    __shared__ int ty[16 * kLumaStride];
    __shared__ int tc[2][8 * kChromaStride];

    const int row = blockIdx.x;
    const int t = threadIdx.x;
    const int w = mbw * 16, wc = mbw * 8;
    const bool is_luma = t < 16;
    const int comp = (t - 16) >> 3;           // chroma threads: 0 = u, 1 = v
    const int r = is_luma ? t : (t & 7);      // the sample row it owns
    int* lrow = ty + r * kLumaStride;
    int* crow = is_luma ? nullptr : tc[comp] + r * kChromaStride;
    const uint8_t* cin = comp == 0 ? u : v;
    uint8_t* cout = comp == 0 ? ou : ov;
    const size_t yoff = static_cast<size_t>(row * 16 + r) * w;
    const size_t coff = static_cast<size_t>(row * 8 + r) * wc;

    // the carry of the picture's first MB (its left edge has bS 0 in
    // compute_bs; zeros as in the plain loop, whatever bS says)
    if (is_luma) {
        for (int k = 0; k < 4; ++k) lrow[k] = 0;
    } else {
        crow[0] = crow[1] = 0;
    }

    for (int c = 0; c < mbw; ++c) {
        const int* bv = bs_v + (static_cast<size_t>(row) * mbw + c) * 16;
        const int* bh = bs_h + (static_cast<size_t>(row) * mbw + c) * 12;
        // 1 + 2: load this thread's sample row, then its vertical edges
        if (is_luma) {
            const uint8_t* src = y + yoff + c * 16;
#pragma unroll
            for (int k = 0; k < 16; ++k) lrow[4 + k] = src[k];
#pragma unroll
            for (int e = 0; e < 4; ++e)
                luma_edge(lrow + 4 * e, 1, bv[e * 4 + (r >> 2)], luma);
        } else {
            const uint8_t* src = cin + coff + c * 8;
#pragma unroll
            for (int k = 0; k < 8; ++k) crow[2 + k] = src[k];
            chroma_edge(crow, 1, bv[0 * 4 + (r >> 1)], chroma);
            chroma_edge(crow + 4, 1, bv[2 * 4 + (r >> 1)], chroma);
        }
        __syncwarp();
        // 3: the inner horizontal edges, one thread per sample column
        if (is_luma) {
            int* col = ty + 4 + t;            // this MB's column t
#pragma unroll
            for (int e = 0; e < 3; ++e)
                luma_edge(col + 4 * e * kLumaStride, kLumaStride,
                          bh[e * 4 + (t >> 2)], luma);
        } else {
            int* col = tc[comp] + 2 + r;      // this MB's chroma column r
            chroma_edge(col + 2 * kChromaStride, kChromaStride,
                        bh[1 * 4 + (r >> 1)], chroma);
        }
        __syncwarp();
        // 4: write what is final and shift the carry
        if (is_luma) {
            uint8_t* dst = oy + yoff + c * 16;
            if (c > 0) {
                for (int k = 1; k < 4; ++k) dst[k - 4] = to_u8(lrow[k]);
            }
            for (int k = 0; k < 13; ++k) dst[k] = to_u8(lrow[4 + k]);
            for (int k = 0; k < 4; ++k) lrow[k] = lrow[16 + k];
        } else {
            uint8_t* dst = cout + coff + c * 8;
            if (c > 0) dst[-1] = to_u8(crow[1]);
            for (int k = 0; k < 7; ++k) dst[k] = to_u8(crow[2 + k]);
            crow[0] = crow[8];
            crow[1] = crow[9];
        }
        __syncwarp();
    }
    // the last MB's right columns
    if (is_luma) {
        uint8_t* dst = oy + yoff + w;
        for (int k = 1; k < 4; ++k) dst[k - 4] = to_u8(lrow[k]);
    } else {
        cout[coff + wc - 1] = to_u8(crow[1]);
    }
}

}  // namespace

extern "C" int h264_deblock_launch(
        const void* y, const void* u, const void* v, const void* bs_v,
        const void* bs_h, void* oy, void* ou, void* ov, int mbh, int mbw,
        int alpha, int beta, int tc0_1, int tc0_2, int tc0_3, int alpha_c,
        int beta_c, int tc0c_1, int tc0c_2, int tc0c_3, void* stream) {
    const Params luma{alpha, beta, {tc0_1, tc0_2, tc0_3}};
    const Params chroma{alpha_c, beta_c, {tc0c_1, tc0c_2, tc0c_3}};
    h264_deblock_kernel<<<mbh, 32, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(y), static_cast<const uint8_t*>(u),
        static_cast<const uint8_t*>(v), static_cast<const int*>(bs_v),
        static_cast<const int*>(bs_h), static_cast<uint8_t*>(oy),
        static_cast<uint8_t*>(ou), static_cast<uint8_t*>(ov), mbw, luma,
        chroma);
    return static_cast<int>(cudaGetLastError());
}
