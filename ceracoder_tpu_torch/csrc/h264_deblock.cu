// K2: the H.264 in-loop deblocking filter under the slice-per-MB-row
// schedule, hand-written for Hopper.
//
// Replaces the column loop of ops/deblock.py:deblock_frame_rows_ref,
// which on the TPU is an XLA-lowered lax.scan over MB columns
// (ceracoder_tpu/ops/deblock.py:deblock_frame_rows, :213, no Pallas
// source). With disable_deblocking_filter_idc == 2 and one slice per MB
// row, MB rows are independent, and inside a row the macroblocks are
// filtered in raster order: MB c's vertical edges (its left MB boundary
// first) filter the left MB's columns 13..15 AFTER that MB's own
// horizontal edges. So the columns of a row form one serial chain.
//
// Design: one CTA per MB row, of two warps that never wait on each
// other: warp 0 runs the luma chain, warp 1 the chroma chain (u on
// lanes 0..7, v on lanes 8..15), so luma and chroma no longer serialise
// by divergence. Each warp keeps its own ring of kSlots chunks in
// shared memory, a chunk being kChunk MB columns: the chunk's sample
// rows (as bytes, rows padded so that lane loads do not collide in a
// bank) and its bS. The warp fills the ring with cp.async copies two
// chunks ahead of the chain (row_stage.cuh: 16-byte copies where the
// addresses allow it, 8-byte ones for the chroma rows of an odd number
// of MB columns), so the chain itself reads only shared memory and
// registers. Per MB, each chain lane owns one sample row:
//   1. it holds its row (the 4 carried columns of the left MB and this
//      MB's 16) in registers through the four vertical edges;
//   2. it writes the left MB's now final columns 13..15 back into the
//      ring as bytes, and its row into a transposition tile;
//   3. __syncwarp, then each lane takes one sample column from the tile
//      through the inner horizontal edges, writes the column's bytes
//      back into the ring (in place of the source bytes) and the carried
//      columns 12..15 back into the tile;
//   4. __syncwarp, and each lane reads its carry for the next MB.
// Once the first MB of the next chunk has run its left edge, a chunk is
// final: the warp writes it from the ring to the output with 16-byte
// (or narrower, as aligned) stores, and the slot is refilled. The ring
// does not grow with the frame width: a 4K row is 30 chunks through the
// same 4 slots, and the last chunk of a row is ragged.
// Values stay int32 between edges, as in the plain loop, and are
// clamped to 0..255 only when written out. bS is clipped to 1..3 to
// index tc0; bS 4 takes the strong filter; a chroma edge takes the
// co-located luma bS (chroma x = 4 reads luma edge 2, chroma y = 4 reads
// luma edge y = 8, chroma sample r reads segment r / 2). The first MB's
// carry is zeros, whatever its bS.
//
// Bound: bytes. At 1080p one call reads the three planes (3.13 MB) and
// the bS arrays (0.91 MB) and writes the three planes (3.13 MB): 7.2 MB,
// 2.1 us at 3.35 TB/s. The real floor is the luma chain: 120 MB columns,
// each 4 vertical and 3 horizontal edge filters one after another (about
// a hundred instructions each, issued by one warp) and two trips through
// shared memory, on 68 of the 132 SMs. The filters are branch-free
// (per-lane branches, which split the warp between the filters on an
// IDR, were slower on the card); an edge whose bS are all 0 is skipped,
// which pays on P frames, and so is an MB whose bS all are.
//
// The launch goes on the caller's stream; the C entry point returns
// cudaGetLastError() so the wrapper can raise on a refused launch.

#include <cstdint>

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "row_stage.cuh"

namespace {

using row_stage::stage_rows;
using row_stage::store_rows;

constexpr int kChunk = 8;                 // MB columns per ring slot
constexpr int kSlots = 4;                 // ring depth (2 chunks ahead)
constexpr int kLumaPitch = kChunk * 16 + 16;   // bytes per staged row
constexpr int kChromaPitch = kChunk * 8 + 16;
constexpr int kTile = 17;                 // odd tile strides: no bank
constexpr int kTileC = 9;                 // conflicts row- or column-wise

struct Params {
    int alpha, beta, tc0[3];
};

struct __align__(16) LumaSlot {
    uint8_t px[16][kLumaPitch];
    int bv[kChunk][16];                   // bs_v of the chunk's MBs
    int bh[kChunk][12];                   // bs_h
};

struct __align__(16) ChromaSlot {
    uint8_t px[16][kChromaPitch];         // rows 0..7 u, 8..15 v
    int bv[kChunk][16];
    int bh[kChunk][12];
};

__device__ __forceinline__ int iabs(int x) { return x < 0 ? -x : x; }
__device__ __forceinline__ int clampi(int x, int lo, int hi) {
    return x < lo ? lo : (x > hi ? hi : x);
}
__device__ __forceinline__ uint8_t to_u8(int x) {
    return static_cast<uint8_t>(clampi(x, 0, 255));
}
// tc0 for bS clipped to 1..3 (selects, not an indexed load)
__device__ __forceinline__ int tc0_of(const Params& pr, int bs) {
    return bs <= 1 ? pr.tc0[0] : (bs == 2 ? pr.tc0[1] : pr.tc0[2]);
}

// One luma edge on 8 samples p3..q3 at s[0], s[d], ..., s[7d]
// (spec 8.7.2.3 / 8.7.2.4); rewrites p2..q2 as ops/deblock.py's
// _filter_luma_edge does, and as it does without a branch: both filters'
// candidates are computed and the result selected per lane.
__device__ __forceinline__ void luma_edge(int* s, int d, int bs,
                                          const Params& pr) {
    const int p3 = s[0], p2 = s[d], p1 = s[2 * d], p0 = s[3 * d];
    const int q0 = s[4 * d], q1 = s[5 * d], q2 = s[6 * d], q3 = s[7 * d];
    const bool filt = (iabs(p0 - q0) < pr.alpha) & (iabs(p1 - p0) < pr.beta)
                      & (iabs(q1 - q0) < pr.beta) & (bs > 0);
    const bool ap_b = iabs(p2 - p0) < pr.beta;
    const bool aq_b = iabs(q2 - q0) < pr.beta;
    // bS 1..3 (8.7.2.3)
    const int tc0 = tc0_of(pr, bs);
    const int tc = tc0 + ap_b + aq_b;
    const int delta = clampi(((q0 - p0) * 4 + (p1 - q1) + 4) >> 3, -tc, tc);
    const int np0 = clampi(p0 + delta, 0, 255);
    const int nq0 = clampi(q0 - delta, 0, 255);
    const int avg = (p0 + q0 + 1) >> 1;
    const int np1 = ap_b ? p1 + clampi((p2 + avg - 2 * p1) >> 1, -tc0, tc0)
                         : p1;
    const int nq1 = aq_b ? q1 + clampi((q2 + avg - 2 * q1) >> 1, -tc0, tc0)
                         : q1;
    // bS 4 (8.7.2.4)
    const bool small = iabs(p0 - q0) < ((pr.alpha >> 2) + 2);
    const bool sp = ap_b & small, sq = aq_b & small;
    const int s4p0 = sp ? (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3
                        : (2 * p1 + p0 + q1 + 2) >> 2;
    const int s4p1 = sp ? (p2 + p1 + p0 + q0 + 2) >> 2 : p1;
    const int s4p2 = sp ? (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3 : p2;
    const int s4q0 = sq ? (q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3
                        : (2 * q1 + q0 + p1 + 2) >> 2;
    const int s4q1 = sq ? (q2 + q1 + q0 + p0 + 2) >> 2 : q1;
    const int s4q2 = sq ? (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3 : q2;
    const bool is4 = bs == 4;
    s[d] = filt & is4 ? s4p2 : p2;
    s[2 * d] = filt ? (is4 ? s4p1 : np1) : p1;
    s[3 * d] = filt ? (is4 ? s4p0 : np0) : p0;
    s[4 * d] = filt ? (is4 ? s4q0 : nq0) : q0;
    s[5 * d] = filt ? (is4 ? s4q1 : nq1) : q1;
    s[6 * d] = filt & is4 ? s4q2 : q2;
}

// One chroma edge on p1, p0, q0, q1 at s[0], s[d], s[2d], s[3d]: only p0
// and q0 change (ops/deblock.py's _filter_chroma_edge); without a branch.
__device__ __forceinline__ void chroma_edge(int* s, int d, int bs,
                                            const Params& pr) {
    const int p1 = s[0], p0 = s[d], q0 = s[2 * d], q1 = s[3 * d];
    const bool filt = (iabs(p0 - q0) < pr.alpha) & (iabs(p1 - p0) < pr.beta)
                      & (iabs(q1 - q0) < pr.beta) & (bs > 0);
    const int tc = tc0_of(pr, bs) + 1;
    const int delta = clampi(((q0 - p0) * 4 + (p1 - q1) + 4) >> 3, -tc, tc);
    const bool is4 = bs == 4;
    const int np0 = is4 ? (2 * p1 + p0 + q1 + 2) >> 2
                        : clampi(p0 + delta, 0, 255);
    const int nq0 = is4 ? (2 * q1 + q0 + p1 + 2) >> 2
                        : clampi(q0 - delta, 0, 255);
    s[d] = filt ? np0 : p0;
    s[2 * d] = filt ? nq0 : q0;
}

// Whether any of an edge's 4 bS segments (seg, 16-byte aligned) is above
// 0. An edge whose segments are all 0 changes no sample; the test is the
// same for every lane, so skipping on it never splits the warp.
__device__ __forceinline__ bool any_bs(const int* seg) {
    const int4 b = *reinterpret_cast<const int4*>(seg);
    return (b.x | b.y | b.z | b.w) != 0;
}

// The edge at s (stride d), this lane's segment bs, skipped unless nz
// (any_bs of its segments).
template <bool kLuma>
__device__ __forceinline__ void edge(int* s, int d, int bs, bool nz,
                                     const Params& pr) {
    if (!nz) return;
    kLuma ? luma_edge(s, d, bs, pr) : chroma_edge(s, d, bs, pr);
}

// One MB row of one plane group: the luma plane (kRows 16, kMb 16) or
// the two chroma planes stacked (kRows 16, kMb 8).
struct Plane {
    const uint8_t* in[2];
    uint8_t* out[2];
    int w;                                // plane width in bytes
};

// Fill ring slot `slot` with chunk k of MB row `row`: the sample rows
// and the chunk's bS (both bS arrays are whole 16-byte-multiple blocks
// per chunk, at 64 and 48 bytes per MB).
template <typename Slot, int kMb>
__device__ __forceinline__ void issue_chunk(Slot& slot, const Plane& pl,
                                            const int* bs_v, const int* bs_h,
                                            int row, int mbw, int k,
                                            int lane) {
    const int c0 = k * kChunk, n = min(kChunk, mbw - c0);
    constexpr int kComps = kMb == 16 ? 1 : 2;
    constexpr int kRows = kMb == 16 ? 16 : 8;
    for (int comp = 0; comp < kComps; ++comp) {
        stage_rows(&slot.px[comp * kRows][0], sizeof(slot.px[0]),
                   pl.in[comp] + static_cast<size_t>(row * kRows) * pl.w
                       + c0 * kMb,
                   pl.w, kRows, n * kMb, lane);
    }
    const size_t mb0 = static_cast<size_t>(row) * mbw + c0;
    stage_rows(reinterpret_cast<uint8_t*>(slot.bv),
               static_cast<int>(sizeof(slot.bv)),
               reinterpret_cast<const uint8_t*>(bs_v + mb0 * 16), 0, 1,
               n * 64, lane);
    stage_rows(reinterpret_cast<uint8_t*>(slot.bh),
               static_cast<int>(sizeof(slot.bh)),
               reinterpret_cast<const uint8_t*>(bs_h + mb0 * 12), 0, 1,
               n * 48, lane);
}

template <typename Slot, int kMb>
__device__ __forceinline__ void write_chunk(const Slot& slot,
                                            const Plane& pl, int row,
                                            int mbw, int k, int lane) {
    const int c0 = k * kChunk, n = min(kChunk, mbw - c0);
    constexpr int kComps = kMb == 16 ? 1 : 2;
    constexpr int kRows = kMb == 16 ? 16 : 8;
    for (int comp = 0; comp < kComps; ++comp) {
        store_rows(pl.out[comp] + static_cast<size_t>(row * kRows) * pl.w
                       + c0 * kMb,
                   pl.w, &slot.px[comp * kRows][0], sizeof(slot.px[0]),
                   kRows, n * kMb, lane);
    }
}

// The luma chain of one MB: lane r & 15 owns sample row r (vertical
// edges) and then sample column r (horizontal edges). Lanes 16..31
// repeat lanes 0..15 and write nothing (a repeat lane may still read a
// tile column while its owner writes it back). The transposition tile
// alternates between two buffers by MB, so no lane's write for MB c can
// meet another lane's carry read of MB c - 1.
__device__ __forceinline__ void luma_mb(LumaSlot* ring,
                                        int (*tiles)[16][kTile], int* carry,
                                        int c, int lane, const Params& pr) {
    const int r = lane & 15;
    const bool own = lane < 16;
    int (*tile)[kTile] = tiles[c & 1];
    LumaSlot& sl = ring[(c / kChunk) % kSlots];
    const int m = c % kChunk;
    // which of the 4 vertical and 3 horizontal edges have a bS above 0,
    // read before the chain reaches them; an MB with none changes no
    // sample
    bool nz[7];
#pragma unroll
    for (int e = 0; e < 7; ++e)
        nz[e] = any_bs(e < 4 ? &sl.bv[m][4 * e] : &sl.bh[m][4 * (e - 4)]);
    const bool any = nz[0] | nz[1] | nz[2] | nz[3] | nz[4] | nz[5] | nz[6];
    int x[20];
#pragma unroll
    for (int k = 0; k < 4; ++k) x[k] = carry[k];
    const uint4 raw = *reinterpret_cast<const uint4*>(&sl.px[r][m * 16]);
    const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int k = 0; k < 16; ++k) x[4 + k] = (words[k >> 2] >> (8 * (k & 3))) & 255;
    if (!any) {           // the ring already holds this MB's output bytes
#pragma unroll
        for (int k = 0; k < 4; ++k) carry[k] = x[16 + k];
        return;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e)
        edge<true>(x + 4 * e, 1, sl.bv[m][e * 4 + (r >> 2)], nz[e], pr);
    if (c > 0 && own) {                   // the left MB's final columns
        LumaSlot& ls = ring[((c - 1) / kChunk) % kSlots];
        uint8_t* dst = &ls.px[r][((c - 1) % kChunk) * 16 + 13];
#pragma unroll
        for (int k = 0; k < 3; ++k) dst[k] = to_u8(x[1 + k]);
    }
    if (own) {
#pragma unroll
        for (int k = 0; k < 16; ++k) tile[r][k] = x[4 + k];
    }
    __syncwarp();
    int col[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) col[k] = tile[k][r];
#pragma unroll
    for (int e = 0; e < 3; ++e)
        edge<true>(col + 4 * e, 1, sl.bh[m][e * 4 + (r >> 2)], nz[4 + e], pr);
    if (own) {
#pragma unroll
        for (int k = 0; k < 16; ++k) sl.px[k][m * 16 + r] = to_u8(col[k]);
        if (r >= 12) {
#pragma unroll
            for (int k = 0; k < 16; ++k) tile[k][r] = col[k];
        }
    }
    __syncwarp();
#pragma unroll
    for (int k = 0; k < 4; ++k) carry[k] = tile[r][12 + k];
}

// The chroma chain of one MB: lane & 15 owns sample row (lane & 7) of
// component (lane >> 3) & 1, then that component's sample column; lanes
// 16..31 repeat lanes 0..15 and write nothing.
__device__ __forceinline__ void chroma_mb(ChromaSlot* ring,
                                          int (*tiles)[2][8][kTileC],
                                          int* carry, int c, int lane,
                                          const Params& pr) {
    const int r = lane & 7, comp = (lane >> 3) & 1, pr_row = comp * 8 + r;
    const bool own = lane < 16;
    int (*tile)[8][kTileC] = tiles[c & 1];
    ChromaSlot& sl = ring[(c / kChunk) % kSlots];
    const int m = c % kChunk;
    int x[10];
    x[0] = carry[0];
    x[1] = carry[1];
    const uint2 raw = *reinterpret_cast<const uint2*>(&sl.px[pr_row][m * 8]);
#pragma unroll
    for (int k = 0; k < 8; ++k)
        x[2 + k] = ((k < 4 ? raw.x : raw.y) >> (8 * (k & 3))) & 255;
    // the co-located luma edges: vertical 0 and 2, horizontal 1
    const bool nz[3] = {any_bs(&sl.bv[m][0]), any_bs(&sl.bv[m][8]),
                        any_bs(&sl.bh[m][4])};
    if (!(nz[0] | nz[1] | nz[2])) {
        carry[0] = x[8];
        carry[1] = x[9];
        return;
    }
    edge<false>(x, 1, sl.bv[m][r >> 1], nz[0], pr);
    edge<false>(x + 4, 1, sl.bv[m][2 * 4 + (r >> 1)], nz[1], pr);
    if (c > 0 && own) {
        ChromaSlot& ls = ring[((c - 1) / kChunk) % kSlots];
        ls.px[pr_row][((c - 1) % kChunk) * 8 + 7] = to_u8(x[1]);
    }
    if (own) {
#pragma unroll
        for (int k = 0; k < 8; ++k) tile[comp][r][k] = x[2 + k];
    }
    __syncwarp();
    int col[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) col[k] = tile[comp][k][r];
    edge<false>(col + 2, 1, sl.bh[m][1 * 4 + (r >> 1)], nz[2], pr);
    if (own) {
#pragma unroll
        for (int k = 0; k < 8; ++k)
            sl.px[comp * 8 + k][m * 8 + r] = to_u8(col[k]);
        if (r >= 6) {
            tile[comp][3][r] = col[3];
            tile[comp][4][r] = col[4];
        }
    }
    __syncwarp();
    carry[0] = tile[comp][r][6];
    carry[1] = tile[comp][r][7];
}

// One warp's whole MB row: the ring is filled two chunks ahead; a chunk
// is written out once the next chunk's first MB has run its left edge.
template <typename Slot, int kMb, typename Tile, typename MbFn>
__device__ __forceinline__ void run_row(Slot* ring, Tile tile,
                                        const Plane& pl, const int* bs_v,
                                        const int* bs_h, int row, int mbw,
                                        int lane, MbFn mb_fn) {
    const int nch = (mbw + kChunk - 1) / kChunk;
    for (int k = 0; k < kSlots - 1; ++k) {
        if (k < nch)
            issue_chunk<Slot, kMb>(ring[k], pl, bs_v, bs_h, row, mbw, k,
                                   lane);
        __pipeline_commit();
    }
    int carry[4] = {0, 0, 0, 0};
    for (int k = 0; k < nch; ++k) {
        if (k >= 1) {                     // slot of chunk k - 2 is free
            __syncwarp();                 // (its write-out has read it)
            const int kk = k + kSlots - 2;
            if (kk < nch)
                issue_chunk<Slot, kMb>(ring[kk % kSlots], pl, bs_v, bs_h,
                                       row, mbw, kk, lane);
            __pipeline_commit();
        }
        __pipeline_wait_prior(kSlots - 2);
        __syncwarp();
        const int n = min(kChunk, mbw - k * kChunk);
        for (int m = 0; m < n; ++m) {
            mb_fn(ring, tile, carry, k * kChunk + m, lane);
            if (m == 0 && k > 0)
                write_chunk<Slot, kMb>(ring[(k - 1) % kSlots], pl, row, mbw,
                                       k - 1, lane);
        }
    }
    __syncwarp();
    write_chunk<Slot, kMb>(ring[(nch - 1) % kSlots], pl, row, mbw, nch - 1,
                           lane);
}

__global__ void __launch_bounds__(64)
h264_deblock_kernel(const uint8_t* __restrict__ y,
                    const uint8_t* __restrict__ u,
                    const uint8_t* __restrict__ v,
                    const int* __restrict__ bs_v,    // (mbh, mbw, 4, 4)
                    const int* __restrict__ bs_h,    // (mbh, mbw, 3, 4)
                    uint8_t* __restrict__ oy, uint8_t* __restrict__ ou,
                    uint8_t* __restrict__ ov, int mbw, Params luma,
                    Params chroma) {
    __shared__ __align__(16) LumaSlot luma_ring[kSlots];
    __shared__ __align__(16) ChromaSlot chroma_ring[kSlots];
    __shared__ int luma_tile[2][16][kTile];
    __shared__ int chroma_tile[2][2][8][kTileC];

    const int row = blockIdx.x;
    const int lane = threadIdx.x & 31;
    if (threadIdx.x < 32) {
        const Plane pl{{y, nullptr}, {oy, nullptr}, mbw * 16};
        run_row<LumaSlot, 16>(
            luma_ring, luma_tile, pl, bs_v, bs_h, row, mbw, lane,
            [&](LumaSlot* ring, int (*tile)[16][kTile], int* carry, int c,
                int l) { luma_mb(ring, tile, carry, c, l, luma); });
    } else {
        const Plane pl{{u, v}, {ou, ov}, mbw * 8};
        run_row<ChromaSlot, 8>(
            chroma_ring, chroma_tile, pl, bs_v, bs_h, row, mbw, lane,
            [&](ChromaSlot* ring, int (*tile)[2][8][kTileC], int* carry,
                int c, int l) { chroma_mb(ring, tile, carry, c, l, chroma); });
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
    h264_deblock_kernel<<<mbh, 64, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(y), static_cast<const uint8_t*>(u),
        static_cast<const uint8_t*>(v), static_cast<const int*>(bs_v),
        static_cast<const int*>(bs_h), static_cast<uint8_t*>(oy),
        static_cast<uint8_t*>(ou), static_cast<uint8_t*>(ov), mbw, luma,
        chroma);
    return static_cast<int>(cudaGetLastError());
}
