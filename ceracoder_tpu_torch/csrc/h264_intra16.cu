// K3: the H.264 Intra_16x16 macroblock coder over the MB columns of a
// frame, one slice per MB row, hand-written for Hopper.
//
// Replaces the column loop of ops/intra.py:_encode_mb_cols_ref, which
// serves both the IDR frame (encode_frame_i16_rows) and the intra-in-P
// scan (ops/inter.py:_intra_fallback). On the TPU both are XLA-lowered
// lax.scans over MB columns (ceracoder_tpu/ops/intra.py:152
// encode_frame_i16_rows, ceracoder_tpu/ops/inter.py:570 _intra_fallback,
// no Pallas source). Per MB, in order:
//   - luma: H or DC prediction from the left MB's reconstructed right
//     column, whichever has the smaller SAD (a tie goes to DC); the 4x4
//     forward core transform of the residual, the Hadamard of the 16 DCs
//     (floored by 1 bit), quant with intra rounding (the DCs with qbits+1
//     and twice the offset), dequant, the inverse Hadamard and DC scaling,
//     the inverse core transform and the reconstruction clamped to 0..255;
//   - chroma: H or DC prediction chosen on the summed SAD of u and v, then
//     each component through the 2x2 DC path at qp_c.
// The right column of the reconstruction is the next MB's left column; in
// scan mode (an is_intra mask and the inter reconstruction given) the
// carry is the intra reconstruction where is_intra is set and the inter
// one elsewhere. Column 0 sees a left column of 128.
//
// Design: the serial work and the parallel work are two kernels, one
// after the other on the caller's stream.
//   (a) h264_intra16_carry_kernel, one CTA of four warps per MB row,
//       serial over the columns, computes only what the next MB needs: the
//       two mode decisions, the 16 luma and 2x4 chroma DC paths and the
//       right-hand 4x4 blocks' reconstruction (luma block column 3, chroma
//       1), which is the next left column. It writes each MB's left column
//       (16 luma + 8 u + 8 v samples) to a scratch buffer and the modes to
//       their outputs. Warp 0 runs the luma chain and warp 1 the chroma
//       chain; they never wait on each other, and each chain runs on
//       shuffles alone, with no CTA-wide barrier between its stages. Lane
//       y & 15 of the luma chain owns sample row y, 4x4 block y for the DC
//       path, and row y & 3 of right-hand block y >> 2; the chroma lanes
//       likewise per component. Everything that depends only on the source
//       is off the chain: warps 2 and 3, one per chain, stage the row's
//       chunks (the source, and in scan mode the inter reconstruction and
//       is_intra) into a ring of shared-memory slots with cp.async
//       (row_stage.cuh) and compute each MB's block sums (the DC of a
//       block's forward transform is the block's sum; the prediction's is 4
//       * its left samples' sum for H, 16 * the DC value) and its
//       right-hand blocks' coefficients (the prediction's transform is zero
//       outside coefficient column 0 for H and outside the DC for DC, so
//       only the column-0 coefficients wait for the left column), one chunk
//       ahead of the chain, handing each chunk over at a named barrier. The
//       chain reads only shared memory and registers.
//   (b) h264_intra16_code_kernel, one warp per MB, all independent (8,160
//       warps in 1,020 CTAs at 1080p), codes each MB from its stored left
//       column and modes: levels and reconstruction. Luma lane l takes two
//       rows of 4x4 block l / 2, chroma lane l one row of a block; rows,
//       DCs and inverse-transform rows move between lanes by shuffles, so
//       no MB waits at a CTA barrier.
// Both kernels take their arithmetic from one set of __device__ functions
// below (prediction, the transform of the source and of the prediction,
// quant, dequant, the Hadamards, the inverse transform, reconstruction),
// so the carried column and the stored reconstruction cannot disagree.
// The transform of the residual is taken as that of the source less that
// of the prediction: the same integers, as the transform is linear and
// nothing overflows (below).
//
// int32 ranges (a residual is at most 255 in magnitude): a core transform
// coefficient is at most 36 * 255 = 9180, a luma DC after the floored
// Hadamard 32640, so quant's |w| * MF stays under 4.3e8 and its offset
// under 5.6e6 at qp 51; a dequantized coefficient is at most 1.1e5 at
// qp 0 and 5.8e4 at qp 51; the dequantized luma DC at most 3.0e7 (qp 0)
// and the chroma DC 2.1e6 (qp_c 0 and 51): far inside int32 throughout.
// The source's transform alone is at most 9180 too (its samples are
// 0..255), and the prediction's at most 16 * 255. Shifts left are written
// as products, and every right shift of a negative value is arithmetic,
// as torch's.
//
// Bound: bytes. At 1080p one IDR call reads the three planes (3.13 MB)
// and writes the reconstruction (3.13 MB) and the levels and modes
// (6.28 MB): 12.5 MB, 3.7 us at 3.35 TB/s; the scan also reads the inter
// reconstruction (3.13 MB). The scratch (32 B per MB) is not counted.
// The real floor is the carry chain: 120 MB columns one after another,
// each about a dozen rounds of shuffles (the left column's sums, the
// SADs, the Hadamards, one column of the inverse transform) in one warp.
//
// The C entry points return cudaGetLastError() after each launch so the
// wrapper can raise on a refused launch.

#include <cstdint>

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "row_stage.cuh"

namespace {

using row_stage::stage_bytes;
using row_stage::stage_rows;

constexpr int kChunk = 8;                 // MB columns per ring slot
constexpr int kSlots = 3;                 // source ring depth
constexpr int kLumaPitch = kChunk * 16 + 16;   // bytes per staged row
constexpr int kChromaPitch = kChunk * 8 + 16;
constexpr int kScratch = 32;              // bytes per MB: 16 y, 8 u, 8 v

// ops/transform.py: _MF_CLASS, _V_CLASS, _POS_CLASS and the inverse of
// ZIGZAG4x4 (raster position -> zigzag index)
__constant__ int kMF[6][3] = {{13107, 5243, 8066}, {11916, 4660, 7490},
                              {10082, 4194, 6554}, {9362, 3647, 5825},
                              {8192, 3355, 5243},  {7282, 2893, 4559}};
__constant__ int kV[6][3] = {{10, 16, 13}, {11, 18, 14}, {13, 20, 16},
                             {14, 23, 18}, {16, 25, 20}, {18, 29, 23}};
__constant__ int kPosClass[16] = {0, 2, 0, 2, 2, 1, 2, 1,
                                  0, 2, 0, 2, 2, 1, 2, 1};
__constant__ int kInvZigzag[16] = {0, 1, 5, 6, 2, 4, 7, 12,
                                   3, 8, 11, 13, 9, 10, 14, 15};
// rows of the forward core transform Cf and of the 4x4 Hadamard
__constant__ int kCf[4][4] = {{1, 1, 1, 1}, {2, 1, -1, -2},
                              {1, -1, -1, 1}, {1, -2, 2, -1}};
__constant__ int kH4[4][4] = {{1, 1, 1, 1}, {1, 1, -1, -1},
                              {1, -1, -1, 1}, {1, -1, 1, -1}};

// ---------------------------------------------------------------------------
// The arithmetic both kernels share
// ---------------------------------------------------------------------------

struct Row4 {
    int a, b, c, d;
};

__device__ __forceinline__ Row4 cf_row(int i) {
    return {kCf[i][0], kCf[i][1], kCf[i][2], kCf[i][3]};
}
__device__ __forceinline__ Row4 h4_row(int i) {
    return {kH4[i][0], kH4[i][1], kH4[i][2], kH4[i][3]};
}
__device__ __forceinline__ int dot4(const Row4& r, int x0, int x1, int x2,
                                    int x3) {
    return r.a * x0 + r.b * x1 + r.c * x2 + r.d * x3;
}
__device__ __forceinline__ int dot4(const Row4& r, const Row4& x) {
    return dot4(r, x.a, x.b, x.c, x.d);
}

__device__ __forceinline__ int iabs(int x) { return x < 0 ? -x : x; }
__device__ __forceinline__ int isign(int x) { return (x > 0) - (x < 0); }

// The quantizer of one qp: qbits, the intra offset, qp % 6 and qp / 6.
struct Quant {
    int qbits, f, r, m;
};
__device__ __forceinline__ Quant make_quant(int qp) {
    const int qbits = 15 + qp / 6;
    return {qbits, (1 << qbits) / 3, qp % 6, qp / 6};
}
// MF and V of raster position pos
__device__ __forceinline__ int mf_of(const Quant& q, int pos) {
    return kMF[q.r][kPosClass[pos]];
}
__device__ __forceinline__ int v_of(const Quant& q, int pos) {
    return kV[q.r][kPosClass[pos]];
}

// quant4 (intra rounding) of an AC coefficient with multiplier mf
__device__ __forceinline__ int quant_ac(int w, int mf, const Quant& q) {
    return isign(w) * ((iabs(w) * mf + q.f) >> q.qbits);
}
// quant_dc4 / quant_dc2: MF(0,0), qbits + 1, twice the intra offset
__device__ __forceinline__ int quant_dc(int w, const Quant& q) {
    return isign(w) * ((iabs(w) * kMF[q.r][0] + 2 * q.f) >> (q.qbits + 1));
}
__device__ __forceinline__ int dequant_ac(int z, int v, const Quant& q) {
    return z * v * (1 << q.m);
}
// dequant_dc4: the inverse Hadamard's output f scaled, rounded by qp / 6
__device__ __forceinline__ int dequant_dc_luma(int f, const Quant& q) {
    const int ls = kV[q.r][0] * 16;
    return q.m >= 6 ? f * ls * (1 << (q.m - 6))
                    : (f * ls + (1 << (5 - q.m))) >> (6 - q.m);
}
// dequant_dc2
__device__ __forceinline__ int dequant_dc_chroma(int f, const Quant& q) {
    return (f * kV[q.r][0] * 16 * (1 << q.m)) >> 5;
}

// Coefficient (i, j) of the forward core transform Cf X Cf^T of the 4x4
// block x (row stride 4), ci and cj being rows i and j of Cf. With ci =
// cj = row 0 it is the block's sum.
__device__ __forceinline__ int fdct_coef(const int* x, const Row4& ci,
                                         const Row4& cj) {
    return dot4(ci, dot4(cj, x[0], x[1], x[2], x[3]),
                dot4(cj, x[4], x[5], x[6], x[7]),
                dot4(cj, x[8], x[9], x[10], x[11]),
                dot4(cj, x[12], x[13], x[14], x[15]));
}

// Coefficient (i, j) of the forward transform of a 4x4 block of the
// prediction, left4 being the left samples of its rows: H predicts row k
// as left4[k], so only coefficient column 0 is non-zero (Cf's rows 1..3
// sum to 0): 4 * (row i of Cf) . left4; DC predicts dcv everywhere: only
// the DC, 16 * dcv.
__device__ __forceinline__ int pred_coef(bool use_h, const Row4& left4,
                                         int dcv, const Row4& ci, int i,
                                         int j) {
    if (use_h) return j == 0 ? 4 * dot4(ci, left4) : 0;
    return i == 0 && j == 0 ? 16 * dcv : 0;
}

// The luma DC prediction (the left column's 16 samples) and the chroma
// one of a 4-row half (its 4 left samples)
__device__ __forceinline__ int luma_dc(int left_sum) {
    return (left_sum + 8) >> 4;
}
__device__ __forceinline__ int chroma_dc(int left4_sum) {
    return (left4_sum + 2) >> 2;
}

// Output (p, q) of the 2x2 Hadamard of d0..d3 (raster order)
__device__ __forceinline__ int h2(int d0, int d1, int d2, int d3, int p,
                                  int q) {
    const int sq = q ? -1 : 1, sp = p ? -1 : 1;
    return (d0 + sq * d1) + sp * (d2 + sq * d3);
}

// one 4-point inverse butterfly (spec 8.5.12.2) on d0..d3, output k
__device__ __forceinline__ int idct_1d(int d0, int d1, int d2, int d3,
                                       int k) {
    const int e0 = d0 + d2, e1 = d0 - d2;
    const int e2 = (d1 >> 1) - d3, e3 = d1 + (d3 >> 1);
    return k == 0 ? e0 + e3 : k == 1 ? e1 + e2 : k == 2 ? e1 - e2 : e0 - e3;
}

__device__ __forceinline__ int recon(int pred, int h) {
    return min(max(pred + ((h + 32) >> 6), 0), 255);
}

// ---------------------------------------------------------------------------
// (a) The carry kernel
// ---------------------------------------------------------------------------

struct __align__(16) LumaSlot {
    uint8_t px[16][kLumaPitch];           // source rows
    uint8_t inter[16][kLumaPitch];        // inter reconstruction (scan)
    uint8_t intra[16];                    // is_intra words (scan)
    int intra_at;                         // first MB's byte in intra
};

struct __align__(16) ChromaSlot {
    uint8_t px[16][kChromaPitch];         // rows 0..7 u, 8..15 v
    uint8_t inter[16][kChromaPitch];
    uint8_t intra[16];
    int intra_at;
};

struct Planes {
    const uint8_t* in[2];                 // source (y, or u and v)
    const uint8_t* inter[2];              // inter reconstruction or null
    const uint8_t* is_intra;              // (mbh, mbw) or null
    int w;                                // plane width in bytes
};

template <typename Slot, int kMb>
__device__ __forceinline__ void issue_chunk(Slot& slot, const Planes& pl,
                                            int row, int mbw, int k,
                                            int lane) {
    const int c0 = k * kChunk, n = min(kChunk, mbw - c0);
    constexpr int kComps = kMb == 16 ? 1 : 2;
    constexpr int kRows = kMb == 16 ? 16 : 8;
    for (int comp = 0; comp < kComps; ++comp) {
        const size_t off = static_cast<size_t>(row * kRows) * pl.w + c0 * kMb;
        stage_rows(&slot.px[comp * kRows][0], sizeof(slot.px[0]),
                   pl.in[comp] + off, pl.w, kRows, n * kMb, lane);
        if (pl.is_intra != nullptr)
            stage_rows(&slot.inter[comp * kRows][0], sizeof(slot.inter[0]),
                       pl.inter[comp] + off, pl.w, kRows, n * kMb, lane);
    }
    if (pl.is_intra != nullptr)
        slot.intra_at = stage_bytes(
            slot.intra, pl.is_intra + static_cast<size_t>(row) * mbw + c0, n,
            lane);
}

// The rendezvous of a chain warp and its producer warp: named barrier
// `id` over their 64 threads, which also orders their shared-memory
// accesses.
__device__ __forceinline__ void pair_sync(int id) {
    asm volatile("bar.sync %0, 64;" :: "r"(id) : "memory");
}

__device__ __forceinline__ uint32_t load_u32(const uint8_t* p) {
    return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ uint32_t splat(int v) {
    return static_cast<uint32_t>(v) * 0x01010101u;
}
__device__ __forceinline__ Row4 shfl4(int v, int base) {
    return {__shfl_sync(0xffffffffu, v, base),
            __shfl_sync(0xffffffffu, v, base + 1),
            __shfl_sync(0xffffffffu, v, base + 2),
            __shfl_sync(0xffffffffu, v, base + 3)};
}
// sum over the 16 lanes of a half warp, of two 16-bit counts packed in
// one word (each sum at most 256 * 255 = 65280: no carry between them)
__device__ __forceinline__ uint32_t half_warp_sum(uint32_t v) {
#pragma unroll
    for (int o = 1; o < 16; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}
// the 16 samples of a 4x4 block from four staged rows
__device__ __forceinline__ void block_samples(int* x, const uint8_t* p,
                                              int pitch) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        const uint32_t wd = load_u32(p + k * pitch);
#pragma unroll
        for (int m = 0; m < 4; ++m) x[4 * k + m] = (wd >> (8 * m)) & 255;
    }
}

// What the luma chain of an MB needs from the source alone, per lane y
// (P = y >> 2, i = y & 3), computed by the producer warp; the chain
// reads the source row itself from the ring.
struct LumaPre {
    int bsum;           // sum of 4x4 block y = (P, i)
    int ws0;            // coefficient (i, 0) of the source's block (P, 3)
    int d1, d2, d3;     // dequantized coefficients (i, 1..3) of block (P, 3)
    int inter_intra;    // inter recon of row y, column 15 | is_intra << 8
};

__device__ __forceinline__ LumaPre luma_pre(const LumaSlot& sl, int m,
                                            int y, bool scan,
                                            const Quant& q) {
    const int P = y >> 2, i = y & 3;
    LumaPre o;
    o.bsum = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k)
        o.bsum += __vsadu4(load_u32(&sl.px[4 * P + k][m * 16 + 4 * i]), 0);
    int x[16];
    block_samples(x, &sl.px[4 * P][m * 16 + 12], kLumaPitch);
    const Row4 ci = cf_row(i);
    o.ws0 = fdct_coef(x, ci, cf_row(0));
    int d[3];
#pragma unroll
    for (int j = 1; j < 4; ++j) {
        // the prediction's coefficient (i, j >= 1) is 0 in both modes
        const int z = quant_ac(fdct_coef(x, ci, cf_row(j)), mf_of(q, 4 * i + j), q);
        d[j - 1] = dequant_ac(z, v_of(q, 4 * i + j), q);
    }
    o.d1 = d[0];
    o.d2 = d[1];
    o.d3 = d[2];
    // (without a scan these bytes were never staged and are not used)
    const bool intra = !scan || sl.intra[(sl.intra_at + m) & 15] != 0;
    o.inter_intra = sl.inter[y][m * 16 + 15] | (intra ? 256 : 0);
    return o;
}

struct ChromaPre {
    int bsum[4];        // the component's four 4x4 block sums (raster)
    int ws0, d1, d2, d3;   // block (G, 1), row i: as LumaPre
    int inter_intra;
    int pad;
};

__device__ __forceinline__ ChromaPre chroma_pre(const ChromaSlot& sl, int m,
                                                int cc, int r, bool scan,
                                                const Quant& q) {
    const int G = r >> 2, i = r & 3, pr = cc * 8 + r;
    ChromaPre o;
    const uint2 raw = *reinterpret_cast<const uint2*>(&sl.px[pr][m * 8]);
    // block sums: this row's two halves, summed over the 4 rows of its
    // half (lanes G*4 .. G*4+3), then the other half's from lane ^ 4
    uint32_t s = __vsadu4(raw.x, 0) | (__vsadu4(raw.y, 0) << 16);
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    const uint32_t so = __shfl_xor_sync(0xffffffffu, s, 4);
    const uint32_t top = G ? so : s, bottom = G ? s : so;
    o.bsum[0] = top & 0xffff;
    o.bsum[1] = top >> 16;
    o.bsum[2] = bottom & 0xffff;
    o.bsum[3] = bottom >> 16;
    int x[16];
    block_samples(x, &sl.px[cc * 8 + 4 * G][m * 8 + 4], kChromaPitch);
    const Row4 ci = cf_row(i);
    o.ws0 = fdct_coef(x, ci, cf_row(0));
    int d[3];
#pragma unroll
    for (int j = 1; j < 4; ++j) {
        const int z = quant_ac(fdct_coef(x, ci, cf_row(j)), mf_of(q, 4 * i + j), q);
        d[j - 1] = dequant_ac(z, v_of(q, 4 * i + j), q);
    }
    o.d1 = d[0];
    o.d2 = d[1];
    o.d3 = d[2];
    const bool intra = !scan || sl.intra[(sl.intra_at + m) & 15] != 0;
    o.inter_intra = sl.inter[pr][m * 8 + 7] | (intra ? 256 : 0);
    o.pad = 0;
    return o;
}

// The producer warp of a chain: it stages the row's chunks (kSlots
// slots, refilled two chunks ahead) and computes each chunk's Pre into
// one of two slots, chunk k + 1 while the chain runs chunk k; one
// rendezvous per chunk hands it over.
template <typename Slot, int kMb, typename Pre, typename PreFn>
__device__ __forceinline__ void produce(Slot* ring, Pre (*pre)[kChunk][16],
                                        const Planes& pl, int row, int mbw,
                                        int nch, int lane, int bar,
                                        PreFn pre_fn) {
    for (int k = 0; k < kSlots; ++k) {
        if (k < nch) issue_chunk<Slot, kMb>(ring[k], pl, row, mbw, k, lane);
        __pipeline_commit();
    }
    __pipeline_wait_prior(kSlots - 1);
    for (int k = 0; k < nch; ++k) {
        if (k > 0) {
            // the chain is done with chunk k - 2 (it has passed the last
            // rendezvous): refill its slot
            const int kk = k - 2 + kSlots;
            if (k >= 2 && kk < nch)
                issue_chunk<Slot, kMb>(ring[kk % kSlots], pl, row, mbw, kk,
                                       lane);
            __pipeline_commit();
            __pipeline_wait_prior(kSlots - 2);
        }
        __syncwarp();
        const int n = min(kChunk, mbw - k * kChunk);
        for (int m = 0; m < n; ++m) {
            const Pre p = pre_fn(ring[k % kSlots], m);
            if (lane < 16) pre[k & 1][m][lane] = p;
        }
        pair_sync(bar);
    }
}

// The luma chain of one MB: from the left column (lane y holds sample
// y) to the next one. Writes the left column and the mode.
__device__ __forceinline__ int luma_carry(int left, const LumaPre& pre,
                                          const uint4& row_px, int y,
                                          const Quant& q, int mf_i0,
                                          int v_i0, uint8_t* scratch_mb,
                                          uint8_t* mode, bool own) {
    const int P = y >> 2, i = y & 3;
    if (own) scratch_mb[y] = static_cast<uint8_t>(left);
    // the left samples of this lane's 4-row group, and the DC prediction
    const Row4 left4 = shfl4(left, 4 * P);
    const int gsum = left4.a + left4.b + left4.c + left4.d;
    int total = gsum + __shfl_xor_sync(0xffffffffu, gsum, 4);
    total += __shfl_xor_sync(0xffffffffu, total, 8);
    const int dc = luma_dc(total);
    // SADs of H (low half) and DC (high half), summed over the 16 rows
    const uint32_t px4[4] = {row_px.x, row_px.y, row_px.z, row_px.w};
    uint32_t sad = 0, sad_dc = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        sad += __vsadu4(px4[k], splat(left));
        sad_dc += __vsadu4(px4[k], splat(dc));
    }
    const uint32_t both = half_warp_sum(sad | (sad_dc << 16));
    const bool use_h = (both & 0xffff) < (both >> 16);
    if (y == 0 && own) *mode = use_h ? 1 : 2;        // LUMA_H / LUMA_DC
    // the DC path: lane y holds the DC of block y = (P, i)
    const int dcw = pre.bsum - pred_coef(use_h, left4, dc, cf_row(0), 0, 0);
    const int t = dot4(h4_row(i), shfl4(dcw, 4 * P));         // (P, i)
    const int acc = dot4(h4_row(P), __shfl_sync(0xffffffffu, t, i),
                         __shfl_sync(0xffffffffu, t, 4 + i),
                         __shfl_sync(0xffffffffu, t, 8 + i),
                         __shfl_sync(0xffffffffu, t, 12 + i));
    const int zdc = quant_dc(acc >> 1, q);                    // (P, i)
    // the inverse Hadamard's column 3 only: u_P, then (P, 3)
    const int u = dot4(h4_row(3), shfl4(zdc, 4 * P));
    const int f = dot4(h4_row(P), __shfl_sync(0xffffffffu, u, 0),
                       __shfl_sync(0xffffffffu, u, 4),
                       __shfl_sync(0xffffffffu, u, 8),
                       __shfl_sync(0xffffffffu, u, 12));
    // right-hand block (P, 3), row i: coefficient (i, 0) (the DC for
    // i = 0), then the row's inverse butterfly at column 3 and the
    // column's at row i
    const int w = pre.ws0 - pred_coef(use_h, left4, dc, cf_row(i), i, 0);
    const int d_ac = dequant_ac(quant_ac(w, mf_i0, q), v_i0, q);
    const int d0 = i == 0 ? dequant_dc_luma(f, q) : d_ac;
    const int g = idct_1d(d0, pre.d1, pre.d2, pre.d3, 3);
    const Row4 g4 = shfl4(g, 4 * P);
    const int h = idct_1d(g4.a, g4.b, g4.c, g4.d, i);
    const int rec = recon(use_h ? left : dc, h);
    return pre.inter_intra >> 8 ? rec : pre.inter_intra & 255;
}

// The chroma chain of one MB: lane (cc, r) holds left sample r of
// component cc.
__device__ __forceinline__ int chroma_carry(int left, const ChromaPre& pre,
                                            const uint2& row_px, int cc,
                                            int r, const Quant& q,
                                            int mf_i0, int v_i0,
                                            uint8_t* scratch_mb,
                                            uint8_t* mode, bool own) {
    const int G = r >> 2, i = r & 3;
    if (own) scratch_mb[16 + cc * 8 + r] = static_cast<uint8_t>(left);
    const Row4 top = shfl4(left, 8 * cc), bottom = shfl4(left, 8 * cc + 4);
    const int dc_top = chroma_dc(top.a + top.b + top.c + top.d);
    const int dc_bottom = chroma_dc(bottom.a + bottom.b + bottom.c + bottom.d);
    const Row4 left4 = G ? bottom : top;
    const int dc = G ? dc_bottom : dc_top;
    const uint32_t sad = __vsadu4(row_px.x, splat(left))
                         + __vsadu4(row_px.y, splat(left));
    const uint32_t sad_dc = __vsadu4(row_px.x, splat(dc))
                            + __vsadu4(row_px.y, splat(dc));
    const uint32_t both = half_warp_sum(sad | (sad_dc << 16));   // u + v
    const bool use_h = (both & 0xffff) < (both >> 16);
    if (cc == 0 && r == 0 && own) *mode = use_h ? 1 : 0;   // CHROMA_H / _DC
    // the 2x2 DC path of this component, in every lane
    const int w0 = pred_coef(use_h, top, dc_top, cf_row(0), 0, 0);
    const int w1 = pred_coef(use_h, bottom, dc_bottom, cf_row(0), 0, 0);
    const int d[4] = {pre.bsum[0] - w0, pre.bsum[1] - w0, pre.bsum[2] - w1,
                      pre.bsum[3] - w1};
    int z[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
        z[k] = quant_dc(h2(d[0], d[1], d[2], d[3], k >> 1, k & 1), q);
    const int w = pre.ws0 - pred_coef(use_h, left4, dc, cf_row(i), i, 0);
    const int d_ac = dequant_ac(quant_ac(w, mf_i0, q), v_i0, q);
    const int d0 = i == 0
        ? dequant_dc_chroma(h2(z[0], z[1], z[2], z[3], G, 1), q) : d_ac;
    const int g = idct_1d(d0, pre.d1, pre.d2, pre.d3, 3);
    const Row4 g4 = shfl4(g, 8 * cc + 4 * G);
    const int h = idct_1d(g4.a, g4.b, g4.c, g4.d, i);
    const int rec = recon(use_h ? left : dc, h);
    return pre.inter_intra >> 8 ? rec : pre.inter_intra & 255;
}

__global__ void __launch_bounds__(128)
h264_intra16_carry_kernel(const uint8_t* __restrict__ y,
                          const uint8_t* __restrict__ u,
                          const uint8_t* __restrict__ v,
                          const uint8_t* __restrict__ is_intra,   // or null
                          const uint8_t* __restrict__ ry,   // inter recon
                          const uint8_t* __restrict__ ru,
                          const uint8_t* __restrict__ rv,
                          uint8_t* __restrict__ scratch,    // (mbh, mbw, 32)
                          uint8_t* __restrict__ mode_luma,
                          uint8_t* __restrict__ mode_chroma, int mbw,
                          int qp, int qp_c) {
    __shared__ __align__(16) LumaSlot luma_ring[kSlots];
    __shared__ __align__(16) ChromaSlot chroma_ring[kSlots];
    __shared__ LumaPre luma_pres[2][kChunk][16];
    __shared__ ChromaPre chroma_pres[2][kChunk][16];

    const int row = blockIdx.x;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const bool own = lane < 16;           // lanes 16..31 repeat 0..15
    const bool scan = is_intra != nullptr;
    const int nch = (mbw + kChunk - 1) / kChunk;
    const size_t mb_row = static_cast<size_t>(row) * mbw;
    const Quant ql = make_quant(qp), qc = make_quant(qp_c);
    const Planes pl_luma{{y, nullptr}, {ry, nullptr}, is_intra, mbw * 16};
    const Planes pl_chroma{{u, v}, {ru, rv}, is_intra, mbw * 8};
    const int yy = lane & 15;                           // luma lanes
    const int cc = (lane >> 3) & 1, r = lane & 7;       // chroma lanes
    constexpr int kLumaBar = 1, kChromaBar = 2;

    if (warp == 2) {
        produce<LumaSlot, 16>(
            luma_ring, luma_pres, pl_luma, row, mbw, nch, lane, kLumaBar,
            [&](const LumaSlot& sl, int m) {
                return luma_pre(sl, m, yy, scan, ql);
            });
    } else if (warp == 3) {
        produce<ChromaSlot, 8>(
            chroma_ring, chroma_pres, pl_chroma, row, mbw, nch, lane,
            kChromaBar, [&](const ChromaSlot& sl, int m) {
                return chroma_pre(sl, m, cc, r, scan, qc);
            });
    } else if (warp == 0) {
        const int i = yy & 3;
        const int mf_i0 = mf_of(ql, 4 * i), v_i0 = v_of(ql, 4 * i);
        int left = 128;
        for (int k = 0; k < nch; ++k) {
            pair_sync(kLumaBar);          // chunk k is staged and precomputed
            const LumaSlot& sl = luma_ring[k % kSlots];
            const int n = min(kChunk, mbw - k * kChunk);
            for (int m = 0; m < n; ++m) {
                const size_t mb = mb_row + k * kChunk + m;
                left = luma_carry(
                    left, luma_pres[k & 1][m][yy],
                    *reinterpret_cast<const uint4*>(&sl.px[yy][m * 16]), yy,
                    ql, mf_i0, v_i0, scratch + mb * kScratch,
                    mode_luma + mb, own);
            }
        }
    } else {
        const int i = r & 3;
        const int mf_i0 = mf_of(qc, 4 * i), v_i0 = v_of(qc, 4 * i);
        int left = 128;
        for (int k = 0; k < nch; ++k) {
            pair_sync(kChromaBar);
            const ChromaSlot& sl = chroma_ring[k % kSlots];
            const int n = min(kChunk, mbw - k * kChunk);
            for (int m = 0; m < n; ++m) {
                const size_t mb = mb_row + k * kChunk + m;
                left = chroma_carry(
                    left, chroma_pres[k & 1][m][(lane & 15)],
                    *reinterpret_cast<const uint2*>(&sl.px[cc * 8 + r][m * 8]),
                    cc, r, qc, mf_i0, v_i0, scratch + mb * kScratch,
                    mode_chroma + mb, own);
            }
        }
    }
}

// ---------------------------------------------------------------------------
// (b) The code kernel
// ---------------------------------------------------------------------------

struct Out {
    int16_t* dc_luma;       // (mbh, mbw, 16), zigzag
    int16_t* ac_luma;       // (mbh, mbw, 4, 4, 15)
    const uint8_t* mode_luma;     // (mbh, mbw), from the carry kernel
    int16_t* dc_chroma;     // (mbh, mbw, 2, 4)
    int16_t* ac_chroma;     // (mbh, mbw, 2, 2, 2, 15)
    const uint8_t* mode_chroma;   // (mbh, mbw), from the carry kernel
    uint8_t *y, *u, *v;     // the intra reconstruction planes
};

// 4 bytes at p (aligned: p is 4-byte aligned), packed little-endian
__device__ __forceinline__ uint32_t load4(const uint8_t* p, bool aligned) {
    if (aligned) return *reinterpret_cast<const uint32_t*>(p);
    return p[0] | (p[1] << 8) | (p[2] << 16) | (static_cast<uint32_t>(p[3])
                                                << 24);
}
__device__ __forceinline__ void store4(uint8_t* p, uint32_t v, bool aligned) {
    if (aligned) {
        *reinterpret_cast<uint32_t*>(p) = v;
    } else {
        p[0] = v & 255;
        p[1] = (v >> 8) & 255;
        p[2] = (v >> 16) & 255;
        p[3] = v >> 24;
    }
}
__device__ __forceinline__ Row4 bytes4(uint32_t w) {
    return {static_cast<int>(w & 255), static_cast<int>((w >> 8) & 255),
            static_cast<int>((w >> 16) & 255), static_cast<int>(w >> 24)};
}
__device__ __forceinline__ int row4_at(const Row4& r, int k) {
    return k == 0 ? r.a : k == 1 ? r.b : k == 2 ? r.c : r.d;
}
// the 16 samples of a 4x4 block from its four rows, packed
__device__ __forceinline__ void unpack_block(int* x, const uint32_t* rows) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
#pragma unroll
        for (int m = 0; m < 4; ++m) x[4 * k + m] = (rows[k] >> (8 * m)) & 255;
    }
}
__device__ __forceinline__ uint32_t pack4(int a, int b, int c, int d) {
    return a | (b << 8) | (c << 16) | (static_cast<uint32_t>(d) << 24);
}

// One MB per warp, no barrier but the warp's own: luma lane l takes rows
// 2 * (l & 1) and 2 * (l & 1) + 1 of 4x4 block l >> 1 (its partner lane
// l ^ 1 the other two), chroma lane l row l & 3 of block (l >> 2) & 3 of
// component l >> 4; a block's rows reach the lanes that need them by
// shuffles, and so do the DCs through the Hadamards.
__global__ void __launch_bounds__(256)
h264_intra16_code_kernel(const uint8_t* __restrict__ y,
                         const uint8_t* __restrict__ u,
                         const uint8_t* __restrict__ v,
                         const uint8_t* __restrict__ scratch, Out out,
                         int mbh, int mbw, int qp, int qp_c) {
    constexpr unsigned kAll = 0xffffffffu;
    const int lane = threadIdx.x & 31;
    const int mb_i = blockIdx.x * 8 + (threadIdx.x >> 5);
    if (mb_i >= mbh * mbw) return;        // whole warps
    const size_t mb = mb_i;
    const int row = mb_i / mbw, c = mb_i - row * mbw;
    const int w = mbw * 16, wc = mbw * 8;
    const bool al = ((reinterpret_cast<uintptr_t>(y)
                      | reinterpret_cast<uintptr_t>(u)
                      | reinterpret_cast<uintptr_t>(v)
                      | reinterpret_cast<uintptr_t>(out.y)
                      | reinterpret_cast<uintptr_t>(out.u)
                      | reinterpret_cast<uintptr_t>(out.v)) & 3) == 0;
    const Quant q = make_quant(qp), qc = make_quant(qp_c);
    // the left columns the carry pass coded this MB with, and its modes
    const uint4 lw = *reinterpret_cast<const uint4*>(scratch + mb * kScratch);
    const uint4 cw =
        *reinterpret_cast<const uint4*>(scratch + mb * kScratch + 16);
    const bool use_h = out.mode_luma[mb] == 1;
    const bool cuse_h = out.mode_chroma[mb] == 1;

    // --- luma
    {
        const int b = lane >> 1, by = b >> 2, bx = b & 3, half = lane & 1;
        const Row4 left4 = bytes4(by == 0 ? lw.x : by == 1 ? lw.y
                                  : by == 2 ? lw.z : lw.w);
        const int dc = luma_dc(__vsadu4(lw.x, 0) + __vsadu4(lw.y, 0)
                               + __vsadu4(lw.z, 0) + __vsadu4(lw.w, 0));
        const size_t at = static_cast<size_t>(row * 16 + 4 * by + 2 * half) * w
                          + c * 16 + 4 * bx;
        const uint32_t r0 = load4(y + at, al), r1 = load4(y + at + w, al);
        const uint32_t o0 = __shfl_xor_sync(kAll, r0, 1);
        const uint32_t o1 = __shfl_xor_sync(kAll, r1, 1);
        const uint32_t rows[4] = {half ? o0 : r0, half ? o1 : r1,
                                  half ? r0 : o0, half ? r1 : o1};
        int x[16];
        unpack_block(x, rows);
        int d[2][4], dcw = 0;
#pragma unroll
        for (int ii = 0; ii < 2; ++ii) {
            const int i = 2 * half + ii;
            const Row4 ci = cf_row(i);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int pos = 4 * i + j;
                const int wv = fdct_coef(x, ci, cf_row(j))
                               - pred_coef(use_h, left4, dc, ci, i, j);
                if (pos == 0) {
                    dcw = wv;
                    d[ii][j] = 0;
                } else {
                    const int z = quant_ac(wv, mf_of(q, pos), q);
                    out.ac_luma[(mb * 16 + b) * 15 + kInvZigzag[pos] - 1] =
                        static_cast<int16_t>(z);
                    d[ii][j] = dequant_ac(z, v_of(q, pos), q);
                }
            }
        }
        // the DC path: block b = (by, bx)'s DC is on lane 2b
        const Row4 hq = h4_row(bx), hp = h4_row(by);
        const int t = dot4(hq, __shfl_sync(kAll, dcw, 8 * by),
                           __shfl_sync(kAll, dcw, 8 * by + 2),
                           __shfl_sync(kAll, dcw, 8 * by + 4),
                           __shfl_sync(kAll, dcw, 8 * by + 6));
        const int acc = dot4(hp, __shfl_sync(kAll, t, 2 * bx),
                             __shfl_sync(kAll, t, 8 + 2 * bx),
                             __shfl_sync(kAll, t, 16 + 2 * bx),
                             __shfl_sync(kAll, t, 24 + 2 * bx));
        const int zdc = quant_dc(acc >> 1, q);
        if (half == 0)
            out.dc_luma[mb * 16 + kInvZigzag[b]] = static_cast<int16_t>(zdc);
        const int t2 = dot4(hq, __shfl_sync(kAll, zdc, 8 * by),
                            __shfl_sync(kAll, zdc, 8 * by + 2),
                            __shfl_sync(kAll, zdc, 8 * by + 4),
                            __shfl_sync(kAll, zdc, 8 * by + 6));
        const int f = dot4(hp, __shfl_sync(kAll, t2, 2 * bx),
                           __shfl_sync(kAll, t2, 8 + 2 * bx),
                           __shfl_sync(kAll, t2, 16 + 2 * bx),
                           __shfl_sync(kAll, t2, 24 + 2 * bx));
        if (half == 0) d[0][0] = dequant_dc_luma(f, q);
        // inverse transform: this lane's two rows, then the block's
        // columns at this lane's rows
        int res[2][4], oth[2][4];
#pragma unroll
        for (int ii = 0; ii < 2; ++ii) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                res[ii][j] = idct_1d(d[ii][0], d[ii][1], d[ii][2], d[ii][3], j);
            }
        }
#pragma unroll
        for (int ii = 0; ii < 2; ++ii) {
#pragma unroll
            for (int j = 0; j < 4; ++j)
                oth[ii][j] = __shfl_xor_sync(kAll, res[ii][j], 1);
        }
#pragma unroll
        for (int ii = 0; ii < 2; ++ii) {
            const int i = 2 * half + ii;
            const int pred = use_h ? row4_at(left4, i) : dc;
            int rec[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int c0 = half ? oth[0][j] : res[0][j];
                const int c1 = half ? oth[1][j] : res[1][j];
                const int c2 = half ? res[0][j] : oth[0][j];
                const int c3 = half ? res[1][j] : oth[1][j];
                rec[j] = recon(pred, idct_1d(c0, c1, c2, c3, i));
            }
            store4(out.y + at + ii * w, pack4(rec[0], rec[1], rec[2], rec[3]),
                   al);
        }
    }

    // --- chroma
    {
        const int comp = lane >> 4, cb = (lane >> 2) & 3, i = lane & 3;
        const int cby = cb >> 1, cbx = cb & 1;
        const uint32_t lword = comp == 0 ? (cby ? cw.y : cw.x)
                                         : (cby ? cw.w : cw.z);
        const Row4 left4 = bytes4(lword);
        const int dc = chroma_dc(__vsadu4(lword, 0));
        const size_t at = static_cast<size_t>(row * 8 + 4 * cby + i) * wc
                          + c * 8 + 4 * cbx;
        const uint32_t r = load4((comp == 0 ? u : v) + at, al);
        const int base = lane & ~3;
        const uint32_t rows[4] = {__shfl_sync(kAll, r, base),
                                  __shfl_sync(kAll, r, base + 1),
                                  __shfl_sync(kAll, r, base + 2),
                                  __shfl_sync(kAll, r, base + 3)};
        int x[16];
        unpack_block(x, rows);
        const Row4 ci = cf_row(i);
        int d[4], dcw = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int pos = 4 * i + j;
            const int wv = fdct_coef(x, ci, cf_row(j))
                           - pred_coef(cuse_h, left4, dc, ci, i, j);
            if (pos == 0) {
                dcw = wv;
                d[j] = 0;
            } else {
                const int z = quant_ac(wv, mf_of(qc, pos), qc);
                out.ac_chroma[((mb * 2 + comp) * 4 + cb) * 15 + kInvZigzag[pos]
                              - 1] = static_cast<int16_t>(z);
                d[j] = dequant_ac(z, v_of(qc, pos), qc);
            }
        }
        // the 2x2 DC path of this component: block k's DC is on lane
        // 16 * comp + 4 * k
        const int cbase = 16 * comp;
        const int d0 = __shfl_sync(kAll, dcw, cbase);
        const int d1 = __shfl_sync(kAll, dcw, cbase + 4);
        const int d2 = __shfl_sync(kAll, dcw, cbase + 8);
        const int d3 = __shfl_sync(kAll, dcw, cbase + 12);
        const int z = quant_dc(h2(d0, d1, d2, d3, cby, cbx), qc);
        if (i == 0)
            out.dc_chroma[(mb * 2 + comp) * 4 + cb] = static_cast<int16_t>(z);
        const int f = h2(__shfl_sync(kAll, z, cbase),
                         __shfl_sync(kAll, z, cbase + 4),
                         __shfl_sync(kAll, z, cbase + 8),
                         __shfl_sync(kAll, z, cbase + 12), cby, cbx);
        if (i == 0) d[0] = dequant_dc_chroma(f, qc);
        int res[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) res[j] = idct_1d(d[0], d[1], d[2], d[3], j);
        const int pred = cuse_h ? row4_at(left4, i) : dc;
        int rec[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            rec[j] = recon(pred, idct_1d(__shfl_sync(kAll, res[j], base),
                                         __shfl_sync(kAll, res[j], base + 1),
                                         __shfl_sync(kAll, res[j], base + 2),
                                         __shfl_sync(kAll, res[j], base + 3),
                                         i));
        }
        store4((comp == 0 ? out.u : out.v) + at,
               pack4(rec[0], rec[1], rec[2], rec[3]), al);
    }
}

}  // namespace

extern "C" int h264_intra16_carry_launch(
        const void* y, const void* u, const void* v, const void* is_intra,
        const void* ry, const void* ru, const void* rv, void* scratch,
        void* mode_luma, void* mode_chroma, int mbh, int mbw, int qp,
        int qp_c, void* stream) {
    h264_intra16_carry_kernel<<<mbh, 128, 0,
                                static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(y), static_cast<const uint8_t*>(u),
        static_cast<const uint8_t*>(v),
        static_cast<const uint8_t*>(is_intra),
        static_cast<const uint8_t*>(ry), static_cast<const uint8_t*>(ru),
        static_cast<const uint8_t*>(rv), static_cast<uint8_t*>(scratch),
        static_cast<uint8_t*>(mode_luma), static_cast<uint8_t*>(mode_chroma),
        mbw, qp, qp_c);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int h264_intra16_code_launch(
        const void* y, const void* u, const void* v, const void* scratch,
        void* dc_luma, void* ac_luma, const void* mode_luma, void* dc_chroma,
        void* ac_chroma, const void* mode_chroma, void* oy, void* ou,
        void* ov, int mbh, int mbw, int qp, int qp_c, void* stream) {
    const Out out{static_cast<int16_t*>(dc_luma),
                  static_cast<int16_t*>(ac_luma),
                  static_cast<const uint8_t*>(mode_luma),
                  static_cast<int16_t*>(dc_chroma),
                  static_cast<int16_t*>(ac_chroma),
                  static_cast<const uint8_t*>(mode_chroma),
                  static_cast<uint8_t*>(oy), static_cast<uint8_t*>(ou),
                  static_cast<uint8_t*>(ov)};
    h264_intra16_code_kernel<<<(mbh * mbw + 7) / 8, 256, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(y), static_cast<const uint8_t*>(u),
        static_cast<const uint8_t*>(v),
        static_cast<const uint8_t*>(scratch), out, mbh, mbw, qp, qp_c);
    return static_cast<int>(cudaGetLastError());
}
