// K4: the HEVC IDR intra coder over the CTB columns of a frame, one slice
// (tile) per CTB row, hand-written for Hopper.
//
// Replaces the column loop of ops/h265.py:_i_frame_cols_ref. On the TPU it
// is an XLA-lowered lax.scan over CTB columns
// (ceracoder_tpu/ops/h265.py:_i_frame_core, no Pallas source). Per 16x16
// CTB, in order:
//   - luma: the 12 candidates of _intra_preds(left, 16, luma=True) from
//     the left CTB's reconstructed right column (corner = left[0], the top
//     row and below-left substituted): planar on the smoothed left
//     reference, DC with its row-0 and column-0 filters, horizontal,
//     vertical with its column-0 filter, the angular modes 2..9 (2..8 on
//     the smoothed reference, 9 on the raw one);
//   - the SATD of each candidate (four 8x8 Hadamard sums, each >> 2, then
//     added) and the first minimum in _MODES order;
//   - the luma TU: the 16x16 forward transform (shifts 3 and 10), intra
//     quant (offset 171/512), dequant, the inverse transform with both
//     clamps, and the reconstruction clamped to 0..255;
//   - chroma: the same candidate index among the 8x8 chroma candidates (no
//     smoothing, no edge filters), each plane coded with the 8x8 transform
//     at qp_c.
// The right column of each reconstruction is the next CTB's left column;
// column 0 sees 128. The kernels also write the constant outputs of an
// intra frame (is_intra 1, tu_split 0, mv 0).
//
// Bound: operations. Per CTB the function needs about 65,000 integer
// operations (chip_smoke.py:H265_INTRA_OPS_PER_CTB: the 12 candidates and
// their Hadamards, both transforms each way); at 1080p that is 0.0113 ms at
// 67e12 operations/s, against 19 MB of planes, levels and outputs (5.7 us
// at 3.35 TB/s). The carry pass repeats part of that work and writes a
// scratch buffer; neither is counted. The real floor is the serial chain:
// 120 CTB columns at 1080p (240 at 4K) one after another, each as long as
// the chain of one CTB, on one CTA per CTB row (68 CTAs at 1080p, 135 at
// 4K, where three SMs carry two rows).
//
// Design: the serial work and the parallel work are two kernels, one after
// the other on the caller's stream.
//   (a) h265_intra_carry_kernel, one CTA of 15 warps per CTB row, serial
//       over the columns, computes only what the next CTB needs: the mode,
//       and the right column of the luma and chroma reconstruction, which it
//       keeps in shared memory as the next left column. It writes each
//       CTB's left columns (16 luma + 8 Cb + 8 Cr samples) to a scratch
//       buffer and the mode to its output.
//       - Warps 13 and 14 (producers) stage the row's source a chunk of
//         kChunk columns ahead with cp.async (row_stage.cuh) and compute
//         what depends on the source alone, off the chain: the 2-D 8x8
//         Hadamards H(src) of the four luma blocks and the first forward
//         stage's products T16 . src and T8 . src (before their shift).
//         They hand a chunk over at a named barrier.
//       - Warps 0..11 run the luma chain. Warp m takes candidate m: it
//         predicts the CTB, takes the 2-D Hadamard of the prediction on
//         the tensor cores and sums |H(src) - H(pred)| (the Hadamard is
//         linear and exact on integers) over each 8x8 block with redux;
//         the least key (16 SATD + m: ties go to the first in _MODES order)
//         is a shared atomicMin. The SATDs meet at a named barrier.
//       - After it, warp 3 runs the luma tail: stage 1 as (T . src less T .
//         pred of the chosen mode + 4) >> 3, stage 2, quant and dequant,
//         the inverse stage 1 in full and the inverse stage 2 for column 15
//         only (a sum across lanes), then the clamp against the prediction.
//         The next CTB's candidates wait for it at a second named barrier:
//         two chain barriers per CTB where there were nine block barriers,
//         and no CTA-wide one.
//       - Warp 12 runs chroma off the chain, as no candidate needs it: it
//         joins the SATD barrier for the mode, then codes CTB m (both
//         planes at once; the inverse stage 2 for column 7 only) while the
//         chain goes on to m + 1, and counts itself in at the hand-over
//         without waiting (bar.arrive).
//   (b) h265_intra_code_kernel, one warp per CTB, all independent (8,160
//       warps in 1,020 CTAs at 1080p), codes each CTB from its stored left
//       columns and mode: prediction, the full luma 16x16 and chroma 8x8
//       chains, every level and the reconstruction, with coalesced stores,
//       and the constant outputs. Stages meet at __syncwarp.
// Every matrix product is int8 mma.sync (m16n8k16, 32-bit sums, exact):
// the transform matrices and the Hadamard's +-1 are signed bytes, the
// prediction and the source unsigned bytes, and every other operand fits
// 16 bits (below) and goes in as its low byte (unsigned) and its high byte
// (signed), two products summed as 256 * high + low. A 16x16 result is two
// 16x8 tiles; chroma stacks Cb over Cr in one tile with block-diagonal
// matrices. Between stages a warp turns a result's fragments into the next
// product's operands through a small shared-memory buffer of its own.
// Both kernels take their arithmetic from one set of __device__ functions
// below (prediction, the products, quant, dequant, the stage roundings), so
// the carried column and the stored reconstruction cannot disagree.
//
// int32 ranges (a residual is at most 255 in magnitude, and the absolute
// row sums of T16 and T8 are at most 1024 and 512): T . src and T . pred
// are each at most 1024 * 255 = 261,120, the forward stage 1 value at most
// (261,120 + 4) >> 3 = 32,640 (luma; chroma (130,560 + 2) >> 2 = 32,640),
// so its high byte lies in -128..127; a coefficient is at most 32,640;
// quant's |coef| * scale at most 32,640 * 26,214 = 8.6e8 (about 2^30) and
// its offset 171 << 16 = 1.1e7 at qp 51; a level is at most 6,529 (qp 0),
// so the dequant product is at most 6,529 * 640 = 4.2e6 at qp 0 and 18 *
// 233,472 = 4.2e6 at qp 51; dequantized values and the inverse stage 1 are
// clamped to 16 bits; the inverse sums are at most 1024 * 32,768 = 3.4e7. A
// split product is 256 times the high bytes' (at most 16 * 128 * 90 =
// 184,320) plus the low bytes': under 4.8e7. The Hadamard's first pass is at
// most 8 * 255 = 2,040 (16 bits), its second 16,320; the SATD sums stay
// under 2^21. Every right shift of a negative value is arithmetic, as
// torch's, and levels are sign * magnitude.
//
// The C entry points return cudaGetLastError() after each launch so the
// wrapper can raise on a refused launch.

#include <cstdint>

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "row_stage.cuh"

namespace {

using row_stage::stage_rows;

constexpr unsigned kAll = 0xffffffffu;
constexpr int kCands = 12;
constexpr int kChunk = 4;                 // CTB columns per ring slot
constexpr int kSlots = 3;                 // source ring depth
constexpr int kLumaPitch = kChunk * 16 + 16;   // bytes per staged row
constexpr int kChromaPitch = kChunk * 8 + 16;
constexpr int kScratch = 32;              // bytes per CTB: 16 y, 8 u, 8 v
constexpr int kChainThreads = kCands * 32;     // warps 0..11
constexpr int kChromaWarp = kCands;            // warp 12
constexpr int kCarryThreads = kChainThreads + 96;   // + chroma, 2 producers
constexpr int kPitch = 24;                // int16 row pitch of a warp's buffer
// named barriers (0 is __syncthreads)
constexpr int kSatdBar = 1;               // warps 0..12: the SATDs are in
constexpr int kLeftBar = 2;               // warps 0..11: the next left column
constexpr int kProducerBar = 3;           // warps 13, 14
constexpr int kHandoffBar = 4;            // all 15 warps (chroma: arrive)

// _MODES: candidate index -> intra mode; the angles of modes 2..9
__constant__ int kModes[kCands] = {0, 1, 10, 26, 2, 3, 4, 5, 6, 7, 8, 9};
__constant__ int kAngle[8] = {32, 26, 21, 17, 13, 9, 5, 2};
// codec/h265/tables.py: QUANT_SCALES, INV_QUANT_SCALES, T16, T8
__constant__ int kQuant[6] = {26214, 23302, 20560, 18396, 16384, 14564};
__constant__ int kInvQuant[6] = {40, 45, 51, 57, 64, 72};
struct Mat16 {
    int v[16][16];
};
struct Mat8 {
    int v[8][8];
};
constexpr Mat16 kT16 = {{
    {64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64},
    {90, 87, 80, 70, 57, 43, 25, 9, -9, -25, -43, -57, -70, -80, -87, -90},
    {89, 75, 50, 18, -18, -50, -75, -89, -89, -75, -50, -18, 18, 50, 75, 89},
    {87, 57, 9, -43, -80, -90, -70, -25, 25, 70, 90, 80, 43, -9, -57, -87},
    {83, 36, -36, -83, -83, -36, 36, 83, 83, 36, -36, -83, -83, -36, 36, 83},
    {80, 9, -70, -87, -25, 57, 90, 43, -43, -90, -57, 25, 87, 70, -9, -80},
    {75, -18, -89, -50, 50, 89, 18, -75, -75, 18, 89, 50, -50, -89, -18, 75},
    {70, -43, -87, 9, 90, 25, -80, -57, 57, 80, -25, -90, -9, 87, 43, -70},
    {64, -64, -64, 64, 64, -64, -64, 64, 64, -64, -64, 64, 64, -64, -64, 64},
    {57, -80, -25, 90, -9, -87, 43, 70, -70, -43, 87, 9, -90, 25, 80, -57},
    {50, -89, 18, 75, -75, -18, 89, -50, -50, 89, -18, -75, 75, 18, -89, 50},
    {43, -90, 57, 25, -87, 70, 9, -80, 80, -9, -70, 87, -25, -57, 90, -43},
    {36, -83, 83, -36, -36, 83, -83, 36, 36, -83, 83, -36, -36, 83, -83, 36},
    {25, -70, 90, -80, 43, 9, -57, 87, -87, 57, -9, -43, 80, -90, 70, -25},
    {18, -50, 75, -89, 89, -75, 50, -18, -18, 50, -75, 89, -89, 75, -50, 18},
    {9, -25, 43, -57, 70, -80, 87, -90, 90, -87, 80, -70, 57, -43, 25, -9}}};
constexpr Mat8 kT8 = {{
    {64, 64, 64, 64, 64, 64, 64, 64},
    {89, 75, 50, 18, -18, -50, -75, -89},
    {83, 36, -36, -83, -83, -36, 36, 83},
    {75, -18, -89, -50, 50, 89, 18, -75},
    {64, -64, -64, 64, 64, -64, -64, 64},
    {50, -89, 18, 75, -75, -18, 89, -50},
    {36, -83, 83, -36, -36, 83, -83, 36},
    {18, -50, 75, -89, 89, -75, 50, -18}}};

// ---------------------------------------------------------------------------
// The arithmetic both kernels share
// ---------------------------------------------------------------------------

__device__ __forceinline__ int iabs(int x) { return x < 0 ? -x : x; }
__device__ __forceinline__ int isign(int x) { return (x > 0) - (x < 0); }
__device__ __forceinline__ int clamp_to(int x, int lo, int hi) {
    return min(max(x, lo), hi);
}
__device__ __forceinline__ int clamp16(int x) {
    return clamp_to(x, -32768, 32767);
}

// four values' low bytes in one word, the first in the lowest byte
__device__ __forceinline__ uint32_t pack4(int a, int b, int c, int d) {
    return (a & 255) | ((b & 255) << 8) | ((c & 255) << 16)
           | (static_cast<uint32_t>(d & 255) << 24);
}
// two 16-bit values in one word
__device__ __forceinline__ uint32_t pack2(int a, int b) {
    return (a & 0xffff) | (static_cast<uint32_t>(b) << 16);
}

// The quantizer of one qp and TU size 2^log2n: quant's scale, intra
// offset (171/512) and shift, dequant's scale and shift
struct Quant {
    int scale, off, qbits, dscale, dshift;
};
__device__ __forceinline__ Quant make_quant(int qp, int log2n) {
    const int qbits = 21 + qp / 6 - log2n;
    return {kQuant[qp % 6], 171 << (qbits - 9), qbits,
            (kInvQuant[qp % 6] * 16) << (qp / 6), log2n + 3};
}
__device__ __forceinline__ int quant(int coef, const Quant& q) {
    return isign(coef) * ((iabs(coef) * q.scale + q.off) >> q.qbits);
}
__device__ __forceinline__ int dequant(int level, const Quant& q) {
    return clamp16((level * q.dscale + (1 << (q.dshift - 1))) >> q.dshift);
}

__device__ __forceinline__ int inv1(int sum) {
    return clamp16((sum + 64) >> 7);
}
__device__ __forceinline__ int inv2(int sum) {
    return clamp16((sum + 2048) >> 12);
}
__device__ __forceinline__ int recon(int pred, int res) {
    return clamp_to(pred + res, 0, 255);
}

// Fragments of mma.sync m16n8k16 with 8-bit operands, lane = 4 g + t:
// A (16x16, row-major) a0 = A[g][4t .. 4t + 3], a1 = A[g + 8][4t ..];
// B (16x8, k x n) b = B[4t .. 4t + 3][g]; the 16x8 result tile C holds
// C[g][2t], C[g][2t + 1], C[g + 8][2t], C[g + 8][2t + 1]. A 16x16 result
// is two tiles, columns 0..7 and 8..15.
struct Tile {
    int v[4];
};
struct AFrag {
    uint32_t a0, a1;
};

// C = A . B for signed A and unsigned B bytes (su), signed both (ss),
// unsigned A and signed B (us)
__device__ __forceinline__ Tile mma_su(const AFrag& a, uint32_t b) {
    Tile d;
    asm("mma.sync.aligned.m16n8k16.row.col.s32.s8.u8.s32 {%0,%1,%2,%3}, {%4,%5}, {%6}, {%7,%8,%9,%10};"
        : "=r"(d.v[0]), "=r"(d.v[1]), "=r"(d.v[2]), "=r"(d.v[3])
        : "r"(a.a0), "r"(a.a1), "r"(b), "r"(0), "r"(0), "r"(0), "r"(0));
    return d;
}
__device__ __forceinline__ Tile mma_ss(const AFrag& a, uint32_t b) {
    Tile d;
    asm("mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5}, {%6}, {%7,%8,%9,%10};"
        : "=r"(d.v[0]), "=r"(d.v[1]), "=r"(d.v[2]), "=r"(d.v[3])
        : "r"(a.a0), "r"(a.a1), "r"(b), "r"(0), "r"(0), "r"(0), "r"(0));
    return d;
}
__device__ __forceinline__ Tile mma_us(const AFrag& a, uint32_t b) {
    Tile d;
    asm("mma.sync.aligned.m16n8k16.row.col.s32.u8.s8.s32 {%0,%1,%2,%3}, {%4,%5}, {%6}, {%7,%8,%9,%10};"
        : "=r"(d.v[0]), "=r"(d.v[1]), "=r"(d.v[2]), "=r"(d.v[3])
        : "r"(a.a0), "r"(a.a1), "r"(b), "r"(0), "r"(0), "r"(0), "r"(0));
    return d;
}
// 256 * hi + lo, tile by tile
__device__ __forceinline__ Tile combine(const Tile& lo, const Tile& hi) {
    Tile d;
#pragma unroll
    for (int k = 0; k < 4; ++k) d.v[k] = 256 * hi.v[k] + lo.v[k];
    return d;
}
// A . B for a constant A and a 16-bit B given as its low and high bytes
__device__ __forceinline__ Tile mma_const_a(const AFrag& a, uint32_t b_lo,
                                            uint32_t b_hi) {
    return combine(mma_su(a, b_lo), mma_ss(a, b_hi));
}
// A . B for a 16-bit A given as its low and high bytes and a constant B
__device__ __forceinline__ Tile mma_const_b(const AFrag& a_lo,
                                            const AFrag& a_hi, uint32_t b) {
    return combine(mma_us(a_lo, b), mma_ss(a_hi, b));
}

// The constant operands of both kernels, every lane's fragments of: T16,
// its transpose, the 8x8 Walsh-Hadamard matrix twice on the diagonal
// (W[u][r] = (-1)^popcount(u & r)), T8 twice on the diagonal and its
// transpose (A operands); T16 and the Hadamard's matrix (B operands, both
// tiles) and T8 in the top-left corner of zeros; and the weights of the
// last column's inverse sums, T16[g][15], T16[g + 8][15] and T8[g][7].
// Built at compile time (lanes would read the matrices at 32 different
// addresses at once).
struct Mats {
    AFrag t16, t16t, had, t8d, t8dt;
    uint32_t t16_b[2], had_b[2], t8c_b;
    int w15[2], w7;
};

constexpr int kFragWords = 20;
struct alignas(16) FragTable {
    uint32_t w[32][kFragWords];
};

namespace frag {
constexpr int t16(int r, int c) { return kT16.v[r][c]; }
constexpr int t16t(int r, int c) { return kT16.v[c][r]; }
constexpr int had(int r, int c) {
    const int x = r & c & 7;
    return ((r ^ c) & 8) ? 0 : (((x & 1) + ((x >> 1) & 1) + (x >> 2)) & 1)
                                   ? -1 : 1;
}
constexpr int t8d(int r, int c) {
    return ((r ^ c) & 8) ? 0 : kT8.v[r & 7][c & 7];
}
constexpr int t8dt(int r, int c) {
    return ((r ^ c) & 8) ? 0 : kT8.v[c & 7][r & 7];
}
constexpr int t8c(int r, int c) { return ((r | c) & 8) ? 0 : kT8.v[r][c]; }
constexpr uint32_t pack(int a, int b, int c, int d) {
    return static_cast<uint32_t>(a & 255) | static_cast<uint32_t>(b & 255) << 8
           | static_cast<uint32_t>(c & 255) << 16
           | static_cast<uint32_t>(d & 255) << 24;
}
// A operand: rows g and g + 8, columns 4t .. 4t + 3; B operand of tile j:
// rows 4t .. 4t + 3, column g + 8 j
template <typename M>
constexpr void a_frag(M m, int lane, uint32_t* w) {
    const int g = lane >> 2, t4 = 4 * (lane & 3);
    w[0] = pack(m(g, t4), m(g, t4 + 1), m(g, t4 + 2), m(g, t4 + 3));
    w[1] = pack(m(g + 8, t4), m(g + 8, t4 + 1), m(g + 8, t4 + 2),
                m(g + 8, t4 + 3));
}
template <typename M>
constexpr uint32_t b_frag(M m, int lane, int j) {
    const int n = (lane >> 2) + 8 * j, t4 = 4 * (lane & 3);
    return pack(m(t4, n), m(t4 + 1, n), m(t4 + 2, n), m(t4 + 3, n));
}
constexpr FragTable make_table() {
    FragTable f{};
    for (int lane = 0; lane < 32; ++lane) {
        uint32_t* w = f.w[lane];
        const int g = lane >> 2;
        a_frag(t16, lane, w);
        a_frag(t16t, lane, w + 2);
        a_frag(had, lane, w + 4);
        a_frag(t8d, lane, w + 6);
        a_frag(t8dt, lane, w + 8);
        w[10] = b_frag(t16, lane, 0);
        w[11] = b_frag(t16, lane, 1);
        w[12] = b_frag(had, lane, 0);
        w[13] = b_frag(had, lane, 1);
        w[14] = b_frag(t8c, lane, 0);
        w[15] = static_cast<uint32_t>(kT16.v[g][15]);
        w[16] = static_cast<uint32_t>(kT16.v[g + 8][15]);
        w[17] = static_cast<uint32_t>(kT8.v[g][7]);
    }
    return f;
}
}  // namespace frag

__device__ const FragTable kFrags = frag::make_table();

__device__ __forceinline__ Mats load_mats(int lane) {
    const uint4* p = reinterpret_cast<const uint4*>(kFrags.w[lane]);
    const uint4 a = p[0], b = p[1], c = p[2], d = p[3], e = p[4];
    Mats k;
    k.t16 = {a.x, a.y};
    k.t16t = {a.z, a.w};
    k.had = {b.x, b.y};
    k.t8d = {b.z, b.w};
    k.t8dt = {c.x, c.y};
    k.t16_b[0] = c.z;
    k.t16_b[1] = c.w;
    k.had_b[0] = d.x;
    k.had_b[1] = d.y;
    k.t8c_b = d.z;
    k.w15[0] = static_cast<int>(d.w);
    k.w15[1] = static_cast<int>(e.x);
    k.w7 = static_cast<int>(e.y);
    return k;
}

// A warp's buffer for turning result tiles into operands
using Buf = int16_t[16][kPitch];

// Store a 16x16 result (two tiles; n = 1: one 16x8 tile) of 16-bit values
// row-major, or transposed (element (r, c) at [c][r]).
__device__ __forceinline__ void put(Buf& s, const Tile* x, int n, int lane) {
    const int g = lane >> 2, t2 = 2 * (lane & 3);
    for (int j = 0; j < n; ++j) {
        *reinterpret_cast<uint32_t*>(&s[g][8 * j + t2]) =
            pack2(x[j].v[0], x[j].v[1]);
        *reinterpret_cast<uint32_t*>(&s[g + 8][8 * j + t2]) =
            pack2(x[j].v[2], x[j].v[3]);
    }
}
__device__ __forceinline__ void put_t(Buf& s, const Tile* x, int n,
                                      int lane) {
    const int g = lane >> 2, t2 = 2 * (lane & 3);
    for (int j = 0; j < n; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
            s[8 * j + t2 + (e & 1)][g + 8 * (e >> 1)] =
                static_cast<int16_t>(x[j].v[e]);
    }
}
// Four 16-bit values at s[r][c .. c + 3] as their low and high bytes
__device__ __forceinline__ void get_split(const Buf& s, int r, int c,
                                          uint32_t& lo, uint32_t& hi) {
    const uint2 w = *reinterpret_cast<const uint2*>(&s[r][c]);
    lo = __byte_perm(w.x, w.y, 0x6420);
    hi = __byte_perm(w.x, w.y, 0x7531);
}
// The A operand of a matrix stored row-major, split in bytes
__device__ __forceinline__ void get_a(const Buf& s, int lane, AFrag& lo,
                                      AFrag& hi) {
    const int g = lane >> 2, t4 = 4 * (lane & 3);
    get_split(s, g, t4, lo.a0, hi.a0);
    get_split(s, g + 8, t4, lo.a1, hi.a1);
}

// The luma references of a CTB, one entry per lane l: left2 = left[min(l,
// 15)] (the left column, below-left substituted), fl = left2 smoothed with
// [1 2 1] (corner = left[0]; fl[31] = left[15] unsmoothed); index 32 of
// either is index 31. c0 is the corner.
struct LumaRef {
    int left2, fl, c0;
};

template <typename T>
__device__ __forceinline__ LumaRef luma_ref(const T* left, int lane) {
    const int prev = left[min(max(lane - 1, 0), 15)];
    const int here = left[min(lane, 15)], next = left[min(lane + 1, 15)];
    LumaRef r;
    r.left2 = here;
    r.fl = lane < 31 ? (prev + 2 * here + next + 2) >> 2 : here;
    r.c0 = left[0];
    return r;
}

// the DC value: the left column's sum, the top's (16 * corner), rounded
__device__ __forceinline__ int luma_dc(const LumaRef& r, int lane) {
    const int s = __reduce_add_sync(kAll, lane < 16 ? r.left2 : 0);
    return (s + 16 * r.c0 + 16) >> 5;
}

// Luma candidate m (an index into _MODES, the same in the whole warp) in
// lane (g, t): p[4 j + i] is the sample in column x = g + 8 j, row y =
// 4 t + i, the lane's part of the prediction as the B operand of a product.
__device__ __forceinline__ void luma_pred(int m, const LumaRef& r, int lane,
                                          int* p) {
    const int g = lane >> 2, y0 = 4 * (lane & 3);
    if (m >= 4) {                   // angular 2..9 along the left reference
        const int ref = m < 11 ? r.fl : r.left2;
        const int a = kAngle[m - 4];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
            const int pos = (g + 8 * j + 1) * a;
            const int d = pos >> 5, f = pos & 31;
            int r1 = __shfl_sync(kAll, ref, min(y0 + d, 31));
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int r0 = r1;
                r1 = __shfl_sync(kAll, ref, min(y0 + i + d + 1, 31));
                p[4 * j + i] = ((32 - f) * r0 + f * r1 + 16) >> 5;
            }
        }
        return;
    }
    if (m == 0) {                   // planar on the smoothed reference
        const int fl16 = __shfl_sync(kAll, r.fl, 16);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int y = y0 + i;
            const int fly = __shfl_sync(kAll, r.fl, y);
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                const int x = g + 8 * j;
                p[4 * j + i] = ((15 - x) * fly + (x + 1) * r.c0
                                + (15 - y) * r.c0 + (y + 1) * fl16 + 16) >> 5;
            }
        }
        return;
    }
    const int dc = m == 1 ? luma_dc(r, lane) : 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int y = y0 + i;
        const int ly = __shfl_sync(kAll, r.left2, y);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
            const int x = g + 8 * j;
            int v;
            if (m == 1) {           // DC, row 0 and column 0 filtered
                v = y == 0 && x == 0 ? (ly + 2 * dc + r.c0 + 2) >> 2
                    : y == 0         ? (r.c0 + 3 * dc + 2) >> 2
                    : x == 0         ? (ly + 3 * dc + 2) >> 2
                                     : dc;
            } else if (m == 2) {    // horizontal
                v = ly;
            } else {                // vertical, column 0 filtered
                v = x == 0 ? clamp_to(r.c0 + ((ly - r.c0) >> 1), 0, 255)
                           : r.c0;
            }
            p[4 * j + i] = v;
        }
    }
}

// chroma candidate m at (y, x) from the 8-sample left column l
__device__ __forceinline__ int chroma_pred(int m, int y, int x, const int* l,
                                           int dc) {
    const int c = l[0];
    switch (m) {
        case 0:
            return ((7 - x) * l[y] + (x + 1) * c + (7 - y) * c
                    + (y + 1) * l[7] + 8) >> 4;
        case 1:
            return dc;
        case 2:
            return l[y];
        case 3:
            return c;
        default: {
            const int pos = (x + 1) * kAngle[m - 4];
            const int i0 = y + (pos >> 5), f = pos & 31;
            return ((32 - f) * l[min(i0, 7)] + f * l[min(i0 + 1, 7)] + 16)
                   >> 5;
        }
    }
}

__device__ __forceinline__ int chroma_dc(const int* l) {
    int s = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) s += l[k];
    return (s + 8 * l[0] + 8) >> 4;
}

// Chroma candidate m in lane (g, t): plane p = t >> 1, column x = g, rows
// y = 4 (t & 1) .. + 3, as the B operand of the stacked planes (rows 8 p
// + y); lc = the planes' left columns
__device__ __forceinline__ uint32_t chroma_pred4(int m, const int (*lc)[8],
                                                 int lane) {
    const int p = (lane >> 1) & 1, x = lane >> 2, y0 = 4 * (lane & 1);
    const int* l = lc[p];
    const int dc = chroma_dc(l);
    return pack4(chroma_pred(m, y0, x, l, dc), chroma_pred(m, y0 + 1, x, l, dc),
                 chroma_pred(m, y0 + 2, x, l, dc),
                 chroma_pred(m, y0 + 3, x, l, dc));
}

// The 2-D Hadamard (W . X . W per 8x8 block) of a 16x16 block of bytes
// given as B operands b[0], b[1] (columns 0..7, 8..15); the result's row
// block is the block row, its column tile the block column.
__device__ __forceinline__ void hadamard(const Mats& k, const uint32_t* b,
                                         Buf& s, int lane, Tile* z) {
    const Tile x[2] = {mma_su(k.had, b[0]), mma_su(k.had, b[1])};
    put(s, x, 2, lane);
    __syncwarp();
    AFrag lo, hi;
    get_a(s, lane, lo, hi);
    __syncwarp();
    z[0] = mma_const_b(lo, hi, k.had_b[0]);
    z[1] = mma_const_b(lo, hi, k.had_b[1]);
}

// The luma TU's stage 1, one warp: a = (T16 . src - T16 . pred + 4) >> 3
// (rows i, columns x), from ts = T16 . src and the prediction's B operands
__device__ __forceinline__ void luma_fwd1(const Mats& k, const Tile* ts,
                                          const uint32_t* b_pred, Tile* a) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
        const Tile tp = mma_su(k.t16, b_pred[j]);
#pragma unroll
        for (int e = 0; e < 4; ++e)
            a[j].v[e] = (ts[j].v[e] - tp.v[e] + 4) >> 3;
    }
}

// The rest of the luma TU chain through the inverse stage 1, one warp,
// from stage 1 stored row-major in a_s: returns the inverse stage 1
// transposed, a2t (rows kk, columns i: a2[i][kk]), and when levels is given
// (the code pass) the levels (levels[i][jj]).
__device__ __forceinline__ void luma_back(const Mats& k, const Buf& a_s,
                                          const Quant& q, Buf& s, int lane,
                                          Tile* a2t, int32_t* levels) {
    const int g = lane >> 2, t2 = 2 * (lane & 3);
    // stage 2 transposed, coef[i][jj] at (jj, i): T16 . a^T, whose B
    // operand of tile j is row g + 8 j of a
    uint32_t lo[2], hi[2];
    get_split(a_s, g, 4 * (lane & 3), lo[0], hi[0]);
    get_split(a_s, g + 8, 4 * (lane & 3), lo[1], hi[1]);
    __syncwarp();
    Tile dq[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
        const Tile c = mma_const_a(k.t16, lo[j], hi[j]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int lv = quant((c.v[e] + 512) >> 10, q);
            if (levels != nullptr)
                levels[16 * (8 * j + t2 + (e & 1)) + g + 8 * (e >> 1)] = lv;
            dq[j].v[e] = dequant(lv, q);
        }
    }
    // the inverse stage 1 transposed: a2^T = dq^T . T16
    put(s, dq, 2, lane);
    __syncwarp();
    AFrag dlo, dhi;
    get_a(s, lane, dlo, dhi);
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 2; ++j) {
        const Tile c = mma_const_b(dlo, dhi, k.t16_b[j]);
#pragma unroll
        for (int e = 0; e < 4; ++e) a2t[j].v[e] = inv1(c.v[e]);
    }
}

// The chroma chain of both planes, stacked (rows 8 p + ...): ts = T8 .
// src; returns the inverse stage 1 transposed (rows (p, kk), columns i) and
// the levels ((p, i, jj)) when given.
__device__ __forceinline__ void chroma_chain(const Mats& k, const Tile& ts,
                                             uint32_t b_pred, const Quant& q,
                                             Buf& s, int lane, Tile& a2t,
                                             int32_t* const* levels) {
    const int g = lane >> 2, t = lane & 3;
    const Tile tp = mma_su(k.t8d, b_pred);
    Tile a;
#pragma unroll
    for (int e = 0; e < 4; ++e) a.v[e] = (ts.v[e] - tp.v[e] + 2) >> 2;
    put(s, &a, 1, lane);
    __syncwarp();
    // stage 2 transposed: T8 . a_p^T per plane; the B operand's rows 4t ..
    // are plane t >> 1, x = 4 (t & 1) .., column i = g: a_p[g][x ..]
    uint32_t lo, hi;
    get_split(s, 8 * (t >> 1) + g, 4 * (t & 1), lo, hi);
    __syncwarp();
    const Tile c = mma_const_a(k.t8d, lo, hi);
    Tile dq;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
        const int lv = quant((c.v[e] + 256) >> 9, q);
        if (levels != nullptr) levels[e >> 1][8 * (2 * t + (e & 1)) + g] = lv;
        dq.v[e] = dequant(lv, q);
    }
    // the inverse stage 1 transposed: [dq_p^T | 0] . [T8; 0]
    put(s, &dq, 1, lane);
    __syncwarp();
    AFrag dlo{0, 0}, dhi{0, 0};
    if (t < 2) {
        get_split(s, g, 4 * t, dlo.a0, dhi.a0);
        get_split(s, g + 8, 4 * t, dlo.a1, dhi.a1);
    }
    __syncwarp();
    const Tile r = mma_const_b(dlo, dhi, k.t8c_b);
#pragma unroll
    for (int e = 0; e < 4; ++e) a2t.v[e] = inv1(r.v[e]);
}

// ---------------------------------------------------------------------------
// (a) The carry kernel
// ---------------------------------------------------------------------------

struct __align__(16) Slot {
    uint8_t y[16][kLumaPitch];            // source luma rows
    uint8_t c[16][kChromaPitch];          // rows 0..7 u, 8..15 v
};

// What the chain needs of one CTB's source, per lane, in result layout
struct __align__(16) Pre {
    uint32_t hs[32][4];   // H(src): tiles 0, 1 as 16-bit pairs
    int ts[32][8];        // T16 . y: tiles 0, 1
    int tsc[32][4];       // T8 . u over T8 . v
};

// The rendezvous of `n` threads at named barrier `id`, which also orders
// their shared-memory accesses; bar_arrive counts the caller in without
// waiting.
__device__ __forceinline__ void bar_sync(int id, int n) {
    asm volatile("bar.sync %0, %1;" :: "r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
    asm volatile("bar.arrive %0, %1;" :: "r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void issue_chunk(Slot& slot, const uint8_t* y,
                                            const uint8_t* u,
                                            const uint8_t* v, int row,
                                            int ncw, int k, int lane) {
    const int c0 = k * kChunk, n = min(kChunk, ncw - c0);
    const int w = ncw * 16, wc = ncw * 8;
    stage_rows(&slot.y[0][0], kLumaPitch,
               y + static_cast<size_t>(row * 16) * w + c0 * 16, w, 16, n * 16,
               lane);
    const size_t coff = static_cast<size_t>(row * 8) * wc + c0 * 8;
    stage_rows(&slot.c[0][0], kChromaPitch, u + coff, wc, 8, n * 8, lane);
    stage_rows(&slot.c[8][0], kChromaPitch, v + coff, wc, 8, n * 8, lane);
}

__device__ __forceinline__ void store8(int* dst, const Tile* x) {
    *reinterpret_cast<int4*>(dst) =
        make_int4(x[0].v[0], x[0].v[1], x[0].v[2], x[0].v[3]);
    *reinterpret_cast<int4*>(dst + 4) =
        make_int4(x[1].v[0], x[1].v[1], x[1].v[2], x[1].v[3]);
}
__device__ __forceinline__ void load8(const int* src, Tile* x) {
    const int4 a = *reinterpret_cast<const int4*>(src);
    const int4 b = *reinterpret_cast<const int4*>(src + 4);
    x[0] = {{a.x, a.y, a.z, a.w}};
    x[1] = {{b.x, b.y, b.z, b.w}};
}

// The source terms of CTB mm of a staged chunk, one warp
__device__ __forceinline__ void produce_ctb(const Mats& k, const Slot& sl,
                                            int mm, Pre& pre, Buf& s,
                                            int lane) {
    const int g = lane >> 2, t = lane & 3;
    uint32_t b[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
        const uint8_t* col = &sl.y[4 * t][mm * 16 + g + 8 * j];
        b[j] = pack4(col[0], col[kLumaPitch], col[2 * kLumaPitch],
                     col[3 * kLumaPitch]);
    }
    const Tile ts[2] = {mma_su(k.t16, b[0]), mma_su(k.t16, b[1])};
    store8(pre.ts[lane], ts);
    Tile hs[2];
    hadamard(k, b, s, lane, hs);
    *reinterpret_cast<uint4*>(pre.hs[lane]) =
        make_uint4(pack2(hs[0].v[0], hs[0].v[1]), pack2(hs[0].v[2], hs[0].v[3]),
                   pack2(hs[1].v[0], hs[1].v[1]), pack2(hs[1].v[2], hs[1].v[3]));
    const uint8_t* col = &sl.c[8 * (t >> 1) + 4 * (t & 1)][mm * 8 + g];
    const Tile tsc = mma_su(k.t8d, pack4(col[0], col[kChromaPitch],
                                         col[2 * kChromaPitch],
                                         col[3 * kChromaPitch]));
    *reinterpret_cast<int4*>(pre.tsc[lane]) =
        make_int4(tsc.v[0], tsc.v[1], tsc.v[2], tsc.v[3]);
}

// Four values e[0..3] per lane, each summed over the 8 lanes of one tq (g =
// 0..7): lane (g, tq) ends with the sum of e[2 (lane >> 4) + (lane >> 3 &
// 1)] (lanes g and g ^ 1 alike).
__device__ __forceinline__ int sum_over_g(const int* e, int lane) {
    const bool hi = lane & 16, odd = lane & 8;
    int x0 = hi ? e[2] : e[0], x1 = hi ? e[3] : e[1];
    x0 += __shfl_xor_sync(kAll, hi ? e[0] : e[2], 16);
    x1 += __shfl_xor_sync(kAll, hi ? e[1] : e[3], 16);
    int sum = (odd ? x1 : x0) + __shfl_xor_sync(kAll, odd ? x0 : x1, 8);
    return sum + __shfl_xor_sync(kAll, sum, 4);
}

struct CarryOut {
    int32_t* mode;          // (nch, ncw)
    uint8_t* scratch;       // (nch, ncw, 32)
};

__global__ void __launch_bounds__(kCarryThreads, 2)
h265_intra_carry_kernel(const uint8_t* __restrict__ y,
                        const uint8_t* __restrict__ u,
                        const uint8_t* __restrict__ v, CarryOut out, int ncw,
                        int qp, int qp_c) {
    __shared__ Slot ring[kSlots];
    __shared__ Pre pre[2][kChunk];
    __shared__ __align__(16) Buf bufs[kCarryThreads / 32];
    __shared__ __align__(16) uint2 pred_b[kCands][32];   // B operands
    __shared__ __align__(16) uint8_t pred15[kCands][16];   // column 15
    __shared__ __align__(16) uint8_t cpred7[2][8];         // column 7
    __shared__ int best[2];     // the candidates' least key, by CTB parity
    __shared__ __align__(16) int left_y[16];
    __shared__ __align__(16) int left_c[2][8];

    const int row = blockIdx.x;
    const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
    const int nch = (ncw + kChunk - 1) / kChunk;
    const size_t ctb_row = static_cast<size_t>(row) * ncw;
    const Mats k = load_mats(lane);
    Buf& s = bufs[warp];

    const int g = lane >> 2, tq = lane & 3;
    if (warp > kChromaWarp) {
        // the producers
        const int pw = warp - kChromaWarp - 1;
        if (pw == 0) {
            for (int q = 0; q < kSlots; ++q) {
                if (q < nch) issue_chunk(ring[q], y, u, v, row, ncw, q, lane);
                __pipeline_commit();
            }
        }
        for (int q = 0; q < nch; ++q) {
            if (pw == 0) __pipeline_wait_prior(kSlots - 1);
            bar_sync(kProducerBar, 64);   // chunk q is staged
            const int n = min(kChunk, ncw - q * kChunk);
            for (int mm = pw; mm < n; mm += 2)
                produce_ctb(k, ring[q % kSlots], mm, pre[q & 1][mm], s, lane);
            bar_sync(kProducerBar, 64);   // both are done with its slot
            if (pw == 0) {
                if (q + kSlots < nch)
                    issue_chunk(ring[q % kSlots], y, u, v, row, ncw,
                                q + kSlots, lane);
                __pipeline_commit();
            }
            // hand chunk q over; the chain is done with chunk q - 1, whose
            // Pre slots the next iteration refills
            bar_sync(kHandoffBar, kCarryThreads);
        }
        return;
    }

    if (warp == kChromaWarp) {
        // chroma, off the chain: CTB m after the SATDs of m are in, while
        // the chain goes on to m + 1 (no candidate needs chroma)
        const Quant qc = make_quant(qp_c, 3);
        left_c[lane >> 4][(lane >> 1) & 7] = 128;
        bar_arrive(kHandoffBar, kCarryThreads);   // no earlier chunk
        for (int q = 0; q < nch; ++q) {
            const int n = min(kChunk, ncw - q * kChunk);
            for (int mm = 0; mm < n; ++mm) {
                const size_t ctb = ctb_row + q * kChunk + mm;
                bar_sync(kSatdBar, kChainThreads + 32);
                const int midx = best[ctb & 1] & 15;
                const Tile tsc =
                    *reinterpret_cast<const Tile*>(pre[q & 1][mm].tsc[lane]);
                if (mm == n - 1 && q + 1 < nch)   // done with chunk q's Pre
                    bar_arrive(kHandoffBar, kCarryThreads);
                if (lane >= 16)               // the left columns it is coded with
                    out.scratch[ctb * kScratch + lane] = static_cast<uint8_t>(
                        left_c[(lane >> 3) & 1][lane & 7]);
                const uint32_t b = chroma_pred4(midx, left_c, lane);
                if (g == 7)                   // column 7, plane tq >> 1
                    *reinterpret_cast<uint32_t*>(
                        &cpred7[tq >> 1][4 * (tq & 1)]) = b;
                Tile a2t;
                chroma_chain(k, tsc, b, qc, s, lane, a2t, nullptr);
                // inverse stage 2 at column 7, per plane: sum over kk = g of
                // a2t[(p, kk)][i] T8[kk][7]; e[2 p + c] is i = 2 tq + c
                const int e[4] = {a2t.v[0] * k.w7, a2t.v[1] * k.w7,
                                  a2t.v[2] * k.w7, a2t.v[3] * k.w7};
                const int sum = sum_over_g(e, lane);
                __syncwarp();                 // chroma_pred4 has read left_c
                if ((lane & 4) == 0) {
                    const int pl = lane >> 4, i = 2 * tq + ((lane >> 3) & 1);
                    left_c[pl][i] = recon(cpred7[pl][i], inv2(sum));
                }
                __syncwarp();
            }
        }
        return;
    }

    // the chain: warp m takes candidate m, then warp kLumaTail the luma
    // tail (scheduler 3, which neither the chroma warp nor a producer
    // shares)
    constexpr int kLumaTail = 3;
    const Quant ql = make_quant(qp, 4);
    if (t < 16) left_y[t] = 128;
    if (t < 2) best[t] = 0x7fffffff;

    for (int q = 0; q < nch; ++q) {
        bar_sync(kHandoffBar, kCarryThreads);    // chunk q's Pre is ready
        const int n = min(kChunk, ncw - q * kChunk);
        for (int mm = 0; mm < n; ++mm) {
            const Pre& pr = pre[q & 1][mm];
            const size_t ctb = ctb_row + q * kChunk + mm;
            // candidate `warp`: its SATD, and its luma stage 1 in case it
            // wins
            {
                const LumaRef ref = luma_ref(left_y, lane);
                int p[8];
                luma_pred(warp, ref, lane, p);
                const uint32_t b[2] = {pack4(p[0], p[1], p[2], p[3]),
                                       pack4(p[4], p[5], p[6], p[7])};
                if (g == 7)                   // column 15, rows 4 tq ..
                    *reinterpret_cast<uint32_t*>(&pred15[warp][4 * tq]) = b[1];
                pred_b[warp][lane] = make_uint2(b[0], b[1]);
                Tile z[2];
                hadamard(k, b, s, lane, z);
                const uint4 h = *reinterpret_cast<const uint4*>(pr.hs[lane]);
                const uint32_t hw[4] = {h.x, h.y, h.z, h.w};
                // per 8x8 block (by, bx) = (row half, tile): this lane's
                // part, the block's sum over the warp, >> 2, added
                int sum = 0;
#pragma unroll
                for (int j = 0; j < 2; ++j) {
#pragma unroll
                    for (int by = 0; by < 2; ++by) {
                        const uint32_t w2 = hw[2 * j + by];
                        const int d = iabs(static_cast<int16_t>(w2 & 0xffff)
                                           - z[j].v[2 * by])
                                      + iabs((static_cast<int>(w2) >> 16)
                                             - z[j].v[2 * by + 1]);
                        sum += __reduce_add_sync(kAll, d) >> 2;
                    }
                }
                if (lane == 0) atomicMin(&best[ctb & 1], 16 * sum + warp);
                if (warp == kCands - 1 && lane < 16)   // the left column
                    out.scratch[ctb * kScratch + lane] =   // it is coded with
                        static_cast<uint8_t>(left_y[lane]);
            }
            Tile ts[2];                       // ahead of the barrier
            if (warp == kLumaTail) load8(pr.ts[lane], ts);
            bar_sync(kSatdBar, kChainThreads + 32);
            // the first minimum in _MODES order: the least key (ties go to
            // the lower index)
            if (warp == kLumaTail) {
                const int midx = best[ctb & 1] & 15;
                if (lane == 0) {
                    out.mode[ctb] = kModes[midx];
                    best[(ctb & 1) ^ 1] = 0x7fffffff;   // the next CTB's
                }
                const uint2 pb = pred_b[midx][lane];
                const uint32_t b[2] = {pb.x, pb.y};
                Tile a[2], a2t[2];
                luma_fwd1(k, ts, b, a);
                put(s, a, 2, lane);
                __syncwarp();
                luma_back(k, s, ql, s, lane, a2t, nullptr);
                // inverse stage 2 at column 15: sum over kk of a2t[kk][i]
                // T16[kk][15]; this lane holds kk = g, g + 8 and i = 8 j +
                // 2 tq + c (e[2 j + c])
                int e[4];
#pragma unroll
                for (int j = 0; j < 2; ++j) {
#pragma unroll
                    for (int c = 0; c < 2; ++c)
                        e[2 * j + c] = a2t[j].v[c] * k.w15[0]
                                       + a2t[j].v[c + 2] * k.w15[1];
                }
                const int sum = sum_over_g(e, lane);
                if ((lane & 4) == 0) {
                    const int i = 8 * (lane >> 4) + 2 * tq + ((lane >> 3) & 1);
                    left_y[i] = recon(pred15[midx][i], inv2(sum));
                }
            }
            bar_sync(kLeftBar, kChainThreads);   // the next left column
        }
    }
}

// ---------------------------------------------------------------------------
// (b) The code kernel
// ---------------------------------------------------------------------------

struct CodeOut {
    const int32_t* mode;    // (nch, ncw), from the carry kernel
    int32_t* luma_lv;       // (nch, ncw, 16, 16)
    int32_t* cb_lv;         // (nch, ncw, 8, 8)
    int32_t* cr_lv;
    uint8_t *y, *u, *v;     // the reconstruction planes
    uint8_t* is_intra;      // (nch, ncw) bool
    uint8_t* tu_split;      // (nch, ncw) bool
    int32_t* mv;            // (nch, ncw, 2)
};

// 8 bytes at p as two words, and back (p need not be aligned)
__device__ __forceinline__ uint2 load_row8(const uint8_t* p) {
    if ((reinterpret_cast<uintptr_t>(p) & 7) == 0)
        return *reinterpret_cast<const uint2*>(p);
    return make_uint2(pack4(p[0], p[1], p[2], p[3]),
                      pack4(p[4], p[5], p[6], p[7]));
}
__device__ __forceinline__ void store_row8(uint8_t* p, uint2 v) {
    if ((reinterpret_cast<uintptr_t>(p) & 7) == 0) {
        *reinterpret_cast<uint2*>(p) = v;
        return;
    }
#pragma unroll
    for (int k = 0; k < 8; ++k)
        p[k] = static_cast<uint8_t>((k < 4 ? v.x : v.y) >> (8 * (k & 3)));
}

// One warp's workspace
struct __align__(16) CodeWork {
    Buf s;
    uint8_t src[16][16];          // [y][x]
    uint8_t csrc[2][8][8];        // [p][y][x]
    uint8_t pred_t[16][16];       // [x][y]
    uint8_t cpred_t[2][8][8];     // [p][x][y]
    uint8_t rec[16][16];          // [y][x]
    uint8_t crec[2][8][8];        // [p][y][x]
    int left_c[2][8];
};

// One CTB per warp, no barrier but the warp's own.
__global__ void __launch_bounds__(256)
h265_intra_code_kernel(const uint8_t* __restrict__ y,
                       const uint8_t* __restrict__ u,
                       const uint8_t* __restrict__ v,
                       const uint8_t* __restrict__ scratch, CodeOut out,
                       int nch, int ncw, int qp, int qp_c) {
    __shared__ CodeWork work[8];
    const int lane = threadIdx.x & 31;
    const int ctb_i = blockIdx.x * 8 + (threadIdx.x >> 5);
    if (ctb_i >= nch * ncw) return;       // whole warps
    CodeWork& ws = work[threadIdx.x >> 5];
    const size_t ctb = ctb_i;
    const int row = ctb_i / ncw, col = ctb_i - row * ncw;
    const int w = ncw * 16, wc = ncw * 8;
    const int g = lane >> 2, t = lane & 3;
    const Mats k = load_mats(lane);
    int midx = 0;
    const int mode = out.mode[ctb];
#pragma unroll
    for (int m = 1; m < kCands; ++m)
        if (kModes[m] == mode) midx = m;
    const uint8_t* left = scratch + ctb * kScratch;
    if (lane >= 16) ws.left_c[(lane >> 3) & 1][lane & 7] = left[lane];
    const LumaRef ref = luma_ref(left, lane);
    // the source rows, 8 bytes a lane
    *reinterpret_cast<uint2*>(&ws.src[lane >> 1][8 * (lane & 1)]) = load_row8(
        y + static_cast<size_t>(row * 16 + (lane >> 1)) * w + col * 16
        + 8 * (lane & 1));
    if (lane < 16)
        *reinterpret_cast<uint2*>(&ws.csrc[lane >> 3][lane & 7][0]) =
            load_row8((lane >> 3 ? v : u)
                      + static_cast<size_t>(row * 8 + (lane & 7)) * wc
                      + col * 8);
    __syncwarp();

    // luma: the prediction and the source as B operands (column g + 8 j,
    // rows 4 t ..), T16 . src
    int p[8];
    luma_pred(midx, ref, lane, p);
    uint32_t b[2], bs[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
        b[j] = pack4(p[4 * j], p[4 * j + 1], p[4 * j + 2], p[4 * j + 3]);
        *reinterpret_cast<uint32_t*>(&ws.pred_t[g + 8 * j][4 * t]) = b[j];
        const int x = g + 8 * j;
        bs[j] = pack4(ws.src[4 * t][x], ws.src[4 * t + 1][x],
                      ws.src[4 * t + 2][x], ws.src[4 * t + 3][x]);
    }
    const Tile ts[2] = {mma_su(k.t16, bs[0]), mma_su(k.t16, bs[1])};
    Tile a[2], a2t[2];
    luma_fwd1(k, ts, b, a);
    put(ws.s, a, 2, lane);
    __syncwarp();
    luma_back(k, ws.s, make_quant(qp, 4), ws.s, lane, a2t,
              out.luma_lv + ctb * 256);
    // inverse stage 2 transposed: res^T = T16^T . a2^T, whose B operand of
    // tile j is column g + 8 j of a2^T (row g + 8 j of a2)
    put_t(ws.s, a2t, 2, lane);
    __syncwarp();
    {
        uint32_t lo[2], hi[2];
        get_split(ws.s, g, 4 * t, lo[0], hi[0]);
        get_split(ws.s, g + 8, 4 * t, lo[1], hi[1]);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
            const Tile r = mma_const_a(k.t16t, lo[j], hi[j]);
            // (jj, i) = (g + 8 (e >> 1), 8 j + 2 t + (e & 1))
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int jj = g + 8 * (e >> 1), i = 8 * j + 2 * t + (e & 1);
                ws.rec[i][jj] = static_cast<uint8_t>(
                    recon(ws.pred_t[jj][i], inv2(r.v[e])));
            }
        }
    }

    // chroma: both planes stacked, (p, y) = (t >> 1, 4 (t & 1) ..), x = g
    __syncwarp();                         // left_c is in place
    const uint32_t cb = chroma_pred4(midx, ws.left_c, lane);
    *reinterpret_cast<uint32_t*>(&ws.cpred_t[t >> 1][g][4 * (t & 1)]) = cb;
    const uint8_t(*cs)[8] = &ws.csrc[t >> 1][4 * (t & 1)];
    const Tile tsc = mma_su(k.t8d, pack4(cs[0][g], cs[1][g], cs[2][g],
                                         cs[3][g]));
    int32_t* clv[2] = {out.cb_lv + ctb * 64, out.cr_lv + ctb * 64};
    Tile ca2t;
    chroma_chain(k, tsc, cb, make_quant(qp_c, 3), ws.s, lane, ca2t, clv);
    // inverse stage 2 transposed per plane: res_p^T = T8^T . a2_p^T, B rows
    // (p, kk) = (t >> 1, 4 (t & 1) ..), column i = g: a2_p[g][kk ..]
    {
        Tile tr = ca2t;
        // a2_p[i][kk] at [8 p + i][kk]: element ((p, kk), i) of a2t
        const int t2 = 2 * t;
#pragma unroll
        for (int e = 0; e < 4; ++e)
            ws.s[8 * (e >> 1) + t2 + (e & 1)][g] = static_cast<int16_t>(tr.v[e]);
        __syncwarp();
        uint32_t lo, hi;
        get_split(ws.s, 8 * (t >> 1) + g, 4 * (t & 1), lo, hi);
        const Tile r = mma_const_a(k.t8dt, lo, hi);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int pl = e >> 1, i = t2 + (e & 1);
            ws.crec[pl][i][g] = static_cast<uint8_t>(
                recon(ws.cpred_t[pl][g][i], inv2(r.v[e])));
        }
    }
    __syncwarp();
    // the reconstruction, a row of 8 bytes per lane
    store_row8(out.y + static_cast<size_t>(row * 16 + (lane >> 1)) * w
                   + col * 16 + 8 * (lane & 1),
               *reinterpret_cast<const uint2*>(
                   &ws.rec[lane >> 1][8 * (lane & 1)]));
    if (lane < 16)
        store_row8((lane >> 3 ? out.v : out.u)
                       + static_cast<size_t>(row * 8 + (lane & 7)) * wc
                       + col * 8,
                   *reinterpret_cast<const uint2*>(
                       &ws.crec[lane >> 3][lane & 7][0]));
    if (lane == 0) out.is_intra[ctb] = 1;
    if (lane == 1) out.tu_split[ctb] = 0;
    if (lane == 2 || lane == 3) out.mv[ctb * 2 + (lane - 2)] = 0;
}

}  // namespace

extern "C" int h265_intra_carry_launch(const void* y, const void* u,
                                       const void* v, void* mode,
                                       void* scratch, int nch, int ncw,
                                       int qp, int qp_c, void* stream) {
    const CarryOut out{static_cast<int32_t*>(mode),
                       static_cast<uint8_t*>(scratch)};
    h265_intra_carry_kernel<<<nch, kCarryThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(y), static_cast<const uint8_t*>(u),
        static_cast<const uint8_t*>(v), out, ncw, qp, qp_c);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int h265_intra_code_launch(const void* y, const void* u,
                                      const void* v, const void* scratch,
                                      const void* mode, void* luma_lv,
                                      void* cb_lv, void* cr_lv, void* oy,
                                      void* ou, void* ov, void* is_intra,
                                      void* tu_split, void* mv, int nch,
                                      int ncw, int qp, int qp_c,
                                      void* stream) {
    const CodeOut out{static_cast<const int32_t*>(mode),
                      static_cast<int32_t*>(luma_lv),
                      static_cast<int32_t*>(cb_lv),
                      static_cast<int32_t*>(cr_lv),
                      static_cast<uint8_t*>(oy),
                      static_cast<uint8_t*>(ou),
                      static_cast<uint8_t*>(ov),
                      static_cast<uint8_t*>(is_intra),
                      static_cast<uint8_t*>(tu_split),
                      static_cast<int32_t*>(mv)};
    h265_intra_code_kernel<<<(nch * ncw + 7) / 8, 256, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(y), static_cast<const uint8_t*>(u),
        static_cast<const uint8_t*>(v),
        static_cast<const uint8_t*>(scratch), out, nch, ncw, qp, qp_c);
    return static_cast<int>(cudaGetLastError());
}
