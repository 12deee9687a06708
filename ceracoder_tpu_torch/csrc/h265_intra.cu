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
// column 0 sees 128. The kernel also writes the constant outputs of an
// intra frame (is_intra 1, tu_split 0, mv 0).
//
// Design: one CTA of 256 threads per CTB row, looping over the CTB columns
// with the left columns in shared memory. Per column:
//   S1  the smoothed luma reference and the DCs (36 threads);
//   S2  thread t predicts luma sample t for all 12 candidates and keeps the
//       differences in shared memory (12 x 256);
//   S3  the Hadamard row pass: 384 8-sample row vectors over 256 threads;
//   S4  the column pass, |.| summed over 8-lane groups by shuffles: 48
//       8x8 SATDs (12 candidates x 4 blocks);
//   S5  every thread takes the first minimum; luma forward stage 1; the
//       chroma residual (threads 0..127: component t / 64, sample t % 64);
//   S6-S9 the rest of the luma and chroma transform chains, chroma one
//       stage behind luma, thread t owning one coefficient of each.
// Nine block barriers per column. The next column's samples are loaded
// while this one is coded.
//
// int32 ranges (a residual is at most 255 in magnitude, and the absolute
// row sums of T16 and T8 are at most 1024 and 512): the forward stage 1
// sum is at most 1024 * 255 = 261,120 (about 2^18), a coefficient at most
// 32,640; quant's |coef| * scale at most 32,640 * 26,214 = 8.6e8 (about
// 2^30) and its offset 171 << 16 = 1.1e7 at qp 51; a level is at most
// 6,529 (qp 0), so the dequant product is at most 6,529 * 640 = 4.2e6 at
// qp 0 and 18 * 233,472 = 4.2e6 at qp 51; the inverse stages sum at most
// 1024 * 32,768 = 3.4e7. The SATD's Hadamard values stay under 16,320,
// their sums under 2^20. Every right shift of a negative value is
// arithmetic, as torch's, and levels are sign * magnitude.
//
// Bound: bytes. At 1080p one call reads the three planes (3.13 MB) and
// writes the reconstruction (3.13 MB), the levels (12.5 MB as int32) and
// the per-CTB outputs (0.16 MB): 19 MB, 5.7 us at 3.35 TB/s. The real
// floor is the dependency chain: 120 CTB columns one after another, nine
// barriers each, on 68 of the 132 SMs.
//
// The launch goes on the caller's stream; the C entry point returns
// cudaGetLastError() so the wrapper can raise on a refused launch.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCands = 12;

// _MODES: candidate index -> intra mode; the angles of modes 2..9
__constant__ int kModes[kCands] = {0, 1, 10, 26, 2, 3, 4, 5, 6, 7, 8, 9};
__constant__ int kAngle[8] = {32, 26, 21, 17, 13, 9, 5, 2};
// codec/h265/tables.py: QUANT_SCALES, INV_QUANT_SCALES, T16, T8
__constant__ int kQuant[6] = {26214, 23302, 20560, 18396, 16384, 14564};
__constant__ int kInvQuant[6] = {40, 45, 51, 57, 64, 72};
__constant__ int kT16[16][16] = {
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
    {9, -25, 43, -57, 70, -80, 87, -90, 90, -87, 80, -70, 57, -43, 25, -9}};
__constant__ int kT8[8][8] = {
    {64, 64, 64, 64, 64, 64, 64, 64},
    {89, 75, 50, 18, -18, -50, -75, -89},
    {83, 36, -36, -83, -83, -36, 36, 83},
    {75, -18, -89, -50, 50, 89, 18, -75},
    {64, -64, -64, 64, 64, -64, -64, 64},
    {50, -89, 18, 75, -75, -18, 89, -50},
    {36, -83, 83, -36, -36, 83, -83, 36},
    {18, -50, 75, -89, 89, -75, 50, -18}};

__device__ __forceinline__ int iabs(int x) { return x < 0 ? -x : x; }
__device__ __forceinline__ int isign(int x) { return (x > 0) - (x < 0); }
__device__ __forceinline__ int clamp_to(int x, int lo, int hi) {
    return min(max(x, lo), hi);
}

// luma candidate m at (y, x): left the left column (16), fl the smoothed
// reference extended to 33 entries (fl[32] == fl[31]), dc the DC value
__device__ __forceinline__ int luma_pred(int m, int y, int x, const int* left,
                                         const int* fl, int dc) {
    const int c = left[0];
    switch (m) {
        case 0:     // planar; top == corner, p[-1][16] == fl[16]
            return ((15 - x) * fl[y] + (x + 1) * c + (15 - y) * c
                    + (y + 1) * fl[16] + 16) >> 5;
        case 1:     // DC with its edge filters
            if (y == 0 && x == 0) return (left[0] + 2 * dc + c + 2) >> 2;
            if (y == 0) return (c + 3 * dc + 2) >> 2;
            if (x == 0) return (left[y] + 3 * dc + 2) >> 2;
            return dc;
        case 2:     // horizontal
            return left[y];
        case 3:     // vertical, column-0 filter
            return x == 0 ? clamp_to(c + ((left[y] - c) >> 1), 0, 255) : c;
        default: {  // angular 2..9: two taps along the left reference
            const int pos = (x + 1) * kAngle[m - 4];
            const int i0 = y + (pos >> 5), f = pos & 31;
            int r0, r1;
            if (m < 11) {
                r0 = fl[i0];
                r1 = fl[i0 + 1];
            } else {
                r0 = left[min(i0, 15)];
                r1 = left[min(i0 + 1, 15)];
            }
            return ((32 - f) * r0 + f * r1 + 16) >> 5;
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

// 8-point Walsh-Hadamard transform in place (any row order: only the
// absolute sum is used)
__device__ __forceinline__ void wht8(int* v) {
#pragma unroll
    for (int h = 1; h < 8; h <<= 1) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            if ((i & h) == 0) {
                const int a = v[i], b = v[i + h];
                v[i] = a + b;
                v[i + h] = a - b;
            }
        }
    }
}

__device__ __forceinline__ int quant(int coef, int qp, int qbits) {
    const int off = 171 << (qbits - 9);
    return isign(coef) * ((iabs(coef) * kQuant[qp % 6] + off) >> qbits);
}

__device__ __forceinline__ int dequant(int level, int qp, int bd_shift) {
    const int scale = (kInvQuant[qp % 6] * 16) << (qp / 6);
    return clamp_to((level * scale + (1 << (bd_shift - 1))) >> bd_shift,
                    -32768, 32767);
}

struct Out {
    int32_t* mode;          // (nch, ncw)
    int32_t* luma_lv;       // (nch, ncw, 16, 16)
    int32_t* cb_lv;         // (nch, ncw, 8, 8)
    int32_t* cr_lv;
    uint8_t *y, *u, *v;     // the reconstruction planes
    uint8_t* is_intra;      // (nch, ncw) bool
    uint8_t* tu_split;      // (nch, ncw) bool
    int32_t* mv;            // (nch, ncw, 2)
};

__global__ void __launch_bounds__(kThreads)
h265_intra_kernel(const uint8_t* __restrict__ y,
                  const uint8_t* __restrict__ u,
                  const uint8_t* __restrict__ v, Out out, int ncw, int qp,
                  int qp_c) {
    __shared__ int t16[16][16], t8[8][8];
    __shared__ int left_y[16], left_c[2][8];
    __shared__ int fl[33];                  // smoothed luma reference
    __shared__ int dcs[3];                  // luma, cb, cr DC
    __shared__ int diff[kCands][256];       // source - candidate
    __shared__ int work[kCands][256];       // Hadamard rows, then stages
    __shared__ int s8[kCands * 4];          // 8x8 SATDs

    const int row = blockIdx.x;
    const int t = threadIdx.x;
    const int w = ncw * 16, wc = ncw * 8;
    // luma: sample / coefficient (i, j) of the CTB
    const int i = t >> 4, j = t & 15;
    const size_t yoff = static_cast<size_t>(row * 16 + i) * w + j;
    // chroma (t < 128): component comp, sample (ci, cj)
    const bool has_c = t < 128;
    const int comp = (t >> 6) & 1, e = t & 63, ci = e >> 3, cj = e & 7;
    const uint8_t* cin = comp == 0 ? u : v;
    const size_t coff = static_cast<size_t>(row * 8 + ci) * wc + cj;
    // luma transform stages: a, dequantized levels, inverse stage 1;
    // chroma: residual, a, dequantized levels, inverse stage 1
    int* la = work[0];
    int* ldq = work[1];
    int* la2 = work[2];
    int* cres = work[3];
    int* ca = work[3] + 128;
    int* cdq = work[4];
    int* ca2 = work[4] + 128;

    t16[i][j] = kT16[i][j];
    if (t < 64) t8[t >> 3][t & 7] = kT8[t >> 3][t & 7];
    if (t < 16) left_y[t] = 128;
    if (t < 16) left_c[t >> 3][t & 7] = 128;

    int o = y[yoff];
    int oc = has_c ? cin[coff] : 0;
    __syncthreads();

    for (int c = 0; c < ncw; ++c) {
        const size_t ctb = static_cast<size_t>(row) * ncw + c;
        int o_next = 0, oc_next = 0;
        if (c + 1 < ncw) {
            o_next = y[yoff + (c + 1) * 16];
            if (has_c) oc_next = cin[coff + (c + 1) * 8];
        }

        // S1: the smoothed luma reference (ext = [corner, left2]), DCs
        if (t < 33) {
            if (t < 31) {
                const int e0 = left_y[min(max(t - 1, 0), 15)];
                const int e1 = left_y[min(t, 15)];
                const int e2 = left_y[min(t + 1, 15)];
                fl[t] = (e0 + 2 * e1 + e2 + 2) >> 2;
            } else {
                fl[t] = left_y[15];
            }
        } else if (t == 33) {
            int s = 0;
#pragma unroll
            for (int k = 0; k < 16; ++k) s += left_y[k];
            dcs[0] = (s + 16 * left_y[0] + 16) >> 5;
        } else if (t < 36) {
            const int* l = left_c[t - 34];
            int s = 0;
#pragma unroll
            for (int k = 0; k < 8; ++k) s += l[k];
            dcs[t - 33] = (s + 8 * l[0] + 8) >> 4;
        }
        __syncthreads();

        // S2: the differences to all 12 luma candidates
#pragma unroll
        for (int m = 0; m < kCands; ++m)
            diff[m][t] = o - luma_pred(m, i, j, left_y, fl, dcs[0]);
        __syncthreads();

        // S3: Hadamard rows: item q = (candidate, row, half)
        for (int q = t; q < kCands * 32; q += kThreads) {
            const int m = q >> 5, base = ((q >> 1) & 15) * 16 + (q & 1) * 8;
            int vals[8];
#pragma unroll
            for (int k = 0; k < 8; ++k) vals[k] = diff[m][base + k];
            wht8(vals);
#pragma unroll
            for (int k = 0; k < 8; ++k) work[m][base + k] = vals[k];
        }
        __syncthreads();

        // S4: Hadamard columns: item q = (candidate, 8x8 block, column);
        // the 8 columns of a block lie on 8 consecutive lanes (warp-
        // uniform loop: 256 items, then 128 on warps 0..3)
        for (int q = t; q < kCands * 32; q += kThreads) {
            const int b = q >> 3, m = b >> 2, blk = b & 3;
            const int col = (blk & 1) * 8 + (q & 7);
            const int r0 = (blk >> 1) * 8;
            int vals[8];
#pragma unroll
            for (int k = 0; k < 8; ++k) vals[k] = work[m][(r0 + k) * 16 + col];
            wht8(vals);
            int s = 0;
#pragma unroll
            for (int k = 0; k < 8; ++k) s += iabs(vals[k]);
            s += __shfl_xor_sync(0xffffffffu, s, 1);
            s += __shfl_xor_sync(0xffffffffu, s, 2);
            s += __shfl_xor_sync(0xffffffffu, s, 4);
            if ((q & 7) == 0) s8[b] = s >> 2;
        }
        __syncthreads();

        // S5: the first minimum; luma forward stage 1; chroma residual
        int midx = 0, best = 0;
#pragma unroll
        for (int m = 0; m < kCands; ++m) {
            const int sat = s8[4 * m] + s8[4 * m + 1] + s8[4 * m + 2]
                            + s8[4 * m + 3];
            if (m == 0 || sat < best) {
                best = sat;
                midx = m;
            }
        }
        const int* res = diff[midx];
        const int lpred = o - res[t];
        {
            int acc = 0;
#pragma unroll
            for (int k = 0; k < 16; ++k) acc += t16[i][k] * res[k * 16 + j];
            la[t] = (acc + 4) >> 3;
        }
        int cpred = 0;
        if (has_c) {
            cpred = chroma_pred(midx, ci, cj, left_c[comp], dcs[1 + comp]);
            cres[t] = oc - cpred;
        }
        if (t == 0) out.mode[ctb] = kModes[midx];
        if (t == 1) out.is_intra[ctb] = 1;
        if (t == 2) out.tu_split[ctb] = 0;
        if (t == 3 || t == 4) out.mv[ctb * 2 + (t - 3)] = 0;
        __syncthreads();

        // S6: luma stage 2, quant, dequant; chroma forward stage 1
        {
            int acc = 0;
#pragma unroll
            for (int k = 0; k < 16; ++k) acc += la[i * 16 + k] * t16[j][k];
            const int lv = quant((acc + 512) >> 10, qp, 17 + qp / 6);
            out.luma_lv[ctb * 256 + t] = lv;
            ldq[t] = dequant(lv, qp, 7);
        }
        if (has_c) {
            const int* r = cres + comp * 64;
            int acc = 0;
#pragma unroll
            for (int k = 0; k < 8; ++k) acc += t8[ci][k] * r[k * 8 + cj];
            ca[t] = (acc + 2) >> 2;
        }
        __syncthreads();

        // S7: luma inverse stage 1; chroma stage 2, quant, dequant
        {
            int acc = 0;
#pragma unroll
            for (int k = 0; k < 16; ++k) acc += t16[k][i] * ldq[k * 16 + j];
            la2[t] = clamp_to((acc + 64) >> 7, -32768, 32767);
        }
        if (has_c) {
            const int* a = ca + comp * 64;
            int acc = 0;
#pragma unroll
            for (int k = 0; k < 8; ++k) acc += a[ci * 8 + k] * t8[cj][k];
            const int lv = quant((acc + 256) >> 9, qp_c, 18 + qp_c / 6);
            int32_t* dst = comp == 0 ? out.cb_lv : out.cr_lv;
            dst[ctb * 64 + e] = lv;
            cdq[t] = dequant(lv, qp_c, 6);
        }
        __syncthreads();

        // S8: luma inverse stage 2 and reconstruction; chroma inverse
        // stage 1
        {
            int acc = 0;
#pragma unroll
            for (int k = 0; k < 16; ++k) acc += la2[i * 16 + k] * t16[k][j];
            const int r = clamp_to((acc + 2048) >> 12, -32768, 32767);
            const int rec = clamp_to(lpred + r, 0, 255);
            out.y[yoff + c * 16] = static_cast<uint8_t>(rec);
            if (j == 15) left_y[i] = rec;
        }
        if (has_c) {
            const int* d = cdq + comp * 64;
            int acc = 0;
#pragma unroll
            for (int k = 0; k < 8; ++k) acc += t8[k][ci] * d[k * 8 + cj];
            ca2[t] = clamp_to((acc + 64) >> 7, -32768, 32767);
        }
        __syncthreads();

        // S9: chroma inverse stage 2 and reconstruction
        if (has_c) {
            const int* a = ca2 + comp * 64;
            int acc = 0;
#pragma unroll
            for (int k = 0; k < 8; ++k) acc += a[ci * 8 + k] * t8[k][cj];
            const int r = clamp_to((acc + 2048) >> 12, -32768, 32767);
            const int rec = clamp_to(cpred + r, 0, 255);
            uint8_t* dst = comp == 0 ? out.u : out.v;
            dst[coff + c * 8] = static_cast<uint8_t>(rec);
            if (cj == 7) left_c[comp][ci] = rec;
        }
        __syncthreads();
        o = o_next;
        oc = oc_next;
    }
}

}  // namespace

extern "C" int h265_intra_launch(const void* y, const void* u, const void* v,
                                 void* mode, void* luma_lv, void* cb_lv,
                                 void* cr_lv, void* oy, void* ou, void* ov,
                                 void* is_intra, void* tu_split, void* mv,
                                 int nch, int ncw, int qp, int qp_c,
                                 void* stream) {
    Out out{static_cast<int32_t*>(mode), static_cast<int32_t*>(luma_lv),
            static_cast<int32_t*>(cb_lv),  static_cast<int32_t*>(cr_lv),
            static_cast<uint8_t*>(oy),     static_cast<uint8_t*>(ou),
            static_cast<uint8_t*>(ov),     static_cast<uint8_t*>(is_intra),
            static_cast<uint8_t*>(tu_split), static_cast<int32_t*>(mv)};
    h265_intra_kernel<<<nch, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(y), static_cast<const uint8_t*>(u),
        static_cast<const uint8_t*>(v), out, ncw, qp, qp_c);
    return static_cast<int>(cudaGetLastError());
}
