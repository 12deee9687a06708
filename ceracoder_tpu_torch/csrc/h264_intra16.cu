// K3: the H.264 Intra_16x16 macroblock coder over the MB columns of a
// frame, one slice per MB row, hand-written for Hopper.
//
// Replaces the column loop of ops/intra.py:_encode_mb_cols_ref, which
// serves both the IDR frame (encode_frame_i16_rows) and the intra-in-P
// scan (ops/inter.py:_intra_fallback). On the TPU both are XLA-lowered
// lax.scans over MB columns (ceracoder_tpu/ops/intra.py:
// encode_frame_i16_rows, ceracoder_tpu/ops/inter.py:_intra_fallback, no
// Pallas source). Per MB, in order:
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
// Design: one CTA of 256 threads per MB row, looping over the MB columns
// with the left columns in shared memory. Thread t owns luma sample
// (4*by + i, 4*bx + j) of 4x4 block b = t / 16 = (by, bx), (i, j) =
// ((t / 4) % 4, t % 4), through every stage: its sample, residual,
// coefficient (i, j) of block b, and its reconstruction. Threads 0..127
// own the chroma samples the same way (component t / 64, 2x2 blocks).
// Block reductions (warp shuffles, then 8 per-warp partials) give the
// SADs; the 16 luma and 2x4 chroma DCs go through the Hadamards on 24
// threads of warp 0. The next MB's samples are loaded while this one is
// coded.
//
// int32 ranges (a residual is at most 255 in magnitude): a core transform
// coefficient is at most 36 * 255 = 9180, a luma DC after the floored
// Hadamard 32640, so quant's |w| * MF stays under 4.3e8 and its offset
// under 5.6e6 at qp 51; a dequantized coefficient is at most 1.1e5 at
// qp 0 and 5.8e4 at qp 51; the dequantized luma DC at most 3.0e7 (qp 0)
// and the chroma DC 2.1e6 (qp_c 0 and 51): far inside int32 throughout.
// Shifts left are written as products, and every right shift of a
// negative value is arithmetic, as torch's.
//
// Bound: bytes. At 1080p one IDR call reads the three planes (3.13 MB)
// and writes the reconstruction (3.13 MB) and the levels and modes
// (6.28 MB): 12.5 MB, 3.7 us at 3.35 TB/s; the scan also reads the inter
// reconstruction (3.13 MB). The real floor is the dependency chain: 120
// MB columns one after another, each a chain of transform stages with a
// barrier between them, on 68 of the 132 SMs.
//
// The launch goes on the caller's stream; the C entry point returns
// cudaGetLastError() so the wrapper can raise on a refused launch.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

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

__device__ __forceinline__ int iabs(int x) { return x < 0 ? -x : x; }
__device__ __forceinline__ int isign(int x) { return (x > 0) - (x < 0); }

// quant4 (intra rounding) for one coefficient of position class pc
__device__ __forceinline__ int quant_ac(int w, int qp, int pc) {
    const int qbits = 15 + qp / 6;
    const int f = (1 << qbits) / 3;
    return isign(w) * ((iabs(w) * kMF[qp % 6][pc] + f) >> qbits);
}

// quant_dc4 / quant_dc2: MF(0,0), qbits + 1, twice the intra offset
__device__ __forceinline__ int quant_dc(int w, int qp) {
    const int qbits = 15 + qp / 6;
    const int f = ((1 << qbits) / 3) * 2;
    return isign(w) * ((iabs(w) * kMF[qp % 6][0] + f) >> (qbits + 1));
}

// forward core transform: coefficient (i, j) of the 4x4 block at x
// (row stride 4), Cf X Cf^T
__device__ __forceinline__ int fdct_coef(const int* x, int i, int j) {
    int acc = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        const int* r = x + 4 * k;
        const int s = kCf[j][0] * r[0] + kCf[j][1] * r[1] + kCf[j][2] * r[2]
                      + kCf[j][3] * r[3];
        acc += kCf[i][k] * s;
    }
    return acc;
}

// one 4-point inverse butterfly (spec 8.5.12.2) on d0..d3, output k
__device__ __forceinline__ int idct_1d(int d0, int d1, int d2, int d3,
                                       int k) {
    const int e0 = d0 + d2, e1 = d0 - d2;
    const int e2 = (d1 >> 1) - d3, e3 = d1 + (d3 >> 1);
    switch (k) {
        case 0: return e0 + e3;
        case 1: return e1 + e2;
        case 2: return e1 - e2;
        default: return e0 - e3;
    }
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

struct Out {
    int16_t* dc_luma;       // (mbh, mbw, 16), zigzag
    int16_t* ac_luma;       // (mbh, mbw, 4, 4, 15)
    uint8_t* mode_luma;     // (mbh, mbw)
    int16_t* dc_chroma;     // (mbh, mbw, 2, 4)
    int16_t* ac_chroma;     // (mbh, mbw, 2, 2, 2, 15)
    uint8_t* mode_chroma;   // (mbh, mbw)
    uint8_t *y, *u, *v;     // the intra reconstruction planes
};

__global__ void __launch_bounds__(kThreads)
h264_intra16_kernel(const uint8_t* __restrict__ y,
                    const uint8_t* __restrict__ u,
                    const uint8_t* __restrict__ v,
                    const uint8_t* __restrict__ is_intra,   // or null
                    const uint8_t* __restrict__ ry,         // inter recon
                    const uint8_t* __restrict__ ru,
                    const uint8_t* __restrict__ rv, Out out, int mbw,
                    int qp, int qp_c) {
    __shared__ int left_y[16];
    __shared__ int left_c[2][8];
    __shared__ int red[kThreads / 32][4];
    __shared__ int res_y[256], res_c[128];    // residual, then row pass
    __shared__ int deq_y[256], deq_c[128];    // dequantized coefficients
    __shared__ int dcw_y[16], dcw_c[8];       // forward DCs
    __shared__ int zdc_y[16], zdc_c[8];       // quantized DCs

    const int row = blockIdx.x;
    const int t = threadIdx.x;
    const int lane = t & 31, warp = t >> 5;
    const int w = mbw * 16, wc = mbw * 8;
    // luma: block b = (by, bx), sample (i, j) inside it
    const int b = t >> 4, by = b >> 2, bx = b & 3;
    const int i = (t >> 2) & 3, j = t & 3;
    const int ly = 4 * by + i, lx = 4 * bx + j;
    const size_t yoff = static_cast<size_t>(row * 16 + ly) * w + lx;
    // chroma (t < 128): component comp, 2x2 block cb = (cby, cbx)
    const bool has_c = t < 128;
    const int comp = (t >> 6) & 1, cb = (t >> 4) & 3;
    const int cby = cb >> 1, cbx = cb & 1;
    const int cy = 4 * cby + i, cx = 4 * cbx + j;
    const uint8_t* cin = comp == 0 ? u : v;
    const size_t coff = static_cast<size_t>(row * 8 + cy) * wc + cx;

    if (t < 16) left_y[t] = 128;
    if (t < 16) left_c[t >> 3][t & 7] = 128;

    int o = y[yoff];
    int oc = has_c ? cin[coff] : 0;
    __syncthreads();

    for (int c = 0; c < mbw; ++c) {
        const size_t mb = static_cast<size_t>(row) * mbw + c;
        // the next MB's samples, in flight while this one is coded
        int o_next = 0, oc_next = 0;
        if (c + 1 < mbw) {
            o_next = y[yoff + (c + 1) * 16];
            if (has_c) oc_next = cin[coff + (c + 1) * 8];
        }

        // --- prediction: H and DC candidates, SADs by block reduction
        int lsum = 0;
#pragma unroll
        for (int k = 0; k < 16; ++k) lsum += left_y[k];
        const int pred_h = left_y[ly];
        const int pred_dc = (lsum + 8) >> 4;
        int cpred_h = 0, cpred_dc = 0;
        if (has_c) {
            const int* l = left_c[comp] + 4 * cby;
            cpred_h = left_c[comp][cy];
            cpred_dc = (l[0] + l[1] + l[2] + l[3] + 2) >> 2;
        }
        int s0 = warp_sum(iabs(o - pred_h));
        int s1 = warp_sum(iabs(o - pred_dc));
        int s2 = warp_sum(has_c ? iabs(oc - cpred_h) : 0);
        int s3 = warp_sum(has_c ? iabs(oc - cpred_dc) : 0);
        if (lane == 0) {
            red[warp][0] = s0;
            red[warp][1] = s1;
            red[warp][2] = s2;
            red[warp][3] = s3;
        }
        __syncthreads();
        int sad[4] = {0, 0, 0, 0};
#pragma unroll
        for (int k = 0; k < kThreads / 32; ++k) {
#pragma unroll
            for (int q = 0; q < 4; ++q) sad[q] += red[k][q];
        }
        const bool use_h = sad[0] < sad[1];
        const bool cuse_h = sad[2] < sad[3];
        const int pred = use_h ? pred_h : pred_dc;
        const int cpred = cuse_h ? cpred_h : cpred_dc;
        if (t == 0) {
            out.mode_luma[mb] = use_h ? 1 : 2;       // LUMA_H / LUMA_DC
            out.mode_chroma[mb] = cuse_h ? 1 : 0;    // CHROMA_H / CHROMA_DC
        }
        res_y[t] = o - pred;
        if (has_c) res_c[t] = oc - cpred;
        __syncthreads();

        // --- forward transform and AC quant / dequant; DCs aside
        {
            const int wv = fdct_coef(res_y + 16 * b, i, j);
            const int pos = 4 * i + j;
            if (pos == 0) {
                dcw_y[b] = wv;
            } else {
                const int z = quant_ac(wv, qp, kPosClass[pos]);
                out.ac_luma[(mb * 16 + b) * 15 + kInvZigzag[pos] - 1] =
                    static_cast<int16_t>(z);
                deq_y[t] = z * kV[qp % 6][kPosClass[pos]] * (1 << (qp / 6));
            }
        }
        if (has_c) {
            const int wv = fdct_coef(res_c + 16 * (t >> 4), i, j);
            const int pos = 4 * i + j;
            if (pos == 0) {
                dcw_c[t >> 4] = wv;
            } else {
                const int z = quant_ac(wv, qp_c, kPosClass[pos]);
                out.ac_chroma[((mb * 2 + comp) * 4 + cb) * 15
                              + kInvZigzag[pos] - 1] = static_cast<int16_t>(z);
                deq_c[t] = z * kV[qp_c % 6][kPosClass[pos]]
                           * (1 << (qp_c / 6));
            }
        }
        __syncthreads();

        // --- the DC paths, on threads 0..23 of warp 0
        if (t < 16) {                 // luma: Hadamard, floor by 1, quant
            const int p = t >> 2, q = t & 3;
            int acc = 0;
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                const int* r = dcw_y + 4 * k;
                acc += kH4[p][k] * (kH4[q][0] * r[0] + kH4[q][1] * r[1]
                                    + kH4[q][2] * r[2] + kH4[q][3] * r[3]);
            }
            const int z = quant_dc(acc >> 1, qp);
            out.dc_luma[mb * 16 + kInvZigzag[t]] = static_cast<int16_t>(z);
            zdc_y[t] = z;
        } else if (t < 24) {          // chroma: 2x2 Hadamard, quant
            const int k = t - 16, cc = k >> 2, p = (k >> 1) & 1, q = k & 1;
            const int* d = dcw_c + 4 * cc;
            const int sq = q ? -1 : 1, sp = p ? -1 : 1;
            const int acc = (d[0] + sq * d[1]) + sp * (d[2] + sq * d[3]);
            const int z = quant_dc(acc, qp_c);
            out.dc_chroma[(mb * 2 + cc) * 4 + 2 * p + q] =
                static_cast<int16_t>(z);
            zdc_c[k] = z;
        }
        __syncwarp();
        if (t < 16) {                 // luma: inverse Hadamard, scaling
            const int p = t >> 2, q = t & 3;
            int f = 0;
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                const int* r = zdc_y + 4 * k;
                f += kH4[p][k] * (kH4[q][0] * r[0] + kH4[q][1] * r[1]
                                  + kH4[q][2] * r[2] + kH4[q][3] * r[3]);
            }
            const int ls = kV[qp % 6][0] * 16, m = qp / 6;
            deq_y[16 * t] = m >= 6 ? f * ls * (1 << (m - 6))
                                   : (f * ls + (1 << (5 - m))) >> (6 - m);
        } else if (t < 24) {          // chroma: inverse Hadamard, scaling
            const int k = t - 16, cc = k >> 2, p = (k >> 1) & 1, q = k & 1;
            const int* d = zdc_c + 4 * cc;
            const int sq = q ? -1 : 1, sp = p ? -1 : 1;
            const int f = (d[0] + sq * d[1]) + sp * (d[2] + sq * d[3]);
            const int ls = kV[qp_c % 6][0] * 16;
            deq_c[16 * k] = (f * ls * (1 << (qp_c / 6))) >> 5;
        }
        __syncthreads();

        // --- inverse transform: rows, then columns with rounding
        {
            const int* d = deq_y + 16 * b + 4 * i;
            res_y[t] = idct_1d(d[0], d[1], d[2], d[3], j);
        }
        if (has_c) {
            const int* d = deq_c + 16 * (t >> 4) + 4 * i;
            res_c[t] = idct_1d(d[0], d[1], d[2], d[3], j);
        }
        __syncthreads();
        {
            const int* f = res_y + 16 * b + j;
            const int h = idct_1d(f[0], f[4], f[8], f[12], i);
            const int rec = min(max(pred + ((h + 32) >> 6), 0), 255);
            out.y[yoff + c * 16] = static_cast<uint8_t>(rec);
            if (lx == 15) {
                const bool intra = is_intra == nullptr || is_intra[mb];
                left_y[ly] = intra ? rec : ry[yoff + c * 16];
            }
        }
        if (has_c) {
            const int* f = res_c + 16 * (t >> 4) + j;
            const int h = idct_1d(f[0], f[4], f[8], f[12], i);
            const int rec = min(max(cpred + ((h + 32) >> 6), 0), 255);
            uint8_t* cdst = comp == 0 ? out.u : out.v;
            cdst[coff + c * 8] = static_cast<uint8_t>(rec);
            if (cx == 7) {
                const bool intra = is_intra == nullptr || is_intra[mb];
                const uint8_t* rc = comp == 0 ? ru : rv;
                left_c[comp][cy] = intra ? rec : rc[coff + c * 8];
            }
        }
        __syncthreads();
        o = o_next;
        oc = oc_next;
    }
}

}  // namespace

extern "C" int h264_intra16_launch(
        const void* y, const void* u, const void* v, const void* is_intra,
        const void* ry, const void* ru, const void* rv, void* dc_luma,
        void* ac_luma, void* mode_luma, void* dc_chroma, void* ac_chroma,
        void* mode_chroma, void* oy, void* ou, void* ov, int mbh, int mbw,
        int qp, int qp_c, void* stream) {
    Out out{static_cast<int16_t*>(dc_luma), static_cast<int16_t*>(ac_luma),
            static_cast<uint8_t*>(mode_luma),
            static_cast<int16_t*>(dc_chroma),
            static_cast<int16_t*>(ac_chroma),
            static_cast<uint8_t*>(mode_chroma), static_cast<uint8_t*>(oy),
            static_cast<uint8_t*>(ou), static_cast<uint8_t*>(ov)};
    h264_intra16_kernel<<<mbh, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(y), static_cast<const uint8_t*>(u),
        static_cast<const uint8_t*>(v),
        static_cast<const uint8_t*>(is_intra),
        static_cast<const uint8_t*>(ry), static_cast<const uint8_t*>(ru),
        static_cast<const uint8_t*>(rv), out, mbw, qp, qp_c);
    return static_cast<int>(cudaGetLastError());
}
