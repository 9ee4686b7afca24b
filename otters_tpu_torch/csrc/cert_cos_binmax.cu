// K1: certified-cosine bin maxima over int8 rows, for Hopper (sm_90a).
//
// Replaces otters_tpu/ops/pallas_topk.py::_kernel in its certify=True,
// cert_cos=True mode (phase 1 of the fused pruned top-k). For every live
// 512-row bin and every query it computes
//
//   dot   = bf16(q) . int8 row          (bf16 tensor cores, f32 accumulate)
//   score = (dot * q_inv) * inv          (rounded multiplies, JAX's order)
//   ok    = rmask > 0 && q_ok > 0 && !isnan(score) && cmp(score, thr)
//   key   = (ok ? score : -inf) + lane_a (per-row certificate residual)
//   out[bin][q] = max over the bin's 512 rows of key
//
// The per-query c0 of the certificate is added by phase 2 (max is
// monotone, so max(key) + c0 is the fully adjusted bin max).
//
// Design. The survivor list (live bins in ascending order, and their count
// n_surv) is built on the device by the caller; the grid covers every bin
// times every 64-query block, and a block whose survivor slot is >= n_surv
// returns at once, so pruned bins cost no loads and no math. A live block
// keeps its 64 bf16 queries in shared memory, streams its bin through in
// 128-row x 64-deep int8 tiles converted to bf16 in shared memory (int8
// codes are exact in bf16), runs WMMA 16x16x16 bf16 products with f32
// accumulators, and folds each 128-row sub-tile into a running per-query
// max. The four query blocks of one bin are adjacent in the grid, so the
// bin's rows come from L2 after the first read. Dead bins are left at the
// -inf the caller filled in.
//
// Bound at the main path's shapes (10M x 768 int8 store, 256 queries, half
// of the 1024-row chunks pruned): about 5.0M live rows x 768 B = 3.84 GB,
// 1.15 ms at 3.35 TB/s; 2 * 256 * 768 * 5.0M = 1.97 TFLOP, 2.0 ms at 989
// TFLOP/s dense bf16. The scan is bound by the tensor cores, at about
// 2.0 ms per 256-query batch. This first version is simple (synchronous
// loads, WMMA, one block per SM); wgmma, TMA and warp specialisation are
// later work.
//
// Hazards handled:
// - Epilogue rounding: nvcc would contract a*b + c into an FMA. The
//   epilogue uses __fmul_rn / __fadd_rn, keeping JAX's (dot*q_inv)*inv then
//   + lane_a rounding exactly.
// - Accumulation: bf16 x bf16 products are exact in f32; the tensor cores'
//   f32 accumulation is not guaranteed round-to-nearest. The certificate's
//   headroom mixed_cert_eps(d) = 4*d*2^-24 + 4e-6 must cover it; the smoke
//   test measures max |kernel dot - float64 dot| / (|qh| |v|) against
//   d*2^-24 at the main path's shapes (it runs this kernel with unit norms,
//   zero lanes and one unmasked row per bin, so out[bin][q] is that row's
//   accumulated dot exactly).
// - Padded query rows (q_ok = 0) come out -inf; out is written only for
//   query lanes < b. n_surv = 0 launches safely (every block returns).
// - Launch errors: the launcher returns cudaGetLastError(); the Python
//   wrapper raises when it is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <math.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BIN = 512;      // rows per bin (= scoring.CERT_BIN)
constexpr int QB = 64;        // queries per block
constexpr int RN = 128;       // rows per sub-tile
constexpr int BK = 64;        // depth per staged tile
constexpr int THREADS = 256;  // 8 warps: 2 (queries) x 4 (rows), 32x32 each
constexpr int VLD = BK + 8;   // shared leading dimensions, in elements
constexpr int CLD = RN + 4;

__global__ void __launch_bounds__(THREADS) cert_cos_binmax_kernel(
    const __nv_bfloat16* __restrict__ q,   // [bq, d], bq = blocks * QB
    const int8_t* __restrict__ v,          // [n_pad, d]
    const float* __restrict__ inv,         // [n_pad]
    const float* __restrict__ rmask,       // [n_pad] 0/1
    const float* __restrict__ lane_a,      // [n_pad]
    const float* __restrict__ q_inv,       // [bq]
    const float* __restrict__ q_ok,        // [bq] 0/1
    const float* __restrict__ thr,         // [1]
    const int* __restrict__ surv,          // [n_bins] live bins, ascending
    const int* __restrict__ n_surv,        // [1]
    float* __restrict__ out,               // [n_bins, b], pre-filled -inf
    int d, int b, int n_qblocks, int cmp)  // cmp: 0 none, 1 Gt, 2 Gte
{
    const int slot = blockIdx.x / n_qblocks;
    if (slot >= *n_surv) return;
    const int qblk = blockIdx.x - slot * n_qblocks;
    const int bin = surv[slot];
    const int q0 = qblk * QB;
    const int qld = d + 8;

    extern __shared__ __align__(128) unsigned char smem[];
    __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);   // [QB][qld]
    __nv_bfloat16* vs = qs + QB * qld;                              // [RN][VLD]
    float* cs = reinterpret_cast<float*>(vs + RN * VLD);            // [QB][CLD]

    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int wm = warp >> 2;  // 32-query half
    const int wn = warp & 3;   // 32-row quarter

    // the block's queries, once, in 16-byte copies
    const int qvec = d / 8;
    for (int i = tid; i < QB * qvec; i += THREADS) {
        const int r = i / qvec, c = i - r * qvec;
        const uint4 val =
            reinterpret_cast<const uint4*>(q + (size_t)(q0 + r) * d)[c];
        *reinterpret_cast<uint4*>(qs + r * qld + c * 8) = val;
    }

    // epilogue ownership: 4 adjacent threads per query, 32 rows each
    const int eq = tid >> 2;
    const int esub = tid & 3;
    const float qi = q_inv[q0 + eq];
    const bool qok = q_ok[q0 + eq] > 0.f;
    const float t = *thr;
    float best = -INFINITY;
    __syncthreads();

    for (int rs = 0; rs < BIN / RN; ++rs) {
        const size_t row0 = (size_t)bin * BIN + (size_t)rs * RN;
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

        for (int k0 = 0; k0 < d; k0 += BK) {
            // stage RN x BK int8 as bf16: 16 codes per thread-step
            for (int i = tid; i < RN * (BK / 16); i += THREADS) {
                const int r = i / (BK / 16), c = i - r * (BK / 16);
                const int kk = k0 + c * 16;
                __nv_bfloat162 h[8];
                if (kk < d) {
                    const int4 raw = *reinterpret_cast<const int4*>(
                        v + (row0 + r) * (size_t)d + kk);
                    const int8_t* b8 = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
                    for (int e = 0; e < 8; ++e)
                        h[e] = __floats2bfloat162_rn((float)b8[2 * e],
                                                     (float)b8[2 * e + 1]);
                } else {
#pragma unroll
                    for (int e = 0; e < 8; ++e)
                        h[e] = __floats2bfloat162_rn(0.f, 0.f);
                }
                uint4* dst = reinterpret_cast<uint4*>(vs + r * VLD + c * 16);
                dst[0] = *reinterpret_cast<const uint4*>(&h[0]);
                dst[1] = *reinterpret_cast<const uint4*>(&h[4]);
            }
            __syncthreads();
            const int kmax = min(BK, d - k0);
            for (int kk = 0; kk < kmax; kk += 16) {
                wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                               wmma::row_major> a[2];
                wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                               wmma::col_major> bm[2];
#pragma unroll
                for (int i = 0; i < 2; ++i)
                    wmma::load_matrix_sync(
                        a[i], qs + (wm * 32 + i * 16) * qld + k0 + kk, qld);
#pragma unroll
                for (int j = 0; j < 2; ++j)
                    wmma::load_matrix_sync(
                        bm[j], vs + (wn * 32 + j * 16) * VLD + kk, VLD);
#pragma unroll
                for (int i = 0; i < 2; ++i)
#pragma unroll
                    for (int j = 0; j < 2; ++j)
                        wmma::mma_sync(acc[i][j], a[i], bm[j], acc[i][j]);
            }
            __syncthreads();
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j)
                wmma::store_matrix_sync(
                    cs + (wm * 32 + i * 16) * CLD + wn * 32 + j * 16,
                    acc[i][j], CLD, wmma::mem_row_major);
        __syncthreads();

        for (int r = esub * 32; r < esub * 32 + 32; ++r) {
            const size_t row = row0 + r;
            const float score = __fmul_rn(__fmul_rn(cs[eq * CLD + r], qi), inv[row]);
            bool ok = qok && rmask[row] > 0.f && !isnan(score);
            if (cmp == 1) ok = ok && score > t;
            else if (cmp == 2) ok = ok && score >= t;
            const float key = __fadd_rn(ok ? score : -INFINITY, lane_a[row]);
            best = fmaxf(best, key);
        }
        __syncthreads();  // cs is rewritten by the next sub-tile
    }

    best = fmaxf(best, __shfl_xor_sync(0xffffffffu, best, 1));
    best = fmaxf(best, __shfl_xor_sync(0xffffffffu, best, 2));
    if (esub == 0 && q0 + eq < b) out[(size_t)bin * b + q0 + eq] = best;
}

}  // namespace

extern "C" size_t cert_cos_binmax_smem_bytes(int d) {
    return (size_t)QB * (d + 8) * sizeof(__nv_bfloat16)
         + (size_t)RN * VLD * sizeof(__nv_bfloat16)
         + (size_t)QB * CLD * sizeof(float);
}

extern "C" int cert_cos_binmax_launch(
    const void* q, const void* v, const void* inv, const void* rmask,
    const void* lane_a, const void* q_inv, const void* q_ok, const void* thr,
    const void* surv, const void* n_surv, void* out,
    int n_bins, int d, int b, int n_qblocks, int cmp, void* stream)
{
    const size_t smem = cert_cos_binmax_smem_bytes(d);
    cudaError_t err = cudaFuncSetAttribute(
        cert_cos_binmax_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((unsigned)n_bins * (unsigned)n_qblocks);
    cert_cos_binmax_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)q, (const int8_t*)v, (const float*)inv,
        (const float*)rmask, (const float*)lane_a, (const float*)q_inv,
        (const float*)q_ok, (const float*)thr, (const int*)surv,
        (const int*)n_surv, (float*)out, d, b, n_qblocks, cmp);
    return (int)cudaGetLastError();
}
