// The simple scan of the one-pass K6 over bfloat16 rows
// (csrc/bf16_binmax.cu, bf16_binmax_bf16). K1, K5 and K6 over f32 rows run
// the Hopper scan of csrc/cert_scan_sm90.cuh.
//
// One block takes one live 512-row bin and 64 queries (rounded to bf16 by
// the caller). It keeps the queries in shared memory, streams its bin
// through in 128-row x 64-deep bf16 tiles copied into shared memory, runs
// WMMA 16x16x16 bf16 products with f32 accumulators, and hands every (query,
// row) dot to the kernel's key function, keeping a running per-query max.
// bf16 x bf16 products are exact in f32; the tensor cores' f32
// accumulation is covered by the certificate's arithmetic headroom, and
// chip_smoke.py measures it against float64.
//
// Epilogue ownership: 4 adjacent threads per query (query threadIdx.x / 4
// of the block), 32 rows each of every 128-row sub-tile; after the scan
// the 4 partial maxima are combined with warp shuffles, so every thread of
// the 4 holds its query's bin max.

#pragma once

#include <cuda_bf16.h>
#include <mma.h>

#include "binmax_common.cuh"

namespace binmax {

constexpr int CERT_RN = 128;            // rows per sub-tile
constexpr int CERT_BK = 64;             // depth per staged tile
constexpr int CERT_VLD = CERT_BK + 8;   // shared leading dimensions, in elements
constexpr int CERT_CLD = CERT_RN + 4;

// 16 bf16 row elements at p -> dst (32 bytes, both 16-byte aligned)
__device__ __forceinline__ void stage16(const __nv_bfloat16* p, __nv_bfloat16* dst) {
    reinterpret_cast<uint4*>(dst)[0] = reinterpret_cast<const uint4*>(p)[0];
    reinterpret_cast<uint4*>(dst)[1] = reinterpret_cast<const uint4*>(p)[1];
}

// dynamic shared memory of the scan: queries [QB][d + 8] bf16, one row
// tile [RN][VLD] bf16, one dot tile [QB][CLD] f32
__host__ __device__ inline size_t cert_smem_bytes(int d) {
    return (size_t)QB * (d + 8) * sizeof(__nv_bfloat16)
         + (size_t)CERT_RN * CERT_VLD * sizeof(__nv_bfloat16)
         + (size_t)QB * CERT_CLD * sizeof(float);
}

// The bin max of key(dot, row) over the bin's 512 rows for this thread's
// query (q0 + threadIdx.x / 4). q: [*, d] bf16, d a multiple of 16;
// v: [n_pad, d] bf16 rows.
template <typename KeyFn>
__device__ __forceinline__ float cert_bin_max(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ v, int bin,
    int q0, int d, unsigned char* smem, const KeyFn& key)
{
    using namespace nvcuda;
    const int qld = d + 8;
    __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);   // [QB][qld]
    __nv_bfloat16* vs = qs + QB * qld;                              // [RN][VLD]
    float* cs = reinterpret_cast<float*>(vs + CERT_RN * CERT_VLD);  // [QB][CLD]

    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int wm = warp >> 2;  // 32-query half
    const int wn = warp & 3;   // 32-row quarter
    const int eq = tid >> 2;
    const int esub = tid & 3;

    // the block's queries, once, in 16-byte copies
    const int qvec = d / 8;
    for (int i = tid; i < QB * qvec; i += THREADS) {
        const int r = i / qvec, c = i - r * qvec;
        const uint4 val = reinterpret_cast<const uint4*>(q + (size_t)(q0 + r) * d)[c];
        *reinterpret_cast<uint4*>(qs + r * qld + c * 8) = val;
    }
    float best = -INFINITY;
    __syncthreads();

    for (int rs = 0; rs < BIN / CERT_RN; ++rs) {
        const size_t row0 = (size_t)bin * BIN + (size_t)rs * CERT_RN;
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

        for (int k0 = 0; k0 < d; k0 += CERT_BK) {
            // stage RN x BK rows as bf16, 16 elements per thread-step
            for (int i = tid; i < CERT_RN * (CERT_BK / 16); i += THREADS) {
                const int r = i / (CERT_BK / 16), c = i - r * (CERT_BK / 16);
                const int kk = k0 + c * 16;
                __nv_bfloat16* dst = vs + r * CERT_VLD + c * 16;
                if (kk < d) {
                    stage16(v + (row0 + r) * (size_t)d + kk, dst);
                } else {
                    reinterpret_cast<uint4*>(dst)[0] = make_uint4(0u, 0u, 0u, 0u);
                    reinterpret_cast<uint4*>(dst)[1] = make_uint4(0u, 0u, 0u, 0u);
                }
            }
            __syncthreads();
            const int kmax = min(CERT_BK, d - k0);
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
                        bm[j], vs + (wn * 32 + j * 16) * CERT_VLD + kk, CERT_VLD);
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
                    cs + (wm * 32 + i * 16) * CERT_CLD + wn * 32 + j * 16,
                    acc[i][j], CERT_CLD, wmma::mem_row_major);
        __syncthreads();

        for (int r = esub * 32; r < esub * 32 + 32; ++r)
            best = fmaxf(best, key(cs[eq * CERT_CLD + r], row0 + r));
        __syncthreads();  // cs is rewritten by the next sub-tile
    }

    best = fmaxf(best, __shfl_xor_sync(0xffffffffu, best, 1));
    best = fmaxf(best, __shfl_xor_sync(0xffffffffu, best, 2));
    return best;
}

}  // namespace binmax
