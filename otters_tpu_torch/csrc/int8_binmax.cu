// K2: uncertified int8 bin maxima, for Hopper (sm_90a).
//
// Replaces otters_tpu/ops/pallas_topk.py::_kernel in its int8 mode
// (certify=False, q_ref.dtype == int8): symmetric int8 queries times int8
// rows with int32 accumulation, which is exact at any dimension, then the
// masked key of binmax_common.cuh and its maximum over each live 512-row
// bin. The int32 dots are bit for bit those of an exact integer product.
//
// Design. As K1: the survivor list (live bins, ascending, and their count)
// is built on the device; a block takes one live bin and 64 queries. The
// block's int8 queries sit in shared memory for the whole bin; the bin's
// rows stream through in 128-row x 64-deep int8 tiles. Tensor-core WMMA
// 16x16x16 products of signed char with int accumulators (the s8 x s8 ->
// s32 mma); each 128-row sub-tile's int32 dots go through shared memory to
// the epilogue, which folds them into a running per-query max. WMMA wants
// 32-byte aligned fragments, so both operands are stored slab-major: a
// 16-byte k-slab of every row is contiguous ([k/16][rows][16]). Rows
// whose d is not a multiple of 16 are zero-padded in shared memory.
//
// Bound at the main path's shapes (10M x 768 int8 store, 256 queries, half
// of the 1024-row chunks pruned: 5,000,192 live rows): 3.84 GB of rows,
// 1.15 ms at 3.35 TB/s; 1.97 T int8 operations, 0.99 ms at 1,979 TOP/s. So
// bytes bound it. This first version is simple (synchronous loads, WMMA,
// the query block re-read per bin); wgmma and TMA are later work.
//
// Hazards handled:
// - Exactness: int32 accumulation cannot overflow for 127^2 d < 2^31 (the
//   wrapper checks d); the int -> float conversion rounds to nearest like
//   JAX's astype (exact below 2^24, i.e. d <= 1040).
// - Padded query rows (q_ok = 0) come out -inf; out is written only for
//   query lanes < b. n_surv = 0 launches safely (every block returns).
// - Launch errors: the launcher returns cudaGetLastError(); the Python
//   wrapper raises when it is not 0.

#include <mma.h>

#include "binmax_common.cuh"

using namespace nvcuda;
using namespace binmax;

namespace {

constexpr int RN = 128;       // rows per sub-tile
constexpr int BK = 64;        // depth per staged tile, bytes
constexpr int CLD = RN + 4;   // int32 dot tile leading dimension

__global__ void __launch_bounds__(THREADS) int8_binmax_kernel(
    const int8_t* __restrict__ q,      // [bq, d]
    const int8_t* __restrict__ v,      // [n_pad, d]
    const float* __restrict__ inv,     // [n_pad]
    const float* __restrict__ nsq,     // [n_pad]
    const float* __restrict__ rmask,   // [n_pad] 0/1
    const float* __restrict__ q_inv,   // [bq]
    const float* __restrict__ q_sq,    // [bq]
    const float* __restrict__ q_ok,    // [bq] 0/1
    const float* __restrict__ thr,     // [1]
    const int* __restrict__ surv,      // [n_bins] live bins, ascending
    const int* __restrict__ n_surv,    // [1]
    float* __restrict__ out,           // [n_bins, b], pre-filled -inf
    int d, int b, int n_qblocks, int metric, int take_min, int cmp)
{
    const int slot = blockIdx.x / n_qblocks;
    if (slot >= *n_surv) return;
    const int qblk = blockIdx.x - slot * n_qblocks;
    const int bin = surv[slot];
    const int q0 = qblk * QB;
    const int dk = (d + 15) / 16;  // 16-byte k-slabs
    const bool vec = (d % 16) == 0;

    extern __shared__ __align__(128) unsigned char smem[];
    signed char* qs = reinterpret_cast<signed char*>(smem);        // [dk][QB][16]
    signed char* vs = qs + (size_t)dk * QB * 16;                    // [BK/16][RN][16]
    int* cs = reinterpret_cast<int*>(vs + (BK / 16) * RN * 16);     // [QB][CLD]

    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int wm = warp >> 2;  // 32-query half
    const int wn = warp & 3;   // 32-row quarter

    for (int i = tid; i < QB * dk; i += THREADS) {
        const int r = i / dk, s = i - r * dk;
        const int kk = s * 16;
        *reinterpret_cast<int4*>(qs + ((size_t)s * QB + r) * 16) =
            load16(q + (size_t)(q0 + r) * d + kk, d - kk, vec);
    }

    // epilogue ownership: 4 adjacent threads per query, 32 rows each
    const int eq = tid >> 2;
    const int esub = tid & 3;
    const float qi = q_inv[q0 + eq];
    const float qsq = q_sq[q0 + eq];
    const bool qok = q_ok[q0 + eq] > 0.f;
    const float t = *thr;
    const float sgn = take_min ? -1.f : 1.f;
    const int cmask = cmp_mask(cmp);
    float best = -INFINITY;
    __syncthreads();

    for (int rs = 0; rs < BIN / RN; ++rs) {
        const size_t row0 = (size_t)bin * BIN + (size_t)rs * RN;
        wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[2][2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0);

        for (int k0 = 0; k0 < dk * 16; k0 += BK) {
            for (int i = tid; i < RN * (BK / 16); i += THREADS) {
                const int r = i / (BK / 16), c = i - r * (BK / 16);
                const int kk = k0 + c * 16;
                const int4 val = kk < d
                    ? load16(v + (row0 + r) * (size_t)d + kk, d - kk, vec)
                    : make_int4(0, 0, 0, 0);
                *reinterpret_cast<int4*>(vs + ((size_t)c * RN + r) * 16) = val;
            }
            __syncthreads();
            const int kmax = min(BK, dk * 16 - k0);
            for (int kk = 0; kk < kmax; kk += 16) {
                const int s = (k0 + kk) / 16;
                wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char,
                               wmma::row_major> a[2];
                wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char,
                               wmma::col_major> bm[2];
#pragma unroll
                for (int i = 0; i < 2; ++i)
                    wmma::load_matrix_sync(
                        a[i], qs + ((size_t)s * QB + wm * 32 + i * 16) * 16, 16);
#pragma unroll
                for (int j = 0; j < 2; ++j)
                    wmma::load_matrix_sync(
                        bm[j], vs + ((size_t)(kk / 16) * RN + wn * 32 + j * 16) * 16, 16);
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
            const float dot = __int2float_rn(cs[eq * CLD + r]);
            best = fmaxf(best, key_of(dot, qi, qsq, qok, inv[row], nsq[row],
                                      rmask[row], t, metric, sgn, cmask));
        }
        __syncthreads();  // cs is rewritten by the next sub-tile
    }

    best = fmaxf(best, __shfl_xor_sync(0xffffffffu, best, 1));
    best = fmaxf(best, __shfl_xor_sync(0xffffffffu, best, 2));
    if (esub == 0 && q0 + eq < b) out[(size_t)bin * b + q0 + eq] = best;
}

}  // namespace

extern "C" size_t int8_binmax_smem_bytes(int d) {
    const int dk = (d + 15) / 16;
    return (size_t)dk * QB * 16 + (size_t)(BK / 16) * RN * 16
         + (size_t)QB * CLD * sizeof(int);
}

extern "C" int int8_binmax_launch(
    const void* q, const void* v, const void* inv, const void* nsq,
    const void* rmask, const void* q_inv, const void* q_sq, const void* q_ok,
    const void* thr, const void* surv, const void* n_surv, void* out,
    int n_bins, int d, int b, int n_qblocks, int metric, int take_min, int cmp,
    void* stream)
{
    const size_t smem = int8_binmax_smem_bytes(d);
    cudaError_t err = cudaFuncSetAttribute(
        int8_binmax_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((unsigned)n_bins * (unsigned)n_qblocks);
    int8_binmax_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
        (const int8_t*)q, (const int8_t*)v, (const float*)inv, (const float*)nsq,
        (const float*)rmask, (const float*)q_inv, (const float*)q_sq,
        (const float*)q_ok, (const float*)thr, (const int*)surv,
        (const int*)n_surv, (float*)out, d, b, n_qblocks, metric, take_min, cmp);
    return (int)cudaGetLastError();
}
