// K4: bf16x3 fast-exact bin maxima over f32 or bfloat16 rows, for Hopper
// (sm_90a).
//
// Replaces otters_tpu/ops/pallas_topk.py::_kernel in its prec="high" mode
// (the verified fast-exact phase 1, fast=True, and the store precision
// "high"), over f32 rows (entry bf16x3_binmax) and bfloat16 rows (entry
// bf16x3_binmax_bf16): each dot is
//
//   qh.vh + qh.vl + ql.vh,   x_h = bf16_rn(x),  x_l = bf16_rn(x - x_h),
//
// three bf16 tensor-core products with f32 accumulation (ql.vl dropped),
// then the masked key of binmax_common.cuh and its maximum over each live
// 512-row bin. A bf16 row is its own high plane: JAX upcasts it to f32 and
// splits it, giving vh = v exactly and vl = 0, so qh.vl is identically zero
// and this kernel skips that product (two products, qh.v + ql.v).
// scoring.high_precision_bound(d) = 2^-14 + 4 d 2^-24 bounds
// |dot_bf16x3 - dot| / (|q| |v|); phase 2 re-scores in exact f32 and the
// check kth_key >= boundary + slack decides whether the answer stands.
//
// Design. As K1: a block takes one live bin and 64 queries, the survivor
// list lives on the device, dead slots return at once. The f32 rows stay
// the store (K3 needs them), so the planes are not stored: each 64-deep
// step loads the block's f32 query tile (64 x 64) and row tile (128 x 64)
// and splits them into bf16 high / low planes in shared memory with JAX's
// roundings. WMMA 16x16x16 bf16 products accumulate each step's three
// partial products (at most 192 terms) in a fresh f32 fragment, which is
// then added to the running f32 sum with a rounded add: the tensor cores'
// own accumulation (not promised round-to-nearest) never spans more than
// one step, and the steps combine in IEEE f32. chip_smoke.py measures the
// accumulation error against float64 on the split products at d = 768 and
// asserts it stays within the bound's 4 d 2^-24 share.
//
// Bound at the f32 path's shapes (4M x 768 f32 store, 256 queries, half of
// the 1024-row chunks pruned: about 2.0M live rows): 3 x 2 x 256 x 768 x
// 2.0M = 2.36 T bf16 operations, 2.4 ms at 989 TFLOP/s, against 6.1 GB of
// rows, 1.8 ms at 3.35 TB/s. So the tensor cores bound it. Over bf16 rows
// (10M x 768 store, about 5.0M live rows) the two products are 3.93 T
// operations, 4.0 ms, against 7.7 GB of rows: operations again. This first
// version is simple (synchronous loads, the split redone per query block,
// WMMA); wgmma, TMA and a stored plane pair are later work.
//
// Hazards handled:
// - Splits: __float2bfloat16_rn both times and an exact f32 difference,
//   as JAX's astype; inf / nan rows give nan low planes, as there.
// - Epilogue rounding: rounded intrinsics keep JAX's order of ops.
// - Padded query rows (q_ok = 0) come out -inf; out is written only for
//   query lanes < b; n_surv = 0 launches safely; d need not be a multiple
//   of 4 or 16 (zero-padded in shared memory).
// - Launch errors: the launcher returns cudaGetLastError().

#include <cuda_bf16.h>
#include <mma.h>

#include <type_traits>

#include "binmax_common.cuh"

using namespace nvcuda;
using namespace binmax;

namespace {

constexpr int RN = 128;       // rows per sub-tile
constexpr int BK = 64;        // depth per staged step
constexpr int PLD = BK + 8;   // bf16 plane leading dimension, in elements
constexpr int CLD = RN + 4;   // f32 dot tile leading dimension

// dynamic shared memory: the query and row planes, one f32 dot tile (a
// bf16-row launch leaves the row low plane unused)
constexpr size_t smem_bytes() {
    return (size_t)2 * (QB + RN) * PLD * sizeof(__nv_bfloat16)
         + (size_t)QB * CLD * sizeof(float);
}

// rows [r0, r0 + rows) x [k0, k0 + BK) of an f32 [*, d] matrix into the
// bf16 high / low planes [rows][PLD] (zeros past d)
__device__ __forceinline__ void split_tile(
    const float* __restrict__ src, size_t r0, int rows, int d, int k0, bool vec,
    __nv_bfloat16* hi, __nv_bfloat16* lo, int tid)
{
    constexpr int C4 = BK / 4;
    for (int i = tid; i < rows * C4; i += THREADS) {
        const int r = i / C4, c = i - r * C4;
        const int kk = k0 + c * 4;
        float x[4] = {0.f, 0.f, 0.f, 0.f};
        if (kk < d) {
            const int4 raw = load16(src + (r0 + r) * (size_t)d + kk, 4 * (d - kk), vec);
            const float* f = reinterpret_cast<const float*>(&raw);
#pragma unroll
            for (int e = 0; e < 4; ++e) x[e] = f[e];
        }
        __nv_bfloat16 h[4], l[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            h[e] = __float2bfloat16_rn(x[e]);
            l[e] = __float2bfloat16_rn(__fsub_rn(x[e], __bfloat162float(h[e])));
        }
        __nv_bfloat16* hp = hi + r * PLD + c * 4;
        __nv_bfloat16* lp = lo + r * PLD + c * 4;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            hp[e] = h[e];
            lp[e] = l[e];
        }
    }
}

// rows [r0, r0 + rows) x [k0, k0 + BK) of a bf16 [*, d] matrix copied as
// they are into the plane [rows][PLD] (zeros past d); vec: d % 4 == 0, so
// 4 elements are one aligned 8-byte load
__device__ __forceinline__ void copy_tile(
    const __nv_bfloat16* __restrict__ src, size_t r0, int rows, int d, int k0,
    bool vec, __nv_bfloat16* dst, int tid)
{
    constexpr int C4 = BK / 4;
    for (int i = tid; i < rows * C4; i += THREADS) {
        const int r = i / C4, c = i - r * C4;
        const int kk = k0 + c * 4;
        const __nv_bfloat16* p = src + (r0 + r) * (size_t)d + kk;
        __nv_bfloat16* o = dst + r * PLD + c * 4;
        if (vec && kk + 4 <= d) {
            *reinterpret_cast<uint2*>(o) = *reinterpret_cast<const uint2*>(p);
        } else {
#pragma unroll
            for (int e = 0; e < 4; ++e)
                o[e] = kk + e < d ? p[e] : __float2bfloat16_rn(0.f);
        }
    }
}

template <typename RowT>
__global__ void __launch_bounds__(THREADS) bf16x3_binmax_kernel(
    const float* __restrict__ q,       // [bq, d]
    const RowT* __restrict__ v,        // [n_pad, d] f32 or bf16
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
    const bool vec = (d % 4) == 0;
    constexpr bool ROW_BF16 = std::is_same<RowT, __nv_bfloat16>::value;

    extern __shared__ __align__(128) unsigned char smem[];
    __nv_bfloat16* qh = reinterpret_cast<__nv_bfloat16*>(smem);   // [QB][PLD]
    __nv_bfloat16* ql = qh + QB * PLD;
    __nv_bfloat16* vh = ql + QB * PLD;                             // [RN][PLD]
    __nv_bfloat16* vl = vh + RN * PLD;
    float* cs = reinterpret_cast<float*>(vl + RN * PLD);           // [QB][CLD]

    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int wm = warp >> 2;  // 32-query half
    const int wn = warp & 3;   // 32-row quarter

    const int eq = tid >> 2;
    const int esub = tid & 3;
    const float qi = q_inv[q0 + eq];
    const float qsq = q_sq[q0 + eq];
    const bool qok = q_ok[q0 + eq] > 0.f;
    const float t = *thr;
    const float sgn = take_min ? -1.f : 1.f;
    const int cmask = cmp_mask(cmp);
    float best = -INFINITY;

    for (int rs = 0; rs < BIN / RN; ++rs) {
        const size_t row0 = (size_t)bin * BIN + (size_t)rs * RN;
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

        for (int k0 = 0; k0 < d; k0 += BK) {
            split_tile(q, (size_t)q0, QB, d, k0, vec, qh, ql, tid);
            if constexpr (ROW_BF16) copy_tile(v, row0, RN, d, k0, vec, vh, tid);
            else split_tile(v, row0, RN, d, k0, vec, vh, vl, tid);
            __syncthreads();
            wmma::fragment<wmma::accumulator, 16, 16, 16, float> part[2][2];
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
                for (int j = 0; j < 2; ++j) wmma::fill_fragment(part[i][j], 0.0f);
            const int kmax = min(BK, ((d - k0) + 15) / 16 * 16);
            for (int kk = 0; kk < kmax; kk += 16) {
                wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                               wmma::row_major> ah[2], al[2];
                wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                               wmma::col_major> bh[2], bl[2];
#pragma unroll
                for (int i = 0; i < 2; ++i) {
                    const int off = (wm * 32 + i * 16) * PLD + kk;
                    wmma::load_matrix_sync(ah[i], qh + off, PLD);
                    wmma::load_matrix_sync(al[i], ql + off, PLD);
                }
#pragma unroll
                for (int j = 0; j < 2; ++j) {
                    const int off = (wn * 32 + j * 16) * PLD + kk;
                    wmma::load_matrix_sync(bh[j], vh + off, PLD);
                    if constexpr (!ROW_BF16) wmma::load_matrix_sync(bl[j], vl + off, PLD);
                }
#pragma unroll
                for (int i = 0; i < 2; ++i)
#pragma unroll
                    for (int j = 0; j < 2; ++j) {
                        wmma::mma_sync(part[i][j], ah[i], bh[j], part[i][j]);
                        // bf16 rows: vl = 0, so qh.vl adds nothing
                        if constexpr (!ROW_BF16)
                            wmma::mma_sync(part[i][j], ah[i], bl[j], part[i][j]);
                        wmma::mma_sync(part[i][j], al[i], bh[j], part[i][j]);
                    }
            }
            // one step's partial sum joins the running sum in IEEE f32
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
                for (int j = 0; j < 2; ++j)
#pragma unroll
                    for (int e = 0; e < acc[i][j].num_elements; ++e)
                        acc[i][j].x[e] = __fadd_rn(acc[i][j].x[e], part[i][j].x[e]);
            __syncthreads();  // the planes are rewritten by the next step
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
            best = fmaxf(best, key_of(cs[eq * CLD + r], qi, qsq, qok, inv[row],
                                      nsq[row], rmask[row], t, metric, sgn, cmask));
        }
        __syncthreads();  // cs is rewritten by the next sub-tile
    }

    best = fmaxf(best, __shfl_xor_sync(0xffffffffu, best, 1));
    best = fmaxf(best, __shfl_xor_sync(0xffffffffu, best, 2));
    if (esub == 0 && q0 + eq < b) out[(size_t)bin * b + q0 + eq] = best;
}

template <typename RowT>
int launch(const void* q, const void* v, const void* inv, const void* nsq,
           const void* rmask, const void* q_inv, const void* q_sq, const void* q_ok,
           const void* thr, const void* surv, const void* n_surv, void* out,
           int n_bins, int d, int b, int n_qblocks, int metric, int take_min, int cmp,
           void* stream)
{
    const size_t smem = smem_bytes();
    cudaError_t err = cudaFuncSetAttribute(
        bf16x3_binmax_kernel<RowT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((unsigned)n_bins * (unsigned)n_qblocks);
    bf16x3_binmax_kernel<RowT><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
        (const float*)q, (const RowT*)v, (const float*)inv, (const float*)nsq,
        (const float*)rmask, (const float*)q_inv, (const float*)q_sq,
        (const float*)q_ok, (const float*)thr, (const int*)surv,
        (const int*)n_surv, (float*)out, d, b, n_qblocks, metric, take_min, cmp);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" size_t bf16x3_binmax_smem_bytes(int) { return smem_bytes(); }
extern "C" size_t bf16x3_binmax_bf16_smem_bytes(int) { return smem_bytes(); }

extern "C" int bf16x3_binmax_launch(
    const void* q, const void* v, const void* inv, const void* nsq,
    const void* rmask, const void* q_inv, const void* q_sq, const void* q_ok,
    const void* thr, const void* surv, const void* n_surv, void* out,
    int n_bins, int d, int b, int n_qblocks, int metric, int take_min, int cmp,
    void* stream)
{
    return launch<float>(q, v, inv, nsq, rmask, q_inv, q_sq, q_ok, thr, surv, n_surv,
                         out, n_bins, d, b, n_qblocks, metric, take_min, cmp, stream);
}

extern "C" int bf16x3_binmax_bf16_launch(
    const void* q, const void* v, const void* inv, const void* nsq,
    const void* rmask, const void* q_inv, const void* q_sq, const void* q_ok,
    const void* thr, const void* surv, const void* n_surv, void* out,
    int n_bins, int d, int b, int n_qblocks, int metric, int take_min, int cmp,
    void* stream)
{
    return launch<__nv_bfloat16>(q, v, inv, nsq, rmask, q_inv, q_sq, q_ok, thr, surv,
                                 n_surv, out, n_bins, d, b, n_qblocks, metric, take_min,
                                 cmp, stream);
}
