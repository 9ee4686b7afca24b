// K3: exact f32 bin maxima over f32 or bfloat16 rows, for Hopper (sm_90a).
//
// Replaces otters_tpu/ops/pallas_topk.py::_kernel in its prec="highest"
// mode (the strict mode: the rerun when the fast check fails, Eq score
// filters, k > 128), over f32 rows (entry f32_binmax) and over bfloat16
// rows upcast exactly to f32 as JAX's `v_ref[:].astype(jnp.float32)` does
// (entry f32_binmax_bf16): each dot is an f32 product with one
// IEEE rounding per term (FFMA on the CUDA cores; no TF32, no tensor
// cores, independent of torch's TF32 switch), then the masked key of
// binmax_common.cuh and its maximum over each live 512-row bin.
//
// Phase 1 and phase 2 sum in different orders: this kernel runs the
// k-loop in index order with FMAs, phase 2's torch rescore (cuBLAS f32)
// in its own order. They differ by ulps, within d 2^-24 |q| |v|, as the
// TPU's HIGHEST phase 1 and its phase-2 XLA dot do; the certificate of
// exactness is phase 2's.
//
// Design. A block takes one live bin and 64 queries (the survivor list on
// the device, dead slots return at once, as K1). It walks the bin in four
// 128-row sub-tiles; each 32-deep step stages the 64 x 32 query tile and
// the 128 x 32 row tile transposed (k-major) in shared memory, and each of
// the 256 threads keeps a 4-query x 8-row register tile of accumulators
// (rows tr, tr + 16, ..., so a warp's row loads are conflict-free). The
// epilogue runs in registers; a running max per query is reduced across
// the 16 row-threads with warp shuffles.
//
// Bound at the f32 path's shapes (4M x 768 f32 store, 256 queries, half of
// the 1024-row chunks pruned: about 2.0M live rows): 2 x 256 x 768 x 2.0M
// = 0.79 T f32 operations, 11.7 ms at the 67 TFLOP/s of the CUDA cores,
// against 6.1 GB of rows, 1.8 ms at 3.35 TB/s. So operations bound it.
// Over bf16 rows (10M x 768 store, about 5.0M live rows) the same count is
// 1.97 T operations, 29 ms, against 7.7 GB of rows: operations again.
// This first version is simple: synchronous loads, no double buffering.
//
// Hazards handled:
// - Zero padding past d: 0 * 0 adds nothing; d need not be a multiple of 4.
// - bf16 rows: __bfloat162float is exact, so the products are those of the
//   stored values, as in JAX.
// - Padded query rows (q_ok = 0) come out -inf; out is written only for
//   query lanes < b; n_surv = 0 launches safely.
// - Launch errors: the launcher returns cudaGetLastError().

#include <cuda_bf16.h>

#include "binmax_common.cuh"

using namespace binmax;

namespace {

constexpr int RN = 128;        // rows per sub-tile
constexpr int BK = 32;         // depth per staged step
constexpr int QLD = QB + 4;    // transposed tile leading dimensions
constexpr int VLD = RN + 4;
constexpr int TQ = 4;          // queries per thread
constexpr int TR = 8;          // rows per thread

// 4 elements at p, of which the first n are real (the rest read as 0), as
// f32; vec: a whole 16-byte (f32) or 8-byte (bf16) load is aligned
__device__ __forceinline__ void load4(const float* p, int n, bool vec, float x[4]) {
    const int4 raw = load16(p, 4 * n, vec);
    const float* f = reinterpret_cast<const float*>(&raw);
#pragma unroll
    for (int e = 0; e < 4; ++e) x[e] = f[e];
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, int n, bool vec, float x[4]) {
    if (vec && n >= 4) {
        const uint2 raw = *reinterpret_cast<const uint2*>(p);
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
        const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
        x[0] = a.x; x[1] = a.y; x[2] = b.x; x[3] = b.y;
        return;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) x[e] = e < n ? __bfloat162float(p[e]) : 0.f;
}

// rows [r0, r0 + rows) x [k0, k0 + BK) of an f32 or bf16 [*, d] matrix, as
// f32, transposed into dst[BK][ld] (zeros past d)
template <typename T>
__device__ __forceinline__ void stage_t(
    const T* __restrict__ src, size_t r0, int rows, int d, int k0, bool vec,
    float* dst, int ld, int tid)
{
    constexpr int C4 = BK / 4;
    for (int i = tid; i < rows * C4; i += THREADS) {
        const int r = i / C4, c = i - r * C4;
        const int kk = k0 + c * 4;
        float x[4] = {0.f, 0.f, 0.f, 0.f};
        if (kk < d) load4(src + (r0 + r) * (size_t)d + kk, d - kk, vec, x);
#pragma unroll
        for (int e = 0; e < 4; ++e) dst[(c * 4 + e) * ld + r] = x[e];
    }
}

template <typename RowT>
__global__ void __launch_bounds__(THREADS) f32_binmax_kernel(
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

    __shared__ __align__(16) float qs[BK * QLD];   // [BK][QLD]
    __shared__ __align__(16) float vs[BK * VLD];   // [BK][VLD]

    const int tid = threadIdx.x;
    const int tq = tid >> 4;   // query group: queries tq*4 .. tq*4+3
    const int tr = tid & 15;   // row lane: rows tr, tr+16, ..., tr+112

    float qi[TQ], qsq[TQ], best[TQ];
    bool qok[TQ];
#pragma unroll
    for (int i = 0; i < TQ; ++i) {
        const int qq = q0 + tq * TQ + i;
        qi[i] = q_inv[qq];
        qsq[i] = q_sq[qq];
        qok[i] = q_ok[qq] > 0.f;
        best[i] = -INFINITY;
    }
    const float t = *thr;
    const float sgn = take_min ? -1.f : 1.f;
    const int cmask = cmp_mask(cmp);

    for (int rs = 0; rs < BIN / RN; ++rs) {
        const size_t row0 = (size_t)bin * BIN + (size_t)rs * RN;
        float acc[TQ][TR];
#pragma unroll
        for (int i = 0; i < TQ; ++i)
#pragma unroll
            for (int j = 0; j < TR; ++j) acc[i][j] = 0.f;

        for (int k0 = 0; k0 < d; k0 += BK) {
            stage_t(q, (size_t)q0, QB, d, k0, vec, qs, QLD, tid);
            stage_t(v, row0, RN, d, k0, vec, vs, VLD, tid);
            __syncthreads();
#pragma unroll 8
            for (int kk = 0; kk < BK; ++kk) {
                const float4 a4 = *reinterpret_cast<const float4*>(qs + kk * QLD + tq * TQ);
                const float a[TQ] = {a4.x, a4.y, a4.z, a4.w};
                float bv[TR];
#pragma unroll
                for (int j = 0; j < TR; ++j) bv[j] = vs[kk * VLD + tr + 16 * j];
#pragma unroll
                for (int i = 0; i < TQ; ++i)
#pragma unroll
                    for (int j = 0; j < TR; ++j)
                        acc[i][j] = __fmaf_rn(a[i], bv[j], acc[i][j]);
            }
            __syncthreads();  // the tiles are rewritten by the next step
        }

#pragma unroll
        for (int j = 0; j < TR; ++j) {
            const size_t row = row0 + tr + 16 * j;
            const float iv = inv[row], ns = nsq[row], rm = rmask[row];
#pragma unroll
            for (int i = 0; i < TQ; ++i)
                best[i] = fmaxf(best[i], key_of(acc[i][j], qi[i], qsq[i], qok[i],
                                                iv, ns, rm, t, metric, sgn, cmask));
        }
    }

#pragma unroll
    for (int i = 0; i < TQ; ++i) {
        float m = best[i];
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 4));
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 8));
        const int qq = q0 + tq * TQ + i;
        if (tr == 0 && qq < b) out[(size_t)bin * b + qq] = m;
    }
}

template <typename RowT>
int launch(const void* q, const void* v, const void* inv, const void* nsq,
           const void* rmask, const void* q_inv, const void* q_sq, const void* q_ok,
           const void* thr, const void* surv, const void* n_surv, void* out,
           int n_bins, int d, int b, int n_qblocks, int metric, int take_min, int cmp,
           void* stream)
{
    const dim3 grid((unsigned)n_bins * (unsigned)n_qblocks);
    f32_binmax_kernel<RowT><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)q, (const RowT*)v, (const float*)inv, (const float*)nsq,
        (const float*)rmask, (const float*)q_inv, (const float*)q_sq,
        (const float*)q_ok, (const float*)thr, (const int*)surv,
        (const int*)n_surv, (float*)out, d, b, n_qblocks, metric, take_min, cmp);
    return (int)cudaGetLastError();
}

}  // namespace

// static shared memory only
extern "C" size_t f32_binmax_smem_bytes(int) { return 0; }
extern "C" size_t f32_binmax_bf16_smem_bytes(int) { return 0; }

extern "C" int f32_binmax_launch(
    const void* q, const void* v, const void* inv, const void* nsq,
    const void* rmask, const void* q_inv, const void* q_sq, const void* q_ok,
    const void* thr, const void* surv, const void* n_surv, void* out,
    int n_bins, int d, int b, int n_qblocks, int metric, int take_min, int cmp,
    void* stream)
{
    return launch<float>(q, v, inv, nsq, rmask, q_inv, q_sq, q_ok, thr, surv, n_surv,
                         out, n_bins, d, b, n_qblocks, metric, take_min, cmp, stream);
}

extern "C" int f32_binmax_bf16_launch(
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
