// K6: one-pass bf16 bin maxima over f32 or bfloat16 rows, for Hopper
// (sm_90a).
//
// Replaces otters_tpu/ops/pallas_topk.py::_kernel in its prec="default" /
// "bf16" mode (the `dot_general` at :182-189 at Precision.DEFAULT,
// scoring.py:469-475), the store precisions that trade exactness for one
// tensor-core pass. What a TPU computes there for f32 operands, and this
// kernel computes:
//
//   dot   = bf16_rn(q) . bf16_rn(v)       (each product exact in f32, f32 sums)
//   score = the metric of binmax_common.cuh over the UNROUNDED f32 norms
//           (q_inv / q_sq of the f32 queries, the store's inv / nsq)
//   key   = ok ? (take_min ? -score : score) : -inf, its max per live bin
//
// over f32 rows (entry bf16_binmax, rounded to bf16 while they are staged)
// or bfloat16 rows (entry bf16_binmax_bf16, their own rounding, copied as
// they are). The caller rounds the queries to bf16, as K1's does. Every
// metric (Cosine, Dot, Euclid) and every score filter.
//
// Design. The scan of csrc/cert_scan.cuh (K1's and K5's): a block takes
// one live 512-row bin and 64 queries, keeps the bf16 query block in
// shared memory, stages the bin in 128-row x 64-deep bf16 tiles, runs WMMA
// 16x16x16 bf16 products with f32 accumulators and folds every dot into a
// running per-query max through the branch-free key of binmax_common.cuh
// (the epilogue of K3 and K4, JAX's order of roundings). Dead survivor
// slots return at once; the output [n_bins, b] is pre-filled with -inf.
// The tensor cores' f32 accumulation is not promised round-to-nearest: the
// mode is defined up to the order of its f32 sums, and chip_smoke.py
// measures the accumulation against float64 of the rounded operands.
//
// Bound at the paths' shapes (256 queries, half the 1024-row chunks
// pruned, d = 768): over the 10M x 768 bf16 store, 5.0M live rows of
// 1,536 B are 7.7 GB, 2.3 ms at 3.35 TB/s, against 2 x 256 x 768 x 5.0M =
// 1.97 T bf16 operations, 2.0 ms at 989 TFLOP/s: the bytes bound it. Over
// the 4M x 768 f32 store, 2.0M live rows of 3,072 B are 6.1 GB, 1.8 ms,
// against 0.79 T operations, 0.8 ms: bytes again. This first version is
// simple (synchronous loads, WMMA, the query block re-read per bin); wgmma,
// TMA and a persistent grid are later work.
//
// Hazards handled:
// - Rounding: __floats2bfloat162_rn rounds f32 rows to nearest even, as
//   JAX's astype does; the queries arrive rounded the same way.
// - d must be a multiple of 16 (the scan's staging step); the wrapper
//   raises otherwise.
// - Padded query rows (q_ok = 0) come out -inf; out is written only for
//   query lanes < b; n_surv = 0 launches safely.
// - Launch errors: the launcher returns cudaGetLastError().

#include "cert_scan.cuh"

using namespace binmax;

namespace {

template <typename RowT>
__global__ void __launch_bounds__(THREADS) bf16_binmax_kernel(
    const __nv_bfloat16* __restrict__ q,  // [bq, d] bf16-rounded queries
    const RowT* __restrict__ v,           // [n_pad, d] f32 or bf16
    const float* __restrict__ inv,        // [n_pad]
    const float* __restrict__ nsq,        // [n_pad]
    const float* __restrict__ rmask,      // [n_pad] 0/1
    const float* __restrict__ q_inv,      // [bq] of the f32 queries
    const float* __restrict__ q_sq,       // [bq] of the f32 queries
    const float* __restrict__ q_ok,       // [bq] 0/1
    const float* __restrict__ thr,        // [1]
    const int* __restrict__ surv,         // [n_bins] live bins, ascending
    const int* __restrict__ n_surv,       // [1]
    float* __restrict__ out,              // [n_bins, b], pre-filled -inf
    int d, int b, int n_qblocks, int metric, int take_min, int cmp)
{
    const int slot = blockIdx.x / n_qblocks;
    if (slot >= *n_surv) return;
    const int qblk = blockIdx.x - slot * n_qblocks;
    const int bin = surv[slot];
    const int q0 = qblk * QB;
    extern __shared__ __align__(128) unsigned char smem[];

    const int qq = q0 + (threadIdx.x >> 2);
    const float qi = q_inv[qq];
    const float qsq = q_sq[qq];
    const bool qok = q_ok[qq] > 0.f;
    const float t = *thr;
    const float sgn = take_min ? -1.f : 1.f;
    const int cmask = cmp_mask(cmp);
    const auto key = [&](float dot, size_t row) {
        return key_of(dot, qi, qsq, qok, inv[row], nsq[row], rmask[row], t, metric, sgn,
                      cmask);
    };
    const float best = cert_bin_max(q, v, bin, q0, d, smem, key);
    if ((threadIdx.x & 3) == 0 && qq < b) out[(size_t)bin * b + qq] = best;
}

template <typename RowT>
int launch(const void* q, const void* v, const void* inv, const void* nsq,
           const void* rmask, const void* q_inv, const void* q_sq, const void* q_ok,
           const void* thr, const void* surv, const void* n_surv, void* out,
           int n_bins, int d, int b, int n_qblocks, int metric, int take_min, int cmp,
           void* stream)
{
    const size_t smem = cert_smem_bytes(d);
    cudaError_t err = cudaFuncSetAttribute(
        bf16_binmax_kernel<RowT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((unsigned)n_bins * (unsigned)n_qblocks);
    bf16_binmax_kernel<RowT><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)q, (const RowT*)v, (const float*)inv, (const float*)nsq,
        (const float*)rmask, (const float*)q_inv, (const float*)q_sq,
        (const float*)q_ok, (const float*)thr, (const int*)surv,
        (const int*)n_surv, (float*)out, d, b, n_qblocks, metric, take_min, cmp);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" size_t bf16_binmax_smem_bytes(int d) { return cert_smem_bytes(d); }
extern "C" size_t bf16_binmax_bf16_smem_bytes(int d) { return cert_smem_bytes(d); }

extern "C" int bf16_binmax_launch(
    const void* q, const void* v, const void* inv, const void* nsq,
    const void* rmask, const void* q_inv, const void* q_sq, const void* q_ok,
    const void* thr, const void* surv, const void* n_surv, void* out,
    int n_bins, int d, int b, int n_qblocks, int metric, int take_min, int cmp,
    void* stream)
{
    return launch<float>(q, v, inv, nsq, rmask, q_inv, q_sq, q_ok, thr, surv, n_surv,
                         out, n_bins, d, b, n_qblocks, metric, take_min, cmp, stream);
}

extern "C" int bf16_binmax_bf16_launch(
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
