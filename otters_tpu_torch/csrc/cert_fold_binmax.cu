// K5: the general certified fold over bfloat16 rows, for Hopper (sm_90a).
//
// Replaces otters_tpu/ops/pallas_topk.py::_kernel in its certify=True,
// cert_cos=False mode (`:244-247`, set up at `:350-354`, `:366-371`,
// `:456-470`, `:484-487`): the certified scan of bfloat16 storage for Dot
// (take-max) and Euclid (take-min). For every live 512-row bin and every
// query it computes
//
//   dot   = bf16(q) . bf16 row          (bf16 tensor cores, f32 accumulate)
//   score = dot (Dot) | (q_sq + nsq) - 2 dot (Euclid, q_sq of bf16(q))
//   ok    = rmask > 0 && q_ok > 0 && !isnan(score) && cmp(score, thr)
//   key   = ok ? (take_min ? -score : score) : -inf
//   key   = (((key + c0) + c1 * lane_a) + c2 * sqrt(nsq)) + lane_b
//   out[bin][q] = max over the bin's 512 rows of key
//
// with the per-query certificate coefficients c0 / c1 / c2 and the per-row
// lanes of ops/scoring.py (cert_query_coeffs, cert_row_lanes). The key is
// negated and masked before the fold, so for Euclid the slack still adds:
// the bin max bounds the negated true distance of every row of the bin.
// Unlike K1's Cosine fold, c0 stays in the kernel (phase 2 selects by the
// same fold, without adding c0 to the bin maxima).
//
// Design. The scan of csrc/cert_scan.cuh (shared with K1): one block per
// live bin and 64-query block, the survivor list on the device, dead
// slots return at once, bf16 rows copied into shared memory, WMMA bf16
// products with f32 accumulators. The per-query values (q_inv, q_sq, q_ok,
// c0, c1, c2) ride with the query block: each epilogue thread reads its
// query's once.
//
// Bound at the bf16 path's shapes (10M x 768 bf16 store, 256 queries, half
// of the 1024-row chunks pruned: about 5.0M live rows): 5.0M x 1,536 B =
// 7.7 GB of rows, 2.3 ms at 3.35 TB/s, against 1.97 TFLOP, 2.0 ms at 989
// TFLOP/s: the bytes bound it. This first version is simple (synchronous
// loads, WMMA); wgmma and TMA are later work.
//
// Hazards handled:
// - The fold: __fadd_rn / __fmul_rn in JAX's order, so nvcc cannot
//   contract it into FMAs; sqrt(nsq) with __fsqrt_rn (correctly rounded).
// - Score epilogue and filter: binmax_common.cuh's key_of (rounded ops,
//   the cmp mask; masked rows -inf, which the finite fold keeps -inf).
// - Padded query rows (q_ok = 0) come out -inf; out is written only for
//   query lanes < b; n_surv = 0 launches safely.
// - Launch errors: the launcher returns cudaGetLastError().

#include "cert_scan.cuh"

using namespace binmax;

namespace {

__global__ void __launch_bounds__(THREADS) cert_fold_binmax_kernel(
    const __nv_bfloat16* __restrict__ q,    // [bq, d], bq = blocks * QB
    const __nv_bfloat16* __restrict__ v,    // [n_pad, d]
    const float* __restrict__ inv,          // [n_pad]
    const float* __restrict__ nsq,          // [n_pad]
    const float* __restrict__ rmask,        // [n_pad] 0/1
    const float* __restrict__ lane_a,       // [n_pad]
    const float* __restrict__ lane_b,       // [n_pad]
    const float* __restrict__ q_inv,        // [bq]
    const float* __restrict__ q_sq,         // [bq]
    const float* __restrict__ q_ok,         // [bq] 0/1
    const float* __restrict__ c0,           // [bq]
    const float* __restrict__ c1,           // [bq]
    const float* __restrict__ c2,           // [bq]
    const float* __restrict__ thr,          // [1]
    const int* __restrict__ surv,           // [n_bins] live bins, ascending
    const int* __restrict__ n_surv,         // [1]
    float* __restrict__ out,                // [n_bins, b], pre-filled -inf
    int d, int b, int n_qblocks, int metric, int take_min, int cmp)
{
    const int slot = blockIdx.x / n_qblocks;
    if (slot >= *n_surv) return;
    const int qblk = blockIdx.x - slot * n_qblocks;
    const int bin = surv[slot];
    const int q0 = qblk * QB;
    extern __shared__ __align__(128) unsigned char smem[];

    const int qq = q0 + (threadIdx.x >> 2);
    const float qi = q_inv[qq], qsq = q_sq[qq];
    const float k0 = c0[qq], k1 = c1[qq], k2 = c2[qq];
    const bool qok = q_ok[qq] > 0.f;
    const float t = *thr;
    const float sgn = take_min ? -1.f : 1.f;
    const int cmask = cmp_mask(cmp);
    const auto key = [&](float dot, size_t row) {
        const float ns = nsq[row];
        const float kk = key_of(dot, qi, qsq, qok, inv[row], ns, rmask[row], t,
                                metric, sgn, cmask);
        const float f = __fadd_rn(__fadd_rn(kk, k0), __fmul_rn(k1, lane_a[row]));
        return __fadd_rn(__fadd_rn(f, __fmul_rn(k2, __fsqrt_rn(ns))), lane_b[row]);
    };
    const float best = cert_bin_max(q, v, bin, q0, d, smem, key);
    if ((threadIdx.x & 3) == 0 && qq < b) out[(size_t)bin * b + qq] = best;
}

}  // namespace

extern "C" size_t cert_fold_binmax_smem_bytes(int d) { return cert_smem_bytes(d); }

extern "C" int cert_fold_binmax_launch(
    const void* q, const void* v, const void* inv, const void* nsq,
    const void* rmask, const void* lane_a, const void* lane_b, const void* q_inv,
    const void* q_sq, const void* q_ok, const void* c0, const void* c1,
    const void* c2, const void* thr, const void* surv, const void* n_surv,
    void* out, int n_bins, int d, int b, int n_qblocks, int metric, int take_min,
    int cmp, void* stream)
{
    const size_t smem = cert_smem_bytes(d);
    cudaError_t err = cudaFuncSetAttribute(
        cert_fold_binmax_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((unsigned)n_bins * (unsigned)n_qblocks);
    cert_fold_binmax_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)v, (const float*)inv,
        (const float*)nsq, (const float*)rmask, (const float*)lane_a,
        (const float*)lane_b, (const float*)q_inv, (const float*)q_sq,
        (const float*)q_ok, (const float*)c0, (const float*)c1, (const float*)c2,
        (const float*)thr, (const int*)surv, (const int*)n_surv, (float*)out,
        d, b, n_qblocks, metric, take_min, cmp);
    return (int)cudaGetLastError();
}
