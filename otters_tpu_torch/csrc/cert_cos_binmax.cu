// K1: certified-cosine bin maxima over int8 or bfloat16 rows, for Hopper
// (sm_90a).
//
// Replaces otters_tpu/ops/pallas_topk.py::_kernel in its certify=True,
// cert_cos=True mode (phase 1 of the fused pruned top-k), over int8
// storage (entry cert_cos_binmax) and bfloat16 storage (entry
// cert_cos_binmax_bf16). For every live 512-row bin and every query it
// computes
//
//   dot   = bf16(q) . row               (bf16 tensor cores, f32 accumulate)
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
// runs the scan of csrc/cert_scan.cuh: its 64 bf16 queries in shared
// memory, its bin in 128-row x 64-deep tiles staged as bf16 (int8 codes
// converted exactly, bf16 rows copied), WMMA 16x16x16 bf16 products with
// f32 accumulators, and the key above folded into a running per-query max.
// The four query blocks of one bin are adjacent in the grid, so the bin's
// rows come from L2 after the first read. Dead bins are left at the -inf
// the caller filled in. A bf16 row is 1,536 B at d = 768 (int8: 768 B).
//
// Bound at the main path's shapes (10M x 768 int8 store, 256 queries, half
// of the 1024-row chunks pruned): about 5.0M live rows x 768 B = 3.84 GB,
// 1.15 ms at 3.35 TB/s; 2 * 256 * 768 * 5.0M = 1.97 TFLOP, 2.0 ms at 989
// TFLOP/s dense bf16. The scan is bound by the tensor cores, at about
// 2.0 ms per 256-query batch. Over bf16 rows the same work reads 7.7 GB,
// 2.3 ms: the bytes bound it. This first version is simple (synchronous
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

#include "cert_scan.cuh"

using namespace binmax;

namespace {

template <typename RowT>
__global__ void __launch_bounds__(THREADS) cert_cos_binmax_kernel(
    const __nv_bfloat16* __restrict__ q,   // [bq, d], bq = blocks * QB
    const RowT* __restrict__ v,            // [n_pad, d] int8 or bf16
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
    extern __shared__ __align__(128) unsigned char smem[];

    const int qq = q0 + (threadIdx.x >> 2);
    const float qi = q_inv[qq];
    const bool qok = q_ok[qq] > 0.f;
    const float t = *thr;
    const auto key = [&](float dot, size_t row) {
        const float score = __fmul_rn(__fmul_rn(dot, qi), inv[row]);
        bool ok = qok && rmask[row] > 0.f && !isnan(score);
        if (cmp == 1) ok = ok && score > t;
        else if (cmp == 2) ok = ok && score >= t;
        return __fadd_rn(ok ? score : -INFINITY, lane_a[row]);
    };
    const float best = cert_bin_max(q, v, bin, q0, d, smem, key);
    if ((threadIdx.x & 3) == 0 && qq < b) out[(size_t)bin * b + qq] = best;
}

template <typename RowT>
int launch(const void* q, const void* v, const void* inv, const void* rmask,
           const void* lane_a, const void* q_inv, const void* q_ok, const void* thr,
           const void* surv, const void* n_surv, void* out,
           int n_bins, int d, int b, int n_qblocks, int cmp, void* stream)
{
    const size_t smem = cert_smem_bytes(d);
    cudaError_t err = cudaFuncSetAttribute(
        cert_cos_binmax_kernel<RowT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((unsigned)n_bins * (unsigned)n_qblocks);
    cert_cos_binmax_kernel<RowT><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)q, (const RowT*)v, (const float*)inv,
        (const float*)rmask, (const float*)lane_a, (const float*)q_inv,
        (const float*)q_ok, (const float*)thr, (const int*)surv,
        (const int*)n_surv, (float*)out, d, b, n_qblocks, cmp);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" size_t cert_cos_binmax_smem_bytes(int d) { return cert_smem_bytes(d); }
extern "C" size_t cert_cos_binmax_bf16_smem_bytes(int d) { return cert_smem_bytes(d); }

extern "C" int cert_cos_binmax_launch(
    const void* q, const void* v, const void* inv, const void* rmask,
    const void* lane_a, const void* q_inv, const void* q_ok, const void* thr,
    const void* surv, const void* n_surv, void* out,
    int n_bins, int d, int b, int n_qblocks, int cmp, void* stream)
{
    return launch<int8_t>(q, v, inv, rmask, lane_a, q_inv, q_ok, thr, surv, n_surv,
                          out, n_bins, d, b, n_qblocks, cmp, stream);
}

extern "C" int cert_cos_binmax_bf16_launch(
    const void* q, const void* v, const void* inv, const void* rmask,
    const void* lane_a, const void* q_inv, const void* q_ok, const void* thr,
    const void* surv, const void* n_surv, void* out,
    int n_bins, int d, int b, int n_qblocks, int cmp, void* stream)
{
    return launch<__nv_bfloat16>(q, v, inv, rmask, lane_a, q_inv, q_ok, thr, surv,
                                 n_surv, out, n_bins, d, b, n_qblocks, cmp, stream);
}
