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
// over f32 rows (entry bf16_binmax, rounded to bf16 in registers) or
// bfloat16 rows (entry bf16_binmax_bf16, their own rounding). The caller
// rounds the queries to bf16, as K1's does. Every metric (Cosine, Dot,
// Euclid) and every score filter.
//
// Design over f32 rows: the scan of csrc/cert_scan_sm90.cuh (K1's and
// K5's): a persistent grid over the survivor list, the query block
// resident (streamed through the ring past about d = 1,536), a TMA ring
// feeding two ping-pong consumer warpgroups. TMA lands each 64-deep f32
// k-block as two 128-byte swizzled boxes of 32 deep; each consumer thread
// loads its A fragment (16-byte loads free of bank conflicts), rounds it
// to bf16 in registers (cvt.rn.bf16x2, one per pair) and issues wgmma
// m64n64k16 with A from registers. The caller (ops/fused_topk.py) pads the
// batch to whole 64-query blocks and the query depth to a multiple of 64,
// and permutes each 64-deep block of the queries (f32_query_perm) to the
// order in which a thread's fragment is loaded. A stage holds one k-block
// of 128 rows (32 KB; of 64 rows when fewer than 4 stages fit). The key is
// key_of unchanged, each slot's q_ok and metric norm in registers.
//
// Over bfloat16 rows (bf16_binmax_bf16): the simple scan of
// csrc/cert_scan.cuh: a block takes one live 512-row bin and 64 queries,
// keeps the bf16 query block in shared memory, stages the bin in 128-row x
// 64-deep tiles, runs WMMA 16x16x16 bf16 products with f32 accumulators
// and folds every dot into a running per-query max through the same key.
// Dead survivor slots return at once; the output [n_bins, b] is pre-filled
// with -inf.
//
// The tensor cores' f32 accumulation is not promised round-to-nearest: the
// mode is defined up to the order of its f32 sums, and chip_smoke.py
// measures the accumulation against float64 of the rounded operands.
//
// Bound at the paths' shapes (256 queries, half the 1024-row chunks
// pruned, d = 768): over the 10M x 768 bf16 store, 5.0M live rows of
// 1,536 B are 7.7 GB, 2.3 ms at 3.35 TB/s, against 2 x 256 x 768 x 5.0M =
// 1.97 T bf16 operations, 2.0 ms at 989 TFLOP/s: the bytes bound it. Over
// the 4M x 768 f32 store, 2.0M live rows of 3,072 B are 6.1 GB, 1.8 ms,
// against 0.79 T operations, 0.8 ms: bytes again. At b = 256 the four
// query blocks' CTAs each read a row tile, so the rows reach the SMs four
// times (from L2 after the first).
//
// Hazards handled:
// - Rounding: __floats2bfloat162_rn rounds f32 rows to nearest even, as
//   JAX's astype does; the queries arrive rounded the same way.
// - The rows' depth is a multiple of 16 (the store pads it), so the f32
//   rows' TMA stride is a multiple of 16 bytes and the bf16 scan's
//   16-element staging steps stay inside a row; the wrapper checks it.
// - Padded query rows (q_ok = 0) come out -inf; out is written only for
//   query lanes < b; n_surv = 0 launches safely.
// - Launch errors: the launchers return a CUDA error code.

#include "cert_scan.cuh"
#include "cert_scan_sm90.cuh"

#include <type_traits>

using namespace binmax;

namespace {

// ---- over bfloat16 rows, on the simple scan ----

__global__ void __launch_bounds__(THREADS) bf16_binmax_kernel(
    const __nv_bfloat16* __restrict__ q,  // [bq, d] bf16-rounded queries
    const __nv_bfloat16* __restrict__ v,  // [n_pad, d] bf16 rows
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

int launch_bf16_rows(const void* q, const void* v, const void* inv, const void* nsq,
           const void* rmask, const void* q_inv, const void* q_sq, const void* q_ok,
           const void* thr, const void* surv, const void* n_surv, void* out,
           int n_bins, int d, int b, int n_qblocks, int metric, int take_min, int cmp,
           void* stream)
{
    const size_t smem = cert_smem_bytes(d);
    cudaError_t err = cudaFuncSetAttribute(
        bf16_binmax_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((unsigned)n_bins * (unsigned)n_qblocks);
    bf16_binmax_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)v, (const float*)inv, (const float*)nsq,
        (const float*)rmask, (const float*)q_inv, (const float*)q_sq,
        (const float*)q_ok, (const float*)thr, (const int*)surv,
        (const int*)n_surv, (float*)out, d, b, n_qblocks, metric, take_min, cmp);
    return (int)cudaGetLastError();
}

// ---- over f32 rows, on the sm90 scan ----

constexpr int K6_NSIDE = 3;  // inv, nsq, rmask

// key_of per slot. Only one per-query norm enters a metric (Cosine q_inv,
// Euclid q_sq, Dot none), so a slot keeps that one in qn and hands it to
// key_of in both places: the metric's form reads the right one.
struct K6Key {
    float qn[16];   // the slot's f32 query's q_inv (Cosine) or q_sq
    uint32_t ok;    // bit j: q_ok of slot j
    float t, sgn;
    int metric, cmask;

    __device__ __forceinline__ void prep(float (&)[K6_NSIDE]) const {}
    __device__ __forceinline__ float operator()(float dot, const float (&s)[K6_NSIDE],
                                                int j) const {
        return key_of(dot, qn[j], qn[j], (ok >> j) & 1u, s[0], s[1], s[2], t, metric, sgn,
                      cmask);
    }
};

template <int KS, int TM, bool STREAM>
__global__ void __launch_bounds__(sm90::THREADS, 1) bf16_binmax_sm90_kernel(
    const __grid_constant__ CUtensorMap qmap,  // [bq, dq] bf16 queries, permuted
    const __grid_constant__ CUtensorMap vmap,  // [n_pad, d] f32 rows
    const sm90::ScanArgs a,                    // side = {inv, nsq, rmask}
    const float* __restrict__ q_inv,           // [bq] of the f32 queries
    const float* __restrict__ q_sq,            // [bq] of the f32 queries
    const float* __restrict__ q_ok,            // [bq] 0/1
    const float* __restrict__ thr,             // [1]
    int metric, int take_min, int cmp)
{
    const float t = *thr;
    const auto make_key = [&](int q0, const int (&cols)[16]) {
        K6Key k;
        k.ok = 0;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
            const int q = q0 + cols[j];
            k.qn[j] = metric == 0 ? q_inv[q] : q_sq[q];
            k.ok |= (q_ok[q] > 0.f ? 1u : 0u) << j;
        }
        k.t = t;
        k.sgn = take_min ? -1.f : 1.f;
        k.metric = metric;
        k.cmask = cmp_mask(cmp);
        return k;
    };
    sm90::scan<float, K6_NSIDE, KS, TM, STREAM>(&qmap, &vmap, a, make_key);
}

// the stage shapes (sm90::with_plan): one k-block of 128 rows (32 KB),
// of 64 rows when fewer than 4 stages fit, streamed past 2
constexpr int K6_KS1 = 1, K6_TM1 = 128, K6_KS2 = 1, K6_TM2 = 64;

}  // namespace

extern "C" size_t bf16_binmax_smem_bytes(int d) {
    return sm90::plan_smem<float, K6_KS1, K6_TM1, K6_KS2, K6_TM2>(d);
}
extern "C" int bf16_binmax_stages(int d) {
    return sm90::plan_stages<float, K6_KS1, K6_TM1, K6_KS2, K6_TM2>(d);
}
extern "C" size_t bf16_binmax_bf16_smem_bytes(int d) { return cert_smem_bytes(d); }

extern "C" int bf16_binmax_launch(
    const void* q, const void* v, const void* inv, const void* nsq,
    const void* rmask, const void* q_inv, const void* q_sq, const void* q_ok,
    const void* thr, const void* surv, const void* n_surv, void* out,
    int n_bins, int d, int b, int dq, int n_qb, int per_group, int metric, int take_min,
    int cmp, void* stream)
{
    const float* side[K6_NSIDE] = {(const float*)inv, (const float*)nsq, (const float*)rmask};
    const auto get_kernel = [](auto ks, auto tm, auto st) {
        return bf16_binmax_sm90_kernel<decltype(ks)::value, decltype(tm)::value,
                                       decltype(st)::value>;
    };
    const auto launch_fn = [&](auto kernel, dim3 grid, size_t smem, const CUtensorMap& qmap,
                               const CUtensorMap& vmap, const sm90::ScanArgs& a) {
        kernel<<<grid, sm90::THREADS, smem, (cudaStream_t)stream>>>(
            qmap, vmap, a, (const float*)q_inv, (const float*)q_sq, (const float*)q_ok,
            (const float*)thr, metric, take_min, cmp);
    };
    return sm90::launch_plan<float, K6_KS1, K6_TM1, K6_KS2, K6_TM2>(
        get_kernel, launch_fn, q, v, side, K6_NSIDE, surv, n_surv, out, n_bins, d, b, dq,
        n_qb, per_group);
}

extern "C" int bf16_binmax_bf16_launch(
    const void* q, const void* v, const void* inv, const void* nsq,
    const void* rmask, const void* q_inv, const void* q_sq, const void* q_ok,
    const void* thr, const void* surv, const void* n_surv, void* out,
    int n_bins, int d, int b, int n_qblocks, int metric, int take_min, int cmp,
    void* stream)
{
    return launch_bf16_rows(q, v, inv, nsq, rmask, q_inv, q_sq, q_ok, thr, surv, n_surv,
                            out, n_bins, d, b, n_qblocks, metric, take_min, cmp, stream);
}
