// K5: the general certified fold over bfloat16 rows, for Hopper (sm_90a).
//
// Replaces otters_tpu/ops/pallas_topk.py::_kernel in its certify=True,
// cert_cos=False mode (`:244-247`, set up at `:350-354`, `:366-371`,
// `:456-470`, `:484-487`): the certified scan of bfloat16 storage for Dot
// (take-max) and Euclid (take-min). For every live 512-row bin and every
// query it computes
//
//   dot   = bf16(q) . bf16 row          (exact products, f32 sums)
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
// Design: the scan of csrc/cert_scan_sm90.cuh, as K1 over bf16 rows (a
// persistent grid over the survivor list, the query block resident (its
// head only at d = 1,296-1,536), or streamed through the ring past about
// d = 1,536, a TMA ring feeding two
// ping-pong consumer warpgroups, wgmma m64n64k16 with A read from the
// swizzled stage by descriptor, the key applied in registers). A stage
// holds two 64-deep k-blocks of 128 rows (one when fewer than 4 stages
// fit), so a warpgroup holds 64 accumulators a thread and issues 16
// products between barrier waits. The caller (ops/fused_topk.py
// ``sm90_geometry`` / ``sm90_pad_queries``) pads the batch to whole 64-query
// blocks and the depth of the queries to a multiple of 64.
//
// The key (FoldKey). The scan reads 16 B of side data a row (nsq, rmask,
// lane_a, lane_b: inv is not a term of Dot or Euclid) and each thread
// keeps, for its 16 query slots, q_sq (Euclid), c0, c1 and c2 in
// registers. The per-row work is done once a row in prep: sqrt(nsq)
// (__fsqrt_rn), and a masked row becomes NaN there. A padded or invalid
// query carries c0 = NaN. Their folded keys are NaN, which the running max
// (fmaxf) never takes, so such a bin max stays -inf exactly as the masked
// key's -inf + finite fold does. The score filter is one compare in the
// key space: key >= t, with t from thr and cmp (a strict filter compares
// with the next float). Euclid's key is 2 dot - (q_sq + nsq), the exact
// negation of (q_sq + nsq) - 2 dot. The fold keeps JAX's order, each
// operation rounded (__fadd_rn / __fmul_rn, no contraction): per dot an
// add, a multiply and a subtract (Euclid), a compare, then four adds and
// two multiplies.
//
// Bound at the bf16 path's shapes (10M x 768 bf16 store, 256 queries, half
// of the 1024-row chunks pruned: about 5.0M live rows): 5.0M x 1,536 B =
// 7.7 GB of rows, 2.3 ms at 3.35 TB/s, against 1.97 TFLOP, 2.0 ms at 989
// TFLOP/s: the bytes bound it. The epilogue of a 128-row sub-tile (64
// dots a thread, about 10 rounded operations each) is about a quarter of
// the other warpgroup's products for the same sub-tile at d = 768.
//
// Launch errors: the launcher returns a CUDA error code
// (cudaErrorInvalidValue when a tensor map cannot be encoded); the Python
// wrapper raises when it is not 0.

#include "cert_scan_sm90.cuh"

#include <type_traits>

namespace {

constexpr int NSIDE = 4;  // nsq, rmask, lane_a, lane_b

__device__ __forceinline__ float qnan() { return __int_as_float(0x7fc00000); }

template <bool EUCLID>
struct FoldKey {
    float qs[16];                  // q_sq (Euclid)
    float k0[16], k1[16], k2[16];  // c0 (NaN for an invalid query), c1, c2
    float t;                       // pass: key >= t

    // side = {nsq, rmask, lane_a, lane_b} -> {nsq, sqrt(nsq) or NaN, ...}
    __device__ __forceinline__ void prep(float (&s)[NSIDE]) const {
        s[1] = s[1] > 0.f ? __fsqrt_rn(s[0]) : qnan();
    }
    __device__ __forceinline__ float operator()(float dot, const float (&s)[NSIDE],
                                                int j) const {
        float key = EUCLID ? __fsub_rn(__fmul_rn(2.0f, dot), __fadd_rn(qs[j], s[0])) : dot;
        key = key >= t ? key : -INFINITY;
        const float f = __fadd_rn(__fadd_rn(key, k0[j]), __fmul_rn(k1[j], s[2]));
        return __fadd_rn(__fadd_rn(f, __fmul_rn(k2[j], s[1])), s[3]);
    }
};

template <int KS, int TM, bool STREAM, bool EUCLID>
__global__ void __launch_bounds__(sm90::THREADS, 1) cert_fold_binmax_kernel(
    const __grid_constant__ CUtensorMap qmap,  // [bq, dq] bf16 queries
    const __grid_constant__ CUtensorMap vmap,  // [n_pad, d] bf16 rows
    const sm90::ScanArgs a,                    // side = {nsq, rmask, lane_a, lane_b}
    const float* __restrict__ q_sq,            // [bq]
    const float* __restrict__ q_ok,            // [bq] 0/1
    const float* __restrict__ c0,              // [bq]
    const float* __restrict__ c1,              // [bq]
    const float* __restrict__ c2,              // [bq]
    const float* __restrict__ thr,             // [1]
    int cmp)                                   // 0 none, 1 Gt, 2 Gte, 3 Lt, 4 Lte
{
    // the filter in the key space (Euclid's key is -score): >= t, a strict
    // filter against the next float up; nothing passes a strict test
    // against the top of the range
    float t = -INFINITY;
    if (cmp != 0) {
        t = cmp >= 3 ? -*thr : *thr;
        if (cmp == 1 || cmp == 3) t = t == INFINITY ? qnan() : nextafterf(t, INFINITY);
    }
    const auto make_key = [&](int q0, const int (&cols)[16]) {
        FoldKey<EUCLID> k;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
            const int q = q0 + cols[j];
            k.qs[j] = q_sq[q];
            k.k0[j] = q_ok[q] > 0.f ? c0[q] : qnan();
            k.k1[j] = c1[q];
            k.k2[j] = c2[q];
        }
        k.t = t;
        return k;
    };
    sm90::scan<__nv_bfloat16, NSIDE, KS, TM, STREAM>(&qmap, &vmap, a, make_key);
}

// the stage shapes (sm90::with_plan): two k-blocks of 128 rows, one when
// fewer than 4 stages fit, 4 stages of two beside the head of the query
// block where one would leave fewer (the split plan), streamed past 2
constexpr int KS1 = 2, TM1 = 128, KS2 = 1, TM2 = 128;
using RowT = __nv_bfloat16;

template <bool EUCLID>
int launch(const void* q, const void* v, const float* const* side, const void* q_sq,
           const void* q_ok, const void* c0, const void* c1, const void* c2, const void* thr,
           const void* surv, const void* n_surv, void* out, int n_bins, int d, int b, int dq,
           int n_qb, int per_group, int cmp, void* stream)
{
    const auto get_kernel = [](auto ks, auto tm, auto st) {
        return cert_fold_binmax_kernel<decltype(ks)::value, decltype(tm)::value,
                                       decltype(st)::value, EUCLID>;
    };
    const auto launch_fn = [&](auto kernel, dim3 grid, size_t smem, const CUtensorMap& qmap,
                               const CUtensorMap& vmap, const sm90::ScanArgs& a) {
        kernel<<<grid, sm90::THREADS, smem, (cudaStream_t)stream>>>(
            qmap, vmap, a, (const float*)q_sq, (const float*)q_ok, (const float*)c0,
            (const float*)c1, (const float*)c2, (const float*)thr, cmp);
    };
    return sm90::launch_plan<RowT, KS1, TM1, KS2, TM2>(
        get_kernel, launch_fn, q, v, side, NSIDE, surv, n_surv, out, n_bins, d, b, dq, n_qb,
        per_group);
}

}  // namespace

extern "C" size_t cert_fold_binmax_smem_bytes(int d) {
    return sm90::plan_smem<RowT, KS1, TM1, KS2, TM2>(d);
}
extern "C" int cert_fold_binmax_stages(int d) {
    return sm90::plan_stages<RowT, KS1, TM1, KS2, TM2>(d);
}

// metric: 1 Dot (take-max), 2 Euclid (take-min); the wrapper checks the
// pairing
extern "C" int cert_fold_binmax_launch(
    const void* q, const void* v, const void* nsq, const void* rmask, const void* lane_a,
    const void* lane_b, const void* q_sq, const void* q_ok, const void* c0, const void* c1,
    const void* c2, const void* thr, const void* surv, const void* n_surv,
    void* out, int n_bins, int d, int b, int dq, int n_qb, int per_group, int metric,
    int cmp, void* stream)
{
    const float* side[NSIDE] = {(const float*)nsq, (const float*)rmask, (const float*)lane_a,
                                (const float*)lane_b};
    if (metric == 2)
        return launch<true>(q, v, side, q_sq, q_ok, c0, c1, c2, thr, surv, n_surv, out,
                            n_bins, d, b, dq, n_qb, per_group, cmp, stream);
    if (metric != 1) return (int)cudaErrorInvalidValue;
    return launch<false>(q, v, side, q_sq, q_ok, c0, c1, c2, thr, surv, n_surv, out, n_bins,
                         d, b, dq, n_qb, per_group, cmp, stream);
}
