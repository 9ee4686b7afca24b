// K1: certified-cosine bin maxima over int8 or bfloat16 rows, for Hopper
// (sm_90a).
//
// Replaces otters_tpu/ops/pallas_topk.py::_kernel in its certify=True,
// cert_cos=True mode (phase 1 of the fused pruned top-k), over int8
// storage (entry cert_cos_binmax) and bfloat16 storage (entry
// cert_cos_binmax_bf16). For every live 512-row bin and every query it
// computes
//
//   dot   = bf16(q) . row               (exact products, f32 sums)
//   score = (dot * q_inv) * inv          (rounded multiplies, JAX's order)
//   ok    = rmask > 0 && q_ok > 0 && !isnan(score) && cmp(score, thr)
//   key   = (ok ? score : -inf) + lane_a (per-row certificate residual)
//   out[bin][q] = max over the bin's 512 rows of key
//
// The per-query c0 of the certificate is added by phase 2 (max is
// monotone, so max(key) + c0 is the fully adjusted bin max). Dead bins are
// left at the -inf the caller filled in.
//
// Design: the scan of csrc/cert_scan_sm90.cuh (a persistent grid over the
// survivor list, the query block resident in shared memory, a TMA ring
// feeding two ping-pong consumer warpgroups, wgmma m64n64k16, the key
// applied in registers). The key's side data per row is (inv, rmask,
// lane_a); each thread keeps q_inv of its 16 queries in registers, with
// the filters folded into NaNs (CosKey). The caller
// (ops/fused_topk.py::k1_geometry, k1_pad_queries) pads the batch to whole
// 64-query blocks (padded lanes q_ok = 0) and the depth of the queries to
// a multiple of 64 and, over int8 rows, permutes each 64-deep block of the
// queries to match the fragment order in which the kernel reads the rows
// (k1_query_perm). A stage holds two 64-deep k-blocks of 128 rows over
// int8 rows and one of 256 rows over bf16 rows (plan_for), so each
// warpgroup issues 16 products between barrier waits. Over int8 rows the
// products are f16 when the query block allows it (the scan's note).
//
// Bound at the main path's shapes (10M x 768 int8 store, 256 queries, half
// of the 1024-row chunks pruned): about 5.0M live rows x 768 B = 3.84 GB,
// 1.15 ms at 3.35 TB/s; 2 * 256 * 768 * 5.0M = 1.97 TFLOP, 2.0 ms at 989
// TFLOP/s dense bf16 / f16: the tensor cores bound it. Over bf16 rows the
// same work reads 7.7 GB, 2.3 ms: the bytes bound it. The four query
// blocks of b = 256 walk the same bins side by side, so each row comes
// from memory about once and from L2 four times.
//
// Launch errors: the launcher returns a CUDA error code (cudaErrorInvalidValue
// when a tensor map cannot be encoded); the Python wrapper raises when it
// is not 0.

#include "cert_scan_sm90.cuh"

#include <type_traits>

namespace {

constexpr int NSIDE = 3;  // inv, rmask, lane_a

// The key with the filters folded into NaNs: q_inv is NaN for a padded or
// invalid query, inv is NaN for a masked row, so their score is NaN and
// fails the threshold test like a NaN score does; Gt compares >= with the
// next float above thr. score = (dot * q_inv) * inv, then + lane_a.
struct CosKey {
    float qi[16];
    float t;  // pass: score >= t

    // side = {inv, rmask, lane_a} -> {inv or NaN, -, lane_a}
    __device__ __forceinline__ void prep(float (&s)[NSIDE]) const {
        s[0] = s[1] > 0.f ? s[0] : __int_as_float(0x7fc00000);
    }
    __device__ __forceinline__ float operator()(float dot, const float (&s)[NSIDE],
                                                int j) const {
        const float score = __fmul_rn(__fmul_rn(dot, qi[j]), s[0]);
        return __fadd_rn(score >= t ? score : -INFINITY, s[2]);
    }
};

template <typename RowT, int KS, int TM>
__global__ void __launch_bounds__(sm90::THREADS, 1) cert_cos_binmax_kernel(
    const __grid_constant__ CUtensorMap qmap,  // [bq, dq] bf16 queries
    const __grid_constant__ CUtensorMap vmap,  // [n_pad, d] int8 or bf16 rows
    const sm90::ScanArgs a,                    // side = {inv, rmask, lane_a}
    const float* __restrict__ q_inv,           // [bq]
    const float* __restrict__ q_ok,            // [bq] 0/1
    const float* __restrict__ thr,             // [1]
    int cmp)                                   // 0 none, 1 Gt, 2 Gte
{
    // cmp none: every non-NaN score passes >= -inf; Gt: > thr is >= the next
    // float above thr (nothing passes > +inf)
    float t = cmp == 0 ? -INFINITY : *thr;
    if (cmp == 1) t = t == INFINITY ? __int_as_float(0x7fc00000) : nextafterf(t, INFINITY);
    const auto make_key = [&](int q0, const int (&cols)[16]) {
        CosKey k;
#pragma unroll
        for (int j = 0; j < 16; ++j)
            k.qi[j] = q_ok[q0 + cols[j]] > 0.f ? q_inv[q0 + cols[j]] : __int_as_float(0x7fc00000);
        k.t = t;
        return k;
    };
    sm90::scan<RowT, NSIDE, KS, TM>(&qmap, &vmap, a, make_key);
}

// The stage shape of a launch: int8 rows take 2 k-blocks of 128 rows a
// stage (each warpgroup converts and multiplies 16 products between two
// barrier waits), bf16 rows one k-block of 256 rows (the 256-row box keeps
// the same work per wait); either falls back to one k-block of 128 rows
// when fewer than 4 stages would fit.
enum Plan { P128 = 0, P128x2 = 1, P256 = 2 };

template <typename RowT>
Plan plan_for(int d) {
    if (sizeof(RowT) == 1)
        return sm90::stages_for<RowT, 2, 128>(d) >= 4 ? P128x2 : P128;
    return sm90::stages_for<RowT, 1, 256>(d) >= 4 ? P256 : P128;
}

// call F<KS, TM>() for the plan of d (only the plans the row type uses are
// instantiated)
template <typename RowT, typename F>
auto with_plan(int d, const F& f) {
    if constexpr (sizeof(RowT) == 1) {
        if (plan_for<RowT>(d) == P128x2) return f(std::integral_constant<int, 2>{},
                                                  std::integral_constant<int, 128>{});
    } else {
        if (plan_for<RowT>(d) == P256) return f(std::integral_constant<int, 1>{},
                                                std::integral_constant<int, 256>{});
    }
    return f(std::integral_constant<int, 1>{}, std::integral_constant<int, 128>{});
}

template <typename RowT>
int stages_of(int d) {
    return with_plan<RowT>(d, [&](auto ks, auto tm) {
        return sm90::stages_for<RowT, decltype(ks)::value, decltype(tm)::value>(d);
    });
}

template <typename RowT>
size_t smem_for(int d) {
    return with_plan<RowT>(d, [&](auto ks, auto tm) {
        constexpr int KS = decltype(ks)::value, TM = decltype(tm)::value;
        return sm90::smem_bytes<RowT, KS, TM>(d, sm90::stages_for<RowT, KS, TM>(d));
    });
}

template <typename RowT>
int launch(const void* q, const void* v, const void* inv, const void* rmask,
           const void* lane_a, const void* q_inv, const void* q_ok, const void* thr,
           const void* surv, const void* n_surv, void* out, int n_bins, int d, int b,
           int dq, int n_qb, int per_group, int cmp, void* stream)
{
    if (n_qb < 1 || per_group < 1 || dq % 64) return (int)cudaErrorInvalidValue;
    return with_plan<RowT>(d, [&](auto ks, auto tm) {
        constexpr int KS = decltype(ks)::value, TM = decltype(tm)::value;
        const auto kernel = cert_cos_binmax_kernel<RowT, KS, TM>;
        const int stages = sm90::stages_for<RowT, KS, TM>(d);
        const size_t smem = sm90::smem_bytes<RowT, KS, TM>(d, stages);
        cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
        CUtensorMap qmap, vmap;
        if (!sm90::make_maps<RowT, TM>(&qmap, &vmap, q, n_qb * sm90::QB, dq, v,
                                       (long long)n_bins * sm90::BIN, d))
            return (int)cudaErrorInvalidValue;
        sm90::ScanArgs a = {};
        a.surv = (const int*)surv;
        a.n_surv = (const int*)n_surv;
        a.side[0] = (const float*)inv;
        a.side[1] = (const float*)rmask;
        a.side[2] = (const float*)lane_a;
        a.out = (float*)out;
        a.d = d;
        a.b = b;
        a.n_qb = n_qb;
        a.stages = stages;
        cert_cos_binmax_kernel<RowT, KS, TM>
            <<<n_qb * per_group, sm90::THREADS, smem, (cudaStream_t)stream>>>(
                qmap, vmap, a, (const float*)q_inv, (const float*)q_ok, (const float*)thr, cmp);
        return (int)cudaGetLastError();
    });
}

}  // namespace

extern "C" size_t cert_cos_binmax_smem_bytes(int d) { return smem_for<int8_t>(d); }
extern "C" size_t cert_cos_binmax_bf16_smem_bytes(int d) { return smem_for<__nv_bfloat16>(d); }
extern "C" int cert_cos_binmax_stages(int d) { return stages_of<int8_t>(d); }
extern "C" int cert_cos_binmax_bf16_stages(int d) { return stages_of<__nv_bfloat16>(d); }
extern "C" int cert_cos_binmax_launch(
    const void* q, const void* v, const void* inv, const void* rmask,
    const void* lane_a, const void* q_inv, const void* q_ok, const void* thr,
    const void* surv, const void* n_surv, void* out, int n_bins, int d, int b, int dq,
    int n_qb, int per_group, int cmp, void* stream)
{
    return launch<int8_t>(q, v, inv, rmask, lane_a, q_inv, q_ok, thr, surv, n_surv, out,
                          n_bins, d, b, dq, n_qb, per_group, cmp, stream);
}

extern "C" int cert_cos_binmax_bf16_launch(
    const void* q, const void* v, const void* inv, const void* rmask,
    const void* lane_a, const void* q_inv, const void* q_ok, const void* thr,
    const void* surv, const void* n_surv, void* out, int n_bins, int d, int b, int dq,
    int n_qb, int per_group, int cmp, void* stream)
{
    return launch<__nv_bfloat16>(q, v, inv, rmask, lane_a, q_inv, q_ok, thr, surv, n_surv,
                                 out, n_bins, d, b, dq, n_qb, per_group, cmp, stream);
}
