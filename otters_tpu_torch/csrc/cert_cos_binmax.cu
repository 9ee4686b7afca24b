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
// warpgroup issues 16 products between barrier waits; over bf16 rows at d
// = 1,296-1,536 the split plan keeps 4 such stages by holding only the
// first 8 query k-blocks resident. Over int8 rows the
// products are f16 when the query block allows it (the scan's note).
// Over int8 rows at more than one query block the entry
// cert_cos_binmax_pair takes the pair plan instead (sm90::scan_pair_s8,
// cert_cos_binmax_pair_kernel): 128 queries a CTA, 256-row stages that
// both warpgroups share beside the resident head of the pair's query
// block, m64n128k16 products, each row converted once per pair; the
// caller has already rewritten each pair to f16 where the rule allows
// (cert_cos_binmax_f16_queries, cert_cos_binmax_f16_queries_kernel).
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

template <typename RowT, int KS, int TM, bool STREAM>
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
    sm90::scan<RowT, NSIDE, KS, TM, STREAM>(&qmap, &vmap, a, make_key);
}

// The f16 rule of sm90::queries_to_f16 (sm90::f16_scale, bf16x2_to_f16)
// for the pair plan, applied to the caller's padded, permuted bf16 queries
// q [n_groups * 128, dq] in place: CTA c takes group c, a warp a query at
// a time. The group takes f16 (flags[c] = 1) if every query is ok and
// every element comes back exactly, and is then rewritten as f16(x 2^s);
// unscale[q] = 2^-s (1 for a query that is not ok).
// ops/fused_topk.py::f16_queries is the plain version.
__global__ void __launch_bounds__(256) cert_cos_binmax_f16_queries_kernel(
    uint32_t* __restrict__ q, float* __restrict__ unscale, int* __restrict__ flags, int dq)
{
    constexpr int G = sm90::PAIR_Q;
    __shared__ float up_s[G], down_s[G];
    __shared__ int all_ok;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int words = dq / 2;  // bf16 pairs a query
    uint32_t* qg = q + (size_t)blockIdx.x * G * words;
    if (threadIdx.x == 0) all_ok = 1;
    __syncthreads();
    for (int r = warp; r < G; r += 8) {
        uint32_t m = 0;
        for (int k = lane; k < words; k += 32) m = sm90::bf16x2_absmax(m, qg[(size_t)r * words + k]);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) m = max(m, __shfl_xor_sync(0xffffffffu, m, o));
        const sm90::F16Scale sc = sm90::f16_scale(m);
        if (lane == 0) {
            up_s[r] = sc.up;
            down_s[r] = sc.down;
            if (!sc.ok) all_ok = 0;
        }
    }
    __syncthreads();
    bool good = true;
    for (int r = warp; r < G; r += 8)
        for (int k = lane; k < words; k += 32)
            sm90::bf16x2_to_f16(qg[(size_t)r * words + k], up_s[r], down_s[r], good);
    const bool f16 = __syncthreads_and(good) && all_ok;
    if (f16)
        for (int r = warp; r < G; r += 8)
            for (int k = lane; k < words; k += 32) {
                uint32_t& w = qg[(size_t)r * words + k];
                w = sm90::bf16x2_to_f16(w, up_s[r], down_s[r], good);
            }
    if (threadIdx.x < G) unscale[(size_t)blockIdx.x * G + threadIdx.x] = down_s[threadIdx.x];
    if (threadIdx.x == 0) flags[blockIdx.x] = f16;
}

// the pair plan over int8 rows (sm90::scan_pair_s8): 128 queries a CTA,
// rewritten by the caller to f16 where f16[pair] is 1
__global__ void __launch_bounds__(sm90::THREADS, 1) cert_cos_binmax_pair_kernel(
    const __grid_constant__ CUtensorMap qmap,  // [bq, dq] f16 or bf16 queries, 128 a pair
    const __grid_constant__ CUtensorMap vmap,  // [n_pad, d] int8 rows
    const sm90::ScanArgs a,                    // side = {inv, rmask, lane_a}; n_qb = n_qp
    const float* __restrict__ q_inv,           // [bq]
    const float* __restrict__ q_ok,            // [bq] 0/1
    const float* __restrict__ unscale,         // [bq] 2^-s of the f16 queries
    const int* __restrict__ f16,               // [n_qp] 1: the pair's queries are f16
    const float* __restrict__ thr,             // [1]
    int cmp)                                   // 0 none, 1 Gt, 2 Gte
{
    float t = cmp == 0 ? -INFINITY : *thr;  // as in cert_cos_binmax_kernel
    if (cmp == 1) t = t == INFINITY ? __int_as_float(0x7fc00000) : nextafterf(t, INFINITY);
    const auto make_key = [&](int q0, const int (&cols)[16]) {
        CosKey k;
#pragma unroll
        for (int j = 0; j < 16; ++j)
            k.qi[j] = q_ok[q0 + cols[j]] > 0.f ? q_inv[q0 + cols[j]] : __int_as_float(0x7fc00000);
        k.t = t;
        return k;
    };
    sm90::scan_pair_s8<NSIDE>(&qmap, &vmap, a, make_key, unscale, f16);
}

// The stage shapes (sm90::with_plan): int8 rows take 2 k-blocks of 128 rows
// a stage (each warpgroup converts and multiplies 16 products between two
// barrier waits), bf16 rows one k-block of 256 rows (the 256-row box keeps
// the same work per wait); either takes one k-block of 128 rows when fewer
// than 4 stages would fit, and streams the query block beside it when
// fewer than 2 would (deep rows). Where one k-block of 128 rows would
// still leave fewer than 4 stages, bf16 rows keep 4 stages of 256 rows
// beside only the head of the query block (the split plan).
template <typename RowT>
struct Shape;
template <>
struct Shape<int8_t> { static constexpr int KS1 = 2, TM1 = 128, KS2 = 1, TM2 = 128; };
template <>
struct Shape<__nv_bfloat16> { static constexpr int KS1 = 1, TM1 = 256, KS2 = 1, TM2 = 128; };

template <typename RowT>
int stages_of(int d) {
    using S = Shape<RowT>;
    return sm90::plan_stages<RowT, S::KS1, S::TM1, S::KS2, S::TM2>(d);
}

template <typename RowT>
size_t smem_for(int d) {
    using S = Shape<RowT>;
    return sm90::plan_smem<RowT, S::KS1, S::TM1, S::KS2, S::TM2>(d);
}

template <typename RowT>
int launch(const void* q, const void* v, const void* inv, const void* rmask,
           const void* lane_a, const void* q_inv, const void* q_ok, const void* thr,
           const void* surv, const void* n_surv, void* out, int n_bins, int d, int b,
           int dq, int n_qb, int per_group, int cmp, void* stream)
{
    using S = Shape<RowT>;
    const float* side[3] = {(const float*)inv, (const float*)rmask, (const float*)lane_a};
    const auto get_kernel = [](auto ks, auto tm, auto st) {
        return cert_cos_binmax_kernel<RowT, decltype(ks)::value, decltype(tm)::value,
                                      decltype(st)::value>;
    };
    const auto launch_fn = [&](auto kernel, dim3 grid, size_t smem, const CUtensorMap& qmap,
                               const CUtensorMap& vmap, const sm90::ScanArgs& a) {
        kernel<<<grid, sm90::THREADS, smem, (cudaStream_t)stream>>>(
            qmap, vmap, a, (const float*)q_inv, (const float*)q_ok, (const float*)thr, cmp);
    };
    return sm90::launch_plan<RowT, S::KS1, S::TM1, S::KS2, S::TM2>(
        get_kernel, launch_fn, q, v, side, 3, surv, n_surv, out, n_bins, d, b, dq, n_qb,
        per_group);
}

}  // namespace

extern "C" size_t cert_cos_binmax_smem_bytes(int d) { return smem_for<int8_t>(d); }
extern "C" size_t cert_cos_binmax_bf16_smem_bytes(int d) { return smem_for<__nv_bfloat16>(d); }
extern "C" int cert_cos_binmax_stages(int d) { return stages_of<int8_t>(d); }
extern "C" int cert_cos_binmax_bf16_stages(int d) { return stages_of<__nv_bfloat16>(d); }
// the pair plan over int8 rows (the head of the query block resident:
// sm90::pair_s8_resident)
extern "C" size_t cert_cos_binmax_pair_smem_bytes(int d) {
    return sm90::PairShape<int8_t>::smem(d);
}
extern "C" int cert_cos_binmax_pair_stages(int d) { return sm90::PairShape<int8_t>::stages(d); }

// the f16 rule on the card: q [n_groups * 128, dq] bf16, rewritten in place
extern "C" int cert_cos_binmax_f16_queries(void* q, void* unscale, void* flags, int n_groups,
                                           int dq, void* stream)
{
    if (n_groups < 1 || dq < 2 || dq % 2) return (int)cudaErrorInvalidValue;
    cert_cos_binmax_f16_queries_kernel<<<n_groups, 256, 0, (cudaStream_t)stream>>>(
        (uint32_t*)q, (float*)unscale, (int*)flags, dq);
    return (int)cudaGetLastError();
}

// q: [n_qp * 128, dq] 16-bit queries, pair c f16 (scaled by 2^s, unscale
// holding 2^-s) where f16[c] is 1, else bf16; n_qp = ceil(n_qb / 2)
extern "C" int cert_cos_binmax_pair_launch(
    const void* q, const void* v, const void* inv, const void* rmask,
    const void* lane_a, const void* q_inv, const void* q_ok, const void* unscale,
    const void* f16, const void* thr, const void* surv, const void* n_surv, void* out,
    int n_bins, int d, int b, int dq, int n_qb, int per_group, int cmp, void* stream)
{
    const float* side[3] = {(const float*)inv, (const float*)rmask, (const float*)lane_a};
    const auto launch_fn = [&](auto kernel, dim3 grid, size_t smem, const CUtensorMap& qmap,
                               const CUtensorMap& vmap, const sm90::ScanArgs& a) {
        kernel<<<grid, sm90::THREADS, smem, (cudaStream_t)stream>>>(
            qmap, vmap, a, (const float*)q_inv, (const float*)q_ok, (const float*)unscale,
            (const int*)f16, (const float*)thr, cmp);
    };
    return sm90::launch_pair<int8_t>(cert_cos_binmax_pair_kernel, launch_fn, q, v, side, 3,
                                     surv, n_surv, out, n_bins, d, b, dq, (n_qb + 1) / 2,
                                     per_group);
}

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
