// K4: bf16x3 fast-exact bin maxima over f32 or bfloat16 rows, for Hopper
// (sm_90a).
//
// Replaces otters_tpu/ops/pallas_topk.py::_kernel in its prec="high" mode
// (:168-181; the verified fast-exact phase 1, fast=True, and the store
// precision "high"), over f32 rows (entry bf16x3_binmax) and bfloat16 rows
// (entry bf16x3_binmax_bf16): each dot is
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
// Each 64-deep step's products accumulate in a fresh f32 accumulator,
// which is then added to the running f32 sum with a rounded add: the
// tensor cores' own accumulation (not promised round-to-nearest) never
// spans more than one step, and the steps combine in IEEE f32. chip_smoke.py
// measures the accumulation error against float64 on the split products
// at d = 768 and asserts it stays within the bound's 4 d 2^-24 share.
//
// Design: both entries run on csrc/cert_scan_sm90.cuh with two query
// planes: a persistent grid over the survivor list, a TMA ring feeding two
// consumer warpgroups, wgmma with rows as A and a query plane as B, per
// k-block the products into a partial accumulator that is then added with
// __fadd_rn, the key of binmax_common.cuh in registers. The wrapper
// (ops/fused_topk.py) splits the f32 queries into the planes on the device
// with JAX's roundings, pads them to whole query groups and a depth
// multiple of 64, and stacks them. Every stage streams both planes'
// k-blocks of the CTA's queries beside its rows (resident, the planes of
// 64 queries would take 192 KB at d = 768), so any depth fits.
// - f32 rows (entry bf16x3_binmax): the pair plan, sm90::scan_pair, at
//   every batch size. The rows stay f32 in the store (K3 needs them), so
//   the planes are not stored (they would add 30.7 GB to a 10M x 768
//   store). A CTA holds a pair of query blocks (128 queries; the batch
//   padded with q_ok = 0 lanes to whole pairs) and 132 / n_qp CTAs a pair
//   walk the bins side by side. A stage holds one 64-deep k-block of 128
//   rows, landed by TMA as two 128-byte swizzled boxes of 32 deep (K6's
//   layout, 32 KB), and both planes' k-blocks of the 128 queries (32 KB), 3
//   stages; both warpgroups take every stage, each its own 64 rows times
//   all 128 queries. Each thread loads its A fragment, splits it in
//   registers into vh = cvt.rn.bf16x2(x) and vl = cvt.rn.bf16x2(x - vh)
//   (the difference exact, __fsub_rn) and issues the register-A form
//   m64n128k16 three times per 16-deep step (vh.qh, vl.qh, vh.ql), each
//   split fragment feeding all 128 queries. The queries are permuted to
//   K6's fragment order (f32_query_perm) before they are split. 4 B reach
//   the SM per (row, query) pair and k-block (a 64-query CTA moved 6 B: a
//   row's 256 B shared by 64 queries, a query's 256 B of planes by 128
//   rows), and each row is fetched and split once per pair of query
//   blocks. At b <= 64 half the pair's lanes are padding, and it still
//   measured about 14% faster there than the 64-query plan it replaced
//   (PERF.md). The key runs after each sub-tile in both warpgroups at once,
//   while the tensor cores wait, so it is fixed at compile time by metric
//   and by whether a score filter applies (FixedSlotKey: six
//   instantiations, chosen at launch; about 10% faster at b = 256).
// - bf16 rows (entry bf16x3_binmax_bf16, NV = 1): sm90::scan in
//   ping-pong; A is read from the swizzled stage by descriptor, two
//   products per 16-deep step (v.qh, v.ql); a stage holds one k-block of
//   128 rows (16 KB) and both planes' k-blocks of 64 queries (16 KB), 6
//   stages.
//
// Bound at the f32 path's shapes (4M x 768 f32 store, 256 queries, half of
// the 1024-row chunks pruned: about 2.0M live rows): 3 x 2 x 256 x 768 x
// 2.0M = 2.36 T bf16 operations, 2.4 ms at 989 TFLOP/s, against 6.1 GB of
// rows, 1.8 ms at 3.35 TB/s. So the tensor cores bound it. Over bf16 rows
// (10M x 768 store, about 5.0M live rows) the two products are 3.93 T
// operations, 4.0 ms, against 7.7 GB of rows: operations again. Over f32
// rows the split (cvt, two unpacks, two subtracts and a cvt a pair,
// against K6's one cvt) is consumer work that the other warpgroup's
// products must hide.
//
// Hazards handled:
// - Splits: round to nearest even both times and an exact f32 difference,
//   as JAX's astype; inf / nan rows give nan low planes, as there. No
//   fast-math or flush to zero: a subnormal low plane stays subnormal, as
//   torch's casts keep it (a card test holds this on rows scaled to
//   1e-30 and 1e-36).
// - Registers: the running and the partial accumulators both live across a
//   k-block, and over f32 rows the split A planes beside them. A thread
//   of the pair plan holds one m-block by 128 queries: 64 + 64
//   accumulators and the split fragments of two k-blocks (64: the next one
//   is split while the current one's products run), about 200 of the
//   consumers' 232, and ptxas spills nothing (the 64-query plan it
//   replaced held two m-blocks by 64 queries and spilled 316 bytes).
//   (ptxas reports 168 registers for every kernel of this file, the launch
//   bound's; setmaxnreg gives the consumers 232.) Splitting the next
//   k-block ahead measured faster than splitting each one after the last
//   one's products; folding a sub-tile's sums through the key under the
//   next one's products spilled (PERF.md).
// - Epilogue rounding: rounded intrinsics keep JAX's order of ops.
// - Padded query rows (q_ok = 0) come out -inf; out is written only for
//   query lanes < b; n_surv = 0 launches safely; the rows' depth is a
//   multiple of 16 (the store pads it), so their TMA stride is a multiple
//   of 16 bytes.
// - Launch errors: the launchers return a CUDA error code.

#include <cuda_bf16.h>

#include "binmax_common.cuh"
#include "cert_scan_sm90.cuh"

using namespace binmax;

namespace {

// over bf16 rows (RowT = bf16, NV = 1; the parameters keep the kernel's
// name): sm90::scan with two query planes
template <typename RowT, int NV, int KS, int TM, bool STREAM>
__global__ void __launch_bounds__(sm90::THREADS, 1) bf16x3_binmax_sm90_kernel(
    const __grid_constant__ CUtensorMap qmap,  // [2 bq, dq] bf16: qh of every block, then ql
    const __grid_constant__ CUtensorMap vmap,  // [n_pad, d] bf16 rows
    const sm90::ScanArgs a,                    // side = {inv, nsq, rmask}
    const float* __restrict__ q_inv,           // [bq] of the f32 queries
    const float* __restrict__ q_sq,            // [bq] of the f32 queries
    const float* __restrict__ q_ok,            // [bq] 0/1
    const float* __restrict__ thr,             // [1]
    int metric, int take_min, int cmp)
{
    const float t = *thr;
    const auto make_key = [&](int q0, const int (&cols)[16]) {
        return make_slot_key(q0, cols, q_inv, q_sq, q_ok, t, metric, take_min, cmp);
    };
    sm90::scan<RowT, SlotKey::NSIDE, KS, TM, STREAM, 2, NV>(&qmap, &vmap, a, make_key);
}

// the pair plan over f32 rows (sm90::scan_pair): 128 queries a CTA, the key
// fixed by metric and filter (FixedSlotKey)
template <int METRIC, bool FILTER>
__global__ void __launch_bounds__(sm90::THREADS, 1) bf16x3_binmax_pair_kernel(
    const __grid_constant__ CUtensorMap qmap,  // [2 bq, dq] bf16: qh of every pair, then ql
    const __grid_constant__ CUtensorMap vmap,  // [n_pad, d] f32 rows
    const sm90::ScanArgs a,                    // side = {inv, nsq, rmask}; n_qb = n_qp
    const float* __restrict__ q_inv,           // [bq] of the f32 queries
    const float* __restrict__ q_sq,            // [bq] of the f32 queries
    const float* __restrict__ q_ok,            // [bq] 0/1
    const float* __restrict__ thr,             // [1]
    int metric, int take_min, int cmp)
{
    const float t = *thr;
    const auto make_key = [&](int q0, const int (&cols)[16]) {
        return make_fixed_slot_key<METRIC, FILTER>(q0, cols, q_inv, q_sq, q_ok, t, take_min,
                                                   cmp);
    };
    sm90::scan_pair<SlotKey::NSIDE>(&qmap, &vmap, a, make_key);
}

// the stage shape of bf16 rows (sm90::with_plan): no resident plan (KS1 =
// 0); one k-block of 128 rows with both query planes' k-blocks, at every
// depth
constexpr int KS1 = 0, TM1 = 0, KS2 = 1, TM2 = 128;

// q: the query planes (qh of every query group, then ql) [2 * n_qp * 128,
// dq] bf16 over f32 rows (the pair plan: n_qp = ceil(n_qb / 2) pairs of
// query blocks, per_group CTAs a pair), [2 * n_qb * 64, dq] over bf16 rows
template <typename RowT>
int launch(const void* q, const void* v, const void* inv, const void* nsq, const void* rmask,
           const void* q_inv, const void* q_sq, const void* q_ok, const void* thr,
           const void* surv, const void* n_surv, void* out, int n_bins, int d, int b, int dq,
           int n_qb, int per_group, int metric, int take_min, int cmp, void* stream)
{
    const float* side[SlotKey::NSIDE] = {(const float*)inv, (const float*)nsq,
                                         (const float*)rmask};
    const auto launch_fn = [&](auto kernel, dim3 grid, size_t smem, const CUtensorMap& qmap,
                               const CUtensorMap& vmap, const sm90::ScanArgs& a) {
        kernel<<<grid, sm90::THREADS, smem, (cudaStream_t)stream>>>(
            qmap, vmap, a, (const float*)q_inv, (const float*)q_sq, (const float*)q_ok,
            (const float*)thr, metric, take_min, cmp);
    };
    if constexpr (std::is_same_v<RowT, float>) {
        const bool filter = cmp_mask(cmp) != 7;
        const auto kernel =
            metric == 0 ? (filter ? bf16x3_binmax_pair_kernel<0, true>
                                  : bf16x3_binmax_pair_kernel<0, false>)
          : metric == 2 ? (filter ? bf16x3_binmax_pair_kernel<2, true>
                                  : bf16x3_binmax_pair_kernel<2, false>)
                        : (filter ? bf16x3_binmax_pair_kernel<1, true>
                                  : bf16x3_binmax_pair_kernel<1, false>);
        return sm90::launch_pair(kernel, launch_fn, q, v, side, SlotKey::NSIDE, surv, n_surv,
                                 out, n_bins, d, b, dq, (n_qb + 1) / 2, per_group);
    } else {
        const auto get_kernel = [](auto ks, auto tm, auto st) {
            return bf16x3_binmax_sm90_kernel<RowT, 1, decltype(ks)::value, decltype(tm)::value,
                                             decltype(st)::value>;
        };
        return sm90::launch_plan<RowT, KS1, TM1, KS2, TM2, 2, 1>(
            get_kernel, launch_fn, q, v, side, SlotKey::NSIDE, surv, n_surv, out, n_bins, d, b,
            dq, n_qb, per_group);
    }
}

}  // namespace

// over f32 rows the pair plan's, the same at every depth
extern "C" size_t bf16x3_binmax_smem_bytes(int) {
    return sm90::pair_smem_bytes(sm90::pair_stages());
}
extern "C" int bf16x3_binmax_stages(int) { return sm90::pair_stages(); }
extern "C" size_t bf16x3_binmax_bf16_smem_bytes(int d) {
    return sm90::plan_smem<__nv_bfloat16, KS1, TM1, KS2, TM2, 2, 1>(d);
}
extern "C" int bf16x3_binmax_bf16_stages(int d) {
    return sm90::plan_stages<__nv_bfloat16, KS1, TM1, KS2, TM2, 2, 1>(d);
}

extern "C" int bf16x3_binmax_launch(
    const void* q, const void* v, const void* inv, const void* nsq,
    const void* rmask, const void* q_inv, const void* q_sq, const void* q_ok,
    const void* thr, const void* surv, const void* n_surv, void* out,
    int n_bins, int d, int b, int dq, int n_qb, int per_group, int metric, int take_min,
    int cmp, void* stream)
{
    return launch<float>(q, v, inv, nsq, rmask, q_inv, q_sq, q_ok, thr, surv, n_surv, out,
                         n_bins, d, b, dq, n_qb, per_group, metric, take_min, cmp, stream);
}

extern "C" int bf16x3_binmax_bf16_launch(
    const void* q, const void* v, const void* inv, const void* nsq,
    const void* rmask, const void* q_inv, const void* q_sq, const void* q_ok,
    const void* thr, const void* surv, const void* n_surv, void* out,
    int n_bins, int d, int b, int dq, int n_qb, int per_group, int metric, int take_min,
    int cmp, void* stream)
{
    return launch<__nv_bfloat16>(q, v, inv, nsq, rmask, q_inv, q_sq, q_ok, thr, surv, n_surv,
                                 out, n_bins, d, b, dq, n_qb, per_group, metric, take_min, cmp,
                                 stream);
}
