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
// Design: both entries run the scan of csrc/cert_scan_sm90.cuh with two
// query planes: a persistent grid over the survivor list, a TMA ring
// feeding two ping-pong consumer warpgroups, wgmma m64n64k16 (rows as A,
// a query plane as B), per k-block the products into a partial
// accumulator that is then added with __fadd_rn, the key of
// binmax_common.cuh (SlotKey) in registers. The wrapper (ops/fused_topk.py)
// splits the f32 queries into the planes on the device with JAX's
// roundings, pads them to whole query blocks and a depth multiple of 64,
// and stacks them. Every stage streams both planes' k-blocks of the CTA's
// 64 queries beside its rows (resident, the planes would take 192 KB at d
// = 768), so any depth fits one plan.
// - f32 rows (two row planes, NV = 2): the rows stay f32 in the store (K3
//   needs them), so the planes are not stored. TMA lands each 64-deep f32
//   k-block as two 128-byte swizzled boxes of 32 deep (K6's layout); each
//   consumer thread loads its A fragment, splits it in registers into
//   vh = cvt.rn.bf16x2(x) and vl = cvt.rn.bf16x2(x - vh) (the difference
//   exact, __fsub_rn) and issues the register-A form three times per
//   16-deep step (vh.qh, vl.qh, vh.ql). The queries are permuted to K6's
//   fragment order (f32_query_perm) before they are split. A stage holds
//   one k-block of ROWS_F32 = 128 rows (32 KB of f32 rows) and both
//   planes' query k-blocks (16 KB): 4 stages, 128 KB of rows in flight.
//   Stages of 64 rows (6 of them, 96 KB in flight, no spill) measured
//   slower at b = 256 and faster at b = 64 (PERF.md, the K4 variants).
// - bf16 rows (NV = 1): A is read from the swizzled stage by descriptor,
//   two products per 16-deep step (v.qh, v.ql); a stage holds one k-block
//   of 128 rows (16 KB) and both planes' k-blocks (16 KB), 6 stages.
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
//   k-block (64 floats a thread per 64-row m-block), and over f32 rows the
//   two A planes beside them (32 registers an m-block): with two m-blocks
//   (128 rows) about 192 of the consumers' 232, and ptxas spills some of
//   the rest (about 300 bytes a thread), which the 128-row stages still
//   outrun at b = 256.
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

template <typename RowT, int NV, int KS, int TM, bool STREAM>
__global__ void __launch_bounds__(sm90::THREADS, 1) bf16x3_binmax_sm90_kernel(
    const __grid_constant__ CUtensorMap qmap,  // [2 bq, dq] bf16: qh of every block, then ql
    const __grid_constant__ CUtensorMap vmap,  // [n_pad, d] f32 or bf16 rows
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

// the stage shapes (sm90::with_plan): no resident plan (KS1 = 0); one
// k-block with both query planes' k-blocks, at every depth: of ROWS_F32
// f32 rows (two row planes split in registers), or of 128 bf16 rows
constexpr int ROWS_F32 = 128;
template <typename RowT> struct Shape;
template <> struct Shape<float> {
    static constexpr int NV = 2, KS1 = 0, TM1 = 0, KS2 = 1, TM2 = ROWS_F32;
};
template <> struct Shape<__nv_bfloat16> {
    static constexpr int NV = 1, KS1 = 0, TM1 = 0, KS2 = 1, TM2 = 128;
};

template <typename RowT>
size_t smem_of(int d) {
    using S = Shape<RowT>;
    return sm90::plan_smem<RowT, S::KS1, S::TM1, S::KS2, S::TM2, 2, S::NV>(d);
}
template <typename RowT>
int stages_of(int d) {
    using S = Shape<RowT>;
    return sm90::plan_stages<RowT, S::KS1, S::TM1, S::KS2, S::TM2, 2, S::NV>(d);
}

// q: the query planes [2 * n_qb * 64, dq] bf16 (qh of every query block,
// then ql)
template <typename RowT>
int launch(const void* q, const void* v, const void* inv, const void* nsq, const void* rmask,
           const void* q_inv, const void* q_sq, const void* q_ok, const void* thr,
           const void* surv, const void* n_surv, void* out, int n_bins, int d, int b, int dq,
           int n_qb, int per_group, int metric, int take_min, int cmp, void* stream)
{
    using S = Shape<RowT>;
    const float* side[SlotKey::NSIDE] = {(const float*)inv, (const float*)nsq,
                                         (const float*)rmask};
    const auto get_kernel = [](auto ks, auto tm, auto st) {
        return bf16x3_binmax_sm90_kernel<RowT, S::NV, decltype(ks)::value, decltype(tm)::value,
                                         decltype(st)::value>;
    };
    const auto launch_fn = [&](auto kernel, dim3 grid, size_t smem, const CUtensorMap& qmap,
                               const CUtensorMap& vmap, const sm90::ScanArgs& a) {
        kernel<<<grid, sm90::THREADS, smem, (cudaStream_t)stream>>>(
            qmap, vmap, a, (const float*)q_inv, (const float*)q_sq, (const float*)q_ok,
            (const float*)thr, metric, take_min, cmp);
    };
    return sm90::launch_plan<RowT, S::KS1, S::TM1, S::KS2, S::TM2, 2, S::NV>(
        get_kernel, launch_fn, q, v, side, SlotKey::NSIDE, surv, n_surv, out, n_bins, d, b,
        dq, n_qb, per_group);
}

}  // namespace

extern "C" size_t bf16x3_binmax_smem_bytes(int d) { return smem_of<float>(d); }
extern "C" int bf16x3_binmax_stages(int d) { return stages_of<float>(d); }
extern "C" size_t bf16x3_binmax_bf16_smem_bytes(int d) { return smem_of<__nv_bfloat16>(d); }
extern "C" int bf16x3_binmax_bf16_stages(int d) { return stages_of<__nv_bfloat16>(d); }

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
