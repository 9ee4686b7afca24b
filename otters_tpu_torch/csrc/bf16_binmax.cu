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
// Design: both entries run the scan of csrc/cert_scan_sm90.cuh (K1's and
// K5's): a persistent grid over the survivor list, the query block
// resident (streamed through the ring for deep rows: any d), a TMA ring
// feeding two ping-pong consumer warpgroups, wgmma m64n64k16 with rows as
// A and the queries as B. The caller (ops/fused_topk.py) pads the batch to
// whole 64-query blocks and the query depth to a multiple of 64.
// - f32 rows: TMA lands each 64-deep f32 k-block as two 128-byte swizzled
//   boxes of 32 deep; each consumer thread loads its A fragment (16-byte
//   loads free of bank conflicts), rounds it to bf16 in registers
//   (cvt.rn.bf16x2, one per pair) and issues wgmma with A from registers.
//   The caller permutes each 64-deep block of the queries (f32_query_perm)
//   to the order in which a thread's fragment is loaded. A stage holds one
//   k-block of 128 rows (32 KB; of 64 rows when fewer than 4 stages fit).
// - bf16 rows: A is read from the swizzled stage by descriptor, as K1 and
//   K5 read bf16 rows; no conversion, no query permutation. A stage holds
//   one k-block of 256 rows (of 128 when fewer than 4 stages fit; beside
//   only the head of the query block where 128 rows would leave fewer: the
//   split plan), K1-bf16's shapes (K5's two k-blocks of 128 rows timed the same or
//   slower; PERF.md, the K6 / K4 variants).
// The key is key_of unchanged (binmax_common.cuh SlotKey), each slot's
// q_ok and metric norm in registers.
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
// - The rows' depth is a multiple of 16 (the store pads it), so the rows'
//   TMA stride is a multiple of 16 bytes; the wrapper checks it.
// - Padded query rows (q_ok = 0) come out -inf; out is written only for
//   query lanes < b; n_surv = 0 launches safely.
// - Launch errors: the launchers return a CUDA error code.

#include "binmax_common.cuh"
#include "cert_scan_sm90.cuh"

using namespace binmax;

namespace {

template <typename RowT, int KS, int TM, bool STREAM>
__global__ void __launch_bounds__(sm90::THREADS, 1) bf16_binmax_sm90_kernel(
    const __grid_constant__ CUtensorMap qmap,  // [bq, dq] bf16 queries (permuted for f32 rows)
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
    sm90::scan<RowT, SlotKey::NSIDE, KS, TM, STREAM>(&qmap, &vmap, a, make_key);
}

// the stage shapes (sm90::with_plan), wide then narrow: over f32 rows one
// k-block of 128 rows (32 KB), of 64 rows when fewer than 4 stages fit;
// over bf16 rows one k-block of 256 rows, of 128 when fewer than 4 fit,
// and 4 stages of 256 rows beside the head of the query block where 128
// rows would leave fewer (the split plan; K1-bf16's shapes); streamed past
// 2
template <typename RowT> struct Shape;
template <> struct Shape<float> { static constexpr int KS1 = 1, TM1 = 128, KS2 = 1, TM2 = 64; };
template <> struct Shape<__nv_bfloat16> {
    static constexpr int KS1 = 1, TM1 = 256, KS2 = 1, TM2 = 128;
};

template <typename RowT>
size_t smem_of(int d) {
    using S = Shape<RowT>;
    return sm90::plan_smem<RowT, S::KS1, S::TM1, S::KS2, S::TM2>(d);
}
template <typename RowT>
int stages_of(int d) {
    using S = Shape<RowT>;
    return sm90::plan_stages<RowT, S::KS1, S::TM1, S::KS2, S::TM2>(d);
}

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
        return bf16_binmax_sm90_kernel<RowT, decltype(ks)::value, decltype(tm)::value,
                                       decltype(st)::value>;
    };
    const auto launch_fn = [&](auto kernel, dim3 grid, size_t smem, const CUtensorMap& qmap,
                               const CUtensorMap& vmap, const sm90::ScanArgs& a) {
        kernel<<<grid, sm90::THREADS, smem, (cudaStream_t)stream>>>(
            qmap, vmap, a, (const float*)q_inv, (const float*)q_sq, (const float*)q_ok,
            (const float*)thr, metric, take_min, cmp);
    };
    return sm90::launch_plan<RowT, S::KS1, S::TM1, S::KS2, S::TM2>(
        get_kernel, launch_fn, q, v, side, SlotKey::NSIDE, surv, n_surv, out, n_bins, d, b,
        dq, n_qb, per_group);
}

}  // namespace

extern "C" size_t bf16_binmax_smem_bytes(int d) { return smem_of<float>(d); }
extern "C" int bf16_binmax_stages(int d) { return stages_of<float>(d); }
extern "C" size_t bf16_binmax_bf16_smem_bytes(int d) { return smem_of<__nv_bfloat16>(d); }
extern "C" int bf16_binmax_bf16_stages(int d) { return stages_of<__nv_bfloat16>(d); }

extern "C" int bf16_binmax_launch(
    const void* q, const void* v, const void* inv, const void* nsq,
    const void* rmask, const void* q_inv, const void* q_sq, const void* q_ok,
    const void* thr, const void* surv, const void* n_surv, void* out,
    int n_bins, int d, int b, int dq, int n_qb, int per_group, int metric, int take_min,
    int cmp, void* stream)
{
    return launch<float>(q, v, inv, nsq, rmask, q_inv, q_sq, q_ok, thr, surv, n_surv, out,
                         n_bins, d, b, dq, n_qb, per_group, metric, take_min, cmp, stream);
}

extern "C" int bf16_binmax_bf16_launch(
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
