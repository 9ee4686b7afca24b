// K3: exact f32 bin maxima over f32 or bfloat16 rows, for Hopper (sm_90a).
//
// Replaces otters_tpu/ops/pallas_topk.py::_kernel in its prec="highest"
// mode (:182-189; the strict mode: the rerun when the fast check fails, Eq
// score filters, k > 128), over f32 rows (entry f32_binmax) and over
// bfloat16 rows upcast exactly to f32 as JAX's `v_ref[:].astype(jnp.float32)`
// does (entry f32_binmax_bf16): each dot is an f32 product with one IEEE
// rounding per term (__fmaf_rn on the CUDA cores, in depth order; no TF32,
// no tensor cores, independent of torch's TF32 switch), then the masked key
// of binmax_common.cuh (SlotKey) and its maximum over each live 512-row
// bin.
//
// Phase 1 and phase 2 sum in different orders: this kernel runs the depth
// in index order with FMAs, phase 2's torch rescore (cuBLAS f32) in its own
// order. They differ by ulps, within d 2^-24 |q| |v|, as the TPU's HIGHEST
// phase 1 and its phase-2 XLA dot do; the certificate of exactness is
// phase 2's.
//
// Design: the scan of csrc/cert_scan_sm90.cuh with f32 queries (QT =
// float), whose consumers are FFMA warpgroups: a persistent grid over the
// survivor list (CTA c holds query block c % n_qb and walks slots p, p + P,
// ...), a TMA ring fed by one producer thread with full / empty mbarriers,
// two consumer warpgroups on alternate stages. The f32 query block is 192
// KB at d = 768, so it never stays resident: every stage carries its 64
// queries' k-block (two 128-byte swizzled boxes of 32 deep) beside one
// k-block of 128 rows: f32 rows as two such boxes (K6's layout), bf16 rows
// as one box of 64 deep, widened exactly in registers (a shift or a mask
// per element, once per 16-byte chunk). Each consumer thread keeps an
// 8-row x 8-query register tile and reads both operands with 16-byte
// loads, K-contiguous as they landed: 4 FFMAs per f32 read from shared
// memory; the swizzle keeps a quarter-warp's row loads on 8 distinct bank
// groups and its query load a broadcast. The key, a running per-query max,
// shuffles and one shared reduction per bin stay in registers, and
// out[bin][q0 : q0 + 64] is written once. Stages: 4 of 48 KB (f32 rows) or
// 6 of 32 KB (bf16 rows), at every depth.
//
// Bound at the f32 path's shapes (4M x 768 f32 store, 256 queries, half of
// the 1024-row chunks pruned: about 2.0M live rows): 2 x 256 x 768 x 2.0M
// = 0.79 T f32 operations, 11.7 ms at the 67 TFLOP/s of the CUDA cores,
// against 6.1 GB of rows, 1.8 ms at 3.35 TB/s. So operations bound it.
// Over bf16 rows (10M x 768 store, about 5.0M live rows) the same count is
// 1.97 T operations, 29 ms, against 7.7 GB of rows: operations again. The
// rows and the streamed queries reach each SM from L2, (1 / 64 + 1 / 128)
// b d 4 bytes a row, about 24 bytes per 1,000 FFMAs.
//
// Hazards handled:
// - Zero padding past d: TMA fills a k-block past the rows' depth (a
//   multiple of 16, the store pads it) with zeros, and the wrapper pads the
//   queries' depth to a multiple of 64 with zeros: 0 * 0 adds nothing.
// - bf16 rows: the widening is exact, so the products are those of the
//   stored values, as in JAX.
// - Padded query rows (q_ok = 0) come out -inf; out is written only for
//   query lanes < b; n_surv = 0 launches safely.
// - Launch errors: the launchers return a CUDA error code.

#include <cuda_bf16.h>

#include "binmax_common.cuh"
#include "cert_scan_sm90.cuh"

using namespace binmax;

namespace {

template <typename RowT, int KS, int TM, bool STREAM>
__global__ void __launch_bounds__(sm90::THREADS, 1) f32_binmax_sm90_kernel(
    const __grid_constant__ CUtensorMap qmap,  // [bq, dq] f32 queries
    const __grid_constant__ CUtensorMap vmap,  // [n_pad, d] f32 or bf16 rows
    const sm90::ScanArgs a,                    // side = {inv, nsq, rmask}
    const float* __restrict__ q_inv,           // [bq]
    const float* __restrict__ q_sq,            // [bq]
    const float* __restrict__ q_ok,            // [bq] 0/1
    const float* __restrict__ thr,             // [1]
    int metric, int take_min, int cmp)
{
    const float t = *thr;
    const auto make_key = [&](int q0, const int (&cols)[16]) {
        return make_slot_key(q0, cols, q_inv, q_sq, q_ok, t, metric, take_min, cmp);
    };
    sm90::scan<RowT, SlotKey::NSIDE, KS, TM, STREAM, 1, 1, float>(&qmap, &vmap, a, make_key);
}

// the stage shape (sm90::with_plan): no resident plan (KS1 = 0); one
// k-block of 128 rows with the queries' k-block, at every depth
constexpr int KS1 = 0, TM1 = 0, KS2 = 1, TM2 = 128;

template <typename RowT>
size_t smem_of(int d) {
    return sm90::plan_smem<RowT, KS1, TM1, KS2, TM2, 1, 1, float>(d);
}
template <typename RowT>
int stages_of(int d) {
    return sm90::plan_stages<RowT, KS1, TM1, KS2, TM2, 1, 1, float>(d);
}

template <typename RowT>
int launch(const void* q, const void* v, const void* inv, const void* nsq, const void* rmask,
           const void* q_inv, const void* q_sq, const void* q_ok, const void* thr,
           const void* surv, const void* n_surv, void* out, int n_bins, int d, int b, int dq,
           int n_qb, int per_group, int metric, int take_min, int cmp, void* stream)
{
    const float* side[SlotKey::NSIDE] = {(const float*)inv, (const float*)nsq,
                                         (const float*)rmask};
    const auto get_kernel = [](auto ks, auto tm, auto st) {
        return f32_binmax_sm90_kernel<RowT, decltype(ks)::value, decltype(tm)::value,
                                      decltype(st)::value>;
    };
    const auto launch_fn = [&](auto kernel, dim3 grid, size_t smem, const CUtensorMap& qmap,
                               const CUtensorMap& vmap, const sm90::ScanArgs& a) {
        kernel<<<grid, sm90::THREADS, smem, (cudaStream_t)stream>>>(
            qmap, vmap, a, (const float*)q_inv, (const float*)q_sq, (const float*)q_ok,
            (const float*)thr, metric, take_min, cmp);
    };
    return sm90::launch_plan<RowT, KS1, TM1, KS2, TM2, 1, 1, float>(
        get_kernel, launch_fn, q, v, side, SlotKey::NSIDE, surv, n_surv, out, n_bins, d, b,
        dq, n_qb, per_group);
}

}  // namespace

extern "C" size_t f32_binmax_smem_bytes(int d) { return smem_of<float>(d); }
extern "C" int f32_binmax_stages(int d) { return stages_of<float>(d); }
extern "C" size_t f32_binmax_bf16_smem_bytes(int d) { return smem_of<__nv_bfloat16>(d); }
extern "C" int f32_binmax_bf16_stages(int d) { return stages_of<__nv_bfloat16>(d); }

extern "C" int f32_binmax_launch(
    const void* q, const void* v, const void* inv, const void* nsq,
    const void* rmask, const void* q_inv, const void* q_sq, const void* q_ok,
    const void* thr, const void* surv, const void* n_surv, void* out,
    int n_bins, int d, int b, int dq, int n_qb, int per_group, int metric, int take_min,
    int cmp, void* stream)
{
    return launch<float>(q, v, inv, nsq, rmask, q_inv, q_sq, q_ok, thr, surv, n_surv, out,
                         n_bins, d, b, dq, n_qb, per_group, metric, take_min, cmp, stream);
}

extern "C" int f32_binmax_bf16_launch(
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
