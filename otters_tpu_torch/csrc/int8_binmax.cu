// K2: uncertified int8 bin maxima, for Hopper (sm_90a).
//
// Replaces otters_tpu/ops/pallas_topk.py::_kernel in its int8 mode
// (certify=False, q_ref.dtype == int8, :149-155): symmetric int8 queries
// times int8 rows with int32 accumulation, which is exact at any dimension
// below the wrapper's limit, the int32 dot converted to f32 (JAX's astype),
// then the masked key of binmax_common.cuh and its maximum over each live
// 512-row bin. The int32 dots are bit for bit those of an exact integer
// product.
//
// Design: the scan of csrc/cert_scan_sm90.cuh with int8 queries (QT =
// int8): a persistent grid over the survivor list, the query block resident
// in shared memory (streamed through the ring for deep rows: any d), a TMA
// ring feeding two ping-pong consumer warpgroups, and wgmma
// m64n64k32.s32.s8.s8 with rows as A and the queries as B, both read by
// descriptor from 128-byte swizzled k-blocks of 128 int8 codes (128 B a
// row): no register loads, no conversion, no query permutation, no f16
// rewrite, int32 accumulators in registers (32 a thread per m-block). Each
// accumulator is converted with __int2float_rn and handed to the key of
// K6 and K4 (binmax_common.cuh SlotKey, side data {inv, nsq, rmask}), so
// every metric, take-min and score filter is the one of the other
// uncertified kernels. A stage holds one k-block of 256 rows (32 KB; of
// 128 rows when fewer than 4 stages fit beside the resident query block,
// whose 48 KB at d = 768 leave 4 stages of 256 rows), K1-bf16's shapes,
// whose k-blocks are 128 B a row too.
//
// Bound at the main path's shapes (10M x 768 int8 store, 256 queries, half
// of the 1024-row chunks pruned: 5,000,192 live rows): 3.84 GB of rows,
// 1.15 ms at 3.35 TB/s; 1.97 T int8 operations, 0.99 ms at 1,979 TOP/s. So
// bytes bound it, as they bound K1-bf16 and K6-bf16, whose stages move the
// same bytes a row tile.
//
// Hazards handled:
// - Exactness: int32 accumulation cannot overflow for 127^2 d < 2^31 (the
//   wrapper checks d); __int2float_rn rounds to nearest even like JAX's
//   astype (exact below 2^24, i.e. d <= 1040).
// - The rows' depth is a multiple of 16 (the store pads it), so their TMA
//   stride is a multiple of 16 bytes; the last k-block past the depth is
//   filled with zeros by TMA, and the wrapper pads the queries' depth to a
//   multiple of 128 with zeros.
// - Padded query rows (q_ok = 0) come out -inf; out is written only for
//   query lanes < b; n_surv = 0 launches safely.
// - Launch errors: the launcher returns a CUDA error code; the Python
//   wrapper raises when it is not 0.

#include "binmax_common.cuh"
#include "cert_scan_sm90.cuh"

using namespace binmax;

namespace {

template <int KS, int TM, bool STREAM>
__global__ void __launch_bounds__(sm90::THREADS, 1) int8_binmax_sm90_kernel(
    const __grid_constant__ CUtensorMap qmap,  // [bq, dq] int8 queries
    const __grid_constant__ CUtensorMap vmap,  // [n_pad, d] int8 rows
    const sm90::ScanArgs a,                    // side = {inv, nsq, rmask}
    const float* __restrict__ q_inv,           // [bq] of the int8 queries
    const float* __restrict__ q_sq,            // [bq] of the int8 queries
    const float* __restrict__ q_ok,            // [bq] 0/1
    const float* __restrict__ thr,             // [1]
    int metric, int take_min, int cmp)
{
    const float t = *thr;
    const auto make_key = [&](int q0, const int (&cols)[16]) {
        return make_slot_key(q0, cols, q_inv, q_sq, q_ok, t, metric, take_min, cmp);
    };
    sm90::scan<int8_t, SlotKey::NSIDE, KS, TM, STREAM, 1, 1, int8_t>(&qmap, &vmap, a,
                                                                     make_key);
}

// the stage shapes (sm90::with_plan): one k-block of 256 rows, of 128
// when fewer than 4 stages fit; streamed past 2
constexpr int KS1 = 1, TM1 = 256, KS2 = 1, TM2 = 128;

}  // namespace

extern "C" size_t int8_binmax_smem_bytes(int d) {
    return sm90::plan_smem<int8_t, KS1, TM1, KS2, TM2, 1, 1, int8_t>(d);
}
extern "C" int int8_binmax_stages(int d) {
    return sm90::plan_stages<int8_t, KS1, TM1, KS2, TM2, 1, 1, int8_t>(d);
}

extern "C" int int8_binmax_launch(
    const void* q, const void* v, const void* inv, const void* nsq,
    const void* rmask, const void* q_inv, const void* q_sq, const void* q_ok,
    const void* thr, const void* surv, const void* n_surv, void* out,
    int n_bins, int d, int b, int dq, int n_qb, int per_group, int metric, int take_min,
    int cmp, void* stream)
{
    const float* side[SlotKey::NSIDE] = {(const float*)inv, (const float*)nsq,
                                         (const float*)rmask};
    const auto get_kernel = [](auto ks, auto tm, auto st) {
        return int8_binmax_sm90_kernel<decltype(ks)::value, decltype(tm)::value,
                                       decltype(st)::value>;
    };
    const auto launch_fn = [&](auto kernel, dim3 grid, size_t smem, const CUtensorMap& qmap,
                               const CUtensorMap& vmap, const sm90::ScanArgs& a) {
        kernel<<<grid, sm90::THREADS, smem, (cudaStream_t)stream>>>(
            qmap, vmap, a, (const float*)q_inv, (const float*)q_sq, (const float*)q_ok,
            (const float*)thr, metric, take_min, cmp);
    };
    return sm90::launch_plan<int8_t, KS1, TM1, KS2, TM2, 1, 1, int8_t>(
        get_kernel, launch_fn, q, v, side, SlotKey::NSIDE, surv, n_surv, out, n_bins, d, b,
        dq, n_qb, per_group);
}
