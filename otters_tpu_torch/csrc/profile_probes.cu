// The three profiling probes of scripts/kernel_profile_variants.py, for
// Hopper (sm_90a). Each replaces one kernel body that the script's `run`
// launches through pl.pallas_call over 1024-row tiles of v (t rows, nb =
// t / 512 bins per tile):
//
//   probe_mm        k_mm (:11): the f32 product of each tile at HIGHEST,
//                   out[tile][q][c] = dot(q, row c of the tile), c < 2;
//   probe_mm_bins   k_mm_bins (:16): the same product, then the max over
//                   each 512-row bin, out[bin][q];
//   probe_planes    k_planes (:24): qh.vh + qh.vl + ql.vh with the query
//                   split into bf16 planes (x_h = bf16(x), x_l = bf16(x -
//                   x_h)) and VH / VL pre-split bf16 arrays in device
//                   memory, then the max over each 512-row bin, out[bin][q].
//
// The wrappers (otters_tpu_torch/profile_variants.py) permute the bin
// maxima [n_bins, b] to the script's [tile][q][j]. The probes exist to time
// the whole tile product, so they keep no pruning, no mask and no metric:
// each runs on the scan of csrc/cert_scan_sm90.cuh over a persistent grid
// of every bin (the survivor list is all of them), with the raw dot as the
// key and no side data.
// - probe_mm / probe_mm_bins: K3's FFMA consumers (f32 queries) over f32
//   rows: a TMA ring whose stages carry one 128-byte box of 256 rows (32
//   deep) and the 64 queries' box of the same depth; each consumer thread
//   keeps a 16-row x 8-query tile of exact f32 accumulators (one IEEE FMA
//   per term, in depth order; no TF32, no tensor cores). probe_mm keeps the
//   whole tile product live (the scan's bin maxima go to a scratch output)
//   and hands every row's dots to its key, which writes those of rows 0
//   and 1 of each tile, and every dot to `all_dots` when that pointer is
//   not null (the wrapper passes null; the card test does not).
// - probe_planes: the bf16x3 core of K4 over f32 rows, with the row planes
//   read from two bf16 arrays instead of split in registers: the stages
//   carry the VH and VL k-blocks of their rows (two row maps) and both
//   query planes' k-blocks (the wrapper splits the queries, as K4's does),
//   two ping-pong consumer warpgroups, per 16-deep step three wgmma
//   products (A by descriptor) into a partial accumulator that joins the
//   running sum per 64-deep k-block with a rounded add. Its k-blocks hold 4
//   bytes a row element, as K4's over f32 rows: the two differ only in
//   where the row planes come from.
//
// Bounds at the script's shapes (q [256, 768], v [1,007,616, 768], t =
// 1024, 984 tiles): probe_mm and probe_mm_bins do 2 x 256 x 768 x
// 1,007,616 = 396 G f32 operations, 5.9 ms at the 67 TFLOP/s of the CUDA
// cores, against 3.1 GB of rows, 0.9 ms: operations bound them.
// probe_planes does three such products in bf16, 1.19 T operations, 1.2
// ms at 989 TFLOP/s, against the 3.1 GB of VH and VL, 0.9 ms: operations.
//
// Hazards handled: TMA fills past d with zeros, the queries are padded to
// 64-deep k-blocks with zeros, and the wrappers pass a zero-padded copy of
// rows whose stride is not a multiple of 16 bytes; padded query rows are
// computed but never written (q < b); NaN rows are skipped by fmaxf, where
// the script's jnp.max would propagate them; launch errors are returned
// from cudaGetLastError().

#include <cuda_bf16.h>

#include "cert_scan_sm90.cuh"

namespace {

// the key of the probes: the raw dot, no side data
struct RawDot {
    static constexpr int NSIDE = 0;
    __device__ __forceinline__ float operator()(float dot, int) const { return dot; }
};

// the key of probe_mm: the raw dot, and each row's dots (queries q + 8 j)
// as the FFMA scan hands them over: rows 0 and 1 of every t-row tile to
// first2 [n_tiles, b, 2], every dot to all_dots [bq, n_rows] unless null
struct TileDots : RawDot {
    float* first2;
    float* all_dots;
    unsigned n_rows, t;
    int b;

    __device__ __forceinline__ void store(size_t row, int q, const float (&dots)[8]) const {
        const unsigned r = (unsigned)row;
        if (all_dots != nullptr) {
#pragma unroll
            for (int j = 0; j < 8; ++j) all_dots[(size_t)(q + 8 * j) * n_rows + r] = dots[j];
        }
        // t is a multiple of 512, so a tile's rows 0 and 1 are rows 0 and 1
        // of a bin: the division only for those
        if ((r & 511u) < 2 && r % t < 2) {
            const unsigned tile = r / t, c = r & 1u;
#pragma unroll
            for (int j = 0; j < 8; ++j)
                if (q + 8 * j < b) first2[((size_t)tile * b + q + 8 * j) * 2 + c] = dots[j];
        }
    }
};

template <typename Key, int KS, int TM, bool STREAM>
__global__ void __launch_bounds__(sm90::THREADS, 1) probe_f32_kernel(
    const __grid_constant__ CUtensorMap qmap,  // [bq, dq] f32 queries
    const __grid_constant__ CUtensorMap vmap,  // [n_rows, d] f32 rows
    const sm90::ScanArgs a,                    // out [n_bins, b]
    const Key key)
{
    const auto make_key = [&](int, const int (&)[16]) { return key; };
    sm90::scan<float, Key::NSIDE, KS, TM, STREAM, 1, 1, float>(&qmap, &vmap, a, make_key);
}

template <int KS, int TM, bool STREAM>
__global__ void __launch_bounds__(sm90::THREADS, 1) probe_planes_kernel(
    const __grid_constant__ CUtensorMap qmap,   // [2 bq, dq] bf16: qh of every block, then ql
    const __grid_constant__ CUtensorMap vhmap,  // [n_rows, d] bf16 VH
    const __grid_constant__ CUtensorMap vlmap,  // [n_rows, d] bf16 VL
    const sm90::ScanArgs a)                     // out [n_bins, b]
{
    const auto make_key = [](int, const int (&)[16]) { return RawDot{}; };
    sm90::scan<__nv_bfloat16, RawDot::NSIDE, KS, TM, STREAM, 2, 2>(&qmap, &vhmap, a, make_key,
                                                                  &vlmap);
}

// the stage shapes (sm90::with_plan), no resident plan: K3's over f32 rows
// for the FFMA probes (one 32-deep box of 256 rows with the queries' box, 4
// stages at every depth); for probe_planes one k-block of PLANE_ROWS
// rows of both row planes (32 KB) with both query planes' k-blocks (16 KB),
// K4's shape over f32 rows, 4 stages at every depth (stages of 64 rows
// timed the same, PERF.md)
constexpr int PLANE_ROWS = 128;
constexpr int KS1 = 0, TM1 = 0, KS2 = 1;
using Bf16 = __nv_bfloat16;

template <typename Key>
int launch_f32(const Key& key, const void* q, const void* v, const void* surv,
               const void* n_surv, void* out, int n_bins, int d, int b, int dq, int n_qb,
               int per_group, void* stream)
{
    const auto get_kernel = [](auto ks, auto tm, auto st) {
        return probe_f32_kernel<Key, decltype(ks)::value, decltype(tm)::value,
                                decltype(st)::value>;
    };
    const auto launch_fn = [&](auto kernel, dim3 grid, size_t smem, const CUtensorMap& qmap,
                               const CUtensorMap& vmap, const sm90::ScanArgs& a) {
        kernel<<<grid, sm90::THREADS, smem, (cudaStream_t)stream>>>(qmap, vmap, a, key);
    };
    return sm90::launch_plan<float, KS1, TM1, KS2, sm90::ffma_rows<float>(), 1, 1, float>(
        get_kernel, launch_fn, q, v, nullptr, 0, surv, n_surv, out, n_bins, d, b, dq, n_qb,
        per_group);
}

}  // namespace

extern "C" size_t probe_mm_smem_bytes(int d) {
    return sm90::plan_smem<float, KS1, TM1, KS2, sm90::ffma_rows<float>(), 1, 1, float>(d);
}
extern "C" int probe_mm_stages(int d) {
    return sm90::plan_stages<float, KS1, TM1, KS2, sm90::ffma_rows<float>(), 1, 1, float>(d);
}
extern "C" size_t probe_mm_bins_smem_bytes(int d) { return probe_mm_smem_bytes(d); }
extern "C" int probe_mm_bins_stages(int d) { return probe_mm_stages(d); }
extern "C" size_t probe_planes_smem_bytes(int d) {
    return sm90::plan_smem<Bf16, KS1, TM1, KS2, PLANE_ROWS, 2, 2>(d);
}
extern "C" int probe_planes_stages(int d) {
    return sm90::plan_stages<Bf16, KS1, TM1, KS2, PLANE_ROWS, 2, 2>(d);
}

// q: the f32 queries [n_qb * 64, dq]; v: [n_bins * 512, d] f32, row stride
// d * 4 bytes a multiple of 16; out [n_bins, b]: the bin maxima (every bin
// is scanned); surv / n_surv: the bins to scan
extern "C" int probe_mm_bins_launch(const void* q, const void* v, const void* surv,
                                    const void* n_surv, void* out, int n_bins, int d, int b,
                                    int dq, int n_qb, int per_group, void* stream)
{
    return launch_f32(RawDot{}, q, v, surv, n_surv, out, n_bins, d, b, dq, n_qb, per_group,
                      stream);
}

// as probe_mm_bins (out a scratch [n_bins, b]), and first2 [n_bins * 512 /
// t, b, 2] the dots of rows 0 and 1 of each t-row tile; all_dots [n_qb *
// 64, n_bins * 512] every dot, or null
extern "C" int probe_mm_launch(const void* q, const void* v, const void* surv,
                               const void* n_surv, void* out, void* first2, void* all_dots,
                               int n_bins, int d, int b, int dq, int n_qb, int per_group, int t,
                               void* stream)
{
    TileDots key;
    key.first2 = (float*)first2;
    key.all_dots = (float*)all_dots;
    key.n_rows = (unsigned)n_bins * sm90::BIN;
    key.t = (unsigned)t;
    key.b = b;
    return launch_f32(key, q, v, surv, n_surv, out, n_bins, d, b, dq, n_qb, per_group, stream);
}

// q: the query planes [2 * n_qb * 64, dq] bf16 (qh of every query block,
// then ql); vh, vl: [n_bins * 512, d] bf16, row stride d * 2 bytes a
// multiple of 16; out [n_bins, b]; surv / n_surv: the bins to scan
extern "C" int probe_planes_launch(const void* q, const void* vh, const void* vl,
                                   const void* surv, const void* n_surv, void* out, int n_bins,
                                   int d, int b, int dq, int n_qb, int per_group, void* stream)
{
    const auto get_kernel = [](auto ks, auto tm, auto st) {
        return probe_planes_kernel<decltype(ks)::value, decltype(tm)::value,
                                   decltype(st)::value>;
    };
    const auto launch_fn = [&](auto kernel, dim3 grid, size_t smem, const CUtensorMap& qmap,
                               const CUtensorMap& vhmap, const CUtensorMap& vlmap,
                               const sm90::ScanArgs& a) {
        kernel<<<grid, sm90::THREADS, smem, (cudaStream_t)stream>>>(qmap, vhmap, vlmap, a);
    };
    return sm90::launch_plan<Bf16, KS1, TM1, KS2, PLANE_ROWS, 2, 2>(
        get_kernel, launch_fn, q, vh, nullptr, 0, surv, n_surv, out, n_bins, d, b, dq, n_qb,
        per_group, vl);
}
