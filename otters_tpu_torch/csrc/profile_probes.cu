// The three profiling probes of scripts/kernel_profile_variants.py, for
// Hopper (sm_90a). Each replaces one kernel body that the script's `run`
// launches through pl.pallas_call over 1024-row tiles of v (t rows, nb =
// t / 512 bins per tile):
//
//   probe_mm        k_mm (:11): the f32 product of each tile at HIGHEST,
//                   out[tile][q][c] = dot(q, row c of the tile), c < 2;
//   probe_mm_bins   k_mm_bins (:16): the same product, then the max over
//                   each 512-row bin, out[tile][q][j];
//   probe_planes    k_planes (:24): qh.vh + qh.vl + ql.vh with the query
//                   split into bf16 planes (x_h = bf16(x), x_l = bf16(x -
//                   x_h)) and VH / VL pre-split bf16 arrays in device
//                   memory, then the max over each 512-row bin, out[bin][q]
//                   (the wrapper, profile_variants.k_planes, permutes it to
//                   the script's [tile][q][j]).
//
// They exist to time the whole tile product, so they keep no pruning, no
// mask and no metric. Designs:
// - probe_mm / probe_mm_bins: K3's exact-f32 core (csrc/f32_binmax.cu): a
//   block takes one 512-row bin and 64 queries, stages 32-deep tiles
//   transposed in shared memory, and each thread keeps a 4-query x 8-row
//   register tile of FFMA accumulators (no TF32, no tensor cores).
//   probe_mm writes only two columns of each tile, so nvcc would delete
//   the other 1022 and their products; it also stores every dot to
//   `all_dots` when that pointer is not null, a runtime condition the
//   compiler cannot decide, and the wrapper passes null.
// - probe_planes: the bf16x3 core of K4 over f32 rows on the scan of
//   csrc/cert_scan_sm90.cuh, with the row planes read from two bf16 arrays
//   instead of split in registers: a persistent grid over every bin (the
//   survivor list is all of them), a TMA ring whose stages carry the VH
//   and VL k-blocks of their rows (two row maps) and both query planes'
//   k-blocks (the wrapper splits the queries, as K4's does), two ping-pong
//   consumer warpgroups, per 16-deep step three wgmma products (A by
//   descriptor) into a partial accumulator that joins the running sum per
//   64-deep k-block with a rounded add, and the raw dot as the key (no side
//   data). Its k-blocks hold 4 bytes a row element, as K4's over f32 rows:
//   the two differ only in where the row planes come from.
//
// Bounds at the script's shapes (q [256, 768], v [1,007,616, 768], t =
// 1024, 984 tiles): probe_mm and probe_mm_bins do 2 x 256 x 768 x
// 1,007,616 = 396 G f32 operations, 5.9 ms at the 67 TFLOP/s of the CUDA
// cores, against 3.1 GB of rows, 0.9 ms: operations bound them.
// probe_planes does three such products in bf16, 1.19 T operations, 1.2
// ms at 989 TFLOP/s, against the 3.1 GB of VH and VL, 0.9 ms: operations.
//
// Hazards handled: zero padding past d (any d; FFMA probes: 16-byte loads
// only where aligned; probe_planes: TMA fills past d with zeros, and the
// wrapper pads a copy of VH / VL whose row stride is not a multiple of 16
// bytes); padded query rows are computed but never written (q < b); NaN
// rows are skipped by fmaxf, where the script's jnp.max would propagate
// them; launch errors are returned from cudaGetLastError().

#include <cuda_bf16.h>

#include "binmax_common.cuh"
#include "cert_scan_sm90.cuh"

using namespace binmax;

namespace {

constexpr int RN = 128;         // rows per sub-tile
// the FFMA core (K3's)
constexpr int FBK = 32;         // depth per staged step
constexpr int QLD = QB + 4;     // transposed tile leading dimensions
constexpr int VLD = RN + 4;
constexpr int TQ = 4;           // queries per thread
constexpr int TR = 8;           // rows per thread

// rows [r0, r0 + rows) x [k0, k0 + FBK) of an f32 [*, d] matrix,
// transposed into dst[FBK][ld] (zeros past d)
__device__ __forceinline__ void stage_t(
    const float* __restrict__ src, size_t r0, int rows, int d, int k0, bool vec,
    float* dst, int ld, int tid)
{
    constexpr int C4 = FBK / 4;
    for (int i = tid; i < rows * C4; i += THREADS) {
        const int r = i / C4, c = i - r * C4;
        const int kk = k0 + c * 4;
        float x[4] = {0.f, 0.f, 0.f, 0.f};
        if (kk < d) {
            const int4 raw = load16(src + (r0 + r) * (size_t)d + kk, 4 * (d - kk), vec);
            const float* f = reinterpret_cast<const float*>(&raw);
#pragma unroll
            for (int e = 0; e < 4; ++e) x[e] = f[e];
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) dst[(c * 4 + e) * ld + r] = x[e];
    }
}

// BINS: out[tile][q][j] = the max of bin j of the tile (probe_mm_bins);
// else out[tile][q][c] = the dot of the tile's row c < 2 (probe_mm), and
// every dot to all_dots [bq, n_rows] unless it is null
template <bool BINS>
__global__ void __launch_bounds__(THREADS) probe_ffma_kernel(
    const float* __restrict__ q,    // [bq, d]
    const float* __restrict__ v,    // [n_rows, d]
    float* __restrict__ out,        // [n_tiles, b, nb] or [n_tiles, b, 2]
    float* __restrict__ all_dots,   // [bq, n_rows] or null
    int d, int b, int nb, int n_qblocks)
{
    const int bin = blockIdx.x / n_qblocks;
    const int q0 = (blockIdx.x - bin * n_qblocks) * QB;
    const int tile = bin / nb, j = bin - tile * nb;
    const size_t n_rows = (size_t)(gridDim.x / n_qblocks) * BIN;
    const bool vec = (d % 4) == 0;

    __shared__ __align__(16) float qs[FBK * QLD];   // [FBK][QLD]
    __shared__ __align__(16) float vs[FBK * VLD];   // [FBK][VLD]

    const int tid = threadIdx.x;
    const int tq = tid >> 4;   // query group: queries tq*4 .. tq*4+3
    const int tr = tid & 15;   // row lane: rows tr, tr+16, ..., tr+112
    float best[TQ];
#pragma unroll
    for (int i = 0; i < TQ; ++i) best[i] = -INFINITY;

    for (int rs = 0; rs < BIN / RN; ++rs) {
        const size_t row0 = (size_t)bin * BIN + (size_t)rs * RN;
        float acc[TQ][TR];
#pragma unroll
        for (int i = 0; i < TQ; ++i)
#pragma unroll
            for (int jj = 0; jj < TR; ++jj) acc[i][jj] = 0.f;

        for (int k0 = 0; k0 < d; k0 += FBK) {
            stage_t(q, (size_t)q0, QB, d, k0, vec, qs, QLD, tid);
            stage_t(v, row0, RN, d, k0, vec, vs, VLD, tid);
            __syncthreads();
#pragma unroll 8
            for (int kk = 0; kk < FBK; ++kk) {
                const float4 a4 = *reinterpret_cast<const float4*>(qs + kk * QLD + tq * TQ);
                const float a[TQ] = {a4.x, a4.y, a4.z, a4.w};
                float bv[TR];
#pragma unroll
                for (int jj = 0; jj < TR; ++jj) bv[jj] = vs[kk * VLD + tr + 16 * jj];
#pragma unroll
                for (int i = 0; i < TQ; ++i)
#pragma unroll
                    for (int jj = 0; jj < TR; ++jj)
                        acc[i][jj] = __fmaf_rn(a[i], bv[jj], acc[i][jj]);
            }
            __syncthreads();  // the tiles are rewritten by the next step
        }

        if constexpr (BINS) {
#pragma unroll
            for (int i = 0; i < TQ; ++i)
#pragma unroll
                for (int jj = 0; jj < TR; ++jj) best[i] = fmaxf(best[i], acc[i][jj]);
        } else {
            if (all_dots != nullptr) {
#pragma unroll
                for (int i = 0; i < TQ; ++i)
#pragma unroll
                    for (int jj = 0; jj < TR; ++jj)
                        all_dots[(size_t)(q0 + tq * TQ + i) * n_rows + row0 + tr + 16 * jj] =
                            acc[i][jj];
            }
            if (j == 0 && rs == 0 && tr < 2) {
#pragma unroll
                for (int i = 0; i < TQ; ++i) {
                    const int qq = q0 + tq * TQ + i;
                    if (qq < b) out[((size_t)tile * b + qq) * 2 + tr] = acc[i][0];
                }
            }
        }
    }

    if constexpr (BINS) {
#pragma unroll
        for (int i = 0; i < TQ; ++i) {
            float m = best[i];
            m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
            m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
            m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 4));
            m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 8));
            const int qq = q0 + tq * TQ + i;
            if (tr == 0 && qq < b) out[((size_t)tile * b + qq) * nb + j] = m;
        }
    }
}

// the key of probe_planes: the raw dot, no side data
struct RawDot {
    static constexpr int NSIDE = 0;
    __device__ __forceinline__ float operator()(float dot, int) const { return dot; }
};

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

// the stage shape (sm90::with_plan): no resident plan; one k-block of
// PLANE_ROWS rows of both row planes (32 KB) with both query planes'
// k-blocks (16 KB), K4's shape over f32 rows: 4 stages at every depth
// (stages of 64 rows timed the same, PERF.md)
constexpr int PLANE_ROWS = 128;
constexpr int KS1 = 0, TM1 = 0, KS2 = 1, TM2 = PLANE_ROWS;
using Bf16 = __nv_bfloat16;

}  // namespace

// static shared memory for the FFMA probes; the planes probe's is its plan's
extern "C" size_t probe_mm_smem_bytes(int) { return 0; }
extern "C" size_t probe_mm_bins_smem_bytes(int) { return 0; }
extern "C" size_t probe_planes_smem_bytes(int d) {
    return sm90::plan_smem<Bf16, KS1, TM1, KS2, TM2, 2, 2>(d);
}
extern "C" int probe_planes_stages(int d) {
    return sm90::plan_stages<Bf16, KS1, TM1, KS2, TM2, 2, 2>(d);
}

extern "C" int probe_mm_launch(const void* q, const void* v, void* out, void* all_dots,
                               int n_tiles, int nb, int d, int b, int n_qblocks,
                               void* stream)
{
    const dim3 grid((unsigned)n_tiles * (unsigned)nb * (unsigned)n_qblocks);
    probe_ffma_kernel<false><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)q, (const float*)v, (float*)out, (float*)all_dots, d, b, nb,
        n_qblocks);
    return (int)cudaGetLastError();
}

extern "C" int probe_mm_bins_launch(const void* q, const void* v, void* out, int n_tiles,
                                    int nb, int d, int b, int n_qblocks, void* stream)
{
    const dim3 grid((unsigned)n_tiles * (unsigned)nb * (unsigned)n_qblocks);
    probe_ffma_kernel<true><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)q, (const float*)v, (float*)out, nullptr, d, b, nb, n_qblocks);
    return (int)cudaGetLastError();
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
    return sm90::launch_plan<Bf16, KS1, TM1, KS2, TM2, 2, 2>(
        get_kernel, launch_fn, q, vh, nullptr, 0, surv, n_surv, out, n_bins, d, b, dq, n_qb,
        per_group, vl);
}
