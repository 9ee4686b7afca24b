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
//                   split in the kernel (x_h = bf16(x), x_l = bf16(x - x_h))
//                   and VH / VL pre-split bf16 arrays in device memory, the
//                   three products summed in that order in f32, then the
//                   bin maxima, out[tile][q][j].
//
// They exist to time the whole tile product, so they keep no pruning, no
// mask and no metric. Designs, each a copy of the core it times:
// - probe_mm / probe_mm_bins: K3's exact-f32 core (csrc/f32_binmax.cu): a
//   block takes one 512-row bin and 64 queries, stages 32-deep tiles
//   transposed in shared memory, and each thread keeps a 4-query x 8-row
//   register tile of FFMA accumulators (no TF32, no tensor cores).
//   probe_mm writes only two columns of each tile, so nvcc would delete
//   the other 1022 and their products; it also stores every dot to
//   `all_dots` when that pointer is not null, a runtime condition the
//   compiler cannot decide, and the wrapper passes null.
// - probe_planes: K4's bf16x3 core (csrc/bf16x3_binmax.cu): 64-deep steps,
//   the f32 query tile split into bf16 planes in shared memory, the VH /
//   VL tiles copied as they are, three WMMA bf16 products per step into a
//   fresh f32 fragment that joins the running sum with a rounded add.
//
// Bounds at the script's shapes (q [256, 768], v [1,007,616, 768], t =
// 1024, 984 tiles): probe_mm and probe_mm_bins do 2 x 256 x 768 x
// 1,007,616 = 396 G f32 operations, 5.9 ms at the 67 TFLOP/s of the CUDA
// cores, against 3.1 GB of rows, 0.9 ms: operations bound them.
// probe_planes does three such products in bf16, 1.19 T operations, 1.2
// ms at 989 TFLOP/s, against the 3.1 GB of VH and VL, 0.9 ms: operations.
//
// Hazards handled: zero padding past d (any d; 16-byte loads only where
// aligned); padded query rows are computed but never written (q < b); NaN
// rows are skipped by fmaxf, where the script's jnp.max would propagate
// them; launch errors are returned from cudaGetLastError().

#include <cuda_bf16.h>
#include <mma.h>

#include "binmax_common.cuh"

using namespace nvcuda;
using namespace binmax;

namespace {

constexpr int RN = 128;         // rows per sub-tile
// the FFMA core (K3's)
constexpr int FBK = 32;         // depth per staged step
constexpr int QLD = QB + 4;     // transposed tile leading dimensions
constexpr int VLD = RN + 4;
constexpr int TQ = 4;           // queries per thread
constexpr int TR = 8;           // rows per thread
// the bf16x3 core (K4's)
constexpr int PBK = 64;         // depth per staged step
constexpr int PLD = PBK + 8;    // bf16 plane leading dimension
constexpr int CLD = RN + 4;     // f32 dot tile leading dimension

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

// rows [r0, r0 + rows) x [k0, k0 + PBK) of an f32 [*, d] matrix into the
// bf16 high / low planes [rows][PLD] (zeros past d), JAX's roundings
__device__ __forceinline__ void split_tile(
    const float* __restrict__ src, size_t r0, int rows, int d, int k0, bool vec,
    __nv_bfloat16* hi, __nv_bfloat16* lo, int tid)
{
    constexpr int C4 = PBK / 4;
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
        for (int e = 0; e < 4; ++e) {
            const __nv_bfloat16 h = __float2bfloat16_rn(x[e]);
            hi[r * PLD + c * 4 + e] = h;
            lo[r * PLD + c * 4 + e] = __float2bfloat16_rn(__fsub_rn(x[e], __bfloat162float(h)));
        }
    }
}

// rows [r0, r0 + rows) x [k0, k0 + PBK) of a bf16 [*, d] matrix copied as
// they are into the plane [rows][PLD] (zeros past d); vec: d % 4 == 0
__device__ __forceinline__ void copy_tile(
    const __nv_bfloat16* __restrict__ src, size_t r0, int rows, int d, int k0,
    bool vec, __nv_bfloat16* dst, int tid)
{
    constexpr int C4 = PBK / 4;
    for (int i = tid; i < rows * C4; i += THREADS) {
        const int r = i / C4, c = i - r * C4;
        const int kk = k0 + c * 4;
        const __nv_bfloat16* p = src + (r0 + r) * (size_t)d + kk;
        __nv_bfloat16* o = dst + r * PLD + c * 4;
        if (vec && kk + 4 <= d) {
            *reinterpret_cast<uint2*>(o) = *reinterpret_cast<const uint2*>(p);
        } else {
#pragma unroll
            for (int e = 0; e < 4; ++e)
                o[e] = kk + e < d ? p[e] : __float2bfloat16_rn(0.f);
        }
    }
}

constexpr size_t planes_smem_bytes() {
    return (size_t)2 * (QB + RN) * PLD * sizeof(__nv_bfloat16)
         + (size_t)QB * CLD * sizeof(float);
}

__global__ void __launch_bounds__(THREADS) probe_planes_kernel(
    const float* __restrict__ q,             // [bq, d]
    const __nv_bfloat16* __restrict__ vh,    // [n_rows, d]
    const __nv_bfloat16* __restrict__ vl,    // [n_rows, d]
    float* __restrict__ out,                 // [n_tiles, b, nb]
    int d, int b, int nb, int n_qblocks)
{
    const int bin = blockIdx.x / n_qblocks;
    const int q0 = (blockIdx.x - bin * n_qblocks) * QB;
    const int tile = bin / nb, j = bin - tile * nb;
    const bool vec = (d % 4) == 0;

    extern __shared__ __align__(128) unsigned char smem[];
    __nv_bfloat16* qh = reinterpret_cast<__nv_bfloat16*>(smem);   // [QB][PLD]
    __nv_bfloat16* ql = qh + QB * PLD;
    __nv_bfloat16* th = ql + QB * PLD;                             // [RN][PLD]
    __nv_bfloat16* tl = th + RN * PLD;
    float* cs = reinterpret_cast<float*>(tl + RN * PLD);           // [QB][CLD]

    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int wm = warp >> 2;  // 32-query half
    const int wn = warp & 3;   // 32-row quarter
    const int eq = tid >> 2;
    const int esub = tid & 3;
    float best = -INFINITY;

    for (int rs = 0; rs < BIN / RN; ++rs) {
        const size_t row0 = (size_t)bin * BIN + (size_t)rs * RN;
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int jj = 0; jj < 2; ++jj) wmma::fill_fragment(acc[i][jj], 0.0f);

        for (int k0 = 0; k0 < d; k0 += PBK) {
            split_tile(q, (size_t)q0, QB, d, k0, vec, qh, ql, tid);
            copy_tile(vh, row0, RN, d, k0, vec, th, tid);
            copy_tile(vl, row0, RN, d, k0, vec, tl, tid);
            __syncthreads();
            wmma::fragment<wmma::accumulator, 16, 16, 16, float> part[2][2];
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
                for (int jj = 0; jj < 2; ++jj) wmma::fill_fragment(part[i][jj], 0.0f);
            const int kmax = min(PBK, ((d - k0) + 15) / 16 * 16);
            for (int kk = 0; kk < kmax; kk += 16) {
                wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                               wmma::row_major> ah[2], al[2];
                wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                               wmma::col_major> bh[2], bl[2];
#pragma unroll
                for (int i = 0; i < 2; ++i) {
                    const int off = (wm * 32 + i * 16) * PLD + kk;
                    wmma::load_matrix_sync(ah[i], qh + off, PLD);
                    wmma::load_matrix_sync(al[i], ql + off, PLD);
                }
#pragma unroll
                for (int jj = 0; jj < 2; ++jj) {
                    const int off = (wn * 32 + jj * 16) * PLD + kk;
                    wmma::load_matrix_sync(bh[jj], th + off, PLD);
                    wmma::load_matrix_sync(bl[jj], tl + off, PLD);
                }
#pragma unroll
                for (int i = 0; i < 2; ++i)
#pragma unroll
                    for (int jj = 0; jj < 2; ++jj) {
                        wmma::mma_sync(part[i][jj], ah[i], bh[jj], part[i][jj]);
                        wmma::mma_sync(part[i][jj], ah[i], bl[jj], part[i][jj]);
                        wmma::mma_sync(part[i][jj], al[i], bh[jj], part[i][jj]);
                    }
            }
            // one step's partial sum joins the running sum in IEEE f32
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
                for (int jj = 0; jj < 2; ++jj)
#pragma unroll
                    for (int e = 0; e < acc[i][jj].num_elements; ++e)
                        acc[i][jj].x[e] = __fadd_rn(acc[i][jj].x[e], part[i][jj].x[e]);
            __syncthreads();  // the planes are rewritten by the next step
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int jj = 0; jj < 2; ++jj)
                wmma::store_matrix_sync(cs + (wm * 32 + i * 16) * CLD + wn * 32 + jj * 16,
                                        acc[i][jj], CLD, wmma::mem_row_major);
        __syncthreads();
        for (int r = esub * 32; r < esub * 32 + 32; ++r) best = fmaxf(best, cs[eq * CLD + r]);
        __syncthreads();  // cs is rewritten by the next sub-tile
    }

    best = fmaxf(best, __shfl_xor_sync(0xffffffffu, best, 1));
    best = fmaxf(best, __shfl_xor_sync(0xffffffffu, best, 2));
    if (esub == 0 && q0 + eq < b) out[((size_t)tile * b + q0 + eq) * nb + j] = best;
}

}  // namespace

// static shared memory for the FFMA probes; the planes probe's is dynamic
extern "C" size_t probe_mm_smem_bytes(int) { return 0; }
extern "C" size_t probe_mm_bins_smem_bytes(int) { return 0; }
extern "C" size_t probe_planes_smem_bytes(int) { return planes_smem_bytes(); }

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

extern "C" int probe_planes_launch(const void* q, const void* vh, const void* vl, void* out,
                                   int n_tiles, int nb, int d, int b, int n_qblocks,
                                   void* stream)
{
    const size_t smem = planes_smem_bytes();
    cudaError_t err = cudaFuncSetAttribute(
        probe_planes_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((unsigned)n_tiles * (unsigned)nb * (unsigned)n_qblocks);
    probe_planes_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
        (const float*)q, (const __nv_bfloat16*)vh, (const __nv_bfloat16*)vl, (float*)out,
        d, b, nb, n_qblocks);
    return (int)cudaGetLastError();
}
