// The scan of every bin-max kernel for Hopper (sm_90a): a persistent grid
// over the survivor list, the query block resident in shared memory (or,
// for deep rows, streamed beside the rows past a resident head, or whole),
// a TMA ring with warp specialisation, and wgmma (or FFMA, for exact f32).
//
// What it computes: for every live 512-row bin (the survivor list
// surv[0 : n_surv), read on the device) and every query of the CTA's
// 64-query block, the max over the bin's rows of key(dot, row side data,
// query), with dot = bf16 query . row (exact products, f32 sums); with two
// query planes dot = qh . row + ql . row; with two query planes and two row
// planes dot = qh . vh + qh . vl + ql . vh (bf16x3); with int8 queries the
// exact int32 dot of int8 queries and rows, converted to f32; with f32
// queries the f32 dot, one IEEE FMA per term. The kernels supply the key:
// K1 over int8 and bf16 rows (csrc/cert_cos_binmax.cu, certified Cosine),
// K2 (csrc/int8_binmax.cu, uncertified int8), K3 over f32 and bf16 rows
// (csrc/f32_binmax.cu, exact f32), K5 (csrc/cert_fold_binmax.cu, the
// general certified fold), K6 over f32 and bf16 rows (csrc/bf16_binmax.cu,
// one bf16 pass), K4 (csrc/bf16x3_binmax.cu, bf16x3) over bf16 rows (the
// rows' low plane is 0: two query planes) and over f32 rows (scan_pair:
// two row planes split in registers, 128 queries a CTA), K1 over int8 rows
// at more than one query block (scan_pair_s8: 128 queries a CTA), and the
// profiling probes of
// csrc/profile_probes.cu (k_planes: bf16x3 over two bf16 row arrays;
// k_mm and k_mm_bins: exact f32 over f32 rows; the raw dot as the key, no
// side data). The header is templated on the row type (int8,
// bf16 or f32), the number of side arrays (0 to 4), the stage shape,
// whether the query block is streamed, the number of query planes (1 or 2)
// and of row planes (1 or 2), the query element type (bf16, int8 or f32)
// and the key.
//
// Design.
// - Persistent grid: about one CTA per SM (the shared memory admits no
//   second). CTA c holds query block c % n_qb and takes survivor slots p,
//   p + P, ... (p = c / n_qb, P = gridDim.x / n_qb), so the CTAs of a
//   batch's query blocks walk the same bins side by side and share the
//   rows through L2. No block exists for a pruned bin; no host round trip
//   reads n_surv; n_surv = 0 launches safely.
// - The query block is loaded once per CTA by TMA, 128-byte swizzled and
//   K-major in 64-deep blocks of [64 queries x 128 B], the layout wgmma
//   reads as its B operand, and stays resident across bins.
// - Two query planes (NQ = 2, K4 over bf16 rows): the caller splits each
//   query into qh = bf16(q) and ql = bf16(q - qh) and stacks the planes
//   (plane p of query block c at rows p * n_qb * 64 + 64 c of the query
//   map); both sit side by side in every 64-deep block, 16 KB per 64 deep
//   (K4 streams them with the rows at every depth: resident at d = 768
//   they would leave 32 KB of ring, and the 96 KB of rows in flight of the
//   streamed plan measured faster, PERF.md). Each 64-deep k-block
//   is multiplied by both planes into a partial accumulator, which the
//   consumers wait for and add to the running sum element by element with
//   __fadd_rn: the tensor cores' own accumulation never spans more than
//   one 64-deep step, so scoring.high_precision_bound holds.
// - Two row planes (NV = 2, with NQ = 2: bf16x3 over two bf16 row arrays,
//   the probe k_planes): each 64-deep k-block's partial is the three
//   products vh.qh + vl.qh + vh.ql of every 16-deep step (the first
//   overwrites it), then added with __fadd_rn as above. A second row map
//   loads the low plane's k-block (VL, split beforehand) beside the high
//   one in every stage, and A is read by descriptor. A k-block holds 4
//   bytes a row element, and the stages stream both query planes (resident
//   they would take 192 KB at d = 768). Over f32 rows K4 takes the pair
//   plan below.
// - The pair plan (scan_pair; K4 over f32 rows, every batch): a CTA holds a
//   pair of query blocks, 128 queries (n_qp = ceil(n_qb / 2) pairs, an odd
//   last block padded with q_ok = 0 lanes; CTA c holds pair c % n_qp). A
//   stage is one 64-deep k-block of 128 f32 rows (32 KB) and both planes'
//   k-blocks of the 128 queries (32 KB), 3 stages; both consumer
//   warpgroups take every stage (its empty barrier counts 2), warpgroup w
//   its rows 64 w .. 64 w + 63 times all 128 queries. The k-block lands
//   once (as for K6) and each thread splits its A fragment in registers,
//   vh = bf16_rn(x), vl = bf16_rn(x - vh) with the difference exact (JAX's
//   astype roundings; an inf row gives a NaN low plane, as there): per
//   16-deep step one split fragment feeds vh.qh, vl.qh, vh.ql as
//   m64n128k16 products into the k-block's partial, added with __fadd_rn
//   as above. SM-side traffic per (row, query) pair and 64-deep k-block is
//   4 B (a CTA of 64 queries would move 6 B: a row's 256 B over 64
//   queries, a query's 256 B of planes over 128 rows), and each row is
//   fetched from L2 and split once per pair of query blocks. At b <= 64
//   half the lanes are padding, and the pair still measured faster there
//   than a 64-query CTA in scan (PERF.md). A
//   warpgroup splits the next k-block's fragment while the current one's
//   products run (two fragment buffers). A thread holds one m-block by 128
//   queries: 64 running and 64 partial accumulators and 64 registers of
//   split fragments, about 200 of 232; ptxas spills nothing. The key runs
//   after each 128-row sub-tile, then a shuffle reduce-scatter leaves each
//   lane the running max of 4 queries.
// - The pair plan over int8 rows (scan_pair_s8; K1 at more than one query
//   block, ops/fused_topk.py::K1_PAIR_FROM): as above, a CTA of 128
//   queries on a pair of blocks; a stage is one 64-deep k-block of 256
//   int8 rows (16 KB, plain) and, past the resident head, the pair's query
//   k-block (16 KB); the first R query k-blocks of the pair stay resident
//   (16 KB each, the largest R that leaves 4 stages: R = 6 from d = 384,
//   so 4 stages at d = 768, 231,504 B). Both warpgroups take every stage,
//   warpgroup w rows 128 w .. 128 w + 127 as two m-blocks by all 128
//   queries. Each row is converted to f16 (or bf16) once per pair, twice
//   per 256-query request (the 64-query plan converted it four times), and
//   SM-side traffic per (row, query) pair and 64-deep k-block is 0.5 B of
//   rows (64 B over 128 queries) plus 0.5 B of queries (128 B over 256
//   rows) on the streamed depth steps only: 0.75 B at d = 768 (the 64-query
//   plan moved 1.0 B: a row's 64 B over 64 queries). A group is one
//   m-block's four m64n128k16 products of one k-block, from registers; the
//   next group's fragment is converted into the other of two 16-register
//   buffers while the current group runs, and a warpgroup waits only for
//   the older group (wait_group 1) before it reuses that buffer or releases
//   a stage. A thread holds 2 x 64 running sums, 2 x 16 fragment registers
//   and 12 of side data; the code reaches R228 of setmaxnreg's 232 and
//   ptxas spills nothing (256-row stages with the fragments of two whole
//   k-blocks spilled 192-260 bytes; 128-row stages, 1.5 B a pair with the
//   queries streamed, measured slower: PERF.md). The queries arrive rewritten: the
//   caller applies queries_to_f16's rule to each pair (ops/fused_topk.py::
//   f16_queries, on the card csrc/cert_cos_binmax.cu's
//   cert_cos_binmax_f16_queries_kernel) and passes the f16 (or bf16) pair, its
//   per-query 2^-s and a flag per pair; the sums are unscaled before the
//   key, as in scan.
// - Deep rows (the streamed plan): when the resident query block (8 KB per
//   k-block and plane) would leave fewer than two ring stages, or always
//   for a kernel with no resident plan (K3, K4, the probes), no query block
//   is resident; each ring stage carries the query k-blocks of its depth
//   step beside the row k-blocks, in the same layout, and the consumers
//   read B from the stage. Any depth then fits; the query block is read
//   again for every row sub-tile (from L2).
// - The split plan (bf16 rows, one plane of each): where the whole query
//   block would stay resident beside fewer than 4 stages (at d = 1,536 its
//   192 KB leave 2 stages of 16 KB: 32 KB of rows in flight on an SM), only
//   its first R k-blocks stay resident and the rest ride in the stages as
//   in the streamed plan, so the ring keeps 4 stages (of the wide shape
//   where they fit: 128 KB of rows in flight). The consumers take B from
//   the resident head for the depth steps below R and from the stage
//   beyond; the products and their order are those of the other plans.
// - One producer thread keeps an even number of ring stages of KS k-blocks
//   of [TM rows x KD deep] in flight with full / empty mbarrier pairs (KD =
//   64, 128 for int8 queries, one 128-byte row box for f32 queries:
//   sm90::stage_depth).
// - Two consumer warpgroups in ping-pong: the stages alternate between
//   them, and each takes a TM-row sub-tile of its own (TM / 64 m-blocks,
//   f32 accumulators in registers, 32 a thread per m-block), so one
//   warpgroup converts, waits and releases while the other's products run.
//   Each stage is waited for, multiplied to completion (wgmma m64n64k16,
//   rows as A, queries as B) and released.
//   - bf16 rows: A is read from the swizzled stage by descriptor.
//   - int8 rows with int8 queries (K2): A and B are read by descriptor
//     from 128-byte swizzled k-blocks of 128 codes (the layout of a bf16
//     k-block of 64), wgmma m64n64k32.s32.s8.s8 into int32 accumulators
//     (exact), each converted with __int2float_rn before the key.
//   - int8 rows with bf16 queries (K1): each thread loads its A fragment
//     from the stage (16-byte
//     loads; the caller permutes the depth of every 64-deep block of the
//     queries so that a thread's fragment bytes of a row are contiguous),
//     converts it exactly in registers and issues the register-A form; no
//     converted copy of the tile is written.
//   - f32 rows: TMA cannot convert, so a k-block lands as f32 in two
//     128-byte swizzled boxes of [TM rows x 32 deep]; each thread loads its
//     A fragment (four 16-byte loads a row: chunks 2t, 2t + 1 of each half,
//     t = lane % 4; the caller permutes the query depth to match, see
//     ops/fused_topk.py::f32_query_perm), rounds it to bf16 in registers
//     (one cvt.rn.bf16x2 per pair) and issues the register-A form. With
//     that chunk order the 8 threads of a quarter-warp's load touch 8
//     distinct bank groups under the swizzle, so the loads are free of
//     bank conflicts.
// - f32 queries (K3, and the probes k_mm / k_mm_bins): the consumers are
//   FFMA warpgroups on the same ring. A stage's k-block is one 128-byte
//   swizzled box of rows with the 64 queries' f32 of the same depth (one or
//   two boxes of 32 deep): 256 f32 rows 32 deep (32 KB, 4 stages) or 128
//   bf16 rows 64 deep (16 KB, 6 stages). Each thread keeps a 16-row (f32
//   rows) or 8-row (bf16 rows) x 8-query tile of f32 accumulators, one
//   __fmaf_rn per term in depth order. Over f32 rows, per 4-deep chunk it
//   loads its 8 queries once and streams its 16 rows: 24 shared loads per
//   512 FFMAs (an 8 x 8 tile takes 16 per 256), with 128 accumulators of
//   setmaxnreg's 232 registers. Over bf16 rows each row's 16 bytes (8
//   deep) are loaded once and widened in registers, and the larger tile
//   measured slower (PERF.md). A quarter-warp's row loads sit on 8 distinct
//   bank groups under the swizzle, its query load is a broadcast. Every
//   consumer thread releases the stage (the empty barrier counts 128).
// - int8 rows, f16 products: int8 -> f16 takes 5 instructions per 4 codes
//   (the bytes + 128 under an f16 exponent, one f16x2 subtract per pair),
//   int8 -> bf16 11, and the conversion is most of the consumers' work
//   beside wgmma. So once the query block is resident, each query is scaled
//   by a power of two 2^s that puts its largest magnitude in [2^14, 2^15)
//   and rewritten in place as f16, if every element of the block survives
//   the round trip exactly; the products are then those of the bf16
//   queries times 2^s, and each dot is multiplied by 2^-s (exact) before
//   the key. A block with a query whose magnitudes span more than f16's
//   range stays bf16 and converts the rows to bf16; so does the streamed
//   plan, which holds no whole query block to rewrite. The pair plan takes
//   the same rule per pair from the caller (it streams its queries, which
//   cannot be rewritten in place): a pair is f16 if both of its blocks are.
// - The epilogue stays in registers: the rows' side data is read from
//   global memory (__ldg) when a sub-tile starts and first used after its
//   products; the key folds each accumulator into a running per-query max;
//   a shuffle reduction inside the warp, then shared-memory atomicMax over
//   the 8 consumer warps once per bin; out[bin][q0 : q0 + 64] is written
//   once.
// - setmaxnreg gives the producer warpgroup 40 registers and the consumers
//   232.
//
// Where trouble lies, and what the code does about it.
// - The certificate's headroom: wgmma's f32 accumulation order and
//   rounding differ from WMMA's and from the plain product's. The
//   certificate allows mixed_cert_eps(d) = 4 d 2^-24 + 4e-6; chip_smoke.py
//   measures the accumulated dots against float64 and asserts d 2^-24.
// - Tensor maps need the driver API (cuTensorMapEncodeTiled), taken
//   through the runtime's driver entry point (no -lcuda); they are encoded
//   per launch for that launch's pointers and passed as __grid_constant__.
//   The rows' global stride (d bytes for int8) must be a multiple of 16:
//   the store pads its rows' depth to a multiple of 16 (ops/scoring.py).
//   Boxes past the depth (the last k-block, an f32 half box) are filled
//   with zeros by TMA and count their full bytes.
// - Barrier phases: a waiter may never be a lap ahead of its barrier,
//   whose parity would then read as an old phase. The ring is even, so
//   each stage always serves the same consumer warpgroup. Every consumer
//   walks every bin of its CTA to the end; padded query lanes (q_ok = 0)
//   are computed and not written. A wait that spins for about 10 s traps
//   instead of hanging the card.
// - The f16 rewrite of the queries is a generic-proxy store into memory
//   that wgmma reads through the async proxy: a proxy fence and a barrier
//   stand between them.
// - Register hazards of asynchronous wgmma: in scan each stage's products
//   complete (wgmma.wait_group 0) before its fragment and accumulator
//   registers are touched again, and the overlap comes from the other
//   warpgroup; the pair plans keep two fragment buffers and wait for the
//   older group only, so that a buffer is rewritten after its group is
//   complete.
// - Register pressure with two row planes over f32 rows: the running and
//   partial accumulators and both A planes of every m-block live across a
//   k-block. The pair plan holds one m-block by 128 queries and the split
//   fragments of two k-blocks, about 200 registers a thread of
//   setmaxnreg's 232, with no spill (two m-blocks by 64 queries, the
//   64-query CTA it replaced, spilled 316 bytes); folding the
//   previous sub-tile's sums under the next one's products (the key's work
//   overlapped) would hold both sums and spilled 486 bytes, slower
//   (PERF.md). ptxas reports the launch bound's 168 registers for
//   each kernel; the consumers' code after setmaxnreg.inc uses up to 232.
// - Roundings: the keys' multiplies and adds are __fmul_rn / __fadd_rn.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace sm90 {

constexpr int BIN = 512;       // rows per bin
constexpr int QB = 64;         // queries per CTA
constexpr int TK = 64;         // depth of a k-block of bf16 or f32 queries
constexpr int CONSUMERS = 256; // two consumer warpgroups
constexpr int THREADS = 384;   // + one producer warpgroup (one thread works)
constexpr int MAX_STAGES = 12;
constexpr size_t SMEM_LIMIT = 232448;
// [64] per-query maxima as ordered ints, [64] per-query 2^-s, the f16 flag
constexpr int RED_BYTES = 2 * QB * 4 + 8;

// The query element type QT: bf16 (K1, K4, K5, K6, k_planes), int8 (K2) or
// f32 (K3). A k-block is KD deep: 64 elements, or 128 for int8 queries, so
// that a k-block of int8 rows and queries is 128 B a row and takes the same
// 128-byte swizzled layout and descriptor as a bf16 one (wgmma's k32 steps
// of int8 then advance 32 B, as its k16 steps of bf16 do); a 64-byte
// swizzle of 64-deep int8 k-blocks would need a second descriptor layout
// for no gain. f32 queries land as two 128-byte boxes of 32 deep.
template <typename QT>
__host__ __device__ constexpr int kdepth() { return sizeof(QT) == 1 ? 128 : 64; }
// one KD-deep block of one query plane: 8 KB (bf16, int8), 16 KB (f32)
template <typename QT>
__host__ __device__ constexpr int qblock_bytes() { return QB * kdepth<QT>() * (int)sizeof(QT); }
constexpr int QBLOCK_BYTES = qblock_bytes<__nv_bfloat16>();

// The depth of a ring stage's k-block: the queries' KD, except under f32
// queries (the FFMA consumers), whose k-block is one 128-byte box of rows,
// 32 f32 or 64 bf16 deep, with the queries of the same depth (one or two
// 128-byte boxes of 32 f32)
template <typename RowT, typename QT>
__host__ __device__ constexpr int stage_depth() {
    return sizeof(QT) == 4 ? 128 / (int)sizeof(RowT) : kdepth<QT>();
}
// rows of the FFMA consumers' stages and sub-tiles: over f32 rows half a
// bin (a 16-row register tile a thread; each of the two warpgroups takes
// one sub-tile of every bin), over bf16 rows 128 (an 8-row tile, which
// measured faster there: the rows are widened in registers, PERF.md)
template <typename RowT>
__host__ __device__ constexpr int ffma_rows() { return sizeof(RowT) == 4 ? 256 : 128; }

// one [TM rows x stage depth] k-block of a ring stage
template <typename RowT, int TM, typename QT = __nv_bfloat16>
__host__ __device__ constexpr int tile_bytes() {
    return TM * stage_depth<RowT, QT>() * (int)sizeof(RowT);
}

// one ring stage: KS row k-blocks (of each of the NV row planes), and with a
// streamed query block the KS query k-blocks (NQ planes each) of the same
// depth step
template <typename RowT, int KS, int TM, bool STREAM, int NQ = 1, int NV = 1,
          typename QT = __nv_bfloat16>
__host__ __device__ constexpr int stage_bytes() {
    return KS * (NV * tile_bytes<RowT, TM, QT>()
                 + (STREAM ? NQ * QB * stage_depth<RowT, QT>() * (int)sizeof(QT) : 0));
}

// dynamic shared memory for `stages` stages at depth d: 1 KB of alignment
// slack, the resident query blocks of NQ planes (all nk k-blocks; with the
// query k-blocks streamed, the first `resident` of them: none, or the
// split plan's head), the ring, the reduction buffer and the barriers
template <typename RowT, int KS, int TM, bool STREAM, int NQ = 1, int NV = 1,
          typename QT = __nv_bfloat16>
__host__ __device__ inline size_t smem_bytes(int d, int stages, int resident = 0) {
    const int nk = (d + kdepth<QT>() - 1) / kdepth<QT>();
    return 1024 + (size_t)(STREAM ? resident : nk) * NQ * qblock_bytes<QT>()
         + (size_t)stages * stage_bytes<RowT, KS, TM, STREAM, NQ, NV, QT>()
         + RED_BYTES + (size_t)(2 * stages + 1) * 8;
}

// the most stages (an even number up to MAX_STAGES) that fit, never
// below 2: the two consumer warpgroups take alternate stages, so with an
// even ring each stage always serves the same warpgroup and no waiter can
// be a lap ahead of its barrier's phase
template <typename RowT, int KS, int TM, bool STREAM, int NQ = 1, int NV = 1,
          typename QT = __nv_bfloat16>
__host__ __device__ inline int stages_for(int d, int resident = 0) {
    int s = MAX_STAGES;
    while (s > 2 && smem_bytes<RowT, KS, TM, STREAM, NQ, NV, QT>(d, s, resident) > SMEM_LIMIT)
        s -= 2;
    return s;
}

// The plan of a launch at depth d: the wide stage shape (KS1 k-blocks of
// TM1 rows) when 4 stages of it fit beside the resident query block, else
// the narrow one (KS2 of TM2) when 2 of it fit, else the narrow one with
// the query block streamed; KS1 = 0: no resident plan, the narrow shape
// streamed at every depth. Where the narrow plan would keep fewer than 4
// stages and the rows are bf16 with one query plane (K1-bf16, K5,
// K6-bf16), the split plan instead: the first R query k-blocks resident,
// the rest streamed, with 4 stages of the wide shape and the largest R
// that leaves them, else of the narrow shape likewise (over int8 rows K1's
// f16 products need the whole block resident: it keeps the narrow plan).
// with_plan calls f(KS, TM, STREAM, resident) with the first three as
// integral constants and the count of resident query k-blocks (nk when
// the block is resident, R split, 0 streamed); ops/fused_topk.py::sm90_plan
// mirrors the choice.
struct Plan {
    bool wide;     // the stage shape: KS1 x TM1, else KS2 x TM2
    bool stream;   // the stages carry the query k-blocks past the resident ones
    int resident;  // query k-blocks resident in shared memory
};

template <typename RowT, int NQ, int NV>
constexpr bool splits() { return sizeof(RowT) == 2 && NQ == 1 && NV == 1; }

template <typename RowT, int KS1, int TM1, int KS2, int TM2, int NQ = 1, int NV = 1,
          typename QT = __nv_bfloat16>
inline Plan plan_for(int d) {
    if constexpr (KS1 > 0) {
        const int nk = (d + kdepth<QT>() - 1) / kdepth<QT>();
        if (smem_bytes<RowT, KS1, TM1, false, NQ, NV, QT>(d, 4) <= SMEM_LIMIT)
            return {true, false, nk};
        if (smem_bytes<RowT, KS2, TM2, false, NQ, NV, QT>(d, 2) <= SMEM_LIMIT) {
            if constexpr (splits<RowT, NQ, NV>()) {
                if (smem_bytes<RowT, KS2, TM2, false, NQ, NV, QT>(d, 4) > SMEM_LIMIT) {
                    for (int r = nk - 1; r > 0; --r)
                        if (smem_bytes<RowT, KS1, TM1, true, NQ, NV, QT>(d, 4, r) <= SMEM_LIMIT)
                            return {true, true, r};
                    for (int r = nk - 1; r > 0; --r)
                        if (smem_bytes<RowT, KS2, TM2, true, NQ, NV, QT>(d, 4, r) <= SMEM_LIMIT)
                            return {false, true, r};
                }
            }
            return {false, false, nk};
        }
    }
    return {false, true, 0};
}

template <typename RowT, int KS1, int TM1, int KS2, int TM2, int NQ = 1, int NV = 1,
          typename QT = __nv_bfloat16, typename F>
auto with_plan(int d, const F& f) {
    using std::integral_constant;
    using Wide = integral_constant<int, KS1>;
    using WideRows = integral_constant<int, TM1>;
    using Narrow = integral_constant<int, KS2>;
    using NarrowRows = integral_constant<int, TM2>;
    const Plan p = plan_for<RowT, KS1, TM1, KS2, TM2, NQ, NV, QT>(d);
    if constexpr (KS1 > 0) {
        if (!p.stream)
            return p.wide ? f(Wide{}, WideRows{}, std::false_type{}, p.resident)
                          : f(Narrow{}, NarrowRows{}, std::false_type{}, p.resident);
        if constexpr (splits<RowT, NQ, NV>())
            if (p.wide) return f(Wide{}, WideRows{}, std::true_type{}, p.resident);
    }
    // streamed, or split with the narrow shape
    return f(Narrow{}, NarrowRows{}, std::true_type{}, p.resident);
}

// the plan's ring stages and shared memory at depth d (exported by each
// kernel source for ops/fused_topk.py's mirror and its test)
template <typename RowT, int KS1, int TM1, int KS2, int TM2, int NQ = 1, int NV = 1,
          typename QT = __nv_bfloat16>
int plan_stages(int d) {
    return with_plan<RowT, KS1, TM1, KS2, TM2, NQ, NV, QT>(
        d, [&](auto ks, auto tm, auto st, int resident) {
            return stages_for<RowT, decltype(ks)::value, decltype(tm)::value,
                              decltype(st)::value, NQ, NV, QT>(d, resident);
        });
}

template <typename RowT, int KS1, int TM1, int KS2, int TM2, int NQ = 1, int NV = 1,
          typename QT = __nv_bfloat16>
size_t plan_smem(int d) {
    return with_plan<RowT, KS1, TM1, KS2, TM2, NQ, NV, QT>(
        d, [&](auto ks, auto tm, auto st, int resident) {
            constexpr int KS = decltype(ks)::value, TM = decltype(tm)::value;
            constexpr bool S = decltype(st)::value;
            return smem_bytes<RowT, KS, TM, S, NQ, NV, QT>(
                d, stages_for<RowT, KS, TM, S, NQ, NV, QT>(d, resident), resident);
        });
}

// The pair plan (scan_pair: K4 over f32 rows, at every batch size):
// a CTA holds a pair of query blocks, and a stage one 64-deep k-block of
// PAIR_ROWS f32 rows (two 128-byte swizzled half boxes of 32 deep, 32 KB)
// with both query planes' k-blocks of the pair (32 KB), which both
// consumer warpgroups share. Its shared memory: 1 KB of alignment slack,
// the ring, scan's reduction buffer sized for 128 queries (the maxima; the
// scales and the flag unused), and the barriers; the most stages that fit
// (3), odd or even: every stage serves both warpgroups, so no waiter can
// be a lap ahead of its barrier.
// Over int8 rows (K1, scan_pair_s8) a stage holds one 64-deep k-block of
// PAIR_S8_ROWS int8 rows (plain, 64 B a row) and the pair's bf16 or f16
// query k-block (16 KB): 24 KB, 9 stages.
constexpr int PAIR_Q = 2 * QB;  // queries of a CTA
constexpr int PAIR_ROWS = 128;  // rows of a stage, 64 for each warpgroup
constexpr int PAIR_STAGE = PAIR_ROWS * TK * 4 + 2 * PAIR_Q * TK * 2;
constexpr int PAIR_RED_BYTES = 2 * PAIR_Q * 4 + 8;
constexpr int PAIR_S8_ROWS = 256;  // rows of an int8 stage, 128 for each warpgroup
constexpr int PAIR_S8_STAGE = PAIR_S8_ROWS * TK + PAIR_Q * TK * 2;

__host__ __device__ constexpr size_t pair_smem_bytes(int stages) {
    return 1024 + (size_t)stages * PAIR_STAGE + PAIR_RED_BYTES + (size_t)(2 * stages + 1) * 8;
}
__host__ __device__ constexpr int pair_stages() {
    int s = MAX_STAGES;
    while (s > 2 && pair_smem_bytes(s) > SMEM_LIMIT) --s;
    return s;
}

// Over int8 rows the head of the pair's query block stays resident: R
// k-blocks of 16 KB before the ring (the largest R <= nk that leaves
// PAIR_S8_MIN_STAGES stages), then as many stages as fit; the stages carry
// the query k-blocks of depth steps >= R.
constexpr int PAIR_S8_QBLOCK = PAIR_Q * TK * 2;
constexpr int PAIR_S8_MIN_STAGES = 4;
__host__ __device__ constexpr size_t pair_s8_smem_bytes(int stages, int resident) {
    return 1024 + (size_t)resident * PAIR_S8_QBLOCK + (size_t)stages * PAIR_S8_STAGE
         + PAIR_RED_BYTES + (size_t)(2 * stages + 1) * 8;
}
__host__ __device__ constexpr int pair_s8_resident(int d) {
    int r = (d + TK - 1) / TK;
    while (r > 0 && pair_s8_smem_bytes(PAIR_S8_MIN_STAGES, r) > SMEM_LIMIT) --r;
    return r;
}
__host__ __device__ constexpr int pair_s8_stages(int d) {
    const int r = pair_s8_resident(d);
    int s = MAX_STAGES;
    while (s > 2 && pair_s8_smem_bytes(s, r) > SMEM_LIMIT) --s;
    return s;
}

// ---------------------------------------------------------------------------
// PTX wrappers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" :: "r"(bar) : "memory");
}

// wait for the completion of the phase of parity `parity`; trap after
// about 10 s rather than hang
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    uint32_t done;
    long long start = 0;
    while (true) {
        asm volatile(
            "{\n .reg .pred p;\n"
            " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            " selp.u32 %0, 1, 0, p;\n}"
            : "=r"(done) : "r"(bar), "r"(parity) : "memory");
        if (done) return;
        const long long now = clock64();
        if (start == 0) start = now;
        else if (now - start > 20000000000LL) __trap();
    }
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%3, %4}], [%2];"
        :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
        : "memory");
}

// wgmma descriptor of a K-major operand in 128-byte swizzled [rows][128 B]
// atoms of 8 rows (1024 B apart)
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
    return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16)
         | ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(N) : "memory");
}

// keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma (f32 or s32 accumulators)
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
    for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}
__device__ __forceinline__ void fence_acc(int (&d)[32]) {
#pragma unroll
    for (int i = 0; i < 32; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
    for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

#define SM90_ACC_OUT                                                                   \
    "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),            \
    "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),          \
    "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),      \
    "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),      \
    "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),      \
    "+f"(d[30]), "+f"(d[31])
#define SM90_ACC_OUT_S32                                                               \
    "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),            \
    "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),          \
    "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),      \
    "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),      \
    "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),      \
    "+r"(d[30]), "+r"(d[31])
#define SM90_ACC_REGS                                                                  \
    "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "          \
    "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// D[64 rows x 64 queries] += A[64 x 16] (shared, descriptor) . B[16 x 64];
// with accumulate = 0, D = A . B
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db,
                                         int accumulate = 1) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SM90_ACC_REGS
        ", %32, %33, p, 1, 1, 0, 0;\n}"
        : SM90_ACC_OUT : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 rows x 64 queries] += A[64 x 32] . B[32 x 64] in int8 with exact
// s32 accumulation (both operands K-major by descriptor: the integer form
// has no transpose or negate immediates); with accumulate = 0, D = A . B
__device__ __forceinline__ void wgmma_ss(int (&d)[32], uint64_t da, uint64_t db,
                                         int accumulate = 1) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 " SM90_ACC_REGS
        ", %32, %33, p;\n}"
        : SM90_ACC_OUT_S32 : "l"(da), "l"(db), "r"(accumulate));
}

// the same with A from registers (the m16n8k16 fragment of each warp's 16
// rows: a0 (row g, k 2t..2t+1), a1 (row g+8), a2 (row g, k 2t+8..),
// a3 (row g+8, k 2t+8..), g = lane / 4, t = lane % 4), in f16 or bf16
template <bool F16>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint64_t db,
                                         int accumulate = 1) {
    if constexpr (F16)
        asm volatile(
            "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
            " wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 " SM90_ACC_REGS
            ", {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}"
            : SM90_ACC_OUT : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(accumulate));
    else
        asm volatile(
            "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
            " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SM90_ACC_REGS
            ", {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}"
            : SM90_ACC_OUT : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(accumulate));
}

#define SM90_ACC64_OUT                                                                 \
    "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),            \
    "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),          \
    "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),      \
    "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),      \
    "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),      \
    "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),      \
    "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),      \
    "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),      \
    "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),      \
    "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),      \
    "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
#define SM90_ACC64_REGS                                                                \
    "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "          \
    "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
    "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
    "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// D[64 rows x 128 queries] += A[64 x 16] (registers, the fragment of
// wgmma_rs) . B[16 x 128], in bf16 or f16; with accumulate = 0, D = A . B.
// Accumulator element i: row g + 8 ((i >> 1) & 1), query 8 (i >> 2) + 2 t +
// (i & 1), so elements 0..31 are those of wgmma_rs over queries 0..63 and
// 32..63 those over queries 64..127.
template <bool F16 = false>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], uint32_t a0, uint32_t a1,
                                              uint32_t a2, uint32_t a3, uint64_t db,
                                              int accumulate = 1) {
    if constexpr (F16)
        asm volatile(
            "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
            " wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 " SM90_ACC64_REGS
            ", {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}"
            : SM90_ACC64_OUT : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(accumulate));
    else
        asm volatile(
            "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
            " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " SM90_ACC64_REGS
            ", {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}"
            : SM90_ACC64_OUT : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(accumulate));
}

// a float as an int whose signed order is the float order (NaN excluded),
// for shared-memory atomicMax, and back
__device__ __forceinline__ int ordered(float f) {
    const int i = __float_as_int(f);
    return i >= 0 ? i : i ^ 0x7fffffff;
}
__device__ __forceinline__ float unordered(int i) {
    return __int_as_float(i >= 0 ? i : i ^ 0x7fffffff);
}

// two int8 codes (bytes i, j of w) -> two f16 or bf16 values, exactly. u =
// the bytes + 128 as unsigned; f16: 0x64XX is 1024 + XX, so one f16x2
// subtract of 1152 leaves the code; bf16: 0x4B0000XX is 2^23 + XX as f32.
template <bool F16>
__device__ __forceinline__ uint32_t s8x2_convert(uint32_t w, int i, int j) {
    const uint32_t u = w ^ 0x80808080u;
    if constexpr (F16) {
        const uint32_t r = __byte_perm(u, 0x64646464u, (uint32_t)i | ((uint32_t)j << 8) | 0x4040u);
        uint32_t o;
        asm("sub.f16x2 %0, %1, %2;" : "=r"(o) : "r"(r), "r"(0x64806480u));
        return o;
    } else {
        const float magic = 8388736.0f;  // 2^23 + 128
        const float lo = __uint_as_float(__byte_perm(u, 0x4B000000u, (uint32_t)i | 0x7540u)) - magic;
        const float hi = __uint_as_float(__byte_perm(u, 0x4B000000u, (uint32_t)j | 0x7540u)) - magic;
        const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
        return *reinterpret_cast<const uint32_t*>(&h);
    }
}

// The f16 rule of one query (queries_to_f16, and for the pair plan the
// caller's rewrite, csrc/cert_cos_binmax.cu): its largest magnitude m (bf16
// bits) gives s = 141 - (m >> 7) (0 for a zero query), which puts it in
// [2^14, 2^15); the query is ok if m is finite (m < inf excludes inf and
// NaN) and s <= 126 (2^-s a normal float); up = 2^s and down = 2^-s, both
// 1 where it is not.
struct F16Scale {
    float up, down;
    bool ok;
};
__device__ __forceinline__ F16Scale f16_scale(uint32_t m) {
    const int s = m == 0 ? 0 : 141 - (int)(m >> 7);
    const bool ok = m < 0x7f80u && s <= 126;
    return {ok ? __int_as_float((127 + s) << 23) : 1.f,
            ok ? __int_as_float((127 - s) << 23) : 1.f, ok};
}

// m folded with the magnitudes (bf16 bits) of a pair of bf16 values
__device__ __forceinline__ uint32_t bf16x2_absmax(uint32_t m, uint32_t w) {
    return max(m, max(w & 0x7fffu, (w >> 16) & 0x7fffu));
}

// a pair of bf16 values -> the pair of f16 values of each times up; ok
// stays true while each is exactly up times its bf16 value (the scaled f32
// value, and the way back by down: an underflow fails one of the two)
__device__ __forceinline__ uint32_t bf16x2_to_f16(uint32_t w, float up, float down, bool& ok) {
    uint32_t o = 0;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
        const float f = __uint_as_float((w >> (16 * k)) << 16);
        const __half h = __float2half_rn(f * up);
        ok = ok && __half2float(h) == f * up && __half2float(h) * down == f;
        o |= (uint32_t)__half_as_ushort(h) << (16 * k);
    }
    return o;
}

// Rewrite the resident bf16 query blocks (qg, nk 64-deep blocks of [64 x
// 128 B]) in place as f16, each query scaled by 2^s (its largest magnitude
// into [2^14, 2^15)), if every element comes back exactly; unscale[q] =
// 2^-s. Run by the 256 consumer threads (4 per query; a query's row of a
// block is its own 128 B whatever the swizzle); flag is 1 on entry.
// Returns whether the block is f16 now.
__device__ __forceinline__ bool queries_to_f16(unsigned char* qg, int nk, int tid,
                                               int* flag, float* unscale) {
    const int r = tid >> 2, part = tid & 3;
    // this thread's 32 B of the query's row in each block: 2 uint4s
    uint4* row = reinterpret_cast<uint4*>(qg + r * 128 + part * 32);
    constexpr int STEP = QBLOCK_BYTES / 16;  // uint4s from one block to the next
    uint32_t m = 0;  // largest magnitude as bf16 bits
    for (int c = 0; c < nk; ++c)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const uint4 x = row[c * STEP + h];
            const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
            for (int k = 0; k < 4; ++k) m = bf16x2_absmax(m, w[k]);
        }
    m = max(m, __shfl_xor_sync(0xffffffffu, m, 1));
    m = max(m, __shfl_xor_sync(0xffffffffu, m, 2));
    const F16Scale sc = f16_scale(m);
    bool ok = sc.ok;
    const float up = sc.up, down = sc.down;
    const auto to_f16 = [&](uint32_t pair) { return bf16x2_to_f16(pair, up, down, ok); };
    for (int c = 0; c < nk && ok; ++c)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const uint4 x = row[c * STEP + h];
            to_f16(x.x); to_f16(x.y); to_f16(x.z); to_f16(x.w);
        }
    if (!ok) *flag = 0;
    asm volatile("bar.sync 1, 256;" ::: "memory");
    if (!*(volatile int*)flag) return false;
    for (int c = 0; c < nk; ++c)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const uint4 x = row[c * STEP + h];
            row[c * STEP + h] = make_uint4(to_f16(x.x), to_f16(x.y), to_f16(x.z), to_f16(x.w));
        }
    if (part == 0) unscale[r] = down;
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("bar.sync 1, 256;" ::: "memory");
    return true;
}

// ---------------------------------------------------------------------------
// the scan
// ---------------------------------------------------------------------------

struct ScanArgs {
    const int* surv;     // [n_bins] live bins, ascending
    const int* n_surv;   // [1]
    const float* side[4];  // per-row side arrays [n_pad] (NSIDE of them)
    float* out;          // [n_bins, b]
    int d, b, n_qb, stages;
    int resident;        // streamed plans: query k-blocks kept resident (split: R; else 0)
};

// bf16 pair of two floats, round to nearest even, lo in the low half
__device__ __forceinline__ uint32_t bf16x2_of(float lo, float hi) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&h);
}

// the high and low bf16 planes of a pair of floats, JAX's astype
// roundings: hi = bf16_rn(x), lo = bf16_rn(x - hi), the difference exact
// in f32 (__fsub_rn, never contracted; no flush of a subnormal lo); an inf
// or NaN x gives a NaN lo, as there
__device__ __forceinline__ void split_bf16x2(float x, float y, uint32_t& hi, uint32_t& lo) {
    hi = bf16x2_of(x, y);
    lo = bf16x2_of(__fsub_rn(x, __uint_as_float(hi << 16)),
                   __fsub_rn(y, __uint_as_float(hi & 0xffff0000u)));
}

// Key: a per-thread object made by make_key(q0, cols), cols the query
// column (in the block) of each of the thread's 16 query slots, with
//   void prep(float (&side)[NSIDE]) const    (once per row, on its side data)
//   float operator()(float dot, const float (&side)[NSIDE], int slot) const
// (slot 0..15 compile-time after unrolling), or with no side data (NSIDE =
// 0) only float operator()(float dot, int slot) const. KS: 64-deep
// k-blocks per ring stage, TM rows per stage (each warpgroup takes a TM-row
// sub-tile of its own: TM / 64 m-blocks); STREAM: the query k-blocks ride
// in the stages; NQ: query planes (2: qh and ql), each k-block's products
// summed apart and added to the running sum with __fadd_rn; NV: row planes
// (2: vh and vl, with NQ = 2: the three products vh.qh + vl.qh + vh.ql of
// bf16x3) over bf16 rows read from two arrays (vmap2 the map of the low
// plane; over f32 rows, scan_pair); QT: the query element type
// (bf16; int8, K2: int8 rows, A by descriptor, wgmma m64n64k32 s8 x s8 into
// exact s32 sums, each converted to f32 with __int2float_rn before the key;
// f32, K3: the FFMA consumers, exact f32 dots on the CUDA cores). Under
// the FFMA consumers a key may also have
//   void store(size_t row, int q, const float (&dots)[8]) const
// which receives each row's raw dots with queries q + 8 j before the key
// (the probe k_mm); the other keys have none and pay nothing.
template <typename K, typename = void>
struct stores_dots : std::false_type {};
template <typename K>
struct stores_dots<K, std::void_t<decltype(&K::store)>> : std::true_type {};

template <typename RowT, int NSIDE, int KS, int TM, bool STREAM, int NQ = 1, int NV = 1,
          typename QT = __nv_bfloat16, typename MakeKey>
__device__ __forceinline__ void scan(const CUtensorMap* qmap, const CUtensorMap* vmap,
                                     const ScanArgs& a, const MakeKey& make_key,
                                     const CUtensorMap* vmap2 = nullptr) {
    constexpr bool INT8 = sizeof(RowT) == 1;
    constexpr bool F32 = sizeof(RowT) == 4;
    constexpr bool S8 = sizeof(QT) == 1;    // K2: int8 x int8 into s32
    constexpr bool FFMA = sizeof(QT) == 4;  // K3: f32 queries, FFMA consumers
    static_assert(!S8 || (INT8 && NQ == 1), "int8 queries: int8 rows, one query plane");
    static_assert(!FFMA || (STREAM && NQ == 1 && NV == 1 && TM == ffma_rows<RowT>() && KS == 1
                            && !INT8),
                  "f32 queries: f32 or bf16 rows, streamed, one plane, ffma_rows-row stages");
    static_assert(NV == 1 || (NV == 2 && NQ == 2 && sizeof(RowT) == 2),
                  "two row planes: bf16x3 over two bf16 row arrays, with two query planes");
    static_assert(NQ == 1 || (NQ == 2 && sizeof(RowT) == 2),
                  "two query planes: bf16 rows (bf16x3 over f32 rows is scan_pair)");
    constexpr int KD = stage_depth<RowT, QT>();   // depth of a k-block
    constexpr int QBLK = QB * KD * (int)sizeof(QT);  // one query k-block of one plane
    constexpr int QH = QBLK / (QB * 128);         // its 128-byte boxes (f32: 32 deep each)
    constexpr int TILE = tile_bytes<RowT, TM, QT>();  // one [TM x KD] k-block of one array
    constexpr int RTILE = NV * TILE;  // of every row plane
    constexpr int MB = TM / 64;                   // m-blocks of a warpgroup
    constexpr int STAGE = stage_bytes<RowT, KS, TM, STREAM, NQ, NV, QT>();
    constexpr int QSTEP = NQ * QBLK;              // one k-block of every query plane
    extern __shared__ unsigned char smem_raw[];
    const uint32_t raw = smem_u32(smem_raw);
    const uint32_t base = (raw + 1023u) & ~1023u;
    unsigned char* gbase = smem_raw + (base - raw);
    const int nk = (a.d + KD - 1) / KD;   // KD-deep k-blocks
    const int nks = (nk + KS - 1) / KS;   // ring stages per TM-row sub-tile
    const int S = a.stages;
    // the query k-blocks resident (all, or the split plan's head); the
    // stages carry those of depth steps >= R
    const int R = STREAM ? a.resident : nk;
    const uint32_t q_s = base;            // the resident query blocks
    const uint32_t tiles = q_s + R * QSTEP;
    const uint32_t red = tiles + S * STAGE;
    const uint32_t bars = red + RED_BYTES;  // full[S], empty[S], qbar
    int* red_g = reinterpret_cast<int*>(gbase + (red - base));
    float* unscale_g = reinterpret_cast<float*>(red_g + QB);
    int* f16_flag = reinterpret_cast<int*>(unscale_g + QB);
    const unsigned char* tile_g = gbase + (tiles - base);

    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int qblk = blockIdx.x % a.n_qb;
    const int p0 = blockIdx.x / a.n_qb;
    const int P = gridDim.x / a.n_qb;
    const int n_surv = *a.n_surv;

    if (tid < QB) red_g[tid] = ordered(-INFINITY);
    if (tid == 0) {
        *f16_flag = 1;
        for (int s = 0; s < S; ++s) {
            mbar_init(bars + 8 * s, 1);
            // one warp of its warpgroup (wgmma), or each of its 128 threads
            // (FFMA: every thread reads the stage on its own)
            mbar_init(bars + 8 * (S + s), FFMA ? 128 : 1);
        }
        mbar_init(bars + 16 * S, 1);
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();

    if (warp >= 8) {
        // ---- producer warpgroup: one thread issues every copy ----
        asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
        if (tid == CONSUMERS) {
            // plane p of query block qblk: rows p * n_qb * 64 + 64 qblk
            const int qrow = qblk * QB, qplane = a.n_qb * QB;
            if (R > 0) {
                const uint32_t qbar = bars + 16 * S;
                mbar_expect_tx(qbar, R * QSTEP);
                for (int c = 0; c < R; ++c)
                    for (int pl = 0; pl < NQ; ++pl)
                        tma_load_2d(q_s + c * QSTEP + pl * QBLK, qmap, qbar, c * KD,
                                    qrow + pl * qplane);
            }
            int st = 0;
            uint32_t ph = 0;  // ring position and the parity of its use
            for (int slot = p0; slot < n_surv; slot += P) {
                const int bin = a.surv[slot];
                // stage order: for each pair of sub-tiles and depth step,
                // warpgroup 0's sub-tile, then warpgroup 1's
                for (int sp = 0; sp < BIN / TM / 2; ++sp)
                for (int ks = 0; ks < nks; ++ks)
                    for (int w = 0; w < 2; ++w) {
                        const int row0 = bin * BIN + (2 * sp + w) * TM;
                        const uint32_t full = bars + 8 * st;
                        const uint32_t dst = tiles + st * STAGE;
                        const int nkb = min(KS, nk - ks * KS);
                        // the step's query k-blocks past the resident head
                        const int nkq = STREAM ? min(nkb, max(0, ks * KS + nkb - R)) : 0;
                        mbar_wait(bars + 8 * (S + st), ph ^ 1);
                        mbar_expect_tx(full, nkb * RTILE + nkq * QSTEP);
                        for (int kb = 0; kb < nkb; ++kb) {
                            const int k0 = (ks * KS + kb) * KD;
                            if constexpr (F32 && !FFMA) {
                                // two swizzled half boxes of 32 deep
                                tma_load_2d(dst + kb * RTILE, vmap, full, k0, row0);
                                tma_load_2d(dst + kb * RTILE + TM * 128, vmap, full, k0 + 32,
                                            row0);
                            } else {
                                tma_load_2d(dst + kb * RTILE, vmap, full, k0, row0);
                                if constexpr (RTILE == 2 * TILE)  // the low row plane
                                    tma_load_2d(dst + kb * RTILE + TILE, vmap2, full, k0, row0);
                            }
                            if (STREAM && ks * KS + kb >= R)
                                for (int pl = 0; pl < NQ; ++pl)
                                    for (int h = 0; h < QH; ++h)
                                        tma_load_2d(dst + KS * RTILE + kb * QSTEP + pl * QBLK
                                                        + h * QB * 128,
                                                    qmap, full, k0 + h * (128 / (int)sizeof(QT)),
                                                    qrow + pl * qplane);
                        }
                        if (++st == S) { st = 0; ph ^= 1; }
                    }
            }
        }
        return;
    }

    // ---- two consumer warpgroups ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int wg = warp >> 2, wq = warp & 3;
    if constexpr (FFMA) {
        // K3 and the probes k_mm / k_mm_bins: exact f32 dots, one IEEE FMA
        // per term in depth order. Warpgroup wg takes the TM-row sub-tiles
        // wg, wg + 2, ... of every bin; its thread (rg, qg) keeps an RI-row x
        // 8-query register tile, rows rg + 16 i and queries qg + 8 j (rg =
        // lane % 8 + 8 (wq % 2), qg = lane / 8 + 4 (wq / 2); RI = TM / 16:
        // 16 over f32 rows, 8 over bf16 rows). A quarter-warp's 8 lanes read
        // 8 rows whose (row % 8) differ, so under the 128-byte swizzle (chunk
        // c of row r at c ^ (r % 8)) they touch 8 distinct 16-byte bank
        // groups, and one query (a broadcast); both operands stay
        // K-contiguous as TMA lands them. The chunk loops stay rolled (K3's
        // unrolled ones measured slower, PERF.md).
        constexpr int RI = TM / 16;  // rows of a thread's tile
        const int rg = (lane & 7) + 8 * (wq & 1);
        const int qg = (lane >> 3) + 4 * (wq >> 1);
        const int sr = rg & 7;  // the swizzle of each of the thread's rows
        int cols[16];
#pragma unroll
        for (int j = 0; j < 16; ++j) cols[j] = qg + 8 * (j & 7);  // slots 8..15 unused
        const auto key = make_key(qblk * QB, cols);
        int st = 0;
        uint32_t ph = 0;
        const auto advance = [&]() { if (++st == S) { st = 0; ph ^= 1; } };
        if (wg == 1) advance();  // the ring alternates between the warpgroups
        for (int slot = p0; slot < n_surv; slot += P) {
            const int bin = a.surv[slot];
            float best[8];
#pragma unroll
            for (int j = 0; j < 8; ++j) best[j] = -INFINITY;
            for (int sp = 0; sp < BIN / TM / 2; ++sp) {
                const size_t row = (size_t)bin * BIN + (2 * sp + wg) * TM + rg;
                float acc[RI][8];
#pragma unroll
                for (int i = 0; i < RI; ++i)
#pragma unroll
                    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
                for (int ks = 0; ks < nks; ++ks) {
                    mbar_wait(bars + 8 * st, ph);
                    const unsigned char* rt = tile_g + st * STAGE + rg * 128;
                    const unsigned char* qt = tile_g + st * STAGE + RTILE + qg * 128;
                    if constexpr (F32) {
                        // 8 chunks of 4 deep: the queries' chunk c, then the
                        // rows' chunk c streamed, one 16-byte load a row
#pragma unroll 1
                        for (int c = 0; c < 8; ++c) {
                            const unsigned char* rp = rt + ((c ^ sr) << 4);
                            const unsigned char* qp = qt + ((c ^ qg) << 4);
                            float4 q[8];
#pragma unroll
                            for (int j = 0; j < 8; ++j)
                                q[j] = *reinterpret_cast<const float4*>(qp + j * 8 * 128);
#pragma unroll
                            for (int i = 0; i < RI; ++i) {
                                const float4 v = *reinterpret_cast<const float4*>(rp + i * 16 * 128);
#pragma unroll
                                for (int j = 0; j < 8; ++j) {
                                    acc[i][j] = __fmaf_rn(v.x, q[j].x, acc[i][j]);
                                    acc[i][j] = __fmaf_rn(v.y, q[j].y, acc[i][j]);
                                    acc[i][j] = __fmaf_rn(v.z, q[j].z, acc[i][j]);
                                    acc[i][j] = __fmaf_rn(v.w, q[j].w, acc[i][j]);
                                }
                            }
                        }
                    } else {
                        // 8 chunks of 8 bf16, each loaded once and widened
                        // exactly in two halves of 4 deep; depths 8c + 4e
                        // .. 8c + 4e + 3 are the queries' f32 chunk 2c + e
#pragma unroll 1
                        for (int c = 0; c < 8; ++c) {
                            const unsigned char* rp = rt + ((c ^ sr) << 4);
                            uint4 w[RI];
#pragma unroll
                            for (int i = 0; i < RI; ++i)
                                w[i] = *reinterpret_cast<const uint4*>(rp + i * 16 * 128);
#pragma unroll
                            for (int e = 0; e < 2; ++e) {
                                float v[RI][4];
#pragma unroll
                                for (int i = 0; i < RI; ++i) {
                                    const uint32_t lo = e ? w[i].z : w[i].x;
                                    const uint32_t hi = e ? w[i].w : w[i].y;
                                    v[i][0] = __uint_as_float(lo << 16);
                                    v[i][1] = __uint_as_float(lo & 0xffff0000u);
                                    v[i][2] = __uint_as_float(hi << 16);
                                    v[i][3] = __uint_as_float(hi & 0xffff0000u);
                                }
                                const unsigned char* qp = qt + (c >> 2) * (QB * 128)
                                                        + ((((2 * c + e) & 7) ^ qg) << 4);
#pragma unroll
                                for (int j = 0; j < 8; ++j) {
                                    const float4 q =
                                        *reinterpret_cast<const float4*>(qp + j * 8 * 128);
#pragma unroll
                                    for (int i = 0; i < RI; ++i) {
                                        acc[i][j] = __fmaf_rn(v[i][0], q.x, acc[i][j]);
                                        acc[i][j] = __fmaf_rn(v[i][1], q.y, acc[i][j]);
                                        acc[i][j] = __fmaf_rn(v[i][2], q.z, acc[i][j]);
                                        acc[i][j] = __fmaf_rn(v[i][3], q.w, acc[i][j]);
                                    }
                                }
                            }
                        }
                    }
                    // release the stage: each thread's reads of it are done
                    // (the arrive orders them before the producer's reuse)
                    mbar_arrive(bars + 8 * (S + st));
                    advance();
                    advance();
                }
                // the rows' side data, read once the products are done (it
                // would hold RI NSIDE registers across them)
#pragma unroll
                for (int i = 0; i < RI; ++i) {
                    float sv[NSIDE > 0 ? NSIDE : 1];
#pragma unroll
                    for (int s = 0; s < NSIDE; ++s) sv[s] = __ldg(a.side[s] + row + 16 * i);
                    if constexpr (stores_dots<std::decay_t<decltype(key)>>::value)
                        key.store(row + 16 * i, qblk * QB + qg, acc[i]);
                    if constexpr (NSIDE > 0) key.prep(sv);
#pragma unroll
                    for (int j = 0; j < 8; ++j) {
                        if constexpr (NSIDE > 0)
                            best[j] = fmaxf(best[j], key(acc[i][j], sv, j));
                        else
                            best[j] = fmaxf(best[j], key(acc[i][j], j));
                    }
                }
            }
            // the 8 lanes of a quarter-warp hold the same queries
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                best[j] = fmaxf(best[j], __shfl_xor_sync(0xffffffffu, best[j], 1));
                best[j] = fmaxf(best[j], __shfl_xor_sync(0xffffffffu, best[j], 2));
                best[j] = fmaxf(best[j], __shfl_xor_sync(0xffffffffu, best[j], 4));
            }
            if ((lane & 7) == 0) {
#pragma unroll
                for (int j = 0; j < 8; ++j) atomicMax(red_g + cols[j], ordered(best[j]));
            }
            asm volatile("bar.sync 1, 256;" ::: "memory");
            if (tid < QB) {
                const int q = qblk * QB + tid;
                if (q < a.b) a.out[(size_t)bin * a.b + q] = unordered(red_g[tid]);
                red_g[tid] = ordered(-INFINITY);
            }
            asm volatile("bar.sync 1, 256;" ::: "memory");  // reset before the next bin's maxima
        }
    } else {
        // warpgroup w takes the TM-row sub-tiles w, w + 2, ... of every bin: in
        // m-block mb (rows 64 mb ..) warp wq holds rows 64 mb + 16 wq + g and
        // + 8. The two warpgroups work on different ring stages, so one
        // converts, waits and releases while the other's products run.
        const int g = lane >> 2, t = lane & 3;
        const int r0 = wq * 16 + g;
        // query slot j (0..15) of this thread: column 8 (j / 2) + 2 t + j % 2
        int cols[16];
#pragma unroll
        for (int j = 0; j < 16; ++j) cols[j] = 8 * (j >> 1) + 2 * t + (j & 1);
        const auto key = make_key(qblk * QB, cols);
        bool f16 = false;
        if (R > 0) mbar_wait(bars + 16 * S, 0);
        if constexpr (!STREAM && INT8 && !S8)
            f16 = queries_to_f16(gbase, nk, tid, f16_flag, unscale_g);

        // the bin walk, with f16 (int8 rows only) or bf16 products
        const auto walk = [&](auto f16_tag) {
            constexpr bool F16 = decltype(f16_tag)::value;
            float qmul[16];  // 2^-s of each query slot (f16 products)
            if constexpr (F16) {
#pragma unroll
                for (int j = 0; j < 16; ++j) qmul[j] = unscale_g[cols[j]];
            }
            int st = 0;
            uint32_t ph = 0;
            const auto advance = [&]() { if (++st == S) { st = 0; ph ^= 1; } };
            if (wg == 1) advance();  // the ring alternates between the warpgroups
            // B of plane pl of k-block kb of depth step ks: resident (below
            // R), or in the stage
            const auto qdesc = [&](int ks, int kb, int kk, int pl = 0) {
                const int k = ks * KS + kb;
                const uint32_t off = pl * QBLK + kk * 32;
                return desc_sw128(STREAM && k >= R
                                      ? tiles + st * STAGE + KS * RTILE + kb * QSTEP + off
                                      : q_s + k * QSTEP + off);
            };
            for (int slot = p0; slot < n_surv; slot += P) {
                const int bin = a.surv[slot];
                float best[16];
#pragma unroll
                for (int j = 0; j < 16; ++j) best[j] = -INFINITY;
                for (int sp = 0; sp < BIN / TM / 2; ++sp) {
                    // the rows' side data, read now and first used after the
                    // sub-tile's products
                    const size_t row = (size_t)bin * BIN + (2 * sp + wg) * TM + r0;
                    float sv[MB][2][NSIDE > 0 ? NSIDE : 1];
#pragma unroll
                    for (int mb = 0; mb < MB; ++mb)
#pragma unroll
                        for (int j = 0; j < NSIDE; ++j) {
                            sv[mb][0][j] = __ldg(a.side[j] + row + 64 * mb);
                            sv[mb][1][j] = __ldg(a.side[j] + row + 64 * mb + 8);
                        }
                    // exact s32 sums of int8 products (K2), else f32
                    std::conditional_t<S8, int, float> d[MB][32];
                    [[maybe_unused]] float pd[NQ == 2 ? MB : 1][32];  // a k-block's partial (NQ = 2)
#pragma unroll
                    for (int mb = 0; mb < MB; ++mb)
#pragma unroll
                        for (int i = 0; i < 32; ++i) d[mb][i] = 0;
                    if constexpr (NQ == 2) {
#pragma unroll
                        for (int mb = 0; mb < MB; ++mb)
#pragma unroll
                            for (int i = 0; i < 32; ++i) pd[mb][i] = 0.f;
                    }
                    // the sub-tile's ring stages, each waited for, multiplied to
                    // completion and released: the other warpgroup's products
                    // keep the tensor cores busy meanwhile
                    for (int ks = 0; ks < nks; ++ks) {
                        const int nkb = min(KS, nk - ks * KS);
                        mbar_wait(bars + 8 * st, ph);
                        // A from registers (int8 rows with bf16 queries, f32
                        // rows): a0 (row g, depth
                        // 2t..2t+1), a1 (row g + 8), a2 (row g, depth 2t + 8..),
                        // a3 (row g + 8, depth 2t + 8..) of each 16-deep step kk
                        [[maybe_unused]] uint32_t af[KS][MB][4][4];
                        if constexpr ((INT8 && !S8) || F32) {
#pragma unroll
                            for (int kb = 0; kb < KS; ++kb) {
                                if (kb < nkb) {
#pragma unroll
                                    for (int mb = 0; mb < MB; ++mb) {
                                        const unsigned char* tk = tile_g + st * STAGE + kb * RTILE;
                                        const int r = 64 * mb + r0;
                                        if constexpr (INT8) {
                                            const unsigned char* tg = tk + r * TK + 16 * t;
                                            const uint4 x0 = *reinterpret_cast<const uint4*>(tg);
                                            const uint4 x1 = *reinterpret_cast<const uint4*>(tg + 8 * TK);
                                            const uint32_t w0[4] = {x0.x, x0.y, x0.z, x0.w};
                                            const uint32_t w1[4] = {x1.x, x1.y, x1.z, x1.w};
#pragma unroll
                                            for (int kk = 0; kk < 4; ++kk) {
                                                af[kb][mb][kk][0] = s8x2_convert<F16>(w0[kk], 0, 1);
                                                af[kb][mb][kk][1] = s8x2_convert<F16>(w1[kk], 0, 1);
                                                af[kb][mb][kk][2] = s8x2_convert<F16>(w0[kk], 2, 3);
                                                af[kb][mb][kk][3] = s8x2_convert<F16>(w1[kk], 2, 3);
                                            }
                                        } else {
                                            // step kk: chunk 2t + kk % 2 of half kk / 2, at
                                            // physical chunk c ^ (row % 8) (rows r, r + 8
                                            // share it); half h at h * TM * 128
#pragma unroll
                                            for (int kk = 0; kk < 4; ++kk) {
                                                const int c = (2 * t + (kk & 1)) ^ (r & 7);
                                                const unsigned char* tg =
                                                    tk + (kk >> 1) * TM * 128 + r * 128 + c * 16;
                                                const float4 x0 = *reinterpret_cast<const float4*>(tg);
                                                const float4 x1 =
                                                    *reinterpret_cast<const float4*>(tg + 8 * 128);
                                                af[kb][mb][kk][0] = bf16x2_of(x0.x, x0.y);
                                                af[kb][mb][kk][1] = bf16x2_of(x1.x, x1.y);
                                                af[kb][mb][kk][2] = bf16x2_of(x0.z, x0.w);
                                                af[kb][mb][kk][3] = bf16x2_of(x1.z, x1.w);
                                            }
                                        }
                                    }
                                }
                            }
                        }
                        if constexpr (NV == 2) {
                            // bf16x3 over two bf16 row arrays: each
                            // k-block's three products vh.qh, vl.qh, vh.ql
                            // per 16-deep step into the partial (its first
                            // product overwrites it), completed, then added
                            // to the running sum in IEEE f32
#pragma unroll
                            for (int kb = 0; kb < KS; ++kb)
                                if (kb < nkb) {
#pragma unroll
                                    for (int mb = 0; mb < MB; ++mb) fence_acc(pd[mb]);
                                    wgmma_fence();
#pragma unroll
                                    for (int kk = 0; kk < 4; ++kk) {
                                        const uint64_t qh = qdesc(ks, kb, kk, 0);
                                        const uint64_t ql = qdesc(ks, kb, kk, 1);
#pragma unroll
                                        for (int mb = 0; mb < MB; ++mb) {
                                            const uint32_t ah = tiles + st * STAGE + kb * RTILE
                                                              + mb * 64 * 128 + kk * 32;
                                            wgmma_ss(pd[mb], desc_sw128(ah), qh, kk > 0);
                                            wgmma_ss(pd[mb], desc_sw128(ah + TILE), qh);
                                            wgmma_ss(pd[mb], desc_sw128(ah), ql);
                                        }
                                    }
                                    wgmma_commit();
                                    wgmma_wait<0>();
#pragma unroll
                                    for (int mb = 0; mb < MB; ++mb) {
                                        fence_acc(pd[mb]);
#pragma unroll
                                        for (int i = 0; i < 32; ++i)
                                            d[mb][i] = __fadd_rn(d[mb][i], pd[mb][i]);
                                    }
                                }
                        } else if constexpr ((INT8 && !S8) || F32) {
#pragma unroll
                            for (int mb = 0; mb < MB; ++mb) fence_acc(d[mb]);
                            wgmma_fence();
#pragma unroll
                            for (int kb = 0; kb < KS; ++kb)
                                if (kb < nkb)
#pragma unroll
                                    for (int kk = 0; kk < 4; ++kk) {
                                        const uint64_t db = qdesc(ks, kb, kk);
#pragma unroll
                                        for (int mb = 0; mb < MB; ++mb)
                                            wgmma_rs<F16>(d[mb], af[kb][mb][kk][0], af[kb][mb][kk][1],
                                                          af[kb][mb][kk][2], af[kb][mb][kk][3], db);
                                    }
                        } else if constexpr (NQ == 1) {
                            // A by descriptor: bf16 rows (k16 steps) or int8
                            // rows with int8 queries (k32 steps, s32 sums); 4
                            // steps of 32 B a k-block either way
#pragma unroll
                            for (int mb = 0; mb < MB; ++mb) fence_acc(d[mb]);
                            wgmma_fence();
#pragma unroll
                            for (int kb = 0; kb < KS; ++kb)
                                if (kb < nkb)
#pragma unroll
                                    for (int kk = 0; kk < 4; ++kk) {
                                        const uint64_t db = qdesc(ks, kb, kk);
#pragma unroll
                                        for (int mb = 0; mb < MB; ++mb)
                                            wgmma_ss(d[mb],
                                                     desc_sw128(tiles + st * STAGE + kb * TILE
                                                                + mb * 64 * 128 + kk * 32),
                                                     db);
                                    }
                        } else {
                            // two query planes over bf16 rows (vl = 0): each
                            // k-block's qh and ql products into the partial (its
                            // first product overwrites it), completed, then added
                            // to the running sum in IEEE f32
#pragma unroll
                            for (int kb = 0; kb < KS; ++kb)
                                if (kb < nkb) {
#pragma unroll
                                    for (int mb = 0; mb < MB; ++mb) fence_acc(pd[mb]);
                                    wgmma_fence();
#pragma unroll
                                    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
                                        for (int pl = 0; pl < 2; ++pl) {
                                            const uint64_t db = qdesc(ks, kb, kk, pl);
#pragma unroll
                                            for (int mb = 0; mb < MB; ++mb)
                                                wgmma_ss(pd[mb],
                                                         desc_sw128(tiles + st * STAGE + kb * TILE
                                                                    + mb * 64 * 128 + kk * 32),
                                                         db, kk + pl > 0);
                                        }
                                    wgmma_commit();
                                    wgmma_wait<0>();
#pragma unroll
                                    for (int mb = 0; mb < MB; ++mb) {
                                        fence_acc(pd[mb]);
#pragma unroll
                                        for (int i = 0; i < 32; ++i)
                                            d[mb][i] = __fadd_rn(d[mb][i], pd[mb][i]);
                                    }
                                }
                        }
                        if constexpr (NQ == 1) {
                            wgmma_commit();
                            wgmma_wait<0>();
#pragma unroll
                            for (int mb = 0; mb < MB; ++mb) fence_acc(d[mb]);
                        }
                        // release the stage: the warpgroup's products on it are
                        // complete (wgmma.wait_group is warpgroup-wide), so one
                        // of its warps speaks for it
                        if (wq == (st & 3) && lane == 0) mbar_arrive(bars + 8 * (S + st));
                        advance();
                        advance();
                    }
                    // accumulator element i of m-block mb: row 64 mb + r0 + 8
                    // ((i >> 1) & 1), query slot 2 (i >> 2) + (i & 1)
#pragma unroll
                    for (int mb = 0; mb < MB; ++mb) {
                        if constexpr (NSIDE > 0) {
                            key.prep(sv[mb][0]);
                            key.prep(sv[mb][1]);
                        }
#pragma unroll
                        for (int i = 0; i < 32; ++i) {
                            const int j = 2 * (i >> 2) + (i & 1);
                            float dot;
                            if constexpr (S8)
                                dot = __int2float_rn(d[mb][i]);  // JAX's astype: nearest even
                            else
                                dot = F16 ? d[mb][i] * qmul[j] : d[mb][i];
                            if constexpr (NSIDE > 0)
                                best[j] = fmaxf(best[j], key(dot, sv[mb][(i >> 1) & 1], j));
                            else
                                best[j] = fmaxf(best[j], key(dot, j));
                        }
                    }
                }
#pragma unroll
                for (int j = 0; j < 16; ++j) {
                    best[j] = fmaxf(best[j], __shfl_xor_sync(0xffffffffu, best[j], 4));
                    best[j] = fmaxf(best[j], __shfl_xor_sync(0xffffffffu, best[j], 8));
                    best[j] = fmaxf(best[j], __shfl_xor_sync(0xffffffffu, best[j], 16));
                }
                if (lane < 4) {
#pragma unroll
                    for (int j = 0; j < 16; ++j) atomicMax(red_g + cols[j], ordered(best[j]));
                }
                asm volatile("bar.sync 1, 256;" ::: "memory");
                if (tid < QB) {
                    const int q = qblk * QB + tid;
                    if (q < a.b) a.out[(size_t)bin * a.b + q] = unordered(red_g[tid]);
                    red_g[tid] = ordered(-INFINITY);
                }
                asm volatile("bar.sync 1, 256;" ::: "memory");  // reset before the next bin's maxima
            }
        };
        if (f16) walk(std::true_type{});
        else walk(std::false_type{});
    }
}

// x as a value the compiler cannot see through: the key's loads of the
// per-query data stay in the epilogue instead of being hoisted out of the
// bin walk into registers that would live across the products
__device__ __forceinline__ int opaque(int x) {
    asm volatile("" : "+r"(x));
    return x;
}

// m[0 : 2N) -> m[0 : N): lanes with bit s set keep the upper half, the
// others the lower, each the max of its own and the partner's (lane ^ s)
template <int N>
__device__ __forceinline__ void max_scatter(float (&m)[32], int lane, int s) {
    const bool up = lane & s;
#pragma unroll
    for (int k = 0; k < N; ++k) {
        const float send = up ? m[k] : m[k + N];
        const float keep = up ? m[k + N] : m[k];
        m[k] = fmaxf(keep, __shfl_xor_sync(0xffffffffu, send, s));
    }
}

// A pair plan's producer (one thread): for each of the CTA's survivor
// slots p0, p0 + P, ..., each TM-row sub-tile of its bin and each of its
// nk k-blocks, it waits until the next of the S stages (STAGE bytes from
// tiles) is free and has fill(dst, full, row0, k0, kb) load it (rows from
// row0, depth from k0 = 64 kb), to arrive on the stage's full barrier.
template <int TM, int STAGE, typename Fill>
__device__ __forceinline__ void pair_produce(const ScanArgs& a, int nk, int S, uint32_t tiles,
                                             uint32_t bars, int p0, int P, int n_surv,
                                             const Fill& fill) {
    int st = 0;
    uint32_t ph = 0;
    for (int slot = p0; slot < n_surv; slot += P) {
        const int bin = a.surv[slot];
        for (int sp = 0; sp < BIN / TM; ++sp)
            for (int kb = 0; kb < nk; ++kb) {
                const int row0 = bin * BIN + sp * TM, k0 = kb * TK;
                const uint32_t full = bars + 8 * st;
                const uint32_t dst = tiles + st * STAGE;
                mbar_wait(bars + 8 * (S + st), ph ^ 1);
                fill(dst, full, row0, k0, kb);
                if (++st == S) { st = 0; ph ^= 1; }
            }
    }
}

// The key of a pair plan's sub-tile (scan_pair, scan_pair_s8): the
// thread's sums of MB m-blocks (acc(mb, i): element i of m-block mb as
// wgmma_rs_n128 lays it out, rows r + 64 mb and r + 64 mb + 8), times 2^-s
// where F16 (unscale, per query), keyed by make_key's key of each half of
// the pair with the side data side(mb, 0) and side(mb, 1) of those rows,
// the max over the rows into the thread's 32 query slots; a shuffle
// reduce-scatter over the 8 lanes that share them then leaves each lane
// the max of slots 4 g .. 4 g + 3, folded into best.
template <int NSIDE, int MB, bool F16, typename MakeKey, typename Acc, typename Side>
__device__ __forceinline__ void pair_key(const MakeKey& make_key, int pair, int lane,
                                         const float* __restrict__ unscale, const Acc& acc,
                                         const Side& side, float (&best)[4]) {
    const int t = lane & 3;
    // accumulator element i of the pair's slot j (0..31): 4 (j / 2) + j % 2
    // for row r, + 2 for r + 8
    float m[32];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        // slot j (0..15) of the half: its column 8 (j / 2) + 2 t + j % 2
        int cols[16];
#pragma unroll
        for (int j = 0; j < 16; ++j) cols[j] = 8 * (j >> 1) + 2 * t + (j & 1);
        const int q0 = opaque(pair * PAIR_Q + h * QB);
        const auto key = make_key(q0, cols);
        float qmul[16];  // 2^-s of each slot (f16 products)
        if constexpr (F16) {
#pragma unroll
            for (int j = 0; j < 16; ++j) qmul[j] = __ldg(unscale + q0 + cols[j]);
        }
#pragma unroll
        for (int mb = 0; mb < MB; ++mb) {
            if constexpr (NSIDE > 0) {
                key.prep(side(mb, 0));
                key.prep(side(mb, 1));
            }
#pragma unroll
            for (int j = 0; j < 16; ++j) {
                const int i = 4 * ((16 * h + j) >> 1) + (j & 1);
                float d0 = acc(mb, i), d1 = acc(mb, i + 2);
                if constexpr (F16) {
                    d0 = d0 * qmul[j];
                    d1 = d1 * qmul[j];
                }
                float k2;
                if constexpr (NSIDE > 0)
                    k2 = fmaxf(key(d0, side(mb, 0), j), key(d1, side(mb, 1), j));
                else
                    k2 = fmaxf(key(d0, j), key(d1, j));
                m[16 * h + j] = mb == 0 ? k2 : fmaxf(m[16 * h + j], k2);
            }
        }
    }
    // over the 8 lanes of the same t (lane bits 4, 3, 2 = g): each keeps
    // the max of slots 4 g .. 4 g + 3
    max_scatter<16>(m, lane, 16);
    max_scatter<8>(m, lane, 8);
    max_scatter<4>(m, lane, 4);
#pragma unroll
    for (int k = 0; k < 4; ++k) best[k] = fmaxf(best[k], m[k]);
}

// A pair plan's bin write-out: each lane's maxima of its slots 4 g ..
// 4 g + 3 into the CTA's per-query maxima (shared atomicMax), then the
// bin's row of out for the pair's real queries, and the maxima reset to
// -inf for the next bin.
__device__ __forceinline__ void pair_write_bin(const float (&best)[4], int* red_g, int lane,
                                               int pair, int bin, const ScanArgs& a) {
    const int tid = threadIdx.x, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        const int j = 4 * g + k;  // the pair's column of slot j
        atomicMax(red_g + 8 * (j >> 1) + 2 * t + (j & 1), ordered(best[k]));
    }
    asm volatile("bar.sync 1, 256;" ::: "memory");
    if (tid < PAIR_Q) {
        const int q = pair * PAIR_Q + tid;
        if (q < a.b) a.out[(size_t)bin * a.b + q] = unordered(red_g[tid]);
        red_g[tid] = ordered(-INFINITY);
    }
    asm volatile("bar.sync 1, 256;" ::: "memory");  // reset before the next bin's maxima
}

// The scan on the pair plan: bf16x3 over f32 rows (K4), a pair of query
// blocks (PAIR_Q queries) a CTA. CTA c holds pair c % n_qp (a.n_qb holds
// n_qp; plane p of pair c at rows p * n_qp * 128 + 128 c of the query
// map) and takes survivor slots p, p + P, ... as scan does. The producer
// fills each stage with a 64-deep k-block of PAIR_ROWS rows and both
// planes' k-blocks of the pair's queries; warpgroup w takes rows 64 w ..
// 64 w + 63 of every stage and multiplies them by all 128 queries: per
// 16-deep step its A fragment is loaded and split once (vh, vl) and feeds
// vh.qh, vl.qh, vh.ql as m64n128k16 products into the k-block's partial
// (the first overwrites it), which is then added to the running sum with
// __fadd_rn, as in scan; the next k-block's fragment is split meanwhile
// into a second buffer. A thread holds one m-block: 64 running and 64
// partial accumulators and 2 x 32 registers of split A. Both warpgroups
// release every stage (the empty barrier counts 2). After each 128-row
// sub-tile the key folds the thread's 2 rows into its 32 query slots, and
// a shuffle reduce-scatter over the 8 lanes that share them leaves each
// lane the running max of 4 queries, written once per bin by shared-memory
// atomicMax as in scan.
template <int NSIDE, typename MakeKey>
__device__ __forceinline__ void scan_pair(const CUtensorMap* qmap, const CUtensorMap* vmap,
                                          const ScanArgs& a, const MakeKey& make_key) {
    constexpr int HALF = PAIR_ROWS * 128;   // one half box: [PAIR_ROWS rows x 32 f32]
    constexpr int RTILE = 2 * HALF;         // the rows' k-block
    constexpr int QPLANE = PAIR_Q * 128;    // one plane's k-block of the pair
    extern __shared__ unsigned char smem_raw[];
    const uint32_t raw = smem_u32(smem_raw);
    const uint32_t tiles = (raw + 1023u) & ~1023u;
    const unsigned char* tile_g = smem_raw + (tiles - raw);
    const int nk = (a.d + TK - 1) / TK;
    const int S = a.stages;
    const uint32_t red = tiles + S * PAIR_STAGE;
    const uint32_t bars = red + PAIR_RED_BYTES;  // full[S], empty[S]
    int* red_g = reinterpret_cast<int*>(smem_raw + (red - raw));

    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int pair = blockIdx.x % a.n_qb;
    const int p0 = blockIdx.x / a.n_qb;
    const int P = gridDim.x / a.n_qb;
    const int n_surv = *a.n_surv;

    if (tid < PAIR_Q) red_g[tid] = ordered(-INFINITY);
    if (tid == 0) {
        for (int s = 0; s < S; ++s) {
            mbar_init(bars + 8 * s, 1);
            mbar_init(bars + 8 * (S + s), 2);  // one warp of each warpgroup
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();

    if (warp >= 8) {
        // ---- producer warpgroup: one thread issues every copy ----
        asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
        if (tid == CONSUMERS) {
            const int qrow = pair * PAIR_Q, qplane = a.n_qb * PAIR_Q;
            pair_produce<PAIR_ROWS, PAIR_STAGE>(
                a, nk, S, tiles, bars, p0, P, n_surv,
                [&](uint32_t dst, uint32_t full, int row0, int k0, int kb) {
                    mbar_expect_tx(full, PAIR_STAGE);
                    tma_load_2d(dst, vmap, full, k0, row0);
                    tma_load_2d(dst + HALF, vmap, full, k0 + 32, row0);
                    for (int pl = 0; pl < 2; ++pl)
                        for (int h = 0; h < 2; ++h)
                            tma_load_2d(dst + RTILE + pl * QPLANE + h * QB * 128, qmap, full,
                                        k0, qrow + pl * qplane + h * QB);
                });
        }
        return;
    }

    // ---- two consumer warpgroups, both on every stage ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int wg = warp >> 2, wq = warp & 3;
    const int g = lane >> 2, t = lane & 3;
    const int r = 64 * wg + 16 * wq + g;  // the thread's rows of a stage: r, r + 8
    int st = 0;
    uint32_t ph = 0;
    // the split A fragments of two k-blocks: buffer B of k-blocks kb with kb % 2 = B
    uint32_t ah[2][4][4], al[2][4][4];
    // load the A fragment of each 16-deep step kk of stage `at` (chunk 2t + kk % 2 of
    // half kk / 2, at physical chunk c ^ (r % 8); rows r and r + 8 share it) and
    // split it into buffer B: vh, vl
    const auto load_split = [&](auto buf, int at) {
        constexpr int B = decltype(buf)::value;
        const unsigned char* tk = tile_g + at * PAIR_STAGE;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
            const int c = (2 * t + (kk & 1)) ^ (r & 7);
            const unsigned char* tg = tk + (kk >> 1) * HALF + r * 128 + c * 16;
            const float4 x0 = *reinterpret_cast<const float4*>(tg);
            const float4 x1 = *reinterpret_cast<const float4*>(tg + 8 * 128);
            split_bf16x2(x0.x, x0.y, ah[B][kk][0], al[B][kk][0]);
            split_bf16x2(x1.x, x1.y, ah[B][kk][1], al[B][kk][1]);
            split_bf16x2(x0.z, x0.w, ah[B][kk][2], al[B][kk][2]);
            split_bf16x2(x1.z, x1.w, ah[B][kk][3], al[B][kk][3]);
        }
    };
    for (int slot = p0; slot < n_surv; slot += P) {
        const int bin = a.surv[slot];
        float best[4];  // the bin max of slots 4 g + k (k = 0..3) of the pair
#pragma unroll
        for (int k = 0; k < 4; ++k) best[k] = -INFINITY;
        for (int sp = 0; sp < BIN / PAIR_ROWS; ++sp) {
            // the rows' side data, read now and first used after the products
            const size_t row = (size_t)bin * BIN + sp * PAIR_ROWS + r;
            float sv[2][NSIDE > 0 ? NSIDE : 1];
#pragma unroll
            for (int j = 0; j < NSIDE; ++j) {
                sv[0][j] = __ldg(a.side[j] + row);
                sv[1][j] = __ldg(a.side[j] + row + 8);
            }
            float d[64], pd[64];
#pragma unroll
            for (int i = 0; i < 64; ++i) d[i] = pd[i] = 0.f;
            // one k-block from buffer B: its three products vh.qh, vl.qh, vh.ql
            // per step into the partial (the first overwrites it); meanwhile the
            // next k-block's stage is waited for and its fragment split into the
            // other buffer; then the products complete, the partial is added in
            // IEEE f32 and the stage released (one warp speaks for the
            // warpgroup: wgmma.wait_group is warpgroup-wide)
            const auto step = [&](auto buf, int kb) {
                constexpr int B = decltype(buf)::value;
                const uint32_t qs = tiles + st * PAIR_STAGE + RTILE;
                fence_acc(pd);
                wgmma_fence();
#pragma unroll
                for (int kk = 0; kk < 4; ++kk) {
                    const uint64_t qh = desc_sw128(qs + kk * 32);
                    const uint64_t ql = desc_sw128(qs + QPLANE + kk * 32);
                    const uint32_t(&h)[4] = ah[B][kk];
                    const uint32_t(&l)[4] = al[B][kk];
                    wgmma_rs_n128(pd, h[0], h[1], h[2], h[3], qh, kk > 0);
                    wgmma_rs_n128(pd, l[0], l[1], l[2], l[3], qh);
                    wgmma_rs_n128(pd, h[0], h[1], h[2], h[3], ql);
                }
                wgmma_commit();
                const int nst = st + 1 == S ? 0 : st + 1;
                if (kb + 1 < nk) {
                    mbar_wait(bars + 8 * nst, nst == 0 ? ph ^ 1 : ph);
                    load_split(std::integral_constant<int, 1 - B>{}, nst);
                }
                wgmma_wait<0>();
                fence_acc(pd);
#pragma unroll
                for (int i = 0; i < 64; ++i) d[i] = __fadd_rn(d[i], pd[i]);
                if (wq == (st & 3) && lane == 0) mbar_arrive(bars + 8 * (S + st));
                if (nst == 0) ph ^= 1;
                st = nst;
            };
            mbar_wait(bars + 8 * st, ph);
            load_split(std::integral_constant<int, 0>{}, st);
            for (int kb = 0; kb < nk; kb += 2) {
                step(std::integral_constant<int, 0>{}, kb);
                if (kb + 1 < nk) step(std::integral_constant<int, 1>{}, kb + 1);
            }
            pair_key<NSIDE, 1, false>(make_key, pair, lane, nullptr,
                                      [&](int, int i) { return d[i]; },
                                      [&](int, int h) -> auto& { return sv[h]; }, best);
        }
        pair_write_bin(best, red_g, lane, pair, bin, a);
    }
}

// The scan on the pair plan over int8 rows with bf16 queries (K1), a pair
// of query blocks (PAIR_Q queries) a CTA, CTA c on pair c % n_qp (a.n_qb
// holds n_qp; pair c at rows 128 c of the query map) and survivor slots p,
// p + P, ... as in scan_pair. The caller has rewritten the queries: where
// f16[pair] is 1 they are f16, each query scaled by 2^s (unscale[q] =
// 2^-s, fused_topk.f16_queries, the rule of queries_to_f16), else bf16.
// The producer loads the first a.resident query k-blocks of the pair once
// (the resident head), then fills each stage with a 64-deep k-block of
// PAIR_S8_ROWS rows and, past the head, the pair's query k-block;
// warpgroup w takes its MB m-blocks of every stage (rows 64 MB w ..) and
// multiplies them by all 128 queries. A group is one m-block's four
// m64n128k16 products of one k-block, A from registers (loaded and
// converted once, f16 or bf16, s8x2_convert), B from the head or the
// stage, straight into running sums that span the whole depth as in scan;
// the next group's fragment is converted into the other of two buffers
// while the current group runs, and only the older group is waited for
// (wait_group 1) before its buffer is reused and, at a k-block's end, the
// stage before is released. Both warpgroups release every stage (the empty
// barrier counts 2). After each sub-tile the sums are unscaled (f16) and
// keyed, and a shuffle reduce-scatter leaves each lane the running max of
// 4 queries, as in scan_pair.
template <int NSIDE, typename MakeKey>
__device__ __forceinline__ void scan_pair_s8(const CUtensorMap* qmap, const CUtensorMap* vmap,
                                             const ScanArgs& a, const MakeKey& make_key,
                                             const float* __restrict__ unscale,
                                             const int* __restrict__ f16_pair) {
    constexpr int TM = PAIR_S8_ROWS;
    constexpr int MB = 2;             // m-blocks of a warpgroup
    static_assert(TM == 128 * MB, "two m-blocks a warpgroup");
    constexpr int RT = TM * TK;       // the rows' k-block: [TM rows x 64 B], plain
    constexpr int STAGE = PAIR_S8_STAGE;
    constexpr int QBLK = PAIR_S8_QBLOCK;
    extern __shared__ unsigned char smem_raw[];
    const uint32_t raw = smem_u32(smem_raw);
    const uint32_t q_s = (raw + 1023u) & ~1023u;  // the resident head of the query block
    const int nk = (a.d + TK - 1) / TK;
    const int S = a.stages;
    const int R = a.resident;
    const uint32_t tiles = q_s + R * QBLK;
    const unsigned char* tile_g = smem_raw + (tiles - raw);
    const uint32_t red = tiles + S * STAGE;
    const uint32_t bars = red + PAIR_RED_BYTES;  // full[S], empty[S], qbar
    int* red_g = reinterpret_cast<int*>(smem_raw + (red - raw));

    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int pair = blockIdx.x % a.n_qb;
    const int p0 = blockIdx.x / a.n_qb;
    const int P = gridDim.x / a.n_qb;
    const int n_surv = *a.n_surv;

    if (tid < PAIR_Q) red_g[tid] = ordered(-INFINITY);
    if (tid == 0) {
        for (int s = 0; s < S; ++s) {
            mbar_init(bars + 8 * s, 1);
            mbar_init(bars + 8 * (S + s), 2);  // one warp of each warpgroup
        }
        mbar_init(bars + 16 * S, 1);
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();

    if (warp >= 8) {
        // ---- producer warpgroup: one thread issues every copy ----
        asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
        if (tid == CONSUMERS) {
            const int qrow = pair * PAIR_Q;
            if (R > 0) {
                const uint32_t qbar = bars + 16 * S;
                mbar_expect_tx(qbar, R * QBLK);
                for (int c = 0; c < R; ++c)
                    for (int h = 0; h < 2; ++h)
                        tma_load_2d(q_s + c * QBLK + h * QB * 128, qmap, qbar, c * TK,
                                    qrow + h * QB);
            }
            pair_produce<TM, STAGE>(
                a, nk, S, tiles, bars, p0, P, n_surv,
                [&](uint32_t dst, uint32_t full, int row0, int k0, int kb) {
                    mbar_expect_tx(full, kb < R ? RT : STAGE);
                    tma_load_2d(dst, vmap, full, k0, row0);
                    if (kb >= R)  // past the resident head: the step's query k-block
                        for (int h = 0; h < 2; ++h)
                            tma_load_2d(dst + RT + h * QB * 128, qmap, full, k0,
                                        qrow + h * QB);
                });
        }
        return;
    }

    // ---- two consumer warpgroups, both on every stage ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int wg = warp >> 2, wq = warp & 3;
    const int g = lane >> 2, t = lane & 3;
    const int r = 64 * MB * wg + 16 * wq + g;  // m-block mb's rows: r + 64 mb, + 8
    if (R > 0) mbar_wait(bars + 16 * S, 0);
    const auto walk = [&](auto f16_tag) {
        constexpr bool F16 = decltype(f16_tag)::value;
        int st = 0;
        uint32_t ph = 0;
        // the A fragments of two groups (a group: one m-block's products of
        // one k-block): the group in flight and the next one
        uint32_t af[2][4][4];
        // load the A fragment of m-block mb of stage `at` (16 bytes a row:
        // bytes 16 t .., which the query permutation k1_query_perm puts at the
        // depths of the m16n8k16 layout) and convert it into buffer B
        const auto load_cvt = [&](auto buf, int at, int mb) {
            constexpr int B = decltype(buf)::value;
            const unsigned char* tg = tile_g + at * STAGE + (r + 64 * mb) * TK + 16 * t;
            const uint4 x0 = *reinterpret_cast<const uint4*>(tg);
            const uint4 x1 = *reinterpret_cast<const uint4*>(tg + 8 * TK);
            const uint32_t w0[4] = {x0.x, x0.y, x0.z, x0.w};
            const uint32_t w1[4] = {x1.x, x1.y, x1.z, x1.w};
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
                af[B][kk][0] = s8x2_convert<F16>(w0[kk], 0, 1);
                af[B][kk][1] = s8x2_convert<F16>(w1[kk], 0, 1);
                af[B][kk][2] = s8x2_convert<F16>(w0[kk], 2, 3);
                af[B][kk][3] = s8x2_convert<F16>(w1[kk], 2, 3);
            }
        };
        // release a stage: the warpgroup's products on it are complete
        // (wgmma.wait_group is warpgroup-wide), so one warp speaks for it
        const auto release = [&](int at) {
            if (wq == (at & 3) && lane == 0) mbar_arrive(bars + 8 * (S + at));
        };
        constexpr std::integral_constant<int, 0> B0{};
        constexpr std::integral_constant<int, 1> B1{};
        for (int slot = p0; slot < n_surv; slot += P) {
            const int bin = a.surv[slot];
            float best[4];  // the bin max of slots 4 g + k (k = 0..3) of the pair
#pragma unroll
            for (int k = 0; k < 4; ++k) best[k] = -INFINITY;
            for (int sp = 0; sp < BIN / TM; ++sp) {
                // the rows' side data, read now and first used after the products
                const size_t row = (size_t)bin * BIN + sp * TM + r;
                float sv[MB][2][NSIDE > 0 ? NSIDE : 1];
#pragma unroll
                for (int mb = 0; mb < MB; ++mb)
#pragma unroll
                    for (int j = 0; j < NSIDE; ++j) {
                        sv[mb][0][j] = __ldg(a.side[j] + row + 64 * mb);
                        sv[mb][1][j] = __ldg(a.side[j] + row + 64 * mb + 8);
                    }
                float d[MB][64];
#pragma unroll
                for (int mb = 0; mb < MB; ++mb)
#pragma unroll
                    for (int i = 0; i < 64; ++i) d[mb][i] = 0.f;
                int prev = -1;  // the stage of the last k-block issued before this one
                // the group of m-block mb of k-block kb on the current stage from
                // buffer B (the query k-block resident below R, else in the
                // stage), then the group before it waited for (its buffer is
                // free again)
                const auto issue = [&](auto buf, int mb, int kb) {
                    constexpr int B = decltype(buf)::value;
                    const uint32_t qs = kb < R ? q_s + kb * QBLK : tiles + st * STAGE + RT;
                    fence_acc(d[mb]);
                    wgmma_fence();
#pragma unroll
                    for (int kk = 0; kk < 4; ++kk) {
                        const uint32_t(&f)[4] = af[B][kk];
                        wgmma_rs_n128<F16>(d[mb], f[0], f[1], f[2], f[3],
                                           desc_sw128(qs + kk * 32));
                    }
                    wgmma_commit();
                    wgmma_wait<1>();
                };
                // k-block kb's groups are issued: the stage before it is released
                // (its groups are complete), and the next k-block's stage waited
                // for and its first m-block converted into buffer B while the
                // products run
                const auto kblock_done = [&](auto buf, int kb) {
                    if (prev >= 0) release(prev);
                    prev = st;
                    if (++st == S) { st = 0; ph ^= 1; }
                    if (kb + 1 < nk) {
                        mbar_wait(bars + 8 * st, ph);
                        load_cvt(buf, st, 0);
                    }
                };
                // m-block 0's groups from buffer 0, m-block 1's from buffer 1
                mbar_wait(bars + 8 * st, ph);
                load_cvt(B0, st, 0);
                for (int kb = 0; kb < nk; ++kb) {
                    issue(B0, 0, kb);
                    load_cvt(B1, st, 1);
                    issue(B1, 1, kb);
                    kblock_done(B0, kb);
                }
                wgmma_wait<0>();
                release(prev);
#pragma unroll
                for (int mb = 0; mb < MB; ++mb) fence_acc(d[mb]);
                pair_key<NSIDE, MB, F16>(make_key, pair, lane, unscale,
                                         [&](int mb, int i) { return d[mb][i]; },
                                         [&](int mb, int h) -> auto& { return sv[mb][h]; },
                                         best);
            }
            pair_write_bin(best, red_g, lane, pair, bin, a);
        }
    };
    if (f16_pair[pair]) walk(std::true_type{});
    else walk(std::false_type{});
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
    static EncodeTiledFn fn = nullptr;
    if (!fn) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
        if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                             cudaEnableDefault, &q) != cudaSuccess)
            return nullptr;
#else
        if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q)
            != cudaSuccess)
            return nullptr;
#endif
        if (q != cudaDriverEntryPointSuccess) return nullptr;
        fn = reinterpret_cast<EncodeTiledFn>(p);
    }
    return fn;
}

// a 2-D map over a row-major [rows, cols] tensor (cols contiguous, row
// stride `stride` bytes) with boxes of [box_rows, box_cols]; zero fill out
// of bounds
inline bool make_map(CUtensorMap* map, CUtensorMapDataType type, const void* ptr,
                     uint64_t rows, uint64_t cols, uint64_t stride, uint32_t box_rows,
                     uint32_t box_cols, CUtensorMapSwizzle swz) {
    EncodeTiledFn fn = encode_tiled();
    if (!fn) return false;
    const cuuint64_t dims[2] = {cols, rows};
    const cuuint64_t strides[1] = {stride};
    const cuuint32_t box[2] = {box_cols, box_rows};
    const cuuint32_t estr[2] = {1, 1};
    return fn(map, type, 2, const_cast<void*>(ptr), dims, strides, box, estr,
              CU_TENSOR_MAP_INTERLEAVE_NONE, swz, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the data type of a map over elements of type T
template <typename T>
constexpr CUtensorMapDataType map_type() {
    return sizeof(T) == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
         : sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                          : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
}

// the maps of one launch: queries [bq, dq] of QT (dq a multiple of the
// k-block depth; 128 B swizzled boxes of 64 queries x 128 B: 64 bf16, 128
// int8, 32 f32; with two planes bq is twice the padded batch) and rows
// [n_pad, d] (TM-row boxes of one k-block, 128 B swizzled for wgmma's
// descriptor and the FFMA loads; int8 rows under bf16 queries 64 deep and
// plain, for the fragment loads; f32 rows two boxes of 32 deep a k-block);
// with v2 (two bf16 row arrays) the second row map
template <typename RowT, int TM, typename QT = __nv_bfloat16>
inline bool make_maps(CUtensorMap* qmap, CUtensorMap* vmap, const void* q, int bq, int dq,
                      const void* v, long long n_pad, int d, CUtensorMap* vmap2 = nullptr,
                      const void* v2 = nullptr) {
    constexpr int ELT = (int)sizeof(RowT);
    constexpr bool PLAIN = ELT == 1 && sizeof(QT) != 1;  // K1's int8 rows
    const auto row_map = [&](CUtensorMap* map, const void* rows) {
        return make_map(map, map_type<RowT>(), rows, (uint64_t)n_pad, (uint64_t)d,
                        (uint64_t)d * ELT, TM, PLAIN ? TK : 128 / ELT,
                        PLAIN ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B);
    };
    return make_map(qmap, map_type<QT>(), q, (uint64_t)bq, (uint64_t)dq,
                    (uint64_t)dq * sizeof(QT), QB, 128 / sizeof(QT), CU_TENSOR_MAP_SWIZZLE_128B)
        && row_map(vmap, v) && (vmap2 == nullptr || row_map(vmap2, v2));
}

// the scan's arguments of a launch: side[0 : n_side), n_groups query groups
// (blocks, or pairs on the pair plan)
inline ScanArgs scan_args(const float* const* side, int n_side, const void* surv,
                          const void* n_surv, void* out, int d, int b, int n_groups,
                          int stages, int resident) {
    ScanArgs a = {};
    a.surv = (const int*)surv;
    a.n_surv = (const int*)n_surv;
    for (int i = 0; i < n_side; ++i) a.side[i] = side[i];
    a.out = (float*)out;
    a.d = d;
    a.b = b;
    a.n_qb = n_groups;
    a.stages = stages;
    a.resident = resident;
    return a;
}

// Launch kernel<KS, TM, STREAM> of the plan of d on a persistent grid of
// n_qb * per_group CTAs: set its shared memory, encode the maps (q holds
// NQ planes of n_qb * 64 queries each, one after the other; over two bf16
// row arrays, NV = 2, v2 is the low plane's), fill the scan's arguments
// (side[0 : n_side)) and call launch_fn(kernel, grid, smem, qmap, vmap,
// args), or launch_fn(kernel, grid, smem, qmap, vmap, vmap2, args) with
// two row maps, which passes the kernel's own arguments. Returns a CUDA
// error code (cudaErrorInvalidValue when a map cannot be encoded).
template <typename RowT, int KS1, int TM1, int KS2, int TM2, int NQ = 1, int NV = 1,
          typename QT = __nv_bfloat16, typename GetKernel, typename LaunchFn>
int launch_plan(const GetKernel& get_kernel, const LaunchFn& launch_fn, const void* q,
                const void* v, const float* const* side, int n_side, const void* surv,
                const void* n_surv, void* out, int n_bins, int d, int b, int dq, int n_qb,
                int per_group, const void* v2 = nullptr) {
    constexpr bool TWO_MAPS = NV == 2;
    if (n_qb < 1 || per_group < 1 || dq % kdepth<QT>() || TWO_MAPS != (v2 != nullptr))
        return (int)cudaErrorInvalidValue;
    return with_plan<RowT, KS1, TM1, KS2, TM2, NQ, NV, QT>(d, [&](auto ks, auto tm, auto st,
                                                                   int resident) {
        constexpr int KS = decltype(ks)::value, TM = decltype(tm)::value;
        constexpr bool STREAM = decltype(st)::value;
        const auto kernel = get_kernel(ks, tm, st);
        const int stages = stages_for<RowT, KS, TM, STREAM, NQ, NV, QT>(d, resident);
        const size_t smem = smem_bytes<RowT, KS, TM, STREAM, NQ, NV, QT>(d, stages, resident);
        cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
        CUtensorMap qmap, vmap, vmap2;
        if (!make_maps<RowT, TM, QT>(&qmap, &vmap, q, NQ * n_qb * QB, dq, v,
                                     (long long)n_bins * BIN, d, TWO_MAPS ? &vmap2 : nullptr,
                                     v2))
            return (int)cudaErrorInvalidValue;
        const ScanArgs a = scan_args(side, n_side, surv, n_surv, out, d, b, n_qb, stages,
                                     STREAM ? resident : 0);
        if constexpr (TWO_MAPS)
            launch_fn(kernel, dim3(n_qb * per_group), smem, qmap, vmap, vmap2, a);
        else
            launch_fn(kernel, dim3(n_qb * per_group), smem, qmap, vmap, a);
        return (int)cudaGetLastError();
    });
}

// the pair plan of RowT: its rows a stage, query planes, and its stages,
// resident query k-blocks and shared memory at depth d; over f32 rows
// scan_pair's, over int8 rows scan_pair_s8's
template <typename RowT>
struct PairShape;
template <>
struct PairShape<float> {
    static constexpr int ROWS = PAIR_ROWS, NQ = 2;
    static int stages(int) { return pair_stages(); }
    static int resident(int) { return 0; }
    static size_t smem(int) { return pair_smem_bytes(pair_stages()); }
};
template <>
struct PairShape<int8_t> {
    static constexpr int ROWS = PAIR_S8_ROWS, NQ = 1;
    static int stages(int d) { return pair_s8_stages(d); }
    static int resident(int d) { return pair_s8_resident(d); }
    static size_t smem(int d) { return pair_s8_smem_bytes(pair_s8_stages(d), pair_s8_resident(d)); }
};

// Launch a kernel of scan_pair (f32 rows) or scan_pair_s8 (int8 rows) on a
// persistent grid of n_qp * per_group CTAs, n_qp pairs of query blocks (q
// holds the NQ planes of n_qp * 128 queries each, one after the other), as
// launch_plan does.
template <typename RowT = float, typename Kernel, typename LaunchFn>
int launch_pair(Kernel kernel, const LaunchFn& launch_fn, const void* q, const void* v,
                const float* const* side, int n_side, const void* surv, const void* n_surv,
                void* out, int n_bins, int d, int b, int dq, int n_qp, int per_group) {
    using Shape = PairShape<RowT>;
    if (n_qp < 1 || per_group < 1 || dq % TK) return (int)cudaErrorInvalidValue;
    const int stages = Shape::stages(d), resident = Shape::resident(d);
    const size_t smem = Shape::smem(d);
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    CUtensorMap qmap, vmap;
    if (!make_maps<RowT, Shape::ROWS>(&qmap, &vmap, q, Shape::NQ * n_qp * PAIR_Q, dq, v,
                                      (long long)n_bins * BIN, d))
        return (int)cudaErrorInvalidValue;
    launch_fn(kernel, dim3(n_qp * per_group), smem, qmap, vmap,
              scan_args(side, n_side, surv, n_surv, out, d, b, n_qp, stages, resident));
    return (int)cudaGetLastError();
}

}  // namespace sm90
