// Shared pieces of the uncertified bin-max kernels (K2, K3, K4, K6).
//
// Each kernel computes, for every live 512-row bin and every query, the
// bin maximum of the masked key of otters_tpu/ops/pallas_topk.py::_kernel:
//
//   score = (dot * q_inv) * inv          Cosine    (metric 0)
//         = dot                          Dot       (metric 1)
//         = (q_sq + nsq) - 2 * dot       Euclid    (metric 2)
//   ok    = q_ok > 0 && rmask > 0 && !isnan(score) && cmp(score, thr)
//   key   = ok ? (take_min ? -score : score) : -inf
//
// with JAX's order of operations kept by the rounded intrinsics (nvcc
// would otherwise contract a*b + c into an FMA). cmp: 0 none, 1 Gt, 2 Gte,
// 3 Lt, 4 Lte, 5 Eq; the kernels receive it as cmp_mask(cmp).
//
// Every bin-max kernel walks the survivor list with a persistent grid
// (csrc/cert_scan_sm90.cuh), K2, K3, K4 and K6 with the key of SlotKey
// below; the output [n_bins, b] is pre-filled with -inf by the caller and
// padded query rows carry q_ok = 0.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace binmax {

// The epilogue is branch-free: every metric form is computed and one is
// selected, and the filter is a mask of the accepted orderings. (Branches
// on the same runtime parameters, inlined once per register-tile element,
// let the compiler's correlated-branch threading blow up.)
__device__ __forceinline__ float score_of(float dot, float qi, float qsq,
                                          float inv, float nsq, int metric) {
    const float cosv = __fmul_rn(__fmul_rn(dot, qi), inv);
    const float eucl = __fsub_rn(__fadd_rn(qsq, nsq), __fmul_rn(2.0f, dot));
    return metric == 0 ? cosv : (metric == 2 ? eucl : dot);
}

// accepted orderings of (score vs thr): bit 0 greater, bit 1 equal, bit 2
// less; no filter accepts all three (NaN is excluded on its own)
__host__ __device__ __forceinline__ int cmp_mask(int cmp) {
    switch (cmp) {
        case 1: return 1;  // Gt
        case 2: return 3;  // Gte
        case 3: return 4;  // Lt
        case 4: return 6;  // Lte
        case 5: return 2;  // Eq
        default: return 7;
    }
}

// sgn = -1 for take-min (the key is the negated score), +1 otherwise
__device__ __forceinline__ float key_of(float dot, float qi, float qsq, bool qok,
                                        float inv, float nsq, float rm, float thr,
                                        int metric, float sgn, int cmask) {
    const float s = score_of(dot, qi, qsq, inv, nsq, metric);
    const int order = (s > thr ? 1 : 0) | (s == thr ? 2 : 0) | (s < thr ? 4 : 0);
    const bool ok = qok & (rm > 0.f) & !isnan(s) & ((order & cmask) != 0);
    return ok ? __fmul_rn(sgn, s) : -INFINITY;
}

// key_of for the 16 query slots of a thread of the Hopper scan
// (csrc/cert_scan_sm90.cuh's Key; row side data {inv, nsq, rmask}), for K2
// and for K3, K6 and K4 over f32 and bf16 rows (K3's FFMA consumers use
// slots 0..7). Only one per-query norm enters a metric (Cosine
// q_inv, Euclid q_sq, Dot none), so a slot keeps that one in qn and hands
// it to key_of in both places: the metric's form reads the right one.
struct SlotKey {
    static constexpr int NSIDE = 3;
    float qn[16];   // the slot's f32 query's q_inv (Cosine) or q_sq
    uint32_t ok;    // bit j: q_ok of slot j
    float t, sgn;
    int metric, cmask;

    __device__ __forceinline__ void prep(float (&)[NSIDE]) const {}
    __device__ __forceinline__ float operator()(float dot, const float (&s)[NSIDE],
                                                int j) const {
        return key_of(dot, qn[j], qn[j], (ok >> j) & 1u, s[0], s[1], s[2], t, metric, sgn,
                      cmask);
    }
};

// the SlotKey of query columns cols (of the block at q0), from the f32
// queries' norms q_inv / q_sq, q_ok (0/1), thr[0] and the codes
__device__ __forceinline__ SlotKey make_slot_key(int q0, const int (&cols)[16],
                                                 const float* q_inv, const float* q_sq,
                                                 const float* q_ok, float thr, int metric,
                                                 int take_min, int cmp) {
    SlotKey k;
    k.ok = 0;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
        const int q = q0 + cols[j];
        k.qn[j] = metric == 0 ? q_inv[q] : q_sq[q];
        k.ok |= (q_ok[q] > 0.f ? 1u : 0u) << j;
    }
    k.t = thr;
    k.sgn = take_min ? -1.f : 1.f;
    k.metric = metric;
    k.cmask = cmp_mask(cmp);
    return k;
}

}  // namespace binmax
