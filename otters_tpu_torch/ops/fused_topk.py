"""Fused pruned scoring + exact top-k: the K1 kernel and its phase 2.

Counterpart of the JAX package's ``ops/pallas_topk.py``. The chunk mask
becomes a per-512-row-bin alive mask, and a **survivor list** of live bins
is built on the device (a cumsum of the alive flags and a scatter), so no
host round trip decides what to scan. Phase 1 is the hand-written Hopper
kernel ``csrc/cert_cos_binmax.cu`` (K1, the certified-cosine mode over int8
rows): per-bin maxima of the certificate-adjusted key for the live bins
only. Phase 2 re-scores the winning bins and selects the k candidates by
the adjusted key, returning the certificate's bound, in plain torch (it is
XLA code in the JAX package).

Only K1 is ported. The other modes of the TPU kernel (K2 uncertified int8,
K3 exact f32/bf16, K4 bf16x3 fast-exact, K5 the general certificate fold)
raise ``NotImplementedError`` naming the mode; nothing routes silently to a
plain torch path.

Exactness: the k winning bins by adjusted bin max are a superset of the
best k adjusted keys; the bound covers every row not returned (see the JAX
package's ``_pallas_topk_jit``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from ..types import Cmp, Metric
from .scoring import (
    CERT_BIN,
    _filter_ok,
    _query_norms,
    _stable_topk,
    cert_global_slack,
    cert_query_coeffs,
    cert_row_lanes,
    exact_topk_flat,
    require_full_f32,
)

BIN = 512
assert BIN == CERT_BIN  # resid_bin granularity must match the kernel's bins
# widest top-k the fused path accepts; the certificate's widen loop clamps
# its sequence to this boundary (meta.py widen loop)
FUSED_K_MAX = 1024
QUERY_BLOCK = 64  # queries per kernel block (csrc/cert_cos_binmax.cu QB)
_CMP_CODE = {None: 0, Cmp.Gt: 1, Cmp.Gte: 2}
_NEG_INF = float("-inf")


def kernel_mode(storage_dtype, metric: Metric, take_min: bool, certify: bool) -> str:
    """Name the TPU kernel mode a fused query needs; raise unless ported."""
    if storage_dtype == torch.int8 and certify:
        if metric is Metric.Cosine and not take_min:
            return "K1"
        raise NotImplementedError("this certified int8 plan shape is not a K1 query")
    if storage_dtype == torch.int8:
        name = "K2 (uncertified int8 cosine)"
    elif certify:
        name = "K5 (general certified fold, bfloat16 storage)"
    else:
        name = "K3/K4 (exact f32 / bf16x3 fast-exact)"
    raise NotImplementedError(
        f"fused kernel mode {name} is not ported yet; only K1 (certified "
        "cosine over int8 rows) runs on the port"
    )


def bins_alive_from_chunk_mask(chunk_mask: torch.Tensor, chunk_size: int, n_pad: int):
    """[n_chunks] chunk mask -> [n_bins] bin-alive flags (OR of overlaps).

    A bin [i*512, (i+1)*512) overlaps chunks first..last; it is alive when
    the alive-count prefix sum differs across that range. O(n_bins +
    n_chunks) on the device, no host round trip."""
    n_chunks = chunk_mask.shape[0]
    n_bins = n_pad // BIN
    dev = chunk_mask.device
    cs = torch.zeros(n_chunks + 1, dtype=torch.int64, device=dev)
    cs[1:] = torch.cumsum(chunk_mask.to(torch.int64), dim=0)
    start = torch.arange(n_bins, device=dev) * BIN
    first = torch.clamp(start // chunk_size, max=n_chunks)
    last = torch.clamp((start + BIN - 1) // chunk_size + 1, max=n_chunks)
    return cs[last] > cs[first]


def survivor_bins(bin_alive: torch.Tensor):
    """-> (surv[n_bins] int32, n_surv[1] int32): the live bins in ascending
    order (slots past n_surv hold 0), built with a cumsum and a scatter."""
    n_bins = bin_alive.shape[0]
    dev = bin_alive.device
    alive = bin_alive.to(torch.int64)
    cs = torch.cumsum(alive, dim=0)
    # dead bins scatter into a dump slot past the end
    pos = torch.where(bin_alive, cs - 1, n_bins)
    surv = torch.zeros(n_bins + 1, dtype=torch.int32, device=dev)
    surv.scatter_(0, pos, torch.arange(n_bins, dtype=torch.int32, device=dev))
    n_surv = alive.sum().to(torch.int32).reshape(1)
    return surv[:n_bins], n_surv


def _check_k1_inputs(q, v, inv, rmask, lane_a, q_inv, q_ok, thr, surv, n_surv):
    b, d = q.shape
    n_pad = v.shape[0]
    want = [
        ("q", q, torch.bfloat16, (b, d)),
        ("v", v, torch.int8, (n_pad, d)),
        ("inv", inv, torch.float32, (n_pad,)),
        ("rmask", rmask, torch.float32, (n_pad,)),
        ("lane_a", lane_a, torch.float32, (n_pad,)),
        ("q_inv", q_inv, torch.float32, (b,)),
        ("q_ok", q_ok, torch.float32, (b,)),
        ("thr", thr, torch.float32, (1,)),
        ("surv", surv, torch.int32, (n_pad // BIN,)),
        ("n_surv", n_surv, torch.int32, (1,)),
    ]
    for name, t, dtype, shape in want:
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"cert_cos_binmax: {name} must be {dtype} {shape}, got "
                f"{t.dtype} {tuple(t.shape)}"
            )
        if t.device != q.device:
            raise ValueError(f"cert_cos_binmax: {name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"cert_cos_binmax: {name} must be contiguous")
    if n_pad % BIN:
        raise ValueError(f"cert_cos_binmax: n_pad={n_pad} is not a multiple of {BIN}")


def cert_cos_binmax_plain(q, v, inv, rmask, lane_a, q_inv, q_ok, thr, surv, n_surv,
                          cmp: Optional[Cmp] = None, slab_bins: int = 256):
    """The K1 function in plain torch: [n_bins, b] per-bin maxima of

        key = where(ok, (dot * q_inv) * inv, -inf) + lane_a,
        ok  = rmask > 0 & q_ok > 0 & !isnan(score) & cmp(score, thr),

    with dot the f32 product of the bf16-rounded queries and the int8 rows,
    over the live bins ``surv[:n_surv]`` only; dead bins stay -inf. Slabs of
    ``slab_bins`` bins bound the temporaries."""
    require_full_f32(q)
    b, d = q.shape
    n_bins = v.shape[0] // BIN
    out = torch.full((n_bins, b), _NEG_INF, device=q.device)
    live = surv[: int(n_surv[0])].long()
    q32 = q.float()
    ar = torch.arange(BIN, device=q.device)
    for s in range(0, live.shape[0], slab_bins):
        bins = live[s : s + slab_bins]
        rows = (bins[:, None] * BIN + ar[None, :]).reshape(-1)
        dots = q32 @ v[rows].float().T  # [b, rows]
        score = dots * q_inv[:, None] * inv[rows][None, :]
        ok = (rmask[rows] > 0)[None, :] & (q_ok > 0)[:, None] & ~torch.isnan(score)
        if cmp is not None:
            ok = ok & _filter_ok(score, thr[0], cmp)
        key = torch.where(ok, score, _NEG_INF) + lane_a[rows][None, :]
        out[bins] = key.reshape(b, -1, BIN).amax(dim=2).T
    return out


@functools.lru_cache(maxsize=None)
def _k1_lib():
    """The built K1 library with its C signatures declared (built on the
    first call, never at import)."""
    from .. import kernels

    lib = kernels.load("cert_cos_binmax")
    lib.cert_cos_binmax_smem_bytes.argtypes = [ctypes.c_int]
    lib.cert_cos_binmax_smem_bytes.restype = ctypes.c_size_t
    lib.cert_cos_binmax_launch.argtypes = (
        [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    )
    lib.cert_cos_binmax_launch.restype = ctypes.c_int
    return lib


def cert_cos_binmax(q, v, inv, rmask, lane_a, q_inv, q_ok, thr, surv, n_surv,
                    cmp: Optional[Cmp] = None):
    """K1 bin maxima (see :func:`cert_cos_binmax_plain` for the function).

    CPU tensors take the plain version; CUDA tensors launch the Hopper
    kernel (csrc/cert_cos_binmax.cu) and raise if it cannot build or
    launch. ``cert_cos_binmax.launches`` counts kernel launches."""
    _check_k1_inputs(q, v, inv, rmask, lane_a, q_inv, q_ok, thr, surv, n_surv)
    if q.device.type == "cpu":
        return cert_cos_binmax_plain(
            q, v, inv, rmask, lane_a, q_inv, q_ok, thr, surv, n_surv, cmp
        )
    if q.device.type != "cuda":
        raise ValueError(f"cert_cos_binmax: unsupported device {q.device}")
    b, d = q.shape
    if d % 16:
        raise ValueError(f"cert_cos_binmax: d={d} must be a multiple of 16")
    n_bins = v.shape[0] // BIN
    lib = _k1_lib()
    smem = lib.cert_cos_binmax_smem_bytes(d)
    if smem > 232448:
        raise ValueError(f"cert_cos_binmax: d={d} needs {smem} B of shared memory (> 227 KB)")
    # pad the batch to whole query blocks; padded lanes have q_ok = 0
    n_qb = -(-b // QUERY_BLOCK)
    bq = n_qb * QUERY_BLOCK
    if bq != b:
        q = torch.cat([q, q.new_zeros((bq - b, d))])
        q_inv = torch.cat([q_inv, q_inv.new_zeros(bq - b)])
        q_ok = torch.cat([q_ok, q_ok.new_zeros(bq - b)])
    out = torch.full((n_bins, b), _NEG_INF, device=q.device)
    if n_bins == 0 or b == 0:
        return out
    err = lib.cert_cos_binmax_launch(
        q.data_ptr(), v.data_ptr(), inv.data_ptr(), rmask.data_ptr(),
        lane_a.data_ptr(), q_inv.data_ptr(), q_ok.data_ptr(), thr.data_ptr(),
        surv.data_ptr(), n_surv.data_ptr(), out.data_ptr(),
        n_bins, d, b, n_qb, _CMP_CODE[cmp],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"cert_cos_binmax kernel launch failed: CUDA error {err}")
    cert_cos_binmax.launches += 1
    return out


cert_cos_binmax.launches = 0


def fused_topk(
    vectors,
    norms_sq,
    inv_norms,
    valid,
    queries,
    row_mask,
    thr,
    bin_alive,
    *,
    metric: Metric,
    k: int,
    take_min: bool,
    cmp: Optional[Cmp],
    certify: bool,
    resid=None,
    q_valid=None,
):
    """Fused pruned scoring + top-k candidates with the certificate bound.

    bin_alive: [n_pad / 512] bool — False bins are skipped entirely (no
    loads, no math). Soundness requires that every row of a dead bin fails
    ``row_mask`` (zonemap pruning guarantees this). ``thr`` is a device f32
    scalar.

    Returns (rows[k], scores[k], valid[k], check, bound): ``bound`` is a
    sound upper bound on the true f32 cosine of every row not returned;
    ``check`` is always True (the fast-exact mode K4 is not ported)."""
    kernel_mode(vectors.dtype, metric, take_min, certify)
    if cmp not in _CMP_CODE:
        raise NotImplementedError(f"K1 takes no {cmp} score filter")
    if resid is None:
        raise ValueError("certified fused scan needs the per-row residuals")
    n_pad, d = vectors.shape
    b = queries.shape[0]
    dev = vectors.device
    # MIXED certified scan: queries rounded once to bf16 and kept
    # unquantized; c0 carries their rounding residual + arithmetic headroom
    qh32, c0, c1, c2 = cert_query_coeffs(metric, queries, d)
    q_kern = qh32.to(torch.bfloat16)
    lane_a, lane_b = cert_row_lanes(metric, vectors.dtype, resid, inv_norms, norms_sq, d)
    _, q_inv = _query_norms(qh32)
    # the global slack only loosens the score filter, so no truly passing
    # row is dropped on its scan score
    slack_g = cert_global_slack(c0, c1, c2, lane_a, lane_b, norms_sq, q_valid=q_valid)
    thr1 = thr - slack_g if cmp in (Cmp.Gt, Cmp.Gte) else thr
    q_ok = (
        torch.ones(b, device=dev) if q_valid is None else q_valid.to(torch.float32)
    )
    rmask01 = valid.to(torch.float32)
    if row_mask is not None:
        rmask01 = rmask01 * row_mask.to(torch.float32)
    surv, n_surv = survivor_bins(bin_alive)
    bins = cert_cos_binmax(
        q_kern, vectors, inv_norms, rmask01, lane_a, q_inv, q_ok,
        thr1.reshape(1).to(torch.float32), surv, n_surv, cmp,
    )

    # ---- phase 2: winner-bin rescore and adjusted-key selection ----
    # the per-query c0 joins here: max(key) + c0 is the fully adjusted bin
    # max (max is monotone; -inf stays -inf)
    flat = (bins + c0[None, :]).reshape(-1)  # slot = bin * b + query
    kb = min(k, flat.shape[0])
    _, top_slots = exact_topk_flat(flat, kb)
    # phase-1 term of the bound: an unselected bin's adjusted max bounds
    # the true score of every row it holds
    bound1 = flat.scatter(0, top_slots, _NEG_INF).max()
    bsel = top_slots // b
    qsel = top_slots % b
    rows_flat = (
        bsel[:, None] * BIN + torch.arange(BIN, device=dev)[None, :]
    ).reshape(-1)
    # mixed rescore: bf16 queries x int8 rows, f32 products and sums (the
    # same arithmetic class as phase 1, covered by mixed_cert_eps)
    require_full_f32(qh32)
    blk = vectors[rows_flat].reshape(kb, BIN, d).float()
    dots = torch.bmm(blk, qh32[qsel][:, :, None])[:, :, 0]  # [kb, BIN]
    scores = dots * q_inv[qsel][:, None] * inv_norms[rows_flat].reshape(kb, BIN)
    ok = valid[rows_flat].reshape(kb, BIN) & ~torch.isnan(scores)
    if row_mask is not None:
        ok = ok & row_mask[rows_flat].reshape(kb, BIN)
    if q_valid is not None:
        ok = ok & q_valid[qsel][:, None]
    if cmp is not None:
        # phase-2 scores are still approximate: keep the loosened threshold
        ok = ok & _filter_ok(scores, thr1, cmp)
    # select by the ADJUSTED key (scan key + per-(query, row) slack): the
    # unreturned rows are then the smallest adjusted values, which
    # minimizes the bound; the rerank re-scores candidates exactly
    adj = scores + c0[qsel][:, None] + lane_a[rows_flat].reshape(kb, BIN)
    key_flat = torch.where(ok, adj, _NEG_INF).reshape(-1)
    _, sel = _stable_topk(key_flat, min(k, key_flat.shape[0]))
    out_rows = rows_flat[sel].to(torch.int32)
    out_scores = scores.reshape(-1)[sel]
    out_ok = ok.reshape(-1)[sel]
    # phase-2 term: examined rows not returned, with their own slacks
    bound = torch.maximum(bound1, key_flat.scatter(0, sel, _NEG_INF).max())
    check = torch.ones((), dtype=torch.bool, device=dev)
    return out_rows, out_scores, out_ok, check, bound
