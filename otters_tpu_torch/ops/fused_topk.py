"""Fused pruned scoring + exact top-k: the Hopper kernels and their phase 2.

Counterpart of the JAX package's ``ops/pallas_topk.py``. The chunk mask
becomes a per-512-row-bin alive mask, and a **survivor list** of live bins
is built on the device (a cumsum of the alive flags and a scatter), so no
host round trip decides what to scan. Phase 1 is a hand-written Hopper
kernel that writes the per-bin maxima of the masked key for the live bins
only; each replaces one mode of the TPU kernel
(``otters_tpu/ops/pallas_topk.py::_kernel``), named by its key in
:data:`KERNELS`:

- K1 ``csrc/cert_cos_binmax.cu``: certified Cosine (bf16-rounded queries,
  the per-row certificate lane folded in), over int8 rows ("K1") and over
  bfloat16 rows ("K1-bf16");
- K2 ``csrc/int8_binmax.cu``: the uncertified int8 modes, int8 queries x
  int8 rows into exact int32 dots (s8 wgmma);
- K3 ``csrc/f32_binmax.cu``: exact f32 (``prec="highest"``), the strict
  mode, for Cosine / Dot / Euclid and every score filter, over f32 rows
  ("K3") and bfloat16 rows upcast exactly ("K3-bf16"), one FFMA per term;
- K4 ``csrc/bf16x3_binmax.cu``: the bf16x3 fast-exact mode (``prec="high"``
  or the default verified fast path), over f32 rows ("K4") and bfloat16
  rows ("K4-bf16", whose low plane is zero, so two products);
- K5 ``csrc/cert_fold_binmax.cu``: the general certified fold over bfloat16
  rows, Dot (take-max) and Euclid (take-min),
  ``key + c0 + c1*lane_a + c2*||v|| + lane_b``;
- K6 ``csrc/bf16_binmax.cu``: the one-pass store precisions ("default" /
  "bf16", ``Precision.DEFAULT`` on a TPU), bf16-rounded queries x rows
  rounded to bf16 (f32 rows, "K6") or as stored ("K6-bf16"), f32 sums,
  every metric and score filter.

Every kernel runs the Hopper scan of ``csrc/cert_scan_sm90.cuh``
(:func:`sm90_plan` mirrors its ring plans, the deep-row, split and pair
plans included; K4
with two query planes, :func:`query_planes`, and over f32 rows two row
planes split in the kernel; K1 over int8 rows at more than one query block
on the pair plan, its queries rewritten to f16 pair by pair,
:func:`f16_queries`; K2 with int8 queries, K3 with f32 queries and
FFMA consumers). The stored rows' depth is padded to a multiple of 16
(``scoring.pad_depth``): the launch reads it from the rows' stride and pads
the queries to it. :func:`kernel_takes`, the counterpart of the JAX
package's ``pallas_ok``, tells from the shape whether a kernel fits (every
kernel takes any d: the deep-row plan streams the query block) and refuses
every shape under ``OTTERS_DISABLE_PALLAS``; the callers send a shape it
refuses to the scan program before any launch.

Phase 2 re-scores the winning bins and selects the k results in plain
torch (it is XLA code in the JAX package), at the phase-1 precision for
K6. Every kernel has a plain torch version in this module, which serves CPU
tensors; a CUDA tensor launches the kernel or raises.

Exactness: the k winning bins by bin max are a superset of the best k keys.
In the fast mode the check ``kth_key >= boundary + slack`` certifies that no
unexamined bin can hold a better row; callers re-run strictly (K3) when it
fails. With certify (K1, K5) the bound covers every row not returned (see
the JAX package's ``_pallas_topk_jit``).
"""

from __future__ import annotations

import ctypes
import os
import functools
from typing import NamedTuple, Optional

import torch

from ..types import VPU_METRICS, Cmp, Metric
from ..utils.profiling import count, span
from .scoring import (
    CERT_BIN,
    DEPTH_ALIGN,
    ONE_PASS,
    _filter_ok,
    _quantize_rows_int8,
    _query_norms,
    _stable_topk,
    cert_maxima,
    cert_slack,
    cert_terms,
    check_precision,
    exact_topk_flat,
    high_precision_bound,
    loosened,
    one_pass_dots,
    pad_depth,
    require_full_f32,
    tiles_alive_from_chunk_mask,
)

BIN = 512
assert BIN == CERT_BIN  # resid_bin granularity must match the kernel's bins
# widest top-k the fused path accepts; the certificate's widen loop clamps
# its sequence to this boundary (meta.py widen loop)
FUSED_K_MAX = 1024
QUERY_BLOCK = 64  # queries per kernel block (every csrc/*.cu kernel's QB)
# queries of a CTA on the pair plan (csrc/cert_scan_sm90.cuh's PAIR_Q): K4's
# over f32 rows, and K1's over int8 rows from a batch of K1_PAIR_FROM (more
# than one query block; a single block is faster on 64 queries a CTA)
PAIR_QUERIES = 2 * QUERY_BLOCK
K1_PAIR_FROM = QUERY_BLOCK + 1
PAIR_MIN_STAGES = 4  # stages the pair plan over int8 rows keeps beside its resident head
_CMP_CODE = {None: 0, Cmp.Gt: 1, Cmp.Gte: 2, Cmp.Lt: 3, Cmp.Lte: 4, Cmp.Eq: 5}
_METRIC_CODE = {Metric.Cosine: 0, Metric.DotProduct: 1, Metric.Euclidean: 2}
_NEG_INF = float("-inf")
_SMEM_MAX = 232448  # a block's shared memory on Hopper (227 KB)


def fast_ok(metric: Metric, take_min: bool, cmp, k: int, prec: str) -> bool:
    """Is the verified fast-exact mode (K4 + check) applicable?

    The matmul metrics qualify at the store's default precision; an Eq
    score filter would need a two-sided slack, and a large k makes the
    4k-bin candidate set expensive (the JAX package's rule)."""
    return (
        prec == "highest"
        and metric not in VPU_METRICS
        and cmp is not Cmp.Eq
        and k <= 128
    )


def kernel_mode(storage_dtype, metric: Metric, take_min: bool, certify: bool,
                prec: str = "highest", fast: bool = False) -> str:
    """Name the kernel a fused query needs (a key of :data:`KERNELS`). The
    store precision ``prec`` picks the uncertified f32 / bf16-row mode:
    "highest" K3 (K4 when ``fast``), "high" K4, "default" / "bf16" the
    one-pass K6."""
    if storage_dtype == torch.int8:
        if not certify:
            return "K2"
        if metric is Metric.Cosine and not take_min:
            return "K1"
        raise NotImplementedError("this certified int8 plan shape is not a K1 query")
    if storage_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"unsupported storage dtype {storage_dtype}")
    if certify:
        if storage_dtype != torch.bfloat16:
            raise ValueError("f32 storage is exact and carries no certificate")
        if metric is Metric.Cosine and not take_min:
            return "K1-bf16"
        if metric is Metric.DotProduct and not take_min:
            return "K5"
        if metric is Metric.Euclidean and take_min:
            return "K5"
        raise ValueError(f"no certificate for {metric} with take_min={take_min}")
    check_precision(prec)
    if prec in ONE_PASS:
        mode = "K6"
    else:
        mode = "K4" if (fast or prec == "high") else "K3"
    return mode if storage_dtype == torch.float32 else f"{mode}-bf16"


def bins_alive_from_chunk_mask(chunk_mask: torch.Tensor, chunk_size: int, n_pad: int):
    """[n_chunks] chunk mask -> [n_bins] bin-alive flags (OR of overlaps),
    :func:`scoring.tiles_alive_from_chunk_mask` at 512-row bins."""
    return tiles_alive_from_chunk_mask(chunk_mask, chunk_size, n_pad, BIN)


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


def _scan_masks(valid, row_mask, bin_alive, q_valid, b: int, dev):
    """-> (q_ok[b], rmask01[n_pad], surv, n_surv): the kernels' query and row
    masks as f32 0 / 1 and the survivor list of the live bins."""
    q_ok = torch.ones(b, device=dev) if q_valid is None else q_valid.to(torch.float32)
    rmask01 = valid.to(torch.float32)
    if row_mask is not None:
        rmask01 = rmask01 * row_mask.to(torch.float32)
    return (q_ok, rmask01, *survivor_bins(bin_alive))


def _check_operands(kernel: str, q, n_pad: int, operands) -> None:
    """Raise unless every (name, tensor, dtype, shape) operand matches, lies
    on q's device and is contiguous (the rows ``v``: each row contiguous,
    as the store's depth-padded view is), and the rows are whole bins."""
    for name, t, dtype, shape in operands:
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"{kernel}: {name} must be {dtype} {shape}, got {t.dtype} {tuple(t.shape)}"
            )
        if t.device != q.device:
            raise ValueError(f"{kernel}: {name} is on {t.device}, q on {q.device}")
        if not (t.stride(-1) == 1 if name == "v" else t.is_contiguous()):
            raise ValueError(f"{kernel}: {name} must be contiguous")
    if n_pad % BIN:
        raise ValueError(f"{kernel}: n_pad={n_pad} is not a multiple of {BIN}")


def stored_depth(v) -> int:
    """The depth of the rows ``v`` as the kernels read them: their row
    stride, the logical depth padded to a multiple of 16 by the store
    (``scoring.pad_depth``). Raise for rows stored otherwise."""
    n, d = v.shape
    dp = v.stride(0) if n > 1 else pad_depth(d)
    if v.stride(1) != 1 or dp % DEPTH_ALIGN or dp < d:
        raise ValueError(
            f"rows of depth {d} must be stored with their depth padded to a multiple of "
            f"{DEPTH_ALIGN} (row stride {v.stride(0)}): build them through scoring.materialize*"
        )
    return dp


@functools.lru_cache(maxsize=None)
def _kernel_fns(source: str, entry: str, n_ptrs: int, n_ints: int):
    """The (smem_bytes, launch) C functions ``{entry}_smem_bytes`` and
    ``{entry}_launch`` of a built kernel library with their signatures
    declared: launch takes n_ptrs pointers, n_ints ints and the stream.
    Built on the first call, never at import."""
    from .. import kernels

    lib = kernels.load(source)
    smem = getattr(lib, f"{entry}_smem_bytes")
    smem.argtypes = [ctypes.c_int]
    smem.restype = ctypes.c_size_t
    launch = getattr(lib, f"{entry}_launch")
    launch.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints + [ctypes.c_void_p]
    launch.restype = ctypes.c_int
    return smem, launch


def _launch(wrapper, source, entry, q, v, ptrs, ints, d, split=False, wide=False):
    """Launch ``entry`` of ``source`` on q's stream with the pointers
    ``ptrs`` (q and v first) and the output [n_bins, b], pre-filled with
    -inf, then n_bins, d (the rows' stored depth, :func:`stored_depth`) and
    the ints ``ints`` (b first). ``q`` is already padded to whole query
    blocks and at least to depth d; b is the real batch. Raises if the
    kernel cannot build or launch; counts the launch on
    ``wrapper.launches``, on ``wrapper.split_launches`` too where the sm90
    plan is ``split`` (:attr:`ScanPlan.split`), and on
    ``wrapper.wide_launches`` where it is the pair plan (``wide``, 128
    queries a CTA: :attr:`ScanGeometry.wide`)."""
    b = ints[0]
    assert d % DEPTH_ALIGN == 0, d
    if v.data_ptr() % 16 or q.data_ptr() % 16:
        raise ValueError(f"{entry}: q and v must start on a 16-byte boundary")
    smem_bytes, launch = _kernel_fns(source, entry, len(ptrs) + 1, len(ints) + 2)
    smem = smem_bytes(d)
    if smem > _SMEM_MAX:
        # kernel_takes routes such shapes away before any launch
        raise ValueError(f"{entry}: d={d} needs {smem} B of shared memory (> 227 KB)")
    n_bins = v.shape[0] // BIN
    out = torch.full((n_bins, b), _NEG_INF, device=q.device)
    if n_bins == 0 or b == 0:
        return out
    err = launch(
        *(t.data_ptr() for t in ptrs), out.data_ptr(), n_bins, d, *ints,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {err}")
    wrapper.launches += 1
    wrapper.split_launches += split
    wrapper.wide_launches += wide
    return out


def _on_card(name, q) -> bool:
    """False for a CPU tensor (the plain version serves it), True for a
    CUDA one; raise for any other device."""
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    return True


# ---------------------------------------------------------------------------
# K1: certified Cosine (int8 or bfloat16 rows)
# ---------------------------------------------------------------------------


def cert_cos_binmax_plain(q, v, inv, rmask, lane_a, q_inv, q_ok, thr, surv, n_surv,
                          cmp: Optional[Cmp] = None, slab_bins: int = 256):
    """The K1 function in plain torch: [n_bins, b] per-bin maxima of

        key = where(ok, (dot * q_inv) * inv, -inf) + lane_a,
        ok  = rmask > 0 & q_ok > 0 & !isnan(score) & cmp(score, thr),

    with dot the f32 product of the bf16-rounded queries and the stored
    (int8 or bf16) rows, exact products summed in f32, over the live bins
    ``surv[:n_surv]`` only; dead bins stay -inf. Slabs of ``slab_bins``
    bins bound the temporaries."""
    require_full_f32(q)
    b = q.shape[0]
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


# ---------------------------------------------------------------------------
# The Hopper scan's plans and launch geometry (csrc/cert_scan_sm90.cuh):
# every kernel of KERNELS and the probes
# ---------------------------------------------------------------------------

# CTAs of 64 queries, a persistent grid, a ring of [rows x k-block] stages
# in shared memory beside the resident query block (or, for deep rows, with
# the query k-blocks in the stages). The CTAs of a batch's query blocks sit
# side by side on the same bins and share the rows through L2.
SM90_MAX_STAGES = 12
_TK = 64  # the depth of a k-block of bf16 (and f32) queries, the fragment orders'


def kblock_depth(q_bytes: int) -> int:
    """The depth of a k-block (the C side's ``sm90::kdepth``): 64, or 128
    for int8 queries, whose k-blocks are then 128 B a row as bf16 ones."""
    return 128 if q_bytes == 1 else 64


def stage_depth(row_bytes: int, q_bytes: int) -> int:
    """The depth of a ring stage's k-block (the C side's
    ``sm90::stage_depth``): the queries' k-block, except under f32 queries
    (K3's FFMA consumers), whose stages carry one 128-byte box of rows, 32
    f32 or 64 bf16 deep, with the queries of the same depth."""
    return 128 // row_bytes if q_bytes == 4 else kblock_depth(q_bytes)


class ScanShape(NamedTuple):
    """An sm90 kernel's stages: ``row_bytes`` of an element of the row
    planes a stage holds (4 for both bf16x3 kernels: K4's f32 rows, split
    in registers; k_planes' VH and VL), its query ``planes``, the ``wide``
    and ``narrow`` stage shapes (ks k-blocks, rows) (no wide shape, None,
    the C side's KS1 = 0: no resident plan, the narrow shape streamed at
    every depth), ``q_bytes`` of a query element (1: K2's int8, 4: K3's
    f32, else bf16) and the stage shape of its ``pair`` plan (None: no pair
    plan; :func:`sm90_queries`)."""

    row_bytes: int
    planes: int
    wide: Optional[tuple]
    narrow: tuple
    q_bytes: int = 2
    pair: Optional[tuple] = None


# kernel -> its stages: the C sides' shapes (cert_cos_binmax.cu Shape,
# cert_fold_binmax.cu, bf16_binmax.cu Shape, bf16x3_binmax.cu Shape,
# int8_binmax.cu, f32_binmax.cu, profile_probes.cu)
SM90_SHAPES = {
    "K1": ScanShape(1, 1, (2, 128), (1, 128), pair=(1, 256)),
    "K1-bf16": ScanShape(2, 1, (1, 256), (1, 128)),
    "K2": ScanShape(1, 1, (1, 256), (1, 128), q_bytes=1),
    # the FFMA consumers' stages: sm90::ffma_rows, 256 f32 or 128 bf16 rows
    "K3": ScanShape(4, 1, None, (1, 256), q_bytes=4),
    "K3-bf16": ScanShape(2, 1, None, (1, 128), q_bytes=4),
    "K5": ScanShape(2, 1, (2, 128), (1, 128)),
    "K6": ScanShape(4, 1, (1, 128), (1, 64)),
    "K6-bf16": ScanShape(2, 1, (1, 256), (1, 128)),
    "K4": ScanShape(4, 2, None, (1, 128), pair=(1, 128)),
    "K4-bf16": ScanShape(2, 2, None, (1, 128)),
    "k_planes": ScanShape(4, 2, None, (1, 128)),
    "k_mm": ScanShape(4, 1, None, (1, 256), q_bytes=4),
    "k_mm_bins": ScanShape(4, 1, None, (1, 256), q_bytes=4),
}


class ScanPlan(NamedTuple):
    """A launch's ring: ``stages`` stages of ``ks`` k-blocks of ``rows``
    rows; ``streamed``: the query k-blocks ride in the stages (deep rows)
    instead of the resident query block, past its first ``resident``
    k-blocks (the query k-blocks kept in shared memory: all of them when not
    streamed, 0 on the deep-row plan, the head on the split plan and on the
    pair plan over int8 rows, :class:`PairPlan`)."""

    ks: int
    rows: int
    stages: int
    streamed: bool
    resident: int

    @property
    def split(self) -> bool:
        """The split plan: the query block's head resident, its tail
        streamed."""
        return self.streamed and self.resident > 0


class PairPlan(ScanPlan):
    """The ring of the pair plan (:func:`sm90_queries`): never the split
    plan, though over int8 rows it keeps the head of the pair's query
    block resident and streams the rest."""

    __slots__ = ()
    split = False


class ScanGeometry(NamedTuple):
    """How an sm90 kernel covers a batch: ``n_qb`` 64-query blocks, the
    ``queries`` of a CTA (64, or :data:`PAIR_QUERIES` on the pair plan:
    :func:`sm90_queries`), so ``n_qp`` groups of them (the batch padded to
    whole groups), ``per_group`` persistent CTAs per group, the query depth
    padded to ``dq``, its ring (:class:`ScanPlan`) in ``smem`` bytes of
    shared memory, its query ``planes`` (2: :func:`query_planes`), and
    ``f16``: K1 over int8 rows on the pair plan, whose queries
    :func:`sm90_pad_queries` rewrites to f16 pair by pair
    (:func:`f16_queries`) for the ``*_pair`` entry."""

    n_qb: int
    per_group: int
    dq: int
    ks: int
    rows: int
    stages: int
    streamed: bool
    resident: int
    smem: int
    planes: int = 1
    queries: int = QUERY_BLOCK
    f16: bool = False

    @property
    def n_qp(self) -> int:
        """The CTAs' query groups: n_qb blocks, or their pairs."""
        return -(-self.n_qb * QUERY_BLOCK // self.queries)

    @property
    def wide(self) -> bool:
        """The pair plan: 128 queries a CTA."""
        return self.queries == PAIR_QUERIES

    @property
    def n_ctas(self) -> int:
        return self.n_qp * self.per_group

    @property
    def plan(self) -> ScanPlan:
        """Its ring: a :class:`PairPlan` where ``wide``."""
        return (PairPlan if self.wide else ScanPlan)(
            self.ks, self.rows, self.stages, self.streamed, self.resident)

    @property
    def split(self) -> bool:
        return self.plan.split


def sm90_smem_bytes(d: int, row_bytes: int, stages: int, ks: int, rows: int,
                    streamed: bool = False, planes: int = 1, q_bytes: int = 2,
                    resident: int = 0, queries: int = QUERY_BLOCK) -> int:
    """The scan's dynamic shared memory (the C side's ``sm90::smem_bytes``,
    and ``sm90::pair_smem_bytes`` at 128 ``queries``): 1 KB of alignment
    slack, the resident query blocks (the CTA's queries of one k-block of
    ``q_bytes`` elements per k-block and query plane: 8 KB for 64 bf16 or
    int8 queries; when streamed, only the first ``resident``), the ring of
    ``stages`` stages of ``ks`` [rows x :func:`stage_depth`] row tiles (each
    with room for its queries of that depth when streamed), the per-query
    maxima and scales with the f16 flag, and the barriers."""
    kd = kblock_depth(q_bytes)
    nk = -(-d // kd)
    qblock = planes * queries * kd * q_bytes
    sd = stage_depth(row_bytes, q_bytes)
    stage = ks * (rows * sd * row_bytes + (planes * queries * sd * q_bytes if streamed else 0))
    return (1024 + (resident if streamed else nk) * qblock + stages * stage
            + 2 * queries * 4 + 8 + (2 * stages + 1) * 8)


def sm90_stages(d: int, row_bytes: int, ks: int, rows: int, streamed: bool = False,
                planes: int = 1, q_bytes: int = 2, resident: int = 0,
                queries: int = QUERY_BLOCK) -> int:
    """The most ring stages that fit, up to SM90_MAX_STAGES and never below
    2: an even number (the two consumer warpgroups take alternate stages),
    or any on the pair plan (128 ``queries``), whose stages both take."""
    step = 1 if queries == PAIR_QUERIES else 2
    s = SM90_MAX_STAGES
    while s > 2 and sm90_smem_bytes(d, row_bytes, s, ks, rows, streamed, planes,
                                    q_bytes, resident, queries) > _SMEM_MAX:
        s -= step
    return s


def sm90_queries(mode: str, b: int) -> int:
    """The queries of a CTA of ``mode`` at a batch of ``b``: 128 on the
    pair plan (a pair of query blocks, the C side's ``sm90::scan_pair`` /
    ``scan_pair_s8``), K4's over f32 rows at every batch size (at b <= 64
    half of them padding, and still faster there than 64 a CTA) and K1's
    over int8 rows from b = :data:`K1_PAIR_FROM`, two query blocks (at b <=
    64 the 64-query plan measured faster: PERF.md); 64 otherwise."""
    if SM90_SHAPES[mode].pair is not None and (mode != "K1" or b >= K1_PAIR_FROM):
        return PAIR_QUERIES
    return QUERY_BLOCK


def sm90_plan(mode: str, d: int, b: int) -> ScanPlan:
    """The ring of ``mode`` (a key of :data:`SM90_SHAPES`) at stored depth
    ``d`` and a batch of ``b``. On the pair plan (:func:`sm90_queries`) its
    stage shape (``ScanShape.pair``) streamed with the pair's query
    k-blocks, as many stages as fit, at every depth: K4's 3 stages of 64 KB
    (the C side's ``sm90::pair_stages``); over int8 rows (K1) 256 rows a
    stage (32 KB with the queries) beside the head of the pair's query
    block, the largest that leaves :data:`PAIR_MIN_STAGES` stages (16 KB a
    k-block; ``sm90::pair_s8_resident``: 6 at d >= 384, so 4 stages).
    Otherwise the C side's
    ``sm90::plan_for``: the wide stage shape when 4
    stages of it fit beside the resident query block (of every query
    plane), else the narrow one when 2 fit, else the narrow one with the
    query block streamed (any d); a mode with no wide shape always streams.
    Where the narrow plan would keep fewer than 4 stages, a mode over bf16
    rows with one query plane (the C side's ``sm90::splits``; K1 over int8
    rows needs the whole block resident for its f16 products) keeps only
    the head of the query block resident instead, the largest that leaves
    4 stages of the wide shape, else of the narrow one, and streams the
    rest."""
    row_bytes, planes, wide, narrow, qb, pair = SM90_SHAPES[mode]
    nk = -(-d // kblock_depth(qb))
    if sm90_queries(mode, b) == PAIR_QUERIES:
        kw = dict(streamed=True, planes=planes, q_bytes=qb, queries=PAIR_QUERIES)
        r = 0
        if row_bytes == 1:
            r = next((r for r in range(nk, 0, -1) if sm90_smem_bytes(
                d, row_bytes, PAIR_MIN_STAGES, *pair, resident=r, **kw) <= _SMEM_MAX), 0)
        return PairPlan(*pair, sm90_stages(d, row_bytes, *pair, resident=r, **kw), True, r)

    def fits(ks_rows, stages, streamed=False, resident=0):
        return sm90_smem_bytes(d, row_bytes, stages, *ks_rows, streamed, planes, qb,
                               resident) <= _SMEM_MAX

    if wide is not None:
        if fits(wide, 4):
            return ScanPlan(*wide, sm90_stages(d, row_bytes, *wide, planes=planes, q_bytes=qb),
                            False, nk)
        if fits(narrow, 2):
            if row_bytes == 2 and planes == 1 and not fits(narrow, 4):
                for ks_rows in (wide, narrow):
                    r = next((r for r in range(nk - 1, 0, -1) if fits(ks_rows, 4, True, r)), 0)
                    if r:
                        return ScanPlan(*ks_rows, sm90_stages(d, row_bytes, *ks_rows, True,
                                                              planes, qb, r), True, r)
            return ScanPlan(*narrow,
                            sm90_stages(d, row_bytes, *narrow, planes=planes, q_bytes=qb), False,
                            nk)
    return ScanPlan(*narrow, sm90_stages(d, row_bytes, *narrow, True, planes, qb), True, 0)


def sm90_geometry(mode: str, b: int, d: int, n_sms: int) -> ScanGeometry:
    """The launch of ``mode`` for a batch of ``b`` queries over rows of
    stored depth ``d`` on a card of ``n_sms`` SMs. The shared memory admits
    one CTA per SM, so each query group (a block, or a pair of blocks on
    the pair plan) gets an equal share of the SMs, at least one CTA (a
    group's planes share its CTAs)."""
    n_qb = max(1, -(-b // QUERY_BLOCK))
    queries = sm90_queries(mode, b)
    n_qp = -(-n_qb * QUERY_BLOCK // queries)
    shape = SM90_SHAPES[mode]
    kd = kblock_depth(shape.q_bytes)
    return ScanGeometry(n_qb, max(1, n_sms // n_qp), -(-d // kd) * kd, *sm90_plan(mode, d, b),
                        kernel_smem_bytes(mode, d, b), shape.planes, queries,
                        mode == "K1" and queries == PAIR_QUERIES)


def _fragment_perm(dq: int, t, kk, e) -> torch.Tensor:
    """[dq] gather index putting stored row element p = 0..63 of every
    64-deep block, loaded by lane t = lane % 4 into register e of its A
    fragment's 16-deep step kk, at wgmma depth 16 kk + 2 t + (0, 1, 8, 9)[e]
    (the m16n8k16 layout): ``q_kernel[:, j] = q[:, perm[j]]``."""
    p = torch.arange(_TK)
    block = torch.empty(_TK, dtype=torch.int64)
    block[16 * kk + 2 * t + torch.tensor([0, 1, 8, 9])[e]] = p
    return (torch.arange(0, dq, _TK)[:, None] + block).reshape(-1)


@functools.lru_cache(maxsize=None)
def k1_query_perm(dq: int, device: torch.device = torch.device("cpu")) -> torch.Tensor:
    """[dq] gather index of the int8-row K1's queries: within every 64-deep
    block, stored row byte p = 16 t + 4 kk + e (t = lane % 4 of the thread
    that loads it, kk its 16-deep step, e = 0..3) sits at wgmma depth
    16 kk + 2 t + (0, 1, 8, 9)[e] of the thread's A fragment, so the query
    element p goes there too. Made once per depth and device (callers read
    it, never write it)."""
    p = torch.arange(_TK)
    return _fragment_perm(dq, p // 16, (p % 16) // 4, p % 4).to(device)


@functools.lru_cache(maxsize=None)
def f32_query_perm(dq: int, device: torch.device = torch.device("cpu")) -> torch.Tensor:
    """[dq] gather index of K6's queries over f32 rows: a 64-deep f32
    k-block lands as two halves of 32 (eight 16-byte chunks c each), and
    lane t loads, for its step kk, chunk 2 t + kk % 2 of half kk // 2, so
    stored element p = 32 h + 4 c + e (t = c // 2, kk = 2 h + c % 2) sits at
    wgmma depth 16 kk + 2 t + (0, 1, 8, 9)[e]."""
    p = torch.arange(_TK)
    h, c, e = p // 32, (p % 32) // 4, p % 4
    return _fragment_perm(dq, c // 2, 2 * h + c % 2, e).to(device)


def query_planes(q):
    """The two bf16 query planes of K4 (and of the probe k_planes),
    stacked: [2 b, d] with qh = bf16(q) in rows [0, b) and ql = bf16(q -
    qh) in [b, 2 b), each rounded to nearest even (JAX's ``astype``; the
    f32 difference is exact). Zero queries and columns give zero planes,
    so padding commutes with the split."""
    qh = q.to(torch.bfloat16)
    ql = (q - qh.float()).to(torch.bfloat16)
    return torch.cat([qh, ql])


def f16_queries(qk):
    """K1's f16 products over int8 rows on the pair plan, decided for each
    pair of query blocks by the rule that the C side's
    ``sm90::queries_to_f16`` applies in the kernel to the resident block of
    the 64-query plan, and applied to ``qk`` in place. Each query (a row of
    the padded, permuted bf16 queries ``qk``, [n * 128, dq]) is scaled by
    2^s, s = 141 - e with e the biased exponent of its largest magnitude (s
    = 0 for a zero query), which puts that magnitude in [2^14, 2^15). A pair
    takes f16 if every query's largest magnitude is finite with s <= 126 (so
    2^-s is a normal float) and every element x comes back exactly:
    f16(x 2^s) = x 2^s and f16(x 2^s) 2^-s = x in f32; its rows of ``qk``
    then hold the f16 bits of x 2^s. -> (qk; [n * 128] f32 2^-s, 1 for a
    query that fails; [n] int32 flags, 1 where the pair takes f16). On the
    card one launch of ``cert_cos_binmax_f16_queries`` (csrc/
    cert_cos_binmax.cu), no host synchronisation; these torch ops on the
    CPU."""
    group = PAIR_QUERIES
    n, dq = qk.shape[0] // group, qk.shape[1]
    if qk.device.type == "cuda":
        unscale = torch.empty(qk.shape[0], device=qk.device)
        flags = torch.empty(n, dtype=torch.int32, device=qk.device)
        err = _f16_fn()(qk.data_ptr(), unscale.data_ptr(), flags.data_ptr(), n, dq,
                        torch.cuda.current_stream(qk.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"cert_cos_binmax_f16_queries failed: CUDA error {err}")
        return qk, unscale, flags
    m = (qk.view(torch.int16) & 0x7FFF).amax(1).int()  # the largest magnitude's bf16 bits
    s = torch.where(m == 0, 0, 141 - (m >> 7))
    ok = (m < 0x7F80) & (s <= 126)
    s = torch.where(ok, s, 0)
    up = ((127 + s) << 23).view(torch.float32)[:, None]
    down = ((127 - s) << 23).view(torch.float32)
    x = qk.float()
    h = (x * up).half()
    hf = h.float()
    good = ((hf == x * up) & (hf * down[:, None] == x)).view(n, -1).all(1)
    flag = good & ok.view(n, group).all(1)
    qk.view(n, group, dq)[flag] = h.view(torch.bfloat16).view(n, group, dq)[flag]
    return qk, down, flag.int()


@functools.lru_cache(maxsize=None)
def _f16_fn():
    """The C function ``cert_cos_binmax_f16_queries`` (q, unscale, flags,
    n_groups, dq, stream), built on the first call."""
    from .. import kernels

    fn = kernels.load("cert_cos_binmax").cert_cos_binmax_f16_queries
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def sm90_pad_queries(q, per_query, geom: ScanGeometry, perm=None):
    """An sm90 kernel's query operands: the batch padded to ``geom.n_qp``
    groups of ``geom.queries`` (padded lanes zero, so q_ok = 0 keeps them
    out of every bin max), the depth to ``geom.dq`` with zeros, the depth
    of each 64-deep block gathered by ``perm`` (:func:`k1_query_perm` over
    int8 rows, :func:`f32_query_perm` over f32 rows), with two
    ``geom.planes`` the padded f32 queries split into them
    (:func:`query_planes`), and with ``geom.f16`` (K1 over int8 rows on the
    pair plan) each pair rewritten to f16 where it takes f16 products
    (:func:`f16_queries`), its 2^-s and flags appended to ``per_query`` ->
    (q, per_query)."""
    b, d = q.shape
    pad = geom.n_qp * geom.queries - b
    qk = q if (pad, geom.dq) == (0, d) else torch.nn.functional.pad(q, (0, geom.dq - d, 0, pad))
    if perm is not None:
        qk = qk.index_select(1, perm)
    if geom.planes == 2:
        qk = query_planes(qk)
    if pad:
        per_query = tuple(torch.nn.functional.pad(t, (0, pad)) for t in per_query)
    if geom.f16:  # in place: the gathered copy (K1 over int8 rows always has perm)
        assert perm is not None
        qk, unscale, flags = f16_queries(qk.contiguous())
        per_query = (*per_query, unscale, flags)
    return qk.contiguous(), tuple(per_query)


@functools.lru_cache(maxsize=None)
def _n_sms(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _sm90_launch(wrapper, mode, source, entry, q, v, per_query, ptrs, ints, perm=None):
    """Launch the sm90 kernel of ``mode``: its geometry at the rows' stored
    depth, the queries padded (gathered by ``perm(dq, device)``, split into
    the geometry's planes, rewritten to f16 for K1's ``entry_pair`` on the
    pair plan), then ``_launch`` with the pointers q, v, ``ptrs[0]``, the
    padded ``per_query`` operands, ``ptrs[1]`` and the ints b, dq, n_qb,
    per_group, ``ints``."""
    dp = stored_depth(v)
    dev = q.device.index if q.device.index is not None else torch.cuda.current_device()
    geom = sm90_geometry(mode, q.shape[0], dp, _n_sms(dev))
    qk, pq = sm90_pad_queries(q, per_query, geom,
                              None if perm is None else perm(geom.dq, q.device))
    head, tail = ptrs
    return _launch(
        wrapper, source, f"{entry}_pair" if geom.f16 else entry, qk, v, [qk, v, *head, *pq, *tail],
        [q.shape[0], geom.dq, geom.n_qb, geom.per_group, *ints], dp, geom.split, geom.wide,
    )


def _cert_cos(wrapper, entry, vdtype, q, v, inv, rmask, lane_a, q_inv, q_ok, thr,
              surv, n_surv, cmp):
    b, d = q.shape
    n_pad = v.shape[0]
    _check_operands(entry, q, n_pad, [
        ("q", q, torch.bfloat16, (b, d)),
        ("v", v, vdtype, (n_pad, d)),
        ("inv", inv, torch.float32, (n_pad,)),
        ("rmask", rmask, torch.float32, (n_pad,)),
        ("lane_a", lane_a, torch.float32, (n_pad,)),
        ("q_inv", q_inv, torch.float32, (b,)),
        ("q_ok", q_ok, torch.float32, (b,)),
        ("thr", thr, torch.float32, (1,)),
        ("surv", surv, torch.int32, (n_pad // BIN,)),
        ("n_surv", n_surv, torch.int32, (1,)),
    ])
    if cmp not in (None, Cmp.Gt, Cmp.Gte):
        raise ValueError(f"{entry}: certified Cosine takes no {cmp} score filter")
    if not _on_card(entry, q):
        return cert_cos_binmax_plain(q, v, inv, rmask, lane_a, q_inv, q_ok, thr, surv,
                                     n_surv, cmp)
    if any(t.data_ptr() % 16 for t in (inv, rmask, lane_a)):
        raise ValueError(f"{entry}: inv, rmask and lane_a must start on a 16-byte boundary")
    mode = "K1" if vdtype == torch.int8 else "K1-bf16"
    return _sm90_launch(
        wrapper, mode, "cert_cos_binmax", entry, q, v, (q_inv, q_ok),
        ([inv, rmask, lane_a], [thr, surv, n_surv]), [_CMP_CODE[cmp]],
        perm=k1_query_perm if vdtype == torch.int8 else None,
    )


def cert_cos_binmax(q, v, inv, rmask, lane_a, q_inv, q_ok, thr, surv, n_surv,
                    cmp: Optional[Cmp] = None):
    """K1 bin maxima over int8 rows (see :func:`cert_cos_binmax_plain`).

    CPU tensors take the plain version; CUDA tensors launch the Hopper
    kernel (csrc/cert_cos_binmax.cu; at more than one query block the
    entry ``cert_cos_binmax_pair``, the pair plan) and raise if it cannot
    build or launch. ``cert_cos_binmax.launches`` counts kernel launches
    (``.split_launches`` those on the split plan, ``.wide_launches`` those
    on the pair plan)."""
    return _cert_cos(cert_cos_binmax, "cert_cos_binmax", torch.int8, q, v, inv, rmask,
                     lane_a, q_inv, q_ok, thr, surv, n_surv, cmp)


def cert_cos_binmax_bf16(q, v, inv, rmask, lane_a, q_inv, q_ok, thr, surv, n_surv,
                         cmp: Optional[Cmp] = None):
    """K1 bin maxima over bfloat16 rows: the same function and kernel
    source as :func:`cert_cos_binmax`, the rows loaded as bf16 (no
    conversion). ``.launches`` counts kernel launches (``.split_launches``
    those on the split plan)."""
    return _cert_cos(cert_cos_binmax_bf16, "cert_cos_binmax_bf16", torch.bfloat16, q, v,
                     inv, rmask, lane_a, q_inv, q_ok, thr, surv, n_surv, cmp)


# ---------------------------------------------------------------------------
# K5: the general certified fold (bfloat16 rows, Dot and Euclid)
# ---------------------------------------------------------------------------


def _general_fold(key, c0, c1, c2, lane_a, vn, lane_b):
    """key + c0 + c1*lane_a + c2*||v|| + lane_b, each op rounded in JAX's
    order: (((key + c0) + c1*lane_a) + c2*vn) + lane_b."""
    return key + c0 + c1 * lane_a + c2 * vn + lane_b


def cert_fold_binmax_plain(q, v, inv, nsq, rmask, lane_a, lane_b, q_inv, q_sq, q_ok,
                           c0, c1, c2, thr, surv, n_surv, *, metric: Metric,
                           take_min: bool, cmp: Optional[Cmp], slab_bins: int = 256):
    """The K5 function in plain torch: [n_bins, b] per-bin maxima of

        key = where(ok, score, -inf) (negated for take_min)
              + c0 + c1*lane_a + c2*sqrt(nsq) + lane_b,
        ok  = rmask > 0 & q_ok > 0 & !isnan(score) & cmp(score, thr),

    with the score of the metric over the f32 dots of the bf16-rounded
    queries and the bf16 rows (exact products, f32 sums); per-query c0 /
    c1 / c2, per-row lanes; live bins only, dead bins -inf."""
    require_full_f32(q)
    b = q.shape[0]
    n_bins = v.shape[0] // BIN
    out = torch.full((n_bins, b), _NEG_INF, device=q.device)
    live = surv[: int(n_surv[0])].long()
    q32 = q.float()
    ar = torch.arange(BIN, device=q.device)
    for s in range(0, live.shape[0], slab_bins):
        bins = live[s : s + slab_bins]
        rows = (bins[:, None] * BIN + ar[None, :]).reshape(-1)
        dots = q32 @ v[rows].float().T
        score = _scores(dots, q_inv[:, None], q_sq[:, None], inv[rows][None, :],
                        nsq[rows][None, :], metric)
        ok = (rmask[rows] > 0)[None, :] & (q_ok > 0)[:, None] & ~torch.isnan(score)
        if cmp is not None:
            ok = ok & _filter_ok(score, thr[0], cmp)
        key = _general_fold(
            _masked_key(score, ok, take_min), c0[:, None], c1[:, None], c2[:, None],
            lane_a[rows][None, :], torch.sqrt(nsq[rows])[None, :], lane_b[rows][None, :],
        )
        out[bins] = key.reshape(b, -1, BIN).amax(dim=2).T
    return out


def cert_fold_binmax(q, v, inv, nsq, rmask, lane_a, lane_b, q_inv, q_sq, q_ok, c0, c1,
                     c2, thr, surv, n_surv, metric: Metric = Metric.DotProduct,
                     take_min: bool = False, cmp: Optional[Cmp] = None):
    """K5 bin maxima (see :func:`cert_fold_binmax_plain`). CPU tensors take
    the plain version; CUDA tensors launch csrc/cert_fold_binmax.cu or
    raise. ``.launches`` counts kernel launches (``.split_launches`` those on
    the split plan)."""
    b, d = q.shape
    n_pad = v.shape[0]
    per_query = [("q_inv", q_inv), ("q_sq", q_sq), ("q_ok", q_ok), ("c0", c0),
                 ("c1", c1), ("c2", c2)]
    _check_operands("cert_fold_binmax", q, n_pad, [
        ("q", q, torch.bfloat16, (b, d)),
        ("v", v, torch.bfloat16, (n_pad, d)),
        *((name, t, torch.float32, (n_pad,)) for name, t in (
            ("inv", inv), ("nsq", nsq), ("rmask", rmask), ("lane_a", lane_a),
            ("lane_b", lane_b))),
        *((name, t, torch.float32, (b,)) for name, t in per_query),
        ("thr", thr, torch.float32, (1,)),
        ("surv", surv, torch.int32, (n_pad // BIN,)),
        ("n_surv", n_surv, torch.int32, (1,)),
    ])
    if metric not in (Metric.DotProduct, Metric.Euclidean):
        raise ValueError(f"cert_fold_binmax: the general fold takes Dot or Euclid, not {metric}")
    if (metric is Metric.Euclidean) != bool(take_min):
        raise ValueError("cert_fold_binmax: Euclid is take-min, Dot take-max")
    allowed = (None, Cmp.Lt, Cmp.Lte) if take_min else (None, Cmp.Gt, Cmp.Gte)
    if cmp not in allowed:
        raise ValueError(f"cert_fold_binmax: no {cmp} score filter with take_min={take_min}")
    if not _on_card("cert_fold_binmax", q):
        return cert_fold_binmax_plain(
            q, v, inv, nsq, rmask, lane_a, lane_b, q_inv, q_sq, q_ok, c0, c1, c2, thr,
            surv, n_surv, metric=metric, take_min=take_min, cmp=cmp,
        )
    # Dot and Euclid read neither inv nor q_inv
    return _sm90_launch(
        cert_fold_binmax, "K5", "cert_fold_binmax", "cert_fold_binmax", q, v,
        (q_sq, q_ok, c0, c1, c2), ([nsq, rmask, lane_a, lane_b], [thr, surv, n_surv]),
        [_METRIC_CODE[metric], _CMP_CODE[cmp]],
    )


for _fn in (cert_cos_binmax, cert_cos_binmax_bf16, cert_fold_binmax):
    _fn.launches = _fn.split_launches = _fn.wide_launches = 0


# ---------------------------------------------------------------------------
# K2 / K3 / K4 / K6: the uncertified modes
# ---------------------------------------------------------------------------

# kernel name -> (csrc source, C entry, query dtype, row dtype); K6 takes
# its queries rounded to bf16, as K1 does
_MODES = {
    "K2": ("int8_binmax", "int8_binmax", torch.int8, torch.int8),
    "K3": ("f32_binmax", "f32_binmax", torch.float32, torch.float32),
    "K3-bf16": ("f32_binmax", "f32_binmax_bf16", torch.float32, torch.bfloat16),
    "K4": ("bf16x3_binmax", "bf16x3_binmax", torch.float32, torch.float32),
    "K4-bf16": ("bf16x3_binmax", "bf16x3_binmax_bf16", torch.float32, torch.bfloat16),
    "K6": ("bf16_binmax", "bf16_binmax", torch.bfloat16, torch.float32),
    "K6-bf16": ("bf16_binmax", "bf16_binmax_bf16", torch.bfloat16, torch.bfloat16),
}


def _exact_int8_dots(q8, v8):
    """int8 x int8 dots, exact: every partial sum is an integer of magnitude
    <= 127^2 d, exact in f32 below 2^24 (d <= 1040) and in f64 beyond."""
    d = q8.shape[-1]
    dt = torch.float32 if 127 * 127 * d < (1 << 24) else torch.float64
    return (q8.to(dt) @ v8.to(dt).transpose(-1, -2)).float()


def bf16x3_dots(q32, v):
    """The bf16x3 product qh.vh + qh.vl + ql.vh with JAX's splits
    (x_h = bf16(x), x_l = bf16(x - x_h)), each partial product exact in f32
    and summed in f32 in that order; the ql.vl term is dropped. bfloat16
    rows ``v`` are their own high plane (vl = 0), so qh.vl is identically
    zero and is skipped."""
    qh = q32.to(torch.bfloat16).float()
    ql = (q32 - qh).to(torch.bfloat16).float()
    if v.dtype == torch.bfloat16:
        vht = v.float().transpose(-1, -2)
        return qh @ vht + ql @ vht
    vh = v.to(torch.bfloat16).float()
    vl = (v - vh).to(torch.bfloat16).float()
    vht, vlt = vh.transpose(-1, -2), vl.transpose(-1, -2)
    return qh @ vht + qh @ vlt + ql @ vht


def _scores(dots, q_inv, q_sq, inv, nsq, metric: Metric):
    """The metric epilogue in JAX's order of ops: (dot * q_inv) * inv;
    (q_sq + nsq) - 2 dot; dot."""
    if metric is Metric.Cosine:
        return dots * q_inv * inv
    if metric is Metric.Euclidean:
        return q_sq + nsq - 2.0 * dots
    return dots


def _masked_key(scores, ok, take_min: bool):
    key = torch.where(ok, scores, float("inf") if take_min else _NEG_INF)
    return -key if take_min else key


def binmax_plain(mode: str, q, v, inv, nsq, rmask, q_inv, q_sq, q_ok, thr, surv,
                 n_surv, *, metric: Metric, take_min: bool, cmp: Optional[Cmp],
                 slab_bins: int = 256):
    """K2 / K3 / K4 / K6 (over f32 or bfloat16 rows) in plain torch:
    [n_bins, b] per-bin maxima of

        key = where(ok, score, -inf) (negated for take_min),
        ok  = rmask > 0 & q_ok > 0 & !isnan(score) & cmp(score, thr),

    over the live bins ``surv[:n_surv]`` only (dead bins stay -inf), with
    the dots of the mode: exact int32 for K2, full f32 for K3 (bf16 rows
    upcast exactly), bf16x3 for K4, one bf16 pass for K6 (its queries
    already bf16). Slabs of ``slab_bins`` bins bound the temporaries."""
    strict = mode.startswith("K3")
    if strict:
        require_full_f32(q)
    b = q.shape[0]
    n_bins = v.shape[0] // BIN
    out = torch.full((n_bins, b), _NEG_INF, device=q.device)
    live = surv[: int(n_surv[0])].long()
    ar = torch.arange(BIN, device=q.device)
    for s in range(0, live.shape[0], slab_bins):
        bins = live[s : s + slab_bins]
        rows = (bins[:, None] * BIN + ar[None, :]).reshape(-1)
        if mode == "K2":
            dots = _exact_int8_dots(q, v[rows])
        elif strict:
            dots = q @ v[rows].float().T
        elif mode.startswith("K6"):
            dots = one_pass_dots(q.float(), v[rows])
        else:
            dots = bf16x3_dots(q, v[rows])
        score = _scores(dots, q_inv[:, None], q_sq[:, None], inv[rows][None, :],
                        nsq[rows][None, :], metric)
        ok = (rmask[rows] > 0)[None, :] & (q_ok > 0)[:, None] & ~torch.isnan(score)
        if cmp is not None:
            ok = ok & _filter_ok(score, thr[0], cmp)
        key = _masked_key(score, ok, take_min)
        out[bins] = key.reshape(b, -1, BIN).amax(dim=2).T
    return out


def _binmax(mode, wrapper, q, v, inv, nsq, rmask, q_inv, q_sq, q_ok, thr, surv,
            n_surv, metric, take_min, cmp):
    source, entry, qdtype, vdtype = _MODES[mode]
    b, d = q.shape
    n_pad = v.shape[0]
    _check_operands(entry, q, n_pad, [
        ("q", q, qdtype, (b, d)),
        ("v", v, vdtype, (n_pad, d)),
        ("inv", inv, torch.float32, (n_pad,)),
        ("nsq", nsq, torch.float32, (n_pad,)),
        ("rmask", rmask, torch.float32, (n_pad,)),
        ("q_inv", q_inv, torch.float32, (b,)),
        ("q_sq", q_sq, torch.float32, (b,)),
        ("q_ok", q_ok, torch.float32, (b,)),
        ("thr", thr, torch.float32, (1,)),
        ("surv", surv, torch.int32, (n_pad // BIN,)),
        ("n_surv", n_surv, torch.int32, (1,)),
    ])
    if metric not in _METRIC_CODE:
        raise ValueError(f"{entry}: metric {metric} has no matmul form")
    if not _on_card(entry, q):
        return binmax_plain(
            mode, q, v, inv, nsq, rmask, q_inv, q_sq, q_ok, thr, surv, n_surv,
            metric=metric, take_min=take_min, cmp=cmp,
        )
    if mode == "K2" and 127 * 127 * d >= (1 << 31):
        raise ValueError(f"{entry}: d={d} could overflow the int32 dots")
    return _sm90_launch(
        wrapper, mode, source, entry, q, v, (q_inv, q_sq, q_ok),
        ([inv, nsq, rmask], [thr, surv, n_surv]),
        [_METRIC_CODE[metric], int(take_min), _CMP_CODE[cmp]],
        perm=f32_query_perm if mode in ("K6", "K4") else None,
    )


def _mode_wrapper(mode: str, doc: str):
    """The wrapper of an uncertified kernel: CPU tensors take
    :func:`binmax_plain`, CUDA tensors launch the kernel or raise;
    ``.launches`` counts kernel launches (``.split_launches`` those on the
    split plan, ``.wide_launches`` those on the pair plan)."""

    def wrapper(q, v, inv, nsq, rmask, q_inv, q_sq, q_ok, thr, surv, n_surv,
                metric: Metric = Metric.Cosine, take_min: bool = False,
                cmp: Optional[Cmp] = None):
        return _binmax(mode, wrapper, q, v, inv, nsq, rmask, q_inv, q_sq, q_ok, thr,
                       surv, n_surv, metric, take_min, cmp)

    wrapper.__name__ = wrapper.__qualname__ = _MODES[mode][1]
    wrapper.__doc__ = f"{doc} (see :func:`binmax_plain`). {_mode_wrapper.__doc__}"
    wrapper.launches = wrapper.split_launches = wrapper.wide_launches = 0
    return wrapper


int8_binmax = _mode_wrapper("K2", "K2 bin maxima: int8 queries x int8 rows, exact int32 dots")
f32_binmax = _mode_wrapper("K3", "K3 bin maxima: exact f32 dots on the CUDA cores")
f32_binmax_bf16 = _mode_wrapper(
    "K3-bf16", "K3 bin maxima over bfloat16 rows, upcast exactly: exact f32 dots")
bf16x3_binmax = _mode_wrapper("K4", "K4 bin maxima: bf16x3 dots on the tensor cores")
bf16x3_binmax_bf16 = _mode_wrapper(
    "K4-bf16", "K4 bin maxima over bfloat16 rows: qh.v + ql.v (the low plane of v is 0; "
    "the wrapper splits the f32 queries into the planes, :func:`query_planes`)")
bf16_binmax = _mode_wrapper(
    "K6", "K6 bin maxima: one bf16 pass, bf16 queries x f32 rows rounded to bf16")
bf16_binmax_bf16 = _mode_wrapper(
    "K6-bf16", "K6 bin maxima over bfloat16 rows: one bf16 pass, the rows as stored")

KERNELS = {
    "K1": cert_cos_binmax, "K1-bf16": cert_cos_binmax_bf16, "K2": int8_binmax,
    "K3": f32_binmax, "K3-bf16": f32_binmax_bf16, "K4": bf16x3_binmax,
    "K4-bf16": bf16x3_binmax_bf16, "K5": cert_fold_binmax, "K6": bf16_binmax,
    "K6-bf16": bf16_binmax_bf16,
}


def kernel_source(mode: str) -> str:
    """The ``csrc/`` source (without ``.cu``) that builds the kernel of
    ``mode`` (a key of :data:`KERNELS`)."""
    if mode.startswith("K1"):
        return "cert_cos_binmax"
    if mode == "K5":
        return "cert_fold_binmax"
    return _MODES[mode][0]


def kernel_smem_bytes(mode: str, d: int, b: int) -> int:
    """The dynamic shared memory the kernel of ``mode`` (a key of
    :data:`SM90_SHAPES`) asks for at stored depth ``d`` (a multiple of 16)
    and a batch of ``b``, mirroring its source's ``*_smem_bytes`` (K1's
    ``cert_cos_binmax_pair_smem_bytes`` on the pair plan): its plan's,
    which always fits."""
    plan = sm90_plan(mode, d, b)
    shape = SM90_SHAPES[mode]
    return sm90_smem_bytes(d, shape.row_bytes, plan.stages, plan.ks, plan.rows, plan.streamed,
                           shape.planes, shape.q_bytes, plan.resident, sm90_queries(mode, b))


def kernel_takes(mode: str, d: int) -> bool:
    """Does the kernel of ``mode`` take rows of logical depth ``d``? The
    port's counterpart of the JAX package's ``pallas_ok``, decided from the
    shape before any launch: the kernel's shared memory at the stored depth
    must fit a block (232,448 B) on each plan a batch may take (K1 over int8
    rows: the 64-query plan and the pair plan); unlike a TPU's VMEM budget
    it does not grow with the batch. Every kernel runs on the Hopper scan
    and takes any d (the deep-row plan streams the query block; K3, K4 and
    the pair plans stream theirs at every depth). ``OTTERS_DISABLE_PALLAS`` (JAX's name, so that a
    deployment's environment carries across) refuses every shape: the user
    asks for the scan programs by name, as the on-card differential fuzz
    (``differential_fuzz``) does. A shape it refuses goes to the scan
    program (``scoring.scan_topk_core``, torch ops on the same device), and
    the caller adds the batch's queries to ``kernel_takes.routed``."""
    if os.environ.get("OTTERS_DISABLE_PALLAS"):
        return False
    return all(kernel_smem_bytes(mode, pad_depth(d), b) <= _SMEM_MAX for b in (1, K1_PAIR_FROM))


kernel_takes.routed = 0  # queries sent to the scan program by shape


def reset_launches() -> None:
    """Set every kernel's launch counts (``launches``, ``split_launches``,
    ``wide_launches``), and the count of queries routed away from the
    kernels by shape, to 0."""
    for fn in KERNELS.values():
        fn.launches = fn.split_launches = fn.wide_launches = 0
    kernel_takes.routed = 0


def _winner_rows(top_slots, b: int, dev):
    """Flat slots (bin * b + query) -> (query of each slot, the [kb * 512]
    rows of the winning bins)."""
    bsel = top_slots // b
    rows_flat = (bsel[:, None] * BIN + torch.arange(BIN, device=dev)[None, :]).reshape(-1)
    return top_slots % b, rows_flat


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
    certify: bool = False,
    prec: str = "highest",
    fast: bool = False,
    resid=None,
    q_valid=None,
    with_maxima: bool = False,
):
    """Fused pruned scoring + top-k candidates.

    bin_alive: [n_pad / 512] bool — False bins are skipped entirely (no
    loads, no math). Soundness requires that every row of a dead bin fails
    ``row_mask`` (zonemap pruning guarantees this). ``thr`` is a device f32
    scalar. ``fast`` (f32 / bf16 rows, see :func:`fast_ok`) runs K4 with
    the phase-1 filter loosened by the bf16x3 error bound and examines 4k
    bins. ``certify`` (int8 or bf16 rows, with their ``resid``) runs K1 /
    K5 and returns the certificate's bound. ``prec`` is the store
    precision of uncertified f32 / bf16 rows ("default" / "bf16": K6, both
    phases one bf16 pass).

    Returns (rows[k], scores[k], valid[k], check, bound): ``check`` is False
    only when the fast mode cannot certify its answer (re-run with
    fast=False); ``bound`` is the certificate's bound, in the key space
    (negated for take_min), on the true score of every row not returned
    (-inf without certify). ``with_maxima`` (certify): a 6th output, the
    certificate terms' six maxima over these rows and the valid queries
    (:func:`~.scoring.cert_maxima`'s scalars), which a mesh composes its
    slack from."""
    mode = kernel_mode(vectors.dtype, metric, take_min, certify, prec, fast)
    if certify:
        return _fused_cert(mode, vectors, norms_sq, inv_norms, valid, queries, row_mask,
                           thr, bin_alive, metric=metric, k=k, take_min=take_min,
                           cmp=cmp, resid=resid, q_valid=q_valid, with_maxima=with_maxima)
    if fast and not fast_ok(metric, take_min, cmp, k, prec):
        raise ValueError("the fast-exact mode does not apply to this query")
    with span("otters.submit.scan_setup"):
        n_pad, d = vectors.shape
        b = queries.shape[0]
        dev = vectors.device
        if mode == "K2":
            # uncertified quantized cosine: symmetric int8 queries; both phases
            # take exact int32 dots
            q_kern, _, _ = _quantize_rows_int8(queries.float())
            q32 = q_kern.float()  # for the query norms only
        elif mode.startswith("K6"):
            # one bf16 pass: the kernel takes the queries rounded to bf16, the
            # epilogue their unrounded f32 norms
            q32 = queries.float()
            q_kern = q32.to(torch.bfloat16).contiguous()
        else:
            q32 = q_kern = queries.float().contiguous()
        q_sq, q_inv = _query_norms(q32)
        thr1 = thr
        slack = torch.zeros((), device=dev)
        if fast:
            base = high_precision_bound(d)
            if metric is Metric.Cosine:
                # cosine is norm-scaled: the bound is dimension-only
                slack = torch.full((), base, device=dev)
            else:
                # |dot_bf16x3 - dot| <= base ||q|| ||v||, bounded globally by the
                # max norms (on the device); Euclid doubles it for the -2 dot term
                mult = 2.0 if metric is Metric.Euclidean else 1.0
                slack = base * torch.sqrt(q_sq.max()) * torch.sqrt(norms_sq.max()) * mult
            # loosen the phase-1 filter so no row that truly passes is excluded
            thr1 = loosened(thr, slack, cmp)
        q_ok, rmask01, surv, n_surv = _scan_masks(valid, row_mask, bin_alive, q_valid, b, dev)
    with span("otters.submit.launch"):
        if fast:
            count("otters.fast_checks")
        bins = KERNELS[mode](
            q_kern, vectors, inv_norms, norms_sq, rmask01, q_inv, q_sq, q_ok,
            thr1.reshape(1).to(torch.float32), surv, n_surv, metric, take_min, cmp,
        )

    # ---- phase 2: winner-bin rescore and exact selection ----
    with span("otters.submit.phase2"):
        return _phase2(mode, bins, q_kern, q_sq, q_inv, vectors, norms_sq, inv_norms, valid,
                       row_mask, q_valid, thr, slack, metric=metric, k=k, take_min=take_min,
                       cmp=cmp, fast=fast)


def _phase2(mode, bins, q_kern, q_sq, q_inv, vectors, norms_sq, inv_norms, valid, row_mask,
            q_valid, thr, slack, *, metric, k, take_min, cmp, fast):
    """Phase 2 of the uncertified paths: the winner bins of ``bins`` (the
    [n_bins, b] bin maxima) rescored, the exact selection, the fast mode's
    check -> (rows, scores, ok, check, bound)."""
    b = q_kern.shape[0]
    d = vectors.shape[1]
    dev = vectors.device
    flat = bins.reshape(-1)  # slot = bin * b + query
    n_slots = flat.shape[0]
    boundary = torch.full((), _NEG_INF, device=dev)
    if fast:
        kb = min(4 * k, n_slots)
        sel_n = min(kb + 1, n_slots)
        top_vals, top_all = exact_topk_flat(flat, sel_n)
        if sel_n > kb:
            boundary = top_vals[-1]  # best bf16x3 bin max left unexamined
        top_slots = top_all[:kb]
        kb = top_slots.shape[0]
    else:
        kb = min(k, n_slots)
        _, top_slots = exact_topk_flat(flat, kb)
    qsel, rows_flat = _winner_rows(top_slots, b, dev)
    blk = vectors[rows_flat].reshape(kb, BIN, d)
    qc = q_kern[qsel][:, None, :]
    if mode == "K2":
        dots = _exact_int8_dots(qc, blk)[:, 0, :]
    elif mode.startswith("K6"):
        # the one-pass rescore: the same bf16 pass as phase 1 (the JAX
        # package's DEFAULT on both phases)
        dots = one_pass_dots(qc.float(), blk)[:, 0, :]
    else:
        # the exact f32 rescore of both K3 and K4 (the JAX package's HIGHEST
        # on its own backend's terms: full f32, no TF32); bf16 rows upcast
        # exactly, as there
        require_full_f32(qc)
        dots = torch.bmm(qc, blk.float().transpose(1, 2))[:, 0, :]
    inv_r = inv_norms[rows_flat].reshape(kb, BIN)
    nsq_r = norms_sq[rows_flat].reshape(kb, BIN)
    scores = _scores(dots, q_inv[qsel][:, None], q_sq[qsel][:, None], inv_r, nsq_r, metric)
    ok = _phase2_ok(scores, valid, row_mask, q_valid, rows_flat, qsel, kb, thr, cmp)
    key_flat = _masked_key(scores, ok, take_min).reshape(-1)
    top_keys, sel = _stable_topk(key_flat, min(k, key_flat.shape[0]))
    out_rows = rows_flat[sel].to(torch.int32)
    out_scores = scores.reshape(-1)[sel]
    out_ok = ok.reshape(-1)[sel]
    if fast:
        # the k-th exact key must beat anything an unexamined bin could
        # hold: its bf16x3 max plus the sound error bound
        check = top_keys[-1] >= boundary + slack
    else:
        check = torch.ones((), dtype=torch.bool, device=dev)
    bound = torch.full((), _NEG_INF, device=dev)
    return out_rows, out_scores, out_ok, check, bound


def _phase2_ok(scores, valid, row_mask, q_valid, rows_flat, qsel, kb, thr, cmp):
    """Which re-scored (winner bin, row) pairs pass: valid, not NaN, in the
    row mask, of a valid query, through the score filter at ``thr``."""
    ok = valid[rows_flat].reshape(kb, BIN) & ~torch.isnan(scores)
    if row_mask is not None:
        ok = ok & row_mask[rows_flat].reshape(kb, BIN)
    if q_valid is not None:
        ok = ok & q_valid[qsel][:, None]
    if cmp is not None:
        ok = ok & _filter_ok(scores, thr, cmp)
    return ok


class CertScan(NamedTuple):
    """The certified scan's operands and terms (see :func:`cert_scan`)."""

    ops: list  # the kernel's operands, in its wrapper's order
    qh32: torch.Tensor  # [b, d] bf16-rounded queries, as f32
    c0: torch.Tensor  # [b] per-query certificate coefficients
    c1: torch.Tensor
    c2: torch.Tensor
    lane_a: torch.Tensor  # [n_pad] per-row certificate lanes
    lane_b: torch.Tensor
    q_sq: torch.Tensor  # [b] norms of the bf16-rounded queries
    q_inv: torch.Tensor
    thr1: torch.Tensor  # [1] the score filter's threshold, loosened
    maxima: tuple  # the terms' six maxima over the valid queries (cert_slack's order)


def cert_scan(mode, vectors, norms_sq, inv_norms, valid, queries, row_mask, thr,
              bin_alive, *, metric, cmp, resid, q_valid=None) -> CertScan:
    """Set up the certified scan as the JAX package's ``_pallas_topk_jit``
    does: queries rounded once to bf16 (kept unquantized), the per-query
    coefficients c0 / c1 / c2 and per-row lanes of the certificate fold,
    the score filter loosened by the global slack (from the terms' six
    maxima, kept for a mesh's slack), the survivor list. K1 (``mode`` "K1"
    / "K1-bf16") takes the Cosine lane and leaves c0 to phase 2; K5 takes
    every term."""
    d = vectors.shape[1]
    b = queries.shape[0]
    dev = vectors.device
    qh32, c0, c1, c2, lane_a, lane_b = cert_terms(metric, queries, vectors.dtype, resid,
                                                  inv_norms, norms_sq, d)
    q_kern = qh32.to(torch.bfloat16)
    q_sq, q_inv = _query_norms(qh32)
    # the global slack only loosens the score filter, so no truly passing
    # row is dropped on its scan score
    maxima = cert_maxima(c0, c1, c2, lane_a, lane_b, norms_sq, q_valid=q_valid)
    thr1 = loosened(thr, cert_slack(*maxima), cmp).reshape(1).to(torch.float32)
    q_ok, rmask01, surv, n_surv = _scan_masks(valid, row_mask, bin_alive, q_valid, b, dev)
    if mode == "K5":
        ops = [q_kern, vectors, inv_norms, norms_sq, rmask01, lane_a, lane_b, q_inv, q_sq,
               q_ok, c0, c1, c2, thr1, surv, n_surv]
    else:
        ops = [q_kern, vectors, inv_norms, rmask01, lane_a, q_inv, q_ok, thr1, surv, n_surv]
    return CertScan(ops, qh32, c0, c1, c2, lane_a, lane_b, q_sq, q_inv, thr1, maxima)


def _fused_cert(mode, vectors, norms_sq, inv_norms, valid, queries, row_mask, thr,
                bin_alive, *, metric, k, take_min, cmp, resid, q_valid, with_maxima):
    """The certified paths: K1 (Cosine over int8 or bf16 rows) and K5 (Dot,
    Euclid take-min, over bf16 rows). Candidates are selected by the
    certificate-adjusted key, with the bound on every row not returned;
    ``with_maxima``: the terms' six maxima as a 6th output."""
    allowed = (None, Cmp.Lt, Cmp.Lte) if take_min else (None, Cmp.Gt, Cmp.Gte)
    if cmp not in allowed:
        raise ValueError(f"the certified scan takes no {cmp} score filter here")
    if resid is None:
        raise ValueError("certified fused scan needs the per-row residuals")
    with span("otters.submit.scan_setup"):
        cs = cert_scan(mode, vectors, norms_sq, inv_norms, valid, queries, row_mask, thr,
                       bin_alive, metric=metric, cmp=cmp, resid=resid, q_valid=q_valid)
    with span("otters.submit.launch"):
        if mode == "K5":
            # the kernel folds the whole slack, c0 included
            flat = cert_fold_binmax(*cs.ops, metric, take_min, cmp).reshape(-1)
        else:
            # the Cosine fold's per-query c0 joins here: max(key) + c0 is the
            # fully adjusted bin max (max is monotone; -inf stays -inf)
            flat = (KERNELS[mode](*cs.ops, cmp) + cs.c0[None, :]).reshape(-1)
        # slot = bin * b + query
    with span("otters.submit.phase2"):
        out = _cert_phase2(mode, flat, cs, vectors, norms_sq, inv_norms, valid, row_mask,
                           q_valid, metric=metric, k=k, take_min=take_min, cmp=cmp)
    return (*out, cs.maxima) if with_maxima else out


def _cert_phase2(mode, flat, cs: CertScan, vectors, norms_sq, inv_norms, valid, row_mask,
                 q_valid, *, metric, k, take_min, cmp):
    """Phase 2 of the certified paths: the winner bins of ``flat`` (the
    adjusted bin maxima) rescored, candidates selected by the adjusted key,
    the bound -> (rows, scores, ok, check, bound)."""
    _, qh32, c0, c1, c2, lane_a, lane_b, q_sq, q_inv, thr1, _ = cs
    d = vectors.shape[1]
    b = qh32.shape[0]
    dev = vectors.device
    kb = min(k, flat.shape[0])
    _, top_slots = exact_topk_flat(flat, kb)
    # phase-1 term of the bound: an unselected bin's adjusted max bounds
    # the true score (key) of every row it holds
    bound1 = flat.scatter(0, top_slots, _NEG_INF).max()
    qsel, rows_flat = _winner_rows(top_slots, b, dev)
    # mixed rescore: bf16 queries x stored rows upcast exactly, f32
    # products and sums (the same arithmetic class as phase 1)
    require_full_f32(qh32)
    blk = vectors[rows_flat].reshape(kb, BIN, d).float()
    dots = torch.bmm(blk, qh32[qsel][:, :, None])[:, :, 0]  # [kb, BIN]
    nsq_r = norms_sq[rows_flat].reshape(kb, BIN)
    scores = _scores(dots, q_inv[qsel][:, None], q_sq[qsel][:, None],
                     inv_norms[rows_flat].reshape(kb, BIN), nsq_r, metric)
    # phase-2 scores are still approximate: keep the loosened threshold
    ok = _phase2_ok(scores, valid, row_mask, q_valid, rows_flat, qsel, kb, thr1[0], cmp)
    # select by the ADJUSTED key (scan key + per-(query, row) slack): the
    # unreturned rows are then the smallest adjusted values, which
    # minimizes the bound; the rerank re-scores candidates exactly
    base = -scores if take_min else scores
    lane_a_r = lane_a[rows_flat].reshape(kb, BIN)
    if mode == "K5":
        adj = _general_fold(
            base, c0[qsel][:, None], c1[qsel][:, None], c2[qsel][:, None], lane_a_r,
            torch.sqrt(nsq_r), lane_b[rows_flat].reshape(kb, BIN),
        )
    else:
        adj = base + c0[qsel][:, None] + lane_a_r
    key_flat = torch.where(ok, adj, _NEG_INF).reshape(-1)
    _, sel = _stable_topk(key_flat, min(k, key_flat.shape[0]))
    out_rows = rows_flat[sel].to(torch.int32)
    out_scores = scores.reshape(-1)[sel]
    out_ok = ok.reshape(-1)[sel]
    # phase-2 term: examined rows not returned, with their own slacks
    bound = torch.maximum(bound1, key_flat.scatter(0, sel, _NEG_INF).max())
    check = torch.ones((), dtype=torch.bool, device=dev)
    return out_rows, out_scores, out_ok, check, bound
