"""The profiling probes: three tile-product kernels timed on the card.

Counterpart of the JAX package's ``scripts/kernel_profile_variants.py``,
whose ``run`` launches three kernel bodies through ``pl.pallas_call`` over
1024-row tiles of a [1,007,616, 768] f32 store for a [256, 768] f32 query
block. Here each body is a kernel written by hand for Hopper
(``csrc/profile_probes.cu``) with a plain torch version beside it:

- :func:`k_mm`: the f32 product of each tile at full precision (FFMA, no
  TF32), keeping the dots of the tile's first two rows -> [n_tiles, b, 2];
- :func:`k_mm_bins`: the same product, then the max over each 512-row bin
  -> [n_tiles, b, t / 512];
- :func:`k_planes`: ``qh.vh + qh.vl + ql.vh`` (the query split into bf16
  planes, ``vh`` / ``vl`` pre-split bf16 arrays), then the bin maxima ->
  [n_tiles, b, t / 512].

All three run on the Hopper scan of ``csrc/cert_scan_sm90.cuh`` over every
bin: ``k_mm`` and ``k_mm_bins`` on K3's FFMA consumers over f32 rows,
``k_planes`` on K4's bf16x3 core over f32 rows with the row planes read
from the two arrays.

CPU tensors take the plain versions; CUDA tensors launch the kernel or
raise, and each wrapper's ``.launches`` counts its launches.

Run on the card, from the root of a checkout::

    python -m otters_tpu_torch.profile_variants

It prints the script's three labels with each probe's time (CUDA events).
"""

from __future__ import annotations

import statistics
import sys

import torch

from .ops import fused_topk as ft
from .ops.scoring import require_full_f32

N_PAD, D, B, T = 1007616, 768, 256, 1024  # the script's shapes (:5, :59-61)
BIN = ft.BIN
_SOURCE = "profile_probes"


def split_planes(x: torch.Tensor):
    """JAX's bf16 split of f32 ``x``: (bf16(x), bf16(x - bf16(x)))."""
    hi = x.to(torch.bfloat16)
    return hi, (x - hi.float()).to(torch.bfloat16)


def _tiles(n_rows: int, t: int) -> int:
    if t % BIN or n_rows % t:
        raise ValueError(f"tile {t} must be a multiple of {BIN} dividing {n_rows} rows")
    return n_rows // t


def _tile_dots(q, tiles, dots_fn, tile_slab: int):
    """dots_fn(rows [s*t, e*t)) -> [b, rows] for slabs of ``tile_slab``
    tiles -> [n_tiles, b, t] pieces, yielded slab by slab."""
    n_tiles, t = tiles
    for s in range(0, n_tiles, tile_slab):
        e = min(n_tiles, s + tile_slab)
        yield s, e, dots_fn(s * t, e * t).reshape(q.shape[0], e - s, t).transpose(0, 1)


def k_mm_plain(q, v, t: int = T, tile_slab: int = 64):
    """The k_mm function in plain torch: [n_tiles, b, 2], the full-f32 dots
    of each tile's first two rows (the whole tile product, as the kernel)."""
    require_full_f32(q)
    tiles = (_tiles(v.shape[0], t), t)
    out = torch.empty((tiles[0], q.shape[0], 2), device=q.device)
    for s, e, dots in _tile_dots(q, tiles, lambda a, z: q @ v[a:z].T, tile_slab):
        out[s:e] = dots[:, :, :2]
    return out


def k_mm_bins_plain(q, v, t: int = T, tile_slab: int = 64):
    """The k_mm_bins function in plain torch: [n_tiles, b, t / 512], the
    max of the full-f32 dots over each 512-row bin of each tile."""
    require_full_f32(q)
    tiles = (_tiles(v.shape[0], t), t)
    out = torch.empty((tiles[0], q.shape[0], t // BIN), device=q.device)
    for s, e, dots in _tile_dots(q, tiles, lambda a, z: q @ v[a:z].T, tile_slab):
        out[s:e] = dots.reshape(e - s, q.shape[0], t // BIN, BIN).amax(dim=3)
    return out


def k_planes_plain(q, vh, vl, t: int = T, tile_slab: int = 64):
    """The k_planes function in plain torch: [n_tiles, b, t / 512], the
    bin maxima of qh.vh + qh.vl + ql.vh (each product exact in f32, the
    three summed in f32 in that order)."""
    qh, ql = (x.float() for x in split_planes(q.float()))
    require_full_f32(qh)
    tiles = (_tiles(vh.shape[0], t), t)
    out = torch.empty((tiles[0], q.shape[0], t // BIN), device=q.device)

    def dots(a, z):
        h, lo = vh[a:z].float().T, vl[a:z].float().T
        return qh @ h + qh @ lo + ql @ h

    for s, e, d in _tile_dots(q, tiles, dots, tile_slab):
        out[s:e] = d.reshape(e - s, q.shape[0], t // BIN, BIN).amax(dim=3)
    return out


def bins_to_tiles(bins, nb: int):
    """The scan's [n_bins, b] bin maxima (bin = tile * nb + j) in the
    script's layout [n_tiles, b, nb]: one permute, copied."""
    n_bins, b = bins.shape
    return bins.reshape(n_bins // nb, nb, b).permute(0, 2, 1).contiguous()


def pad_row_stride(x):
    """A row array [n, d] as the scan's row maps read it: TMA needs a row
    stride (d times the element size) that is a multiple of 16 bytes, so at
    a depth that is not a multiple of 16 / element size (4 for f32, 8 for
    bf16) a copy zero-padded to the next one (zero columns add nothing to a
    dot); else ``x`` itself."""
    m = 16 // x.element_size()
    d = x.shape[1]
    return x if d % m == 0 else torch.nn.functional.pad(x, (0, m - d % m))


def _scan(wrapper, entry, mode, q, rows, t, extra=(), ints=()):
    """Launch the probe ``entry`` on the sm90 scan over every bin of the
    row arrays ``rows`` ([n, d], contiguous, on q's device; padded by
    :func:`pad_row_stride`), with the f32 queries padded as the geometry
    of ``mode`` asks (``fused_topk.sm90_pad_queries``, which splits them
    into planes for k_planes): the pointers q, rows, surv, n_surv, out,
    ``extra``, then n_bins, d, b, dq, n_qb, per_group, ``ints`` -> the bin
    maxima [n_bins, b] (every bin is live: all written). Counts the
    launch."""
    b, d = q.shape
    if q.dtype != torch.float32:
        raise ValueError(f"{entry}: q must be float32, got {q.dtype}")
    for r in rows:
        if r.device != q.device or not r.is_contiguous() or r.shape[1] != d:
            raise ValueError(f"{entry}: rows must be contiguous [n, {d}] on {q.device}")
        if r.data_ptr() % 16:
            raise ValueError(f"{entry}: rows must start on a 16-byte boundary")
    n_bins = _tiles(rows[0].shape[0], t) * (t // BIN)
    rows = [pad_row_stride(r) for r in rows]
    dp = rows[0].shape[1]
    dev = q.device.index if q.device.index is not None else torch.cuda.current_device()
    geom = ft.sm90_geometry(mode, b, dp, ft._n_sms(dev))
    qk, _ = ft.sm90_pad_queries(q, (), geom)
    surv = torch.arange(n_bins, dtype=torch.int32, device=q.device)
    n_surv = torch.full((1,), n_bins, dtype=torch.int32, device=q.device)
    out = torch.empty((n_bins, b), device=q.device)
    _, launch = ft._kernel_fns(_SOURCE, entry, len(rows) + 4 + len(extra), 6 + len(ints))
    err = launch(qk.data_ptr(), *(r.data_ptr() for r in rows), surv.data_ptr(),
                 n_surv.data_ptr(), out.data_ptr(), *extra, n_bins, dp, b, geom.dq, geom.n_qb,
                 geom.per_group, *ints, torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {err}")
    wrapper.launches += 1
    return out


def k_mm(q, v, t: int = T, all_dots=None):
    """The k_mm probe (see :func:`k_mm_plain`): CPU tensors take the plain
    version, CUDA tensors launch ``probe_mm`` on K3's FFMA scan, which
    computes the whole tile product and writes the dots of each tile's rows
    0 and 1, and every dot to ``all_dots`` ([n_qb * 64, n_rows] f32, the
    batch padded to whole query blocks) when it is given (tests; else null,
    and the kernel still computes every dot: it keeps their bin maxima in a
    scratch output)."""
    if not ft._on_card("probe_mm", q):
        return k_mm_plain(q, v, t)
    if v.dtype != torch.float32:
        raise ValueError(f"probe_mm: v must be float32, got {v.dtype}")
    first2 = torch.empty((_tiles(v.shape[0], t), q.shape[0], 2), device=q.device)
    if all_dots is not None:
        n_qb = -(-q.shape[0] // ft.QUERY_BLOCK)
        if (all_dots.shape != (n_qb * ft.QUERY_BLOCK, v.shape[0]) or not all_dots.is_contiguous()
                or all_dots.dtype != torch.float32 or all_dots.device != q.device):
            raise ValueError("probe_mm: all_dots must be a contiguous f32 "
                             f"[{n_qb * ft.QUERY_BLOCK}, {v.shape[0]}] on {q.device}")
    _scan(k_mm, "probe_mm", "k_mm", q, [v], t,
          extra=(first2.data_ptr(), None if all_dots is None else all_dots.data_ptr()),
          ints=(t,))
    return first2


def k_mm_bins(q, v, t: int = T):
    """The k_mm_bins probe (see :func:`k_mm_bins_plain`); CUDA tensors
    launch ``probe_mm_bins`` on K3's FFMA scan, every bin live, its [n_bins,
    b] bin maxima permuted to [n_tiles, b, t / 512] (:func:`bins_to_tiles`);
    rows at a depth that is not a multiple of 4 are copied with zero padding
    (:func:`pad_row_stride`)."""
    if not ft._on_card("probe_mm_bins", q):
        return k_mm_bins_plain(q, v, t)
    if v.dtype != torch.float32:
        raise ValueError(f"probe_mm_bins: v must be float32, got {v.dtype}")
    return bins_to_tiles(_scan(k_mm_bins, "probe_mm_bins", "k_mm_bins", q, [v], t), t // BIN)


def k_planes(q, vh, vl, t: int = T):
    """The k_planes probe (see :func:`k_planes_plain`); CUDA tensors launch
    ``probe_planes`` on the sm90 scan: the queries split into their planes
    and padded as K4's wrapper does (``fused_topk.sm90_pad_queries``), every
    bin live, the scan's [n_bins, b] permuted to [n_tiles, b, t / 512]
    (:func:`bins_to_tiles`); VH / VL at a depth that is not a multiple of 8
    are copied with zero padding (:func:`pad_row_stride`)."""
    if not ft._on_card("probe_planes", q):
        return k_planes_plain(q, vh, vl, t)
    if vh.dtype != torch.bfloat16 or vl.dtype != torch.bfloat16 or vh.shape != vl.shape:
        raise ValueError("probe_planes: vh and vl must be bfloat16 arrays of one shape")
    return bins_to_tiles(_scan(k_planes, "probe_planes", "k_planes", q, [vh, vl], t),
                         t // BIN)


PROBES = {"k_mm": k_mm, "k_mm_bins": k_mm_bins, "k_planes": k_planes}
PLAIN = {"k_mm": k_mm_plain, "k_mm_bins": k_mm_bins_plain, "k_planes": k_planes_plain}
# the script's labels (:59-61)
LABELS = {
    "k_mm": "A mm-only t=1024",
    "k_mm_bins": "B mm+binmax t=1024 (f32 HIGHEST baseline)",
    "k_planes": "D planes bf16x3+binmax t=1024",
}
for _fn in PROBES.values():
    _fn.launches = 0


def reset_launches() -> None:
    """Set every probe's launch count to 0."""
    for fn in PROBES.values():
        fn.launches = 0


def make_inputs(device, n_pad: int = N_PAD, d: int = D, b: int = B, seed: int = 0):
    """The script's operands from a seed: v [n_pad, d] and q [b, d] standard
    normal f32, and v's bf16 planes -> dict(q, v, vh, vl)."""
    g = torch.Generator(device=device).manual_seed(seed)
    v = torch.randn((n_pad, d), generator=g, device=device)
    q = torch.randn((b, d), generator=g, device=device)
    vh, vl = split_planes(v)
    return {"q": q, "v": v, "vh": vh, "vl": vl}


def probe_args(name: str, ops: dict):
    """A probe's positional operands from :func:`make_inputs`'s dict."""
    if name == "k_planes":
        return ops["q"], ops["vh"], ops["vl"]
    return ops["q"], ops["v"]


def time_ms(fn, reps: int = 10, warm: int = 2) -> float:
    """Median CUDA-event time of ``fn`` in ms over ``reps`` runs after warm-up."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        a, z = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        z.record()
        z.synchronize()
        times.append(a.elapsed_time(z))
    return statistics.median(times)


def run(ops: dict) -> dict:
    """Time each probe on ``ops`` (CUDA tensors from :func:`make_inputs`),
    printing the script's labels -> {probe: median ms}."""
    times = {}
    n_tiles = ops["v"].shape[0] // T
    for name, fn in PROBES.items():
        args = probe_args(name, ops)
        times[name] = time_ms(lambda: fn(*args))
        print(f"{LABELS[name]}: {times[name]:.3f} ms ({n_tiles} steps) on "
              f"{torch.cuda.get_device_name(ops['q'].device)}", flush=True)
    return times


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_variants: the probes time the card; no CUDA device", file=sys.stderr)
        return 1
    run(make_inputs(torch.device("cuda", torch.cuda.current_device())))
    return 0


if __name__ == "__main__":
    sys.exit(main())
