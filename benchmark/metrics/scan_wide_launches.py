"""Phase 1 scan kernel launches on the pair plan a request over the traced
window (``fused_topk.KERNELS[*].wide_launches``, which the harness sets to 0
before the window through ``fused_topk.reset_launches``): the launches on the
pair plan, whose CTAs hold 128 queries, a pair of query blocks that share
every ring stage: K4's over f32 rows at any batch, and K1's over int8 rows
at more than one query block (b >= 65); 0 where no launch does. Nothing
where the program has no such counter."""


def read(rec):
    if rec.trace is None:
        return None
    from otters_tpu_torch.ops import fused_topk

    counts = [getattr(fn, "wide_launches", None) for fn in fused_topk.KERNELS.values()]
    if None in counts:
        return None
    return sum(counts) / len(rec.window.requests)
