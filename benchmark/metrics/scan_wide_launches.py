"""Phase 1 scan kernel launches on the pair plan a request over the traced
window (``fused_topk.KERNELS[*].wide_launches``, which the harness sets to 0
before the window through ``fused_topk.reset_launches``): the launches of K4
over f32 rows whose CTAs hold 128 queries, a pair of query blocks that
share every ring stage; 0 where no launch does. Nothing where the program
has no such counter."""


def read(rec):
    if rec.trace is None:
        return None
    from otters_tpu_torch.ops import fused_topk

    counts = [getattr(fn, "wide_launches", None) for fn in fused_topk.KERNELS.values()]
    if None in counts:
        return None
    return sum(counts) / len(rec.window.requests)
