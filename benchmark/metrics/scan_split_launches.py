"""Phase 1 scan kernel launches on the split plan a request over the traced
window (``fused_topk.KERNELS[*].split_launches``, which the harness sets to 0
before the window through ``fused_topk.reset_launches``): the launches whose
ring keeps only the head of the query block resident and streams the rest
(bf16 rows at d = 1,296-1,536), 0 where every launch keeps the whole block
resident. Nothing where the program has no such counter."""


def read(rec):
    if rec.trace is None:
        return None
    from otters_tpu_torch.ops import fused_topk

    counts = [getattr(fn, "split_launches", None) for fn in fused_topk.KERNELS.values()]
    if None in counts:
        return None
    return sum(counts) / len(rec.window.requests)
