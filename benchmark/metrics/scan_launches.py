"""Phase 1 scan kernel launches a request over the traced window
(``fused_topk.KERNELS[*].launches``, which the harness sets to 0 before the
window): 1 where every request certified at its first scan width, more with
strict redos or a widened scan (a sharded store: one a shard), 0 where the
scan ran no kernel (the CPU)."""


def read(rec):
    if rec.trace is None:
        return None
    from otters_tpu_torch.ops import fused_topk

    return sum(fn.launches for fn in fused_topk.KERNELS.values()) / len(rec.window.requests)
