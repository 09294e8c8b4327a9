"""mfu.<part>: the reference's FLOPs of a frame (serve) or a step (train)
times the rate of the untraced window, over the card's dense bf16 peak,
in %.  The FLOPs are counted on the benchmark's reference, so they read
the same work whatever implements it."""
from ..peaks import MFU_PEAK_FLOPS


def read(ctx, part):
    flops, rate = ctx.get("flops"), ctx.get("rate")
    if not flops or not rate:
        return None
    return 100.0 * flops * rate / MFU_PEAK_FLOPS
