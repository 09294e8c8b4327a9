"""device_idle_share.<part>: the share of the traced window of served
frames (or of train steps) in which no kernel, copy or memset ran on the
card, in %."""


def read(ctx, part):
    window = ctx.get("window_s")
    if not window:
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / window)
