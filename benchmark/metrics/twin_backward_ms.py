"""twin_backward_ms.train: device ms a step inside the port's
``twin_backward:<kernel>`` profiler ranges (the kernels' backward,
computed by their plain twins), over the traced steps."""


def read(ctx, part):
    ranges = ctx.get("ranges", {})
    inside = [ev for name, evs in ranges.items()
              if name.startswith("twin_backward:") for ev in evs]
    if not inside or not ctx.get("traced_steps"):
        return None
    return sum(ev["dur"] for ev in inside) * 1e-3 / ctx["traced_steps"]
