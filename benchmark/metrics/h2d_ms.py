"""h2d_ms.serve: device ms a served frame of the host-to-device copies
(the request's arrays), from the trace of the served frames."""


def read(ctx, part):
    frames = ctx.get("traced_frames")
    if not frames:
        return None
    copies = [ev for _, ev in frames for ev in ctx["trace"].device_in(
        ev["ts"], ev["ts"] + ev["dur"])
        if ev.get("cat") == "gpu_memcpy" and "htod" in ev["name"].lower()]
    if not copies:
        return None
    return sum(ev["dur"] for ev in copies) * 1e-3 / len(frames)
