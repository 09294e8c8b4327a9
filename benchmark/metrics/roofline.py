"""<kernel>_roofline: over the kernel's launches in the traced served
frames, the least time the launches could take (``rooflines/<kernel>.py``
per launch, on that frame's request and the cell's configuration) over their measured device time,
in %.  The launches of a frame are matched in order to the launches the
benchmark recorded on its eager pass of the same fleet."""
import importlib


def read(ctx, kernel_tag):
    spec = importlib.import_module(f"benchmark.rooflines.{kernel_tag}")
    records = ctx.get("launches", {}).get(spec.KERNEL)
    frames = ctx.get("traced_frames")
    if not records or not frames:
        return None
    from ..trace import hand_written_kernel

    least = spent = 0.0
    for pool_index, frame in frames:
        events = [ev for ev in ctx["trace"].device_in(
            frame["ts"], frame["ts"] + frame["dur"])
            if hand_written_kernel(ev["name"]) == spec.KERNEL]
        if len(events) != len(records):
            raise RuntimeError(
                f"{kernel_tag}: {len(events)} launches in a traced frame, "
                f"{len(records)} recorded on the eager pass")
        request = ctx["pool"][pool_index]
        for ev, launch in zip(events, records):
            least += spec.bound_s(launch, request, ctx["config"])
            spent += ev["dur"] * 1e-6
    return 100.0 * least / spent
