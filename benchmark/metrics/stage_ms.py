"""stage_ms.<stage>: device ms a frame of the operations launched inside
one stage of the model (the ranges the benchmark's forward hooks open
around ``lidar_encoder``, ``camera_encoder``, ``fusion`` and
``HeteroDecoder_0``, and around decode + NMS), on the eager traced pass
over the cell's requests."""


def read(ctx, part):
    inside = ctx.get("stage_ranges", {}).get("stage: " + part)
    if not inside:
        return None
    return sum(ev["dur"] for ev in inside) * 1e-3 / ctx["stage_frames"]
