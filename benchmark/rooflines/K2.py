"""K2: the stripe window-attention kernel (local windows read from unsplit
maps)."""
from .attention import launch_bound_s

KERNEL = "stripe_window_attention"


def bound_s(launch: dict, request: dict, config: dict) -> float:
    return launch_bound_s(launch["ints"])
