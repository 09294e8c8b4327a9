"""K3: the plain window-attention kernel (pre-split windows: the fusion's
grid phase and the planar BEVFormer's camera self-attention)."""
from .attention import launch_bound_s

KERNEL = "plain_window_attention"


def bound_s(launch: dict, request: dict, config: dict) -> float:
    return launch_bound_s(launch["ints"])
